"""Host seconds of the program's ``build.pull`` span (the device
builder's final read of the hierarchy and the host work after it), mean
a build."""


def read(run):
    spans = (run.get("trace") or {}).get("program_spans")
    if not spans or "build.pull" not in spans or not run.get("builds"):
        return None
    return spans["build.pull"]["host_s"] / len(run["builds"])
