"""Host seconds of the program's ``build.assemble`` span
(``ISLabelIndex._assemble``: the core maps, the query engine, the label
entries' read), mean a build."""


def read(run):
    spans = (run.get("trace") or {}).get("program_spans")
    if not spans or "build.assemble" not in spans or not run.get("builds"):
        return None
    return spans["build.assemble"]["host_s"] / len(run["builds"])
