"""The window's seconds over the builds completed in it."""


def read(run):
    if not run.get("builds"):
        return None
    return run["window_s"] / len(run["builds"])
