"""Mean ``BuildStats.label_seconds`` over the window's builds: the label
join, ending on the overflow flags' blocking read."""


def read(run):
    if not run.get("builds"):
        return None
    return sum(b["label_s"] for b in run["builds"]) / len(run["builds"])
