"""Mean ``BuildStats.peel_seconds`` over the window's builds: the
hierarchy (MIS and peel levels), ending on blocking reads."""


def read(run):
    if not run.get("builds"):
        return None
    return sum(b["peel_s"] for b in run["builds"]) / len(run["builds"])
