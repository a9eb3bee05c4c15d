"""Mean device ms a request spends inside ``CoreRelaxer.run``: the seed
scatter and the relaxation rounds. Nothing to read where the window
holds no ``stage2`` range: the call was bypassed or renamed."""


def read(run):
    tr = run.get("trace")
    if (not tr or not tr["device_events"] or not tr["requests"]
            or not tr["stage2_ranges"]):
        return None
    reqs = tr["requests"]
    return sum(r[1] for r in reqs) / len(reqs) * 1e3
