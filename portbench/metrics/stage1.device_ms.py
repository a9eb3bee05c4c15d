"""Mean device ms a request spends outside ``CoreRelaxer.run``: Equation
1, the label-row gathers and seeds, the uploads and the answers' copy.
Nothing to read where the window holds no ``stage2`` range: stage 1
would then take stage 2's time."""


def read(run):
    tr = run.get("trace")
    if (not tr or not tr["device_events"] or not tr["requests"]
            or not tr["stage2_ranges"]):
        return None
    reqs = tr["requests"]
    return sum(r[0] for r in reqs) / len(reqs) * 1e3
