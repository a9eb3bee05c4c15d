"""The least time the first traced request's stage-2 work needs
(``work.py``: the bytes and operations its synchronous rounds need,
over the H100's peaks) as a share of that request's stage-2 device
time, in %. Nothing to read where the replay's frontiers or rounds
differ from the program's."""


def read(run):
    tr, wk = run.get("trace"), run.get("work")
    if not tr or not wk or not tr["requests"] or not tr["stage2_ranges"]:
        return None
    spent = tr["requests"][0][1]
    if not wk["agree"] or wk["rounds"] != wk["program_rounds"] or spent <= 0:
        return None
    return 100.0 * wk["bound_s"] / spent
