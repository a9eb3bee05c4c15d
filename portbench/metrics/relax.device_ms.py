"""Mean device ms a request launched while the program's ``query.relax``
span (``CoreRelaxer.run`` inside ``_query_block``) was open: the seed
scatter and the rounds, from inside the program."""


def read(run):
    tr = run.get("trace") or {}
    spans = tr.get("program_spans")
    if (not spans or "query.relax" not in spans or not tr["device_events"]
            or not run.get("requests")):
        return None
    return spans["query.relax"]["device_s"] / run["requests"] * 1e3
