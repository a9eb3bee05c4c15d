"""Synchronous stage-2 rounds a request: the program's ``relax.rounds``
counter (``QueryEngine._last_rounds`` of each request) across the
window, over the requests."""


def read(run):
    counters = (run.get("trace") or {}).get("program_counters")
    if not counters or "relax.rounds" not in counters \
            or not run.get("requests"):
        return None
    return counters["relax.rounds"] / run["requests"]
