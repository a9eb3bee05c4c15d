"""The share, in %, of the slots ``dedup_min_edges`` sorts that hold an
edge (src < n): the program's ``build.dedup_live`` over
``build.dedup_slots``."""


def read(run):
    counters = (run.get("trace") or {}).get("program_counters")
    if not counters or not counters.get("build.dedup_slots"):
        return None
    return (100.0 * counters.get("build.dedup_live", 0.0)
            / counters["build.dedup_slots"])
