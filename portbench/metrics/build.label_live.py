"""The share, in %, of the candidates ``label_chunk_step`` sorts that
hold an ancestor (id < n): the program's ``build.label_live`` over
``build.label_slots``."""


def read(run):
    counters = (run.get("trace") or {}).get("program_counters")
    if not counters or not counters.get("build.label_slots"):
        return None
    return (100.0 * counters.get("build.label_live", 0.0)
            / counters["build.label_slots"])
