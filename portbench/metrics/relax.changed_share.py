"""The share, in %, of the (row tile, vertex) source slots of the
counted ``relax_csr_rounds`` rounds that were marked changed in the
round's input mask: the program's ``relax.changed`` over
``relax.slots``. Nothing to read where no round ran on that route."""


def read(run):
    counters = (run.get("trace") or {}).get("program_counters")
    if not counters or not counters.get("relax.slots"):
        return None
    return 100.0 * counters.get("relax.changed", 0.0) / counters["relax.slots"]
