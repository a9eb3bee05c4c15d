"""The share, in %, of the Luby rounds launched (``MISState.advance``)
that found a pool: the program's ``build.mis_rounds`` (as each level's
stat vector reads them) over ``build.mis_launched``."""


def read(run):
    counters = (run.get("trace") or {}).get("program_counters")
    if not counters or not counters.get("build.mis_launched"):
        return None
    return (100.0 * counters.get("build.mis_rounds", 0.0)
            / counters["build.mis_launched"])
