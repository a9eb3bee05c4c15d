"""Seconds from the start of the run's process to its first timed
request or build: imports, the CUDA context, the kernel library, the
graph, the index build and the warm-up."""


def read(run):
    return run["setup_s"]
