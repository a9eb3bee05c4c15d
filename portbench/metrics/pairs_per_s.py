"""Pairs whose exact distances reached the host in the window, over the
window's seconds."""


def read(run):
    if "pairs" not in run:
        return None
    return run["pairs"] / run["window_s"]
