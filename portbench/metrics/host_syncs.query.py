"""Blocking device-to-host reads a request (``core.sync.sync_count``
across the window, over the requests)."""


def read(run):
    if not run.get("requests"):
        return None
    return run["syncs"] / run["requests"]
