"""1 - (union of the device's kernel and copy intervals) / the rebuild
window's wall time, from the profiler, in %."""


def read(run):
    tr = run.get("trace")
    if not tr or not tr["device_events"] or "builds" not in run:
        return None
    return 100.0 * tr["idle_share"]
