"""The device's idle seconds whose gap opens while the host is inside the
program's ``sync.read`` span (a blocking ``core.sync.host_read``), as a
share, in %, of the rebuild window."""


def read(run):
    tr = run.get("trace") or {}
    spans = tr.get("program_spans")
    if (not spans or "sync.read" not in spans or not tr["device_events"]
            or "builds" not in run):
        return None
    return 100.0 * spans["sync.read"]["idle_s"] / tr["window_s"]
