"""Structured export: JSON-lines event log + metrics/trace file writers.

``EventLog`` is the append-only structured log the serving launcher and
the (planned) HTTP/SSE front end stream from: one JSON object per line,
each stamped with a monotonically increasing sequence number and the
caller's timestamp. Lines are flushed per event so a tailing consumer
(``tail -f`` / SSE relay) sees them immediately.

``write_metrics`` / ``write_chrome_trace`` are the ``launch/serve.py
--metrics-out`` / ``--trace-out`` sinks.

The port's copy of ``repro.obs.export``, onto the port's registry.
"""
from __future__ import annotations

import json
from pathlib import Path

from repro_torch.obs.registry import REGISTRY

__all__ = ["EventLog", "write_metrics", "write_chrome_trace"]


class EventLog:
    """JSON-lines structured event log.

    ``path=None`` keeps events in memory only (tests, SSE buffers);
    otherwise every event is appended and flushed to the file as one
    line. Events are plain dicts: ``{"seq": n, "ts": t, "kind": k, ...}``.
    """

    def __init__(self, path=None, keep: int = 4096):
        self.path = Path(path) if path else None
        self.keep = int(keep)
        self.recent: list[dict] = []
        self._seq = 0
        self._fh = None
        if self.path:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a", encoding="utf-8")

    def log(self, kind: str, ts: float = 0.0, **fields) -> dict:
        ev = {"seq": self._seq, "ts": float(ts), "kind": str(kind),
              **fields}
        self._seq += 1
        self.recent.append(ev)
        if len(self.recent) > self.keep:
            del self.recent[:len(self.recent) - self.keep]
        if self._fh:
            self._fh.write(json.dumps(ev, sort_keys=True,
                                      default=_jsonable) + "\n")
            self._fh.flush()
        return ev

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @staticmethod
    def read(path) -> list[dict]:
        """Load every event line of a log file (skips blank lines)."""
        out = []
        for line in Path(path).read_text().splitlines():
            if line.strip():
                out.append(json.loads(line))
        return out


def _jsonable(o):
    try:
        import numpy as np
        if isinstance(o, np.generic):
            return o.item()
        if isinstance(o, np.ndarray):
            return o.tolist()
    except Exception:
        pass
    return str(o)


def write_metrics(path, registry=None, **extra) -> Path:
    """Dump a registry snapshot (every metric, every labeled series)
    as one JSON document — the ``--metrics-out`` sink."""
    reg = registry if registry is not None else REGISTRY
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(reg.to_json(**extra) + "\n")
    return p


def write_chrome_trace(path, tracer) -> Path:
    """Write a tracer's spans as Chrome trace-event JSON — the
    ``--trace-out`` sink (open in chrome://tracing or Perfetto)."""
    return tracer.write_chrome(path)
