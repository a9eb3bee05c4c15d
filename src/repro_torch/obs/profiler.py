"""Device-level observability of the port: first-use builds by region,
device-memory gauges, and ``torch.profiler`` session wrapping — the
torch counterpart of ``repro.obs.profiler``.

``repro`` counts XLA backend compiles. The port has no XLA; its
counterpart of a compile is work that the first call builds and later
calls reuse. Three sites build such work and report it here
(``record_build``):

  kernel_library   the CUDA kernel library built or loaded
                   (``kernels/_build.py:load``)
  relax_layout     a stage-2 route's layout (``CoreRelaxer.coo / csr /
                   sliced / dense_adj``, ``core/dispatch.py``)
  chase_planes     the path engine's chase planes (``paths/engine.py``)

Each build counts one ``obs.first_use_builds{region, site}``. The
serving engine tags its windows with ``compile_region``, as in
``repro``:

  warmup       building the server and pre-warming its entry points
  serve_read   the distance hot path          — MUST stay 0 after warmup
  serve_path   the pre-warmed path tiers and the host fallback
  other        anything untagged

``BuildWatcher`` reads the counts since it started, by region;
``launch/serve.py`` fails its run if any build is counted in
``serve_read`` or ``serve_path``.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.obs.registry import REGISTRY

__all__ = ["BuildWatcher", "compile_region", "current_region",
           "device_memory_gauges", "profiler_session", "record_build"]

FIRST_USE_BUILDS = "obs.first_use_builds"

_region = threading.local()


def current_region() -> str:
    return getattr(_region, "name", "other")


@contextlib.contextmanager
def compile_region(name: str):
    """Tag first-use builds triggered inside this block with ``name``."""
    prev = current_region()
    _region.name = name
    try:
        yield
    finally:
        _region.name = prev


def _builds(registry=None):
    reg = registry if registry is not None else REGISTRY
    return reg.counter(FIRST_USE_BUILDS,
                       "first-use builds (kernel library, route layouts, "
                       "chase planes) by region and site")


def record_build(site: str, registry=None) -> None:
    """Count one first-use build at ``site`` in the current region."""
    _builds(registry).inc(1, region=current_region(), site=site)


def _by_region(counter) -> dict:
    out: dict = {}
    for labels in counter.labels_seen():
        region = labels.get("region", "other")
        out[region] = out.get(region, 0) + int(counter.value(**labels))
    return out


class BuildWatcher:
    """First-use builds by region since ``start()`` (the counterpart of
    ``repro``'s ``CompileWatcher``; the sites count whether or not a
    watcher runs, and the watcher reports the difference)."""

    def __init__(self, registry=None):
        self.registry = registry if registry is not None else REGISTRY
        self._base: dict = {}
        self._final: dict | None = None

    def start(self) -> "BuildWatcher":
        self._base = _by_region(_builds(self.registry))
        self._final = None
        return self

    def stop(self) -> None:
        self._final = self.snapshot()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def snapshot(self) -> dict:
        if self._final is not None:
            return dict(self._final)
        now = _by_region(_builds(self.registry))
        return {r: c - self._base.get(r, 0) for r, c in now.items()
                if c - self._base.get(r, 0)}

    def count(self, region: str | None = None) -> int:
        snap = self.snapshot()
        return snap.get(region, 0) if region is not None else sum(
            snap.values())


# ------------------------------------------------------------- memory
def device_memory_gauges(registry=None) -> dict:
    """Sample the bytes the CUDA caching allocator has given to tensors
    (``torch.cuda.memory_stats``) on every visible card into
    ``obs.device_bytes_in_use{device}``. Without CUDA the gauge stays
    absent and the result is empty."""
    reg = registry if registry is not None else REGISTRY
    out: dict = {}
    if not torch.cuda.is_available():
        return out
    gauge = reg.gauge("obs.device_bytes_in_use", "allocator bytes in use")
    for dev in range(torch.cuda.device_count()):
        value = int(torch.cuda.memory_stats(dev).get(
            "allocated_bytes.all.current", 0))
        gauge.set(value, device=str(dev))
        out[f"device{dev}_bytes_in_use"] = value
    return out


# ------------------------------------------------------------ profiler
@contextlib.contextmanager
def profiler_session(log_dir: str | None):
    """``torch.profiler`` over the block, CPU and (where present) CUDA
    activity, written as a Chrome trace (``trace.json``) into
    ``log_dir``; a no-op when ``log_dir`` is falsy. Yields whether a
    session runs."""
    if not log_dir:
        yield False
        return
    from pathlib import Path
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield True
    prof.export_chrome_trace(str(out / "trace.json"))
