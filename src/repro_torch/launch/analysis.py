"""Cost analysis of one traced step (shared by ``dryrun`` and ``perf``
and importable from tests without starting a process group): the
hardware model and the counting modes — the port of
``repro.launch.analysis``.

Hardware model (per card): NVIDIA H100 SXM 80 GB, 989 TFLOP/s dense
bf16, 3.35 TB/s HBM3 of 80 GB, NVLink 4 at 450 GB/s a direction.

``CostMode`` is a ``TorchDispatchMode`` over one eager step (under
``FakeTensorMode`` in the dry run, so nothing is computed or
allocated). It counts, per device (a DTensor by its local shard):

* ``bytes accessed``: the operand and result bytes of every aten op
  that moves data (views and ``prim`` metadata ops excluded), XLA's
  rule;
* collective bytes: the output bytes of every ``_c10d_functional`` /
  ``c10d`` collective the trace issues, by kind, plus ``total``
  (``repro``'s rule on per-device shapes). A collective that DTensor
  issues inside one of its own ops (the all-reduce that turns a
  ``Partial`` norm into a replicated one) runs below the mode and is
  not counted: a few scalars a step;
* peak live bytes: the arguments plus every op result still referenced
  (views share their base's bytes), at its highest.

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
products, convolutions and attention: elementwise arithmetic counts
none, unlike XLA's cost analysis).
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

PEAK_FLOPS = 989e12          # H100 SXM, dense bf16
HBM_BW = 3.35e12             # HBM3
HBM_BYTES = 80e9             # its capacity
LINK_BW = 450e9              # NVLink 4, one direction

COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_":
    "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}


def local(t):
    """A DTensor's local shard; any other tensor itself."""
    return getattr(t, "_local_tensor", t)


def nbytes(t) -> int:
    t = local(t)
    return t.numel() * t.element_size()


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for y in x:
            yield from _tensors(y)
    elif isinstance(x, dict):
        for y in x.values():
            yield from _tensors(y)


class CostMode(TorchDispatchMode):
    """Counts one traced step (the module docstring). ``arg_bytes``: the
    bytes already live when the trace starts (the state and batch)."""

    def __init__(self, arg_bytes: int = 0):
        super().__init__()
        self.bytes = 0
        self.collectives: dict = {}
        self.live = arg_bytes
        self.peak = arg_bytes
        self.ops = 0

    def _free(self, n: int):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        name = func.__name__.split(".")[0]
        if ns in ("_c10d_functional", "c10d") and name in COLLECTIVES:
            kind = COLLECTIVES[name]
            outs = list(_tensors(out))
            if name.endswith("_") and not outs:
                outs = list(_tensors(args[:1]))
            self.collectives[kind] = self.collectives.get(kind, 0) + sum(
                nbytes(t) for t in outs)
            return out
        if ns == "prim" or name == "wait_tensor":
            return out
        views = any(r.alias_info is not None and not r.alias_info.is_write
                    for r in func._schema.returns)
        if views:
            return out
        self.ops += 1
        ins = sum(nbytes(t) for t in _tensors((args, kwargs)))
        outs = list(_tensors(out))
        self.bytes += ins + sum(nbytes(t) for t in outs)
        written = {id(local(t)) for t in _tensors((args, kwargs))}
        for t in outs:
            if id(local(t)) in written:       # an in-place result
                continue
            n = nbytes(t)
            self.live += n
            weakref.finalize(local(t), self._free, n)
        self.peak = max(self.peak, self.live)
        return out

    def collective_bytes(self) -> dict:
        out = dict(self.collectives)
        out["total"] = sum(self.collectives.values())
        return out


def trace_costs(step, arg_bytes: int = 0) -> dict:
    """Run ``step()`` once under ``FlopCounterMode`` and ``CostMode``.
    Returns flops, bytes accessed, collective bytes (by kind and
    ``total``), peak live bytes and the counted op count, per device."""
    flops = FlopCounterMode(display=False)
    cost = CostMode(arg_bytes)
    with flops, cost:
        out = step()
        del out
    return {"flops": float(flops.get_total_flops()),
            "bytes accessed": float(cost.bytes),
            "collective_bytes": cost.collective_bytes(),
            "peak_bytes": int(cost.peak), "ops": cost.ops}


def roofline(flops: float, bytes_acc: float, coll_bytes: float) -> dict:
    """The three times on the H100 model and the dominant one."""
    rec = {"t_compute_s": flops / PEAK_FLOPS,
           "t_memory_s": bytes_acc / HBM_BW,
           "t_collective_s": coll_bytes / LINK_BW}
    dom = max(rec, key=rec.get)
    rec["dominant"] = dom.replace("t_", "").replace("_s", "")
    return rec
