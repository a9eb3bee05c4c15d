"""Cross-pod gradient compression with error feedback — the port of
``repro.distributed.compression`` over ``torch.distributed``.

The pod axis is the slow interconnect. Baseline multi-pod training
all-reduces fp32 gradients across pods; this module replaces that with
**error-feedback int8**:

  1. residual-corrected gradient g' = g + e  (error feedback state e)
  2. per-tensor scale s = max|g'| / 127 shared via a tiny fp32
     ``all_reduce(MAX)``
  3. q = round(g'/s) as int8 (round half to even, as ``jnp.round``),
     ``all_gather_into_tensor`` across the pod group
  4. the dequantized mean becomes the update; e' = g' - dequant(q)

The collectives run over the ``pod`` sub-mesh's process group; the
reduction inside a pod stays fp32 (``make_compressed_grad_fn``). The
error-feedback state makes the compression unbiased over time
(Karimireddy et al., arXiv:1901.09847).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.tree import tree_map


def quantize_int8(g, scale):
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum_pod(grads, err, mesh, axis: str = "pod"):
    """grads/err: trees of local tensors, already reduced within the pod
    (``err`` without its pod dim). Returns (mean_grads, new_err), the
    mean the same on every pod."""
    group = mesh.get_group(axis)
    n_pods = dist.get_world_size(group)

    def one(g, e):
        gf = g.to(torch.float32) + e
        amax = torch.max(torch.abs(gf))
        dist.all_reduce(amax, dist.ReduceOp.MAX, group=group)
        scale = amax / 127.0 + 1e-12
        q = quantize_int8(gf, scale)
        # int8 across pods, then a local mean (cross-pod bytes: N int8 a
        # pod against 2N fp32 for a ring all-reduce)
        allq = q.new_empty(n_pods * q.numel())
        dist.all_gather_into_tensor(allq, q.reshape(-1), group=group)
        allq = allq.view((n_pods,) + tuple(q.shape))
        mean = torch.mean(dequantize_int8(allq, scale), dim=0)
        new_e = gf - dequantize_int8(q, scale)
        return mean.to(g.dtype), new_e

    outs = tree_map(one, grads, err)
    return (tree_map(lambda o: o[0], outs),
            tree_map(lambda o: o[1], outs))


def make_compressed_grad_fn(loss_and_grad_fn, mesh):
    """Wrap a per-rank loss/grad fn with the cross-pod compressed
    reduction. ``fn(params, err, batch) -> (loss, grads, new_err)``:
    ``params`` this rank's whole parameters, ``batch`` its shard, ``err``
    its pod's residual (the leading pod dim of ``repro``'s state, of
    size one here). Inside the pod the loss and the gradients are
    averaged in fp32 over the ``data`` group; across pods the gradients
    go through ``compressed_psum_pod`` and the loss through an fp32 mean."""
    names = tuple(mesh.mesh_dim_names)
    inner = mesh.get_group("data") if "data" in names else None
    pods = mesh.get_group("pod")

    def mean_over(x, group):
        if group is None or dist.get_world_size(group) == 1:
            return x
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x / dist.get_world_size(group)

    def fn(params, err, batch):
        loss, grads = loss_and_grad_fn(params, batch)
        grads = tree_map(lambda g: mean_over(g, inner), grads)
        grads, new_err = compressed_psum_pod(
            grads, tree_map(lambda e: e[0], err), mesh)
        loss = mean_over(mean_over(loss, inner), pods)
        return loss, grads, tree_map(lambda e: e[None], new_err)

    return fn


def init_error_feedback(params, n_pods: int = 1):
    """Per-pod residual state: leading axis = pod."""
    return tree_map(lambda p: torch.zeros((n_pods,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)
