"""Cross-pod gradient compression with error feedback — the port of
``repro.distributed.compression`` over ``torch.distributed``.

The pod axis is the slow interconnect. Baseline multi-pod training
all-reduces fp32 gradients across pods; this module replaces that with
**error-feedback int8**:

  1. residual-corrected gradient g' = g + e  (error feedback state e)
  2. per-tensor scale s = max|g'| / 127 shared via a tiny fp32
     all-reduce (``MAX``)
  3. q = round(g'/s) as int8 (round half to even, as ``jnp.round``),
     all-gathered across the pod group
  4. the dequantized mean becomes the update; e' = g' - dequant(q)

``repro`` runs this inside a ``shard_map`` over ``pod`` alone, the
``data`` and ``model`` axes left to GSPMD: inside each pod the model is
split as the plain mesh step splits it, and the exchange works on
gradients that are logically whole. The port does the same on each
rank's block of a gradient and of its residual (the parameter's layout
inside the pod): steps 1, 3 and 4 are elementwise on the block, the
int8 all-gather moves the block across pods, and the max of step 2 is
taken over the whole tensor (over every mesh axis: the block's own
max, then the pods' and the blocks' ones), so that each element is
quantized as ``repro`` quantizes it. The reduction inside a pod stays
fp32 (``make_compressed_grad_fn``). The error-feedback state makes the
compression unbiased over time (Karimireddy et al., arXiv:1901.09847).
"""
from __future__ import annotations

import math

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed import sharding as SHD
from repro_torch.tree import (flatten_with_paths, leaves, tree_map,
                              unflatten_paths)


def quantize_int8(g, scale):
    return torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def _amax(x):
    """max|x| of a block (0 for an empty one: |x| >= 0)."""
    return torch.max(torch.abs(x)) if x.numel() else x.new_zeros(())


def compressed_psum_pod(grads, err, mesh, axis: str = "pod"):
    """grads/err: trees of this rank's blocks of each gradient (already
    reduced within its pod) and of its pod's residual (without the pod
    dim), the same layout both. Returns (mean_grads, new_err) as blocks
    of the same layout, the mean the same on every pod. Each leaf's
    scale is the max over the whole tensor: one ``MAX`` all-reduce over
    every mesh axis (a leaf's replicated axes hold equal maxima)."""
    names = tuple(mesh.mesh_dim_names)
    size = dict(zip(names, mesh.shape))
    group = mesh.get_group(axis)
    paths = [k for k, _ in flatten_with_paths(grads)]
    gs = leaves(grads)
    gf = [g.to(torch.float32) + e for g, e in zip(gs, leaves(err))]
    amax = torch.stack([_amax(x) for x in gf])
    for a in names:
        if size[a] > 1:
            amax = SHD.all_reduce(amax, mesh.get_group(a), "max")
    means, new_err = [], []
    for g, x, m in zip(gs, gf, amax.unbind(0)):
        scale = m / 127.0 + 1e-12
        q = quantize_int8(x, scale)
        # int8 across pods, then a local mean (cross-pod bytes: N int8 a
        # pod against 2N fp32 for a ring all-reduce)
        allq = SHD.all_gather(q[None], group, size[axis])
        means.append(torch.mean(dequantize_int8(allq, scale), dim=0).to(
            g.dtype))
        new_err.append(x.sub_(dequantize_int8(q, scale)))    # x is ours
    return (unflatten_paths(zip(paths, means)),
            unflatten_paths(zip(paths, new_err)))


def make_compressed_grad_fn(loss_and_grad_fn, mesh, inner=("data",)):
    """Wrap a pod's loss/grad fn with the cross-pod compressed reduction
    (``repro``'s ``shard_map`` over ``pod``). ``fn(params, err, batch) ->
    (loss, grads, new_err)``: ``params`` the state's DTensors (replicated
    over ``pod``), ``err`` the residual laid out ``("pod", *spec)``,
    ``batch`` this rank's shard. ``loss_and_grad_fn(params, batch)``
    returns this rank's loss and each gradient summed over the ``inner``
    batch axes into its parameter's layout (``sharding.ModelCall``'s
    reads): a DTensor that says replicated over ``pod`` but holds this
    pod's value. Its block is taken before anything reads it as a
    DTensor, divided by the ``inner`` count (the pod's mean, in fp32),
    and goes through ``compressed_psum_pod`` with the residual's block;
    the mean, the same on every pod, is wrapped back in the parameter's
    layout, the new residual in the residual's. The loss is the mean
    over the ranks of the pod and then over the pods (``pmean``)."""
    size = dict(zip(mesh.mesh_dim_names, mesh.shape))
    inner = tuple(a for a in inner if a in size)
    n_inner = math.prod(size[a] for a in inner)
    n_all = n_inner * size["pod"]

    def wrap(x, like):
        return DTensor.from_local(x, like.device_mesh, like.placements,
                                  run_check=False, shape=like.shape,
                                  stride=like.stride())

    def fn(params, err, batch):
        loss, grads = loss_and_grad_fn(params, batch)
        blocks = tree_map(lambda g: SHD.local(g) / n_inner if n_inner > 1
                          else SHD.local(g), grads)
        mean, new_err = compressed_psum_pod(
            blocks, tree_map(lambda e: SHD.local(e)[0], err), mesh)
        loss = SHD.mean_over(loss, mesh, ("pod",) + inner, n_all)
        return (loss, tree_map(wrap, mean, params),
                tree_map(lambda e, old: wrap(e[None], old), new_err, err))

    return fn


def init_error_feedback(params, n_pods: int = 1):
    """Per-pod residual state: leading axis = pod."""
    return tree_map(lambda p: torch.zeros((n_pods,) + tuple(p.shape),
                                          dtype=torch.float32,
                                          device=p.device), params)
