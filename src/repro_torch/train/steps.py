"""Step builders: (ArchSpec, shape) -> a step on one device — the port
of the LM, GNN and recsys parts of ``repro.train.steps``.

A train ``StepBundle`` holds ``fn = train_step(state, batch) -> (state,
{"loss", "gnorm"})`` with ``state = {"params", "opt", "step"}``, the
tree ``repro``'s step carries (``repro_torch.tree``); an LM's state is
held in ``spec.param_dtype``. DIEN's serve and retrieval bundles hold
``fn(params, batch)`` (CTR probabilities [B]; scores [B, C]). An LM's
prefill bundle holds ``fn(params, batch) -> (logits [B, 1, V], cache)``
and its decode bundle ``fn(params, cache, last_tokens) -> (logits [B,
1, V], cache)``, writing the cache in place (``repro``'s bundle donates
it). One card needs no mesh and no sharding: the bundle's ``device``
(``device=None`` is the card) is where ``launch/train.py`` places the
state and the batch.

The train step is functional, as ``repro``'s jitted step is: it returns a new
state and leaves its input alone. The loss runs on detached aliases of
the parameters (a module's through ``torch.func.functional_call``),
the optimizer (``optim/``) builds new tensors, and nothing of the state
is updated in place. So a caller that drops a step's result (the
fault-tolerant runner on a non-finite loss or an exception mid-step,
``fault/runner.py``) still holds the state from before that step, with
no snapshot. The step reads nothing back to the host.

``overrides`` (the LM train step, as ``repro``'s): ``grad_accum`` splits
the batch into that many micro-batches along axis 0 and sums their
gradients into fp32 zeros and their losses in fp32, both divided by the
count (``repro``'s ``micro`` scan, a Python loop here); ``warmup`` is
the schedule's warm-up; ``accum_unroll`` (a ``lax.scan`` hint) is
ignored; ``compress_pods`` needs a ``pod`` axis of several cards and
raises.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn
from torch.func import functional_call

from repro_torch.configs.base import ArchSpec
from repro_torch.graphs import segment_ops as sops
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import dien as D
from repro_torch.models import dimenet as DN
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, adafactor, adamw, warmup_cosine
from repro_torch.tree import (flatten_with_paths, leaves, tree_map,
                              unflatten_paths)


@dataclasses.dataclass
class StepBundle:
    name: str
    fn: Callable          # train: (state, batch) -> (state, metrics);
                          # serve/retrieval: (params, batch) -> output
    device: torch.device
    optimizer: Optimizer | None = None     # None: a serve/retrieval bundle
    static_meta: dict = dataclasses.field(default_factory=dict)


def make_optimizer(name: str, total_steps: int = 100_000,
                   warmup: int = 2000):
    sched = warmup_cosine(warmup, total_steps)
    if name == "adafactor":
        return adafactor(lr=1e-2, schedule=sched)
    return adamw(lr=3e-4, schedule=sched)


# ============================================================ LM family
def build_lm_bundle(spec: ArchSpec, shape_name: str, device=None,
                    overrides: dict | None = None) -> StepBundle:
    """An LM's ``train``, ``prefill`` or ``decode`` step on ``device``
    (the card unless the caller names the CPU); ``static_meta["cfg"]``
    is the config. ``overrides`` is read by the train step."""
    device = resolve_device(device)
    shp = spec.shape(shape_name)
    cfg = spec.model_cfg
    name = f"{spec.arch_id}:{shape_name}:{shp.kind}"

    if shp.kind == "train":
        ov = overrides or {}
        if ov.get("compress_pods"):
            raise ValueError("compress_pods (int8 gradients across pods) "
                             "needs a pod axis: it comes with the "
                             "multi-card slice")
        opt = make_optimizer(spec.optimizer,
                             warmup=int(ov.get("warmup", 2000)))

        def loss_fn(params, batch):
            return T.lm_loss(params, cfg, batch["tokens"], batch["targets"])

        return StepBundle(name=name, fn=_train_step(
            opt, loss_fn, int(ov.get("grad_accum", 1))), device=device,
            optimizer=opt, static_meta={"cfg": cfg})

    if shp.kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return T.prefill(params, cfg, batch["tokens"], shp.seq_len)
        return StepBundle(name=name, fn=prefill_step, device=device,
                          static_meta={"cfg": cfg})

    if shp.kind == "decode":
        def decode_step(params, cache, last_tokens):
            with torch.no_grad():
                return T.decode_step(params, cfg, cache, last_tokens)
        return StepBundle(name=name, fn=decode_step, device=device,
                          static_meta={"cfg": cfg})
    raise KeyError(shp.kind)


# =========================================================== GNN family
def _adapt_gnn_cfg(cfg, shp):
    t = type(cfg).__name__
    if t in ("GCNConfig", "SAGEConfig"):
        return dataclasses.replace(cfg, d_in=shp.d_feat,
                                   n_classes=max(shp.n_classes, 1))
    if t == "EGNNConfig":
        return dataclasses.replace(cfg, d_in=shp.d_feat,
                                   n_out=max(shp.n_classes, 1))
    if t == "DimeNetConfig":
        return cfg    # n_out=1 on every shape, as in repro
    raise KeyError(f"{t} is not ported yet")


def _gnn_model(cfg, generator=None) -> nn.Module:
    t = type(cfg).__name__
    if t == "GCNConfig":
        return G.GCN(cfg, generator)
    if t == "SAGEConfig":
        return G.SAGE(cfg, generator)
    if t == "EGNNConfig":
        return G.EGNN(cfg, generator)
    if t == "DimeNetConfig":
        return DN.DimeNet(cfg, generator)
    raise KeyError(f"{t} is not ported yet")


def _gnn_init(cfg, generator: torch.Generator) -> dict:
    """Initial parameters (``repro``'s tree, on the CPU) drawn from
    ``generator``."""
    return L.params_tree(_gnn_model(cfg, generator))


def _gnn_node_out(model, params, batch):
    """``params``: the flat dotted dict ``functional_call`` takes."""
    if isinstance(model, G.GCN):
        args = (batch["feats"], batch["edge_src"], batch["edge_dst"],
                batch["deg"])
    elif isinstance(model, G.SAGE):
        args = (batch["feats"], batch["edge_src"], batch["edge_dst"])
    elif isinstance(model, G.EGNN):
        args = (batch["feats"], batch["coords"], batch["edge_src"],
                batch["edge_dst"])
    else:
        args = (batch["atom_z"], batch["coords"], batch["edge_src"],
                batch["edge_dst"], batch["trip_kj"], batch["trip_ji"])
    out = functional_call(model, params, args)
    return out[0] if isinstance(model, (G.EGNN, DN.DimeNet)) else out


def gnn_loss(model, params, batch, kind: str):
    node_out = _gnn_node_out(model, params, batch)
    if kind in ("full", "minibatch"):
        if isinstance(model, DN.DimeNet):
            # DimeNet emits n_out=1: repro's regression-on-label proxy
            pred = node_out[..., 0]
            per = torch.square(pred - batch["labels"].to(torch.float32))
            return torch.sum(per * batch["mask"]) / torch.clamp(
                torch.sum(batch["mask"]), min=1.0)
        ce = L.softmax_cross_entropy(node_out, batch["labels"])
        return torch.sum(ce * batch["mask"]) / torch.clamp(
            torch.sum(batch["mask"]), min=1.0)
    # molecule: graph-level regression (sum-pool over graph_ids)
    b = batch["targets"].shape[0]
    pooled = sops.segment_sum(node_out[..., 0], batch["graph_ids"], b + 1)[:b]
    return torch.mean(torch.square(pooled - batch["targets"]))


def build_gnn_bundle(spec: ArchSpec, shape_name: str,
                     device=None) -> StepBundle:
    device = resolve_device(device)
    shp = spec.shape(shape_name)
    cfg = _adapt_gnn_cfg(spec.model_cfg, shp)
    with torch.device("meta"):      # a structure for functional_call
        model = _gnn_model(cfg)
    opt = make_optimizer(spec.optimizer)
    train_step = _train_step(opt, lambda params, batch: gnn_loss(
        model, L.dotted(params), batch, shp.kind))
    return StepBundle(name=f"{spec.arch_id}:{shape_name}:train",
                      fn=train_step, device=device, optimizer=opt,
                      static_meta={"cfg": cfg})


def _micro_batches(batch: dict, accum: int) -> list:
    """``batch`` cut into ``accum`` consecutive blocks along axis 0
    (``repro``'s ``reshape(accum, B // accum, ...)``)."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"a batch of {b} does not split into {accum} "
                         "micro-batches")
    return [{k: v[i * (b // accum):(i + 1) * (b // accum)]
             for k, v in batch.items()} for i in range(accum)]


def _train_step(opt: Optimizer, loss_fn, accum: int = 1):
    """``train_step(state, batch)`` over ``loss_fn(params, batch)``
    (``params``: the nested parameter tree), with ``accum`` micro-batches
    (the module docstring)."""

    def value_and_grad(state_params, batch):
        paths = [k for k, _ in flatten_with_paths(state_params)]
        params = tree_map(lambda v: v.detach().requires_grad_(), state_params)
        loss = loss_fn(params, batch)
        # a parameter the loss does not reach (EGNN's last phi_x) gets a
        # zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), unflatten_paths(zip(paths, grads))

    def train_step(state, batch):
        if accum > 1:
            # fp32 sums, as repro's scan carries them: a bf16 model hands
            # its optimizer fp32 gradients. The sums are this step's own
            # tensors, so they are added to in place.
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device),
                state["params"])
            loss = None
            for micro in _micro_batches(batch, accum):
                loss_i, grads_i = value_and_grad(state["params"], micro)
                tree_map(torch.Tensor.add_, grads, grads_i)
                loss = loss_i if loss is None else loss + loss_i
                del grads_i
            tree_map(lambda g: g.div_(accum), grads)
            loss = loss / accum
        else:
            loss, grads = value_and_grad(state["params"], batch)
        new_p, new_opt, gnorm = opt.update(grads, state["opt"],
                                           state["params"], state["step"])
        return ({"params": new_p, "opt": new_opt, "step": state["step"] + 1},
                {"loss": loss, "gnorm": gnorm})

    return train_step


# ======================================================== recsys family
def build_recsys_bundle(spec: ArchSpec, shape_name: str,
                        device=None) -> StepBundle:
    """DIEN on one card: ``train`` (``dien_loss``, AdamW), ``serve``
    (``sigmoid(logit)``) or ``retrieval`` (``retrieval_scores``)."""
    device = resolve_device(device)
    shp = spec.shape(shape_name)
    cfg = spec.model_cfg
    with torch.device("meta"):      # a structure for functional_call
        model = D.DIEN(cfg)
    name = f"{spec.arch_id}:{shape_name}:{shp.kind}"

    if shp.kind == "train":
        opt = make_optimizer(spec.optimizer)
        train_step = _train_step(opt, lambda params, batch: D.dien_loss(
            model, L.dotted(params), batch))
        return StepBundle(name=name, fn=train_step, device=device,
                          optimizer=opt, static_meta={"cfg": cfg})

    if shp.kind == "serve":
        def serve_step(params, batch):
            with torch.no_grad():
                return torch.sigmoid(D.dien_forward(
                    model, L.dotted(params), batch, kind="serve"))
        return StepBundle(name=name, fn=serve_step, device=device,
                          static_meta={"cfg": cfg})

    if shp.kind == "retrieval":
        def retrieval_step(params, batch):
            with torch.no_grad():
                return D.retrieval_scores(model, L.dotted(params), batch)
        return StepBundle(name=name, fn=retrieval_step, device=device,
                          static_meta={"cfg": cfg})
    raise KeyError(shp.kind)


# ------------------------------------------------------------- dispatcher
def build_bundle(spec: ArchSpec, shape_name: str, device=None,
                 overrides: dict | None = None) -> StepBundle:
    """``overrides``: the LM train step's (``build_lm_bundle``); the other
    families take none, as in ``repro``."""
    if spec.family == "lm":
        return build_lm_bundle(spec, shape_name, device, overrides)
    if spec.family == "gnn":
        return build_gnn_bundle(spec, shape_name, device)
    if spec.family == "recsys":
        return build_recsys_bundle(spec, shape_name, device)
    raise KeyError(f"the {spec.family!r} family's steps are not ported yet")
