"""Step builders: (ArchSpec, shape[, mesh]) -> a step — the port of
``repro.train.steps``.

A train ``StepBundle`` holds ``fn = train_step(state, batch) -> (state,
{"loss", "gnorm"})`` with ``state = {"params", "opt", "step"}``, the
tree ``repro``'s step carries (``repro_torch.tree``); an LM's state is
held in ``spec.param_dtype``. DIEN's serve and retrieval bundles hold
``fn(params, batch)`` (CTR probabilities [B]; scores [B, C]). An LM's
prefill bundle holds ``fn(params, batch) -> (logits [B, 1, V], cache)``
and its decode bundle ``fn(params, cache, last_tokens) -> (logits [B,
1, V], cache)``, writing the cache in place (``repro``'s bundle donates
it). The ``islabel`` bundles (``build_islabel_bundle``) hold the query
step ``fn(batch) -> dist [Q]`` and one peel level ``fn(batch, perm)``.
Without a mesh the bundle's ``device`` (``device=None`` is the card) is
where the caller places the state and the batch.

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
ignored; ``compress_pods`` reduces the gradients across the mesh's
``pod`` axis in int8 with error feedback (``distributed/compression``;
the state gains ``err``, laid out ``("pod", *spec)``), and is ignored
without a ``pod`` axis, as in ``repro``. With it ``grad_accum`` is
ignored and the batch laid out ``(dp, None)``, as ``repro``'s compressed
step has no micro loop (``static_meta["grad_accum"]`` is 1); a rule
that shards a parameter over ``pod`` (``fsdp_over_pod``) is refused at
build (``ValueError``), where ``repro`` raises ``DuplicateSpecError``.

**On a mesh** (``mesh=``, a ``DeviceMesh`` from ``launch/mesh.py``) the
bundle carries ``shardings`` (``{"state": ..., "batch": ...}`` trees of
``distributed.sharding.NamedSharding``, ``repro``'s in_shardings) and
``place_state`` / ``place_batch`` lay a whole state or batch out as
DTensors by them. DTensor runs the optimizer shard by shard and inserts
the collectives it needs (the global norm's all-reduce); the model's
forward and backward have no DTensor strategy for every op they use
(the embedding gather, the MoE's stable sort and its index writes,
``scatter_reduce``, ``index_add_``), so each family's model runs on
plain tensors, with explicit collectives around it:

* LM (train, prefill, decode): the model splits its compute over
  ``model`` as ``repro``'s rules split the weights (tensor-parallel
  attention and SwiGLU, the vocabulary-parallel embedding, logits and
  loss, the MoE by experts or by each expert's ffn:
  ``models/transformer.py``). It reads each layer's parameters through
  a ``ModelCall`` (``distributed/sharding.py``): gathered over the FSDP
  axes, this rank's ``model`` block kept. Each rank runs its own shard
  of the batch (``dp_axes``), the same on every rank of a ``model``
  group. The gradients come back summed over the batch's axes into
  each parameter's layout (a reduce-scatter where it is sharded, an
  all-reduce where it is not), and the step divides them by the number
  of batch shards. An LM's batch is laid out by micro-batch under
  ``grad_accum`` (``NamedSharding.micro``), so each rank's micro-batch i
  is its share of the global micro-batch i, and an MoE routes its share
  as part of that micro-batch (``models/moe.py``). The prefill and
  decode cache [L, B, S, KV, Dh] takes ``repro``'s layout ``(None, dp,
  "model", None, None)``: the batch over ``dp``, the sequence over
  ``model``; the logits ``(dp, None, "model")``, each rank's block of
  the vocabulary.
* DIEN: each rank runs its batch shard (``dp_axes``) and reads each
  table from its own ``model`` block of rows (a masked local gather
  summed over ``model``: ``models/embedding.lookup_split``); no rank
  holds a table or its gradient whole. The towers are read whole. The
  loss is the whole batch's on every rank (its sums over the batch
  shards), so the gradients are summed, not averaged. Retrieval's
  candidates (over every axis) are read by their ``model`` group and
  reduce-scattered back to their ranks.
* GNNs: the node and edge arrays stay in their blocks over every axis
  (``distributed/sharding.GraphSplit``): each rank runs the dense
  products on its node block and the messages of its edges, gathering
  the node rows its edges read and reduce-scattering their sums back to
  node blocks; the loss's sums are summed over the ranks. The
  parameters are replicated and read whole.
* ``compress_pods`` (``repro``'s ``shard_map`` over ``pod``): each pod
  runs the LM step above on its own batch, the call's batch axes
  ``dp`` without ``pod``: the model split over ``model``, the parameters
  read over ``data`` as above (replicated across pods), an MoE routing
  the pod's batch (its capacity, ranks and load-balance means the
  pod's), the loss the pod's. Each rank's block of each gradient, its
  pod's mean, goes through the int8 exchange with its block of the
  residual (``distributed/compression``); no rank holds a parameter,
  gradient or residual whole.
* ``islabel`` query: each rank gathers the label rows and core
  positions of every query from its own block of rows (a masked local
  gather and one all-reduce), the core edges are gathered whole, and
  each rank relaxes its ``dp_axes`` share of the queries. A peel level
  gathers its edge list and runs whole on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.func import functional_call

from repro_torch.configs.base import ArchSpec
from repro_torch.distributed import sharding as SHD
from repro_torch.graphs import segment_ops as sops
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import dien as D
from repro_torch.models import dimenet as DN
from repro_torch.models import gnn as G
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import Optimizer, adafactor, adamw, warmup_cosine
from repro_torch.launch.mesh import axis_names, axis_size, dp_axes
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
    mesh: object = None                    # a DeviceMesh, or one device
    shardings: dict = dataclasses.field(default_factory=dict)

    def place_state(self, state):
        """A whole state (the same on every rank) laid out on the mesh by
        ``shardings["state"]``; unchanged without a mesh."""
        if self.mesh is None:
            return state
        return SHD.place_tree(state, self.shardings["state"])

    def place_batch(self, batch):
        """A whole batch laid out on the mesh by ``shardings["batch"]``."""
        if self.mesh is None:
            return batch
        return SHD.place_tree(batch, self.shardings["batch"])


def make_optimizer(name: str, total_steps: int = 100_000,
                   warmup: int = 2000):
    sched = warmup_cosine(warmup, total_steps)
    if name == "adafactor":
        return adafactor(lr=1e-2, schedule=sched)
    return adamw(lr=3e-4, schedule=sched)


# ============================================================ LM family
def lm_rules(spec: ArchSpec, mesh) -> dict:
    cfg = spec.model_cfg
    rules = dict(SHD.LM_RULES)
    names = axis_names(mesh)
    if spec.fsdp_over_pod and "pod" in names:
        rules["embed"] = ("pod", "data")
    if cfg.moe is not None:
        # EP over the model axis when the expert count divides it;
        # otherwise TP inside each expert's ffn dim (qwen2-moe: 60 % 16 != 0)
        if cfg.moe.n_total % axis_size(mesh, "model") == 0:
            rules["experts"], rules["expert_mlp"] = "model", None
        else:
            rules["experts"], rules["expert_mlp"] = None, "model"
    return rules


def _ns(mesh, *parts):
    return SHD.NamedSharding(mesh, tuple(parts))


def _lm_param_shardings(spec: ArchSpec, mesh):
    return SHD.tree_shardings(T.lm_axes(spec.model_cfg), lm_rules(spec, mesh),
                              mesh)


def build_lm_bundle(spec: ArchSpec, shape_name: str, device=None,
                    overrides: dict | None = None, mesh=None) -> StepBundle:
    """An LM's ``train``, ``prefill`` or ``decode`` step on ``device``
    (the card unless the caller names the CPU) or over ``mesh``;
    ``static_meta["cfg"]`` is the config. ``overrides`` is read by the
    train step."""
    device = resolve_device(device)
    shp = spec.shape(shape_name)
    cfg = spec.model_cfg
    name = f"{spec.arch_id}:{shape_name}:{shp.kind}"
    shardings = {}
    dist = None
    ov = overrides or {}
    compress = shp.kind == "train" and bool(ov.get("compress_pods")) and \
        mesh is not None and "pod" in axis_names(mesh)
    if mesh is not None:
        dp = dp_axes(mesh)
        param_sh = _lm_param_shardings(spec, mesh)
        # compress_pods: each pod runs the plain step's split on its own
        # batch (repro's shard_map over "pod"), so the call's batch axes
        # leave "pod" out
        dist = SHD.ModelCall(mesh, tuple(a for a in dp if a != "pod")
                             if compress else dp, "model")

    if shp.kind == "train":
        opt = make_optimizer(spec.optimizer,
                             warmup=int(ov.get("warmup", 2000)))

        def loss_fn(params, batch):
            return T.lm_loss(params, cfg, batch["tokens"], batch["targets"],
                             dist=dist)

        # repro's compressed step has no micro loop: grad_accum is ignored
        accum = 1 if compress else int(ov.get("grad_accum", 1))
        meta = {"cfg": cfg, "compress": compress, "grad_accum": accum}
        if mesh is not None:
            state_sh = {"params": param_sh,
                        "opt": SHD.opt_state_shardings(
                            spec.optimizer, T.abstract_params(cfg), param_sh,
                            mesh),
                        "step": _ns(mesh)}
            if compress:
                # a spec that names "pod" already (fsdp_over_pod) would
                # name it twice in ("pod", *spec): refused here, at build,
                # as repro's shard_map refuses it
                if any("pod" in ((e,) if isinstance(e, str) else e or ())
                       for sh in leaves(param_sh) for e in sh.spec):
                    raise ValueError("compress_pods lays the residual out "
                                     "as ('pod', *spec): a parameter spec "
                                     "that shards over 'pod' names 'pod' "
                                     "twice")
                state_sh["err"] = tree_map(
                    lambda sh: _ns(mesh, "pod", *sh.spec), param_sh)
                meta["n_pods"] = axis_size(mesh, "pod")
            # [B, S] laid out as [accum, B / accum, S], dim 1 over dp
            rows = (SHD.NamedSharding(mesh, (None, dp, None), micro=accum)
                    if accum > 1 else _ns(mesh, dp, None))
            shardings = {"state": state_sh,
                         "batch": {k: rows for k in ("tokens", "targets")}}
        grad_fn = _value_and_grad(loss_fn, accum)

        def local_batch(batch):
            return tree_map(lambda v: SHD.local(v).flatten(0, 1)
                            if accum > 1 else SHD.local(v), batch)
        fn = (_compressed_train_step(opt, grad_fn, dist, local_batch)
              if compress else _train_step(opt, grad_fn, dist, local_batch))
        return StepBundle(name=name + ("+int8pods" if compress else ""),
                          fn=fn, device=device, optimizer=opt,
                          static_meta=meta, mesh=mesh, shardings=shardings)

    if mesh is not None:
        # repro's cache_sh: the batch over dp, the sequence over "model"
        cache_sh = {"k": _ns(mesh, None, dp, "model", None, None),
                    "v": _ns(mesh, None, dp, "model", None, None),
                    "len": _ns(mesh)}
        logits_sh = _ns(mesh, dp, None, "model")

        def logits_out(logits, b):
            return SHD.from_local(logits, logits_sh, (b, 1, cfg.vocab))
    if shp.kind == "prefill":
        def prefill_step(params, batch):
            with torch.no_grad():
                return T.prefill(params, cfg, batch["tokens"], shp.seq_len)
        fn = prefill_step
        if mesh is not None:
            shardings = {"state": {"params": param_sh},
                         "batch": {"tokens": _ns(mesh, dp, None)}}

            def fn(params, batch):
                with torch.no_grad():
                    logits, cache = T.prefill(
                        params, cfg, SHD.local(batch["tokens"]), shp.seq_len,
                        dist)
                b = batch["tokens"].shape[0]
                kv = (cfg.n_layers, b, shp.seq_len, cfg.n_kv_heads, cfg.hd)
                return (logits_out(logits, b),
                        {k: SHD.from_local(v, cache_sh[k],
                                           kv if k != "len" else ())
                         for k, v in cache.items()})
        return StepBundle(name=name, fn=fn, device=device,
                          static_meta={"cfg": cfg}, mesh=mesh,
                          shardings=shardings)

    if shp.kind == "decode":
        def decode_step(params, cache, last_tokens):
            with torch.no_grad():
                return T.decode_step(params, cfg, cache, last_tokens)
        fn = decode_step
        if mesh is not None:
            shardings = {"state": {"params": param_sh},
                         "batch": {"cache": cache_sh,
                                   "last_tokens": _ns(mesh, dp, None)}}

            def fn(params, cache, last_tokens):
                with torch.no_grad():
                    logits, new = T.decode_step(
                        params, cfg, {k: SHD.local(v) for k, v in
                                      cache.items()},
                        SHD.local(last_tokens), dist,
                        max_len=cache["k"].shape[2])
                return (logits_out(logits, last_tokens.shape[0]),
                        {k: SHD.from_local(v, cache_sh[k],
                                           tuple(cache[k].shape))
                         for k, v in new.items()})
        return StepBundle(name=name, fn=fn, device=device,
                          static_meta={"cfg": cfg}, mesh=mesh,
                          shardings=shardings)
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


def _gnn_node_out(model, params, batch, split=None):
    """``params``: the flat dotted dict ``functional_call`` takes;
    ``split``: the ``GraphSplit`` of a mesh step."""
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
    out = functional_call(model, params, args, {"split": split})
    return out[0] if isinstance(model, (G.EGNN, DN.DimeNet)) else out


def gnn_loss(model, params, batch, kind: str, split=None):
    """The loss over the whole graph. On a mesh (``split``) the node
    outputs are this rank's block: the masked terms and the mask, or the
    graphs' pooled sums, are summed over the ranks (``split.total``), so
    every rank holds the whole loss and its gradient reaches this rank's
    terms only."""
    total = (lambda x: x) if split is None else split.total
    node_out = _gnn_node_out(model, params, batch, split)
    if kind in ("full", "minibatch"):
        if isinstance(model, DN.DimeNet):
            # DimeNet emits n_out=1: repro's regression-on-label proxy
            pred = node_out[..., 0]
            per = torch.square(pred - batch["labels"].to(torch.float32))
        else:
            per = L.softmax_cross_entropy(node_out, batch["labels"])
        return total(torch.sum(per * batch["mask"])) / torch.clamp(
            total(torch.sum(batch["mask"])), min=1.0)
    # molecule: graph-level regression (sum-pool over graph_ids)
    b = batch["targets"].shape[0]
    pooled = total(sops.segment_sum(node_out[..., 0], batch["graph_ids"],
                                    b + 1))[:b]
    return torch.mean(torch.square(pooled - batch["targets"]))


def build_gnn_bundle(spec: ArchSpec, shape_name: str, device=None,
                     mesh=None) -> StepBundle:
    device = resolve_device(device)
    shp = spec.shape(shape_name)
    cfg = _adapt_gnn_cfg(spec.model_cfg, shp)
    with torch.device("meta"):      # a structure for functional_call
        model = _gnn_model(cfg)
    opt = make_optimizer(spec.optimizer)
    shardings = {}
    dist = split = None
    if mesh is not None:
        allx = axis_names(mesh)
        specs = spec.input_specs(shape_name)
        batch_sh = {k: _ns(mesh, allx, *([None] * (len(v.shape) - 1)))
                    for k, v in specs.items()}
        if shp.kind == "molecule":
            # the molecule batch's own keys (make_batch_fn), read or not
            batch_sh.update(targets=_ns(mesh, None), coords=_ns(mesh, allx),
                            atom_z=_ns(mesh, allx))
        params = L.params_tree(model)
        param_sh = SHD.like_tree(params, _ns(mesh))     # replicated (tiny)
        shardings = {"state": {"params": param_sh,
                               "opt": SHD.like_tree(opt.init(params),
                                                    _ns(mesh)),
                               "step": _ns(mesh)},
                     "batch": batch_sh}
        # node and edge arrays in blocks over every axis (GraphSplit)
        dist = SHD.ModelCall(mesh, allx, None)
        split = SHD.GraphSplit(specs["feats"].shape[0],
                               specs["edge_src"].shape[0], dist)
    train_step = _train_step(opt, _value_and_grad(
        lambda params, batch: gnn_loss(model, L.dotted(_whole(dist, params)),
                                       batch, shp.kind, split)), dist,
        lambda batch: tree_map(SHD.local, batch), whole_loss=True)
    return StepBundle(name=f"{spec.arch_id}:{shape_name}:train",
                      fn=train_step, device=device, optimizer=opt,
                      static_meta={"cfg": cfg}, mesh=mesh,
                      shardings=shardings)


def _micro_batches(batch: dict, accum: int) -> list:
    """``batch`` cut into ``accum`` consecutive blocks along axis 0
    (``repro``'s ``reshape(accum, B // accum, ...)``)."""
    b = next(iter(batch.values())).shape[0]
    if b % accum:
        raise ValueError(f"a batch of {b} does not split into {accum} "
                         "micro-batches")
    return [{k: v[i * (b // accum):(i + 1) * (b // accum)]
             for k, v in batch.items()} for i in range(accum)]


def _value_and_grad(loss_fn, accum: int = 1):
    """``(params, batch) -> (loss, grads)`` over ``loss_fn(params,
    batch)`` (``params``: the nested parameter tree of plain tensors),
    with ``accum`` micro-batches (the module docstring)."""

    def value_and_grad(state_params, batch):
        paths = [k for k, _ in flatten_with_paths(state_params)]
        params = tree_map(lambda v: v.detach().requires_grad_(), state_params)
        loss = loss_fn(params, batch)
        # a parameter the loss does not reach (EGNN's last phi_x) gets a
        # zero gradient, as under jax.grad
        grads = torch.autograd.grad(loss, leaves(params), allow_unused=True,
                                    materialize_grads=True)
        return loss.detach(), unflatten_paths(zip(paths, grads))

    if accum == 1:
        return value_and_grad

    def accumulated(state_params, batch):
        # fp32 sums, as repro's scan carries them: a bf16 model hands
        # its optimizer fp32 gradients. The sums are this step's own
        # tensors, so they are added to in place.
        grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                         state_params)
        loss = None
        for micro in _micro_batches(batch, accum):
            loss_i, grads_i = value_and_grad(state_params, micro)
            tree_map(torch.Tensor.add_, grads, grads_i)
            loss = loss_i if loss is None else loss + loss_i
            del grads_i
        tree_map(lambda g: g.div_(accum), grads)
        return loss / accum, grads

    return accumulated


def _whole(dist, params):
    """Every parameter whole (``ModelCall.whole``); as they are off a
    mesh."""
    return params if dist is None else tree_map(dist.whole, params)


def _train_step(opt: Optimizer, grad_fn, dist=None, local_batch=None,
                whole_loss: bool = False):
    """``train_step(state, batch)`` over ``grad_fn(params, batch) ->
    (loss, grads)``. On a mesh (``dist``, the module docstring) the
    model gets the parameters as DTensors and ``local_batch(batch)``,
    this rank's plain batch; the gradients come back summed over
    ``dist.dp`` in each parameter's layout and are divided by the shard
    count before the optimizer runs on the shards. With ``whole_loss``
    every rank's loss is the whole batch's (its terms summed over
    ``dp``: the GNNs, DIEN), so the summed gradients are the whole
    gradient and nothing is divided."""
    if dist is None:
        def train_step(state, batch):
            loss, grads = grad_fn(state["params"], batch)
            new_p, new_opt, gnorm = opt.update(grads, state["opt"],
                                               state["params"], state["step"])
            return ({"params": new_p, "opt": new_opt,
                     "step": state["step"] + 1},
                    {"loss": loss, "gnorm": gnorm})
        return train_step

    mesh, dp = dist.mesh, dist.dp
    n_dp = 1 if whole_loss else axis_size(mesh, dp)

    def train_step(state, batch):
        loss, grads = grad_fn(state["params"], local_batch(batch))
        if n_dp > 1:
            grads = tree_map(lambda g: g / n_dp, grads)
        new_p, new_opt, gnorm = opt.update(grads, state["opt"],
                                           state["params"], state["step"])
        return ({"params": _as_before(new_p, state["params"]),
                 "opt": _as_before(new_opt, state["opt"]),
                 "step": state["step"] + 1},
                {"loss": loss if whole_loss else
                 SHD.mean_over(loss, mesh, dp, n_dp),
                 "gnorm": SHD.gather(gnorm)})

    return train_step


def _as_before(new, old):
    """Each DTensor of ``new`` in the placements of its leaf in ``old``:
    DTensor's strategies may lay an optimizer's result out otherwise
    (Adafactor's factored product, ``rfac ⊗ vc``)."""
    def one(n, o):
        if isinstance(n, DTensor) and n.placements != o.placements:
            return n.redistribute(o.device_mesh, o.placements)
        return n
    return tree_map(one, new, old)


def _compressed_train_step(opt: Optimizer, grad_fn, dist, local_batch):
    """The LM step with ``compress_pods``: ``repro``'s ``train+int8pods``
    step (``distributed/compression.make_compressed_grad_fn``). Each pod
    runs the plain mesh step's split compute on its batch (``dist.dp``
    without ``pod``); each rank's block of each gradient, its pod's mean,
    goes through the int8 exchange with its block of the residual
    ``err``, and the optimizer runs on the blocks of the mean, the same
    on every pod."""
    from repro_torch.distributed.compression import make_compressed_grad_fn
    cg = make_compressed_grad_fn(grad_fn, dist.mesh, dist.dp)

    def train_step(state, batch):
        loss, grads, new_err = cg(state["params"], state["err"],
                                  local_batch(batch))
        new_p, new_opt, gnorm = opt.update(grads, state["opt"],
                                           state["params"], state["step"])
        return ({"params": _as_before(new_p, state["params"]),
                 "opt": _as_before(new_opt, state["opt"]), "err": new_err,
                 "step": state["step"] + 1},
                {"loss": loss, "gnorm": SHD.gather(gnorm)})

    return train_step


# ======================================================== recsys family
def _recsys_reads(dist, params, axes):
    """Each DIEN parameter as the model reads it on a mesh: a table's rows
    this rank's ``model`` block (``ModelCall.shard``), the towers whole;
    as they are off a mesh."""
    if dist is None:
        return params
    return tree_map(lambda p, ax: dist.shard(p) if ax[0] == "table_rows"
                    else dist.whole(p), params, axes)


def build_recsys_bundle(spec: ArchSpec, shape_name: str, device=None,
                        mesh=None) -> StepBundle:
    """DIEN: ``train`` (``dien_loss``, AdamW), ``serve``
    (``sigmoid(logit)``) or ``retrieval`` (``retrieval_scores``), on one
    device or over ``mesh``: the tables' rows over ``model``, each rank
    reading its own block (``models/dien.py``), the batch over the data
    axes where it divides among them (replicated where it does not)."""
    device = resolve_device(device)
    shp = spec.shape(shape_name)
    cfg = spec.model_cfg
    with torch.device("meta"):      # a structure for functional_call
        model = D.DIEN(cfg)
    name = f"{spec.arch_id}:{shape_name}:{shp.kind}"
    shardings = {}
    dist = None
    axes = D.dien_axes(cfg)
    if mesh is not None:
        dp = dp_axes(mesh)
        allx = axis_names(mesh)
        specs = spec.input_specs(shape_name)
        # a batch that does not divide over dp (retrieval's one query)
        # is replicated, and every rank runs all of it
        if shp.batch % axis_size(mesh, dp):
            dp = ()
        param_sh = SHD.tree_shardings(axes, SHD.RECSYS_RULES, mesh)
        batch_sh = {k: _ns(mesh, allx) if k == "cand_items" else
                    _ns(mesh, dp or None, *([None] * (len(v.shape) - 1)))
                    for k, v in specs.items()}
        shardings = {"state": {"params": param_sh}, "batch": batch_sh}
        dist = SHD.ModelCall(mesh, dp)

    if shp.kind == "train":
        opt = make_optimizer(spec.optimizer)
        if mesh is not None:
            params = L.params_tree(model)
            shardings["state"] = {
                "params": param_sh, "step": _ns(mesh),
                "opt": SHD.opt_state_shardings(spec.optimizer, params,
                                               param_sh, mesh)}
        train_step = _train_step(opt, _value_and_grad(
            lambda params, batch: D.dien_loss(
                model, L.dotted(_recsys_reads(dist, params, axes)), batch,
                dist)), dist, lambda batch: tree_map(SHD.local, batch),
            whole_loss=True)
        return StepBundle(name=name, fn=train_step, device=device,
                          optimizer=opt, static_meta={"cfg": cfg}, mesh=mesh,
                          shardings=shardings)

    if shp.kind == "serve":
        def step(params, batch):
            return torch.sigmoid(D.dien_forward(model, params, batch,
                                                kind="serve", dist=dist))
    elif shp.kind == "retrieval":
        def step(params, batch):
            return D.retrieval_scores(model, params, batch, dist)
    else:
        raise KeyError(shp.kind)

    def fn(params, batch):
        with torch.no_grad():
            return step(L.dotted(_recsys_reads(dist, params, axes)), batch)
    if mesh is not None:
        out_sh = _ns(mesh, dp or None) if shp.kind == "serve" else \
            _ns(mesh, None, allx)

        def fn(params, batch):
            # retrieval's candidates stay a DTensor (lookup_owned)
            local = {k: v if k == "cand_items" else SHD.local(v)
                     for k, v in batch.items()}
            with torch.no_grad():
                res = step(L.dotted(_recsys_reads(dist, params, axes)),
                           local)
            shape = (batch["user"].shape[0],) + (
                tuple(batch["cand_items"].shape) if "cand_items" in batch
                else ())
            return SHD.from_local(res, out_sh, shape)
    return StepBundle(name=name, fn=fn, device=device,
                      static_meta={"cfg": cfg}, mesh=mesh,
                      shardings=shardings)


# ================================================= IS-LABEL (the paper)
def _relax_round(d, src, dst, w, chunks: int):
    """One (min,+) round of ``d`` [Q, V] over the edges, in place:
    ``repro``'s ``d.at[:, dst].min(d[:, src] + w)``. With ``chunks`` the
    edges go in ``chunks`` consecutive slices of ``e // chunks`` (the
    remainder is dropped, as in ``repro``), each reading the ``d`` the
    slices before it left (Gauss-Seidel, ``repro``'s ``lax.scan``)."""
    q = d.shape[0]
    e = src.shape[0]
    step = e // chunks if chunks else e
    for i in range(chunks or 1):
        s_ = src[i * step:(i + 1) * step]
        t_ = dst[i * step:(i + 1) * step]
        cand = d[:, s_] + w[i * step:(i + 1) * step]
        d.scatter_reduce_(1, t_.expand(q, -1), cand, "amin")
    return d


def islabel_query(lbl_ids, lbl_d, core_pos, ce_src, ce_dst, ce_w, s, t, *,
                  n: int, n_core: int, relax_rounds: int = 8,
                  relax_chunks: int = 0, rows=None):
    """``repro``'s query step on plain tensors: Equation 1 over the
    endpoints' label rows, then two label-seeded frontiers [Q, n_core +
    1] relaxed ``relax_rounds`` fixed rounds, and the min of both.
    ``s``/``t`` read rows by jnp's gather rule (``core/labels.row_index``).
    ``rows``: the label rows of ``s`` and ``t`` (``(ids_s, d_s, ids_t,
    d_t)``, ``d`` as stored) already gathered, and ``core_pos`` then the
    ``(cpos_s, cpos_t)`` of their entries (the mesh path)."""
    from repro_torch.core.labels import row_index
    from repro_torch.core.query import label_intersect_mu
    if rows is None:
        nrows = lbl_ids.shape[0]
        si, ti = row_index(s.long(), nrows), row_index(t.long(), nrows)
        ids_s, d_s, ids_t, d_t = lbl_ids[si], lbl_d[si], lbl_ids[ti], lbl_d[ti]
        cpos_s = core_pos[row_index(torch.clamp(ids_s, max=n).long(), nrows)]
        cpos_t = core_pos[row_index(torch.clamp(ids_t, max=n).long(), nrows)]
    else:
        ids_s, d_s, ids_t, d_t = rows
        cpos_s, cpos_t = core_pos
    d_s, d_t = d_s.to(torch.float32), d_t.to(torch.float32)
    mu, _ = label_intersect_mu(ids_s, d_s, ids_t, d_t, n)
    q = ids_s.shape[0]
    inf = torch.tensor(float("inf"), device=d_s.device)
    src, dst = ce_src.long(), ce_dst.long()
    out = []
    for ids, dd, cpos in ((ids_s, d_s, cpos_s), (ids_t, d_t, cpos_t)):
        front = torch.full((q, n_core + 1), float("inf"), device=d_s.device)
        front.scatter_reduce_(1, cpos.long(), torch.where(ids < n, dd, inf),
                              "amin")
        for _ in range(relax_rounds):
            _relax_round(front, src, dst, ce_w, relax_chunks)
        out.append(front)
    if n_core:
        through = torch.min(out[0][:, :n_core] + out[1][:, :n_core], dim=1)[0]
    else:
        through = torch.full((q,), float("inf"), device=d_s.device)
    return torch.minimum(mu, through)


def islabel_level(src, dst, w, via, active, perm, *, n: int, d_cap: int,
                  aug_cap: int, mis_rounds: int | None = None):
    """One peel level (``repro``'s ``peel_level(...)[:5]``): the MIS of
    ``(deg, perm)`` keys run to its fixed point (a host read of the pool
    flag every 16 rounds; ``mis_rounds``: exactly that many rounds and
    no read, the dry run's trace), then ``core/hierarchy.peel_level``.
    Returns ``(o_src, o_dst, o_w, o_via, in_is)``."""
    from repro_torch.core import sync as hsync
    from repro_torch.core.hierarchy import peel_level
    from repro_torch.core.mis import MISState
    mis = MISState.start(src, dst, src < n, active, perm.to(torch.int32), n,
                         d_cap)
    if mis_rounds is not None:
        mis.advance(mis_rounds)
    while mis_rounds is None:
        mis.advance(16)
        if not bool(hsync.host_read(mis.pool_left())):
            break
    out = peel_level(src, dst, w, via, mis.in_is, n, d_cap, aug_cap)
    return out[0], out[1], out[2], out[3], mis.in_is


def _owned_rows(local_block, offset: int, idx, fill=0):
    """Rows ``idx`` (global row ids, [Q] or [Q, L]) of the plane whose
    rows ``[offset, offset + len(local_block))`` this rank holds: its
    own rows, ``fill`` elsewhere."""
    k = local_block.shape[0]
    mine = (idx >= offset) & (idx < offset + k)
    vals = local_block[torch.where(mine, idx - offset, 0)]
    shape = mine.shape + (1,) * (vals.dim() - mine.dim())
    return torch.where(mine.reshape(shape), vals,
                       torch.zeros((), dtype=vals.dtype, device=vals.device)
                       + fill)


def _row_offset(x) -> int:
    """The first global row of this rank's block of a DTensor sharded on
    dim 0 (``Shard``'s ``torch.chunk`` split, mesh dims in order)."""
    mesh, coord, size, off = x.device_mesh, x.device_mesh.get_coordinate(), \
        x.shape[0], 0
    for i, pl in enumerate(x.placements):
        if isinstance(pl, Shard) and pl.dim == 0:
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            off, size = off + start, min(chunk, size - start)
    return off


def build_islabel_bundle(spec: ArchSpec, shape_name: str, device=None,
                         overrides: dict | None = None,
                         mesh=None) -> StepBundle:
    """``repro``'s IS-LABEL bundles. ``query``: ``fn(batch) -> dist
    [Q]`` over the batch of ``spec.input_specs`` (``islabel_query``);
    overrides ``relax_rounds`` (8), ``relax_chunks`` (0: all edges at
    once) and ``lbl_dtype`` (the dtype ``lbl_d`` is stored in, read as
    fp32; ``static_meta["lbl_dtype"]``). ``build_level``: ``fn(batch,
    perm) -> (src, dst, w, via, in_is)`` (``islabel_level``), ``perm``
    the MIS tie-break permutation of [0, n) that ``repro`` draws from
    its key inside (the builder's permutation source)."""
    device = resolve_device(device)
    shp = spec.shape(shape_name)
    ov = overrides or {}
    shardings = {}
    if mesh is not None:
        dp, allx = dp_axes(mesh), axis_names(mesh)

    if shp.kind == "query":
        n, n_core = shp.n_vertices, shp.n_core
        kw = dict(n=n, n_core=n_core,
                  relax_rounds=int(ov.get("relax_rounds", 8)),
                  relax_chunks=int(ov.get("relax_chunks", 0)))
        meta = {"lbl_dtype": getattr(torch, ov.get("lbl_dtype") or
                                     "float32")}

        def query_step(batch):
            return islabel_query(*(batch[k] for k in (
                "lbl_ids", "lbl_d", "core_pos", "ce_src", "ce_dst", "ce_w",
                "s", "t")), **kw)
        fn = query_step
        if mesh is not None:
            shardings = {"batch": {
                "lbl_ids": _ns(mesh, allx, None),
                "lbl_d": _ns(mesh, allx, None),
                "core_pos": _ns(mesh, allx), "ce_src": _ns(mesh, allx),
                "ce_dst": _ns(mesh, allx), "ce_w": _ns(mesh, allx),
                "s": _ns(mesh, dp), "t": _ns(mesh, dp)}}
            out_sh = _ns(mesh, dp)
            everyone = tuple(Replicate() for _ in allx)

            def fn(batch):
                from repro_torch.core.labels import row_index
                nrows = batch["lbl_ids"].shape[0]
                off = _row_offset(batch["lbl_ids"])
                ends = [row_index(SHD.gather(batch[k]).long(), nrows) % nrows
                        for k in ("s", "t")]
                # every query's rows from each rank's own block: a masked
                # local gather, then one sum over all ranks (one owner a row)
                ids_l, d_l = SHD.local(batch["lbl_ids"]), SHD.local(
                    batch["lbl_d"])
                part = [_owned_rows(blk, off, e) for e in ends
                        for blk in (ids_l, d_l)]
                ids_s, d_s, ids_t, d_t = (
                    SHD.sum_to(x, mesh, allx, 1, everyone).to_local()
                    for x in part)
                cp_l, cp_off = SHD.local(batch["core_pos"]), _row_offset(
                    batch["core_pos"])
                cpos = [SHD.sum_to(_owned_rows(cp_l, cp_off, row_index(
                    torch.clamp(ids, max=n).long(), nrows) % nrows), mesh,
                    allx, 1, everyone).to_local() for ids in (ids_s, ids_t)]
                # this rank's dp share of the queries
                sl = SHD.local(batch["s"]).shape[0]
                lo = _row_offset(batch["s"])
                rows = tuple(x[lo:lo + sl] for x in (ids_s, d_s, ids_t, d_t))
                edges = [SHD.gather(batch[k]) for k in
                         ("ce_src", "ce_dst", "ce_w")]
                out = islabel_query(None, None, tuple(
                    c[lo:lo + sl] for c in cpos), *edges, None, None,
                    rows=rows, **kw)
                return SHD.from_local(out, out_sh)
        return StepBundle(name=f"islabel:{shape_name}:query", fn=fn,
                          device=device, static_meta=meta, mesh=mesh,
                          shardings=shardings)

    if shp.kind == "build_level":
        kw = dict(n=shp.n_vertices, d_cap=shp.d_cap, aug_cap=shp.e_cap // 2)

        def build_step(batch, perm, mis_rounds=None):
            return islabel_level(*(batch[k] for k in (
                "src", "dst", "w", "via", "active")), perm,
                mis_rounds=mis_rounds, **kw)
        fn = build_step
        if mesh is not None:
            shardings = {"batch": {k: _ns(mesh, allx) for k in (
                "src", "dst", "w", "via", "active")}}

            def fn(batch, perm, mis_rounds=None):
                # a whole level on every rank: its MIS and dedup sort have
                # no sharded form here
                return build_step(tree_map(SHD.gather, batch), perm,
                                  mis_rounds)
        return StepBundle(name=f"islabel:{shape_name}:build", fn=fn,
                          device=device, mesh=mesh, shardings=shardings)
    raise KeyError(shp.kind)


# ------------------------------------------------------------- dispatcher
def build_bundle(spec: ArchSpec, shape_name: str, device=None,
                 overrides: dict | None = None, mesh=None) -> StepBundle:
    """``overrides``: the LM train step's (``build_lm_bundle``) and the
    ``islabel`` query's (``build_islabel_bundle``); the other families
    take none, as in ``repro``. ``mesh``: a ``DeviceMesh`` to shard the
    step over (the module docstring), or None for one device."""
    if spec.family == "lm":
        return build_lm_bundle(spec, shape_name, device, overrides, mesh)
    if spec.family == "gnn":
        return build_gnn_bundle(spec, shape_name, device, mesh)
    if spec.family == "recsys":
        return build_recsys_bundle(spec, shape_name, device, mesh)
    if spec.family == "graph_index":
        return build_islabel_bundle(spec, shape_name, device, overrides,
                                    mesh)
    raise KeyError(spec.family)
