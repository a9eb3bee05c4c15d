"""The port's distribution layer against ``repro`` on the CPU: the
sharding rules and the models' logical-axes trees, int8 compression
with error feedback, the mod-sharded lookup, sharded train steps over a
gloo mesh, the elastic restore, and the dry run on a fake process group.

Multi-rank cases run the port under ``torchrun`` over gloo (one worker
script, ``WORKER``, written to the test's directory), ``repro``'s
collectives in one subprocess with 2 XLA host devices. The sharded
steps start from one state (the port's ``init_state`` at the smoke
configs in fp32, the schedule's warm-up at 1 step so steps 1 and 2
update at the full rate) and take the launcher's batches; after two
steps the sharded state, gathered, is held to the port's unsharded
step and to ``repro``'s own step jitted without shardings at rtol and
atol 1e-5 (``tests/test_torch_lm_train.py``'s ``FP32``): the mesh sums
the gradients of the two data shards in another order. The elastic
restore is bitwise.

On the mesh an LM splits its compute over ``model`` as ``repro``'s rules
split its weights (tensor-parallel blocks, the vocabulary-parallel
embedding and loss, the MoE by experts or by each expert's ffn). The
step cases cover each split: granite and the ``+heads3`` variant (3
query heads on 1 KV head, blocks not aligned with heads), qwen2-moe
(4 experts on ``model`` 2: experts split), ``+experts3`` (3 experts:
each expert's ffn split) and ``+dispatch`` (``dispatch_shard``: the
buffer's capacity over ``data`` too), kimi-k2 (experts split,
Adafactor). The
serving case holds a 16-token prefill and 8 greedy decode steps over
the sequence-sharded cache to the unsharded bundles.

The GNNs split their compute as ``repro``'s rules split their arrays:
each rank runs its block of nodes and edges (``GRAPH_CASES``: the smoke
full graph, whose last edge block holds padding only, and a molecule
batch of 40 graphs, whose last node block does), from ``repro``'s
initial state carried across as ``tests/test_torch_train.py`` carries
it. DIEN reads each table from its ``model`` blocks, its batch over
``data``; its serve and retrieval outputs (candidates split over every
axis, in uneven blocks, ids past both ends among them) are held to the
unsharded bundles'. The vocabulary-parallel loss takes targets past
both ends of the vocabulary as the unsharded loss does. SAGE's max
aggregator (``graphsage-reddit+max``) reduce-scatters its partial
maxima by ``MAX``; its gradient splits a tie among the tied messages of
every rank, bitwise the unsharded ``scatter_reduce`` gradient.

``compress_pods`` runs on 8 ranks, a ``(2, 2, 2)`` ``("pod", "data",
"model")`` mesh: each pod runs the split step on its half of the batch
(an MoE routes the pod's batch: ``cf05``'s capacity factor 0.5 gives
each pod a capacity of 33 where the global batch's would be 65), and
each rank's block of each gradient goes through the int8 exchange. The
reference is ``repro``'s own ``make_compressed_grad_fn`` on a
``("pod",)`` mesh of 2 XLA host devices, with its optimizer, jitted
(``repro``'s ``(pod, data, model)`` bundle fails on its mesh).
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.distributed import compression as j_comp
from repro.distributed import sharding as j_shd
from repro.launch import train as j_train
from repro.models import dien as j_dien
from repro.models import dimenet as j_dimenet
from repro.models import gnn as j_gnn
from repro.models import transformer as j_tf
from repro.train import steps as j_steps
from repro_torch.checkpoint import checkpoint as t_ckpt
from repro_torch.configs import registry as t_registry
from repro_torch.data import pipeline as t_pipe
from repro_torch.distributed import compression as t_comp
from repro_torch.distributed import sharding as t_shd
from repro_torch.launch import train as t_train
from repro_torch.models import dien as t_dien
from repro_torch.models import dimenet as t_dimenet
from repro_torch.models import gnn as t_gnn
from repro_torch.models import transformer as t_tf
from repro_torch.train import steps as t_steps
from repro_torch.tree import flatten_with_paths

SRC = str(Path(__file__).resolve().parents[1] / "src")
FP32 = dict(rtol=1e-5, atol=1e-5)
STEP_ARCHS = ("granite-8b", "qwen2-moe-a2.7b")
ACCUM_ARCH = "qwen2-moe-a2.7b"      # its routing sees each micro-batch
# the splits' other layouts: (arch, variant); a variant's fields are
# replaced alike in both packages' smoke configs (``_smoke``)
VARIANTS = {"": {}, "experts3": {"moe": {"n_experts": 3}},
            "heads3": {"n_heads": 3, "n_kv_heads": 1},
            "dispatch": {"moe": {"dispatch_shard": True}},
            "cf05": {"moe": {"capacity_factor": 0.5}}}
SPLIT_CASES = (("kimi-k2-1t-a32b", ""), ("qwen2-moe-a2.7b", "experts3"),
               ("granite-8b", "heads3"), ("qwen2-moe-a2.7b", "dispatch"))
SERVE_CASES = (("granite-8b", ""), ("granite-8b", "heads3"),
               ("qwen2-moe-a2.7b", "experts3"), ("kimi-k2-1t-a32b", ""))
ODD_IDS = [0, 1, 2, 5, 9, 10, 11, 13, 19, 20, 21, -1, -2, -3, -9, -10, -11,
           -12, -20, -21]
# (arch, shape) of the GNN and DIEN mesh steps (``_graph_spec``;
# "+max": SAGE's max aggregator)
GRAPH_CASES = (("gcn-cora", "full_graph_sm"),
               ("graphsage-reddit", "full_graph_sm"),
               ("graphsage-reddit+max", "full_graph_sm"),
               ("egnn", "full_graph_sm"), ("egnn", "molecule"),
               ("dimenet", "molecule"), ("dien", "train_batch"))


# ------------------------------------------------------------ the rules
def _meshes(multi: bool):
    names = ("pod", "data", "model") if multi else ("data", "model")
    shape = (2, 16, 16) if multi else (16, 16)
    j = types.SimpleNamespace(axis_names=names, shape=dict(zip(names, shape)))
    t = types.SimpleNamespace(mesh_dim_names=names, shape=shape)
    return j, t


@functools.lru_cache(maxsize=None)
def _axes(arch):
    """(repro's axes tree, the port's) at the published config."""
    jspec, tspec = j_registry.get_spec(arch), t_registry.get_spec(arch)
    if jspec.family == "lm":
        return j_tf.lm_axes(jspec.model_cfg), t_tf.lm_axes(tspec.model_cfg)
    if arch == "dien":
        return (j_dien.init_dien(jax.random.PRNGKey(0),
                                 jspec.smoke_cfg_fn())[1],
                t_dien.dien_axes(tspec.model_cfg))
    init = {"gcn-cora": (j_gnn.init_gcn, t_gnn.gcn_axes),
            "graphsage-reddit": (j_gnn.init_sage, t_gnn.sage_axes),
            "egnn": (j_gnn.init_egnn, t_gnn.egnn_axes),
            "dimenet": (j_dimenet.init_dimenet, t_dimenet.dimenet_axes)}
    ji, ti = init[arch]
    shp = next(iter(jspec.shapes.values()))
    jcfg = j_steps._adapt_gnn_cfg(jspec.smoke_cfg_fn(), shp)
    tcfg = t_steps._adapt_gnn_cfg(tspec.smoke_cfg_fn(), shp)
    return ji(jax.random.PRNGKey(0), jcfg)[1], ti(tcfg)


def _leaves(tree):
    return [(k, v) for k, v in flatten_with_paths(
        tree)] if isinstance(tree, dict) else [("", tree)]


@pytest.mark.parametrize("arch", j_registry.ASSIGNED)
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_axes_trees_and_specs_equal_repro(arch, multi):
    """Every family's axes tree is ``repro``'s, and ``spec_for_axes``
    gives ``repro``'s ``PartitionSpec`` entries for every leaf under the
    family's rules (the LMs' rules on the production mesh, where the
    MoE's expert rule and kimi-k2's FSDP over pods depend on it)."""
    jax_axes, t_axes = _axes(arch)
    assert t_axes == jax_axes
    spec = j_registry.get_spec(arch)
    jm, tm = _meshes(multi)
    if spec.family == "lm":
        jr = j_steps.lm_rules(spec, jm)
        tr = t_steps.lm_rules(t_registry.get_spec(arch), tm)
        assert tr == jr
    else:
        jr = tr = {"gnn": j_shd.GNN_RULES, "recsys": j_shd.RECSYS_RULES}[
            spec.family]
        assert t_shd.FAMILY_RULES[spec.family] == jr
    for path, ax in flatten_with_paths(t_axes):
        assert t_shd.spec_for_axes(ax, tr) == tuple(
            j_shd.spec_for_axes(ax, jr)), path


def test_adafactor_state_specs_equal_repro():
    """kimi-k2's factored statistics drop the reduced dim as ``repro``'s
    do (``opt_state_shardings``), on the multi-pod rules."""
    jm, tm = _meshes(True)
    jspec = j_registry.get_spec("kimi-k2-1t-a32b")
    tspec = t_registry.get_spec("kimi-k2-1t-a32b")
    t_sh = t_shd.tree_shardings(_axes("kimi-k2-1t-a32b")[1],
                                t_steps.lm_rules(tspec, tm), tm)
    t_opt = t_shd.opt_state_shardings(
        "adafactor", t_tf.abstract_params(tspec.model_cfg), t_sh, tm)
    mesh = jax.make_mesh((1, 1, 1), ("pod", "data", "model"))
    j_sh = j_shd.tree_shardings(_axes("kimi-k2-1t-a32b")[0],
                                j_steps.lm_rules(jspec, jm), mesh)
    j_opt = j_shd.opt_state_shardings(
        "adafactor", j_tf.abstract_params(jspec.model_cfg), j_sh, mesh)
    want = {k: tuple(v.spec) for k, v in flatten_with_paths(
        jax.tree.map(lambda x: x, j_opt,
                     is_leaf=lambda x: isinstance(
                         x, jax.sharding.NamedSharding)))}
    got = {k: v.spec for k, v in flatten_with_paths(t_opt)}
    assert got == want


def test_quantize_bitwise():
    r = np.random.default_rng(3)
    g = (r.standard_normal(4096) * 3).astype(np.float32)
    g[:8] = [0.5, 1.5, 2.5, -0.5, -2.5, 127.5, -300.0, 300.0]
    for scale in (np.float32(1.0), np.float32(0.037)):
        want = np.asarray(j_comp.quantize_int8(g, scale))
        got = t_comp.quantize_int8(torch.from_numpy(g),
                                   torch.tensor(scale)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            t_comp.dequantize_int8(torch.from_numpy(got),
                                   torch.tensor(scale)).numpy(),
            np.asarray(j_comp.dequantize_int8(want, scale)))


# ------------------------------------------------------- multi-rank runs
WORKER = '''
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import distribute_tensor, Shard, Replicate
from repro_torch.checkpoint import checkpoint as ck
from repro_torch.configs import registry
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.compression import compressed_psum_pod
from repro_torch.launch import train as tr
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.embedding import lookup_mod_sharded
from repro_torch.train.steps import build_bundle
from repro_torch.tree import flatten_with_paths
import dataclasses

torch.set_num_threads(1)
mode, out = sys.argv[1], sys.argv[2]
mesh = make_host_mesh(2, "cpu")
rank = dist.get_rank()
VARIANTS = json.load(open(f"{out}/variants.json"))
SMOKE




def gathered(x):
    return x.full_tensor() if hasattr(x, "full_tensor") else x


if mode == "steps":
    res = {}
    for case in sys.argv[4:]:
        arch, accum, var = case.split(":")
        key = arch + (f"+{var}" if var else "") + (
            f"+accum{accum}" if accum != "1" else "")
        spec = _smoke(registry, tr, arch, var)
        bundle = build_bundle(spec, "train_4k", "cpu",
                              {"warmup": 1, "grad_accum": int(accum)}, mesh)
        state0, _ = ck.restore_checkpoint(f"{out}/{key.split('+accum')[0]}_init",
            tr.init_state(spec, build_bundle(spec, "train_4k", "cpu")))
        st = bundle.place_state(state0)
        mb = tr.make_batch_fn(spec, "train_4k", device="cpu")
        losses = []
        for i in range(2):
            st, m = bundle.fn(st, bundle.place_batch(mb(i)))
            losses.append([float(m["loss"]), float(m["gnorm"])])
        ck.save_checkpoint(f"{out}/{key}_mesh", 2, st)
        res[key] = losses
    # prefill and greedy decode over the sequence-sharded cache, against
    # the unsharded bundles
    from repro_torch.configs.shapes import LMShape
    from repro_torch.models import transformer as T
    serve = {}
    for case in sys.argv[3].split(","):
        arch, var = case.split(":")
        spec = _smoke(registry, tr, arch, var)
        spec = dataclasses.replace(spec, shapes={
            "p": LMShape("p", "prefill", 32, 4),
            "d": LMShape("d", "decode", 32, 4)})
        cfg = spec.model_cfg
        params = T.init_lm(cfg, 1, "cpu")
        toks = torch.randint(0, cfg.vocab, (4, 16),
                             generator=torch.Generator().manual_seed(5))
        got = {}
        for tag, m in (("plain", None), ("mesh", mesh)):
            pre = build_bundle(spec, "p", "cpu", mesh=m)
            dec = build_bundle(spec, "d", "cpu", mesh=m)
            p = params if m is None else pre.place_state(
                {"params": params})["params"]
            logits, cache = pre.fn(p, pre.place_batch({"tokens": toks}))
            lg, tk = [], []
            for i in range(9):
                full = gathered(logits)
                nxt = full.argmax(-1)
                lg.append(full.numpy())
                tk.append(nxt.numpy())
                if i == 8:
                    break
                last = nxt if m is None else shd.place(
                    nxt, dec.shardings["batch"]["last_tokens"])
                logits, cache = dec.fn(p, cache, last)
            got[tag] = (lg, tk, gathered(cache["k"]).numpy())
        if rank == 0:
            np.savez(f"{out}/serve_{arch}_{var}.npz",
                     **{f"{t}_{n}": np.stack(v[j]) if j < 2 else v[j]
                        for t, v in got.items()
                        for j, n in enumerate(("logits", "tokens", "cache_k"))})
    # the vocabulary-parallel embedding and loss on ids past both ends,
    # every rank on the whole batch (dp = ())
    from repro_torch.train.steps import _value_and_grad
    spec = _smoke(registry, tr, "granite-8b")
    cfg = spec.model_cfg
    v = cfg.vocab
    params = T.init_lm(cfg, 2, "cpu")
    ids = torch.tensor([[v, v + 3, -1, -v, -v - 1, 0, 1, v - 1]] * 2)
    tgt = torch.tensor([[1, 2, v - 1, 0, 5, 63 % v, 7, 30]] * 2)
    call = shd.ModelCall(mesh, ())
    bsh = build_bundle(spec, "train_4k", "cpu", mesh=mesh)
    ps = bsh.place_state({"params": params})["params"]
    emb = {"plain": T._embed(params, cfg, ids, torch.float32),
           "mesh": T._embed(ps, cfg, ids, torch.float32, call)}
    vg = {"plain": _value_and_grad(lambda p_, b_: T.lm_loss(
              p_, cfg, b_["t"], b_["y"]))(params, {"t": ids, "y": tgt}),
          "mesh": _value_and_grad(lambda p_, b_: T.lm_loss(
              p_, cfg, b_["t"], b_["y"], dist=call))(ps, {"t": ids, "y": tgt})}
    flat = {}                       # gathered on every rank
    for tag in ("plain", "mesh"):
        flat[f"{tag}_embed"] = emb[tag].detach().numpy()
        flat[f"{tag}_loss"] = gathered(vg[tag][0]).numpy()
        for k, g in flatten_with_paths(vg[tag][1]):
            flat[f"{tag}_grad_{k}"] = gathered(g).numpy()
    # the loss on targets past both ends, each impl, on vocabulary blocks
    from repro_torch.models import layers as L
    full = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 8, v)).astype(np.float32) * 3)
    lo, hi = T._vocab_block(cfg, call)
    for impl in ("gather", "iota"):
        flat[f"plain_odd_{impl}"] = L.softmax_cross_entropy(
            full, ids, impl=impl).numpy()
        flat[f"mesh_odd_{impl}"] = L.vocab_cross_entropy(
            full[..., lo:hi], ids, lo, call, v, impl=impl).numpy()
    if rank == 0:
        np.savez(f"{out}/vocab.npz", **flat)
    # the GNNs' and DIEN's mesh steps from repro's initial state
    for arch, shape in json.load(open(f"{out}/graph_cases.json")):
        spec = _graph_spec(registry, tr, arch)
        bundle = build_bundle(spec, shape, "cpu", mesh=mesh)
        state0, _ = ck.restore_checkpoint(f"{out}/{arch}_{shape}_init",
            tr.init_state(spec, build_bundle(spec, shape, "cpu")))
        st = bundle.place_state(state0)
        mb = tr.make_batch_fn(spec, shape, device="cpu")
        losses = []
        for i in range(2):
            st, m = bundle.fn(st, bundle.place_batch(mb(i)))
            losses.append([float(m["loss"]), float(m["gnorm"])])
        ck.save_checkpoint(f"{out}/{arch}_{shape}_mesh", 2, st)
        res[f"{arch}:{shape}"] = losses
    # DIEN's serve and retrieval bundles, mesh against unsharded
    from repro_torch.configs.shapes import RecShape
    d = dict(np.load(f"{out}/dien_serve_in.npz"))
    dspec = _graph_spec(registry, tr, "dien")
    state0, _ = ck.restore_checkpoint(f"{out}/dien_train_batch_init",
        tr.init_state(dspec, build_bundle(dspec, "train_batch", "cpu")))
    params = state0["params"]
    spec = dataclasses.replace(dspec, shapes={
        "s": RecShape("s", "serve", len(d["user"])),
        "r": RecShape("r", "retrieval", 1, n_candidates=len(d["cand"]))})
    serve_in = {k: torch.from_numpy(d[k]) for k in (
        "user", "hist_items", "hist_cats", "hist_mask", "target_item",
        "target_cat")}
    retr_in = {k: v[:1] for k, v in serve_in.items()}
    retr_in["cand_items"] = torch.from_numpy(d["cand"])
    got = {}
    for tag, m in (("plain", None), ("mesh", mesh)):
        for shape, b in (("s", serve_in), ("r", retr_in)):
            bd = build_bundle(spec, shape, "cpu", mesh=m)
            p = params if m is None else bd.place_state(
                {"params": params})["params"]
            got[f"{tag}_{shape}"] = gathered(bd.fn(p, bd.place_batch(b))).numpy()
    if rank == 0:
        np.savez(f"{out}/dien_serve_out.npz", **got)
    # int8 across the pod axis and the mod-sharded lookup over "model"
    pm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("pod", "model"))
    pod, col = pm.get_coordinate()
    d = np.load(f"{out}/comp_in.npz")
    mean, err = compressed_psum_pod({"a": torch.from_numpy(d["g"][pod])},
                                    {"a": torch.from_numpy(d["e"][pod])}, pm)
    table = distribute_tensor(torch.from_numpy(d["table"]), pm,
                              [Replicate(), Shard(0)], src_data_rank=None)
    rows = lookup_mod_sharded(table, torch.from_numpy(d["ids"]), pm)
    if col == 0:
        np.savez(f"{out}/comp_out_{pod}.npz", mean=mean["a"].numpy(),
                 err=err["a"].numpy(), rows=rows.numpy())
    # the islabel query and a peel level on the (2, 2) mesh
    from repro_torch.configs.shapes import IndexShape
    d = dict(np.load(f"{out}/isl_in.npz"))
    f = json.loads(str(d.pop("fields")))
    spec = registry.get_spec("islabel")
    spec = dataclasses.replace(spec, shapes={
        "q": IndexShape("q", "query", **f["query"]),
        "lvl": IndexShape("lvl", "build_level", **f["level"])})
    qb = build_bundle(spec, "q", "cpu", {"relax_rounds": 5,
                                         "relax_chunks": 3}, mesh)
    dist_q = qb.fn(qb.place_batch({k: torch.from_numpy(d[k]) for k in (
        "lbl_ids", "lbl_d", "core_pos", "ce_src", "ce_dst", "ce_w", "s",
        "t")})).full_tensor()
    lb = build_bundle(spec, "lvl", "cpu", None, mesh)
    lvl = lb.fn(lb.place_batch({k: torch.from_numpy(d[k]) for k in (
        "src", "dst", "w", "via", "active")}), torch.from_numpy(d["perm"]))
    if rank == 0:
        np.savez(f"{out}/isl_out.npz", dist=dist_q.numpy(),
                 **{f"lvl{i}": x.numpy() for i, x in enumerate(lvl)})
    # SAGE's max aggregator on node and edge blocks over both axes: ties
    # within and across ranks, empty rows, against the unsharded one
    from repro_torch.graphs import segment_ops as sops
    call = shd.ModelCall(mesh, ("data", "model"), None)
    split = shd.GraphSplit(40, 64, call)
    count, index = call.shard_index()
    g = torch.Generator().manual_seed(9)
    msg = torch.randint(0, 4, (64, 3), generator=g).float()
    seg = torch.randint(0, 30, (64,), generator=g)
    w = torch.randn(40, 3, generator=g)
    whole = msg.clone().requires_grad_()
    agg = sops.segment_max(whole, seg, 40)
    torch.sum(torch.where(torch.isfinite(agg), agg, 0.0) * w).backward()
    e, n_ = 64 // count, 40 // count
    mine = msg[index * e:(index + 1) * e].clone().requires_grad_()
    blk = split.segment_max(mine, seg[index * e:(index + 1) * e])
    torch.sum(torch.where(torch.isfinite(blk), blk, 0.0)
              * w[index * n_:(index + 1) * n_]).backward()
    same = torch.tensor([int(
        torch.equal(blk.detach(), agg.detach()[index * n_:(index + 1) * n_])
        and torch.equal(mine.grad, whole.grad[index * e:(index + 1) * e]))])
    dist.all_reduce(same, dist.ReduceOp.MIN)
    tied = msg == agg.detach()[seg]
    owner = torch.arange(64) // e
    cross = any(len(set(owner[tied[:, c] & (seg == r)].tolist())) > 1
                for r in range(40) for c in range(3))
    if rank == 0:
        json.dump({"equal": int(same), "empty": int(torch.isinf(agg).any()),
                   "cross_rank_ties": int(cross)},
                  open(f"{out}/sage_max.json", "w"))
    if rank == 0:
        json.dump(res, open(f"{out}/losses.json", "w"))
elif mode == "compressed":
    # compress_pods on (pod, data, model) = (2, 2, 2) from the saved state
    from repro_torch.distributed.compression import init_error_feedback
    from repro_torch.tree import unflatten_paths
    cm = init_device_mesh("cpu", (2, 2, 2),
                          mesh_dim_names=("pod", "data", "model"))
    res = {}
    for case in sys.argv[3:]:
        arch, accum, var = case.split(":")
        key = arch + (f"+{var}" if var else "") + (
            f"+accum{accum}" if accum != "1" else "")
        spec = _smoke(registry, tr, arch, var)
        bundle = build_bundle(spec, "train_4k", "cpu", {
            "warmup": 1, "compress_pods": True, "grad_accum": int(accum)}, cm)
        d = np.load(f"{out}/{key.split('+accum')[0]}_init.npz")
        state0 = ck.state_from_tree(unflatten_paths(
            (k, d[k]) for k in d.files), "cpu")
        state0["err"] = init_error_feedback(state0["params"], 2)
        st = bundle.place_state(state0)
        mb = tr.make_batch_fn(spec, "train_4k", device="cpu")
        flat, losses = {}, []
        for i in range(2):
            st, m = bundle.fn(st, bundle.place_batch(mb(i)))
            losses.append([float(m["loss"]), float(m["gnorm"])])
            snap = ck.snapshot(st if i else {"err": st["err"]})
            flat.update({f"{i}/{k}": v for k, v in flatten_with_paths(snap)})
        if rank == 0:
            np.savez(f"{out}/cmp_{key}.npz", **flat)
        res[key] = [losses, bundle.static_meta["grad_accum"], bundle.name]
    if rank == 0:
        json.dump(res, open(f"{out}/cmp_losses.json", "w"))
elif mode == "elastic":
    a = make_host_mesh(2, "cpu")                               # (4, 2)
    b = init_device_mesh("cpu", (2, 4), mesh_dim_names=("data", "model"))
    spec = tr.smoke_spec(registry.get_spec("qwen2-moe-a2.7b"))
    ba = build_bundle(spec, "train_4k", "cpu", None, a)
    bb = build_bundle(spec, "train_4k", "cpu", None, b)
    whole = tr.init_state(spec, build_bundle(spec, "train_4k", "cpu"))
    ck.save_checkpoint(f"{out}/ck", 7, ba.place_state(whole))
    dist.barrier()                    # rank 0's write is on disk
    got, step = ck.restore_checkpoint(f"{out}/ck", whole,
                                      shardings=bb.shardings["state"])
    direct = bb.place_state(whole)
    from repro_torch.tree import flatten_with_paths
    same = all(
        torch.equal(g.to_local(), d.to_local())
        and g.placements == d.placements
        for (_, g), (_, d) in zip(flatten_with_paths(got),
                                  flatten_with_paths(direct)))
    full = all(np.array_equal(x, y) for (_, x), (_, y) in zip(
        flatten_with_paths(ck.snapshot(got)),
        flatten_with_paths(ck.snapshot(whole))))
    flags = torch.tensor([int(same and full and step == 7)])
    dist.all_reduce(flags, dist.ReduceOp.MIN)
    if rank == 0:
        json.dump({"ok": int(flags)}, open(f"{out}/elastic.json", "w"))
dist.destroy_process_group()
'''


def _smoke(registry, train, arch, variant=""):
    """The fp32 smoke spec of ``arch`` (fp32 parameters too) with
    ``VARIANTS[variant]``'s fields replaced."""
    spec = train.smoke_spec(registry.get_spec(arch))
    cfg = dataclasses.replace(spec.model_cfg, dtype="float32")
    for k, v in VARIANTS[variant].items():
        cfg = dataclasses.replace(cfg, **{k: dataclasses.replace(
            getattr(cfg, k), **v) if isinstance(v, dict) else v})
    return dataclasses.replace(spec, model_cfg=cfg, param_dtype="float32")


def _graph_spec(registry, train, arch):
    """The smoke spec of a GNN or of DIEN; a GNN's molecule batch holds
    40 graphs (real atoms on three of the four ranks' node blocks);
    ``arch+agg``: SAGE with aggregator ``agg``."""
    arch, _, agg = arch.partition("+")
    spec = train.smoke_spec(registry.get_spec(arch))
    if agg:
        spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(
            spec.model_cfg, aggregator=agg))
    if spec.family != "gnn":
        return spec
    mol = dataclasses.replace(spec.shapes["molecule"], batch_graphs=40)
    return dataclasses.replace(spec, shapes=dict(spec.shapes, molecule=mol))


def _torchrun(tmp_path, n: int, *args):
    script = tmp_path / "worker.py"
    (tmp_path / "variants.json").write_text(json.dumps(VARIANTS))
    script.write_text(WORKER.replace("SMOKE", inspect.getsource(_smoke) +
                                     "\n\n" + inspect.getsource(_graph_spec)))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "torch.distributed.run",
                        f"--nproc-per-node={n}", "--standalone",
                        str(script), *args], capture_output=True, text=True,
                       timeout=600, env=env, cwd=tmp_path)
    assert r.returncode == 0, f"STDOUT:\n{r.stdout}\nSTDERR:\n{r.stderr[-6000:]}"


def _repro_collectives(tmp_path):
    """``repro``'s ``compressed_psum_pod`` (a ``shard_map`` over 2 pods)
    and ``lookup_mod_sharded`` (over 2 ``model`` shards) on 2 host
    devices."""
    code = f'''
        import jax, jax.numpy as jnp, numpy as np
        from jax import shard_map
        from jax.sharding import PartitionSpec as P
        from repro.distributed.compression import compressed_psum_pod
        from repro.models.embedding import lookup_mod_sharded
        d = np.load("{tmp_path}/comp_in.npz")
        mesh = jax.make_mesh((2,), ("pod",))
        def inner(g, e):
            m, ne = compressed_psum_pod({{"a": g[0]}}, {{"a": e[0]}}, mesh)
            return m["a"], ne["a"][None]
        fn = shard_map(inner, mesh=mesh, in_specs=(P("pod"), P("pod")),
                       out_specs=(P(), P("pod")), check_vma=False)
        mean, err = fn(jnp.asarray(d["g"]), jnp.asarray(d["e"]))
        rows = lookup_mod_sharded(jnp.asarray(d["table"]),
                                  jnp.asarray(d["ids"]),
                                  jax.make_mesh((2,), ("model",)))
        np.savez("{tmp_path}/repro_out.npz", mean=np.asarray(mean),
                 err=np.asarray(err), rows=np.asarray(rows))
    '''
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    return np.load(f"{tmp_path}/repro_out.npz")


def _specs(arch, variant=""):
    return [_smoke(registry, train, arch, variant)
            for registry, train in ((j_registry, j_train),
                                    (t_registry, t_train))]


def _case_key(arch, accum=1, variant=""):
    return arch + (f"+{variant}" if variant else "") + (
        f"+accum{accum}" if accum != 1 else "")


def _parse_key(key):
    """(arch, variant) of a step case's key."""
    parts = [x for x in key.split("+") if not x.startswith("accum")]
    return parts[0], (parts[1] if len(parts) > 1 else "")


def _values(tree):
    return {k: np.asarray(v, np.float32) for k, v in flatten_with_paths(tree)
            if not k.startswith("step")}


def _islabel_batch(r):
    """A small ``islabel`` query batch (sorted label rows of ids below n,
    padding n; integer distances; a 40-vertex core) with endpoint ids
    past both ends, and a peel level's edge list with a permutation."""
    n, l_cap, n_core, e, q = 300, 16, 40, 203, 8
    rows = 512
    ids = np.sort(r.integers(0, n, (rows, l_cap)), axis=1).astype(np.int32)
    ids[r.random((rows, l_cap)) < 0.3] = n
    ids = np.sort(ids, axis=1)
    ids[n:] = n
    core = r.permutation(n)[:n_core]
    cpos = np.full(rows, n_core, np.int32)
    cpos[core] = np.arange(n_core)
    g = t_pipe.graph_from_spec("er:300:3@4")
    e_cap = 4096
    pad = e_cap - len(g[1])
    batch = {"lbl_ids": ids,
             "lbl_d": np.where(ids < n, r.integers(1, 30, (rows, l_cap)),
                               np.inf).astype(np.float32),
             "core_pos": cpos,
             "ce_src": r.integers(0, n_core, e).astype(np.int32),
             "ce_dst": r.integers(0, n_core, e).astype(np.int32),
             "ce_w": r.integers(1, 5, e).astype(np.float32),
             "s": np.array([3, 7, n, -1, 299, 1000, -600, 12], np.int32),
             "t": r.integers(0, n, q).astype(np.int32),
             "src": np.concatenate([g[1], np.full(pad, n)]).astype(np.int32),
             "dst": np.concatenate([g[2], np.full(pad, n)]).astype(np.int32),
             "w": np.concatenate([g[3], np.full(pad, np.inf)]).astype(
                 np.float32),
             "via": np.full(e_cap, -1, np.int32),
             "active": np.ones(n, bool),
             "perm": r.permutation(n).astype(np.int32)}
    fields = {"query": dict(n_vertices=n, l_cap=l_cap, n_core=n_core,
                            core_edges=e, q_batch=q),
              "level": dict(n_vertices=n, l_cap=l_cap, n_core=0,
                            core_edges=0, e_cap=e_cap, d_cap=16)}
    return fields, batch


def _dien_repro(spec):
    """``repro``'s initial DIEN state and its eager train step jitted
    without a mesh (``tests/test_torch_recsys.py``: ``repro``'s jitted
    bundle fails under a mesh)."""
    cfg = spec.model_cfg
    opt = j_steps.make_optimizer(spec.optimizer)

    @jax.jit
    def step(state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: j_dien.dien_loss(p, cfg, batch))(state["params"])
        new_p, new_opt, gnorm = opt.update(grads, state["opt"],
                                           state["params"], state["step"])
        return ({"params": new_p, "opt": new_opt, "step": state["step"] + 1},
                {"loss": loss, "gnorm": gnorm})

    params = j_dien.init_dien(jax.random.PRNGKey(0), cfg)[0]
    state = {"params": params, "opt": opt.init(params),
             "step": jax.numpy.zeros((), jax.numpy.int32)}
    return jax.tree.map(np.asarray, state), step


def _graph_refs(tmp) -> dict:
    """``GRAPH_CASES``: ``repro``'s initial state, saved for the worker,
    and two unsharded steps of the port's bundle and of ``repro``'s
    jitted step from it, on the port's batches."""
    refs = {}
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    for arch, shape in GRAPH_CASES:
        jspec = _graph_spec(j_registry, j_train, arch)
        tspec = _graph_spec(t_registry, t_train, arch)
        tb = t_train.make_batch_fn(tspec, shape, device="cpu")
        batches = [tb(i) for i in range(2)]
        with jmesh:
            if arch == "dien":
                state0, jstep = _dien_repro(jspec)
            else:
                jb = j_steps.build_bundle(jspec, shape, jmesh)
                jstep = jb.jitted()
                state0 = jax.tree.map(np.asarray,
                                      j_train.init_state(jspec, jmesh, jb))
            keys = jspec.input_specs(shape)
            js, jl = state0, []
            for b in batches:
                js, jm = jstep(js, {k: b[k].numpy() for k in keys})
                jl.append([float(jm["loss"]), float(jm["gnorm"])])
        t_ckpt.save_checkpoint(tmp / f"{arch}_{shape}_init", 0,
                               t_ckpt.state_from_tree(state0, "cpu"))
        bundle = t_steps.build_bundle(tspec, shape, "cpu")
        ts, tl = t_ckpt.state_from_tree(state0, "cpu"), []
        for b in batches:
            ts, tm = bundle.fn(ts, b)
            tl.append([float(tm["loss"]), float(tm["gnorm"])])
        refs[f"{arch}:{shape}"] = {
            "port": (_values(t_ckpt.snapshot(ts)), tl),
            "repro": (_values(jax.tree.map(np.asarray, js)), jl)}
    # the blocks of 4 ranks: the full graph's last edge block and the
    # molecule batch's last node block hold padding only
    full = t_train.make_batch_fn(_graph_spec(t_registry, t_train, "gcn-cora"),
                                 "full_graph_sm", device="cpu")(0)
    n = int(full["edge_src"].max())
    assert (full["edge_src"][-len(full["edge_src"]) // 4:] == n).all()
    assert (full["edge_src"][: len(full["edge_src"]) // 2] < n).all()
    mol = t_train.make_batch_fn(_graph_spec(t_registry, t_train, "egnn"),
                                "molecule", device="cpu")(0)
    rows = len(mol["graph_ids"]) // 4
    assert (mol["graph_ids"][-rows:] == 40).all()
    assert (mol["graph_ids"][-2 * rows:-rows] < 40).any()
    return refs


def _dien_serve_batch(r):
    """16 DIEN requests and 510 retrieval candidates (uneven blocks on 4
    ranks) of the smoke config, ids past both ends among them."""
    cfg = t_train.smoke_spec(t_registry.get_spec("dien")).model_cfg
    b, s = 16, cfg.seq_len
    d = {"user": r.integers(0, cfg.n_users, b),
         "hist_items": r.integers(0, cfg.n_items, (b, s)),
         "hist_cats": r.integers(0, cfg.n_cats, (b, s)),
         "hist_mask": (r.random((b, s)) > 0.1).astype(np.float32),
         "target_item": r.integers(0, cfg.n_items, b),
         "target_cat": r.integers(0, cfg.n_cats, b),
         "cand": r.integers(0, cfg.n_items, 510)}
    d["user"][3] = cfg.n_users
    d["target_item"][5] = -1
    d["hist_items"][7, 2] = -cfg.n_items
    d["cand"][[7, 300, 301, 509]] = [cfg.n_items, -1, -cfg.n_items,
                                     -cfg.n_items - 1]
    return {k: v if v.dtype == np.float32 else v.astype(np.int32)
            for k, v in d.items()}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The 4-rank run (``steps``) and both unsharded references."""
    tmp = tmp_path_factory.mktemp("mesh")
    r = np.random.default_rng(7)
    n = 10
    np.savez(tmp / "comp_in.npz",
             g=(r.standard_normal((2, 257)) * 2).astype(np.float32),
             e=(r.standard_normal((2, 257)) * 0.01).astype(np.float32),
             table=np.arange(n * 3, dtype=np.float32).reshape(n, 3),
             ids=np.array(ODD_IDS, np.int32))
    fields, batch = _islabel_batch(r)
    np.savez(tmp / "isl_in.npz", fields=json.dumps(fields), **batch)
    refs = {}
    cases = [(arch, 1, "") for arch in STEP_ARCHS] + [(ACCUM_ARCH, 2, "")] + [
        (arch, 1, var) for arch, var in SPLIT_CASES]
    for arch, accum, var in cases:
        jspec, tspec = _specs(arch, var)
        if var == "dispatch":
            # repro's flag is a layout constraint only, and its jitted step
            # on this (1, 1) mesh of explicit axes refuses it
            # (with_sharding_constraint): its reference is the step without
            jspec = _specs(arch)[0]
        state0 = t_ckpt.snapshot(t_train.init_state(
            tspec, t_steps.build_bundle(tspec, "train_4k", "cpu")))
        t_ckpt.save_checkpoint(tmp / f"{_case_key(arch, 1, var)}_init", 0,
                               t_ckpt.state_from_tree(state0, "cpu"))
        ov = {"warmup": 1, "grad_accum": accum}
        bundle = t_steps.build_bundle(tspec, "train_4k", "cpu", ov)
        tb = t_train.make_batch_fn(tspec, "train_4k", device="cpu")
        jfn = jax.jit(j_steps.build_bundle(
            jspec, "train_4k", jax.make_mesh((1, 1), ("data", "model")),
            ov).fn)
        jb = j_train.make_batch_fn(jspec, "train_4k")
        ts, js = t_ckpt.state_from_tree(state0, "cpu"), state0
        tl, jl = [], []
        for i in range(2):
            ts, tm = bundle.fn(ts, tb(i))
            js, jm = jfn(js, jb(i))
            tl.append([float(tm["loss"]), float(tm["gnorm"])])
            jl.append([float(jm["loss"]), float(jm["gnorm"])])
        refs[_case_key(arch, accum, var)] = {
            "port": (_values(t_ckpt.snapshot(ts)), tl),
            "repro": (_values(jax.tree.map(np.asarray, js)), jl)}
    refs.update(_graph_refs(tmp))
    (tmp / "graph_cases.json").write_text(json.dumps(GRAPH_CASES))
    np.savez(tmp / "dien_serve_in.npz", **_dien_serve_batch(r))
    _torchrun(tmp, 4, "steps", str(tmp),
              ",".join(f"{a}:{v}" for a, v in SERVE_CASES),
              *(f"{arch}:{accum}:{var}" for arch, accum, var in cases))
    return tmp, refs


@pytest.mark.parametrize("arch", STEP_ARCHS + (f"{ACCUM_ARCH}+accum2",) + tuple(
    _case_key(a, 1, v) for a, v in SPLIT_CASES))
@pytest.mark.parametrize("ref", ["port", "repro"])
def test_sharded_step_matches_unsharded(mesh_run, arch, ref):
    """Two steps on the (2, 2) mesh against the unsharded ``ref`` run's,
    at ``FP32``; ``+accum2`` at ``grad_accum`` 2, the batch laid out by
    micro-batch, so each rank routes its share of each global
    micro-batch as the unsharded step routes that micro-batch. The
    model's compute is split over ``model`` (the module docstring)."""
    tmp, refs = mesh_run
    spec = _specs(*_parse_key(arch))[1]
    got_state, _ = t_ckpt.restore_checkpoint(
        tmp / f"{arch}_mesh", t_ckpt.state_from_tree(
            t_ckpt.snapshot(t_train.init_state(
                spec, t_steps.build_bundle(spec, "train_4k", "cpu"))),
            "cpu"))
    got = _values(t_ckpt.snapshot(got_state))
    want, want_losses = refs[arch][ref]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FP32)
    losses = json.load(open(tmp / "losses.json"))[arch]
    np.testing.assert_allclose(losses, want_losses, **FP32)


@pytest.mark.parametrize("case", [_case_key(a, 1, v) for a, v in SERVE_CASES])
def test_mesh_serving_matches_unsharded(mesh_run, case):
    """A 16-token prefill into a cache of 32 (positions 16–31 on the
    second ``model`` rank) and 8 greedy decode steps on the (2, 2) mesh,
    the cache's sequence over ``model``: every step's logits and the
    final cache within ``FP32`` of the unsharded bundles', the greedy
    tokens equal."""
    tmp, _ = mesh_run
    arch, var = _parse_key(case)
    got = np.load(tmp / f"serve_{arch}_{var}.npz")
    np.testing.assert_array_equal(got["mesh_tokens"], got["plain_tokens"])
    np.testing.assert_allclose(got["mesh_logits"], got["plain_logits"],
                               **FP32)
    np.testing.assert_allclose(got["mesh_cache_k"], got["plain_cache_k"],
                               **FP32)
    assert got["plain_logits"].shape[0] == 9


def test_vocab_parallel_embed_and_loss(mesh_run):
    """The embedding on ids V, V+3, -1, -V and -V-1 (read as jnp's gather
    reads them) from each rank's vocabulary block: bitwise the unsharded
    rows; the loss over vocabulary-sharded logits and every gradient
    within ``FP32`` of the unsharded ones."""
    tmp, _ = mesh_run
    got = np.load(tmp / "vocab.npz")
    np.testing.assert_array_equal(got["mesh_embed"], got["plain_embed"])
    np.testing.assert_allclose(got["mesh_loss"], got["plain_loss"], **FP32)
    grads = [k[len("plain_grad_"):] for k in got.files
             if k.startswith("plain_grad_")]
    assert "embed" in grads and "unembed" in grads
    for k in grads:
        np.testing.assert_allclose(got[f"mesh_grad_{k}"],
                                   got[f"plain_grad_{k}"], err_msg=k, **FP32)


@pytest.mark.parametrize("impl", ["gather", "iota"])
def test_vocab_parallel_loss_odd_targets(mesh_run, impl):
    """``vocab_cross_entropy`` on each rank's vocabulary block with
    targets V, V+3, -1, -V and -V-1 beside in-range ones: the unsharded
    loss, NaN where it is NaN (past either end, ``gather`` only)."""
    tmp, _ = mesh_run
    got = np.load(tmp / "vocab.npz")
    want = got[f"plain_odd_{impl}"]
    np.testing.assert_allclose(got[f"mesh_odd_{impl}"], want, equal_nan=True,
                               **FP32)
    assert np.isnan(want).any() == (impl == "gather")
    assert np.isfinite(want).any()


@pytest.mark.parametrize("case", [f"{a}:{s}" for a, s in GRAPH_CASES])
@pytest.mark.parametrize("ref", ["port", "repro"])
def test_sharded_graph_step_matches_unsharded(mesh_run, case, ref):
    """Two steps on the (2, 2) mesh, the GNN's nodes and edges split over
    both axes or DIEN's tables over ``model``, against the unsharded
    ``ref`` run's at ``FP32``: losses, gradient norms and every array of
    the state."""
    tmp, refs = mesh_run
    arch, shape = case.split(":")
    spec = _graph_spec(t_registry, t_train, arch)
    got_state, _ = t_ckpt.restore_checkpoint(
        tmp / f"{arch}_{shape}_mesh", t_ckpt.state_from_tree(
            t_ckpt.snapshot(t_train.init_state(
                spec, t_steps.build_bundle(spec, shape, "cpu"))), "cpu"))
    got = _values(t_ckpt.snapshot(got_state))
    want, want_losses = refs[case][ref]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **FP32)
    losses = json.load(open(tmp / "losses.json"))[case]
    np.testing.assert_allclose(losses, want_losses, **FP32)


def test_sage_max_aggregator_bitwise(mesh_run):
    """SAGE's max aggregator on the (2, 2) mesh, 64 edges of integer
    messages in blocks of 16 into 40 node rows in blocks of 10 (ties
    within and across ranks, empty rows): each rank's block of the max
    and its messages' gradient bitwise the unsharded ``segment_max``'s
    and its ``scatter_reduce`` gradient."""
    tmp, _ = mesh_run
    got = json.load(open(tmp / "sage_max.json"))
    assert got == {"equal": 1, "empty": 1, "cross_rank_ties": 1}


@pytest.mark.parametrize("shape", ["s", "r"], ids=["serve", "retrieval"])
def test_dien_serve_and_retrieval_on_mesh(mesh_run, shape):
    """DIEN's serve bundle (the batch over ``data``) and retrieval bundle
    (510 candidates over every axis) on the (2, 2) mesh, each table read
    from its ``model`` blocks, within ``FP32`` of the unsharded bundles;
    ids past either end give NaN where they do there."""
    tmp, _ = mesh_run
    got = np.load(tmp / "dien_serve_out.npz")
    want = got[f"plain_{shape}"]
    np.testing.assert_allclose(got[f"mesh_{shape}"], want, equal_nan=True,
                               **FP32)
    assert want.shape == ((16,) if shape == "s" else (1, 510))
    assert np.isnan(want).any() and np.isfinite(want).any()


def _entry(axes):
    """A ``PartitionSpec`` entry as jax keeps it (one axis: its name)."""
    axes = tuple(axes) if isinstance(axes, (tuple, list)) else axes
    return axes[0] if isinstance(axes, tuple) and len(axes) == 1 else axes


def _spec(spec) -> tuple:
    return tuple(_entry(e) for e in spec)


@pytest.mark.parametrize("arch", [a for a in j_registry.ASSIGNED
                                  if j_registry.get_spec(a).family == "lm"])
@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_serving_shardings_equal_repro(arch, multi):
    """The port's prefill and decode bundles on the production mesh lay
    the cache out as ``repro``'s ``cache_sh`` (``(None, dp, "model",
    None, None)``) and every parameter by ``repro``'s ``lm_rules``."""
    jm, tm = _meshes(multi)
    jspec, tspec = j_registry.get_spec(arch), t_registry.get_spec(arch)
    names = jm.axis_names
    jmesh = jax.make_mesh((1,) * len(names), names)
    rules = j_steps.lm_rules(jspec, jm)
    want_params = {k: tuple(j_shd.spec_for_axes(ax, rules))
                   for k, ax in flatten_with_paths(j_tf.lm_axes(
                       jspec.model_cfg))}
    jdec = j_steps.build_lm_bundle(jspec, "decode_32k", jmesh)
    want_cache = {k: tuple(v.spec) for k, v in jdec.in_shardings[1].items()}
    assert want_cache["k"][:3] == (None, _entry(names[:-1]), "model")
    for shape in ("prefill_32k", "decode_32k"):
        b = t_steps.build_lm_bundle(tspec, shape, "cpu", mesh=tm)
        got = {k: _spec(v.spec) for k, v in flatten_with_paths(
            b.shardings["state"]["params"])}
        assert got == want_params
    cache = b.shardings["batch"]["cache"]
    assert {k: _spec(v.spec) for k, v in cache.items()} == want_cache


def test_dryrun_model_axis_splits_flops():
    """A granite-like train_4k step traced on a fake group: its FLOPs a
    device on (2, 4) (8 ranks, compute split over ``model`` 4) at most
    0.4x those on (2, 1) (2 ranks), each rank on the same batch share."""
    code = '''
        import dataclasses, json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import registry
        from repro_torch.launch import dryrun
        from repro_torch.launch.train import smoke_spec
        spec = smoke_spec(registry.get_spec("granite-8b"))
        spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(
            spec.model_cfg, n_heads=8, n_kv_heads=2, d_model=64, d_ff=256,
            vocab=512))
        flops = {}
        for world, shape in ((8, (2, 4)), (2, (2, 1))):
            dryrun.fake_world(world)
            dryrun.make_production_mesh = lambda **kw: init_device_mesh(
                "cpu", shape, mesh_dim_names=("data", "model"))
            rec = dryrun.trace_cell(spec, "train_4k", False)
            flops[rec["mesh"]] = rec["flops_per_device"]
        print(json.dumps(flops))
    '''
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    flops = json.loads(r.stdout.strip().splitlines()[-1])
    assert flops["2x4"] > 0 and flops["2x1"] > 0
    assert flops["2x4"] <= 0.4 * flops["2x1"], flops


def test_dryrun_graph_and_table_splits():
    """``gcn-cora`` and ``egnn`` at ``ogb_products`` and DIEN at
    ``train_batch``, traced on fake groups of 2 ranks (mesh (2, 1)) and
    of 8 (mesh (4, 2)): a GNN's nodes and edges split over every axis,
    so its FLOPs a device at 8 ranks are at most 0.3x those at 2; DIEN's
    batch splits over ``data`` and its tables' rows over ``model``, so
    its FLOPs and its collective bytes a device both fall (at most 0.6x
    and 0.7x)."""
    code = '''
        import json
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import registry
        from repro_torch.launch import dryrun
        out = {}
        for world, shape in ((8, (4, 2)), (2, (2, 1))):
            dryrun.fake_world(world)
            dryrun.make_production_mesh = lambda **kw: init_device_mesh(
                "cpu", shape, mesh_dim_names=("data", "model"))
            for arch, cell in (("gcn-cora", "ogb_products"),
                               ("egnn", "ogb_products"),
                               ("dien", "train_batch")):
                rec = dryrun.trace_cell(registry.get_spec(arch), cell, False)
                out[f"{arch}:{rec['mesh']}"] = [
                    rec["flops_per_device"],
                    rec["collective_bytes_per_device"]["total"]]
        print(json.dumps(out))
    '''
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    for arch in ("gcn-cora", "egnn"):
        big, small = got[f"{arch}:4x2"], got[f"{arch}:2x1"]
        assert 0 < big[0] <= 0.3 * small[0], (arch, got)
    big, small = got["dien:4x2"], got["dien:2x1"]
    assert 0 < big[0] <= 0.6 * small[0], got
    assert 0 < big[1] <= 0.7 * small[1], got


def test_compressed_psum_pod_and_mod_lookup_bitwise(mesh_run, tmp_path):
    """Both pods' mean and residual, and the mod-sharded lookup on ids
    past both ends of the table, as ``repro`` computes them."""
    tmp, _ = mesh_run
    want = _repro_collectives(tmp)
    for pod in (0, 1):
        got = np.load(tmp / f"comp_out_{pod}.npz")
        np.testing.assert_array_equal(got["mean"], want["mean"])
        np.testing.assert_array_equal(got["err"], want["err"][pod])
        np.testing.assert_array_equal(got["rows"], want["rows"])
    assert np.isnan(want["rows"]).any() and np.isfinite(want["rows"]).any()


def test_islabel_on_mesh_bitwise(mesh_run):
    """The ``islabel`` query (rows gathered from each rank's block,
    queries split over ``data``, 3 chunks with a remainder) and a peel
    level on the (2, 2) mesh, bitwise equal to the bundles on one
    device."""
    from repro_torch.configs.shapes import IndexShape
    tmp, _ = mesh_run
    d = dict(np.load(tmp / "isl_in.npz"))
    f = json.loads(str(d.pop("fields")))
    spec = dataclasses.replace(t_registry.get_spec("islabel"), shapes={
        "q": IndexShape("q", "query", **f["query"]),
        "lvl": IndexShape("lvl", "build_level", **f["level"])})
    tb = {k: torch.from_numpy(v) for k, v in d.items()}
    want = t_steps.build_bundle(spec, "q", "cpu", {
        "relax_rounds": 5, "relax_chunks": 3}).fn(tb).numpy()
    lvl = t_steps.build_bundle(spec, "lvl", "cpu").fn(tb, tb["perm"])
    got = np.load(tmp / "isl_out.npz")
    np.testing.assert_array_equal(got["dist"], want)
    assert np.isfinite(want).any() and np.isinf(want).any()
    for i, x in enumerate(lvl):
        np.testing.assert_array_equal(got[f"lvl{i}"], x.numpy())


def test_world_one_graph_and_recsys_steps_bitwise():
    """At a world of one every collective of the GNNs' and DIEN's mesh
    steps is a copy: two steps of each ``GRAPH_CASES`` case through the
    mesh bundle equal the unsharded bundle's bitwise, losses and every
    leaf (what ``chip_smoke.py``'s ``distributed`` phase holds on the
    card at the published configs)."""
    code = '''
        import dataclasses, json
        import torch
        from repro_torch.checkpoint.checkpoint import snapshot
        from repro_torch.configs import registry
        from repro_torch.launch import train as tr
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.train.steps import build_bundle
        from repro_torch.tree import flatten_with_paths
        torch.use_deterministic_algorithms(True)
        mesh = make_host_mesh(1, "cpu")
        out = {}
        for arch, shape in CASES:
            name, _, agg = arch.partition("+")
            spec = tr.smoke_spec(registry.get_spec(name))
            if agg:
                spec = dataclasses.replace(spec, model_cfg=dataclasses.replace(
                    spec.model_cfg, aggregator=agg))
            plain = build_bundle(spec, shape, "cpu")
            sharded = build_bundle(spec, shape, "cpu", None, mesh)
            state = tr.init_state(spec, plain)
            make = tr.make_batch_fn(spec, shape, device="cpu")
            a, b, la, lb = state, sharded.place_state(state), [], []
            for i in range(2):
                a, ma = plain.fn(a, make(i))
                b, mb = sharded.fn(b, sharded.place_batch(make(i)))
                la.append(float(ma["loss"]))
                lb.append(float(mb["loss"]))
            sa = dict(flatten_with_paths(snapshot(a)))
            sb = dict(flatten_with_paths(snapshot(b)))
            out[f"{arch}:{shape}"] = la == lb and all(
                (sa[k] == sb[k]).all() for k in sa)
        print(json.dumps(out))
    '''.replace("CASES", repr(GRAPH_CASES))
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got == {f"{a}:{s}": True for a, s in GRAPH_CASES}, got


def test_elastic_restore_bitwise(tmp_path):
    """A state saved from a (4, 2) mesh restores onto (2, 4): every
    shard and placement as the new layout places the whole state, and
    the gathered state bitwise."""
    _torchrun(tmp_path, 8, "elastic", str(tmp_path))
    assert json.load(open(tmp_path / "elastic.json")) == {"ok": 1}


def test_dryrun_cell_on_8_fake_ranks():
    """One granite smoke cell traced on a fake group of 8 ranks, mesh
    (4, 2): FLOPs and collective bytes counted (``repro``'s
    ``test_small_dryrun_cell_on_8_devices``)."""
    code = '''
        import json
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from repro_torch.configs import registry
        from repro_torch.launch import dryrun
        from repro_torch.launch.train import smoke_spec
        dryrun.fake_world(8)
        dryrun.make_production_mesh = lambda **kw: init_device_mesh(
            "cpu", (4, 2), mesh_dim_names=("data", "model"))
        rec = dryrun.trace_cell(smoke_spec(registry.get_spec("granite-8b")),
                                "train_4k", False)
        print(json.dumps(rec))
    '''
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                       capture_output=True, text=True, timeout=300, env=env)
    assert r.returncode == 0, r.stderr[-4000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["mesh"] == "4x2" and rec["devices"] == 8
    assert rec["flops_per_device"] > 0
    assert rec["collective_bytes_per_device"]["total"] > 0
    assert rec["collective_bytes_per_device"]["all-gather"] > 0
    assert rec["peak_bytes_per_device"] >= rec["argument_bytes_per_device"] > 0
    assert rec["fits_80gb"] is True


# ------------------------------------------------- compress_pods on 8 ranks
# (arch, grad_accum, variant): grad_accum is ignored under compress_pods
CMP_CASES = (("granite-8b", 1, ""), ("qwen2-moe-a2.7b", 1, ""),
             ("qwen2-moe-a2.7b", 1, "experts3"), ("qwen2-moe-a2.7b", 1, "cf05"),
             ("qwen2-moe-a2.7b", 2, ""))
MAX_FLIPS = 1e-3          # share of a leaf's elements whose q may flip


def _repro_compressed(tmp, cases):
    """``repro``'s compressed step for each ``(arch, variant)``: its own
    ``make_compressed_grad_fn`` over ``jax.value_and_grad(lm_loss)`` on a
    ``("pod",)`` mesh of 2 host devices and its optimizer's update, the
    step jitted; two steps from ``<case>_init.npz`` on ``repro``'s
    batches, each leaf's scale (max over both pods of |g + e|, / 127 +
    1e-12) before each step. Started in the background: returns the
    process."""
    code = f'''
        import dataclasses, json
        import jax, jax.numpy as jnp, numpy as np
        from repro.configs import registry
        from repro.distributed.compression import (init_error_feedback,
                                                   make_compressed_grad_fn)
        from repro.launch import train
        from repro.models import transformer as T
        from repro.train import steps as S
        from repro_torch.tree import flatten_with_paths, unflatten_paths
        VARIANTS = {VARIANTS!r}
        SMOKE
        mesh = jax.make_mesh((2,), ("pod",))
        for arch, var in {list(cases)!r}:
            key = arch + (f"+{{var}}" if var else "")
            spec = _smoke(registry, train, arch, var)
            cfg = spec.model_cfg
            d = np.load(f"{tmp}/{{key}}_init.npz")
            state = unflatten_paths((k, jnp.asarray(d[k])) for k in d.files)
            state["err"] = init_error_feedback(state["params"], 2)
            opt = S.make_optimizer(spec.optimizer, warmup=1)

            def loss_fn(p, tok, tgt):
                return T.lm_loss(p, cfg, tok, tgt)
            cg = make_compressed_grad_fn(lambda p, b: jax.value_and_grad(
                loss_fn)(p, b["tokens"], b["targets"]), mesh)

            @jax.jit
            def step(state, batch):
                loss, grads, new_err = cg(state["params"], state["err"], batch)
                new_p, new_opt, gnorm = opt.update(
                    grads, state["opt"], state["params"], state["step"])
                return ({{"params": new_p, "opt": new_opt, "err": new_err,
                          "step": state["step"] + 1}},
                        {{"loss": loss, "gnorm": gnorm}})

            @jax.jit
            def scales(state, batch):
                h = batch["tokens"].shape[0] // 2
                mx = None
                for p in range(2):
                    g = jax.grad(loss_fn)(state["params"],
                                          batch["tokens"][p * h:(p + 1) * h],
                                          batch["targets"][p * h:(p + 1) * h])
                    m = jax.tree.map(lambda g_, e: jnp.max(jnp.abs(
                        g_.astype(jnp.float32) + e[p])), g, state["err"])
                    mx = m if mx is None else jax.tree.map(jnp.maximum, mx, m)
                return jax.tree.map(lambda m: m / 127.0 + 1e-12, mx)
            mb = train.make_batch_fn(spec, "train_4k")
            flat, losses = {{}}, []
            for i in range(2):
                b = mb(i)
                sc = scales(jax.tree.map(np.asarray, state), b)
                state, m = step(state, b)
                losses.append([float(m["loss"]), float(m["gnorm"])])
                keep = state if i else {{"err": state["err"]}}
                flat.update({{f"{{i}}/{{k}}": np.asarray(v) for k, v in
                             flatten_with_paths(jax.tree.map(np.asarray, keep))}})
                flat.update({{f"{{i}}/scale/{{k}}": np.asarray(v) for k, v in
                             flatten_with_paths(jax.tree.map(np.asarray, sc))}})
            np.savez(f"{tmp}/ref_{{key}}.npz", **flat)
            json.dump(losses, open(f"{tmp}/ref_{{key}}.json", "w"))
    '''
    code = textwrap.dedent(code).replace("SMOKE", textwrap.dedent(
        inspect.getsource(_smoke)))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


@pytest.fixture(scope="module")
def compressed_run(tmp_path_factory):
    """The 8-rank compressed steps and ``repro``'s reference, run side by
    side from one initial state a case (the port's ``init_state`` at the
    fp32 smoke config)."""
    tmp = tmp_path_factory.mktemp("compressed")
    refs = sorted({(a, v) for a, _, v in CMP_CASES})
    for arch, var in refs:
        tspec = _specs(arch, var)[1]
        state0 = t_ckpt.snapshot(t_train.init_state(
            tspec, t_steps.build_bundle(tspec, "train_4k", "cpu")))
        np.savez(tmp / f"{_case_key(arch, 1, var)}_init.npz",
                 **dict(flatten_with_paths(state0)))
    ref = _repro_compressed(tmp, refs)
    try:
        _torchrun(tmp, 8, "compressed", str(tmp),
                  *(f"{a}:{acc}:{v}" for a, acc, v in CMP_CASES))
        out, err = ref.communicate(timeout=600)
    finally:
        if ref.poll() is None:
            ref.kill()
    assert ref.returncode == 0, err[-4000:]
    return tmp


def _q_steps(got, want, p, scales):
    """Leaf ``p``'s int8 flips against ``repro``'s, from the residuals
    after each step (``s_t q = g + e_{t-1} - e_t``, so each pod's ``q``
    differs at step t by ``(de_{t-1} - de_t) / s_t``, ``de`` the port's
    residual less ``repro``'s): asserts every element's difference is 0
    or one step, and returns (each step's mean-gradient difference that
    the flips make, ``[..]`` per step; the elements a flip touched; the
    most flips at one step)."""
    prev, touched, most, means = 0.0, False, 0, []
    for t, s_t in enumerate(scales):
        de = got[f"{t}/err/{p}"].astype(np.float64) - want[f"{t}/err/{p}"]
        d = prev - de
        zero = np.abs(d) <= FP32["atol"] + FP32["rtol"] * np.abs(
            want[f"{t}/err/{p}"])
        one = np.abs(np.abs(d) - s_t) <= 1e-5 + 1e-3 * s_t
        assert np.all(zero | one), (p, t, np.abs(d[~(zero | one)]) / s_t)
        most = max(most, int((~zero).sum()))
        touched = touched | (~zero).any(0) | (np.abs(de) > FP32["atol"]).any(0)
        means.append(np.where(zero, 0.0, d).sum(0) / d.shape[0])
        prev = de
    return means, touched, most


@pytest.mark.parametrize("case", [_case_key(a, acc, v)
                                  for a, acc, v in CMP_CASES])
def test_compressed_step_matches_repro(compressed_run, case):
    """Two ``compress_pods`` steps on the (2, 2, 2) mesh against
    ``repro``'s compressed step on 2 pods: losses at rtol 1e-5; each
    residual, parameter and optimizer leaf at ``FP32`` except the
    elements whose int8 value flipped by one step against ``repro``'s
    (detected from the residuals, which then differ by that step's
    scale), at most ``MAX_FLIPS`` of a leaf's values of ``q`` a step;
    the gradient norms at rtol 1e-5 plus the norm of what the flips
    move the mean gradient by. ``+accum2`` is the step without it
    (``grad_accum`` ignored, as ``repro`` ignores it)."""
    tmp = compressed_run
    arch, var = _parse_key(case)
    ref_key = _case_key(arch, 1, var)
    got = np.load(tmp / f"cmp_{case}.npz")
    want = np.load(tmp / f"ref_{ref_key}.npz")
    losses, accum, name = json.load(open(tmp / "cmp_losses.json"))[case]
    assert accum == 1 and name.endswith("+int8pods")
    ref_losses = json.load(open(tmp / f"ref_{ref_key}.json"))
    np.testing.assert_allclose([x[0] for x in losses],
                               [x[0] for x in ref_losses], rtol=1e-5)
    params = [k[len("1/params/"):] for k in want.files
              if k.startswith("1/params/")]
    assert params and set(got.files) == {k for k in want.files
                                         if "/scale/" not in k}
    moved = np.zeros(2)
    for p in params:
        scales = [float(want[f"{t}/scale/{p}"]) for t in range(2)]
        means, touched, most = _q_steps(got, want, p, scales)
        moved += [np.sum(m ** 2) for m in means]
        size = want[f"0/err/{p}"].size
        assert most <= MAX_FLIPS * size, (p, most, size)
        for k in [k for k in want.files if k.startswith("1/")
                  and "/scale/" not in k and k.endswith("/" + p)]:
            g, w = got[k], want[k]
            keep = ~touched
            if k.startswith("1/err/"):
                keep = np.broadcast_to(keep, g.shape)
            elif g.shape != keep.shape:
                keep = np.ones(g.shape, bool)
            np.testing.assert_allclose(g[keep], w[keep], err_msg=k, **FP32)
    np.testing.assert_array_equal(got["1/step"], want["1/step"])
    for t in range(2):
        gn, wn = losses[t][1], ref_losses[t][1]
        assert abs(gn - wn) <= 1e-5 * abs(wn) + np.sqrt(moved[t]), (
            t, gn, wn, np.sqrt(moved[t]))


def test_compressed_routing_is_the_pods():
    """``cf05``'s routing of a pod's batch (2 of the 4 sequences, capacity
    33) drops assignments, and keeps other ones than the global batch's
    routing (capacity 65) keeps of those tokens: a step that routed
    across pods would differ from ``repro``'s."""
    from repro_torch.models import moe as t_moe
    spec = _specs("qwen2-moe-a2.7b", "cf05")[1]
    cfg = spec.model_cfg
    params = t_train.init_state(spec, t_steps.build_bundle(
        spec, "train_4k", "cpu"))["params"]
    batch = t_train.make_batch_fn(spec, "train_4k", device="cpu")(0)
    calls, route = [], t_moe.route

    def spy(p, mcfg, xf, *a, **kw):
        r = route(p, mcfg, xf, *a, **kw)
        kept = torch.empty_like(r.keep)
        kept[r.order] = r.keep                   # token order [T * K]
        calls.append((r.cap, kept.view(xf.shape[0], -1)))
        return r
    t_moe.route = spy
    try:
        with torch.no_grad():
            for rows in (slice(0, 2), slice(0, 4)):
                t_tf.lm_loss(params, cfg, batch["tokens"][rows],
                             batch["targets"][rows])
    finally:
        t_moe.route = route
    n = len(calls) // 2
    pod, whole = calls[:n], calls[n:]
    assert n and [c for c, _ in pod] == [33] * n
    assert [c for c, _ in whole] == [65] * n
    assert all((~k).any() for _, k in pod)
    # the first layer sees the same tokens either way
    t = pod[0][1].shape[0]
    assert not torch.equal(pod[0][1], whole[0][1][:t])


@pytest.mark.parametrize("arch", [a for a in j_registry.ASSIGNED
                                  if j_registry.get_spec(a).family == "lm"
                                  and not j_registry.get_spec(a).fsdp_over_pod])
def test_compressed_shardings_equal_repro(arch):
    """The ``compress_pods`` bundle's ``state`` and ``batch`` shardings on
    a ``(pod, data, model)`` mesh are ``repro``'s ``in_shardings``: the
    parameters and optimizer state by the rules, ``err`` as ``("pod",
    *spec)``, the batch ``(dp, None)`` with ``grad_accum`` ignored."""
    names = ("pod", "data", "model")
    jspec, tspec = j_registry.get_spec(arch), t_registry.get_spec(arch)
    ov = {"compress_pods": True, "grad_accum": 4}
    jb = j_steps.build_lm_bundle(jspec, "train_4k", jax.make_mesh(
        (1, 1, 1), names), ov)
    tb = t_steps.build_lm_bundle(tspec, "train_4k", "cpu", ov,
                                 types.SimpleNamespace(mesh_dim_names=names,
                                                       shape=(1, 1, 1)))
    for j_tree, t_tree in zip(jb.in_shardings, (tb.shardings["state"],
                                                tb.shardings["batch"])):
        want = {k: tuple(v.spec) for k, v in flatten_with_paths(
            jax.tree.map(lambda x: x, j_tree, is_leaf=lambda x: isinstance(
                x, jax.sharding.NamedSharding)))}
        got = {k: _spec(v.spec) for k, v in flatten_with_paths(t_tree)}
        assert got == want
    assert tb.shardings["batch"]["tokens"].micro == 1
    assert any(k.startswith("err/") for k, _ in flatten_with_paths(
        tb.shardings["state"]))
    assert tb.static_meta["grad_accum"] == 1


def test_compress_pods_with_fsdp_over_pod_raises():
    """kimi-k2 shards its parameters over ``pod`` (``fsdp_over_pod``), so
    ``compress_pods``'s residual spec ``("pod", *spec)`` names ``pod``
    twice: ``build_lm_bundle`` raises ``ValueError`` naming it, as
    ``repro`` refuses that spec when it builds the step."""
    arch = "kimi-k2-1t-a32b"
    assert t_registry.get_spec(arch).fsdp_over_pod
    _, tm = _meshes(True)
    with pytest.raises(ValueError, match="'pod'"):
        t_steps.build_lm_bundle(t_registry.get_spec(arch), "train_4k", "cpu",
                                {"compress_pods": True}, tm)
    # without the option the bundle builds
    t_steps.build_lm_bundle(t_registry.get_spec(arch), "train_4k", "cpu",
                            None, tm)
    with pytest.raises(Exception, match="pod"):
        j_steps.build_lm_bundle(j_registry.get_spec(arch), "train_4k",
                                jax.make_mesh((1, 1, 1),
                                              ("pod", "data", "model")),
                                {"compress_pods": True})
