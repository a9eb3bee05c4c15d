"""Training launcher: the port of ``repro.launch.train`` on one device.

Wires together the substrate: config registry -> step bundle on
``--device`` -> synthetic data -> fault-tolerant runner (async
checkpoints, NaN rollback, preemption handling, stragglers).

  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
      --steps 50 --ckpt-dir /path/to/ckpt

``--device`` defaults to ``cuda`` and raises without CUDA; ``--device
cpu`` runs on the CPU. ``--smoke`` swaps in the reduced config (same
structure, tiny dims). Every family trains here: the five LMs
(``granite-8b``, ``qwen2-moe-a2.7b``, ``kimi-k2-1t-a32b`` with
Adafactor and bf16 parameters, ``yi-34b``, ``qwen2-72b``; the
``train_4k`` step), the GNNs (``gcn-cora``, ``graphsage-reddit``,
``egnn``, ``dimenet``) and DIEN:

  PYTHONPATH=src python -m repro_torch.launch.train --arch granite-8b \\
      --smoke --steps 20

Under ``torchrun`` (one process a card) the step runs over a
``(world // N, N)`` ``("data", "model")`` mesh (``--model-parallel N``,
``launch/mesh.make_host_mesh``): the state laid out by the sharding
rules, the batch over ``data``, checkpoints gathered and written by
rank 0 (``train/steps.py``'s mesh path):

  PYTHONPATH=src torchrun --nproc-per-node=4 -m repro_torch.launch.train \\
      --arch granite-8b --smoke --steps 20 --model-parallel 2

``--model-parallel`` above 1 without ``torchrun`` starts a world of one
rank, which only ``--model-parallel 1`` divides.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.configs.base import ArchSpec
from repro_torch.core.sync import host_read, upload
from repro_torch.data import synthetic
from repro_torch.fault import FaultTolerantRunner, RunnerConfig
from repro_torch.kernels.backend import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.dien import init_dien
from repro_torch.models.dimenet import build_triplets
from repro_torch.models.transformer import init_lm
from repro_torch.train.steps import StepBundle, _gnn_init, build_bundle
from repro_torch.tree import tree_map


def smoke_spec(spec: ArchSpec) -> ArchSpec:
    """Reduced-config spec with smoke shapes (CPU-runnable)."""
    from repro_torch.configs import shapes as SH
    cfg = spec.smoke_cfg_fn()
    if spec.family == "lm":
        shp = {"train_4k": SH.LMShape("train_4k", "train", 64, 4)}
    elif spec.family == "gnn":
        d_in = cfg.d_in if hasattr(cfg, "d_in") else 8
        shp = {"full_graph_sm": SH.GNNShape("full_graph_sm", "full", 200,
                                            600, d_in, n_classes=4),
               "molecule": SH.GNNShape("molecule", "molecule", 8, 12, d_in,
                                       batch_graphs=4, n_classes=1)}
    elif spec.family == "recsys":
        shp = {"train_batch": SH.RecShape("train_batch", "train", 32)}
    else:
        raise KeyError(spec.family)
    return dataclasses.replace(spec, model_cfg=cfg, shapes=shp)


def init_state(spec: ArchSpec, bundle: StepBundle):
    """Real params + optimizer state on the bundle's device (the
    parameters alone for a bundle without an optimizer: an LM's prefill
    and decode). The parameters are drawn from a ``torch.Generator``
    seeded 0 (other values than ``jax.random``'s, at ``repro``'s scale):
    on the CPU for the GNNs, on the bundle's device for DIEN, whose
    2^26-row item table would take long to draw on the host, and for
    the LMs, in ``spec.param_dtype``."""
    cfg = bundle.static_meta.get("cfg", spec.model_cfg)
    if spec.family == "lm":
        params = init_lm(cfg, 0, bundle.device,
                         getattr(torch, spec.param_dtype))
        if bundle.optimizer is None:
            return {"params": params}
    elif spec.family == "recsys":
        params = init_dien(
            cfg, torch.Generator(bundle.device).manual_seed(0))
    else:
        params = _gnn_init(cfg, torch.Generator().manual_seed(0))
    state = {"params": params, "opt": bundle.optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    if bundle.static_meta.get("compress"):
        from repro_torch.distributed.compression import init_error_feedback
        state["err"] = init_error_feedback(params,
                                           bundle.static_meta["n_pods"])
    return tree_map(lambda x: upload(x, bundle.device), state)


def make_batch_fn(spec: ArchSpec, shape_name: str, seed: int = 0,
                  device=None):
    """``step -> batch``: ``repro``'s arrays (bitwise) on ``device`` (the
    card unless the caller names the CPU). A GNN's graph is static: it
    is built and uploaded once, and every step gets it. An LM and DIEN
    draw a batch a step (``lm_batch(seed, step, ...)``, ``dien_batch``)
    and upload it."""
    device = resolve_device(device)
    shp = spec.shape(shape_name)
    cfg = spec.model_cfg
    specs = spec.input_specs(shape_name)
    if spec.family == "lm":
        return lambda step: {k: upload(v, device) for k, v in
                             synthetic.lm_batch(seed, step, shp.global_batch,
                                                shp.seq_len,
                                                cfg.vocab).items()}
    if spec.family == "recsys":
        return lambda step: {k: upload(v, device) for k, v in
                             synthetic.dien_batch(
                                 seed, step, shp.batch, cfg.seq_len,
                                 cfg.n_items, cfg.n_cats,
                                 cfg.n_users).items()}
    n_pad = specs["feats"].shape[0]
    e_pad = specs["edge_src"].shape[0]
    if shp.kind == "molecule":
        t_cap = specs["trip_kj"].shape[0] if "trip_kj" in specs else 0
        batch = synthetic.molecule_batch(seed, shp.batch_graphs, shp.n_nodes,
                                         shp.n_edges, shp.d_feat, n_pad,
                                         e_pad, t_cap)
    else:
        batch = synthetic.gnn_full_batch(seed, shp.n_nodes, 4.0, shp.d_feat,
                                         shp.n_classes, n_pad, e_pad,
                                         "coords" in specs)
        if "atom_z" in specs:
            batch["atom_z"] = np.minimum(
                np.abs(batch["feats"][:, 0] * 10).astype(np.int32), 94)
        if "trip_kj" in specs:
            t_cap = specs["trip_kj"].shape[0]
            valid = batch["edge_src"] < shp.n_nodes
            tkj, tji = build_triplets(batch["edge_src"][valid],
                                      batch["edge_dst"][valid],
                                      shp.n_nodes, t_cap)
            nv = int(valid.sum())
            batch["trip_kj"] = np.where(tkj == nv, e_pad, tkj)
            batch["trip_ji"] = np.where(tji == nv, e_pad, tji)
    batch = {k: upload(v, device) for k, v in batch.items()}
    return lambda step: batch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    mesh = None
    if args.model_parallel > 1 or "WORLD_SIZE" in os.environ:
        mesh = make_host_mesh(args.model_parallel, device)
        device = torch.device(mesh.device_type,
                              int(os.environ.get("LOCAL_RANK", "0"))) \
            if mesh.device_type == "cuda" else device
    lead = mesh is None or dist.get_rank() == 0

    spec = registry.get_spec(args.arch)
    if args.smoke:
        spec = smoke_spec(spec)
    shape_name = args.shape or next(iter(spec.shapes))
    bundle = build_bundle(spec, shape_name, device, mesh=mesh)
    state = bundle.place_state(init_state(spec, bundle))
    whole_batch = make_batch_fn(spec, shape_name, device=device)

    def make_batch(step):
        return bundle.place_batch(whole_batch(step))

    runner = FaultTolerantRunner(
        bundle.fn, state, make_batch,
        RunnerConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every))
    if args.resume:
        start = runner.restore()
        if lead:
            print(f"resumed at step {start}")

    t0 = time.time()
    steps, losses = [], []
    runner.run(args.steps, on_metrics=lambda s, m: (
        steps.append(s), losses.append(m["loss"])))
    dt = time.time() - t0
    # the runner read each loss already; the list is read back once
    losses = [float(x) for x in host_read(tuple(losses))] if losses else []
    if mesh is not None:
        dist.destroy_process_group()
    if not lead:
        return
    where = (f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}"
             if mesh is not None else str(device))
    print(f"[{spec.arch_id}/{shape_name}] {args.steps} steps in {dt:.1f}s "
          f"({dt / max(args.steps, 1):.3f}s/step) on {where}")
    shown = list(zip(steps, losses))
    for s, l in shown[:3] + shown[-3:]:
        print(f"  step {s}: loss {l:.4f}")
    if len(losses) > 5 and not losses[-1] < losses[0] * 1.5:
        raise SystemExit("loss diverged")
    print("done")


if __name__ == "__main__":
    main()
