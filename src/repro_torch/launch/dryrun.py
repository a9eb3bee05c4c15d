"""Multi-pod dry run: trace one step of every (arch x shape) cell on the
production mesh and record its per-device cost — the torch form of
``repro.launch.dryrun``'s 512-device AOT compile.

One process stands in for rank 0 of a world of 256 (``(16, 16)``) or
512 (``(2, 16, 16)``) ranks: ``torch.distributed`` runs over the fake
backend (collectives return at once and move nothing), the cell's
bundle is built with its state and batch laid out as DTensors by the
sharding rules (``train/steps.py``'s mesh path), and everything is
created under ``FakeTensorMode``, so no memory is used and nothing is
computed. One step is traced eagerly under ``launch/analysis``'s
counting modes, from local shapes. Nothing touches a card.

Depth probes (``repro``'s ``_probe_specs``): an eager trace counts every
layer, but at about a millisecond an op a full-depth LM step (~10^5
ops) takes minutes, so the LMs are traced at 2 and 3 layers and DIEN at
4 and 8 time steps, and every count (peak bytes included) is
extrapolated linearly to the real depth, exact for homogeneous stacks.
The argument bytes are those of the full-depth state. ``--no-probes``
traces at full depth. ``--jobs N`` traces N cells at a time, each in a
process of its own.

Usage:
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--include-islabel] \\
      [--multipod single|multi|both] [--out experiments/dryrun]
  python -m repro_torch.launch.dryrun --arch granite-8b --shape train_4k \\
      --multipod multi --compress-pods

Each cell writes ``<out>/<arch>__<shape>__<singlepod|multipod>.json``
(``multipod+int8pods`` with ``--compress-pods``: the LM train step's
``compress_pods`` override, int8 gradients across pods);
a failure is recorded there with its trace, and the exit code is 1 if
any cell failed. ``fits_80gb`` says whether the cell's peak bytes per
device fit one card's 80 GB: a cell that traces ``ok`` may still need
more memory than a card has.
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.configs import registry
from repro_torch.launch.analysis import (HBM_BYTES, nbytes, roofline,
                                         trace_costs)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.tree import leaves, tree_map


def fake_world(world: int) -> None:
    """Make this process rank 0 of a fake world of ``world`` ranks (an
    existing fake world of another size is torn down first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _zeros(spec):
    return torch.zeros(spec.shape, dtype=spec.dtype)


def cell_inputs(spec, shape: str, bundle) -> tuple:
    """The step's arguments as zeros of the cell's shapes (fake tensors
    under the caller's ``FakeTensorMode``), laid out on the bundle's
    mesh. Returns ``(args, step)`` with ``step()`` running it once."""
    shp = spec.shape(shape)
    batch = tree_map(_zeros, spec.input_specs(shape))
    if spec.family == "graph_index":
        if shp.kind == "query":
            batch["lbl_d"] = batch["lbl_d"].to(bundle.static_meta["lbl_dtype"])
            args = (bundle.place_batch(batch),)
            return args, lambda: bundle.fn(*args)
        perm = torch.arange(shp.n_vertices, dtype=torch.int32)
        args = (bundle.place_batch(batch), perm)
        return args, lambda: bundle.fn(*args, mis_rounds=16)
    if spec.family == "lm" and shp.kind == "decode":
        state = bundle.place_state(_lm_params(spec, bundle))
        b = bundle.place_batch({"cache": batch["cache"],
                                "last_tokens": batch["last_tokens"]})
        args = (state["params"], b["cache"], b["last_tokens"])
        return args, lambda: bundle.fn(*args)
    if spec.family == "lm" and shp.kind == "prefill":
        state = bundle.place_state(_lm_params(spec, bundle))
        b = bundle.place_batch(batch)
        return (state["params"], b), lambda: bundle.fn(state["params"], b)
    if bundle.optimizer is None:                      # DIEN serve/retrieval
        state = bundle.place_state({"params": _params(spec, bundle)})
        b = bundle.place_batch(batch)
        return (state["params"], b), lambda: bundle.fn(state["params"], b)
    state = bundle.place_state(_state(spec, bundle))
    b = bundle.place_batch(batch)
    return (state, b), lambda: bundle.fn(state, b)


def _lm_params(spec, bundle):
    from repro_torch.models.transformer import abstract_params
    return {"params": tree_map(lambda t: torch.zeros(
        t.shape, dtype=getattr(torch, spec.param_dtype)),
        abstract_params(spec.model_cfg))}


def _params(spec, bundle):
    from repro_torch.models import dien as D
    from repro_torch.models import layers as L
    from repro_torch.train.steps import _gnn_model
    cfg = bundle.static_meta.get("cfg", spec.model_cfg)
    with torch.device("meta"):
        model = D.DIEN(cfg) if spec.family == "recsys" else _gnn_model(cfg)
    return tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype),
                    L.params_tree(model))


def _state(spec, bundle):
    """The train state of zeros (``launch/train.init_state``'s tree; its
    random draws would need values the fake mode does not hold)."""
    if spec.family == "lm":
        params = _lm_params(spec, bundle)["params"]
    else:
        params = _params(spec, bundle)
    state = {"params": params, "opt": bundle.optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    if bundle.static_meta.get("compress"):
        from repro_torch.distributed.compression import init_error_feedback
        state["err"] = init_error_feedback(params,
                                           bundle.static_meta["n_pods"])
    return state


def probe_specs(spec):
    """``repro``'s depth probes: ``(lo, hi, d_lo, d_hi, d_real)`` for the
    depth-stacked families (LM layers, DIEN time steps), else None."""
    import dataclasses as dc
    cfg = spec.model_cfg
    if spec.family == "lm" and cfg.n_layers > 3:
        return (dc.replace(spec, model_cfg=dc.replace(cfg, n_layers=2)),
                dc.replace(spec, model_cfg=dc.replace(cfg, n_layers=3)),
                2, 3, cfg.n_layers)
    if spec.family == "recsys" and cfg.seq_len > 8:
        return (dc.replace(spec, model_cfg=dc.replace(cfg, seq_len=4)),
                dc.replace(spec, model_cfg=dc.replace(cfg, seq_len=8)),
                4, 8, cfg.seq_len)
    return None


def _trace(spec, shape: str, mesh, overrides, count: bool = True) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.train.steps import build_bundle
    t0 = time.perf_counter()
    with FakeTensorMode():
        bundle = build_bundle(spec, shape, "cpu", overrides, mesh)
        args, step = cell_inputs(spec, shape, bundle)
        arg_bytes = sum(nbytes(t) for t in leaves(_as_tree(args)))
        if not count:
            return {"arg_bytes": arg_bytes, "name": bundle.name}
        t1 = time.perf_counter()
        cost = trace_costs(step, arg_bytes)
    cost.update(arg_bytes=arg_bytes, name=bundle.name,
                build_s=t1 - t0, trace_s=time.perf_counter() - t1)
    return cost


def trace_cell(spec, shape: str, multi_pod: bool, overrides=None,
               probes: bool = True) -> dict:
    """Build and trace one cell on the production mesh (the module
    docstring). Returns the per-device record."""
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    pr = probe_specs(spec) if probes else None
    rec = {"mesh": "x".join(map(str, mesh.shape)),
           "axes": list(mesh.mesh_dim_names), "devices": mesh.size()}
    if pr is None:
        cost = _trace(spec, shape, mesh, overrides)
    else:
        lo_spec, hi_spec, d_lo, d_hi, d_real = pr
        lo = _trace(lo_spec, shape, mesh, overrides)
        hi = _trace(hi_spec, shape, mesh, overrides)
        k = (d_real - d_lo) / (d_hi - d_lo)

        def ext(a, b):
            return a + k * (b - a)
        cost = {key: ext(lo[key], hi[key]) for key in
                ("flops", "bytes accessed", "peak_bytes", "ops")}
        cost["collective_bytes"] = {
            key: ext(lo["collective_bytes"].get(key, 0),
                     hi["collective_bytes"].get(key, 0))
            for key in set(lo["collective_bytes"]) | set(
                hi["collective_bytes"])}
        cost.update(_trace(spec, shape, mesh, overrides, count=False),
                    build_s=lo["build_s"] + hi["build_s"],
                    trace_s=lo["trace_s"] + hi["trace_s"])
        rec["probe"] = {"depths": [d_lo, d_hi, d_real],
                        "flops_lo_hi": [lo["flops"], hi["flops"]]}
    coll = cost["collective_bytes"]
    rec.update(step=cost["name"], build_s=round(cost["build_s"], 2),
               trace_s=round(cost["trace_s"], 2),
               flops_per_device=cost["flops"],
               bytes_per_device=cost["bytes accessed"],
               collective_bytes_per_device=coll,
               argument_bytes_per_device=cost["arg_bytes"],
               peak_bytes_per_device=cost["peak_bytes"],
               fits_80gb=cost["peak_bytes"] <= HBM_BYTES, ops=cost["ops"])
    rec.update(roofline(cost["flops"], cost["bytes accessed"], coll["total"]))
    return rec


def _as_tree(args) -> dict:
    return {str(i): a if isinstance(a, (dict, torch.Tensor)) else {}
            for i, a in enumerate(args)}


def run_cell(arch: str, shape: str, multi_pod: bool, out_dir: Path,
             verbose: bool = True, probes: bool = True,
             overrides: dict | None = None) -> dict:
    rec = {"arch": arch, "shape": shape, "overrides": overrides or {}}
    try:
        rec.update(trace_cell(registry.get_spec(arch), shape, multi_pod,
                              overrides, probes=probes))
        rec["ok"] = True
        if verbose:
            print(f"[{arch}/{shape}/{rec['mesh']}] ok "
                  f"trace={rec['trace_s']}s "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"bytes/dev={rec['bytes_per_device']:.3e} "
                  f"coll/dev={rec['collective_bytes_per_device']['total']:.3e} "
                  f"args={rec['argument_bytes_per_device']} "
                  f"peak={rec['peak_bytes_per_device']} "
                  f"fits_80gb={rec['fits_80gb']} "
                  f"dom={rec['dominant']}", flush=True)
    except Exception as e:   # record failures — they are bugs to fix
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
        if verbose:
            print(f"[{arch}/{shape}] FAIL {rec['error'][:300]}", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = ("multipod" if multi_pod else "singlepod") + (
        "+int8pods" if (overrides or {}).get("compress_pods") else "")
    (out_dir / f"{arch}__{shape}__{tag}.json").write_text(
        json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-islabel", action="store_true")
    ap.add_argument("--multipod", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--jobs", type=int, default=1)
    ap.add_argument("--compress-pods", action="store_true",
                    help="the LM train step's compress_pods override")
    args = ap.parse_args(argv)
    out = Path(args.out)

    cells = (registry.all_cells(include_islabel=args.include_islabel)
             if args.all else [(args.arch, args.shape)])
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.multipod]
    ov = {"compress_pods": True} if args.compress_pods else None
    work = [(arch, shape, mp, out, True, not args.no_probes, ov)
            for arch, shape in cells for mp in meshes]
    if args.jobs > 1:
        import multiprocessing as mproc
        with mproc.get_context("spawn").Pool(args.jobs) as pool:
            recs = pool.starmap(run_cell, work, chunksize=1)
    else:
        recs = [run_cell(*w) for w in work]
    n_fail = sum(0 if rec.get("ok") else 1 for rec in recs)
    print(f"dry-run complete: {len(cells) * len(meshes)} cells, "
          f"{n_fail} failures")
    if dist.is_initialized():
        dist.destroy_process_group()
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
