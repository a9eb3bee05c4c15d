"""Performance hillclimbing: trace named VARIANTS of a cell and
record the roofline-term deltas — the port of ``repro.launch.perf``
over ``launch/dryrun``'s traced step (the production mesh on the fake
process group, ``FakeTensorMode``, the H100 model of
``launch/analysis``; depth probes as there).

  PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen2-72b:train_4k
  PYTHONPATH=src python -m repro_torch.launch.perf --cell qwen2-moe-a2.7b:train_4k:mp

The overrides reach the port's bundles: ``relax_chunks``, ``lbl_dtype``
and ``relax_rounds`` the ``islabel`` query; ``grad_accum`` the LM train
step (``accum_unroll`` is accepted and ignored); ``ce_impl``,
``act_shard``, ``remat``/``remat_policy`` and the MoE fields the model
config.
"""
import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path

from repro_torch.configs import registry
from repro_torch.launch.dryrun import trace_cell

# variant = (model_cfg field overrides, bundle overrides, spec overrides)
VARIANTS = {
    "qwen2-72b:train_4k": {
        "baseline": ({}, {}, {}),
        "iota_ce": ({"ce_impl": "iota"}, {}, {}),
        "iota+accum4": ({"ce_impl": "iota"}, {"grad_accum": 4}, {}),
        "iota+accum8": ({"ce_impl": "iota"}, {"grad_accum": 8}, {}),
        "iota+accum4+actshard": ({"ce_impl": "iota", "act_shard": True},
                                 {"grad_accum": 4}, {}),
        # with temp headroom from accum+actshard, buy back the remat
        # recompute (saves ~2ND fwd flops + its traffic)
        "accum8+actshard+dots": ({"ce_impl": "iota", "act_shard": True,
                                  "remat_policy": "dots"},
                                 {"grad_accum": 8}, {}),
        "accum8+actshard+noremat": ({"ce_impl": "iota", "act_shard": True,
                                     "remat": False},
                                    {"grad_accum": 8}, {}),
    },
    "qwen2-moe-a2.7b:train_4k:mp": {
        "baseline": ({}, {}, {}),
        "iota_ce": ({"ce_impl": "iota"}, {}, {}),
        "disp_shard": ({"moe": {"dispatch_shard": True}}, {}, {}),
        "disp_shard+cf1": ({"moe": {"dispatch_shard": True,
                                    "capacity_factor": 1.0}}, {}, {}),
        "disp_shard+accum4": ({"moe": {"dispatch_shard": True}},
                              {"grad_accum": 4}, {}),
        # pad 60 -> 64 experts: true EP over the model axis (local expert
        # GEMMs; dispatch becomes all-to-all instead of buffer all-reduce)
        "ep_pad64": ({"moe": {"ep_pad": 64}}, {}, {}),
        "ep_pad64+accum4": ({"moe": {"ep_pad": 64}}, {"grad_accum": 4}, {}),
        "ep_pad64+scatter": ({"moe": {"ep_pad": 64,
                                      "combine_impl": "scatter"}}, {}, {}),
        # int8_pods (shard_map over pod + auto axes) hits an XLA SPMD
        # partitioner CHECK-failure at 512 devices (b/433785288-class);
        # the compression path is validated at 8 devices in
        # tests/test_distributed.py instead.
    },
    "kimi-k2-1t-a32b:train_4k:mp": {
        "baseline": ({}, {}, {}),
        "iota_ce": ({"ce_impl": "iota"}, {}, {}),
        "iota+accum4": ({"ce_impl": "iota"}, {"grad_accum": 4}, {}),
        "iota+accum4+actshard": ({"ce_impl": "iota", "act_shard": True},
                                 {"grad_accum": 4}, {}),
    },
    "islabel:serve_128m": {
        "baseline": ({}, {}, {}),
        "chunked_relax": ({}, {"relax_chunks": 64}, {}),
        "bf16_labels": ({}, {"lbl_dtype": "bfloat16"}, {}),
        "chunked+bf16": ({}, {"relax_chunks": 64,
                              "lbl_dtype": "bfloat16"}, {}),
        "chunked+bf16+r6": ({}, {"relax_chunks": 64,
                                 "lbl_dtype": "bfloat16",
                                 "relax_rounds": 6}, {}),
        "chunked256": ({}, {"relax_chunks": 256}, {}),
        "chunked1024": ({}, {"relax_chunks": 1024}, {}),
    },
    "dimenet:ogb_products": {
        "baseline": ({}, {}, {}),
    },
}


def run_variant(arch, shape, multi_pod, model_over, bundle_over, spec_over,
                name, out_dir: Path):
    spec = registry.get_spec(arch)
    if model_over:
        mo = dict(model_over)
        cfg = spec.model_cfg
        if "moe" in mo:                       # nested MoE overrides
            cfg = dataclasses.replace(
                cfg, moe=dataclasses.replace(cfg.moe, **mo.pop("moe")))
        spec = dataclasses.replace(
            spec, model_cfg=dataclasses.replace(cfg, **mo))
    if spec_over:
        spec = dataclasses.replace(spec, **spec_over)
    rec = {"arch": arch, "shape": shape, "variant": name,
           "model_over": model_over, "bundle_over": bundle_over}
    try:
        t0 = time.perf_counter()
        rec.update(trace_cell(spec, shape, multi_pod,
                              overrides=dict(bundle_over)))
        rec.update(ok=True, trace_s=round(time.perf_counter() - t0, 1))
        print(f"[{name}] peak={rec['peak_bytes_per_device']:.4g} "
              f"t_mem={rec['t_memory_s']:.4g} "
              f"t_coll={rec['t_collective_s']:.4g} "
              f"t_comp={rec['t_compute_s']:.4g} dom={rec['dominant']}",
              flush=True)
    except Exception as e:
        rec.update(ok=False, error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-3000:])
        print(f"[{name}] FAIL {rec['error'][:200]}", flush=True)
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = "multipod" if multi_pod else "singlepod"
    (out_dir / f"{arch}__{shape}__{tag}__{name}.json").write_text(
        json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True)
    ap.add_argument("--variant", default=None)
    ap.add_argument("--out", default="experiments/perf")
    args = ap.parse_args(argv)
    parts = args.cell.split(":")
    arch, shape = parts[0], parts[1]
    multi = len(parts) > 2 and parts[2] == "mp"
    variants = VARIANTS[args.cell]
    if args.variant:
        variants = {args.variant: variants[args.variant]}
    recs = [run_variant(arch, shape, multi, mo, bo, so, name, Path(args.out))
            for name, (mo, bo, so) in variants.items()]
    raise SystemExit(0 if all(r["ok"] for r in recs) else 1)


if __name__ == "__main__":
    main()
