"""Isolation and no-fallback rules of the PyTorch port.

``repro_torch`` never imports jax nor ``repro`` (not even its numpy-only
modules), nor ``ml_dtypes`` (bf16 host arrays are recognised by dtype
name); its entry points run on the card unless the caller names the
CPU, and a kernel binding given a CPU tensor raises instead of running
something else.
"""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.core import ISLabelIndex, IndexConfig
from repro_torch.graphs import generators as gen
from repro_torch.kernels.backend import resolve_backend

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        repro_torch.__path__, "repro_torch."))


def test_import_pulls_in_neither_jax_nor_repro():
    mods = _modules()
    assert "repro_torch.kernels.spmv_relax.ops" in mods
    assert {"repro_torch.serve.versions",
            "repro_torch.core.directed", "repro_torch.shard.partition",
            "repro_torch.shard.query", "repro_torch.shard.sharded_index",
            "repro_torch.fault.stragglers", "repro_torch.serve.replicas",
            "repro_torch.serve.frontend", "repro_torch.obs.slo",
            "repro_torch.train.steps", "repro_torch.optim.adamw",
            "repro_torch.checkpoint", "repro_torch.fault.runner",
            "repro_torch.launch.train", "repro_torch.models.gnn",
            "repro_torch.configs.registry", "repro_torch.core.vc_baseline",
            "repro_torch.models.dimenet", "repro_torch.models.dien",
            "repro_torch.models.embedding", "repro_torch.configs.dimenet",
            "repro_torch.configs.dien", "repro_torch.models.attention",
            "repro_torch.models.moe", "repro_torch.models.transformer",
            "repro_torch.configs.granite_8b",
            "repro_torch.configs.qwen2_moe_a2_7b",
            "repro_torch.configs.kimi_k2_1t_a32b",
            "repro_torch.configs.yi_34b",
            "repro_torch.configs.qwen2_72b", "repro_torch.configs.islabel",
            "repro_torch.data.pipeline", "repro_torch.launch.mesh",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.compression",
            "repro_torch.launch.analysis", "repro_torch.launch.dryrun",
            "repro_torch.launch.perf", "repro_torch.obs.regression"} \
        <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith('jax.') or k == 'repro' or k.startswith('repro.') "
            "or k == 'ml_dtypes')\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
           "PATH": "/usr/bin:/bin"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports_in_source(path):
    text = path.read_text()
    assert not re.search(r"^\s*(import jax|from jax|import ml_dtypes|"
                         r"from ml_dtypes)", text, re.M)
    assert not re.search(r"^\s*(from repro[\s.]|import repro[\s.]|"
                         r"import repro$)", text, re.M)


def test_build_without_device_raises_off_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    n, src, dst, w = gen.er_graph(64, 2.0, seed=0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ISLabelIndex.build(n, src, dst, w, IndexConfig())
    idx = ISLabelIndex.build(n, src, dst, w, IndexConfig(l_cap=64),
                             device="cpu")
    assert idx.device.type == "cpu"


def _default_device_calls():
    """Each entry point called without a device (the card by default)."""
    from repro_torch.core import build_hierarchy
    from repro_torch.core.dispatch import CoreRelaxer
    from repro_torch.core.hierarchy import (build_hierarchy_device,
                                            build_hierarchy_host)
    from repro_torch.core.labeling import build_labels
    from repro_torch.graphs.csr import from_host_edges
    from repro_torch.checkpoint import state_from_tree
    from repro_torch.configs import registry
    from repro_torch.launch import train
    from repro_torch.launch.serve import main
    from repro_torch.core.vc_baseline import build_vc_index
    from repro_torch.models.transformer import init_cache, init_lm
    from repro_torch.data import PrefetchPipeline
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.steps import (StepBundle, build_gnn_bundle,
                                         build_islabel_bundle,
                                         build_lm_bundle, build_recsys_bundle)
    from repro_torch.serve.versions import VersionFamily
    from repro_torch.shard import ShardedIndex
    n, src, dst, w = gen.er_graph(64, 2.0, seed=0)
    cfg = IndexConfig(l_cap=64)
    lm = train.smoke_spec(registry.get_spec("granite-8b"))
    lm_cfg = lm.model_cfg
    return {
        "build_hierarchy": lambda: build_hierarchy(n, src, dst, w, cfg),
        "build_hierarchy_device":
            lambda: build_hierarchy_device(n, src, dst, w, cfg),
        "build_hierarchy_host":
            lambda: build_hierarchy_host(n, src, dst, w, cfg),
        "build_labels": lambda: build_labels(
            build_hierarchy(n, src, dst, w, cfg, device="cpu"), cfg),
        "CoreRelaxer": lambda: CoreRelaxer(src, dst, w, n),
        "from_host_edges": lambda: from_host_edges(src, dst, w, n),
        "VersionFamily": lambda: VersionFamily(n, 8, 64, 4),
        "ShardedIndex.build":
            lambda: ShardedIndex.build(n, src, dst, w, cfg, num_shards=2),
        "launcher --mode http": lambda: main(
            ["--mode", "http", "--graph", "er", "--n", "64", "--queries",
             "8"]),
        "build_gnn_bundle": lambda: build_gnn_bundle(
            registry.get_spec("gcn-cora"), "full_graph_sm"),
        "build_vc_index": lambda: build_vc_index(n, src, dst, w, cfg),
        "build_recsys_bundle": lambda: build_recsys_bundle(
            registry.get_spec("dien"), "serve_p99"),
        "train.make_batch_fn (dien)": lambda: train.make_batch_fn(
            train.smoke_spec(registry.get_spec("dien")), "train_batch"),
        "train.make_batch_fn": lambda: train.make_batch_fn(
            registry.get_spec("gcn-cora"), "molecule"),
        "train.main": lambda: train.main(["--arch", "gcn-cora", "--smoke",
                                          "--steps", "2"]),
        "state_from_tree": lambda: state_from_tree({"w": np.zeros(2)}),
        "build_lm_bundle": lambda: build_lm_bundle(
            registry.get_spec("qwen2-moe-a2.7b"), "decode_32k"),
        "build_lm_bundle (train)": lambda: build_lm_bundle(
            lm, "train_4k", overrides={"grad_accum": 2}),
        "train.make_batch_fn (lm)": lambda: train.make_batch_fn(
            lm, "train_4k"),
        "train.init_state (lm)": lambda: train.init_state(
            lm, StepBundle("lm", None, torch.device("cuda"),
                           static_meta={"cfg": lm_cfg})),
        "init_lm": lambda: init_lm(lm_cfg),
        "init_cache": lambda: init_cache(lm_cfg, 2, 8),
        "launcher --mode lm": lambda: main(
            ["--mode", "lm", "--arch", "granite-8b", "--batch", "2",
             "--gen-len", "2"]),
        "build_islabel_bundle": lambda: build_islabel_bundle(
            registry.get_spec("islabel"), "serve_1m"),
        "PrefetchPipeline": lambda: PrefetchPipeline(lambda step: {}),
        "make_host_mesh": lambda: make_host_mesh(1),
        "train.main --model-parallel": lambda: train.main(
            ["--arch", "granite-8b", "--smoke", "--steps", "2",
             "--model-parallel", "2"]),
    }


@pytest.mark.parametrize("name", sorted(_default_device_calls()))
def test_entry_points_default_to_the_card(name):
    """Without a device every entry point means the card, and raises on
    a machine without CUDA."""
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _default_device_calls()[name]()


def test_backend_resolution():
    assert resolve_backend(None, "cpu") == "reference"
    assert resolve_backend("auto", torch.device("cuda")) == "cuda"
    assert resolve_backend("cuda", "cpu") == "cuda"
    with pytest.raises(ValueError):
        resolve_backend("pallas", "cpu")


def test_backend_env_override(monkeypatch):
    monkeypatch.setenv("ISLABEL_BACKEND", "cuda")
    assert resolve_backend(None, "cpu") == "cuda"
    assert resolve_backend("reference", "cpu") == "reference"


def test_kernel_bindings_refuse_cpu_tensors():
    """A binding never falls back: a CPU operand raises before any
    build or launch."""
    from repro_torch.kernels.label_intersect.kernel import (
        label_intersect_kernel, label_intersect_packed_kernel)
    from repro_torch.kernels.minplus_matmul.kernel import \
        minplus_matmul_kernel
    from repro_torch.kernels.spmv_relax.kernel import (RelaxCSR, SlicedEdges,
                                                       fused_relax_kernel,
                                                       spmv_relax_kernel)
    ids = torch.zeros((8, 4), dtype=torch.int32)
    d = torch.zeros((8, 4))
    delta = torch.zeros((8, 4), dtype=torch.int16)
    base = torch.zeros(8, dtype=torch.int32)
    csr = RelaxCSR(torch.zeros(9, dtype=torch.int32),
                   torch.zeros(0, dtype=torch.int32), torch.zeros(0),
                   torch.arange(8, dtype=torch.int32), 0)
    sliced = SlicedEdges(torch.arange(4, dtype=torch.int32),
                         torch.zeros(2, dtype=torch.int32),
                         torch.zeros(0, dtype=torch.int32), torch.zeros(0))
    mask = torch.full((1, 8), -1, dtype=torch.int16)
    flag = torch.ones(1, dtype=torch.int32)
    calls = [lambda: label_intersect_kernel(ids, d, ids, d, 5),
             lambda: label_intersect_packed_kernel(delta, base, ids, delta,
                                                   base, ids, 5),
             lambda: spmv_relax_kernel(d, csr, mask, flag, d.clone(),
                                       mask.clone(), flag.clone()),
             lambda: fused_relax_kernel(d, sliced, max_rounds=3),
             lambda: minplus_matmul_kernel(d, d.T.contiguous())]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA tensor"):
            call()


def test_compressed_labels_build_and_serve_delta16():
    """``label_dtype="compressed"`` builds, and its engine serves the
    delta16 codec (the packed kernel's path)."""
    n, src, dst, w = gen.er_graph(64, 2.0, seed=0)
    idx = ISLabelIndex.build(n, src, dst, w,
                             IndexConfig(l_cap=64, label_dtype="compressed"),
                             device="cpu")
    assert idx.engine.codec == "delta16"
    assert idx.engine.enc_ids.dtype == torch.int16
