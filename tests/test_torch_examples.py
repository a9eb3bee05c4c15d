"""The port's entry points outside the package — the twins of
``examples/`` and ``scripts/`` (``repro_torch.examples``,
``repro_torch.scripts``) — against ``repro`` on the CPU.

Each twin's ``main`` runs in-process with ``--device cpu`` at a small
size. quickstart: its 256 distances and the generated graph bitwise
``repro``'s, the path's weights summing to its distance, the saved index
answering alike. distance_serving, with ``repro``'s MIS permutations
injected: answers and endpoint types bitwise ``repro``'s, the sharded
batch on two CPU devices bitwise the unsharded one, no path violation.
gnn_molecules: three of the twin's ``train_step``s from ``repro``'s
initial parameters against the same three steps built from ``repro``'s
library calls (``examples/gnn_molecules.py``), losses and parameters
within rtol 1e-5 / atol 1e-6 (float32: XLA fuses and reorders the
sums). train_lm at ``tiny_like``'s widths: its losses bitwise those of
the port's own step taken directly from the same state, and a
checkpoint written. smoke_core on one graph ending "ALL OK". obs_report:
``test_bench_gate.py``'s four scenarios, exit codes and report text
equal to ``scripts/obs_report.py``'s. Without CUDA every device twin
raises unless given ``--device cpu``.
"""
from __future__ import annotations

import importlib.util
import signal
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.data import synthetic as j_synthetic
from repro.graphs import generators as j_gen
from repro.graphs import segment_ops as j_sops
from repro.models.gnn import EGNNConfig as JEGNNConfig
from repro.models.gnn import egnn_forward, init_egnn
from repro.optim import adamw as j_adamw
from repro_torch.checkpoint import state_from_tree
from repro_torch.configs import shapes as SH
from repro_torch.configs.base import ArchSpec
from repro_torch.core import ISLabelIndex
from repro_torch.core.sync import upload
from repro_torch.data import synthetic
from repro_torch.examples import distance_serving, gnn_molecules, quickstart
from repro_torch.examples import train_lm
from repro_torch.graphs import generators as t_gen
from repro_torch.launch.train import init_state
from repro_torch.models.transformer import tiny_like
from repro_torch.paths import edge_weight_map
from repro_torch.scripts import obs_report, smoke_core
from repro_torch.train.steps import build_bundle
from repro_torch.tree import flatten_with_paths
from test_bench_gate import _doc, _write
from test_torch_build import jax_perms

ROOT = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-5, 1e-6
# the twins' l_cap; one label chunk (256 rows) keeps repro's build short
J_CFG = JConfig(l_cap=128, label_chunk=256)


def test_quickstart_answers_and_graph_bitwise_repro(tmp_path):
    out = quickstart.main(["--n-pow", "8", "--l-cap", "128", "--device",
                           "cpu", "--out", str(tmp_path / "idx")])
    n, src, dst, w = j_gen.rmat_graph(8, avg_deg=6.0, seed=7)
    for a, b in zip((n, src, dst, w), t_gen.rmat_graph(8, avg_deg=6.0,
                                                       seed=7)):
        np.testing.assert_array_equal(a, b)
    assert out["n"] == n and len(out["distances"]) == 256
    want = JIndex.build(n, src, dst, w, J_CFG).query_host(out["s"], out["t"])
    np.testing.assert_array_equal(out["distances"], want)
    # the path's edge weights sum to its distance
    edges = edge_weight_map(src, dst, w)
    path = out["path"]
    assert path[0] == out["path_pair"][0] and path[-1] == out["path_pair"][1]
    total = sum(edges[(a, b)] for a, b in zip(path[:-1], path[1:]))
    assert total == out["path_dist"]
    loaded = ISLabelIndex.load(tmp_path / "idx", device="cpu")
    np.testing.assert_array_equal(
        loaded.query_host(out["s"], out["t"]), out["distances"])


def test_distance_serving_bitwise_repro_with_its_permutations():
    n, src, dst, w = j_gen.rmat_graph(8, avg_deg=6.0, seed=3)
    out = distance_serving.main(["8", "1024", "--shards", "2", "--l-cap",
                                 "128", "--device", "cpu"],
                                perms=jax_perms(0, n))
    jidx = JIndex.build(n, src, dst, w, J_CFG)
    reqs = out["requests"]
    want = jidx.query_host(reqs[:, 0], reqs[:, 1])
    np.testing.assert_array_equal(out["answers"], want)
    np.testing.assert_array_equal(
        out["types"], np.asarray(jidx.query_types(reqs[:, 0], reqs[:, 1])))
    u, c = np.unique(np.asarray(jidx.query_types(reqs[:, 0], reqs[:, 1])),
                     return_counts=True)
    assert out["mix"] == dict(zip(u.tolist(), c.tolist()))
    assert out["k"] == jidx.k and out["served"] == 1024
    assert out["shards"] == 2 and len(out["entries_per_shard"]) == 2
    assert out["paths_checked"] + out["paths_overflowed"] == 512
    assert out["paths_checked"] > 0


def _j_egnn_step(cfg, opt):
    """``examples/gnn_molecules.py``'s jitted step, from ``repro``'s own
    calls."""
    gm = gnn_molecules

    def loss_fn(p, batch):
        node_out, _ = egnn_forward(p, cfg, batch["feats"], batch["coords"],
                                   batch["edge_src"], batch["edge_dst"])
        pooled = j_sops.segment_sum(node_out[..., 0], batch["graph_ids"],
                                    gm.B + 1)[:gm.B]
        return jnp.mean(jnp.square(pooled - batch["targets"]))

    @jax.jit
    def train_step(p, st, step, batch):
        loss, g = jax.value_and_grad(loss_fn)(p, batch)
        p, st, _ = opt.update(g, st, p, step)
        return p, st, loss

    return train_step


def _j_molecule_batch(i):
    """``examples/gnn_molecules.py``'s batch of step ``i`` from
    ``repro``'s generator."""
    gm = gnn_molecules
    b = j_synthetic.molecule_batch(i, gm.B, gm.ATOMS, gm.EDGES, 16, gm.N_PAD,
                                   gm.E_PAD)
    coords = b["coords"][:gm.B * gm.ATOMS].reshape(gm.B, gm.ATOMS, 3)
    b["targets"] = np.mean(np.sum(
        (coords - coords.mean(1, keepdims=True)) ** 2, -1), 1).astype(
        np.float32)
    return {k: b[k] for k in gm.KEYS}


def _flat_np(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_with_paths(tree)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_gnn_molecules_steps_match_repro(dtype):
    """The twin's ``train_step`` from ``repro``'s ``init_egnn(PRNGKey(0))``
    parameters against ``repro``'s step, on batches bitwise equal.

    In float32, as the example runs, the first step is compared: its
    loss and the optimizer's moments. Its gradient has a norm of ~7e7 and
    is clipped to 1, which puts gradient entries of a few units at
    AdamW's eps, where float32 summation order alone (~1e-6 of max|g|)
    moves a parameter by up to ~2e-4 in one step; the trajectories then
    part. In float64 that noise is ~1e-16 of max|g|, so three chained
    steps hold the losses, parameters and moments to the same
    tolerances."""
    gm = gnn_molecules
    wide = dtype == "float64"
    steps = 3 if wide else 1
    cfg = JEGNNConfig("egnn-mol", n_layers=4, d_hidden=64, d_in=16, n_out=1)
    j_params = init_egnn(jax.random.PRNGKey(0), cfg)[0]
    with jax.enable_x64(wide):
        j_params = jax.tree.map(lambda a: jnp.asarray(np.asarray(a, dtype)),
                                j_params)
        opt = j_adamw(lr=1e-3)
        j_state = opt.init(j_params)
        j_step = _j_egnn_step(cfg, opt)
        params = state_from_tree(jax.tree.map(np.asarray, j_params), "cpu")
        opt_state = gm.OPT.init(params)
        for i in range(steps):
            b = _j_molecule_batch(i)
            batch = gm.make_batch(i, "cpu")
            for k in gm.KEYS:
                np.testing.assert_array_equal(batch[k].numpy(), b[k], k)
            if wide:
                b = {k: v.astype(dtype) if v.dtype.kind == "f" else v
                     for k, v in b.items()}
                batch = {k: upload(b[k], "cpu") for k in gm.KEYS}
            j_params, j_state, j_loss = j_step(
                j_params, j_state, jnp.int32(i),
                {k: jnp.asarray(v) for k, v in b.items()})
            params, opt_state, loss = gm.train_step(
                params, opt_state, torch.tensor(i, dtype=torch.int32), batch)
            assert loss.dtype == getattr(torch, dtype)
            np.testing.assert_allclose(float(loss), float(j_loss), rtol=RTOL)
        got = _flat_np({"params": params, "opt": opt_state})
        want = _flat_np({"params": j_params, "opt": j_state})
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if wide or k.startswith("opt/"):
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL,
                                       err_msg=k)


def test_train_lm_losses_bitwise_its_own_step(tmp_path):
    ckpt = tmp_path / "ckpt"
    sigterm = signal.getsignal(signal.SIGTERM)
    out = train_lm.main(["--tiny", "--steps", "3", "--batch", "2", "--seq",
                         "32", "--device", "cpu", "--ckpt-dir", str(ckpt),
                         "--ckpt-every", "3"])
    assert out["last_checkpoint"] == 3
    # the runner's SIGTERM handler lasts only for the run
    assert signal.getsignal(signal.SIGTERM) is sigterm
    assert (ckpt / "step_000000003" / "manifest.json").exists()
    cfg = tiny_like(train_lm.CFG)
    spec = ArchSpec(arch_id="lm100m", family="lm", model_cfg=cfg,
                    shapes={"train": SH.LMShape("train", "train", 32, 2)})
    bundle = build_bundle(spec, "train", "cpu")
    state, losses = init_state(spec, bundle), []
    for s in range(3):
        batch = {k: upload(v, "cpu") for k, v in
                 synthetic.lm_batch(0, s, 2, 32, cfg.vocab).items()}
        state, m = bundle.fn(state, batch)
        losses.append(float(m["loss"]))
    assert out["losses"] == losses
    assert all(np.isfinite(losses))


def test_smoke_core_one_graph(capsys):
    out = smoke_core.main(["--graph", "er", "--device", "cpu"])
    assert list(out["graphs"]) == ["er"]
    assert out["graphs"]["er"]["mismatches"] == 0
    assert capsys.readouterr().out.rstrip().endswith("ALL OK")


# test_bench_gate.py::test_obs_report_fail_on_policies's scenarios
GATE_CASES = [
    ("timing", dict(us=5000.0), []),
    ("timing", dict(us=5000.0), ["--fail-on", "behavior"]),
    ("behavior", dict(exact=0), ["--fail-on", "behavior"]),
    ("behavior", dict(exact=0), []),
    ("clean", {}, ["--fail-on", "behavior", "--report-out", "REPORT"]),
    ("coverage", {}, ["--fail-on", "behavior", "--tables",
                      "kernels,serving"]),
]


def _repro_obs_report(argv, monkeypatch, capsys):
    """``scripts/obs_report.py``'s ``main`` on ``argv``, in this process:
    (exit code, stdout)."""
    spec = importlib.util.spec_from_file_location(
        "repro_obs_report", ROOT / "scripts" / "obs_report.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["obs_report.py", *argv])
    code = script.main()
    return code, capsys.readouterr().out


@pytest.mark.parametrize("case,doc,extra", GATE_CASES,
                         ids=[f"{c}-{'+'.join(e[:2]) or 'any'}"
                              for c, _, e in GATE_CASES])
def test_obs_report_matches_repro_script(tmp_path, monkeypatch, capsys,
                                         case, doc, extra):
    base, fresh = tmp_path / "base", tmp_path / "fresh"
    _write(base, _doc())
    _write(fresh, _doc(**doc))
    report = tmp_path / "out" / "report.txt"
    argv = ["--baseline", str(base), "--fresh", str(fresh),
            "--timing-tolerance", "0.5",
            *[str(report) if a == "REPORT" else a for a in extra]]
    want_code, want_out = _repro_obs_report(argv, monkeypatch, capsys)
    want_file = report.read_text() if report.exists() else None
    if report.exists():
        report.unlink()
    got = obs_report.main(argv)
    assert got["exit_code"] == want_code, want_out
    assert capsys.readouterr().out == want_out
    assert got["report"] + "\n" in want_out
    if want_file is not None:
        assert report.read_text() == want_file


DEVICE_TWINS = {
    "quickstart": lambda: quickstart.main(["--n-pow", "6"]),
    "distance_serving": lambda: distance_serving.main(["6", "64"]),
    "gnn_molecules": lambda: gnn_molecules.main(["--steps", "1"]),
    "train_lm": lambda: train_lm.main(["--tiny", "--steps", "1"]),
    "smoke_core": lambda: smoke_core.main(["--graph", "er"]),
}


@pytest.mark.parametrize("name", sorted(DEVICE_TWINS))
def test_device_twins_default_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DEVICE_TWINS[name]()
