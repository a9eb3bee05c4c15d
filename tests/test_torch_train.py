"""GNN training in the PyTorch port against ``repro`` on the CPU: the
step bundles of ``gcn-cora``, ``graphsage-reddit``, ``egnn`` and
``dimenet`` (``train/steps.py``, ``models/gnn.py``,
``models/dimenet.py``), the sampler, the synthetic batches and DimeNet's
triplet lists, the segment reductions and ``launch/train.py``.

Each cell runs at the launcher's smoke sizes (``smoke_spec``): the port's
bundle starts from ``repro``'s initial state carried across
(``state_from_tree``) on ``repro``'s batch and takes three steps beside
``repro``'s jitted step (one per cell, module-scoped). Loss, gradient
norm and every array of the state agree to rtol 1e-5 and atol 1e-6
(float32: XLA fuses and reorders the sums). The warm-up schedule keeps
the parameters within ~1e-7 of where they start over three steps, so the
first moments (``opt/mu``, the clipped gradients' running mean) are
also held to atol 1e-8: they carry the gradient check. Sampler blocks,
batches and segment reductions are bitwise.
"""
from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.graphs import generators as j_gen
from repro.graphs import sampler as j_sampler
from repro.graphs import segment_ops as j_sops
from repro.launch import train as j_train
from repro.models import dien as j_dien
from repro.models import dimenet as j_dimenet
from repro.models import gnn as j_gnn
from repro.models import transformer as j_transformer
from repro.train.steps import build_bundle as j_build_bundle
from repro_torch.checkpoint import state_from_tree
from repro_torch.configs import registry as t_registry
from repro_torch.graphs import sampler as t_sampler
from repro_torch.graphs import segment_ops as t_sops
from repro_torch.launch import train as t_train
from repro_torch.models import dien as t_dien
from repro_torch.models import dimenet as t_dimenet
from repro_torch.models import gnn as t_gnn
from repro_torch.models import transformer as t_transformer
from repro_torch.models.layers import dotted, params_tree
from repro_torch.train.steps import build_bundle as t_build_bundle
from repro_torch.train.steps import _gnn_model
from repro_torch.tree import flatten_with_paths

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gcn-cora", "graphsage-reddit", "egnn", "dimenet")
CELLS = [(a, s) for a in ARCHS for s in ("full_graph_sm", "molecule")]
STEPS = 3
RTOL, ATOL, MU_ATOL = 1e-5, 1e-6, 1e-8


def _flat(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_with_paths(tree)}


@pytest.fixture(scope="module")
def repro_cells():
    """``(arch, shape) -> repro's run``: its initial state and batch (as
    numpy), and per step the loss, gradient norm and state after it."""
    cache = {}

    def get(arch, shape):
        if (arch, shape) not in cache:
            spec = j_train.smoke_spec(j_registry.get_spec(arch))
            mesh = jax.make_mesh((1, 1), ("data", "model"))
            with mesh:
                bundle = j_build_bundle(spec, shape, mesh)
                step = bundle.jitted()
                state = j_train.init_state(spec, mesh, bundle)
                batch = j_train.make_batch_fn(spec, shape)(0)
                # repro's molecule batch carries DimeNet's atom_z, which
                # its GNN specs (the jitted step's in_shardings) lack
                fed = {k: batch[k] for k in spec.input_specs(shape)}
                state0 = jax.tree.map(np.asarray, state)
                runs = []
                for _ in range(STEPS):
                    state, m = step(state, fed)
                    runs.append((float(m["loss"]), float(m["gnorm"]),
                                 jax.tree.map(np.asarray, state)))
            cache[arch, shape] = (state0, batch, runs)
        return cache[arch, shape]
    return get


@pytest.mark.parametrize("arch,shape", CELLS)
def test_train_steps_match_repro(repro_cells, arch, shape):
    state0, _, runs = repro_cells(arch, shape)
    spec = t_train.smoke_spec(t_registry.get_spec(arch))
    bundle = t_build_bundle(spec, shape, "cpu")
    batch = t_train.make_batch_fn(spec, shape, device="cpu")(0)
    state = state_from_tree(state0, "cpu")
    for loss, gnorm, jstate in runs:
        state, m = bundle.fn(state, batch)
        np.testing.assert_allclose(float(m["loss"]), loss, rtol=RTOL)
        np.testing.assert_allclose(float(m["gnorm"]), gnorm, rtol=RTOL)
        a, b = _flat(jstate), _flat(state)
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
            np.testing.assert_allclose(
                b[k], a[k], rtol=RTOL,
                atol=MU_ATOL if k.startswith("opt/mu/") else ATOL, err_msg=k)
    assert int(state["step"]) == STEPS


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_batches_bitwise(repro_cells, arch, shape):
    _, jbatch, _ = repro_cells(arch, shape)
    spec = t_train.smoke_spec(t_registry.get_spec(arch))
    tbatch = t_train.make_batch_fn(spec, shape, device="cpu")(0)
    assert jbatch.keys() == tbatch.keys()
    for k in jbatch:
        assert str(tbatch[k].dtype).endswith(str(jbatch[k].dtype)), k
        np.testing.assert_array_equal(tbatch[k].numpy(), jbatch[k],
                                      err_msg=k)
    specs = spec.input_specs(shape)
    for k, (shp, dtype) in specs.items():
        assert tuple(tbatch[k].shape) == shp and tbatch[k].dtype == dtype


@pytest.mark.parametrize("arch,shape", [("gcn-cora", "full_graph_sm"),
                                        ("egnn", "full_graph_sm"),
                                        ("egnn", "molecule"),
                                        ("dimenet", "full_graph_sm"),
                                        ("dimenet", "molecule")])
def test_full_size_batches_bitwise(arch, shape):
    """The chip phases' batches (published configs, the launcher's
    shapes): 3,072 rows and 21,504 edges; 4,096 rows and 16,384 edges;
    DimeNet's 86,016 and 65,536 triplet slots."""
    jspec = j_registry.get_spec(arch)
    jbatch = j_train.make_batch_fn(jspec, shape)(0)
    tbatch = t_train.make_batch_fn(t_registry.get_spec(arch), shape,
                                   device="cpu")(0)
    assert jbatch.keys() == tbatch.keys()
    for k in jbatch:
        np.testing.assert_array_equal(tbatch[k].numpy(), jbatch[k],
                                      err_msg=k)


@pytest.mark.parametrize("t_cap", [0, 64, 4096])
def test_build_triplets_bitwise(t_cap):
    """DimeNet's host helper on a random multigraph (repeated edges,
    both directions): cut below the triplet count, padded above it."""
    r = np.random.default_rng(t_cap)
    src = r.integers(0, 40, 300).astype(np.int32)
    dst = r.integers(0, 40, 300).astype(np.int32)
    a = j_dimenet.build_triplets(src, dst, 40, t_cap)
    b = t_dimenet.build_triplets(src, dst, 40, t_cap)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.int32 and x.shape == (t_cap,)
        np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_repro(arch):
    jspec, tspec = j_registry.get_spec(arch), t_registry.get_spec(arch)
    assert list(jspec.shapes) == list(tspec.shapes)
    for shape in jspec.shapes:
        a, b = jspec.input_specs(shape), tspec.input_specs(shape)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape, (shape, k)
            assert str(b[k].dtype) == f"torch.{a[k].dtype}", (shape, k)


def test_minibatch_lg_batch_fails_as_in_repro():
    """``repro``'s launcher cannot build ``minibatch_lg``: 232,966 rows
    do not fit r512(169,985) = 170,496 (``gnn_full_batch``'s caps)."""
    with pytest.raises(AssertionError):
        j_train.make_batch_fn(j_registry.get_spec("graphsage-reddit"),
                              "minibatch_lg")
    with pytest.raises(ValueError, match="does not fit"):
        t_train.make_batch_fn(t_registry.get_spec("graphsage-reddit"),
                              "minibatch_lg", device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_names_are_repro_tree_paths(arch):
    """A port model's parameters are ``repro``'s tree, path for path and
    shape for shape, at the published config; drawn at ``repro``'s
    N(0, 1)/sqrt(fan_in) scale, zero biases."""
    cfg = t_registry.get_spec(arch).model_cfg
    jcfg = j_registry.get_spec(arch).model_cfg
    init = {"gcn-cora": j_gnn.init_gcn, "graphsage-reddit": j_gnn.init_sage,
            "egnn": j_gnn.init_egnn,
            "dimenet": j_dimenet.init_dimenet}[arch]
    jtree = jax.eval_shape(lambda k: init(k, jcfg)[0], jax.random.PRNGKey(0))
    model = _gnn_model(cfg, torch.Generator().manual_seed(0))
    ttree = params_tree(model)
    a, b = dict(flatten_with_paths(jtree)), dict(flatten_with_paths(ttree))
    assert a.keys() == b.keys()
    for k in a:
        assert tuple(a[k].shape) == tuple(b[k].shape), k
        if k.endswith("/b"):
            assert not b[k].any(), k
        elif k.endswith("/bilinear"):       # N(0, 1) / d_hidden
            std = float(b[k].std() * b[k].shape[-1])
            assert 0.9 < std < 1.1, (k, std)
        elif b[k].numel() > 1000:
            std = float(b[k].std() * np.sqrt(b[k].shape[0]))
            assert 0.9 < std < 1.1, (k, std)
    assert set(dotted(ttree)) == {n for n, _ in model.named_parameters()}


def _repro_tree_paths(arch):
    """``repro``'s parameter tree at the published config: path ->
    shape (abstract: DIEN's 2^26-row table is never drawn)."""
    cfg = j_registry.get_spec(arch).model_cfg
    init = {"dimenet": j_dimenet.init_dimenet, "dien": j_dien.init_dien}[arch]
    tree = jax.eval_shape(lambda k: init(k, cfg)[0], jax.random.PRNGKey(0))
    return {k: tuple(v.shape) for k, v in flatten_with_paths(tree)}


def test_unported_archs_raise_naming_their_slice():
    """Every arch resolves now (``islabel`` was the last, with the data,
    distribution and launcher slice; an unknown id still raises), and
    ``dimenet``, ``dien`` and the five LMs' parameters are ``repro``'s
    tree, path for path and shape for shape, at the published configs."""
    for arch in ("islabel",):
        got, want = t_registry.get_spec(arch), j_registry.get_spec(arch)
        assert (got.family, tuple(got.shapes)) == (want.family,
                                                   tuple(want.shapes))
    with pytest.raises(KeyError, match="unknown arch"):
        t_registry.get_spec("no-such-arch")
    for arch, model in (("dimenet", t_dimenet.DimeNet),
                        ("dien", t_dien.DIEN)):
        spec = t_registry.get_spec(arch)
        with torch.device("meta"):
            m = model(spec.model_cfg)
        got = {n.replace(".", "/"): tuple(p.shape)
               for n, p in m.named_parameters()}
        assert got == _repro_tree_paths(arch), arch
    for arch in ("qwen2-moe-a2.7b", "kimi-k2-1t-a32b", "granite-8b",
                 "yi-34b", "qwen2-72b"):
        cfg = t_registry.get_spec(arch).model_cfg
        got = {k: tuple(v.shape) for k, v in
               flatten_with_paths(t_transformer.abstract_params(cfg))}
        want = jax.eval_shape(lambda k: j_transformer.init_lm(
            k, j_registry.get_spec(arch).model_cfg)[0],
            jax.random.PRNGKey(0))
        assert got == {k: tuple(v.shape)
                       for k, v in flatten_with_paths(want)}, arch
    assert t_registry.ASSIGNED == ["qwen2-moe-a2.7b", "kimi-k2-1t-a32b",
                                 "granite-8b", "yi-34b", "qwen2-72b",
                                 "dimenet", "graphsage-reddit", "gcn-cora",
                                 "egnn", "dien"]


# ------------------------------------------------------ segment reductions
@pytest.mark.parametrize("op", ["segment_sum", "segment_mean",
                                "segment_max", "segment_min"])
def test_segment_ops_on_messages_bitwise(op):
    """``[E, d]`` messages, ids with empty segments and the pad row."""
    r = np.random.default_rng(0)
    data = r.standard_normal((5000, 16)).astype(np.float32)
    ids = r.integers(0, 301, 5000).astype(np.int32)
    a = np.asarray(getattr(j_sops, op)(jnp.asarray(data), jnp.asarray(ids),
                                       305))
    b = getattr(t_sops, op)(torch.from_numpy(data), torch.from_numpy(ids),
                            305).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("op", ["segment_sum", "segment_mean"])
def test_segment_gradients_bitwise(op):
    r = np.random.default_rng(1)
    data = r.standard_normal((2000, 8)).astype(np.float32)
    ids = r.integers(0, 120, 2000).astype(np.int32)
    w = r.standard_normal((128, 8)).astype(np.float32)
    ga = jax.grad(lambda x: jnp.sum(getattr(j_sops, op)(
        x, jnp.asarray(ids), 128) * w))(jnp.asarray(data))
    x = torch.from_numpy(data).requires_grad_()
    (getattr(t_sops, op)(x, torch.from_numpy(ids), 128)
     * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(ga))


# ----------------------------------------------------------------- sampler
def _blocks(mod, fanouts):
    n, src, dst, _ = j_gen.er_graph(300, 5.0, seed=3)
    csr = mod.HostCSR.from_coo(n, src, dst)
    rng = np.random.default_rng(0)
    seeds = rng.integers(0, n, 32).astype(np.int32)
    return n, rng, mod.sample_blocks(csr, seeds, fanouts, rng)


@pytest.mark.parametrize("fanouts", [[3, 2], [5, 4]])
def test_sample_blocks_bitwise(fanouts):
    _, _, a = _blocks(j_sampler, fanouts)
    _, _, b = _blocks(t_sampler, fanouts)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        for f in ("src_ids", "dst_ids", "edge_src", "edge_dst"):
            assert getattr(x, f).dtype == getattr(y, f).dtype
            np.testing.assert_array_equal(getattr(y, f), getattr(x, f))
        assert (x.n_src_cap, x.n_dst_cap) == (y.n_src_cap, y.n_dst_cap)


def test_sage_forward_blocks_matches_repro():
    """``test_arch_smoke.py``'s minibatch case: the port's SAGE with
    ``repro``'s parameters carried across (a rename by name) on the
    same blocks."""
    n, rng, blocks = _blocks(t_sampler, [3, 2])
    cfg = j_gnn.SAGEConfig("s", 2, 16, 8, 4, fanouts=(3, 2))
    jparams = j_gnn.init_sage(jax.random.PRNGKey(0), cfg)[0]
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    outer = blocks[0].src_ids
    x = np.zeros((len(outer), 8), np.float32)
    x[outer >= 0] = feats[outer[outer >= 0]]
    blk = []
    for b in blocks:
        lut = {int(g): i for i, g in enumerate(b.src_ids) if g >= 0}
        blk.append({"edge_src": b.edge_src, "edge_dst": b.edge_dst,
                    "map_dst": np.asarray([lut.get(int(g), b.n_src_cap)
                                           for g in b.dst_ids], np.int32),
                    "n_dst": b.n_dst_cap})
    want = np.asarray(j_gnn.sage_forward_blocks(
        jparams, cfg, jnp.asarray(x),
        [{k: (jnp.asarray(v) if k != "n_dst" else v) for k, v in d.items()}
         for d in blk]))
    model = t_gnn.SAGE(t_gnn.SAGEConfig("s", 2, 16, 8, 4, fanouts=(3, 2)))
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           dotted(jax.tree.map(np.asarray, jparams)).items()})
    with torch.no_grad():
        got = model.forward_blocks(
            torch.from_numpy(x),
            [{k: (torch.from_numpy(v) if k != "n_dst" else v)
              for k, v in d.items()} for d in blk]).numpy()
    assert got.shape == (32, 4)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- launcher
def test_launcher_on_the_cpu_then_resume(tmp_path):
    """``launch/train.py --smoke --device cpu`` for 12 steps, then
    ``--resume`` to 16 from the step-12 checkpoint."""
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path), "TMPDIR": str(tmp_path)}
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "gcn-cora", "--smoke", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ckpt")]
    first = subprocess.run(base + ["--steps", "12"], capture_output=True,
                           text=True, env=env, timeout=120)
    assert first.returncode == 0, first.stdout + first.stderr
    assert "12 steps" in first.stdout and "step 12: loss" in first.stdout
    second = subprocess.run(base + ["--steps", "16", "--resume"],
                            capture_output=True, text=True, env=env,
                            timeout=120)
    assert second.returncode == 0, second.stdout + second.stderr
    assert "resumed at step 12" in second.stdout
    assert "step 13: loss" in second.stdout and "step 16: loss" in \
        second.stdout
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir())[-1] == \
        "step_000000016"
