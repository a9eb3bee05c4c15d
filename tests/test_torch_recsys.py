"""DIEN and the embedding tables in the PyTorch port against ``repro`` on
the CPU (``models/dien.py``, ``models/embedding.py``, the recsys bundles
of ``train/steps.py`` and the launcher's recsys branches).

``repro``'s jitted DIEN train step fails under a mesh (the gather on the
row-sharded table raises ``ShardingTypeError``), so the anchor is its
eager functions without a mesh: ``dien_forward`` and ``dien_loss`` on
``repro``'s smoke parameters carried across (``state_from_tree``), and
three steps of ``jax.value_and_grad(dien_loss)`` plus ``repro``'s
``make_optimizer("adamw").update``. Logits, auxiliary loss, loss,
gradients and every array of the state agree to rtol 1e-5 and atol 1e-6
(float32: XLA fuses and reorders the sums; the warm-up keeps the first
moments near 1e-8, held to atol 1e-8 as in ``test_torch_train.py``).
``lookup`` and ``embedding_bag`` are bitwise, NaN rows of out-of-range
ids included.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.configs import shapes as j_shapes
from repro.data import synthetic as j_synth
from repro.launch import train as j_train
from repro.models import dien as j_dien
from repro.models import embedding as j_emb
from repro.train.steps import build_bundle as j_build_bundle
from repro.train.steps import make_optimizer as j_make_optimizer
from repro_torch.checkpoint import state_from_tree
from repro_torch.configs import registry as t_registry
from repro_torch.configs import shapes as t_shapes
from repro_torch.launch import train as t_train
from repro_torch.models import dien as t_dien
from repro_torch.models import embedding as t_emb
from repro_torch.models.layers import dotted
from repro_torch.train.steps import build_bundle as t_build_bundle
from repro_torch.tree import flatten_with_paths

RTOL, ATOL, MU_ATOL = 1e-5, 1e-6, 1e-8
STEPS = 3
SERVE_B, N_CAND = 16, 512


def _flat(tree):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten_with_paths(tree)}


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@pytest.fixture(scope="module")
def smoke():
    """``repro``'s smoke spec, parameters (numpy) and the launcher's
    first train batch."""
    spec = j_train.smoke_spec(j_registry.get_spec("dien"))
    params = jax.tree.map(np.asarray, j_dien.init_dien(
        jax.random.PRNGKey(0), spec.model_cfg)[0])
    batch = j_train.make_batch_fn(spec, "train_batch")(0)
    return spec, params, batch


def _port_model(spec_cfg):
    with torch.device("meta"):
        return t_dien.DIEN(spec_cfg)


def test_smoke_spec_and_batches_bitwise(smoke):
    spec, _, jbatch = smoke
    tspec = t_train.smoke_spec(t_registry.get_spec("dien"))
    # repro's config less ``unroll`` (its scans' dry-run probe)
    assert tspec.model_cfg.__dict__ == {
        k: v for k, v in spec.model_cfg.__dict__.items() if k != "unroll"}
    make = t_train.make_batch_fn(tspec, "train_batch", device="cpu")
    for step in (0, 1):
        want = j_train.make_batch_fn(spec, "train_batch")(step)
        got = make(step)
        assert want.keys() == got.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    for k, (shp, dtype) in tspec.input_specs("train_batch").items():
        assert tuple(make(0)[k].shape) == shp and make(0)[k].dtype == dtype


@pytest.mark.parametrize("shape", list(j_shapes.RECSYS_SHAPES))
def test_input_specs_match_repro(shape):
    a = j_registry.get_spec("dien").input_specs(shape)
    b = t_registry.get_spec("dien").input_specs(shape)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].shape == b[k].shape, k
        assert str(b[k].dtype) == f"torch.{a[k].dtype}", k


def test_forward_loss_and_gradients_match_repro(smoke):
    spec, params, batch = smoke
    cfg = spec.model_cfg
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    logit, aux = jax.jit(lambda p: j_dien.dien_forward(p, cfg, jb))(params)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: j_dien.dien_loss(p, cfg, jb)))(params)

    model = _port_model(cfg)
    tp = {k: v.requires_grad_() for k, v in
          dotted(state_from_tree(params, "cpu")).items()}
    tb = _t(batch)
    with torch.no_grad():
        tlogit, taux = t_dien.dien_forward(model, tp, tb)
    np.testing.assert_allclose(tlogit.numpy(), np.asarray(logit), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(aux), rtol=RTOL)
    tloss = t_dien.dien_loss(model, tp, tb)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=RTOL)
    grads = torch.autograd.grad(tloss, list(tp.values()))
    got = {k.replace(".", "/"): g.numpy() for k, g in zip(tp, grads)}
    want = _flat(jax.tree.map(np.asarray, jgrads))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    # the tables' gradients are sparse: only the rows the batch reads
    rows = np.concatenate([batch["hist_items"].ravel(),
                           batch["target_item"]])
    touched = np.flatnonzero(np.abs(got["item/table"]).sum(1))
    assert set(touched) <= set(rows) and len(touched) > 0


def test_train_steps_match_repro_eager(smoke):
    """Three steps of the port's bundle against ``jax.value_and_grad
    (dien_loss)`` and ``repro``'s AdamW update, jitted without a mesh,
    from ``repro``'s initial state and on the launcher's batches."""
    spec, params, _ = smoke
    cfg = spec.model_cfg
    opt = j_make_optimizer(spec.optimizer)

    @jax.jit
    def j_step(state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: j_dien.dien_loss(p, cfg, batch))(state["params"])
        new_p, new_opt, gnorm = opt.update(grads, state["opt"],
                                           state["params"], state["step"])
        return ({"params": new_p, "opt": new_opt, "step": state["step"] + 1},
                {"loss": loss, "gnorm": gnorm})

    jstate = {"params": params, "opt": opt.init(params),
              "step": jnp.zeros((), jnp.int32)}
    tspec = t_train.smoke_spec(t_registry.get_spec("dien"))
    bundle = t_build_bundle(tspec, "train_batch", "cpu")
    tstate = state_from_tree(jax.tree.map(np.asarray, jstate), "cpu")
    jmake = j_train.make_batch_fn(spec, "train_batch")
    tmake = t_train.make_batch_fn(tspec, "train_batch", device="cpu")
    for step in range(STEPS):
        jstate, jm = j_step(jstate, jmake(step))
        tstate, tm = bundle.fn(tstate, tmake(step))
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=RTOL)
        np.testing.assert_allclose(float(tm["gnorm"]), float(jm["gnorm"]),
                                   rtol=RTOL)
        a, b = _flat(jax.tree.map(np.asarray, jstate)), _flat(tstate)
        assert a.keys() == b.keys()
        for k in a:
            assert (a[k].dtype, a[k].shape) == (b[k].dtype, b[k].shape), k
            np.testing.assert_allclose(
                b[k], a[k], rtol=RTOL,
                atol=MU_ATOL if k.startswith("opt/mu/") else ATOL, err_msg=k)
    assert int(tstate["step"]) == STEPS


def _serve_specs(mod_shapes, registry, smoke_spec):
    spec = smoke_spec(registry.get_spec("dien"))
    return dataclasses.replace(spec, shapes={
        "serve_p99": mod_shapes.RecShape("serve_p99", "serve", SERVE_B),
        "retrieval_cand": mod_shapes.RecShape("retrieval_cand", "retrieval",
                                              1, n_candidates=N_CAND)})


@pytest.mark.parametrize("shape", ["serve_p99", "retrieval_cand"])
def test_serve_and_retrieval_bundles_match_repro(smoke, shape):
    """``repro``'s serve (``sigmoid(logit)``) and retrieval bundles,
    called eagerly, against the port's on the same parameters."""
    _, params, _ = smoke
    jspec = _serve_specs(j_shapes, j_registry, j_train.smoke_spec)
    tspec = _serve_specs(t_shapes, t_registry, t_train.smoke_spec)
    cfg = jspec.model_cfg
    b = SERVE_B if shape == "serve_p99" else 1
    batch = j_synth.dien_batch(0, 5, b, cfg.seq_len, cfg.n_items,
                               cfg.n_cats, cfg.n_users)
    del batch["label"]
    if shape == "retrieval_cand":
        batch["cand_items"] = np.random.default_rng(3).integers(
            0, cfg.n_items, N_CAND).astype(np.int32)
    jfn = j_build_bundle(jspec, shape, jax.make_mesh((1, 1),
                                                     ("data", "model"))).fn
    want = np.asarray(jfn(params, {k: jnp.asarray(v)
                                   for k, v in batch.items()}))
    bundle = t_build_bundle(tspec, shape, "cpu")
    assert bundle.optimizer is None
    got = bundle.fn(state_from_tree(params, "cpu"), _t(batch)).numpy()
    assert got.shape == want.shape == ((SERVE_B,) if shape == "serve_p99"
                                       else (1, N_CAND))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# -------------------------------------------------------- embedding tables
N_ROWS = 7
ODD_IDS = [0, 3, N_ROWS, N_ROWS + 3, -1, -N_ROWS, -N_ROWS - 1, 6, 2, -2]


def test_lookup_odd_ids_bitwise_with_gradients():
    """Ids n, n+3 and -n-1 read NaN rows, -1 and -n wrap (``jnp.take``);
    the gradient of an out-of-range id is dropped."""
    r = np.random.default_rng(0)
    tab = r.standard_normal((N_ROWS, 5)).astype(np.float32)
    ids = np.asarray(ODD_IDS, np.int32).reshape(2, 5)
    w = r.standard_normal((2, 5, 5)).astype(np.float32)
    want = np.asarray(j_emb.lookup(jnp.asarray(tab), jnp.asarray(ids)))
    x = torch.from_numpy(tab).requires_grad_()
    got = t_emb.lookup(x, torch.from_numpy(ids))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    assert np.isnan(want[0, 2:4]).all() and np.isnan(want[1, 1]).all()
    jg = jax.grad(lambda t: jnp.sum(jnp.nan_to_num(
        j_emb.lookup(t, jnp.asarray(ids))) * w))(jnp.asarray(tab))
    (torch.nan_to_num(got) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_odd_ids_bitwise(mode):
    r = np.random.default_rng(1)
    tab = r.standard_normal((N_ROWS, 4)).astype(np.float32)
    ids = np.asarray(ODD_IDS, np.int32)
    seg = np.asarray([0, 0, 1, 2, 2, 3, 4, 4, 5, 6], np.int32)  # 6: pad
    want = np.asarray(j_emb.embedding_bag(
        jnp.asarray(tab), jnp.asarray(ids), jnp.asarray(seg), 6, mode))
    got = t_emb.embedding_bag(torch.from_numpy(tab), torch.from_numpy(ids),
                              torch.from_numpy(seg), 6, mode).numpy()
    assert got.shape == (6, 4)
    np.testing.assert_array_equal(got, want)


def test_tables_drawn_at_repro_scale():
    """``init_table``: N(0, 1) * 0.01 on the generator's device."""
    g = torch.Generator("cpu").manual_seed(0)
    t = t_emb.init_table(g, 4096, 18)["table"]
    assert t.shape == (4096, 18) and t.device.type == "cpu"
    assert 0.0095 < float(t.std()) < 0.0105
