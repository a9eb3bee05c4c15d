"""The ``islabel`` arch of the PyTorch port against ``repro`` on the CPU:
the query bundle and one peel level (``train/steps.build_islabel_bundle``)
bitwise against ``repro``'s ``build_islabel_bundle`` jitted without
shardings, and the registry's cells.

The query inputs are a real index's: the port builds
``er_graph(300, 3.0, seed=1)`` at ``l_cap=128`` on the CPU; its label
planes are padded to ``r512(n + 1)`` rows (ids n, distances +inf), and
the core edges are written in core positions. Both packages get the
same arrays. The query runs at ``relax_chunks`` 0 and 4 (the core's
edge count is not a multiple of 4, so ``repro`` drops the remainder
and the port mirrors it), with labels stored in bf16 (``lbl_dtype``),
and with endpoint ids outside [0, rows) (jnp's gather rule). At 0 chunks
and enough rounds the answers also equal ``idx.query``. The peel level
takes ``repro``'s permutation for its key (the parity contract).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs import registry as j_registry
from repro.configs.shapes import IndexShape as JShape
from repro.train.steps import build_bundle as j_build_bundle
from repro_torch.configs import registry as t_registry
from repro_torch.configs.base import r512
from repro_torch.configs.shapes import IndexShape as TShape
from repro_torch.core.config import IndexConfig
from repro_torch.core.index import ISLabelIndex
from repro_torch.graphs import generators as tgen
from repro_torch.train.steps import build_bundle as t_build_bundle

Q = 64


@pytest.fixture(scope="module")
def index_batch():
    """(index, shape fields, numpy batch) of the module docstring."""
    n, src, dst, w = tgen.er_graph(300, 3.0, seed=1)
    idx = ISLabelIndex.build(n, src, dst, w,
                             IndexConfig(l_cap=128, label_chunk=64),
                             device="cpu")
    rows = r512(n + 1)
    l_cap = idx.lbl_ids.shape[1]
    ids = np.full((rows, l_cap), n, np.int32)
    dd = np.full((rows, l_cap), np.inf, np.float32)
    ids[:n + 1] = idx.lbl_ids.numpy()
    dd[:n + 1] = idx.lbl_d.numpy()
    n_core = len(idx.core_ids)
    cpos = np.full(rows, n_core, np.int32)
    cpos[:n + 1] = idx.core_pos_host
    r = np.random.default_rng(0)
    batch = {"lbl_ids": ids, "lbl_d": dd, "core_pos": cpos,
             "ce_src": cpos[idx.core_src].astype(np.int32),
             "ce_dst": cpos[idx.core_dst].astype(np.int32),
             "ce_w": np.asarray(idx.core_w, np.float32),
             "s": r.integers(0, n, Q).astype(np.int32),
             "t": r.integers(0, n, Q).astype(np.int32)}
    assert len(batch["ce_src"]) % 4, "the chunked case needs a remainder"
    fields = dict(n_vertices=n, l_cap=l_cap, n_core=n_core,
                  core_edges=len(batch["ce_src"]), q_batch=Q)
    return idx, fields, batch


def _specs(fields):
    out = []
    for reg, shape in ((j_registry, JShape), (t_registry, TShape)):
        spec = reg.get_spec("islabel")
        out.append(dataclasses.replace(
            spec, shapes={"cell": shape("cell", "query", **fields)}))
    return out


def _both(fields, batch, ov):
    jspec, tspec = _specs(fields)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    jb = dict(batch)
    tb = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in batch.items()}
    if ov.get("lbl_dtype") == "bfloat16":
        jb["lbl_d"] = batch["lbl_d"].astype(ml_dtypes.bfloat16)
        tb["lbl_d"] = tb["lbl_d"].to(torch.bfloat16)
    want = np.asarray(jax.jit(j_build_bundle(jspec, "cell", mesh, ov).fn)(
        {k: jnp.asarray(v) for k, v in jb.items()}))
    bundle = t_build_bundle(tspec, "cell", "cpu", ov)
    got = bundle.fn(tb).numpy()
    return got, want


@pytest.mark.parametrize("ov", [
    {"relax_rounds": 12}, {"relax_chunks": 4}, {"relax_rounds": 3},
    {"lbl_dtype": "bfloat16", "relax_chunks": 4}],
    ids=["r12", "chunks4", "r3", "bf16-chunks4"])
def test_query_bundle_bitwise(index_batch, ov):
    idx, fields, batch = index_batch
    got, want = _both(fields, batch, ov)
    np.testing.assert_array_equal(got, want)
    if ov == {"relax_rounds": 12}:
        # past the route's rounds the fixed rounds reach the answers
        np.testing.assert_array_equal(got, idx.query(
            torch.from_numpy(batch["s"]), torch.from_numpy(batch["t"])
        ).numpy())


def test_query_bundle_out_of_range_endpoints(index_batch):
    """Endpoint ids n, n+3, rows-1, rows, rows+5, -1, -2, -rows and
    -(rows+5) read rows as jnp does."""
    idx, fields, batch = index_batch
    n, rows = fields["n_vertices"], batch["lbl_ids"].shape[0]
    odd = np.array([n, n + 3, rows - 1, rows, rows + 5, -1, -2, -rows,
                    -(rows + 5)], np.int32)
    batch = dict(batch)
    batch["s"] = batch["s"].copy()
    batch["t"] = batch["t"].copy()
    batch["s"][:len(odd)] = odd
    batch["t"][len(odd):2 * len(odd)] = odd
    batch["t"][2 * len(odd):3 * len(odd)] = odd[::-1]
    batch["s"][2 * len(odd):3 * len(odd)] = odd
    got, want = _both(fields, batch, {"relax_rounds": 6})
    np.testing.assert_array_equal(got, want)


def test_build_level_bitwise():
    """One peel level on ``er_graph(300)`` with ``repro``'s permutation."""
    n, src, dst, w = tgen.er_graph(300, 3.0, seed=2)
    e_cap = r512(4 * len(src))
    pad = e_cap - len(src)
    batch = {"src": np.concatenate([src, np.full(pad, n)]).astype(np.int32),
             "dst": np.concatenate([dst, np.full(pad, n)]).astype(np.int32),
             "w": np.concatenate([w, np.full(pad, np.inf)]).astype(
                 np.float32),
             "via": np.full(e_cap, -1, np.int32),
             "active": np.ones(n, bool)}
    batch["active"][::17] = False
    fields = dict(n_vertices=n, l_cap=64, n_core=0, core_edges=0,
                  e_cap=e_cap, d_cap=16)
    specs = []
    for reg, shape in ((j_registry, JShape), (t_registry, TShape)):
        spec = reg.get_spec("islabel")
        specs.append(dataclasses.replace(spec, shapes={
            "lvl": shape("lvl", "build_level", **fields)}))
    key = jax.random.key_data(jax.random.PRNGKey(3))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    want = jax.jit(j_build_bundle(specs[0], "lvl", mesh).fn)(
        {k: jnp.asarray(v) for k, v in batch.items()}, key)
    perm = np.asarray(jax.random.permutation(jax.random.wrap_key_data(key),
                                             n))
    got = t_build_bundle(specs[1], "lvl", "cpu").fn(
        {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(perm.copy()))
    assert len(got) == len(want) == 5
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    assert 0 < int(got[4].sum()) < n


@pytest.mark.parametrize("include", [False, True])
def test_all_cells_equal_repro(include):
    assert t_registry.all_cells(include) == j_registry.all_cells(include)
    assert t_registry.ASSIGNED == j_registry.ASSIGNED
    t, j = t_registry.get_spec("islabel"), j_registry.get_spec("islabel")
    for shape in t.shapes:
        got = {k: (v.shape, str(v.dtype).replace("torch.", ""))
               for k, v in t.input_specs(shape).items()}
        want = {k: (tuple(v.shape), str(v.dtype).replace("bool", "bool"))
                for k, v in j.input_specs(shape).items()}
        assert got == want, shape
