"""Endpoint ids outside [0, n] in the PyTorch port, against ``repro``.

``repro`` reads label rows with jnp's gather rule: a negative id counts
from the end of the [n+1, L] planes, then ids are clamped to [0, n].
The port maps every row read the same way (``core/labels.py:
row_index``; the CUDA label kernels repeat it). For endpoint ids n,
n+3, -1, -2 and -(n+5), on either side and both, ``query``,
``query_mu_only`` and ``shortest_paths`` equal ``repro``'s on an fp32
and a compressed index. Tolerance: bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.graphs import generators as gen
from repro_torch.core import ISLabelIndex
from repro_torch.core.labels import row_index


@pytest.mark.parametrize("rows", [1, 7, 201])
def test_row_index_is_jnp_gather(rows):
    ids = np.array([0, 1, rows - 1, rows, rows + 3, -1, -2, -rows,
                    -(rows + 4), 2 ** 31 - 1, -2 ** 31], np.int64)
    want = np.asarray(jnp.arange(rows)[jnp.asarray(ids.astype(np.int32))])
    idx = row_index(torch.from_numpy(ids.astype(np.int32)), rows)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(torch.arange(rows)[idx].numpy(), want)


@pytest.fixture(scope="module", params=["fp32", "compressed"])
def pair(request, tmp_path_factory):
    n, src, dst, w = gen.er_graph(260, 3.0, seed=11)
    j_idx = JIndex.build(n, src, dst, w, JConfig(
        l_cap=128, label_chunk=64, label_dtype=request.param))
    path = tmp_path_factory.mktemp(request.param)
    j_idx.save(path)
    t_idx = ISLabelIndex.load(path, device="cpu")
    assert t_idx.engine.codec == ("none" if request.param == "fp32"
                                  else "delta16")
    odd = np.array([n, n + 3, -1, -2, -(n + 5)])
    real = np.array([0, 5, 17, n - 1, 100])
    s = np.concatenate([odd, real, odd]).astype(np.int32)
    t = np.concatenate([real, odd, odd[::-1]]).astype(np.int32)
    return j_idx, t_idx, s, t


def test_query_and_mu_only(pair):
    j_idx, t_idx, s, t = pair
    want = np.asarray(j_idx.query(s, t))
    assert np.isfinite(want).any() and np.isinf(want).any()
    for backend in ("cuda", "reference"):
        np.testing.assert_array_equal(
            t_idx.engine.query(s, t, backend=backend).numpy(), want)
        np.testing.assert_array_equal(
            t_idx.engine.query_mu_only(s, t, backend=backend).numpy(),
            np.asarray(j_idx.engine.query_mu_only(s, t)))


@pytest.mark.parametrize("backend", ["cuda", "reference"])
def test_shortest_paths(pair, backend):
    j_idx, t_idx, s, t = pair
    d_j, p_j, ok_j = j_idx.shortest_paths(s, t, hop_cap=16)
    d_t, p_t, ok_t = t_idx.shortest_paths(s, t, hop_cap=16, backend=backend)
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    np.testing.assert_array_equal(ok_t, np.asarray(ok_j))
    assert p_t == p_j
