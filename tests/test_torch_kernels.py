"""Kernel parity of the PyTorch port: each kernel's plain PyTorch
version (what the ``cuda`` backend runs on a CPU tensor) against
``repro``'s wrapper running the Pallas program (``backend="interpret"``)
and the jnp reference, on the same numpy inputs. Every kernel takes a
min over the same fp32 sums, so the tolerance is bitwise.

The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds each against its plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.graphs import segment_ops as jsops
from repro.graphs import csr as jcsr
from repro.kernels.label_intersect.ops import label_intersect as j_intersect
from repro.kernels.minplus_matmul.ops import minplus_matmul as j_minplus
from repro.kernels.spmv_relax.kernel import fused_relax_kernel as j_fused
from repro.kernels.spmv_relax.ops import coo_to_ell as j_coo_to_ell
from repro.kernels.spmv_relax.ops import spmv_relax as j_spmv
from repro_torch.graphs import csr as tcsr
from repro_torch.graphs import segment_ops as tsops
from repro_torch.kernels.label_intersect.ops import label_intersect
from repro_torch.kernels.minplus_matmul.ops import minplus_matmul
from repro_torch.kernels.spmv_relax.ops import (coo_to_ell, fused_relax,
                                                spmv_relax)

J_BACKENDS = ("interpret", "reference")


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _label_rows(rng, q, l, n_sent, fill):
    """Sorted unique id rows padded with n_sent; row fill fractions in
    ``fill`` (0 = empty row)."""
    ids = np.full((q, l), n_sent, np.int32)
    d = np.full((q, l), np.inf, np.float32)
    for i in range(q):
        k = int(fill[i % len(fill)] * l)
        ids[i, :k] = np.sort(rng.choice(n_sent, k, replace=False))
        d[i, :k] = rng.integers(0, 9, k)
    return ids, d


# ------------------------------------------------------- label intersect
@pytest.mark.parametrize("q,l,n_sent", [(1, 8, 50), (13, 100, 300),
                                        (37, 129, 1000)])
def test_label_intersect_plain_matches_repro(q, l, n_sent):
    """Q and L off the block multiples (bq=8, 128); empty and all-pad
    rows; the 'cuda' backend on CPU tensors runs the plain version."""
    rng = np.random.default_rng(q)
    ids_s, d_s = _label_rows(rng, q, l, n_sent, (0.0, 0.3, 1.0, 0.6))
    ids_t, d_t = _label_rows(rng, q, l, n_sent, (0.5, 0.0, 0.9, 1.0))
    args = [torch.from_numpy(x) for x in (ids_s, d_s, ids_t, d_t)]
    got = {be: label_intersect(*args, n_sent, backend=be)
           for be in ("cuda", "reference")}
    for jb in J_BACKENDS:
        want = j_intersect(jnp.asarray(ids_s), jnp.asarray(d_s),
                           jnp.asarray(ids_t), jnp.asarray(d_t), n_sent,
                           backend=jb)
        for g in got.values():
            _same(g, want)
    assert np.isinf(got["cuda"].numpy()[0])     # empty s row: no match


# ------------------------------------------------------------ ELL relax
def _ell_case(seed, v, e, q):
    r = np.random.default_rng(seed)
    src = r.integers(0, v, e).astype(np.int32)
    dst = r.integers(0, v // 2, e).astype(np.int32)   # rows >= v/2: no edges
    w = r.integers(1, 5, e).astype(np.float32)
    dist = np.full((q, v), np.inf, np.float32)
    dist[np.arange(q), r.integers(0, v, q)] = 0.0
    dist[r.random((q, v)) < 0.05] = 3.0
    return src, dst, w, dist


def test_coo_to_ell_matches_repro():
    src, dst, w, _ = _ell_case(0, 97, 400, 1)
    ids, ws = coo_to_ell(97, src, dst, w)
    j_ids, j_ws = j_coo_to_ell(97, src, dst, w)
    _same(torch.from_numpy(ids), j_ids)
    _same(torch.from_numpy(ws), j_ws)


@pytest.mark.parametrize("v,e,q", [(97, 400, 13), (256, 900, 16)])
def test_spmv_relax_plain_matches_repro(v, e, q):
    """One round; ELL rows that are all padding (half the vertices have
    no in-edges); Q and V off the block multiples."""
    src, dst, w, dist = _ell_case(v, v, e, q)
    ids, ws = coo_to_ell(v, src, dst, w)
    t_args = [torch.from_numpy(x) for x in (dist, ids, ws)]
    got = [spmv_relax(*t_args, backend=be) for be in ("cuda", "reference")]
    for jb in J_BACKENDS:
        want = j_spmv(jnp.asarray(dist), jnp.asarray(ids), jnp.asarray(ws),
                      backend=jb)
        for g in got:
            _same(g, want)


@pytest.mark.parametrize("max_rounds", [0, 2, 1000])
def test_fused_relax_plain_matches_repro(max_rounds):
    """Fixed point and per-block round counts of the fused kernel's plain
    version equal the Pallas program's; includes an all-inf block and a
    round cap that stops blocks early."""
    v, q = 128, 24
    src, dst, w, dist = _ell_case(5, v, 600, q)
    dist[16:24] = np.inf                       # a block with no seeds
    ids, ws = coo_to_ell(v, src, dst, w)
    d, rounds = fused_relax(*(torch.from_numpy(x) for x in (dist, ids, ws)),
                            max_rounds=max_rounds)
    j_d, j_rounds = j_fused(jnp.asarray(dist), jnp.asarray(ids),
                            jnp.asarray(ws), max_rounds=max_rounds,
                            interpret=True)
    _same(d, j_d)
    _same(rounds, j_rounds)
    if max_rounds:
        assert rounds.numpy()[2] == 1          # the empty block: one round


# ----------------------------------------------------------- min-plus
@pytest.mark.parametrize("m,k,n", [(1, 1, 1), (37, 100, 70), (130, 260, 5)])
def test_minplus_plain_matches_repro(m, k, n):
    rng = np.random.default_rng(m + k + n)
    a = rng.integers(0, 20, (m, k)).astype(np.float32)
    b = rng.integers(0, 20, (k, n)).astype(np.float32)
    a[rng.random(a.shape) < 0.3] = np.inf
    b[rng.random(b.shape) < 0.3] = np.inf
    if m > 64:
        a[:64] = np.inf                        # an all-inf block of rows
    got = [minplus_matmul(torch.from_numpy(a), torch.from_numpy(b),
                          backend=be) for be in ("cuda", "reference")]
    for jb in J_BACKENDS:
        want = j_minplus(jnp.asarray(a), jnp.asarray(b), backend=jb)
        for g in got:
            _same(g, want)


# -------------------------------------- construction substrate parity
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_segment_ops_match_jax(dtype):
    """Empty segments fill as JAX does (+inf / INT32_MAX for min, the
    lowest value for max); ties in argmin_take go to the largest
    payload."""
    rng = np.random.default_rng(1)
    data = rng.integers(0, 4, 50).astype(dtype)
    seg = rng.integers(0, 12, 50).astype(np.int32)
    seg[seg == 7] = 6                              # segment 7 stays empty
    pay = rng.integers(0, 100, 50).astype(np.int32)
    td, ts, tp = (torch.from_numpy(x) for x in (data, seg, pay))
    for tf, jf in ((tsops.segment_sum, jsops.segment_sum),
                   (tsops.segment_min, jsops.segment_min),
                   (tsops.segment_max, jsops.segment_max)):
        _same(tf(td, ts, 13), jf(jnp.asarray(data), jnp.asarray(seg), 13))
    _same(tsops.segment_argmin_take(td, tp, ts, 13),
          jsops.segment_argmin_take(jnp.asarray(data), jnp.asarray(pay),
                                    jnp.asarray(seg), 13))
    mask = torch.from_numpy(data > 1)
    _same(tsops.count_per_segment(ts, 13, mask=mask),
          jsops.count_per_segment(jnp.asarray(seg), 13,
                                  mask=jnp.asarray(data > 1)))


def test_csr_neighbor_matrix_and_dedup_match_repro():
    """Parking-slot scatters and the lexsort-as-one-key dedup reproduce
    ``repro.graphs.csr`` bitwise, duplicates and ties included."""
    rng = np.random.default_rng(2)
    n, e = 40, 300
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.integers(1, 4, e).astype(np.float32)
    via = rng.integers(-1, n, e).astype(np.int32)
    tg = tcsr.from_host_edges(src, dst, w, n, e + 37, via=via)
    jg = jcsr.from_host_edges(src, dst, w, n, e + 37, via=via)
    for a, b in zip(tcsr.neighbor_matrix(tg, 6), jcsr.neighbor_matrix(jg, 6)):
        _same(a, b)
    out_cap = 200                                  # fewer than the pairs
    got = tcsr.dedup_min_edges(tg.src, tg.dst, tg.weight, tg.via, n, out_cap)
    want = jcsr.dedup_min_edges(jg.src, jg.dst, jg.weight, jg.via, n, out_cap)
    for a, b in zip(got, want):
        _same(a, b)
