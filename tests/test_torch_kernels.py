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
from repro.core.dispatch import CoreRelaxer as JRelaxer
from repro.graphs import generators as jgen
from repro.kernels.spmv_relax.ops import spmv_relax as j_spmv
from repro_torch.graphs import csr as tcsr
from repro_torch.graphs import segment_ops as tsops
from repro_torch.core.labels import LabelRows
from repro_torch.kernels.label_intersect.ops import (label_intersect,
                                                     label_intersect_planes)
from repro_torch.kernels.minplus_matmul.ops import minplus_matmul
from repro_torch.core.dispatch import (CoreRelaxer, relax_csr_rounds,
                                       seed_vertex_major)
from repro_torch.kernels.spmv_relax.kernel import (
    FUSED_VARIANTS, HEAVY_DEGREE, MASK_DTYPE, ROW_TILE, SECTOR_ROWS, SLICE,
    SMEM_BLOCK_BYTES, TILE_SECTORS, VERTEX_BYTES, RelaxCSR, SlicedEdges,
    fused_variant, fused_vmem_bytes, pack_sectors)
from repro_torch.kernels.spmv_relax.ops import (coo_to_csr, coo_to_sliced,
                                                fused_relax, spmv_relax,
                                                stable_argsort)
from repro_torch.kernels.spmv_relax.ref import sector_any, sector_rows

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


# ---------------------------------- label intersect, rows read in place
# real entries of the first rows: empty, and on both sides of the CUDA
# merge's 32-slot chunks
EDGE_COUNTS = (0, 1, 31, 32, 33, 63, 64, 65)


def label_planes(seed, n, l, dup=False):
    """[n+1, L] id-sorted label planes of n vertices (pad id n, pad
    distance +inf): rows 0..7 hold EDGE_COUNTS real entries (cut to L),
    the rest random counts; row n is all pad. With ``dup`` every third
    row draws its ids with repeats; the repeats of an id carry
    non-decreasing distances, so ``repro``'s equality join (every pair)
    and the searchsorted reference (the first match) agree."""
    rng = np.random.default_rng(seed)
    ids = np.full((n + 1, l), n, np.int32)
    d = np.full((n + 1, l), np.inf, np.float32)
    for v in range(n):
        k = min(l, EDGE_COUNTS[v] if v < len(EDGE_COUNTS)
                else int(rng.integers(0, l + 1)))
        row = rng.choice(n, k, replace=dup and v % 3 == 0)
        dist = rng.integers(0, 90, k)
        order = np.lexsort((dist, row))
        ids[v, :k], d[v, :k] = row[order], dist[order]
    return ids, d


def label_endpoints(seed, n, q):
    """int32[q] endpoint pairs: the EDGE_COUNTS rows against each other
    and themselves, repeated endpoints, and the all-pad row n on either
    side and both."""
    rng = np.random.default_rng(seed)
    s = rng.integers(0, n + 1, q).astype(np.int32)
    t = rng.integers(0, n + 1, q).astype(np.int32)
    k = len(EDGE_COUNTS)
    s[:2 * k] = np.tile(np.arange(k), 2)
    t[:2 * k] = np.concatenate([np.arange(k), np.roll(np.arange(k), 1)])
    s[2 * k:2 * k + 4] = s[2 * k + 4]                   # repeated
    s[-3:-1], t[-2:] = n, n
    return s, t


@pytest.mark.parametrize("l,dup", [(45, False), (64, False), (70, True),
                                   (129, True)])
def test_label_intersect_planes_matches_repro(l, dup):
    """The indexed form (endpoint ids into [n+1, L] planes; L off the
    32-slot chunks but for 64) against ``repro``'s intersect of the same
    rows gathered in JAX, bitwise; the 'cuda' backend on CPU tensors
    runs the plain version."""
    n, q = 300, 48
    ids, d = label_planes(l, n, l, dup)
    s, t = label_endpoints(l + 1, n, q)
    planes = LabelRows(torch.from_numpy(ids), None, torch.from_numpy(d))
    got = {be: label_intersect_planes(planes, torch.from_numpy(s),
                                      torch.from_numpy(t), n, backend=be)
           for be in ("cuda", "reference")}
    j_ids, j_d = jnp.asarray(ids), jnp.asarray(d)
    for jb in J_BACKENDS:
        want = torch.from_numpy(np.array(j_intersect(
            j_ids[s], j_d[s], j_ids[t], j_d[t], n, backend=jb)))
        for g in got.values():
            assert torch.equal(g, want)
    mu = got["cuda"]
    assert torch.isinf(mu[torch.from_numpy((s == n) | (t == n))]).all()
    assert torch.isinf(mu[0]) and torch.isfinite(mu).sum() > q // 2


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


def _hub_case(seed, v, e, q, hub_deg):
    """R-MAT-like: one hub whose in-degree (> HEAVY_DEGREE) is far above
    the average, plus random edges."""
    src, dst, w, dist = _ell_case(seed, v, e, q)
    r = np.random.default_rng(seed + 1)
    src = np.concatenate([src, r.integers(0, v, hub_deg).astype(np.int32)])
    dst = np.concatenate([dst, np.full(hub_deg, 3, np.int32)])
    w = np.concatenate([w, r.integers(1, 9, hub_deg).astype(np.float32)])
    return src, dst, w, dist


SPMV_CASES = {"er97": lambda: _ell_case(97, 97, 400, 13),
              "er256": lambda: _ell_case(256, 256, 900, 16),
              "hub": lambda: _hub_case(3, 300, 900, 21, HEAVY_DEGREE + 300)}


def _sliced(v, src, dst, w):
    return SlicedEdges(*(torch.from_numpy(x)
                         for x in coo_to_sliced(v, src, dst, w)))


def _csr(v, src, dst, w):
    indptr, s, ws, order, n_heavy = coo_to_csr(v, src, dst, w)
    return RelaxCSR(*(torch.from_numpy(x) for x in (indptr, s, ws, order)),
                    n_heavy)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_stable_argsort_is_numpys(dtype):
    """The layouts' torch sort gives numpy's stable permutation: ties
    in input order, negative keys (``-indeg``), and no keys."""
    rng = np.random.default_rng(7)
    for a in (rng.integers(-50, 50, 10_000).astype(dtype),
              np.zeros(33, dtype), np.arange(40, 0, -1).astype(dtype),
              np.zeros(0, dtype)):
        got = stable_argsort(a)
        np.testing.assert_array_equal(got, np.argsort(a, kind="stable"))
        assert got.dtype == np.int64


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_coo_to_csr_matches_repro_ell(case):
    """Each destination's CSR in-edges are the same multiset of (src, w)
    as its row of ``repro``'s ELL planes; destinations come by
    in-degree, heaviest first, the hubs counted."""
    src, dst, w, dist = SPMV_CASES[case]()
    v = dist.shape[1]
    indptr, s, ws, order, n_heavy = coo_to_csr(v, src, dst, w)
    j_ids, j_ws = (np.asarray(x) for x in j_coo_to_ell(v, src, dst, w))
    for x in range(v):
        real = np.isfinite(j_ws[x])
        lo, hi = indptr[x], indptr[x + 1]
        assert (sorted(zip(s[lo:hi].tolist(), ws[lo:hi].tolist()))
                == sorted(zip(j_ids[x][real].tolist(),
                              j_ws[x][real].tolist())))
    deg = np.diff(indptr)
    assert sorted(order.tolist()) == list(range(v))
    assert np.all(np.diff(deg[order]) <= 0)
    assert n_heavy == int((deg > HEAVY_DEGREE).sum())
    assert n_heavy == (1 if case == "hub" else 0)


def _all_sectors(n_tiles, v):
    """A sector mask with every bit set (int16 -1 is 0xffff)."""
    return np.full((n_tiles, v), -1, np.int16)


def _round(dist_vm, csr, changed, **kw):
    return spmv_relax(torch.from_numpy(dist_vm), csr,
                      torch.from_numpy(changed), backend="cuda", **kw)


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_spmv_relax_plain_matches_repro(case):
    """One round with every source marked changed, on the vertex-major
    frontier, equals ``repro``'s round on the ELL planes of the same COO
    (transposed); vertices without in-edges, R off the row tile, and a
    hub above the heavy degree. The mask out is the improved set per
    8-row sector of each row tile, the flag its OR."""
    src, dst, w, dist = SPMV_CASES[case]()
    q, v = dist.shape
    csr = _csr(v, src, dst, w)
    dist_vm = np.ascontiguousarray(dist.T)
    n_tiles = -(-q // ROW_TILE)
    out, changed, flag = _round(dist_vm, csr, _all_sectors(n_tiles, v))
    ids, ws = j_coo_to_ell(v, src, dst, w)
    for jb in J_BACKENDS:
        want = j_spmv(jnp.asarray(dist), jnp.asarray(ids), jnp.asarray(ws),
                      backend=jb)
        _same(out.T.contiguous(), want)
    improved = np.asarray(want).T < dist_vm
    _same(changed, np.asarray(sector_any(torch.from_numpy(improved))))
    assert int(flag) == int(improved.any()) == 1
    _same(out, spmv_relax(torch.from_numpy(dist_vm), csr,
                          torch.from_numpy(_all_sectors(n_tiles, v)),
                          backend="reference")[0])


@pytest.mark.parametrize("rows", [48, 264])
def test_spmv_relax_plain_random_mask(rows):
    """Under a random mask the plain version gathers exactly from the
    marked (row tile, source, sector) triples: equal to a numpy loop over
    the edges. R % 8 == 0, off the row tile: inside one tile, or over
    three."""
    src, dst, w, dist = _hub_case(8, 200, 700, 45, HEAVY_DEGREE + 40)
    q, v = dist.shape
    d = np.full((v, rows), np.inf, np.float32)
    d[:, :q] = dist.T
    d[:, rows - q:] = np.minimum(d[:, rows - q:], dist.T[:, ::-1])
    rng = np.random.default_rng(rows)
    bits = rng.random((-(-rows // ROW_TILE), v, TILE_SECTORS)) < 0.4
    mask = pack_sectors(torch.from_numpy(bits))
    out, changed, flag = spmv_relax(
        torch.from_numpy(d), _csr(v, src, dst, w), mask)
    want = d.copy()
    for u, x, wt in zip(src, dst, w):
        for r in range(rows):
            if bits[r // ROW_TILE, u, r % ROW_TILE // SECTOR_ROWS]:
                want[x, r] = min(want[x, r], np.float32(d[u, r] + wt))
    _same(out, want)
    imp = want < d
    _same(changed, np.asarray(sector_any(torch.from_numpy(imp))))
    assert int(flag) == int(imp.any())


def test_spmv_relax_plain_quiet_round_writes_nothing():
    """flag_in = 0: out, changed_out and flag_out keep what they held."""
    src, dst, w, dist = _ell_case(4, 64, 300, 8)
    dist_vm = torch.from_numpy(np.ascontiguousarray(dist.T))
    out = torch.full_like(dist_vm, 7.0)
    chg = torch.zeros((1, 64), dtype=MASK_DTYPE)
    flag = torch.zeros(1, dtype=torch.int32)
    spmv_relax(dist_vm, _csr(64, src, dst, w),
               torch.from_numpy(_all_sectors(1, 64)),
               flag_in=torch.zeros(1, dtype=torch.int32), out=out,
               changed_out=chg, flag_out=flag)
    assert bool((out == 7.0).all()) and not chg.any() and int(flag) == 0


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_masked_rounds_match_repro_rounds(case):
    """From label-like seeds (a few finite entries a row) to the fixed
    point: every masked round of the plain version equals ``repro``'s
    unmasked round bitwise, and both stop after the same number of
    rounds (the last, non-improving one included)."""
    src, dst, w, _ = SPMV_CASES[case]()
    v = int(max(src.max(), dst.max())) + 1
    q = 12
    rng = np.random.default_rng(len(case))
    cpos = rng.integers(0, v, (2, q, 5))
    dl = rng.integers(0, 6, (2, q, 5)).astype(np.float32)
    dl[rng.random(dl.shape) < 0.3] = np.inf          # label padding
    seeds = [(torch.from_numpy(cpos[i]), torch.from_numpy(dl[i]))
             for i in range(2)]
    rows = 2 * q
    cur, changed = seed_vertex_major(*seeds, v, rows)
    assert cur.shape == (v, rows) and changed.shape == (1, v)
    _same(changed[0] != 0, np.isfinite(cur.numpy()).any(1))
    _same(changed, np.asarray(sector_any(torch.isfinite(cur))))
    csr = _csr(v, src, dst, w)
    ids, ws = j_coo_to_ell(v, src, dst, w)
    j_d = jnp.asarray(cur.numpy().T)
    j_rounds, improved = 0, True
    flag_in = torch.ones(1, dtype=torch.int32)
    while improved:
        j_next = j_spmv(j_d, ids, ws, backend="reference")
        improved = bool(jnp.any(j_next < j_d))
        j_rounds += 1
        cur, changed, flag_in = spmv_relax(cur, csr, changed,
                                           flag_in=flag_in)
        _same(cur.T.contiguous(), j_next)
        assert int(flag_in) == int(improved)
        j_d = j_next
    assert j_rounds > 2
    d0, changed0 = seed_vertex_major(*seeds, v, rows)
    d, rounds = relax_csr_rounds(d0, changed0, csr, max_rounds=10 * v)
    _same(d.T.contiguous(), j_d)
    assert int(rounds) == j_rounds


@pytest.mark.parametrize("rows", [24, 136, 264])
def test_sector_mask_packs_the_tile_mask(rows):
    """``sector_any`` packs one bit per 8-row sector of each row tile:
    a word is nonzero exactly where the tile-level mask it replaces (any
    row of the tile) is set, bit j says whether rows 8j..8j+7 of the
    tile are, and ``sector_rows`` spreads each bit back over its rows."""
    v = 70
    rng = np.random.default_rng(rows)
    m = rng.random((v, rows)) < 0.02
    m[3] = True
    m[5, -1] = True                                 # the last sector only
    got = sector_any(torch.from_numpy(m))
    n_tiles = -(-rows // ROW_TILE)
    assert got.dtype == MASK_DTYPE and got.shape == (n_tiles, v)
    padded = np.zeros((v, n_tiles * ROW_TILE), bool)
    padded[:, :rows] = m
    tiles = padded.reshape(v, n_tiles, ROW_TILE).any(2).T
    _same(got != 0, tiles)
    sectors = padded.reshape(v, n_tiles, TILE_SECTORS, SECTOR_ROWS).any(3)
    word = got.numpy().astype(np.int64) & 0xFFFF
    for j in range(TILE_SECTORS):
        _same((word >> j) & 1 == 1, sectors[:, :, j].T)
    spread = np.repeat(sectors.reshape(v, -1), SECTOR_ROWS, 1)[:, :rows]
    _same(sector_rows(got, rows), spread)
    assert bool((got < 0).any()) == (rows >= ROW_TILE)  # bit 15: row 3


@pytest.mark.parametrize("rows", [24, 136])
def test_relax_csr_rounds_partial_sectors_match_repro(rows):
    """Seeds that change only some sectors of a tile (every third sector
    holds none), R off the row tile: each round of the plain version
    under the sector mask equals ``repro``'s unmasked round bitwise, the
    first mask has tiles with some bits and not others, and
    ``relax_csr_rounds`` reaches the same fixed point in ``repro``'s
    round count."""
    src, dst, w, _ = SPMV_CASES["hub"]()
    v = int(max(src.max(), dst.max())) + 1
    q = rows // 2
    rng = np.random.default_rng(rows)
    cpos = rng.integers(0, v, (2, q, 4))
    dl = rng.integers(0, 6, (2, q, 4)).astype(np.float32)
    row = np.arange(2 * q).reshape(2, q)[..., None]
    dl[np.broadcast_to(row // SECTOR_ROWS % 3 == 1, dl.shape)] = np.inf
    seeds = [(torch.from_numpy(cpos[i]), torch.from_numpy(dl[i]))
             for i in range(2)]
    cur, changed = seed_vertex_major(*seeds, v, rows)
    word = changed.numpy().astype(np.int64) & 0xFFFF
    assert np.any((word != 0) & (word & 0b10 == 0))
    csr = _csr(v, src, dst, w)
    ids, ws = j_coo_to_ell(v, src, dst, w)
    j_d = jnp.asarray(cur.numpy().T)
    j_rounds, improved = 0, True
    flag_in = torch.ones(1, dtype=torch.int32)
    while improved:
        j_next = j_spmv(j_d, ids, ws, backend="reference")
        improved = bool(jnp.any(j_next < j_d))
        j_rounds += 1
        cur, changed, flag_in = spmv_relax(cur, csr, changed,
                                           flag_in=flag_in)
        _same(cur.T.contiguous(), j_next)
        _same(changed, np.asarray(sector_any(torch.from_numpy(
            np.asarray(j_next).T < np.asarray(j_d).T))))
        j_d = j_next
    assert j_rounds > 2
    d, rounds = relax_csr_rounds(*seed_vertex_major(*seeds, v, rows), csr,
                                 max_rounds=10 * v)
    _same(d.T.contiguous(), j_d)
    assert int(rounds) == j_rounds


@pytest.mark.parametrize("graph", ["er", "rmat", "grid"])
def test_default_mode_matches_repro(graph):
    """The port's default route equals ``repro``'s on the same COO, with
    the ELL width taken from the in-degrees (no planes uploaded): at the
    default budget, and with the fused budget set just at and just
    below the fused working set."""
    n, src, dst, w = {"er": lambda: jgen.er_graph(260, 3.0, seed=11),
                      "rmat": lambda: jgen.rmat_graph(8, 8.0, seed=2),
                      "grid": lambda: jgen.grid_graph(14, seed=3)}[graph]()
    base = CoreRelaxer(src, dst, w, n, device="cpu")
    vp = base._vp()
    width = np.asarray(j_coo_to_ell(n + 1, src, dst, w)[0]).shape[1]
    need = fused_vmem_bytes(vp, width)
    for kw in (dict(), dict(dense_threshold=2.0, vmem_budget=need),
               dict(dense_threshold=2.0, vmem_budget=need - 1)):
        got = CoreRelaxer(src, dst, w, n, device="cpu", **kw)
        assert got.mode == JRelaxer(src, dst, w, n, **kw).mode
        assert (got._csr, got._sliced, got._adj) == (None,) * 3  # no layout
    assert CoreRelaxer(src, dst, w, n, dense_threshold=2.0,
                       vmem_budget=need - 1, device="cpu").mode == "ell_loop"


def _fused_case(v, q, hub_deg, seed):
    """A random core of ``v`` vertices (rows >= v/2 without in-edges),
    one hub of in-degree ``hub_deg`` (it sets the ELL width), and ``q``
    rows seeded with a zero and a few 3.0 entries each, the last block
    without seeds."""
    src, dst, w, dist = _ell_case(seed, v, 4 * v, q)
    r = np.random.default_rng(seed + 1)
    src = np.concatenate([src, r.integers(0, v, hub_deg).astype(np.int32)])
    dst = np.concatenate([dst, np.full(hub_deg, 1, np.int32)])
    w = np.concatenate([w, r.integers(1, 9, hub_deg).astype(np.float32)])
    dist[q - 8:] = np.inf
    return src, dst, w, dist


def _fused_vs_repro(v, q, hub_deg, max_rounds, seed):
    """The plain version on the sliced in-edges against ``repro``'s Pallas
    program on the ELL planes of the same COO: fixed point and per-block
    rounds."""
    src, dst, w, dist = _fused_case(v, q, hub_deg, seed)
    d, rounds = fused_relax(torch.from_numpy(dist), _sliced(v, src, dst, w),
                            max_rounds=max_rounds)
    ids, ws = j_coo_to_ell(v, src, dst, w)
    j_d, j_rounds = j_fused(jnp.asarray(dist), ids, ws,
                            max_rounds=max_rounds, interpret=True)
    _same(d, j_d)
    _same(rounds, j_rounds)
    return ids.shape[1], rounds.numpy()


@pytest.mark.parametrize("max_rounds", [0, 2, 1000])
def test_fused_relax_plain_matches_repro(max_rounds):
    """Fixed point and per-block round counts of the fused kernel's plain
    version (over the sliced in-edges) equal the Pallas program's (over the
    ELL planes); includes an all-inf block and a round cap that stops
    blocks early."""
    _, rounds = _fused_vs_repro(128, 24, 0, max_rounds, 5)
    if max_rounds:
        assert rounds[2] == 1                  # the empty block: one round


@pytest.mark.parametrize("max_rounds", [1, 3, 7])
@pytest.mark.parametrize("v,hub_deg,width", [(77, 0, 16), (200, 40, 64),
                                             (136, 70, 80)])
def test_fused_relax_sliced_matches_repro_ell(v, hub_deg, width, max_rounds):
    """Over V off the 128-vertex padding, ELL widths 16, 64 and 80, round
    caps of one round, an odd count and past most blocks' fixed point,
    the plain version on the sliced in-edges equals ``repro``'s fused
    kernel on the
    ELL planes bitwise, per-block rounds included."""
    got_width, rounds = _fused_vs_repro(v, 16, hub_deg, max_rounds, v)
    assert got_width == width
    assert rounds.max() == max_rounds or rounds.max() < max_rounds == 7


def test_fused_variant_by_core_size():
    """Two shared buffers of rows and flags while they fit one block's
    shared memory, device scratch above; each variant has an entry point
    index."""
    v_max = SMEM_BLOCK_BYTES // (2 * VERTEX_BYTES)
    assert VERTEX_BYTES == 33 and v_max == 3521
    assert fused_variant(1) == fused_variant(v_max) == "shared"
    assert fused_variant(1920) == "shared"          # the fused cell's core
    assert fused_variant(v_max + 1) == fused_variant(120_000) == "global"
    assert sorted(FUSED_VARIANTS.values()) == list(range(len(FUSED_VARIANTS)))


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_coo_to_sliced_holds_the_csr_in_edges(case):
    """Slot k of a slice holds destination order[k]'s in-edges, the CSR's
    multiset, at slice_ptr[k // 32] + 32 j + k % 32, then +inf padding to
    the slice's depth (its largest in-degree); the order is the CSR's."""
    src, dst, w, dist = SPMV_CASES[case]()
    v = dist.shape[1]
    order, slice_ptr, s_src, s_w = coo_to_sliced(v, src, dst, w)
    indptr, c_src, c_w, c_order, _ = coo_to_csr(v, src, dst, w)
    _same(order, c_order)
    deg = np.diff(indptr)
    assert slice_ptr.shape == (-(-v // SLICE) + 1,) and slice_ptr[0] == 0
    for k, x in enumerate(order):
        s, lane = divmod(k, SLICE)
        depth = (slice_ptr[s + 1] - slice_ptr[s]) // SLICE
        assert depth == deg[order[s * SLICE:(s + 1) * SLICE]].max()
        slots = slice_ptr[s] + SLICE * np.arange(depth) + lane
        real = slots[:deg[x]]
        assert (sorted(zip(s_src[real].tolist(), s_w[real].tolist()))
                == sorted(zip(c_src[indptr[x]:indptr[x + 1]].tolist(),
                              c_w[indptr[x]:indptr[x + 1]].tolist())))
        assert np.isinf(s_w[slots[deg[x]:]]).all()
    assert np.isfinite(s_w).sum() == len(src)


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
    tg = tcsr.from_host_edges(src, dst, w, n, e + 37, via=via, device="cpu")
    jg = jcsr.from_host_edges(src, dst, w, n, e + 37, via=via)
    for a, b in zip(tcsr.neighbor_matrix(tg, 6), jcsr.neighbor_matrix(jg, 6)):
        _same(a, b)
    out_cap = 200                                  # fewer than the pairs
    got = tcsr.dedup_min_edges(tg.src, tg.dst, tg.weight, tg.via, n, out_cap)
    want = jcsr.dedup_min_edges(jg.src, jg.dst, jg.weight, jg.via, n, out_cap)
    for a, b in zip(got, want):
        _same(a, b)
