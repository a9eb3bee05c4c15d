"""Compressed labels in the PyTorch port against ``repro``.

- The delta16 codec: the port's encode gives ``repro``'s ``delta``,
  ``base`` and ``d_enc`` arrays, and raises the same exception type on
  every rejection; its torch decode equals ``repro``'s jnp decode.
- ``label_intersect_packed_ref`` (what the ``cuda`` backend runs on a
  CPU tensor) against ``repro``'s ``label_intersect_rows(...,
  codec="delta16")`` running the Pallas program (``backend="interpret"``)
  and the jnp reference, and against the fp32 intersect on the decoded
  planes; likewise its indexed form, which reads rows by endpoint id
  from the encoded planes.
- A compressed engine against ``repro``'s compressed engine and the
  port's fp32 engine on every stage-2 route, and against Dijkstra; the
  ``"auto"`` fallbacks; compressed indexes saved by one package and
  answered by the other.

Tolerance: bitwise everywhere. The generators' weights are integers,
and delta16 ids and int32 distances decode exactly.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ISLabelIndex as JIndex
from repro.core import IndexConfig as JConfig
from repro.core import labels as jlabels
from repro.graphs import generators as gen
from repro.kernels.label_intersect.ops import \
    label_intersect_rows as j_intersect_rows
from repro_torch.core import ISLabelIndex, IndexConfig, QueryEngine, ref
from repro_torch.core import labels
from repro_torch.kernels.label_intersect.ops import (label_intersect,
                                                     label_intersect_planes,
                                                     label_intersect_rows)
from test_torch_kernels import label_endpoints, label_planes
from test_torch_query import ROUTES, _pin

Q = 48


def _same(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def _planes(rng, q=20, l=24, n=4000, integral=True):
    """Sorted id rows with gaps below int16, pad tails on every fourth
    row and one fully padded row; fp32 distances, +inf on pads."""
    ids = (rng.integers(0, 300, (q, 1))
           + np.cumsum(rng.integers(1, 40, (q, l)), axis=1)).astype(np.int32)
    ids[::4, l - 3:] = n
    ids[3, :] = n
    d = (rng.integers(0, 90, (q, l)).astype(np.float32) if integral
         else (rng.random((q, l)) * 9).astype(np.float32))
    return ids, np.where(ids < n, d, np.inf).astype(np.float32), n


# ----------------------------------------------------------------- codec
@pytest.mark.parametrize("d_dtype", [None, "float32"])
@pytest.mark.parametrize("integral", [True, False])
def test_codec_matches_repro(integral, d_dtype):
    ids, d, n = _planes(np.random.default_rng(1), integral=integral)
    got = labels.encode_labels(ids, d, n, d_dtype)
    want = jlabels.encode_labels(ids, d, n, d_dtype)
    for a, b in zip(got, want):
        _same(torch.from_numpy(a), b)
    assert got[2].dtype == (np.int32 if integral and d_dtype is None
                            else np.float32)
    rows = labels.LabelRows(*(torch.from_numpy(x) for x in got))
    j_rows = jlabels.LabelRows(*(jnp.asarray(x) for x in want))
    dec = labels.decode_rows(rows, n, "delta16")
    for a, b in zip(dec, jlabels.decode_rows(j_rows, n, "delta16")):
        _same(a, b)
    _same(dec[0], ids)
    _same(dec[1], d)
    assert labels.encoded_nbytes(*rows) == jlabels.encoded_nbytes(*want)


def test_decode_matches_repro_on_raw_deltas():
    """Any negative delta is a pad marker and everything after the first
    one decodes to the sentinel, stray deltas included."""
    rng = np.random.default_rng(2)
    delta = rng.integers(-3, 60, (30, 70)).astype(np.int16)
    delta[rng.random(30) < 0.3, 0] = -1
    base = rng.integers(0, 10_000, 30).astype(np.int32)
    got = labels.decode_ids(torch.from_numpy(delta), torch.from_numpy(base),
                            12_345)
    _same(got, jlabels.decode_ids(jnp.asarray(delta), jnp.asarray(base),
                                  12_345))
    d_enc = rng.integers(-1, 50, (30, 70)).astype(np.int32)
    _same(labels.decode_d(torch.from_numpy(d_enc)),
          jlabels.decode_d(jnp.asarray(d_enc)))


def _reject(case):
    ids, d, n = _planes(np.random.default_rng(3))
    if case == "unsorted":
        ids[0, 0], ids[0, 1] = ids[0, 1], ids[0, 0]
    elif case == "delta_overflow":
        ids = ids.astype(np.int64)
        ids[1, -4:] += 40_000
        n = 4_000_000
        ids[ids == 4000] = n
        d = np.where(ids < n, d, np.inf).astype(np.float32)
    elif case == "pad_mid_row":
        ids[2, 5] = n                       # row 2 has no pad tail
    elif case == "bad_shape":
        d = d[:, :-1]
    elif case in ("fractional_int32", "negative_int32"):
        d[0, 0] = 1.5 if case == "fractional_int32" else -2.0
    return ids, d, n, ("int32" if case.endswith("_int32") else None)


@pytest.mark.parametrize("case", ["unsorted", "delta_overflow",
                                  "pad_mid_row", "bad_shape",
                                  "fractional_int32", "negative_int32"])
def test_encode_rejections_match_repro(case):
    ids, d, n, d_dtype = _reject(case)
    with pytest.raises(jlabels.LabelCompressionError):
        jlabels.encode_labels(ids, d, n, d_dtype)
    with pytest.raises(labels.LabelCompressionError):
        labels.encode_labels(ids, d, n, d_dtype)
    assert labels.try_encode_labels(ids, d, n, d_dtype) is None


# --------------------------------------------------------- packed kernel
def _packed_rows(rng, q, l, n, d_dtype):
    """Encodable rows as ``benchmarks/bench_kernels.py`` builds them
    (bounded gaps, a pad tail on every other row), with t sharing about
    half of each s row's ids and one fully padded row."""
    step_hi = max(3, (n // 2) // l)
    ids_s = (rng.integers(0, n // 4, (q, 1))
             + np.cumsum(rng.integers(2, step_hi, (q, l)), axis=1)
             ).astype(np.int32)
    ids_t = ids_s + (rng.random((q, l)) < 0.5)
    d_s = rng.integers(0, 100, (q, l)).astype(np.float32)
    d_t = rng.integers(0, 100, (q, l)).astype(np.float32)
    for ids, d in ((ids_s, d_s), (ids_t, d_t)):
        ids[::2, l - min(4, l - 1):] = n
        ids[q // 2] = n
        d[ids == n] = np.inf
    return [labels.encode_labels(ids, d, n, d_dtype)
            for ids, d in ((ids_s, d_s), (ids_t, d_t))], (ids_s, d_s,
                                                          ids_t, d_t)


@pytest.mark.parametrize("d_dtype", ["int32", "float32"])
@pytest.mark.parametrize("q,l,n", [(1, 8, 500), (13, 100, 4000),
                                   (37, 129, 9000)])
def test_packed_plain_matches_repro(q, l, n, d_dtype):
    """Q and L off the TPU tiles (bq=16, 128); the 'cuda' backend on CPU
    tensors runs the plain version."""
    (enc_s, enc_t), planes = _packed_rows(np.random.default_rng(q), q, l, n,
                                          d_dtype)
    rows = [labels.LabelRows(*(torch.from_numpy(x) for x in e))
            for e in (enc_s, enc_t)]
    got = {be: label_intersect_rows(*rows, n, "delta16", backend=be)
           for be in ("cuda", "reference")}
    j_rows = [jlabels.LabelRows(*(jnp.asarray(x) for x in e))
              for e in (enc_s, enc_t)]
    for jb in ("interpret", "reference"):
        want = j_intersect_rows(*j_rows, n, codec="delta16", backend=jb)
        for g in got.values():
            _same(g, want)
    fp32 = label_intersect(*(torch.from_numpy(x) for x in planes), n)
    _same(got["cuda"], fp32)
    if q > 1:
        assert np.isfinite(fp32.numpy()).sum() > q // 2   # real matches


@pytest.mark.parametrize("d_dtype", ["int32", "float32"])
@pytest.mark.parametrize("l,dup", [(45, False), (70, True), (129, False)])
def test_packed_planes_matches_repro(l, dup, d_dtype):
    """The indexed form over encoded [n+1, L] planes (rows at and one
    past the 32-slot chunks, duplicate ids, the all-pad row n, repeated
    endpoints) against ``repro``'s packed intersect of the same rows
    gathered in JAX, bitwise, and against the indexed fp32 form."""
    n, q = 300, 48
    ids, d = label_planes(l + 7, n, l, dup)
    s, t = label_endpoints(l + 8, n, q)
    enc = labels.encode_labels(ids, d, n, d_dtype)
    assert enc[2].dtype == np.dtype(d_dtype)
    planes = labels.LabelRows(*(torch.from_numpy(x) for x in enc))
    got = {be: label_intersect_planes(planes, torch.from_numpy(s),
                                      torch.from_numpy(t), n, "delta16",
                                      backend=be)
           for be in ("cuda", "reference")}
    j_enc = [jnp.asarray(x) for x in enc]
    j_rows = [jlabels.LabelRows(*(x[e] for x in j_enc)) for e in (s, t)]
    for jb in ("interpret", "reference"):
        want = torch.from_numpy(np.array(
            j_intersect_rows(*j_rows, n, codec="delta16", backend=jb)))
        for g in got.values():
            assert torch.equal(g, want)
    fp32 = label_intersect_planes(
        labels.LabelRows(torch.from_numpy(ids), None, torch.from_numpy(d)),
        torch.from_numpy(s), torch.from_numpy(t), n)
    assert torch.equal(got["cuda"], fp32)
    assert torch.isfinite(fp32).sum() > q // 2


# ---------------------------------------------------------------- engine
@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """``repro``'s compressed index, saved and loaded by the port (a
    compressed engine), and the port's fp32 engine on the same planes."""
    n, src, dst, w = gen.er_graph(240, 2.6, seed=9)
    j_idx = JIndex.build(n, src, dst, w, JConfig(l_cap=128, label_chunk=64,
                                                 label_dtype="compressed"))
    assert j_idx.engine.codec == "delta16" and j_idx.stats.n_core > 0
    path = tmp_path_factory.mktemp("compressed")
    j_idx.save(path)
    t_idx = ISLabelIndex.load(path, device="cpu")
    fp32 = _twin(t_idx.engine, "fp32")
    rng = np.random.default_rng(17)
    s = rng.integers(0, n, Q).astype(np.int32)
    t = rng.integers(0, n, Q).astype(np.int32)
    oracle = ref.dijkstra_oracle(n, src, dst, w, s)[np.arange(Q), t]
    return (n, src, dst, w), j_idx, t_idx, fp32, s, t, oracle


def _twin(eng, label_dtype, lbl_ids=None, n=None):
    r = eng.relaxer
    return QueryEngine(eng.lbl_ids if lbl_ids is None else lbl_ids,
                       eng.lbl_d, eng.core_pos, (r.ce_src, r.ce_dst, r.ce_w),
                       eng.n if n is None else n, eng.n_core,
                       label_dtype=label_dtype)


def test_repro_compressed_index_loads_delta16(indexes):
    _, j_idx, t_idx, _, _, _, _ = indexes
    eng, je = t_idx.engine, j_idx.engine
    assert t_idx.cfg.label_dtype == "compressed"
    assert eng.codec == "delta16" and eng.enc_d.dtype == torch.int32
    for a, b in ((eng.enc_ids, je.enc_ids), (eng.enc_base, je.enc_base),
                 (eng.enc_d, je.enc_d)):
        _same(a, b)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_compressed_routes_match_repro(indexes, route):
    _, j_idx, t_idx, fp32, s, t, oracle = indexes
    _pin(j_idx, t_idx, route)
    _pin(j_idx, types.SimpleNamespace(engine=fp32), route)
    eng, je = t_idx.engine, j_idx.engine
    got = eng.query(s, t, backend="cuda")
    _same(got, je.query(s, t, backend="interpret"))
    assert eng._last_rounds == je._last_rounds
    _same(got, fp32.query(s, t, backend="cuda"))
    _same(got, oracle.astype(np.float32))
    _same(eng.query(s, t, backend="cuda", query_chunk=16), got)
    mu = eng.query_mu_only(s, t, backend="cuda")
    _same(mu, je.query_mu_only(s, t, backend="interpret"))
    _same(mu, fp32.query_mu_only(s, t, backend="cuda"))


def test_compressed_reference_backend_and_serving(indexes):
    _, j_idx, t_idx, fp32, s, t, oracle = indexes
    eng, je = t_idx.engine, j_idx.engine
    for chunk in (0, 16):
        got = eng.query(s, t, backend="reference", query_chunk=chunk)
        _same(got, je.query(s, t, backend="reference"))
        _same(got, oracle.astype(np.float32))
    _same(eng.query_mu_only(s, t, backend="reference"),
          je.query_mu_only(s, t, backend="reference"))
    ans, rounds = eng.batch_fn("cuda")(s, t)
    _same(ans, fp32.batch_fn("cuda")(s, t)[0])
    eng.query(s, t, backend="cuda")
    assert int(rounds) == eng._last_rounds
    _same(eng.mu_batch_fn("cuda")(s, t), fp32.mu_batch_fn("cuda")(s, t))
    assert sorted(eng.warmup([4], backend="cuda")) == [("full", 4),
                                                       ("mu", 4)]


def test_mu_lanes_gather_no_rows(indexes, monkeypatch):
    """``query_mu_only`` and ``mu_batch_fn`` read the label planes in
    place in both codecs: with the row gather disabled they still equal
    ``repro``'s μ-only answers."""
    _, j_idx, t_idx, fp32, s, t, _ = indexes
    want = j_idx.engine.query_mu_only(s, t, backend="interpret")

    def no_gather(self, idx):
        raise AssertionError("the mu-only lane gathered label rows")

    monkeypatch.setattr(QueryEngine, "_rows", no_gather)
    for eng in (t_idx.engine, fp32):
        for backend in ("cuda", "reference"):
            _same(eng.query_mu_only(s, t, backend=backend), want)
            _same(eng.mu_batch_fn(backend)(s, t), want)


def test_auto_fallback_modes(indexes):
    """auto: fractional weights keep a float32 distance plane (ids still
    delta16); ids that overflow int16 gaps keep codec "none", while
    "compressed" raises on them."""
    (n, src, dst, w), _, t_idx, fp32, s, t, _ = indexes
    half = ISLabelIndex.build(
        n, src, dst, w * np.float32(0.5),
        IndexConfig(l_cap=128, label_chunk=64, label_dtype="auto"),
        device="cpu")
    assert half.engine.codec == "delta16"
    assert half.engine.enc_d.dtype == torch.float32
    _same(half.query(s, t), 0.5 * fp32.query(s, t).numpy())

    eng = t_idx.engine
    wide = eng.lbl_ids.to(torch.int64)
    wide = torch.where(wide < eng.n, wide * 40_000, wide)
    wide_n = int(wide.max()) + 1
    wide = torch.where(wide == eng.n, wide_n, wide).to(torch.int32)
    assert _twin(eng, "auto", wide, wide_n).codec == "none"
    with pytest.raises(labels.LabelCompressionError):
        _twin(eng, "compressed", wide, wide_n)
    with pytest.raises(ValueError):
        _twin(eng, "zstd")


def test_port_compressed_index_answers_in_repro(indexes, tmp_path):
    _, j_idx, t_idx, _, s, t, _ = indexes
    t_idx.save(tmp_path)
    back = JIndex.load(tmp_path)
    assert back.engine.codec == "delta16"
    np.testing.assert_array_equal(back.query_host(s, t),
                                  j_idx.query_host(s, t))
    again = ISLabelIndex.load(tmp_path, device="cpu")
    assert again.engine.codec == "delta16"
    np.testing.assert_array_equal(again.query_host(s, t),
                                  t_idx.query_host(s, t))
