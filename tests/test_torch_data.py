"""The port's data pipeline and bench-trajectory gate against ``repro``
on the CPU: ``graph_from_spec`` for every kind, the SNAP loaders (a
round trip with 2 and 3 columns), ``PrefetchPipeline`` (order, seek,
error), and ``obs.regression`` on the committed ``BENCH_*.json`` files.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import pipeline as j_pipe
from repro.obs import regression as j_reg
from repro_torch.data import PrefetchPipeline
from repro_torch.data import pipeline as t_pipe
from repro_torch.obs import regression as t_reg

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("spec", ["er:300:2.5@3", "er:200", "rmat:9:6@1",
                                  "rmat:8", "pa:300:3@2", "pa:150",
                                  "grid:12@4", "grid:9"])
def test_graph_from_spec_equal_repro(spec):
    for a, b in zip(t_pipe.graph_from_spec(spec),
                    j_pipe.graph_from_spec(spec)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_graph_from_spec_unknown_kind():
    with pytest.raises(ValueError, match="unknown graph spec kind"):
        t_pipe.graph_from_spec("torus:4")


@pytest.mark.parametrize("weighted", [False, True], ids=["2col", "3col"])
def test_snap_round_trip_equal_repro(tmp_path, weighted):
    """A graph written by the port's ``save_snap_edgelist`` (sparse ids:
    every vertex id times 3 plus 7) loads through both packages'
    loaders (and ``graph_from_spec("snap:...")``) to the same arrays."""
    n, src, dst, w = t_pipe.graph_from_spec("er:200:3@5")
    path = tmp_path / "g.txt"
    t_pipe.save_snap_edgelist(path, n * 3 + 7, src * 3 + 7, dst * 3 + 7,
                              w if weighted else None, comment="test")
    j_path = tmp_path / "j.txt"
    j_pipe.save_snap_edgelist(j_path, n * 3 + 7, src * 3 + 7, dst * 3 + 7,
                              w if weighted else None, comment="test")
    assert path.read_text() == j_path.read_text()
    got = t_pipe.load_snap_edgelist(path, max_w=4, seed=2)
    want = j_pipe.load_snap_edgelist(path, max_w=4, seed=2)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert got[0] == len(np.unique(src))      # isolated ids dropped
    for a, b in zip(t_pipe.graph_from_spec(f"snap:{path}@2"),
                    j_pipe.graph_from_spec(f"snap:{path}@2")):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _batch(step):
    return {"x": np.full((2, 3), step, np.int32),
            "y": np.arange(4, dtype=np.float32) + step}


def test_prefetch_order_seek_and_stop():
    pipe = PrefetchPipeline(_batch, depth=2, device="cpu")
    got = [pipe(i) for i in range(5)]
    for i, b in enumerate(got):
        assert isinstance(b["x"], torch.Tensor) and b["x"].device.type == "cpu"
        np.testing.assert_array_equal(b["x"].numpy(), _batch(i)["x"])
        np.testing.assert_array_equal(b["y"].numpy(), _batch(i)["y"])
    # a seek backwards and forwards restarts the worker at that step
    for step in (2, 2, 7, 3):
        np.testing.assert_array_equal(pipe(step)["x"].numpy(),
                                      _batch(step)["x"])
    pipe.reset(10)
    np.testing.assert_array_equal(pipe(10)["y"].numpy(), _batch(10)["y"])
    pipe.stop()
    host = PrefetchPipeline(_batch, device_put=False)
    assert isinstance(host(1)["x"], np.ndarray)
    host.stop()


def test_prefetch_reraises_the_batch_error():
    def bad(step):
        if step == 2:
            raise KeyError("no batch 2")
        return _batch(step)
    pipe = PrefetchPipeline(bad, depth=2, device="cpu")
    pipe(0), pipe(1)
    with pytest.raises(KeyError, match="no batch 2"):
        pipe(2)
    pipe.stop()


BENCH = sorted(ROOT.glob("BENCH_*.json"))


def _perturbed(doc):
    """``doc`` with every numeric value scaled by 1.3 (a drift past the
    tolerances in both directions of 'better')."""
    if isinstance(doc, dict):
        return {k: _perturbed(v) for k, v in doc.items()}
    if isinstance(doc, list):
        return [_perturbed(v) for v in doc]
    if isinstance(doc, (int, float)) and not isinstance(doc, bool):
        return doc * 1.3
    return doc


@pytest.mark.parametrize("path", BENCH, ids=lambda p: p.name)
def test_compare_docs_equal_repro(path):
    base = json.loads(path.read_text())
    for fresh in (base, _perturbed(base)):
        for kw in ({}, {"timing_tolerance": 0.1, "behavior_tolerance": 0.0}):
            got = t_reg.compare_docs(path.stem[6:], base, fresh, **kw)
            want = j_reg.compare_docs(path.stem[6:], base, fresh, **kw)
            assert repr(got) == repr(want)


def test_compare_dirs_equal_repro(tmp_path):
    """Some of the committed tables drifted by 30%: the same regressions
    found, table by table."""
    fresh = tmp_path / "fresh"
    fresh.mkdir()
    for p in BENCH[:3]:
        (fresh / p.name).write_text(json.dumps(_perturbed(
            json.loads(p.read_text()))))
    got = t_reg.compare_dirs(ROOT, fresh)
    want = j_reg.compare_dirs(ROOT, fresh)
    assert repr(got) == repr(want)
