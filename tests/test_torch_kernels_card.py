"""The hand-written CUDA kernels on the card, against their plain
versions. Marked ``card``: they skip on a machine without one. Run them
there with ``PYTHONPATH=src python -m pytest -q -m card tests/``.

``spmv_relax_kernel`` with ``full`` 0 writes only the sectors of
``out`` that can differ from the round before's (``csrc/spmv_relax.cu``):
a round over a NaN-poisoned ``out`` shows which it wrote, and a whole
``relax_csr_rounds`` call, which hands each round the buffer of the
round before, must equal the plain rounds bitwise.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.dispatch import relax_csr_rounds, seed_vertex_major
from repro_torch.kernels.spmv_relax.kernel import (HEAVY_DEGREE, ROW_TILE,
                                                   TILE_SECTORS, RelaxCSR,
                                                   pack_sectors, sector_bits,
                                                   spmv_relax_kernel)
from repro_torch.kernels.spmv_relax.ops import coo_to_csr
from repro_torch.kernels.spmv_relax.ref import sector_rows, spmv_relax_ref

LANE_ROWS = 4   # rows a lane loads and stores as one float4


@pytest.fixture
def card():
    """The CUDA card, or a skip where there is none (decided here, when
    the test runs, so every worker collects the same tests)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


def _graph(dev, v, e, hub_deg, seed):
    """Random edges into the first half of the vertices, one hub above
    the heavy degree (a whole block's item), weights 1..8."""
    r = np.random.default_rng(seed)
    src = np.concatenate([r.integers(0, v, e), r.integers(0, v, hub_deg)])
    dst = np.concatenate([r.integers(0, v // 2, e), np.full(hub_deg, 3)])
    w = r.integers(1, 9, len(src)).astype(np.float32)
    *layout, n_heavy = coo_to_csr(v, src, dst, w)
    assert n_heavy == 1
    return RelaxCSR(*(torch.from_numpy(x).to(dev) for x in layout), n_heavy)


def _gather_min(dist, csr, changed):
    """min over the in-edges whose source has the row's sector bit set
    of dist[u, r] + w (+inf where none): what the kernel's gathers
    reach, before the min with dist."""
    rows = dist.shape[1]
    dst = torch.searchsorted(csr.indptr[1:].long(),
                             torch.arange(csr.src.numel(),
                                          device=dist.device), right=True)
    u = csr.src.long()
    g = torch.where(sector_rows(changed, rows)[u], dist[u] + csr.w[:, None],
                    float("inf"))
    cand = torch.full_like(dist, float("inf"))
    return cand.scatter_reduce_(0, dst[:, None].expand_as(g), g, "amin")


@pytest.mark.card
@pytest.mark.parametrize("rows", [24, 136, 264])
def test_partial_round_writes_only_moved_sectors(card, rows):
    """One round with ``full`` 0 over an ``out`` of NaN: a lane's four
    rows are stored where its sector's bit is set or some row improved,
    and equal the plain version there; the rest keep the NaN, so every
    slot whose bit is clear and that no gather reached does. The mask,
    the flag, the counts, and a ``full`` 1 round equal the plain
    version's; a quiet launch (flag in 0) counts nothing."""
    v = 2000
    csr = _graph(card, v, 6 * v, HEAVY_DEGREE + 200, rows)
    g = torch.Generator(device=card).manual_seed(rows)
    dist = torch.randint(0, 30, (v, rows), generator=g, device=card).float()
    dist[torch.rand((v, rows), generator=g, device=card) < 0.7] = np.inf
    n_tiles = -(-rows // ROW_TILE)
    bits = torch.rand((n_tiles, v, TILE_SECTORS), generator=g,
                      device=card) < 0.3
    changed = pack_sectors(bits)
    flag_in = torch.ones(1, dtype=torch.int32, device=card)

    def outs():
        return (torch.full_like(dist, float("nan")),
                torch.full_like(changed, 0x1234),
                torch.zeros(1, dtype=torch.int32, device=card))

    def counts():
        return torch.full((2,), 7, dtype=torch.int64, device=card)

    want_counts, got_counts = counts(), counts()
    want, want_chg, want_flag = spmv_relax_ref(
        dist, csr, changed, flag_in, *outs(), counts=want_counts)
    got, chg, flag = spmv_relax_kernel(dist, csr, changed, flag_in, *outs(),
                                       full=0, counts=got_counts)
    spmv_relax_kernel(dist, csr, changed, torch.zeros_like(flag_in),
                      *outs(), full=0, counts=got_counts)
    torch.cuda.synchronize()
    assert torch.equal(chg, want_chg) and torch.equal(flag, want_flag)
    assert int(flag) == 1
    assert got_counts.tolist() == want_counts.tolist() == [
        7 + int((changed != 0).sum()), 7 + int(sector_bits(changed).sum())]

    def lanes(x):
        return x.view(v, rows // LANE_ROWS, LANE_ROWS)

    reached = lanes(torch.isfinite(_gather_min(dist, csr, changed))).any(2)
    improved = lanes(want < dist).any(2)
    bit = lanes(sector_rows(changed, rows))[..., 0]
    stored = bit | improved
    assert bool(improved.any()) and bool((reached & ~stored).any())
    assert torch.equal(lanes(got)[stored], lanes(want)[stored])
    assert bool(lanes(got)[~stored].isnan().all())
    assert bool(lanes(got)[~bit & ~reached].isnan().all())
    full, _, _ = spmv_relax_kernel(dist, csr, changed, flag_in, *outs(),
                                   full=1)
    assert torch.equal(full, want)


@pytest.mark.card
@pytest.mark.parametrize("rows", [24, 136])
def test_relax_csr_rounds_equal_the_plain_loop(card, rows):
    """A whole ``relax_csr_rounds`` call on the card (round 0 ``full``,
    then each round over the buffer of the round before) equals the
    plain rounds, each into fresh buffers, to the fixed point: frontier
    bitwise and the round count."""
    v = 3000
    csr = _graph(card, v, 5 * v, HEAVY_DEGREE + 60, rows + 1)
    r = np.random.default_rng(rows)
    q = rows // 2
    seeds = [(torch.from_numpy(r.integers(0, v, (q, 6))).to(card),
              torch.from_numpy(np.where(r.random((q, 6)) < 0.3, np.inf,
                                        r.integers(0, 9, (q, 6)))
                               .astype(np.float32)).to(card))
             for _ in range(2)]
    d, rounds = relax_csr_rounds(*seed_vertex_major(*seeds, v, rows), csr,
                                 max_rounds=10 * v)
    cur, changed = seed_vertex_major(*seeds, v, rows)
    flag, want_rounds = torch.ones(1, dtype=torch.int32, device=card), 0
    while int(flag):
        cur, changed, flag = spmv_relax_ref(
            cur, csr, changed, flag, torch.empty_like(cur),
            torch.empty_like(changed),
            torch.zeros(1, dtype=torch.int32, device=card))
        want_rounds += 1
    assert want_rounds > 2
    assert torch.equal(d, cur) and int(rounds) == want_rounds
