"""Parallel independent-set selection (the paper's Alg. 2), as in
``repro.core.mis``: Luby-style rounds over the strict two-word priority
key ``(min(deg, d_cap+1), perm)``; a vertex enters the set iff its key
is a strict local minimum among still-undecided eligible neighbours.

The tie-breaking permutation comes from a *permutation source* (one
permutation of ``[0, n)`` per level): torch cannot reproduce
``jax.random.permutation``, so the default source draws
``torch.randperm`` from a CPU generator seeded with ``cfg.seed`` (the
same permutations on every device), and parity tests inject JAX's.

The round loop has no device-side ``while``: ``MISState.advance`` runs a
fixed number of rounds with no host sync. A round whose pool is already
empty is an exact no-op and is not counted, so ``rounds`` equals
``repro``'s ``lax.while_loop`` count however many rounds were launched;
the caller reads ``pool_left`` once to learn whether to run more.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.graphs import segment_ops as sops
from repro_torch.obs.trace import count, spanned

_HI_INF = 2 ** 31 - 1      # ineligible / empty-segment high word
_LO_INF = 2 ** 31 - 1


def mis_key_words(deg, perm, d_cap):
    """The two-word priority key ``(hi, lo) = (min(deg, d_cap+1), perm)``."""
    hi = torch.clamp(deg, max=d_cap + 1).to(torch.int32)
    lo = perm.to(torch.int32)
    return hi, lo


def lex_less(a_hi, a_lo, b_hi, b_lo):
    """Strict lexicographic (hi, lo) < (hi, lo) — elementwise."""
    return (a_hi < b_hi) | ((a_hi == b_hi) & (a_lo < b_lo))


def torch_permutations(seed: int, n: int):
    """Default permutation source: one ``torch.randperm(n)`` per level
    from a CPU generator seeded with ``seed``."""
    g = torch.Generator().manual_seed(seed)
    while True:
        yield torch.randperm(n, generator=g).to(torch.int32)


@dataclasses.dataclass
class MISState:
    """One level's independent-set search over a fixed edge list."""
    src: torch.Tensor
    dst: torch.Tensor
    valid: torch.Tensor
    key_hi: torch.Tensor
    key_lo: torch.Tensor
    pool: torch.Tensor        # bool[n] still undecided
    in_is: torch.Tensor       # bool[n]
    rounds: torch.Tensor      # int32 scalar: rounds that found a pool
    n: int

    @classmethod
    @spanned("build.mis")
    def start(cls, src, dst, valid, active, perm, n: int, d_cap: int):
        """src, dst: int32[e_cap] (sentinel-padded with id n); valid:
        bool[e_cap]; active: bool[n] vertices still in G_i; perm: a
        permutation of [0, n) on the edges' device."""
        deg = sops.count_per_segment(src, n + 1, mask=valid)[:n]
        key_hi, key_lo = mis_key_words(deg, perm, d_cap)
        eligible = active & (deg <= d_cap)
        key_hi = torch.where(eligible, key_hi, _HI_INF)
        key_lo = torch.where(eligible, key_lo, _LO_INF)
        return cls(src, dst, valid, key_hi, key_lo, eligible,
                   torch.zeros(n, dtype=torch.bool, device=src.device),
                   torch.zeros((), dtype=torch.int32, device=src.device), n)

    @spanned("build.mis")
    def advance(self, n_rounds: int) -> "MISState":
        """Run ``n_rounds`` Luby rounds without a host sync. Updates in
        place (JAX carried the same state through ``while_loop``).
        Counts ``build.mis_launched``."""
        count("build.mis_launched", n_rounds)
        n, dst, valid = self.n, self.dst, self.valid
        # sentinel sources are masked by ``valid``; clamp them in bounds
        # (JAX clamps out-of-bounds gathers, torch raises)
        sc = self.src.long().clamp(max=n - 1)
        dl = dst.long()
        for _ in range(n_rounds):
            pool = self.pool
            self.rounds += pool.any()
            on = pool[sc] & valid
            c_hi = torch.where(on, self.key_hi[sc], _HI_INF)
            nbr_hi = sops.segment_min(c_hi, dst, n + 1)
            at_min = on & (c_hi == nbr_hi[dl])
            c_lo = torch.where(at_min, self.key_lo[sc], _LO_INF)
            nbr_lo = sops.segment_min(c_lo, dst, n + 1)
            winners = pool & lex_less(self.key_hi, self.key_lo, nbr_hi[:n],
                                      nbr_lo[:n])
            w_on = winners[sc] & valid
            w_nbr = sops.segment_max(w_on.to(torch.int32), dst, n + 1)[:n] > 0
            self.pool = pool & ~winners & ~w_nbr
            self.in_is = self.in_is | winners
        return self

    def pool_left(self) -> torch.Tensor:
        return self.pool.any()
