"""The least work stage 2 needs, and the table of peaks it is held to.

Stage 2 relaxes both sides' frontiers over the core in synchronous
(Jacobi) rounds to the fixed point. Rounds are gated bitwise, so which
frontier values change in which round is fixed by the inputs, whatever
implements the rounds. The count takes only what those rounds need:

* bytes, per round: 4 for each frontier value that changed in the
  previous round (the seeds, in the first), 8 for each core in-edge
  (id and weight) whose source changed in some row, and 4 for each
  entry that improves;
* operations, per round: an add and a min for each (in-edge, row) pair
  whose source changed.

``replay`` finds those sets with a plain PyTorch replay of the rounds,
in chunks of rows, from the seeds the program's ``CoreRelaxer.run``
received and over the index's public core arrays. Its final frontiers
must equal the ones ``run`` returned: a check on the count, not the
correctness reference.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

INF = float("inf")

# NVIDIA H100 SXM data sheet, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12       # float32 outside the tensor cores


def bound_s(n_bytes: float, n_ops: float) -> tuple[float, str]:
    """The least seconds the work can take, and which peak sets it."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / FP32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _frontier(seeds, rows: slice, v: int, device) -> torch.Tensor:
    """[v, r] vertex-major frontier of the stacked seed rows ``rows``:
    +inf, each label distance scattered (min) to its core position."""
    cpos, d = (x[rows].to(device) for x in seeds)
    r, width = cpos.shape
    col = torch.arange(r, device=device)[:, None].expand(r, width)
    out = torch.full((v * r,), INF, dtype=torch.float32, device=device)
    out.scatter_reduce_(0, (cpos * r + col).reshape(-1), d.reshape(-1),
                        "amin", include_self=True)
    return out.view(v, r)


def replay(seeds_s, seeds_t, core_src, core_dst, core_w, n_core: int,
           device, frontiers=None, chunk: int = 128) -> dict:
    """The work of stage 2 on these seeds.

    ``seeds_s``/``seeds_t``: each side's ``(cpos int64[Q, L], d
    float32[Q, L])`` as ``CoreRelaxer.run`` takes them (cpos n_core is
    the sentinel for non-core ancestors). ``core_src``/``core_dst``:
    core positions of the core edges, ``core_w`` their weights.
    ``frontiers``: the ``(ds, dt)`` that ``run`` returned, to compare
    with. Returns bytes, operations, rounds and whether the frontiers
    agree (None when none were given)."""
    v = n_core + 1
    src = torch.as_tensor(np.asarray(core_src, np.int64), device=device)
    dst = torch.as_tensor(np.asarray(core_dst, np.int64), device=device)
    w = torch.as_tensor(np.asarray(core_w, np.float32), device=device)[:, None]
    seeds = tuple(torch.cat([a, b]) for a, b in zip(seeds_s, seeds_t))
    want = None if frontiers is None else torch.cat(list(frontiers))
    n_rows = seeds[0].shape[0]
    real = (torch.arange(v, device=device) < n_core)[:, None]
    values = improved_n = pairs = 0
    edges_by_round: list[torch.Tensor] = []   # in-edges read, per round
    rounds = 0
    agree = None if want is None else True
    for lo in range(0, n_rows, chunk):
        cur = _frontier(seeds, slice(lo, lo + chunk), v, device)
        changed = torch.isfinite(cur) & real
        r = 0
        while True:
            live = changed[src]                      # [E, r]
            values += int(changed.sum())
            pairs += int(live.sum())
            used = live.any(1)
            if r == len(edges_by_round):
                edges_by_round.append(used)
            else:
                edges_by_round[r] |= used
            cand = torch.where(live, cur[src] + w, INF)
            with warnings.catch_warnings():    # "index_reduce is in beta"
                warnings.simplefilter("ignore", UserWarning)
                new = cur.index_reduce(0, dst, cand, "amin",
                                       include_self=True)
            del cand, live
            better = new < cur
            n_better = int(better.sum())
            improved_n += n_better
            r += 1
            cur, changed = new, better
            if n_better == 0:
                break
        rounds = max(rounds, r)
        if want is not None:
            got = want[lo:lo + chunk].to(device)
            agree = agree and torch.equal(cur.T, got)
    n_edges = sum(int(u.sum()) for u in edges_by_round)
    n_bytes = 4 * values + 8 * n_edges + 4 * improved_n
    return {"bytes": n_bytes, "ops": 2 * pairs, "rounds": rounds,
            "agree": agree}
