"""Plain PyTorch versions of the ELL min-plus relaxation kernels."""
import torch


def spmv_relax_ref(dist, nbr_ids, nbr_w):
    """One Jacobi round. The min over the D slots runs one [Q, V] gather
    per slot, so memory stays O(Q V) (the jnp form's [Q, V, D] gather
    does not fit at the 10^6 graph's core); min is exact and
    order-free, so the result is bitwise the same."""
    cand = torch.full_like(dist, float("inf"))
    for j in range(nbr_ids.shape[1]):
        cand = torch.minimum(
            cand, dist.index_select(1, nbr_ids[:, j]) + nbr_w[:, j])
    return torch.minimum(dist, cand)


def fused_relax_ref(dist, nbr_ids, nbr_w, max_rounds: int, bq: int = 8):
    """All rounds, each block of ``bq`` rows to its own fixed point or
    ``max_rounds``. Returns (dist [Q, V], rounds int32[Q // bq]). A block
    at its fixed point is unchanged by further rounds, so the batch runs
    as one matrix and only the round counts are kept per block."""
    q, v = dist.shape
    nb = q // bq
    rounds = torch.zeros(nb, dtype=torch.int32, device=dist.device)
    active = torch.full((nb,), max_rounds > 0, dtype=torch.bool,
                        device=dist.device)
    d = dist
    for _ in range(max_rounds):
        d2 = spmv_relax_ref(d, nbr_ids, nbr_w)
        rounds += active
        active &= (d2 < d).view(nb, bq * v).any(1)
        d = d2
        if not bool(active.any()):
            break
    return d, rounds
