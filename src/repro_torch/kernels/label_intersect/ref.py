"""Plain PyTorch version of the label-intersect kernel: μ via a per-row
searchsorted merge (the same math as ``repro``'s jnp reference)."""
import torch


def label_intersect_ref(ids_s, d_s, ids_t, d_t, n_sentinel: int):
    pos = torch.searchsorted(ids_t, ids_s)
    pos_c = pos.clamp(max=ids_t.shape[1] - 1)
    hit = (ids_t.gather(1, pos_c) == ids_s) & (ids_s < n_sentinel)
    tot = torch.where(hit, d_s + d_t.gather(1, pos_c), float("inf"))
    return tot.amin(1)
