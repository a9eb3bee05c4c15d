"""Plain PyTorch versions of the label-intersect kernels: μ via a per-row
searchsorted merge (the same math as ``repro``'s jnp reference), and the
packed variant over delta16 rows, decoded first with the torch decoders
of ``core/labels.py``. Like the kernels, each takes optional row ids
``idx_s`` / ``idx_t``: the rows are then gathered from the planes
first, which is the same function. Row ids map as ``repro`` maps them
(``row_index``)."""
import torch

from repro_torch.core.labels import decode_d, decode_ids, row_index


def _gather(idx, *planes):
    """Rows ``idx`` of each plane (all of them when ``idx`` is None)."""
    if idx is None:
        return planes
    idx = row_index(idx, planes[0].shape[0])
    return tuple(p[idx] for p in planes)


def label_intersect_ref(ids_s, d_s, ids_t, d_t, n_sentinel: int,
                        idx_s=None, idx_t=None):
    ids_s, d_s = _gather(idx_s, ids_s, d_s)
    ids_t, d_t = _gather(idx_t, ids_t, d_t)
    pos = torch.searchsorted(ids_t, ids_s)
    pos_c = pos.clamp(max=ids_t.shape[1] - 1)
    hit = (ids_t.gather(1, pos_c) == ids_s) & (ids_s < n_sentinel)
    tot = torch.where(hit, d_s + d_t.gather(1, pos_c), float("inf"))
    return tot.amin(1)


def label_intersect_packed_ref(delta_s, base_s, d_s, delta_t, base_t, d_t,
                               n_sentinel: int, idx_s=None, idx_t=None):
    delta_s, base_s, d_s = _gather(idx_s, delta_s, base_s, d_s)
    delta_t, base_t, d_t = _gather(idx_t, delta_t, base_t, d_t)
    return label_intersect_ref(decode_ids(delta_s, base_s, n_sentinel),
                               decode_d(d_s),
                               decode_ids(delta_t, base_t, n_sentinel),
                               decode_d(d_t), n_sentinel)
