"""Embedding tables + EmbeddingBag: the port of ``repro.models.embedding``
on one card.

``lookup`` reads rows as ``jnp.take(table, ids, axis=0)`` does: an id in
[-n, 0) counts from the end, and any other id outside [0, n) reads a row
of NaN (its gradient is dropped). The ids are mapped into [0, n) before
``index_select`` (which raises on ids past the table, and whose backward
is an ``index_add_``), and the rows of out-of-range ids are filled
afterwards.

On a mesh whose ``model`` axis shards a table's rows in contiguous
blocks (``repro``'s ``RECSYS_RULES``), ``lookup_split`` reads ids that
every ``model`` rank holds alike: each rank gathers the rows its block
holds, 0 for the rest, and the rows are summed over ``model`` (the
LM's vocabulary-parallel embedding, ``models/transformer.py``); the
gradient is this rank's block's ``index_add_``, and no rank holds the
whole table or its whole gradient. ``lookup_owned`` reads ids that are
themselves split over ``model`` (retrieval's candidates): the ids of a
``model`` group are all-gathered, each rank reads its rows, and the
rows are reduce-scattered back to the ranks that hold the ids. Both
keep ``lookup``'s rule.

``lookup_mod_sharded`` is ``repro``'s explicit mod-sharded lookup over a
mesh axis: row r lives on shard r % S at local index r // S; each shard
looks up the rows it owns (``lookup``'s rule on its local block), zeroes
the rest, and one ``all_reduce(SUM)`` over the axis's group combines
them. It keeps what ``repro``'s form returns (read in ``repro`` on 2
host devices): the table's rows are sharded in contiguous blocks, so on
a table in natural order id r reads row (r % S) · n/S + r // S; ``%``
and ``//`` floor, so a negative id reads the local row that wraps from
the end of its owner's block; an id whose local index falls outside
[-n/S, n/S) reads NaN.
"""
from __future__ import annotations

import torch
from torch import nn

from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import contiguous_stride
from repro_torch.graphs import segment_ops as sops


def init_table(generator: torch.Generator, n_rows: int, dim: int,
               scale: float = 0.01) -> dict:
    """``{"table": N(0, 1) * scale}`` [n_rows, dim], drawn on the
    generator's device (a 2^26-row table is drawn on the card)."""
    return {"table": torch.randn((n_rows, dim), generator=generator,
                                 device=generator.device) * scale}


def table_axes() -> dict:
    return {"table": ("table_rows", "table_dim")}


class Table(nn.Module):
    """One table, parameter ``table``: ``init_table``'s draw, or
    uninitialised without a generator (a structure for
    ``functional_call``)."""

    def __init__(self, n_rows: int, dim: int, scale: float = 0.01,
                 generator=None):
        super().__init__()
        self.table = nn.Parameter(
            torch.empty((n_rows, dim)) if generator is None
            else init_table(generator, n_rows, dim, scale)["table"])


def lookup(table, ids):
    """[..] int ids -> [.., D] rows, by ``jnp.take``'s rule."""
    n = table.shape[0]
    flat = ids.reshape(-1).long()
    ok = (flat >= -n) & (flat < n)
    rows = torch.where(flat < 0, flat + n, flat).clamp(0, n - 1)
    vals = table.index_select(0, rows)
    vals = torch.where(ok[:, None], vals, float("nan"))
    return vals.reshape(tuple(ids.shape) + (table.shape[1],))


def _block_rows(block, ids, n: int, dist) -> tuple:
    """``(rows, ok)`` of flat ``ids`` over a table of ``n`` rows whose
    ``model`` block on this rank is ``block``: the rows the block holds,
    0 for the others; ``ok`` where an id lies in [-n, n)."""
    if any(a >= b for a, b in (dist.model_range(n, r)
                               for r in range(dist.model_size()))):
        raise ValueError(f"a table of {n} rows leaves a model rank no row")
    lo, hi = dist.model_range(n)
    ok = (ids >= -n) & (ids < n)
    local = torch.where(ids < 0, ids + n, ids) - lo
    mine = ok & (local >= 0) & (local < hi - lo)
    vals = block.index_select(0, torch.where(mine, local, 0))
    return torch.where(mine[:, None], vals, vals.new_zeros(())), ok


def lookup_split(block, ids, n: int, dist):
    """``lookup(table, ids)`` of a table of ``n`` rows from this rank's
    ``model`` block ``block`` (``dist``: a tensor-parallel
    ``distributed.sharding.ModelCall``; ``ids`` the same on every
    ``model`` rank): masked local rows summed over ``model`` (the module
    docstring)."""
    flat = ids.reshape(-1).long()
    vals, ok = _block_rows(block, flat, n, dist)
    vals = torch.where(ok[:, None], dist.from_model(vals), float("nan"))
    return vals.reshape(tuple(ids.shape) + (block.shape[1],))


def lookup_owned(block, ids, n: int, dist):
    """The rows of this rank's ids of ``ids``, a 1-D DTensor of ids split
    over mesh axes that ``model`` is among (each rank's ids its own), by
    ``lookup``'s rule, from this rank's ``model`` block ``block`` of a
    table of ``n`` rows (the module docstring; no gradient)."""
    mesh = dist.mesh
    i = tuple(mesh.mesh_dim_names).index(dist.model)
    group = list(ids.placements)
    group[i] = Replicate()
    rows, _ = _block_rows(block, ids.redistribute(mesh, group).to_local()
                          .long(), n, dist)
    part = list(group)
    part[i] = Partial()
    shape = (ids.shape[0], block.shape[1])
    rows = DTensor.from_local(
        rows, mesh, part, run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape)).redistribute(
        mesh, ids.placements).to_local()
    own = ids.to_local().long()
    return torch.where(((own >= -n) & (own < n))[:, None], rows,
                       float("nan"))


def lookup_mod_sharded(table, ids, mesh, axis: str = "model"):
    """Mod-sharded lookup (the module docstring). ``table``: a DTensor
    sharded on rows over ``axis`` (``Shard(0)``, rows divisible by the
    axis size, as ``repro``'s ``shard_map`` requires), or this rank's block; ``ids``: the same
    [..] ids on every rank. Returns the [.., D] rows on every rank."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    group = mesh.get_group(axis)
    n_shards = dist.get_world_size(group)
    shard = dist.get_rank(group)
    local = table
    if isinstance(table, DTensor):
        if table.shape[0] % n_shards:
            raise ValueError(f"{table.shape[0]} rows do not divide "
                             f"{n_shards} shards")
        local = table.to_local()
    ids = ids.long()
    owner = torch.remainder(ids, n_shards)
    vals = lookup(local, torch.div(ids, n_shards, rounding_mode="floor"))
    vals = torch.where((owner == shard)[..., None], vals, 0.0)
    dist.all_reduce(vals, group=group)
    return vals


def embedding_bag(table, ids, segment_ids, n_bags: int, mode: str = "sum"):
    """Multi-hot bag: ids int32[nnz], segment_ids int32[nnz] -> [n_bags, D].
    Sentinel-padded nnz entries must carry segment_id == n_bags."""
    vals = lookup(table, ids)
    if mode == "sum":
        return sops.segment_sum(vals, segment_ids, n_bags + 1)[:n_bags]
    if mode == "mean":
        return sops.segment_mean(vals, segment_ids, n_bags + 1)[:n_bags]
    out = sops.segment_max(vals, segment_ids, n_bags + 1)[:n_bags]
    return torch.where(torch.isfinite(out), out, 0.0)
