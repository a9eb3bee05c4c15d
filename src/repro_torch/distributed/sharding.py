"""Logical-axis -> mesh-axis sharding rules, per model family — the port
of ``repro.distributed.sharding`` over ``torch.distributed`` DTensors.

Params carry logical axis names (the ``*_axes`` trees of
``models/*.py``, equal to ``repro``'s ``init_*`` trees); the rules below
give each leaf a spec (one mesh axis, a tuple of them, or None per
dim: ``repro``'s ``PartitionSpec`` entries) and a ``NamedSharding`` that
places it as a DTensor: ``Shard(d)`` on every mesh dim that dim ``d``
names, ``Replicate()`` on the others. Conventions, as in ``repro``:

* LM: the ``model`` axis takes heads / ffn / vocab / experts, FSDP over
  ``data`` (the ``embed`` dim of weight matrices), pure DP over ``pod``.
  Batch over (pod, data).
* GNN: edge/node arrays sharded over all mesh axes flattened; model
  params replicated (they are tiny).
* RecSys: embedding-table rows over ``model``; batch over (pod, data);
  dense tower params replicated.
* graph_index (IS-LABEL): label-partition blocks over the 1-D ``shard``
  axis (``repro_torch.shard``); vertex rows, hierarchy levels and the
  core graph replicated.

How the port's step computes on such a state is ``train/steps.py``'s
mesh path; this module says where each array lives, ``ModelCall`` how
a model call on one rank reads its parameters from there, and its
region operators (``torch.autograd.Function``s over the
``_c10d_functional`` collectives, which the dry run traces and counts)
how a rank's part of a split computation joins the others'.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.graphs import segment_ops as sops
from repro_torch.tree import tree_map

LM_RULES = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "experts_router": None,
    "embed": "data",          # FSDP shard of the weight's embed dim
    "layers": None,
}

GNN_RULES = {k: None for k in
             ("gnn_in", "gnn_hidden", "rbf", "sbf", "bilinear",
              "mlp_in", "mlp_out")}

RECSYS_RULES = {
    "table_rows": "model",
    "table_dim": None,
    "gru_in": None, "gru_h": None,
    "mlp_in": None, "mlp_out": None,
}

# IS-LABEL partitioned index (repro_torch.shard.ShardedIndex): label
# blocks are stacked [P, n+1, cap_s] with the leading label-partition
# axis laid over the mesh's "shard" axis; everything else replicated
GRAPH_INDEX_RULES = {
    "label_shard": "shard",   # one label partition per mesh slice
    "vertex": None,           # [n+1] rows: every shard sees all vertices
    "label_slot": None,       # padded per-shard label columns
    "level": None,            # hierarchy levels: replicated
    "core_vertex": None,      # core_pos / seed columns: replicated
    "core_edge": None,        # G_k COO arrays: replicated
}

FAMILY_RULES = {"lm": LM_RULES, "gnn": GNN_RULES, "recsys": RECSYS_RULES,
                "graph_index": GRAPH_INDEX_RULES}


def spec_for_axes(axes: tuple, rules: dict) -> tuple:
    """The mesh axes of each dim (``repro``'s ``PartitionSpec`` entries)."""
    return tuple(rules.get(ax, None) for ax in axes)


def placements(mesh, spec: tuple) -> tuple:
    """DTensor placements for ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that entry ``d`` names (an entry may name several, major
    first, as a ``PartitionSpec`` tuple does), ``Replicate()`` on the
    rest. A spec shorter than the tensor leaves its last dims whole."""
    names = tuple(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for ax in ((entry,) if isinstance(entry, str) else entry or ()):
            if ax not in names:
                raise KeyError(f"mesh {names} has no axis {ax!r}")
            i = names.index(ax)
            if not isinstance(out[i], Replicate):
                raise ValueError(f"mesh axis {ax!r} shards two dims")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``repro``'s ``NamedSharding(mesh, P(*spec))``: where a leaf lives
    (``layout``: explicit DTensor placements instead of a spec).
    ``micro`` > 1 lays a batch out by micro-batch: ``place`` views its
    leading dim ``B`` as ``[micro, B // micro]`` and ``spec`` describes
    that view, so that sharding dim 1 gives each rank its share of
    every micro-batch."""
    mesh: object
    spec: tuple = ()
    layout: tuple | None = None
    micro: int = 1

    @property
    def placements(self) -> tuple:
        if self.layout is not None:
            return tuple(self.layout)
        return placements(self.mesh, self.spec)


def tree_shardings(axes_tree, rules: dict, mesh):
    """Map a logical-axes tree to ``NamedSharding``s."""
    return tree_map(lambda ax: NamedSharding(mesh, spec_for_axes(ax, rules)),
                    axes_tree)


def like_tree(tree, sharding):
    """Uniform sharding for every leaf of a tree."""
    return tree_map(lambda _: sharding, tree)


def opt_state_shardings(opt_name: str, params, param_shardings, mesh):
    """Optimizer state shards exactly like its param (ZeRO); Adafactor's
    factored stats drop the reduced dim from the spec."""
    if opt_name == "adamw":
        return {"mu": param_shardings, "nu": param_shardings}
    assert opt_name == "adafactor"

    def one(p, psh):
        nd = len(p.shape)
        spec = tuple(psh.spec) + (None,) * (nd - len(psh.spec))
        if nd >= 2:
            return {"vr": NamedSharding(mesh, spec[:-1]),
                    "vc": NamedSharding(mesh, spec[:-2] + spec[-1:])}
        return {"v": NamedSharding(mesh, spec)}

    return tree_map(one, params, param_shardings)


def place(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``x`` as a DTensor laid out by ``sharding``. A plain tensor is
    taken as the whole array, the same on every rank (each keeps its own
    chunk; nothing is sent); a DTensor is redistributed."""
    if isinstance(x, DTensor):
        return x.redistribute(sharding.mesh, sharding.placements)
    if sharding.micro > 1:
        x = x.reshape(sharding.micro, x.shape[0] // sharding.micro,
                      *x.shape[1:])
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def place_tree(tree, shardings):
    """``place`` over a tree and its tree of shardings."""
    return tree_map(place, tree, shardings)


def gather(x):
    """A DTensor's whole array as a plain tensor on this rank (the
    redistribution to ``Replicate()`` everywhere: an all-gather where it
    is sharded); a plain tensor unchanged."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          [Replicate()] * x.device_mesh.ndim).to_local()


def local(x):
    """This rank's shard of a DTensor as a plain tensor; a plain tensor
    unchanged."""
    return x.to_local() if isinstance(x, DTensor) else x


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape`` (computed, not
    read off an allocation: the dry run counts a meta tensor's bytes)."""
    stride, n = [], 1
    for d in reversed(tuple(shape)):
        stride.append(n)
        n *= max(d, 1)
    return tuple(reversed(stride))


def from_local(x: torch.Tensor, sharding: NamedSharding,
               shape=None) -> DTensor:
    """This rank's shard ``x`` as the DTensor laid out by ``sharding``
    (nothing moves); ``shape``: the global shape, needed where the
    blocks are uneven."""
    kw = {}
    if shape is not None:
        kw = dict(shape=torch.Size(shape), stride=contiguous_stride(shape))
    return DTensor.from_local(x, sharding.mesh, sharding.placements,
                              run_check=False, **kw)


def sum_to(x: torch.Tensor, mesh, axes: tuple, n: int, layout) -> DTensor:
    """The mean over the ranks of ``axes`` (``n`` of them) of each rank's
    ``x``, laid out as ``layout`` (placements): ``x / n`` as a
    ``Partial`` sum over ``axes`` redistributed (a reduce-scatter along
    a mesh dim ``layout`` shards, an all-reduce along one it
    replicates). With ``axes`` empty ``x`` is taken as the same on every
    rank."""
    if n > 1:
        x = x / n
    names = tuple(mesh.mesh_dim_names)
    start = tuple(Partial() if a in axes else Replicate() for a in names)
    return DTensor.from_local(x, mesh, start, run_check=False).redistribute(
        mesh, layout)


def mean_over(x: torch.Tensor, mesh, axes: tuple, n: int) -> torch.Tensor:
    """The mean over the ranks of ``axes`` of each rank's ``x``, as a
    plain tensor on every rank."""
    if not axes:
        return x
    names = tuple(mesh.mesh_dim_names)
    return sum_to(x, mesh, axes, n,
                  tuple(Replicate() for _ in names)).to_local()


# ------------------------------------------------ tensor-parallel regions
def _c10d():
    return torch.ops._c10d_functional


def all_reduce(x, group, op: str = "sum"):
    """``x`` reduced over ``group`` (``"sum"`` or ``"max"``), on every
    rank; no gradient."""
    c = _c10d()
    return c.wait_tensor(c.all_reduce(x.contiguous(), op, group.group_name))


def all_gather(x, group, n: int, dim: int = 0):
    """The ``n`` ranks' ``x`` of ``group`` concatenated along ``dim`` in
    rank order; no gradient."""
    c = _c10d()
    out = c.wait_tensor(c.all_gather_into_tensor(
        x.movedim(dim, 0).contiguous(), n, group.group_name))
    return out.movedim(0, dim)


def reduce_scatter(x, group, n: int, dim: int = 0, op: str = "sum"):
    """This rank's block along ``dim`` (of ``n`` equal blocks) of the
    ranks' ``x`` reduced (``"sum"`` or ``"max"``); no gradient."""
    c = _c10d()
    out = c.wait_tensor(c.reduce_scatter_tensor(
        x.movedim(dim, 0).contiguous(), op, n, group.group_name))
    return out.movedim(0, dim)


class _ToModel(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated input entering
    a region where each rank computes a part (its gradient is the sum
    of the parts' gradients)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    """All-reduce forward, identity backward: the ranks' partial results
    summed into the replicated one."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    """All-gather forward along ``dim``, reduce-scatter backward: each
    rank's block entering a region where each rank computes a part."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return all_gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.n, ctx.dim), None, None, None


class _Scatter(torch.autograd.Function):
    """Reduce-scatter forward along ``dim``, all-gather backward: the
    ranks' partial arrays summed, each rank keeping its block."""

    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.group, ctx.n, ctx.dim = group, n, dim
        return reduce_scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather(g, ctx.group, ctx.n, ctx.dim), None, None, None


def chunk_range(n: int, parts: int, index: int) -> tuple:
    """Block ``index`` of ``n`` rows cut into ``parts`` by ``Shard``'s
    rule (``torch.chunk``: blocks of ceil(n / parts), the last ones
    shorter or empty), as ``(start, stop)``."""
    chunk = -(-n // parts)
    start = min(index * chunk, n)
    return start, min(start + chunk, n)


@dataclasses.dataclass(frozen=True)
class ModelCall:
    """How a model call runs on this rank of a mesh step: the models'
    ``dist`` argument (``models/transformer.py``, ``models/moe.py``,
    ``models/attention.py``, ``models/dien.py``; a GNN's ``GraphSplit``
    holds one). ``dp`` are the mesh axes the call's batch is split over
    (empty: every rank runs the whole batch); an MoE routes its shard as
    part of the whole batch over them, a GNN's node and edge arrays are
    split in row blocks over every axis. ``model`` is the mesh axis the
    model's compute is split over (``repro``'s tensor, vocabulary and
    expert parallelism, DIEN's tables by row block; ``tp``), or None,
    the GNNs' call only: every rank computes the whole model on its part
    of the batch. Under ``compress_pods`` ``dp`` leaves ``pod`` out: each pod
    is a step of its own (``distributed/compression``).

    The model receives its parameters as DTensors laid out by the rules
    and reads each one where it uses it, per layer for a stacked LM:

    * ``whole``: every axis gathered (FSDP's all-gather), for what every
      rank of a ``model`` group computes alike (norms, routers, DIEN's
      towers, the GNN parameters). Its gradient is taken as the same on
      every ``model`` rank.
    * ``shard``: the FSDP axes gathered, this rank's ``model`` block
      left in place (a column or row block of a tensor-parallel matrix,
      a vocabulary block, an expert block, a block of a DIEN table's
      rows). Its gradient is this rank's block's.
    * ``gathered``: every axis gathered for a rank that uses a part of
      it only (the KV projections, query heads not aligned with the
      blocks: ``models/attention.py``). Its gradient is summed over the
      ``model`` ranks.

    Under autograd the gradient of each read comes back as this rank's
    contribution summed over ``dp`` into the parameter's layout (a
    reduce-scatter where the layout shards it, an all-reduce where it
    does not): a sum, which the step divides by the number of batch
    shards (a loss over the whole batch, ``total``'s, is divided by
    nothing). A mesh axis outside ``dp`` and ``model`` keeps its
    placement in the gradient: with ``compress_pods`` that says
    replicated over ``pod`` while the value is this pod's, so the step
    takes the gradient's local block before anything reads it as a
    DTensor. The region operators (``to_model``, ``from_model``,
    ``gather_model``; ``scatter_dp``, ``gather_dp``, ``total``,
    ``roll_dp`` over the batch axes) carry activations into and out of
    the parts."""
    mesh: object
    dp: tuple = ()
    model: str | None = "model"

    @property
    def tp(self) -> bool:
        """Whether the model's compute is split over ``model``."""
        return self.model is not None

    def _read(self, p, keep_model: bool, model_grad):
        if not isinstance(p, DTensor):
            raise TypeError("a mesh model call reads DTensor parameters")
        names = tuple(self.mesh.mesh_dim_names)
        layout = tuple(pl if keep_model and a == self.model else Replicate()
                       for a, pl in zip(names, p.placements))
        grad = tuple(Partial() if a in self.dp else
                     (layout[i] if model_grad is None else model_grad)
                     if a == self.model else
                     layout[i] for i, a in enumerate(names))
        return p.redistribute(self.mesh, layout).to_local(
            grad_placements=grad)

    def whole(self, p):
        """Parameter ``p`` whole as a plain tensor (a plain ``p`` as it
        is; the class docstring)."""
        if not isinstance(p, DTensor):
            return p
        return self._read(p, False, Replicate())

    def shard(self, p):
        """This rank's ``model`` block of ``p`` (the class docstring)."""
        return self._read(p, True, None)

    def gathered(self, p):
        """``p`` whole for a rank that uses a part (the class
        docstring)."""
        return self._read(p, False, Partial())

    def model_dim(self, p):
        """The dim of DTensor ``p`` that ``model`` shards, or None."""
        i = tuple(self.mesh.mesh_dim_names).index(self.model)
        pl = p.placements[i]
        return pl.dim if isinstance(pl, Shard) else None

    def model_group(self):
        return self.mesh.get_group(self.model)

    def model_size(self) -> int:
        return self.mesh.size(tuple(self.mesh.mesh_dim_names).index(
            self.model))

    def model_rank(self) -> int:
        return self.mesh.get_local_rank(self.model)

    def model_range(self, n: int, rank: int | None = None) -> tuple:
        """``(start, stop)`` of this rank's (or ``rank``'s) ``model``
        block of a dim of ``n`` (``chunk_range``)."""
        return chunk_range(n, self.model_size(),
                           self.model_rank() if rank is None else rank)

    def to_model(self, x):
        """``x`` (the same on every ``model`` rank) entering a split
        region: identity forward, all-reduce backward."""
        return _ToModel.apply(x, self.model_group())

    def from_model(self, x):
        """The ``model`` ranks' partial ``x`` summed: all-reduce forward,
        identity backward."""
        return _AllReduce.apply(x, self.model_group())

    def gather_model(self, x, dim: int = 0):
        """The ``model`` ranks' blocks of ``x`` concatenated along
        ``dim``: all-gather forward, reduce-scatter backward."""
        return _Gather.apply(x, self.model_group(), self.model_size(), dim)

    def _dp_groups(self) -> list:
        names = tuple(self.mesh.mesh_dim_names)
        return [(self.mesh.get_group(a), self.mesh.size(names.index(a)))
                for a in self.dp]

    def scatter_dp(self, x, dim: int):
        """The sum over the batch shards of each one's ``x``, this rank's
        block of it along ``dim`` (blocks in the batch's shard order):
        reduce-scatter forward over each ``dp`` axis, major first;
        all-gather backward. ``x.shape[dim]`` must divide evenly."""
        for group, n in self._dp_groups():
            x = _Scatter.apply(x, group, n, dim)
        return x

    def gather_dp(self, x, dim: int):
        """``scatter_dp``'s inverse layout: every batch shard's block of
        ``x`` along ``dim``, concatenated (all-gather forward,
        reduce-scatter backward)."""
        for group, n in reversed(self._dp_groups()):
            x = _Gather.apply(x, group, n, dim)
        return x

    def total(self, x):
        """The sum over the ``dp`` ranks of each one's ``x``, on every
        rank: all-reduce forward over each ``dp`` axis, identity backward
        (a rank's part of a loss over the whole batch: its gradient
        reaches the rank's own terms only)."""
        for group, _ in self._dp_groups():
            x = _AllReduce.apply(x, group)
        return x

    def roll_dp(self, x):
        """``torch.roll(x, 1, 0)`` of the whole batch that the ``dp`` axes
        split in equal blocks (``x``: this rank's): the first row is the
        previous shard's last (every shard's last row all-gathered; its
        gradient goes back to its shard)."""
        count, index = self.shard_index()
        if count == 1:
            return torch.roll(x, 1, 0)
        last = self.gather_dp(x[-1:], 0)
        return torch.cat([last[(index - 1) % count][None], x[:-1]], 0)

    def max_over_model(self, x):
        """The elementwise max over the ``model`` ranks; no gradient."""
        return all_reduce(x.detach(), self.model_group(), "max")

    def unstack(self, p) -> list:
        """The layers of stacked parameter ``p`` (its leading dim, which
        the rules never shard): ``unbind(0)`` of a plain ``p``; of a
        DTensor, each layer's slice of this rank's shard as the DTensor
        of that layer (nothing moves)."""
        if not isinstance(p, DTensor):
            return p.unbind(0)
        if any(isinstance(pl, Shard) and pl.dim == 0 for pl in p.placements):
            raise ValueError("a stacked parameter sharded over its layers")
        layer = tuple(Shard(pl.dim - 1) if isinstance(pl, Shard) else pl
                      for pl in p.placements)
        shape = p.shape[1:]
        stride = contiguous_stride(shape)
        return [DTensor.from_local(c, self.mesh, layer, run_check=False,
                                   shape=shape, stride=stride)
                for c in p.to_local().unbind(0)]

    def shard_index(self) -> tuple:
        """(the number of batch shards, this rank's index among them in
        the batch's shard order: mesh dims in order, major first)."""
        coord, count, index = self.mesh.get_coordinate(), 1, 0
        for i, a in enumerate(self.mesh.mesh_dim_names):
            if a in self.dp:
                count *= self.mesh.size(i)
                index = index * self.mesh.size(i) + coord[i]
        return count, index

    def all_shards(self, x: torch.Tensor) -> torch.Tensor:
        """[count, *x.shape]: every batch shard's ``x`` in shard order
        (an all-gather over ``dp``; no gradient)."""
        layout = [Shard(0) if a in self.dp else Replicate()
                  for a in self.mesh.mesh_dim_names]
        return DTensor.from_local(x.detach()[None], self.mesh, layout,
                                  run_check=False).full_tensor()


@dataclasses.dataclass(frozen=True)
class GraphSplit:
    """A GNN batch as its model call sees it: ``nodes`` rows of every
    node array, ``edges`` rows of every edge array. On a mesh
    (``call``: a ``ModelCall`` whose ``dp`` is every mesh axis, as
    ``repro``'s ``GNN_RULES`` lay the batch out) this rank holds one
    contiguous block of each node, edge and triplet array (``Shard(0)``
    on every axis, major first; the arrays are padded to a multiple of
    512, so the blocks are equal), the edge and triplet ids global. A
    layer that reads rows by edge gathers the node (or, DimeNet's
    triplets, edge) array whole (``whole``: ``ModelCall.gather_dp``),
    computes its own edges' messages, and sums them into a partial of
    whole rows that ``to_block`` reduce-scatters back to this rank's
    block (``scatter_dp``); ``total`` sums a loss's terms over the
    ranks. Off a mesh (``call`` None) each of these is the identity;
    ``whole`` returns a view, so autograd sums a read's gradients before
    adding them to the array's other uses' as it does past the mesh's
    gather (at one rank the mesh step is then bitwise the unsharded
    one). ``segment_max`` is the max aggregator's form of ``to_block``
    (``_SegmentMax``)."""
    nodes: int
    edges: int
    call: ModelCall | None = None

    def __post_init__(self):
        if self.call is not None:
            count = self.call.shard_index()[0]
            if self.nodes % count or self.edges % count:
                raise ValueError(f"{self.nodes} nodes and {self.edges} "
                                 f"edges do not split into {count} equal "
                                 "blocks")

    def whole(self, x):
        return x.view_as(x) if self.call is None else self.call.gather_dp(
            x, 0)

    def to_block(self, x):
        return x if self.call is None else self.call.scatter_dp(x, 0)

    def total(self, x):
        return x if self.call is None else self.call.total(x)

    def segment_max(self, msg, seg):
        """``segment_max`` of this rank's edges' ``msg`` [E, d] into node
        rows ``seg``, this rank's node block of the max over every rank's
        edges (empty rows the lowest value); off a mesh the unsharded
        ``segment_ops.segment_max``."""
        if self.call is None:
            return sops.segment_max(msg, seg, self.nodes)
        return _SegmentMax.apply(msg, seg, self)


class _SegmentMax(torch.autograd.Function):
    """A ``GraphSplit``'s segment max: each rank's ``[nodes, d]`` partial
    of its own edges (``scatter_reduce("amax")`` onto the lowest value),
    reduce-scattered by ``MAX`` to node blocks. The backward is the
    unsharded ``scatter_reduce`` backward: each row's gradient split
    evenly among the messages equal to its max, the tie count summed
    over every rank's edges (a tie can span ranks), so an edge's
    message gets ``mask * (g / count)[seg]`` as off the mesh, bitwise."""

    @staticmethod
    def forward(ctx, msg, seg, split):
        ctx.split = split
        out = sops.segment_max(msg, seg, split.nodes)
        for group, n in split.call._dp_groups():     # scatter_dp's order
            out = reduce_scatter(out, group, n, 0, "max")
        ctx.save_for_backward(msg, seg, out)
        return out

    @staticmethod
    def backward(ctx, g):
        # the region operators run their forwards here (no grad mode)
        msg, seg, out = ctx.saved_tensors
        call, nodes = ctx.split.call, ctx.split.nodes
        mx = call.gather_dp(out, 0)                         # [nodes, d]
        idx = seg.long().view(-1, *([1] * (msg.dim() - 1))).expand_as(msg)
        mask = (msg == mx.gather(0, idx)).to(msg.dtype)
        # the unsharded count starts from the fill's own ties (an empty
        # row's -inf)
        count = (mx == float("-inf")).to(msg.dtype) + call.total(
            sops.segment_sum(mask, seg, nodes))
        share = call.gather_dp(g, 0) / count
        return mask * share.gather(0, idx), None, None


def tp(dist) -> bool:
    """Whether a model call splits its compute over ``model`` (a mesh
    call with a ``model`` axis: an LM's, ``compress_pods``'s too)."""
    return dist is not None and dist.tp
