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
mesh path; this module says where each array lives, and ``ModelCall``
how a model call on one rank reads its parameters from there.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

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


def from_local(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """This rank's shard ``x`` as the DTensor laid out by ``sharding``
    (nothing moves)."""
    return DTensor.from_local(x, sharding.mesh, sharding.placements,
                              run_check=False)


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


@dataclasses.dataclass(frozen=True)
class ModelCall:
    """How a model call runs on this rank of a mesh step: the models'
    ``dist`` argument (``models/transformer.py``, ``models/moe.py``).
    ``dp`` are the mesh axes the call's batch is split over (empty:
    every rank runs the whole batch); an MoE routes its shard as part of
    the whole batch over them.

    The model receives its parameters as DTensors laid out by the rules
    and reads each one whole where it uses it (``whole``: FSDP's
    all-gather, per layer for a stacked LM), so only the parameters in
    use are whole at a time. Under autograd the gradient of ``whole``
    comes back as this rank's contribution summed over ``dp`` into the
    parameter's layout (a reduce-scatter where the layout shards it, an
    all-reduce where it does not): a sum, which the step divides by the
    number of batch shards."""
    mesh: object
    dp: tuple = ()

    def whole(self, p):
        """Parameter ``p`` whole as a plain tensor (a plain ``p`` as it
        is; the class docstring)."""
        if not isinstance(p, DTensor):
            return p
        grad = tuple(Partial() if a in self.dp else Replicate()
                     for a in self.mesh.mesh_dim_names)
        return p.redistribute(self.mesh, [Replicate()] * self.mesh.ndim) \
            .to_local(grad_placements=grad)

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
        stride = torch.empty(shape, device="meta").stride()
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
