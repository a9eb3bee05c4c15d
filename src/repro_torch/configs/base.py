"""ArchSpec: binds an architecture config to its shape set and input
specs — the port's copy of ``repro.configs.base``.

``input_specs`` returns ``TensorSpec(shape, dtype)`` pairs (torch
dtypes) where ``repro`` returns ``jax.ShapeDtypeStruct``s, with the
same ``r512`` padding, for all four families.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.configs import shapes as SH


class TensorSpec(NamedTuple):
    shape: tuple
    dtype: torch.dtype


def sds(shape, dtype) -> TensorSpec:
    return TensorSpec(tuple(int(x) for x in shape), dtype)


def r512(x: int) -> int:
    """Round up to a multiple of 512 (``repro``'s lcm of every mesh size
    it shards over), so the port's arrays have ``repro``'s shapes."""
    return -(-int(x) // 512) * 512


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # lm | gnn | recsys | graph_index
    model_cfg: Any
    shapes: dict
    optimizer: str = "adamw"          # adamw | adafactor
    smoke_cfg_fn: Callable | None = None
    notes: str = ""
    fsdp_over_pod: bool = False       # 1T-class models: FSDP across pods
    param_dtype: str = "float32"

    def shape(self, name: str):
        return self.shapes[name]

    def input_specs(self, shape_name: str) -> dict:
        shp = self.shapes[shape_name]
        if self.family == "lm":
            return lm_input_specs(self.model_cfg, shp)
        if self.family == "gnn":
            return gnn_input_specs(self.model_cfg, shp)
        if self.family == "recsys":
            return recsys_input_specs(self.model_cfg, shp)
        if self.family == "graph_index":
            return islabel_input_specs(self.model_cfg, shp)
        raise KeyError(self.family)

    def runnable_cells(self):
        """Shape names that apply to this arch (assignment skip rules)."""
        out = []
        for name, shp in self.shapes.items():
            if getattr(shp, "subquadratic_required", False) \
                    and self.family == "lm":
                continue   # pure full-attention archs skip long_500k
            out.append(name)
        return out


# ----------------------------------------------------------------- LM specs
def lm_input_specs(cfg, shp: SH.LMShape) -> dict:
    b, s = shp.global_batch, shp.seq_len
    if shp.kind == "train":
        return {"tokens": sds((b, s), torch.int32),
                "targets": sds((b, s), torch.int32)}
    if shp.kind == "prefill":
        return {"tokens": sds((b, s), torch.int32)}
    if shp.kind == "decode":
        kv = sds((cfg.n_layers, b, s, cfg.n_kv_heads, cfg.hd), torch.bfloat16)
        return {"cache": {"k": kv, "v": kv, "len": sds((), torch.int32)},
                "last_tokens": sds((b, 1), torch.int32)}
    raise KeyError(shp.kind)


# ---------------------------------------------------------------- GNN specs
def gnn_minibatch_dims(shp: SH.GNNShape):
    """Padded sampled-subgraph dims for minibatch shapes."""
    b = shp.batch_nodes
    f1, f2 = shp.fanout
    n_sub = b * (1 + f1 + f1 * f2) + 1
    e_sub = 2 * (b * f1 + b * f1 * f2)
    return n_sub, e_sub


def gnn_input_specs(cfg, shp: SH.GNNShape) -> dict:
    need_coords = type(cfg).__name__ in ("EGNNConfig", "DimeNetConfig")
    if shp.kind == "full":
        n1, e = r512(shp.n_nodes + 1), r512(2 * shp.n_edges)
    elif shp.kind == "minibatch":
        n1, e = gnn_minibatch_dims(shp)
        n1, e = r512(n1), r512(e)
    elif shp.kind == "molecule":
        n1 = r512(shp.batch_graphs * shp.n_nodes + 1)
        e = r512(2 * shp.batch_graphs * shp.n_edges)
    else:
        raise KeyError(shp.kind)
    d = {"feats": sds((n1, shp.d_feat), torch.float32),
         "edge_src": sds((e,), torch.int32),
         "edge_dst": sds((e,), torch.int32),
         "deg": sds((n1,), torch.float32)}
    if shp.kind == "molecule":
        d["graph_ids"] = sds((n1,), torch.int32)
        d["targets"] = sds((shp.batch_graphs,), torch.float32)
    else:
        d["labels"] = sds((n1,), torch.int32)
        d["mask"] = sds((n1,), torch.float32)
    if need_coords:
        d["coords"] = sds((n1, 3), torch.float32)
    if type(cfg).__name__ == "DimeNetConfig":
        t_cap = min(r512(4 * e), 1 << 28)   # capped triplet list (DESIGN §4)
        d["trip_kj"] = sds((t_cap,), torch.int32)
        d["trip_ji"] = sds((t_cap,), torch.int32)
        d["atom_z"] = sds((n1,), torch.int32)
    return d


# ------------------------------------------------------------- recsys specs
def recsys_input_specs(cfg, shp: SH.RecShape) -> dict:
    b, s = shp.batch, cfg.seq_len
    d = {"user": sds((b,), torch.int32),
         "hist_items": sds((b, s), torch.int32),
         "hist_cats": sds((b, s), torch.int32),
         "hist_mask": sds((b, s), torch.float32),
         "target_item": sds((b,), torch.int32),
         "target_cat": sds((b,), torch.int32)}
    if shp.kind == "train":
        d["label"] = sds((b,), torch.int32)
    if shp.kind == "retrieval":
        # 1M candidates padded with r512 (repro: "to 2^20 for even
        # sharding"; r512 gives 1,000,448)
        d["cand_items"] = sds((r512(shp.n_candidates),), torch.int32)
    return d


# ----------------------------------------------------- IS-LABEL (the paper)
def islabel_input_specs(cfg, shp: SH.IndexShape) -> dict:
    if shp.kind == "query":
        nrows = r512(shp.n_vertices + 1)
        return {"lbl_ids": sds((nrows, shp.l_cap), torch.int32),
                "lbl_d": sds((nrows, shp.l_cap), torch.float32),
                "core_pos": sds((nrows,), torch.int32),
                "ce_src": sds((shp.core_edges,), torch.int32),
                "ce_dst": sds((shp.core_edges,), torch.int32),
                "ce_w": sds((shp.core_edges,), torch.float32),
                "s": sds((shp.q_batch,), torch.int32),
                "t": sds((shp.q_batch,), torch.int32)}
    if shp.kind == "build_level":
        return {"src": sds((shp.e_cap,), torch.int32),
                "dst": sds((shp.e_cap,), torch.int32),
                "w": sds((shp.e_cap,), torch.float32),
                "via": sds((shp.e_cap,), torch.int32),
                "active": sds((shp.n_vertices,), torch.bool)}
    raise KeyError(shp.kind)
