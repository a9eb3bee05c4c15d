"""DIEN — Deep Interest Evolution Network (arXiv:1809.03672): the port of
``repro.models.dien`` on one card.

Structure per the paper: sparse embeddings (item + category + user
profile) -> interest *extraction* GRU over the behavior sequence (with
the auxiliary next-behavior loss) -> interest *evolution* AUGRU (GRU
whose update gate is scaled by attention against the target item) ->
MLP head [200, 80] -> CTR logit.

``repro``'s two ``lax.scan``s over time are Python loops over
``seq_len`` here (eager torch; autograd keeps each step's activations,
as the scan's backward does). ``DIEN``'s parameter names are
``repro``'s tree paths (``item.table``, ``gru1.wz``, ``augru.bh``,
``att.l0.w``, ``head.l2.b``). ``jnp.clip`` on a parameter-dependent
value is ``torch.minimum(torch.maximum(x, lo), hi)``: both split a tie's
gradient in half, where ``torch.clamp`` passes it whole.

On a mesh (``dist``, a ``distributed.sharding.ModelCall``) each table
parameter is this rank's ``model`` block of rows, read by
``embedding.lookup_split`` (``lookup_owned`` for retrieval's
candidates); the towers run on this rank's batch shard. The loss is the
whole batch's: its sums (the cross-entropy's and the auxiliary loss's
terms and mask) are summed over the batch shards (``ModelCall.total``),
and the auxiliary loss's negatives roll over the whole batch
(``ModelCall.roll_dp``).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.func import functional_call
from torch.nn import functional as F

from repro_torch.distributed import sharding as SHD
from repro_torch.models import layers as L
from repro_torch.models.embedding import (Table, lookup, lookup_owned,
                                          lookup_split, table_axes)


@dataclasses.dataclass(frozen=True)
class DIENConfig:
    name: str
    embed_dim: int = 18
    seq_len: int = 100
    gru_dim: int = 108
    mlp_dims: tuple = (200, 80)
    n_items: int = 1 << 26       # 67M rows — recsys-scale sparse table
    n_cats: int = 10000
    n_users: int = 1 << 22
    aux_weight: float = 1.0

    @property
    def d_behavior(self) -> int:      # item + category embedding concat
        return 2 * self.embed_dim


def gru_axes(prefix: str = "gru") -> dict:
    a = {w: (f"{prefix}_in", f"{prefix}_h") for w in ("wz", "wr", "wh")}
    a.update({b: (f"{prefix}_h",) for b in ("bz", "br", "bh")})
    return a


def dien_axes(cfg: DIENConfig) -> dict:
    """``repro``'s ``init_dien`` axes: the tables' rows on their own
    axis (``table_rows``), the towers replicated."""
    return {"item": table_axes(), "cat": table_axes(), "user": table_axes(),
            "gru1": gru_axes(), "augru": gru_axes(), "att": L.mlp_axes(2),
            "head": L.mlp_axes(3)}


class GRU(nn.Module):
    """``repro``'s ``_init_gru`` parameters (``wz``, ``wr``, ``wh``
    [d_in + d_h, d_h]; ``bz``, ``br``, ``bh`` zeros) and ``_gru_cell``."""

    def __init__(self, d_in: int, d_h: int, generator=None):
        super().__init__()
        for name in ("wz", "wr", "wh"):
            setattr(self, name, L._dense_init((d_in + d_h, d_h), generator))
        for name in ("bz", "br", "bh"):
            setattr(self, name, nn.Parameter(torch.zeros(d_h)))

    def forward(self, x, h, att=None):
        xh = torch.cat([x, h], -1)
        z = torch.sigmoid(xh @ self.wz + self.bz)
        r = torch.sigmoid(xh @ self.wr + self.br)
        hc = torch.tanh(torch.cat([x, r * h], -1) @ self.wh + self.bh)
        if att is not None:                  # AUGRU: attentional update gate
            z = z * att[:, None]
        return (1 - z) * h + z * hc


def _clip(x, lo: float, hi: float):
    # new_full fills on the device: no host copy, no sync
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


class DIEN(nn.Module):
    """Built without a generator it is a structure for
    ``torch.func.functional_call``; with one, every parameter is drawn
    on the generator's device in ``repro``'s order and at its scale
    (other values than ``jax.random``'s)."""

    def __init__(self, cfg: DIENConfig, generator=None):
        super().__init__()
        self.cfg = cfg
        self.item = Table(cfg.n_items, cfg.embed_dim, generator=generator)
        self.cat = Table(cfg.n_cats, cfg.embed_dim, generator=generator)
        self.user = Table(cfg.n_users, cfg.embed_dim, generator=generator)
        self.gru1 = GRU(cfg.d_behavior, cfg.gru_dim, generator)
        self.augru = GRU(cfg.gru_dim, cfg.gru_dim, generator)
        self.att = L.MLP([2 * cfg.gru_dim + cfg.d_behavior, 80, 1],
                         generator=generator)
        d_head = cfg.gru_dim + 2 * cfg.d_behavior + cfg.embed_dim
        self.head = L.MLP([d_head, cfg.mlp_dims[0], cfg.mlp_dims[1], 1],
                          generator=generator)

    def rows(self, name: str, ids, dist=None):
        """``lookup`` in table ``name`` (``item``, ``cat``, ``user``); on a
        mesh the parameter is this rank's ``model`` block of rows."""
        table = getattr(self, name).table
        if not SHD.tp(dist):
            return lookup(table, ids)
        n = {"item": self.cfg.n_items, "cat": self.cfg.n_cats,
             "user": self.cfg.n_users}[name]
        return lookup_split(table, ids, n, dist)

    def behavior_embed(self, item_ids, cat_ids, dist=None):
        return torch.cat([self.rows("item", item_ids, dist),
                          self.rows("cat", cat_ids, dist)], -1)

    def forward(self, batch, kind: str = "train", dist=None):
        """batch: user int32[B], hist_items int32[B,S], hist_cats [B,S],
        hist_mask f32[B,S], target_item [B], target_cat [B]. ``kind``
        "train": (logit [B], aux_loss); "serve": the logit alone (the
        auxiliary loss, which ``repro``'s jitted serve step drops, is not
        computed); "retrieval": ``retrieval_scores`` [B, C] against
        ``batch["cand_items"]``. ``dist``: the mesh's ``ModelCall`` (the
        module docstring)."""
        if kind == "retrieval":
            return self.retrieval_scores(batch, dist)
        cfg = self.cfg
        total = (lambda x: x) if dist is None else dist.total
        hist = self.behavior_embed(batch["hist_items"], batch["hist_cats"],
                                   dist)
        mask = batch["hist_mask"]
        target = self.behavior_embed(batch["target_item"],
                                     batch["target_cat"], dist)
        user = self.rows("user", batch["user"], dist)

        # ---- interest extraction GRU (repro's first scan) ---------------
        # the scans read time steps through unbind: its backward stacks
        # the steps' gradients once, where x[:, t]'s fills a zero tensor
        # of x's whole shape a step (and the sum adds them all)
        h0 = hist.new_zeros((hist.shape[0], cfg.gru_dim))
        m_steps = [m[:, None] for m in mask.unbind(1)]
        h, steps = h0, []
        for x, m in zip(hist.unbind(1), m_steps):
            h = torch.where(m > 0, self.gru1(x, h), h)
            steps.append(h)
        states = torch.stack(steps, 1)                # [B, S, H]

        aux = None
        if kind == "train":
            # auxiliary loss: h_t should predict behavior_{t+1}
            # (negatives = shifted batch — standard sampled approximation)
            h_t = states[:, :-1]
            e_pos = hist[:, 1:]
            e_neg = torch.roll(e_pos, 1, 0) if dist is None else \
                dist.roll_dp(e_pos)
            m_t = mask[:, 1:]

            def binlog(hh, e):
                sim = torch.sum(hh[..., : e.shape[-1]] * e, -1)
                return F.logsigmoid(sim)
            aux = -(binlog(h_t, e_pos) + torch.log1p(
                -_clip(torch.exp(binlog(h_t, e_neg)), 0.0, 1 - 1e-6)))
            aux = total(torch.sum(aux * m_t)) / torch.clamp(
                total(torch.sum(m_t)), min=1.0)

        # ---- attention scores vs target ----------------------------------
        tgt = target[:, None, :].expand(hist.shape)
        att_in = torch.cat([states, tgt, states], -1)
        width = 2 * cfg.gru_dim + cfg.d_behavior
        if att_in.shape[-1] != width:
            # repro's cut, which keeps every column at any config; a
            # full-width slice would still cost its backward a zero fill
            att_in = att_in[..., :width]
        scores = self.att(att_in)[..., 0]
        scores = torch.where(mask > 0, scores, -1e9)
        att = torch.softmax(scores, 1)                # [B, S]

        # ---- interest evolution AUGRU (repro's second scan) --------------
        h = h0
        for x, a, m in zip(steps, att.unbind(1), m_steps):
            h = torch.where(m > 0, self.augru(x, h, att=a), h)

        # ---- head ---------------------------------------------------------
        hist_sum = torch.sum(hist * mask[..., None], 1) / torch.clamp(
            torch.sum(mask, 1, keepdim=True), min=1.0)
        feat = torch.cat([h, target, hist_sum, user], -1)
        logit = self.head(feat)[..., 0]
        if kind == "serve":
            return logit
        return logit, cfg.aux_weight * aux

    def retrieval_scores(self, batch, dist=None):
        """retrieval_cand shape: one query state scored against C
        candidates as a batched dot (no loop): score = <user interest,
        item_emb>. On a mesh ``batch["cand_items"]`` is the DTensor of
        the candidates, and the scores are this rank's candidates'."""
        hist = self.behavior_embed(batch["hist_items"], batch["hist_cats"],
                                   dist)
        user_vec = torch.mean(hist * batch["hist_mask"][..., None], 1)
        if SHD.tp(dist):
            cand = lookup_owned(self.item.table, batch["cand_items"],
                                self.cfg.n_items, dist)
        else:
            cand = lookup(self.item.table, batch["cand_items"])  # [C, D]
        u = user_vec[..., : self.cfg.embed_dim]                  # [B, D]
        return u @ cand.T                                        # [B, C]


def init_dien(cfg: DIENConfig, generator: torch.Generator) -> dict:
    """``repro``'s parameter tree, drawn on the generator's device."""
    with torch.device(generator.device):
        return L.params_tree(DIEN(cfg, generator))


def dien_forward(model: DIEN, params: dict, batch, kind: str = "train",
                 dist=None):
    """``model``'s forward on ``params`` (the flat dotted dict
    ``functional_call`` takes)."""
    return functional_call(model, params, (batch,),
                           {"kind": kind, "dist": dist})


def dien_loss(model: DIEN, params: dict, batch, dist=None):
    """The batch's mean cross-entropy plus the auxiliary loss; on a mesh
    the whole batch's, on every rank (the module docstring)."""
    logit, aux = dien_forward(model, params, batch, dist=dist)
    y = batch["label"].to(torch.float32)
    terms = y * F.logsigmoid(logit) + (1 - y) * F.logsigmoid(-logit)
    if dist is None:
        return -(torch.sum(terms) / logit.shape[0]) + aux
    rows = logit.shape[0] * dist.shard_index()[0]
    return -(dist.total(torch.sum(terms)) / rows) + aux


def retrieval_scores(model: DIEN, params: dict, batch, dist=None):
    return dien_forward(model, params, batch, kind="retrieval", dist=dist)
