"""EGNN molecular-property regression on batched synthetic molecules, on
the port — the GNN-family example (segment-ops message passing +
equivariant coordinate updates).

  PYTHONPATH=src python -m repro_torch.examples.gnn_molecules \\
      [--steps 200] [--device cpu]
"""
import argparse
import functools
import time

import numpy as np
import torch
from torch.func import functional_call

from repro_torch.core.sync import upload
from repro_torch.data import synthetic
from repro_torch.graphs import segment_ops as sops
from repro_torch.kernels.backend import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.gnn import EGNN, EGNNConfig
from repro_torch.optim import adamw
from repro_torch.tree import flatten_with_paths, tree_map, unflatten_paths

CFG = EGNNConfig("egnn-mol", n_layers=4, d_hidden=64, d_in=16, n_out=1)
OPT = adamw(lr=1e-3)

B, ATOMS, EDGES = 32, 12, 24
N_PAD, E_PAD = B * ATOMS + 16, 2 * B * EDGES + 16
KEYS = ("feats", "coords", "edge_src", "edge_dst", "graph_ids", "targets")


@functools.cache
def _model() -> EGNN:
    """The EGNN's structure for ``functional_call`` (no storage)."""
    with torch.device("meta"):
        return EGNN(CFG)


def init_params(device) -> dict:
    """The parameter tree drawn from a ``torch.Generator`` seeded 0, on
    ``device``."""
    params = L.params_tree(EGNN(CFG, torch.Generator().manual_seed(0)))
    return tree_map(lambda p: upload(p, device), params)


def make_batch(i: int, device) -> dict:
    """Step ``i``'s molecule batch on ``device``; the target is each
    molecule's mean squared atom distance from its centroid."""
    b = synthetic.molecule_batch(i, B, ATOMS, EDGES, 16, N_PAD, E_PAD)
    coords = b["coords"][:B * ATOMS].reshape(B, ATOMS, 3)
    b["targets"] = np.mean(np.sum(
        (coords - coords.mean(1, keepdims=True)) ** 2, -1), 1).astype(
        np.float32)
    return {k: upload(b[k], device) for k in KEYS}


def loss_fn(params, batch):
    node_out, _ = functional_call(
        _model(), L.dotted(params), (batch["feats"], batch["coords"],
                                     batch["edge_src"], batch["edge_dst"]))
    pooled = sops.segment_sum(node_out[..., 0], batch["graph_ids"],
                              B + 1)[:B]
    # synthetic target: molecule radius (equivariance-meaningful)
    return torch.mean(torch.square(pooled - batch["targets"]))


def train_step(params, opt_state, step, batch):
    """One AdamW step: ``(params, opt_state, loss)``, new tensors (the
    arguments stay as they were). ``step``: an int32 tensor."""
    paths = [k for k, _ in flatten_with_paths(params)]
    p = tree_map(lambda v: v.detach().requires_grad_(), params)
    loss = loss_fn(p, batch)
    # the last layer's phi_x reaches no output: a zero gradient, as
    # under jax.grad
    grads = torch.autograd.grad(loss, [v for _, v in flatten_with_paths(p)],
                                allow_unused=True, materialize_grads=True)
    params, opt_state, _ = OPT.update(unflatten_paths(zip(paths, grads)),
                                      opt_state, params, step)
    return params, opt_state, loss.detach()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    params = init_params(device)
    opt_state = OPT.init(params)

    t0 = time.perf_counter()
    losses = []
    for i in range(args.steps):
        step = torch.full((), i, dtype=torch.int32, device=device)
        params, opt_state, loss = train_step(params, opt_state, step,
                                             make_batch(i, device))
        losses.append(float(loss))
        if i % 40 == 0:
            print(f"step {i:3d} mse {losses[-1]:.4f}")
    seconds = time.perf_counter() - t0
    final = float(np.mean(losses[-10:]))
    print(f"final mse {final:.4f} (from {losses[0]:.4f}) in {seconds:.0f}s")
    if not final < losses[0]:
        raise AssertionError("the loss did not decrease")
    return {"device": str(device), "steps": args.steps, "losses": losses,
            "final_mse": final, "seconds": seconds}


if __name__ == "__main__":
    main()
