"""The port's cross-entropy (``models/layers.py``) against ``repro``'s
``softmax_cross_entropy`` on the CPU, on targets inside and outside
[0, V).

``repro`` reads the target logit with ``jnp.take_along_axis``: a
target in [-V, 0) counts from the end, one past either end reads NaN.
``impl="iota"`` compares with an iota, so any target outside [0, V)
matches no logit and the loss is the lse. The port's two forms, the
unsharded ``softmax_cross_entropy`` and the vocabulary-parallel
``vocab_cross_entropy`` (here on one rank; on four gloo ranks in
``tests/test_torch_distributed.py``), must give ``repro``'s losses,
NaN where it gives NaN, and its gradients, without raising.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as j_layers
from repro_torch.models import layers as t_layers

V = 8
ODD = [V, V + 3, -1, -V, -V - 1]
TARGETS = np.array([[ODD + [0, 3, V - 1]], [[2, 5, 1, 0, 7, 6, 4, 3]]],
                   np.int32).reshape(2, 8)


def _logits():
    r = np.random.default_rng(26)
    return (r.standard_normal((2, 8, V)) * 3).astype(np.float32)


def _repro(logits, targets, impl, z_loss):
    def total(x):
        return jnp.sum(j_layers.softmax_cross_entropy(
            x, jnp.asarray(targets), z_loss=z_loss, impl=impl))
    loss = j_layers.softmax_cross_entropy(jnp.asarray(logits),
                                          jnp.asarray(targets), z_loss=z_loss,
                                          impl=impl)
    return np.asarray(loss), np.asarray(jax.grad(total)(jnp.asarray(logits)))


class _OneRank:
    """A ``ModelCall`` of one ``model`` rank: every collective the
    identity."""

    @staticmethod
    def max_over_model(x):
        return x.detach()

    @staticmethod
    def from_model(x):
        return x


def _port(logits, targets, impl, z_loss, vocab_parallel):
    x = torch.from_numpy(logits).requires_grad_()
    t = torch.from_numpy(targets)
    if vocab_parallel:
        loss = t_layers.vocab_cross_entropy(x, t, 0, _OneRank(), V,
                                            z_loss=z_loss, impl=impl)
    else:
        loss = t_layers.softmax_cross_entropy(x, t, z_loss=z_loss, impl=impl)
    (g,) = torch.autograd.grad(loss.sum(), x)
    return loss.detach().numpy(), g.numpy()


@pytest.mark.parametrize("vocab_parallel", [False, True],
                         ids=["unsharded", "vocab_parallel"])
@pytest.mark.parametrize("impl", ["gather", "iota"])
@pytest.mark.parametrize("z_loss", [0.0, 1e-4])
def test_cross_entropy_odd_targets_match_repro(impl, z_loss, vocab_parallel):
    """Targets V, V+3, -1, -V and -V-1 beside in-range ones: the losses
    equal ``repro``'s (NaN where it gives NaN) and so do the gradients
    of their sum, for both ``impl``s."""
    logits = _logits()
    want, want_g = _repro(logits, TARGETS, impl, z_loss)
    got, got_g = _port(logits, TARGETS, impl, z_loss, vocab_parallel)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                               equal_nan=True)
    np.testing.assert_allclose(got_g, want_g, rtol=1e-6, atol=1e-6)
    nan = np.isnan(want)
    if impl == "gather":
        # past either end: NaN; -1 and -V wrap to V - 1 and 0
        assert nan[0, :5].tolist() == [True, True, False, False, True]
    else:
        assert not nan.any()
    assert not nan[1].any()


def test_wrapped_targets_read_the_wrapped_logit():
    """A target in [-V, 0) gives the loss of target V + t, bitwise."""
    logits = torch.from_numpy(_logits())
    neg = torch.tensor([[-1, -V, -3, -5, -2, -7, -4, -6]] * 2)
    a = t_layers.softmax_cross_entropy(logits, neg)
    b = t_layers.softmax_cross_entropy(logits, neg + V)
    assert torch.equal(a, b)
