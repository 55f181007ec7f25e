"""The port's losses (cabinet_tpu_torch.train.losses) against the JAX
package's on random logits: OHEM with both methods, the masked-mean CE and
the focal loss, with ignore pixels, class weights, an n_min above the
valid count, and all pixels ignored. f32 bounds: the loss within
1e-6 * |ref| and the gradient with respect to the logits within
1e-6 * max|ref grad|; the class-weighted mean CE within 2e-6 of both, since
its value is a ratio of two sums of ~180 f32 terms each (the loss and the
picked weights) that the two frameworks add in different orders (measured
up to 1.3e-6 over 20 seeds)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.train import losses as jl
from cabinet_tpu_torch.train import losses as tl

LOSS_REL, GRAD_REL = 1e-6, 1e-6
WEIGHTED_MEAN_REL = 2e-6
B, H, W, C = 2, 12, 10, 6


def _inputs(seed, scale, ignore_frac):
    rng = np.random.default_rng(seed)
    logits = (scale * rng.standard_normal((B, H, W, C))).astype(np.float32)
    labels = rng.integers(0, C, (B, H, W))
    labels[rng.random((B, H, W)) < ignore_frac] = 255
    return logits, labels


def _both(jax_fn, torch_fn, logits, labels):
    ref, ref_grad = jax.value_and_grad(jax_fn)(jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).permute(0, 3, 1, 2).clone().requires_grad_()
    got = torch_fn(t, torch.from_numpy(labels))
    got.backward()
    return (float(got.detach()), t.grad.permute(0, 2, 3, 1).numpy(), float(ref),
            np.asarray(ref_grad))


def _check(got, grad, ref, ref_grad, loss_rel=LOSS_REL, grad_rel=GRAD_REL):
    assert abs(got - ref) <= loss_rel * abs(ref), (got, ref)
    bound = grad_rel * max(float(np.abs(ref_grad).max()), 1e-30)
    assert float(np.abs(grad - ref_grad).max()) <= bound


# (scale of the logits, ignored share, n_min): the above-thresh branch (large
# logits), the top-n_min branch (small logits: most losses under 0.7), an
# n_min above the valid count, and everything ignored.
OHEM_CASES = [(3.0, 0.2, 20), (0.05, 0.2, 20), (0.05, 0.3, 10_000), (1.0, 1.0, 20)]


@pytest.mark.parametrize("method", ["topk", "bisect"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("case", range(len(OHEM_CASES)))
def test_ohem_matches_jax(method, weighted, case):
    scale, ignore, n_min = OHEM_CASES[case]
    logits, labels = _inputs(case, scale, ignore)
    cw = (np.random.default_rng(9).random(C) + 0.5).astype(np.float32) if weighted else None
    got, grad, ref, ref_grad = _both(
        lambda x, y: jl.ohem_cross_entropy(x, y, n_min, 0.7, 255,
                                           None if cw is None else jnp.asarray(cw),
                                           method=method),
        lambda x, y: tl.ohem_cross_entropy(x, y, n_min, 0.7, 255, cw, method=method),
        logits, labels)
    _check(got, grad, ref, ref_grad)
    if ignore == 1.0:
        assert got == ref == 0.0 and not grad.any()


def test_bisect_gives_the_tied_fill_no_gradient():
    """Every valid loss equal (constant logits), well under thresh, n_min
    below the valid count: the top-n_min mean is the tied value itself,
    filled under stop-gradient, so no pixel gets a gradient, as in JAX;
    topk gives the same value with a gradient on n_min of the tied pixels
    (which ones is the sort's choice: JAX and torch choose differently)."""
    logits = np.zeros((B, H, W, C), np.float32)
    labels = np.random.default_rng(1).integers(0, C, (B, H, W))
    n_min = 17
    outs = {}
    for method in ("bisect", "topk"):
        outs[method] = _both(
            lambda x, y: jl.ohem_cross_entropy(x, y, n_min, 2.0, 255, method=method),
            lambda x, y: tl.ohem_cross_entropy(x, y, n_min, 2.0, 255, method=method),
            logits, labels)
    _check(*outs["bisect"])
    got, grad, ref, ref_grad = outs["bisect"]
    assert abs(got - np.log(C)) < 1e-6
    assert not grad.any() and not ref_grad.any()
    got, grad, ref, ref_grad = outs["topk"]
    assert abs(got - ref) <= LOSS_REL * abs(ref)
    for g in (grad, ref_grad):
        assert np.count_nonzero(np.abs(g).sum(-1)) == n_min
        assert abs(float(g.sum())) < 1e-6  # softmax minus one-hot, per pixel


def test_unknown_method_raises():
    logits, labels = _inputs(0, 1.0, 0.0)
    with pytest.raises(ValueError, match="Unknown OHEM method"):
        tl.ohem_cross_entropy(torch.from_numpy(logits).permute(0, 3, 1, 2),
                              torch.from_numpy(labels), 4, method="sort")


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("ignore", [0.25, 1.0])
def test_cross_entropy_mean_matches_jax(weighted, ignore):
    logits, labels = _inputs(3, 2.0, ignore)
    cw = (np.random.default_rng(4).random(C) + 0.5).astype(np.float32) if weighted else None
    got, grad, ref, ref_grad = _both(
        lambda x, y: jl.cross_entropy_mean(x, y, 255, None if cw is None else jnp.asarray(cw)),
        lambda x, y: tl.cross_entropy_mean(x, y, 255, cw), logits, labels)
    rel = WEIGHTED_MEAN_REL if weighted else LOSS_REL
    _check(got, grad, ref, ref_grad, rel, rel)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("gamma", [0.0, 2.0])
def test_focal_matches_jax(weighted, gamma):
    logits, labels = _inputs(5, 2.0, 0.25)
    cw = (np.random.default_rng(6).random(C) + 0.5).astype(np.float32) if weighted else None
    got, grad, ref, ref_grad = _both(
        lambda x, y: jl.softmax_focal_loss(x, y, gamma,
                                           None if cw is None else jnp.asarray(cw), 255),
        lambda x, y: tl.softmax_focal_loss(x, y, gamma, cw, 255), logits, labels)
    _check(got, grad, ref, ref_grad)


def test_focal_all_ignored_is_zero():
    logits, labels = _inputs(7, 1.0, 1.0)
    got = tl.softmax_focal_loss(torch.from_numpy(logits).permute(0, 3, 1, 2),
                                torch.from_numpy(labels))
    ref = jl.softmax_focal_loss(jnp.asarray(logits), jnp.asarray(labels))
    assert float(got) == float(ref) == 0.0
