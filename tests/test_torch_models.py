"""Port models (MobileNetV3, CAB, CABiNet) against the JAX package on the
CPU, in f32, with the CAB's gamma and project_out made non-zero so that the
global attention reaches every compared output."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu_torch.models.mobilenetv3 import MOBILENETV3_LARGE_CFGS
from torch_port_utils import (
    assert_close_f32,
    load_large_fixture,
    nchw,
    nhwc,
    perturb,
    port_model,
)

LARGE_CUT = [[3, 1, 16, 0, 0, 1], [3, 4, 24, 0, 0, 2], [5, 3, 40, 1, 0, 2],
             [3, 6, 80, 0, 1, 2], [5, 6, 160, 1, 1, 2]]
SMALL_CUT = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2],
             [5, 6, 96, 1, 1, 2]]


@pytest.fixture(scope="module", params=["large", "small"])
def pair(request):
    """(JAX model, perturbed variables, port model) on a truncated table."""
    mode = request.param
    cfgs = LARGE_CUT if mode == "large" else SMALL_CUT
    jm = JaxCABiNet(n_classes=6, mode=mode, cfgs=cfgs)
    v = jm.init(jax.random.PRNGKey(1), jnp.zeros((1, 64, 64, 3)), train=False)
    v = perturb(v, seed=11)
    return jm, v, port_model(v, 6, mode, cfgs)


def test_mobilenetv3_matches_jax(pair):
    jm, v, tm = pair
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref = jm.apply(v, jnp.asarray(x), method=lambda m, x: m.mobile(x, False))
    with torch.no_grad():
        got = tm.mobile(nchw(x))
    assert_close_f32(nhwc(got), ref)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_branch_with_cab_matches_jax(pair, use_kernel):
    """The attention branch (conva -> CAB -> convb, and the aux path) on a
    4x4 /32 grid: the PSP bins pool down (1, 3) and up (6, 8)."""
    jm, v, tm = pair
    c = tm.mobile.out_channels
    feat = np.random.default_rng(1).standard_normal((2, 4, 4, c)).astype(np.float32)
    ref_low, ref_aux = jm.apply(v, jnp.asarray(feat),
                                method=lambda m, x: m.ab(x, False))
    tm.ab.a2block.global_attn.attention = "kernel" if use_kernel else "einsum"
    with torch.no_grad():
        low, aux = tm.ab(nchw(feat))
    assert float(tm.ab.a2block.gamma.detach()) != 0.0
    assert_close_f32(nhwc(low), ref_low)
    assert_close_f32(nhwc(aux), ref_aux)


@pytest.mark.parametrize("attention", ["plain", "einsum"])
def test_cab_attention_choices_agree_in_f32(pair, attention):
    """On CPU tensors "kernel" runs K1's plain version, so "plain" matches it
    exactly; "einsum" casts the probabilities to v's dtype, a no-op in f32."""
    _, _, tm = pair
    cab = tm.ab.a2block
    x = nchw(np.random.default_rng(9).standard_normal(
        (2, 4, 4, 256)).astype(np.float32))
    with torch.no_grad():
        cab.global_attn.attention = "kernel"
        ref = cab(x)
        cab.global_attn.attention = attention
        got = cab(x)
    if attention == "plain":
        assert torch.equal(got, ref)
    assert_close_f32(nhwc(got), nhwc(ref))


def test_forward_from_early_matches_jax(pair):
    """The seam the stem+block_0 kernel feeds: a given block_0 output runs
    through MobileNetV3.tail and the decoder, as in JAX."""
    jm, v, tm = pair
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 64, 64, 3)).astype(np.float32)
    early = rng.standard_normal((1, 32, 32, 16)).astype(np.float32)
    ref_final, ref_aux = jm.apply(v, jnp.asarray(x), jnp.asarray(early),
                                  train=False, method=JaxCABiNet.forward_from_early)
    with torch.no_grad():
        final, aux = tm.forward_from_early(nchw(x), nchw(early))
    assert_close_f32(nhwc(final), ref_final)
    assert_close_f32(nhwc(aux), ref_aux)


def test_cabinet_forward_small_cabinet_fixture(small_cabinet):
    jm, v0 = small_cabinet
    v = perturb(v0, seed=5)
    tm = port_model(v, jm.n_classes, jm.mode, jm.cfgs, attention="kernel")
    x = np.random.default_rng(2).standard_normal((2, 64, 64, 3)).astype(np.float32)
    ref_final, ref_aux = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        final, aux = tm(nchw(x))
    assert_close_f32(nhwc(final), ref_final)
    assert_close_f32(nhwc(aux), ref_aux)


def test_cabinet_forward_large_fixture_weights():
    """The trained Large fixture (full published table, 5 classes) at 128^2,
    attention perturbed (the fixture's gamma and project_out are zero)."""
    flat, v = load_large_fixture()
    ga = v["params"]["ab"]["a2block"]
    assert float(ga["gamma"][0]) == 0.0
    rng = np.random.default_rng(3)
    ga["gamma"] = np.asarray([0.5], np.float32)
    po = ga["global_attn"]["project_out"]
    po["kernel"] = (0.05 * rng.standard_normal(po["kernel"].shape)).astype(np.float32)
    jm = JaxCABiNet(n_classes=5, mode="large")
    tm = port_model(v, 5, "large", MOBILENETV3_LARGE_CFGS, attention="kernel")
    x = rng.random((1, 128, 128, 3)).astype(np.float32)
    ref_final, _ = jm.apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        final, _ = tm(nchw(x))
    assert_close_f32(nhwc(final), ref_final)

