"""Port building blocks (cabinet_tpu_torch.models.layers, resize_bilinear)
against their JAX counterparts on the CPU, in f32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.models import layers as jl
from cabinet_tpu.models.cab import resize_bilinear as j_resize
from cabinet_tpu_torch.models import layers as tl
from cabinet_tpu_torch.models.cab import resize_bilinear as t_resize
from torch_port_utils import assert_close_f32, nchw, nhwc


@pytest.mark.parametrize("hw,out", [((7, 5), (3, 2)), ((8, 8), (3, 3)),
                                    ((10, 13), (6, 8)), ((2, 3), (6, 8))])
def test_adaptive_avg_pool2d_ragged_bins(hw, out):
    x = np.random.default_rng(0).standard_normal((2, *hw, 4)).astype(np.float32)
    ref = jl.adaptive_avg_pool2d(jnp.asarray(x), out)
    got = tl.adaptive_avg_pool2d(nchw(x), out)
    assert_close_f32(nhwc(got), ref)


@pytest.mark.parametrize("hw,out", [((5, 7), (11, 16)),    # up
                                    ((16, 24), (5, 7)),    # down, no anti-alias
                                    ((9, 4), (3, 13)),     # mixed
                                    ((6, 6), (6, 6))])     # identity
def test_resize_bilinear_both_directions(hw, out):
    x = np.random.default_rng(1).standard_normal((2, *hw, 3)).astype(np.float32)
    ref = j_resize(jnp.asarray(x), out)
    got = t_resize(nchw(x), out)
    assert_close_f32(nhwc(got), ref)


def test_make_divisible_and_activations():
    for v in (3.5, 8, 16 * 0.75, 24 * 4.5, 40 * 3.67, 100, 959.9):
        for d in (4, 8):
            assert tl.make_divisible(v, d) == jl.make_divisible(v, d)
    x = np.linspace(-5, 5, 101, dtype=np.float32)
    np.testing.assert_array_equal(tl.hard_swish(torch.from_numpy(x)).numpy(),
                                  np.asarray(jl.hard_swish(jnp.asarray(x))))


def _conv(k):  # HWIO -> OIHW
    return torch.from_numpy(np.asarray(k).transpose(3, 2, 0, 1).copy())


def _bn(t_bn, p, s):
    t_bn.weight.data = torch.from_numpy(np.asarray(p["scale"]))
    t_bn.bias.data = torch.from_numpy(np.asarray(p["bias"]))
    t_bn.running_mean = torch.from_numpy(np.asarray(s["mean"]))
    t_bn.running_var = torch.from_numpy(np.asarray(s["var"]))


def _perturbed_init(module, x, seed):
    v = module.init(jax.random.PRNGKey(seed), jnp.asarray(x))
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (np.abs(np.asarray(a)) + 0.5
                         if getattr(path[-1], "key", "") == "var"
                         else np.asarray(a) + 0.1 * rng.standard_normal(a.shape)
                         .astype(np.float32)), v)


@pytest.mark.parametrize("block", ["conv_bn_relu", "dwconv", "se"])
def test_blocks_match_flax(block):
    x = np.random.default_rng(2).standard_normal((2, 9, 11, 16)).astype(np.float32)
    if block == "conv_bn_relu":
        jm = jl.ConvBNReLU(24, kernel_size=3, stride=2, padding=1)
        v = _perturbed_init(jm, x, 3)
        tm = tl.ConvBNReLU(16, 24, 3, 2, 1)
        tm.conv.weight.data = _conv(v["params"]["conv"]["kernel"])
        _bn(tm.bn, v["params"]["bn"], v["batch_stats"]["bn"])
    elif block == "dwconv":
        jm = jl.DWConv(stride=1)
        v = _perturbed_init(jm, x, 4)
        tm = tl.DWConv(16)
        tm.block[0].weight.data = _conv(v["params"]["conv"]["kernel"])
        _bn(tm.block[1], v["params"]["bn"], v["batch_stats"]["bn"])
    else:
        jm = jl.SELayer()
        v = _perturbed_init(jm, x, 5)
        tm = tl.SELayer(16)
        for i, name in ((0, "fc1"), (2, "fc2")):
            tm.fc[i].weight.data = torch.from_numpy(
                np.asarray(v["params"][name]["kernel"]).T.copy())
            tm.fc[i].bias.data = torch.from_numpy(np.asarray(v["params"][name]["bias"]))
    ref = jm.apply(v, jnp.asarray(x))
    with torch.no_grad():
        got = tm.eval()(nchw(x))
    assert_close_f32(nhwc(got), ref)
