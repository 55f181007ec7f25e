"""The port's optimizer (cabinet_tpu_torch.train.optimizer) against the JAX
package's optax chain: the warmup+poly schedule, the 4 parameter groups,
and SGD steps with clipping by the global norm, on a small CABiNet."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.train import optimizer as jopt
from cabinet_tpu_torch.train import optimizer as topt
from cabinet_tpu_torch.utils.convert import BN, cabinet_mapping, state_dict_from_jax
from torch_port_utils import jax_tree_from_state_dict, perturb, port_model

CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]]
SCHED = dict(lr0=5e-3, max_iter=100, power=0.9, warmup_steps=10, warmup_start_lr=1e-5)


@pytest.fixture(scope="module")
def small():
    jm = JaxCABiNet(n_classes=8, mode="small", cfgs=CFGS)
    v = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False),
                seed=2)
    return v, port_model(v, 8, "small", CFGS)


@pytest.mark.parametrize("warmup", [0, 10])
def test_schedule_matches_jax(warmup):
    """lr at counts 0, warmup-1, warmup, mid, max_iter and max_iter+5
    within 1e-6 relative (0 exactly past max_iter)."""
    kw = {**SCHED, "warmup_steps": warmup}
    ref, got = jopt.warmup_poly_schedule(**kw), topt.warmup_poly_schedule(**kw)
    for count in (0, max(warmup - 1, 0), warmup, 55, 100, 105):
        r, g = float(ref(jnp.asarray(count))), got(count)
        assert abs(g - r) <= 1e-6 * abs(r), (count, g, r)
    assert got(105) == 0.0 and got(100) == 0.0


def test_groups_match_param_labels(small):
    """Every parameter of the state dict sits in the group that JAX's
    param_labels gives its counterpart through the key table: weight decay
    iff a conv kernel, x10 iff under ab/ffm/conv_out; gamma, BN affine,
    biases and the SE dense kernels without decay."""
    v, model = small
    labels = jopt.param_labels(v["params"])
    ours = topt.param_labels(model)
    seen = set()
    for torch_key, flax_path, kind in cabinet_mapping(CFGS):
        pairs = ([(f"{torch_key}.weight", flax_path + ("scale",)),
                  (f"{torch_key}.bias", flax_path + ("bias",))] if kind == BN
                 else [(torch_key, flax_path)])
        for key, path in pairs:
            node = labels
            for part in path:
                node = node[part]
            assert ours[key] == node, (key, ours[key], node)
            seen.add(key)
    assert seen == {n for n, _ in model.named_parameters()}
    assert ours["ab.a2block.gamma"] == topt.NOWD_X
    assert ours["mobile.features.1.conv.3.fc.0.weight"] == topt.NOWD  # SE dense
    groups = topt.param_groups(model, wd=5e-4)
    assert [g["name"] for g in groups] == list(topt.GROUPS)
    assert [(g["weight_decay"], g["lr_scale"]) for g in groups] == [
        (5e-4, 1.0), (0.0, 1.0), (5e-4, 10.0), (0.0, 10.0)]


def test_sgd_steps_match_optax(small):
    """Three steps of the port's grouped SGD and optax's chain on the same
    random gradients, the global norm 0.5, 3.0 and 0.8 against a clip of
    1.0 (clipping acts on the second step only): parameters within
    1e-6 * max|delta p| of each tensor, plus 2^-21 * max|p| (4 f32 ulps:
    a step much smaller than the parameter is rounded to its ulp)."""
    from torch_port_utils import assert_updates_close

    v, model = small
    model = port_model(v, 8, "small", CFGS)
    kw = dict(lr0=0.05, max_iter=10, momentum=0.9, wd=5e-4, power=0.9,
              warmup_steps=1, warmup_start_lr=0.01)
    opt = topt.GroupedSGD(model, max_grad_norm=1.0, **kw)
    tx = jopt.build_optimizer(v["params"], max_grad_norm=1.0, **kw)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    opt_state = tx.init(params)
    start = {k: t.detach().clone() for k, t in model.state_dict().items()}
    rng = np.random.default_rng(3)
    named = dict(model.named_parameters())
    norms = []
    for target in (0.5, 3.0, 0.8):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in named.items()}
        scale = target / np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                     for g in grads.values()))
        grads = {n: (g * scale).astype(np.float32) for n, g in grads.items()}
        jgrads = jax_tree_from_state_dict({**start, **grads}, CFGS)["params"]
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, jgrads),
                                       opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n])
        norms.append(float(topt.global_norm([p.grad for p in named.values()])))
        opt.step(len(norms) - 1)
    assert norms[0] < 1.0 < norms[1] and norms[2] < 1.0
    ref = state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, params),
                               "batch_stats": v["batch_stats"]}, CFGS)
    got = {n: p.detach() for n, p in named.items()}
    assert_updates_close(got, {k: ref[k] for k in got}, {k: start[k] for k in got},
                         rel=1e-6)


def test_clip_is_optax_form():
    """(g / |g|) * max when |g| >= max, untouched below, no epsilon."""
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.tensor([3.0, 4.0, 0.0])
    norm = topt.clip_by_global_norm([p], 1.0)
    assert float(norm) == 5.0
    assert torch.equal(p.grad, (torch.tensor([3.0, 4.0, 0.0]) / 5.0) * 1.0)
    p.grad = torch.tensor([0.3, 0.4, 0.0])
    topt.clip_by_global_norm([p], 1.0)
    assert torch.equal(p.grad, torch.tensor([0.3, 0.4, 0.0]))
