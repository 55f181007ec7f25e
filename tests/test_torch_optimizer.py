"""The port's optimizer (cabinet_tpu_torch.train.optimizer) against the JAX
package's optax chain: the warmup+poly schedule, the 4 parameter groups,
and SGD steps with clipping by the global norm, on a small CABiNet; and
YOLO-sem's cosine schedule, 2 groups and steps on yolo26n-sem."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.train import optimizer as jopt
from cabinet_tpu_torch.train import optimizer as topt
from cabinet_tpu_torch.utils.convert import (
    BN,
    cabinet_mapping,
    state_dict_from_jax,
    yolosem_state_dict_from_jax,
)
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
        norms.append(float(torch.sqrt(topt.squared_norm(list(named.values()), set(), None))))
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


# --- YOLO-sem: warmup_cosine_schedule and build_sgd -------------------------

@pytest.mark.parametrize("lr0,lrf,total,warmup,start", [
    (0.01, 0.01, 1000, 0, 0.0), (0.01, 0.01, 1000, 30, 0.0), (0.02, 0.1, 37, 5, 1e-3)],
    ids=["no-warmup", "warmup", "warmup-from-lr"])
def test_cosine_schedule_bit_equal_to_jax(lr0, lrf, total, warmup, start):
    """lr at every count from 0 to total + 5 equal to the JAX schedule's
    f32 value (its function called op by op); lr0 * lrf from total on."""
    ref = jopt.warmup_cosine_schedule(lr0, lrf, total, warmup, start)
    got = topt.warmup_cosine_schedule(lr0, lrf, total, warmup, start)
    for count in range(total + 6):
        assert np.float32(got(count)) == np.float32(ref(count)), count
    assert got(total + 5) == got(total) == pytest.approx(lr0 * lrf, rel=1e-5)


@pytest.fixture(scope="module")
def yolo():
    from torch_port_utils import yolo_port_model, yolo_variables

    v = yolo_variables(8, "n", seed=4)
    return v, yolo_port_model(v, 8, "n")


def test_build_sgd_groups_match_jax_labels(yolo):
    """Every parameter of yolo26n-sem sits in the group that JAX's build_sgd
    labels its counterpart: weight decay on every conv kernel (the class
    heads' included), none on biases and BN affine; one LR."""
    from cabinet_tpu_torch.utils.convert import yolosem_mapping

    v, model = yolo
    captured = {}
    real = jopt.optax.multi_transform
    try:
        jopt.optax.multi_transform = lambda groups, labels: captured.setdefault("l", labels)
        jopt.build_sgd(v["params"], lambda c: 0.0)
    finally:
        jopt.optax.multi_transform = real
    labels = captured["l"]
    ours = topt.param_labels(model, decoder_modules=())
    seen = set()
    for torch_key, flax_path, kind in yolosem_mapping("n"):
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
    assert ours["classifier.weight"] == topt.WD and ours["classifier.bias"] == topt.NOWD
    opt = topt.build_sgd(model, lambda c: 0.5, wd=5e-4)
    assert [(g["name"], g["weight_decay"], g["lr_scale"]) for g in opt.sgd.param_groups] == [
        (topt.WD, 5e-4, 1.0), (topt.NOWD, 0.0, 1.0)]


def test_build_sgd_steps_match_optax(yolo):
    """Three steps of build_sgd on the cosine schedule with warmup, and of
    JAX's build_sgd, on the same random gradients of global norm 0.5, 3.0
    and 0.8 against a clip of 1.0: parameters within 1e-6 * max|delta p|
    of each tensor, plus 4 f32 ulps of its magnitude."""
    from torch_port_utils import assert_updates_close, yolo_port_model
    from cabinet_tpu_torch.utils.convert import yolosem_mapping

    v, _ = yolo
    model = yolo_port_model(v, 8, "n")
    kw = dict(momentum=0.937, wd=5e-4, max_grad_norm=1.0)
    opt = topt.build_sgd(model, topt.warmup_cosine_schedule(0.05, 0.01, 5, 1), **kw)
    tx = jopt.build_sgd(v["params"], jopt.warmup_cosine_schedule(0.05, 0.01, 5, 1), **kw)
    params = jax.tree_util.tree_map(jnp.asarray, v["params"])
    opt_state = tx.init(params)
    start = {k: t.detach().clone() for k, t in model.state_dict().items()}
    rng = np.random.default_rng(6)
    named = dict(model.named_parameters())
    mapping = yolosem_mapping("n")
    norms = []
    for target in (0.5, 3.0, 0.8):
        grads = {n: rng.standard_normal(p.shape).astype(np.float32) for n, p in named.items()}
        scale = target / np.sqrt(sum(float((g.astype(np.float64) ** 2).sum())
                                     for g in grads.values()))
        grads = {n: (g * scale).astype(np.float32) for n, g in grads.items()}
        jgrads = jax_tree_from_state_dict({**start, **grads}, None, mapping)["params"]
        updates, opt_state = tx.update(jax.tree_util.tree_map(jnp.asarray, jgrads),
                                       opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for n, p in named.items():
            p.grad = torch.from_numpy(grads[n])
        norms.append(float(torch.sqrt(topt.squared_norm(list(named.values()), set(), None))))
        opt.step(len(norms) - 1)
    assert norms[0] < 1.0 < norms[1] and norms[2] < 1.0
    ref = yolosem_state_dict_from_jax({"params": jax.tree_util.tree_map(np.asarray, params),
                                       "batch_stats": v["batch_stats"]}, "n")
    got = {n: p.detach() for n, p in named.items()}
    assert_updates_close(got, {k: ref[k] for k in got}, {k: start[k] for k in got},
                         rel=1e-6)
