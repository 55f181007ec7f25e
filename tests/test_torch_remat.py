"""Backbone remat (`runtime.remat`, models/mobilenetv3.py) on the CPU: one f32
train step of a small CABiNet with remat true and 2 is bit for bit the step
without remat, on the gradients, the BatchNorm running statistics (updated
once, by the forward, not again by the recomputation) and the parameters;
and it matches the JAX package's remat step (flax `nn.remat`) within the
trainer's bounds (tests/test_torch_train_step.py). Also `remat_of`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.cli.common import remat_of as j_remat_of
from cabinet_tpu.core.config import compose as jcompose
from cabinet_tpu.core.exceptions import ConfigurationError as JConfigurationError
from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.train.optimizer import build_optimizer
from cabinet_tpu.train.trainer import create_train_state, make_train_step as j_train_step
from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.core.config import compose
from cabinet_tpu_torch.core.exceptions import ConfigurationError
from cabinet_tpu_torch.train import trainer as T
from cabinet_tpu_torch.train.optimizer import GroupedSGD
from cabinet_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_utils import assert_updates_close, jax_tree_from_state_dict, perturb

CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]]
S, B, NC = 64, 2, 8
N_MIN = B * S * S // 16
OPT = dict(lr0=0.2, max_iter=10, momentum=0.9, wd=5e-4, power=0.9, warmup_steps=1,
           warmup_start_lr=0.05)
LOSS_REL, UPDATE_REL = 1e-5, 2e-4


@pytest.fixture(scope="module")
def setup():
    """JAX variables of a seeded port model, perturbed (`perturb`), a batch."""
    from cabinet_tpu_torch.models.cabinet import CABiNet

    torch.manual_seed(0)
    v = perturb(jax_tree_from_state_dict(CABiNet(NC, "small", cfgs=CFGS).state_dict(), CFGS),
                seed=7)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    y = rng.integers(0, NC, (B, S, S))
    y[:, :3] = 255
    return v, x, y


def port_step(v, x, y, remat):
    """One micro-step at accum 2 (gradients and statistics, no update), then
    the flush that applies it: (grads, state after the forward, state after
    the update, loss)."""
    from cabinet_tpu_torch.models.cabinet import CABiNet

    model = CABiNet(NC, "small", cfgs=CFGS, remat=remat)
    model.load_state_dict(state_dict_from_jax(v, CFGS), strict=True)
    ts = T.create_train_state(model, GroupedSGD(model, max_grad_norm=1.0, **OPT), 0.9, 2.0)
    ts, loss = T.make_train_step(n_min=N_MIN, accum_steps=2)(
        ts, torch.from_numpy(x), torch.from_numpy(y))
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    after_fwd = {k: t.clone() for k, t in model.state_dict().items()}
    T.make_flush_step()(ts)
    return grads, after_fwd, {k: t.clone() for k, t in model.state_dict().items()}, float(loss)


@pytest.fixture(scope="module")
def steps(setup):
    v, x, y = setup
    return {remat: port_step(v, x, y, remat) for remat in (False, True, 2)}


@pytest.mark.parametrize("remat", [True, 2])
def test_remat_step_is_bit_equal_to_the_plain_step(steps, remat):
    ref, got = steps[False], steps[remat]
    assert got[3] == ref[3]
    for g, r in zip(got[:3], ref[:3]):
        assert g.keys() == r.keys()
        for k in r:
            assert torch.equal(g[k], r[k]), k
    counts = {k: int(t) for k, t in got[1].items() if k.endswith("num_batches_tracked")}
    assert set(counts.values()) == {1}  # one update a layer: the recomputation adds none


def test_remat_checkpoints_the_blocks_it_names(setup, monkeypatch):
    """True checkpoints every backbone block, 2 the first two, false none;
    none under no_grad."""
    from cabinet_tpu_torch.models import mobilenetv3
    from cabinet_tpu_torch.models.cabinet import CABiNet

    calls = []
    real = mobilenetv3.checkpoint

    def spy(fn, *args, **kwargs):
        calls.append(fn)
        return real(fn, *args, **kwargs)

    monkeypatch.setattr(mobilenetv3, "checkpoint", spy)
    x = torch.zeros(2, 3, 64, 64)
    for remat, n in ((True, len(CFGS)), (2, 2), (False, 0), (0, 0)):
        model = CABiNet(NC, "small", cfgs=CFGS, remat=remat).train()
        calls.clear()
        model(x)
        assert [list(model.mobile.features).index(f) for f in calls] == list(range(1, n + 1))
        calls.clear()
        with torch.no_grad():
            model(x)
        assert calls == []


def test_remat_step_matches_jax(setup, steps):
    """The port's remat step against JAX's `CABiNet(remat=True)` step on the
    same batch: the loss within 1e-5 of |ref|, params and statistics within
    2e-4 of each tensor's change (`assert_updates_close`)."""
    v, x, y = setup
    jm = JaxCABiNet(n_classes=NC, mode="small", cfgs=CFGS, remat=True)
    tx = build_optimizer(v["params"], max_grad_norm=1.0, **OPT)
    js = create_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx, ema_decay=0.9,
                            ema_tau=2.0)
    step = j_train_step(jm.apply, tx, n_min=N_MIN, accum_steps=1)
    js, loss = step(js, jnp.asarray(x), jnp.asarray(y))
    _, _, after, got_loss = steps[True]
    assert abs(got_loss - float(loss)) <= LOSS_REL * abs(float(loss))
    ref = state_dict_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32),
        {"params": js.params, "batch_stats": js.batch_stats}), CFGS)
    start = state_dict_from_jax(v, CFGS)
    keys = [k for k in ref if not k.endswith("num_batches_tracked")]
    assert_updates_close({k: after[k] for k in keys}, {k: ref[k] for k in keys},
                         {k: start[k] for k in keys}, rel=UPDATE_REL)


@pytest.mark.parametrize("value", ["true", "false", "3", "0", "maybe"])
def test_remat_of_matches_jax(value):
    args = [f"runtime.remat={value}"]
    cfg = compose(common.CONFIG_DIR, "train", args)
    jcfg = jcompose(common.CONFIG_DIR, "train", args)
    if value == "maybe":
        with pytest.raises(JConfigurationError, match="remat"):
            j_remat_of(jcfg)
        with pytest.raises(ConfigurationError, match="remat"):
            common.remat_of(cfg)
        return
    got, want = common.remat_of(cfg), j_remat_of(jcfg)
    assert got == want and type(got) is type(want)
