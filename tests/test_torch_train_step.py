"""The port's training step (cabinet_tpu_torch.train.trainer) against the
JAX package's `make_train_step` + `make_flush_step` on a small CABiNet in
f32: 5 micro-batches at accum_steps=2 (two updates and a trailing flush),
OHEM on both heads with class weights, clipping, grouped SGD and EMA.
Also the train-mode BatchNorm against flax's, the eval loss, and the grad
guard of the kernel wrappers.

The CAB's gamma and project_out are perturbed away from zero first, so that
gradients reach the global attention."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.train.optimizer import build_optimizer
from cabinet_tpu.train.trainer import (
    create_train_state,
    make_eval_loss_step as j_eval_loss,
    make_flush_step as j_flush,
    make_train_step as j_train_step,
)
from cabinet_tpu_torch.train import trainer as T
from cabinet_tpu_torch.train.optimizer import GroupedSGD
from cabinet_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_utils import assert_updates_close, perturb, port_model

CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]]
S, B, NC, STEPS, ACCUM = 64, 2, 8, 5, 2
N_MIN = B * S * S // 16
OPT = dict(lr0=0.2, max_iter=10, momentum=0.9, wd=5e-4, power=0.9, warmup_steps=1,
           warmup_start_lr=0.05)
EMA = dict(ema_decay=0.9, ema_tau=2.0)
LOSS_REL = 1e-5     # loss of each micro-step, of |ref|
UPDATE_REL = 2e-4   # params, BN statistics and EMA, of max|ref - start| a tensor


def _variables(seed=1):
    jm = JaxCABiNet(n_classes=NC, mode="small", cfgs=CFGS)
    v = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=False),
                seed=seed)
    return jm, v


def _batches(n=STEPS):
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((n, B, S, S, 3)).astype(np.float32)
    ys = rng.integers(0, NC, (n, B, S, S))
    ys[:, :, :3] = 255
    return xs, ys


CW = (np.random.default_rng(5).random(NC) + 0.5).astype(np.float32)


def _state_dict(tree):
    return state_dict_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), tree), CFGS)


@pytest.fixture(scope="module")
def runs():
    """Both trainers over the same micro-batches from the same weights:
    per micro-step losses, and after each update and the flush the
    params + BN statistics, the EMA variables and the counters."""
    jm, v = _variables()
    xs, ys = _batches()
    tx = build_optimizer(v["params"], max_grad_norm=1.0, **OPT)
    js = create_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx, **EMA)
    step = j_train_step(jm.apply, tx, n_min=N_MIN, class_weights=CW, accum_steps=ACCUM)
    flush = j_flush(tx)
    model = port_model(v, NC, "small", CFGS)
    ts = T.create_train_state(model, GroupedSGD(model, max_grad_norm=1.0, **OPT),
                              EMA["ema_decay"], EMA["ema_tau"])
    tstep = T.make_train_step(n_min=N_MIN, class_weights=CW, accum_steps=ACCUM)
    start = {k: t.clone() for k, t in model.state_dict().items()}
    out = {"loss": [], "snap": [], "start": start}

    def snap():
        out["snap"].append((
            _state_dict({"params": js.params, "batch_stats": js.batch_stats}),
            _state_dict(js.ema.variables),
            {k: t.clone() for k, t in ts.model.state_dict().items()},
            {k: t.clone() for k, t in ts.ema.shadow.items()},
            (int(js.step), int(js.micro_step), int(js.ema.updates)),
            (ts.step, ts.micro_step, ts.ema.updates)))

    for i in range(STEPS):
        js, jl = step(js, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        ts, tl = tstep(ts, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
        out["loss"].append((float(jl), float(tl)))
        if (i + 1) % ACCUM == 0:
            snap()
    js = flush(js)
    T.make_flush_step()(ts)
    snap()
    return out


def test_micro_step_losses_match_jax(runs):
    for i, (ref, got) in enumerate(runs["loss"]):
        assert abs(got - ref) <= LOSS_REL * abs(ref), (i, got, ref)


@pytest.mark.parametrize("when", [0, 1, 2], ids=["update1", "update2", "flush"])
def test_variables_after_updates_match_jax(runs, when):
    """Params and BN running mean/var, and the EMA's, within
    2e-4 * max|ref - start| of each tensor (plus 4 f32 ulps of its
    magnitude, `assert_updates_close`); the counters equal."""
    ref, ref_ema, got, got_ema, jcount, tcount = runs["snap"][when]
    start = runs["start"]
    assert tcount == jcount == ((when + 1, 0, when + 1))
    for g, r in ((got, ref), (got_ema, ref_ema)):
        keys = [k for k in r if not k.endswith("num_batches_tracked")]
        assert_updates_close({k: g[k] for k in keys}, {k: r[k] for k in keys},
                             {k: start[k] for k in keys}, rel=UPDATE_REL)
    moved = [k for k in ref if k.endswith("running_var")
             and not torch.equal(got[k], start[k])]
    assert moved  # train mode updated the statistics


def test_flush_is_a_no_op_on_an_empty_window():
    _, v = _variables(seed=3)
    model = port_model(v, NC, "small", CFGS)
    ts = T.create_train_state(model, GroupedSGD(model, **OPT))
    before = {k: t.clone() for k, t in model.state_dict().items()}
    T.make_flush_step()(ts)
    assert ts.step == 0 and ts.ema.updates == 0
    assert all(torch.equal(before[k], t) for k, t in model.state_dict().items())


def test_batch_norm_train_matches_flax():
    """A train-mode forward of the port's BatchNorm against flax's with
    mutable batch_stats on a (2, 8, 2, 2) input: the output, and the
    running mean and the biased running variance within 1e-6 (torch's own
    BatchNorm2d stores the unbiased variance, 8/7 of it here)."""
    from cabinet_tpu_torch.models.layers import batch_norm

    rng = np.random.default_rng(0)
    x = (3.0 * rng.standard_normal((2, 8, 2, 2)) + 1.0).astype(np.float32)
    bn = batch_norm(8).train()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(rng.standard_normal(8).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(rng.random(8).astype(np.float32) + 0.5))
        bn.weight.copy_(torch.from_numpy(rng.standard_normal(8).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.standard_normal(8).astype(np.float32)))
    m = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    v = {"params": {"scale": jnp.asarray(bn.weight.detach().numpy()),
                    "bias": jnp.asarray(bn.bias.detach().numpy())},
         "batch_stats": {"mean": jnp.asarray(bn.running_mean.numpy()),
                         "var": jnp.asarray(bn.running_var.numpy())}}
    xh = jnp.asarray(x.transpose(0, 2, 3, 1))
    y_ref, upd = m.apply(v, xh, use_running_average=False, mutable=["batch_stats"])
    y = bn(torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy().transpose(0, 2, 3, 1),
                               np.asarray(y_ref), atol=1e-5)
    for ours, key in ((bn.running_mean, "mean"), (bn.running_var, "var")):
        np.testing.assert_allclose(ours.numpy(), np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-6)
    assert int(bn.num_batches_tracked) == 1
    bn.eval()
    before = bn.running_var.clone()
    bn(torch.from_numpy(x))
    assert torch.equal(bn.running_var, before)  # eval mode updates nothing


def test_eval_loss_matches_jax():
    """make_eval_loss_step on the raw weights (eval-mode BN, no_grad)
    against JAX's, within 1e-5 of |ref|; the model's parameters and
    statistics are untouched."""
    jm, v = _variables(seed=4)
    xs, ys = _batches(1)
    ref = float(j_eval_loss(jm.apply, n_min=N_MIN, class_weights=CW)(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(xs[0]), jnp.asarray(ys[0])))
    model = port_model(v, NC, "small", CFGS).train()
    before = {k: t.clone() for k, t in model.state_dict().items()}
    got = float(T.make_eval_loss_step(model, n_min=N_MIN, class_weights=CW)(
        torch.from_numpy(xs[0]), torch.from_numpy(ys[0])))
    assert abs(got - ref) <= LOSS_REL * abs(ref), (got, ref)
    assert all(torch.equal(before[k], t) for k, t in model.state_dict().items())


def test_train_step_runs_einsum_attention_and_restores_the_kernel():
    """A model built with attention="kernel" trains through the einsum
    path (the kernel refuses autograd) and keeps "kernel" afterwards."""
    _, v = _variables(seed=5)
    model = port_model(v, NC, "small", CFGS, attention="kernel")
    ts = T.create_train_state(model, GroupedSGD(model, **OPT))
    xs, ys = _batches(1)
    T.make_train_step(n_min=N_MIN)(ts, torch.from_numpy(xs[0]), torch.from_numpy(ys[0]))
    assert ts.step == 1
    assert model.ab.a2block.global_attn.attention == "kernel"
    gamma = dict(model.named_parameters())["ab.a2block.gamma"]
    assert gamma.grad is None and ts.ema.updates == 1  # zeroed after the update


def _wrappers():
    """(name, call) of the three kernel wrappers at tiny shapes."""
    from cabinet_tpu_torch.ops.attention import fused_global_attention
    from cabinet_tpu_torch.ops.decoder_tail import fused_ffm_head
    from cabinet_tpu_torch.ops.early_stage import fused_stem_block0

    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    folded = {"w1_sp": r(128, 256), "w1_cp": r(256, 256), "b1": r(256),
              "w_se1": r(256, 64), "w_se2": r(64, 256), "w3": r(9, 256, 256),
              "b3": r(256), "wc": r(256, 16), "n_classes": 8}
    return [
        ("fused_global_attention",
         lambda x: fused_global_attention(x, r(2, 16, 32), r(2, 16, 32)), r(2, 16, 32)),
        ("fused_ffm_head",
         lambda x: fused_ffm_head(x, r(1, 8, 8, 256), folded), r(1, 8, 8, 128)),
        ("fused_stem_block0",
         lambda x: fused_stem_block0(x, r(16, 27), r(16), r(3, 3, 16), r(16),
                                     r(16, 16), r(16)), r(1, 8, 8, 3)),
    ]


@pytest.mark.parametrize("case", range(3), ids=["K1", "K2+K3", "K4"])
def test_kernel_wrappers_refuse_autograd(case):
    """Each wrapper raises under autograd on an input that requires grad,
    on the CPU too (its plain version is not a silent fallback), and runs
    under no_grad or on inputs that require none."""
    name, call, x = _wrappers()[case]
    with pytest.raises(RuntimeError, match="no backward"):
        call(x.clone().requires_grad_())
    with torch.no_grad():
        call(x.clone().requires_grad_())
    out = call(x)
    assert out.grad_fn is None
