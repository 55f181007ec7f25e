"""The port's bf16 training step (autocast over f32 master weights, no loss
scaler) against the JAX package's `compute_dtype=bfloat16` step (bf16
matmuls over f32 params) on the small CABiNet of test_torch_train_step.py:
3 micro-batches at accum_steps=2 (one update and a flush).

Bounds: the loss of each micro-step within 2e-2 of |ref|; the update of
all parameters together, |Δ_port - Δ_jax|_2 / |Δ_jax|_2, under 0.5
(measured 0.184 here, and 0.19-0.31 over the updates of a 5-step run: bf16
rounds the activations, and the two frameworks round them at different
places, BN among them, so the updates agree in direction, not to f32
precision). The counters are equal."""

import jax
import jax.numpy as jnp
import torch

from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.train.optimizer import build_optimizer
from cabinet_tpu.train.trainer import create_train_state
from cabinet_tpu.train.trainer import make_flush_step as j_flush
from cabinet_tpu.train.trainer import make_train_step as j_train_step
from cabinet_tpu_torch.train import trainer as T
from cabinet_tpu_torch.train.optimizer import GroupedSGD
from test_torch_train_step import ACCUM, CFGS, CW, EMA, N_MIN, NC, OPT, _batches, _state_dict
from torch_port_utils import perturb, port_model

LOSS_REL, UPDATE_REL = 2e-2, 0.5


def test_bf16_step_matches_jax():
    jm = JaxCABiNet(n_classes=NC, mode="small", cfgs=CFGS, dtype=jnp.bfloat16)
    v = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False),
                seed=1)
    xs, ys = _batches(3)
    tx = build_optimizer(v["params"], max_grad_norm=1.0, **OPT)
    js = create_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx, **EMA)
    step = j_train_step(jm.apply, tx, n_min=N_MIN, class_weights=CW, accum_steps=ACCUM,
                        compute_dtype=jnp.bfloat16)
    model = port_model(v, NC, "small", CFGS)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    ts = T.create_train_state(model, GroupedSGD(model, max_grad_norm=1.0, **OPT),
                              EMA["ema_decay"], EMA["ema_tau"])
    tstep = T.make_train_step(n_min=N_MIN, class_weights=CW, accum_steps=ACCUM,
                              compute_dtype=torch.bfloat16)
    for i in range(3):
        js, jl = step(js, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
        ts, tl = tstep(ts, torch.from_numpy(xs[i]), torch.from_numpy(ys[i]))
        assert abs(float(tl) - float(jl)) <= LOSS_REL * abs(float(jl)), (i, tl, jl)
    js = j_flush(tx)(js)
    T.make_flush_step()(ts)
    assert (ts.step, ts.micro_step, ts.ema.updates) == (
        int(js.step), int(js.micro_step), int(js.ema.updates)) == (2, 0, 2)
    ref = _state_dict({"params": js.params, "batch_stats": js.batch_stats})
    got = dict(model.named_parameters())
    num = sum(float(((got[k].detach() - ref[k]) ** 2).sum()) for k in start)
    den = sum(float(((ref[k] - start[k]) ** 2).sum()) for k in start)
    assert den > 0 and (num / den) ** 0.5 < UPDATE_REL, (num / den) ** 0.5
    assert all(p.dtype == torch.float32 for p in got.values())  # f32 masters
