"""Tensor parallelism in the pipeline (`runtime.pipeline_tp`,
`runtime.eval_model_axis`), on gloo CPU ranks, each a process of
tests/torch_dp_worker.py under a time limit, held against the JAX package
(tests/unit/test_pipeline.py, tests/unit/test_mesh_and_sharded_eval.py);
the train mains on ranks are in tests/test_torch_tp_mains.py:
  - PP x TP x DP (`:289 test_pipeline_tp_composition_matches_fused`): the
    2-stage pipeline of the small CABiNet, each stage cut over model groups
    of 2 ranks, 2 data ranks (4 in all), one window of 2 microbatches,
    against JAX's fused trainer at accum_steps 2 on the same weights and
    microbatches, at JAX's bound (rtol 1e-4, atol 1e-6) and the loss within
    1e-5; leaves really split;
  - the merged EMA weights on an eval mesh of their own (`:360
    test_pipeline_merged_variables_on_mesh`): gathered whole from the
    stages' slices, cut again bit-equal, cut for a (1, 4) eval mesh, and
    MscEval's matrix over them that of the whole weights in one process."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dp import run_case
from torch_dp_worker import TP_CFGS as CFGS
from torch_port_utils import perturb

B, S, NC, M = 4, 64, 5, 2
N_MIN = (B // M) * S * S // 16
OPT = dict(lr0=0.2, max_iter=10, momentum=0.9, wd=5e-4, power=0.9, warmup_steps=1,
           warmup_start_lr=0.05)
EMA = dict(ema_decay=0.9, ema_tau=2.0)
LOSS_REL = 1e-5
RTOL, ATOL = 1e-4, 1e-6  # JAX's bound for the pipeline against the fused trainer


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def composition(tmp_path_factory):
    """JAX's fused trainer (accum M) and the port's PP x TP x DP window on
    4 ranks, on JAX's initial weights (perturbed so that the CAB's global
    attention reaches the output)."""
    from cabinet_tpu.models import CABiNet as JaxCABiNet
    from cabinet_tpu.train.optimizer import build_optimizer
    from cabinet_tpu.train.trainer import create_train_state, make_train_step
    from cabinet_tpu_torch.utils.convert import state_dict_from_jax

    model = JaxCABiNet(n_classes=NC, mode="small", cfgs=CFGS)
    v = perturb(model.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=True), seed=4)
    rng = np.random.default_rng(7)
    images = rng.normal(size=(B, S, S, 3)).astype(np.float32)
    labels = rng.integers(0, NC, (B, S, S)).astype(np.int64)
    tx = build_optimizer(v["params"], max_grad_norm=1.0, **OPT)
    state = create_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx, **EMA)
    step = make_train_step(model.apply, tx, n_min=N_MIN, accum_steps=M)
    mb, losses = B // M, []
    for m in range(M):
        state, loss = step(state, jnp.asarray(images[m * mb:(m + 1) * mb]),
                           jnp.asarray(labels[m * mb:(m + 1) * mb]))
        losses.append(float(loss))

    def sd(tree):
        return state_dict_from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), tree), CFGS)
    ref = {"loss": float(np.mean(losses)),
           "state": sd({"params": state.params, "batch_stats": state.batch_stats}),
           "ema": sd(state.ema.variables)}
    start = state_dict_from_jax(v, CFGS)
    eval_rng = np.random.default_rng(3)
    ev_images = eval_rng.normal(size=(1, S, S, 3)).astype(np.float32)
    ev_labels = eval_rng.integers(0, NC, (1, S, S)).astype(np.int64)
    xs = [torch.from_numpy(images[m * mb:(m + 1) * mb]) for m in range(M)]
    ys = [torch.from_numpy(labels[m * mb:(m + 1) * mb]) for m in range(M)]
    got = run_case(tmp_path_factory.mktemp("pp_tp"), "tp_pipeline", {
        "state_dict": start, "opt": OPT, "ema": EMA, "n_min": N_MIN, "xs": xs, "ys": ys,
        "mesh": (2, 2), "eval_model_axis": 4, "images": ev_images, "labels": ev_labels},
        ranks=4)
    return ref, got, start, (ev_images, ev_labels)


def test_pipeline_tp_composition_matches_fused(composition):
    ref, got, start, _ = composition
    for o in got:
        assert o["n_sharded"] > 0, "pipeline_tp=2 split no stage leaf"
        assert o["steps"] == [1, 1]
        assert o["losses"][0] is None and abs(o["losses"][1] - ref["loss"]) <= LOSS_REL * abs(
            ref["loss"])
        for kind in ("state", "ema"):
            for k, want in ref[kind].items():
                if k.endswith("num_batches_tracked"):
                    continue
                np.testing.assert_allclose(o[kind][k].numpy(), want.numpy(), rtol=RTOL,
                                           atol=ATOL, err_msg=f"{kind} {k}")
        for kind in ("state", "ema"):  # one copy of the whole model on every rank
            assert all(torch.equal(o[kind][k], got[0][kind][k]) for k in o[kind])


def test_pipeline_merged_variables_on_mesh(composition):
    """The stages' slices gathered whole and cut again bit-equal; the merged
    EMA weights cut for a (1, 4) eval mesh (more leaves split than the
    stages' 2-way cut allows); MscEval over them gives one process's
    matrix on the whole EMA weights, but for near ties."""
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.models.cabinet import CABiNet

    _, got, _, (images, labels) = composition
    one = CABiNet(NC, mode="small", cfgs=CFGS)
    one.load_state_dict(got[0]["ema"], strict=True)
    one.eval()

    def fwd(_, x):
        with torch.no_grad():
            return tuple(t.permute(0, 2, 3, 1) for t in one(x.permute(0, 3, 1, 2)))

    want = MscEval(fwd, NC, scales=(1.0,), cropsize=32, device="cpu").hist_batch(
        None, images, labels)
    for o in got:
        assert o["slices_equal"]
        assert o["eval_sharded"] > 0
        assert o["hist"].sum() == S * S
        assert np.abs(o["hist"] - want).sum() / 2 <= 1e-3 * S * S, (o["hist"], want)
