"""The port's pipeline-parallel trainer (cabinet_tpu_torch.train.pipeline)
on the CPU, its stages on the CPU:
  - split and merge of a state dict by stage, and the refusals of a module
    no stage covers (one holding only buffers too);
  - one 2-stage CABiNet window against JAX's `CabinetPipeline` on the same
    weights and microbatches (clip engaged and dormant), and YOLO-sem's 2-
    and 3-stage windows against JAX's: params, BatchNorm statistics and
    EMA within the suite's f32 bound of the update, the loss within 1e-5;
  - the port's pipeline against the port's fused trainer at accum_steps=M
    (which `test_torch_train_step.py` holds against JAX), at JAX's own
    bound (rtol 1e-4, atol 1e-6): CABiNet and YOLO-sem, clip engaged and
    dormant, a trailing partial window, device augmentation with the fused
    trainer's draws, and BatchNorm's statistics advancing once a
    microbatch;
  - the stage-count and axis refusals of the train CLIs;
  - `cli/train.py` main with runtime.pipeline=2 (2 epochs; a resume
    bit-equal to the uninterrupted run; its EMA `.pth` read by evaluate
    main) and `cli/train_yolo.py` main with runtime.pipeline=3.

JAX's pipeline compiles a program a stage, so it runs once per family, in
module-scoped fixtures."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu_torch.core.config import Config
from cabinet_tpu_torch.core.exceptions import ConfigurationError
from cabinet_tpu_torch.train import pipeline as P
from cabinet_tpu_torch.train import trainer as T
from cabinet_tpu_torch.train.optimizer import GroupedSGD
from torch_port_utils import assert_updates_close, perturb, yolo_variables

CFGS = [[3, 1, 16, 0, 0, 1], [3, 4, 24, 0, 0, 2], [5, 3, 40, 1, 0, 2], [5, 6, 96, 1, 1, 2]]
B, H, W, C = 4, 64, 64, 5
M = 2
N_MIN = (B // M) * H * W // 16
OPT = dict(lr0=0.2, max_iter=10, momentum=0.9, wd=5e-4, power=0.9, warmup_steps=1,
           warmup_start_lr=0.05)
EMA = dict(ema_decay=0.9, ema_tau=2.0)
LOSS_REL = 1e-5
UPDATE_REL = 2e-4
RTOL, ATOL = 1e-4, 1e-6  # JAX's bound for the pipeline against the fused trainer
CLIPS = {"clip-engaged": 1.0, "clip-dormant": 1e6}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: a multi-threaded CPU conv backward rounds apart
    from run to run (test_torch_train_yolo.py), which two updates of
    train-mode BN amplify; and one thread a worker is the fastest under
    the suite's worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(seed=7):
    rng = np.random.default_rng(seed)
    images = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    labels = rng.integers(0, C, (B, H, W)).astype(np.int64)
    labels[:, :3] = 255
    return images, labels


def _cabinet_variables():
    from cabinet_tpu.models import CABiNet as JaxCABiNet

    jm = JaxCABiNet(n_classes=C, mode="small", cfgs=CFGS)
    v = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), train=False), seed=1)
    return jm, v


def _cabinet_state_dict(tree):
    from cabinet_tpu_torch.utils.convert import state_dict_from_jax

    return state_dict_from_jax(jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                                      tree), CFGS)


def _yolo_state_dict(tree, variant="n"):
    from cabinet_tpu_torch.utils.convert import yolosem_state_dict_from_jax

    return yolosem_state_dict_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), tree), variant)


def _port_model(family, sd):
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.yolosem import YOLOSem

    model = CABiNet(C, mode="small", cfgs=CFGS) if family == "cabinet" else YOLOSem(C, "n")
    model.load_state_dict(sd, strict=True)
    return model


def _stages(n_stages, family):
    if family == "cabinet":
        return P.CABINET_STAGE_KEYS, None
    return ((P.YOLOSEM_STAGE_KEYS, P.YOLOSEM_STAGE_METHODS) if n_stages == 2
            else (P.YOLOSEM_STAGE_KEYS_3, P.YOLOSEM_STAGE_METHODS_3))


def _loss_kw(family):
    return {} if family == "cabinet" else {"loss_type": "ce", "aux_weight": 0.4}


def port_pipeline(family, sd, clip, n_stages=2, aug_fn=None):
    keys, methods = _stages(n_stages, family)
    pipe = P.CabinetPipeline(
        _port_model(family, sd), lambda stage: GroupedSGD(stage, max_grad_norm=None, **OPT),
        n_min=N_MIN, num_microbatches=M, devices=["cpu"] * n_stages, max_grad_norm=clip,
        stage_keys=keys, stage_methods=methods, aug_fn=aug_fn, **_loss_kw(family), **EMA)
    return pipe, pipe.init_state(sd)


def port_fused(family, sd, clip, micro):
    """The fused trainer at accum_steps=M over `micro`, then its flush:
    (state, per-microbatch losses)."""
    model = _port_model(family, sd)
    state = T.create_train_state(model, GroupedSGD(model, max_grad_norm=clip, **OPT), **EMA)
    step = T.make_train_step(n_min=N_MIN, accum_steps=M, **_loss_kw(family))
    losses = []
    for x, y in micro:
        state, loss = step(state, torch.as_tensor(x), torch.as_tensor(y))
        losses.append(float(loss))
    T.make_flush_step()(state)
    return state, losses


def jax_pipeline(family, variables, images, labels, clip, n_stages=2, pipe=None):
    """JAX's CabinetPipeline, one window over the batch: (merged
    {"params", "batch_stats"}, merged EMA variables, loss, steps, the
    pipeline). A `pipe` given is reused with its clip set to `clip`
    (its stage programs compiled once; `init_state` rebuilds the update)."""
    from cabinet_tpu.train import pipeline as JP
    from cabinet_tpu.train.optimizer import build_optimizer

    if family == "cabinet":
        from cabinet_tpu.models import CABiNet as JaxCABiNet

        model, kw = JaxCABiNet(n_classes=C, mode="small", cfgs=CFGS), {}
    else:
        from cabinet_tpu.models.yolosem import YOLOSem as JaxYOLOSem

        keys, methods = ((JP.YOLOSEM_STAGE_KEYS, JP.YOLOSEM_STAGE_METHODS) if n_stages == 2
                         else (JP.YOLOSEM_STAGE_KEYS_3, JP.YOLOSEM_STAGE_METHODS_3))
        model = JaxYOLOSem(n_classes=C, variant="n")
        kw = dict(stage_keys=keys, stage_methods=methods)
    if pipe is None:
        pipe = JP.CabinetPipeline(
            model, tx_factory=lambda p: build_optimizer(p, max_grad_norm=None, **OPT),
            n_min=N_MIN, num_microbatches=M, meshes=JP.make_pipeline_meshes(n_stages, dp=1),
            max_grad_norm=clip, **_loss_kw(family), **kw, **EMA)
    pipe.max_grad_norm = clip
    states = pipe.init_state(variables)
    states, loss = pipe.train_step(states, images, labels.astype(np.int32))
    return (pipe.merged_variables(states), pipe.merged_ema_variables(states), float(loss),
            [int(s.step) for s in states], pipe)


def assert_held(got, ref, start):
    """Every float tensor of `ref` (a state dict) within the suite's bound
    of its update from `start`; the step counters equal."""
    keys = [k for k in ref if not k.endswith("num_batches_tracked")]
    assert_updates_close({k: got[k] for k in keys}, {k: ref[k] for k in keys},
                         {k: start[k] for k in keys}, rel=UPDATE_REL)


def assert_allclose_sd(got, ref):
    """JAX's own bound for the pipeline against the fused trainer: every
    entry within atol + rtol * |ref|; integer buffers equal."""
    assert got.keys() == ref.keys()
    for k, r in ref.items():
        if not r.is_floating_point():
            assert torch.equal(got[k], r), k
            continue
        np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=RTOL, atol=ATOL,
                                   err_msg=k)


def _micro(images, labels, n=M):
    mb = images.shape[0] // M
    return [(images[m * mb:(m + 1) * mb], labels[m * mb:(m + 1) * mb]) for m in range(n)]


# ---------------------------------------------------------------------------
# split / merge
# ---------------------------------------------------------------------------

def test_split_merge_round_trip_and_refusals():
    from cabinet_tpu_torch.models.cabinet import CABiNet

    sd = CABiNet(C, mode="small", cfgs=CFGS).state_dict()
    parts = P.split_variables(sd, P.CABINET_STAGE_KEYS)
    assert {k.split(".")[0] for k in parts[0]} == {"mobile"}
    assert {k.split(".")[0] for k in parts[1]} == {"sb", "ab", "ffm", "conv_out"}
    merged = P.merge_variables(parts)
    assert merged.keys() == sd.keys() and all(merged[k] is sd[k] for k in sd)
    on = P.merge_variables(parts, torch.device("cpu"))
    assert all(torch.equal(on[k], sd[k]) for k in sd)
    with pytest.raises(ValueError, match="do not cover"):
        P.split_variables(sd, (("mobile",), ("sb", "ab", "ffm")))
    # a module holding only buffers is refused as well
    with pytest.raises(ValueError, match="orphan"):
        P.split_variables({**sd, "orphan.running_mean": torch.zeros(2)},
                          P.CABINET_STAGE_KEYS)


def test_stage_state_dicts_are_the_models():
    """Each stage holds copies of whole top-level modules under their own
    names: together they load back into the full model, strict."""
    from cabinet_tpu_torch.models.yolosem import YOLOSem

    model = YOLOSem(C, "n")
    pipe = P.CabinetPipeline(model, lambda s: GroupedSGD(s, **OPT), n_min=1,
                             num_microbatches=2, devices=["cpu"] * 3,
                             stage_keys=P.YOLOSEM_STAGE_KEYS_3,
                             stage_methods=P.YOLOSEM_STAGE_METHODS_3)
    states = pipe.init_state(model.state_dict())
    for keys, s in zip(P.YOLOSEM_STAGE_KEYS_3, states):
        assert {k.split(".")[0] for k in s.model.state_dict()} == set(keys)
    YOLOSem(C, "n").load_state_dict(P.merged(states), strict=True)
    assert states[0].model.stem is not model.stem


# ---------------------------------------------------------------------------
# against JAX's CabinetPipeline (once per family)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cabinet_runs():
    _, v = _cabinet_variables()
    images, labels = _batch()
    sd = _cabinet_state_dict(v)
    out = {"start": sd}
    jax_pipe = None
    for name, clip in CLIPS.items():
        jm, jema, jloss, jsteps, jax_pipe = jax_pipeline("cabinet", v, images, labels, clip,
                                                         pipe=jax_pipe)
        pipe, states = port_pipeline("cabinet", sd, clip)
        states, loss = pipe.train_step(states, torch.from_numpy(images),
                                       torch.from_numpy(labels))
        out[name] = {"ref": _cabinet_state_dict(jm), "ref_ema": _cabinet_state_dict(jema),
                     "ref_loss": jloss, "ref_steps": jsteps,
                     "got": P.merged(states),
                     "got_ema": P.merged(states, ema=True), "loss": float(loss),
                     "steps": [s.step for s in states]}
    return out


@pytest.mark.parametrize("clip", list(CLIPS))
def test_cabinet_window_matches_jax(cabinet_runs, clip):
    r = cabinet_runs[clip]
    assert r["steps"] == r["ref_steps"] == [1, 1]
    assert abs(r["loss"] - r["ref_loss"]) <= LOSS_REL * abs(r["ref_loss"])
    assert_held(r["got"], r["ref"], cabinet_runs["start"])
    assert_held(r["got_ema"], r["ref_ema"], cabinet_runs["start"])


def test_cabinet_clip_engaged_changes_the_update(cabinet_runs):
    """The engaged clip scaled the update: the two runs differ."""
    a, b = cabinet_runs["clip-engaged"]["got"], cabinet_runs["clip-dormant"]["got"]
    assert any(not torch.equal(a[k], b[k]) for k in a if a[k].is_floating_point())


@pytest.fixture(scope="module")
def yolo_runs():
    v = yolo_variables(C, "n", size=H, seed=0)
    images, labels = _batch(seed=3)
    sd = _yolo_state_dict(v)
    out = {"start": sd}
    for n_stages in (2, 3):
        jax_pipe = None
        for name, clip in CLIPS.items():
            jm, jema, jloss, jsteps, jax_pipe = jax_pipeline("yolosem", v, images, labels, clip,
                                                             n_stages, pipe=jax_pipe)
            pipe, states = port_pipeline("yolosem", sd, clip, n_stages)
            states, loss = pipe.train_step(states, torch.from_numpy(images),
                                           torch.from_numpy(labels))
            out[n_stages, name] = {"ref": _yolo_state_dict(jm),
                                   "ref_ema": _yolo_state_dict(jema),
                                   "ref_loss": jloss, "ref_steps": jsteps,
                                   "got": P.merged(states),
                                   "got_ema": P.merged(states, ema=True),
                                   "loss": float(loss), "steps": [s.step for s in states]}
    return out


@pytest.mark.parametrize("n_stages", [2, 3])
@pytest.mark.parametrize("clip", list(CLIPS))
def test_yolosem_window_matches_jax(yolo_runs, n_stages, clip):
    r = yolo_runs[n_stages, clip]
    assert r["steps"] == r["ref_steps"] == [1] * n_stages
    assert abs(r["loss"] - r["ref_loss"]) <= LOSS_REL * abs(r["ref_loss"])
    assert_held(r["got"], r["ref"], yolo_runs["start"])
    assert_held(r["got_ema"], r["ref_ema"], yolo_runs["start"])


# ---------------------------------------------------------------------------
# against the port's fused trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family,n_stages", [("cabinet", 2), ("yolosem", 2), ("yolosem", 3)])
@pytest.mark.parametrize("clip", list(CLIPS.values()), ids=list(CLIPS))
def test_window_matches_fused_accumulation(family, n_stages, clip):
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.yolosem import YOLOSem

    torch.manual_seed(0)
    sd = (CABiNet(C, mode="small", cfgs=CFGS) if family == "cabinet"
          else YOLOSem(C, "n")).state_dict()
    images, labels = _batch(seed=11)
    fused, losses = port_fused(family, sd, clip, _micro(images, labels))
    pipe, states = port_pipeline(family, sd, clip, n_stages)
    states, loss = pipe.train_step(states, torch.from_numpy(images), torch.from_numpy(labels))
    assert np.isclose(float(loss), np.mean(losses), rtol=RTOL)
    assert_allclose_sd(P.merged(states), fused.model.state_dict())
    assert_allclose_sd(P.merged(states, ema=True), fused.ema.state_dict())
    assert all(s.step == 1 for s in states) and fused.step == 1
    assert fused.ema.updates == states[0].ema.updates == 1


def test_trailing_flush_matches_fused():
    """3 microbatches at M=2 through PipelineTrainLoop (a window, then a
    trailing partial one at the 1/M scale) against the fused trainer's 3
    micro-steps and flush."""
    from cabinet_tpu_torch.models.cabinet import CABiNet

    torch.manual_seed(0)
    sd = CABiNet(C, mode="small", cfgs=CFGS).state_dict()
    images, labels = _batch(seed=5)
    micro = _micro(images, labels) + [(images[:B // M][::-1].copy(),
                                       labels[:B // M][::-1].copy())]
    fused, losses = port_fused("cabinet", sd, 1.0, micro)
    pipe, states = port_pipeline("cabinet", sd, 1.0)
    loop = P.PipelineTrainLoop(pipe, states)
    got = [loop.feed(x, y) for x, y in micro]
    assert got[0] is None and got[2] is None  # mid-window: buffered
    assert np.isclose(got[1], np.mean(losses[:2]), rtol=RTOL)
    flushed = loop.flush()
    assert np.isclose(flushed, losses[2], rtol=RTOL)  # mean of a 1-microbatch window
    assert loop.flush() is None and loop.step == fused.step == 2
    assert_allclose_sd(loop.weights(), fused.model.state_dict())
    assert_allclose_sd(loop.weights(ema=True), fused.ema.state_dict())


def test_fused_loop_has_the_pipeline_loops_surface(tmp_path):
    """`trainer.TrainLoop`, the train CLIs' loop over the fused step, with
    the pipeline loop's surface: 3 microbatches fed at M=2 and flushed give
    the fused trainer's losses, weights and EMA bit for bit; and
    `CheckpointManager.save_full`/`restore_full` take either loop's state
    (a TrainState, or the stages' list) and put it back bit for bit."""
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.train.checkpoint import CheckpointManager

    torch.manual_seed(0)
    sd = CABiNet(C, mode="small", cfgs=CFGS).state_dict()
    images, labels = _batch(seed=5)
    micro = _micro(images, labels) + [(images[:B // M], labels[:B // M])]
    fused, losses = port_fused("cabinet", sd, 1.0, micro)

    def fused_loop():
        model = _port_model("cabinet", sd)
        return T.TrainLoop(T.create_train_state(model, GroupedSGD(model, max_grad_norm=1.0,
                                                                  **OPT), **EMA),
                           T.make_train_step(n_min=N_MIN, accum_steps=M), torch.device("cpu"))

    loop = fused_loop()
    assert [float(loop.feed(x, y)) for x, y in micro] == losses
    assert loop.flush() is None and loop.step == fused.step == 2
    assert _tree_equal(loop.weights(), fused.model.state_dict())
    assert _tree_equal(loop.weights(ema=True, device="cpu"), fused.ema.state_dict())

    pipe_loop = P.PipelineTrainLoop(*port_pipeline("cabinet", sd, 1.0))
    for x, y in micro:
        pipe_loop.feed(x, y)
    pipe_loop.flush()
    ckpt = CheckpointManager(tmp_path)
    stopper = {"best_fitness": 0.5, "best_epoch": 1}
    for name, saved, fresh in (("fused", loop, fused_loop()),
                               ("pipe", pipe_loop,
                                P.PipelineTrainLoop(*port_pipeline("cabinet", sd, 1.0)))):
        ckpt.save_full(name, saved.state, 1, 0.5, 1.0, stopper)
        assert ckpt.restore_full(name, fresh.state)["epoch"] == 1
        assert fresh.step == saved.step == 2
        for ema in (False, True):
            assert _tree_equal(fresh.weights(ema=ema), saved.weights(ema=ema))


class _Recipe:
    """The attributes DeviceAugment reads from a train dataset."""

    RECIPE, geometric = "aerial", "device"
    MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    aug = {"degrees": 10.0, "translate": 0.05, "scale": 0.3, "fliplr": 0.5,
           "flipud": 0.2, "hsv_h": 0.01, "hsv_s": 0.4, "hsv_v": 0.3, "mixup": 0.5}


def test_device_augmentation_draws_as_the_fused_trainer():
    """The pipeline with DeviceAugment (the exact warp and the aerial chain
    with mixup) on stage 0 over 4 raw canvas microbatches (2 windows)
    against the fused trainer fed `augment(batch, step, micro_step)`: the
    same crops, the same updates."""
    from cabinet_tpu_torch.cli.train import DeviceAugment
    from cabinet_tpu_torch.models.cabinet import CABiNet

    cfg = Config({"runtime": {"seed": 3, "device_geometric": "true"},
                  "dataset": {"ignore_idx": 255}})
    augment = DeviceAugment(cfg, _Recipe(), torch.device("cpu"), (H, W))
    rng = np.random.default_rng(4)
    mb, S = B // M, H + 16
    raws = [(rng.integers(0, 256, (mb, S, S, 3), dtype=np.uint8),
             rng.integers(0, C, (mb, S, S), dtype=np.uint8),
             np.array([[S, S - 8], [S - 4, S]], np.int32)) for _ in range(4)]
    torch.manual_seed(0)
    sd = CABiNet(C, mode="small", cfgs=CFGS).state_dict()
    model = _port_model("cabinet", sd)
    fused = T.create_train_state(model, GroupedSGD(model, max_grad_norm=1.0, **OPT), **EMA)
    step = T.make_train_step(n_min=N_MIN, accum_steps=M)
    for raw in raws:
        fused, _ = step(fused, *augment(raw, fused.step, fused.micro_step))
    seen = []

    def aug_fn(raw, step_, micro_step):
        seen.append((step_, micro_step))
        return augment(raw, step_, micro_step)

    pipe, states = port_pipeline("cabinet", sd, 1.0, aug_fn=aug_fn)
    loop = P.PipelineTrainLoop(pipe, states)
    assert [loop.feed(*raw) is None for raw in raws] == [True, False, True, False]
    assert seen == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert_allclose_sd(loop.weights(), fused.model.state_dict())
    assert_allclose_sd(loop.weights(ema=True), fused.ema.state_dict())


def test_batch_norm_statistics_advance_once_a_microbatch():
    """Stage 0's backward recomputes its forward with the running
    statistics kept: num_batches_tracked counts the microbatches, in every
    stage, as the fused trainer's does."""
    from cabinet_tpu_torch.models.cabinet import CABiNet

    sd = CABiNet(C, mode="small", cfgs=CFGS).state_dict()
    images, labels = _batch()
    pipe, states = port_pipeline("cabinet", sd, None)
    states, _ = pipe.train_step(states, torch.from_numpy(images), torch.from_numpy(labels))
    counts = {k: int(v) for k, v in P.merged(states).items()
              if k.endswith("num_batches_tracked")}
    assert counts and set(counts.values()) == {M}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_engine_refuses_stage_mismatches():
    from cabinet_tpu_torch.models.cabinet import CABiNet

    model = CABiNet(C, mode="small", cfgs=CFGS)
    tx = lambda s: GroupedSGD(s, **OPT)  # noqa: E731
    with pytest.raises(ValueError, match="stage_methods"):
        P.CabinetPipeline(model, tx, N_MIN, M, ["cpu"] * 3,
                          stage_keys=(("mobile",), ("sb", "ab"), ("ffm", "conv_out")))
    with pytest.raises(ValueError, match=">= 2"):
        P.CabinetPipeline(model, tx, N_MIN, M, ["cpu"], stage_keys=(("mobile",),))
    with pytest.raises(ValueError, match="stage_keys"):
        P.CabinetPipeline(model, tx, N_MIN, M, ["cpu"] * 2,
                          stage_keys=P.YOLOSEM_STAGE_KEYS_3,
                          stage_methods=P.YOLOSEM_STAGE_METHODS_3)
    assert P.make_pipeline_devices(3, "cpu") == [torch.device("cpu")] * 3


def _cfg(**runtime):
    return Config({"runtime": runtime, "training_config": {"batch_size": 4}})


@pytest.mark.parametrize("family,runtime,error,match", [
    ("cabinet", {"pipeline": 3}, ConfigurationError, "pins at 2 stages"),
    ("cabinet", {"pipeline": 2, "model_axis": 2}, ConfigurationError, "cannot combine"),
    ("cabinet", {"pipeline": 2, "spatial_axis": True}, ConfigurationError, "cannot combine"),
    ("cabinet", {"pipeline": 2, "pipeline_dp": 3}, ConfigurationError, "must divide"),
    ("cabinet", {"pipeline": 2, "pipeline_dp": 2}, ConfigurationError, "one process a rank"),
    ("cabinet", {"pipeline": 2, "pipeline_tp": 2}, ConfigurationError, "pipeline_tp=2 must"),
    ("cabinet", {"pipeline": 2, "eval_model_axis": 2}, ConfigurationError,
     "eval_model_axis=2 must"),
    ("yolosem", {"pipeline": 4}, ConfigurationError, "2-stage"),
    ("yolosem", {"pipeline": 3, "pipeline_dp": 3}, ConfigurationError, "must divide"),
])
def test_pipeline_refusals_are_jaxs(family, runtime, error, match):
    from cabinet_tpu_torch.cli.train import pipeline_stages

    with pytest.raises(error, match=match):
        pipeline_stages(_cfg(**runtime), family)


def test_pipeline_stage_counts_taken():
    from cabinet_tpu_torch.cli.train import pipeline_stages

    assert pipeline_stages(_cfg(pipeline=0)) == 0
    assert pipeline_stages(_cfg(pipeline=2, pipeline_dp=1)) == 2
    assert pipeline_stages(_cfg(pipeline=3), "yolosem") == 3


# ---------------------------------------------------------------------------
# the train CLIs
# ---------------------------------------------------------------------------

def _tree_equal(a, b):
    if torch.is_tensor(a):
        return torch.equal(a, b)
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return a == b


def test_train_main_pipeline_resumes_bit_exactly(tmp_path):
    """runtime.pipeline=2, accum 2 (4 frames at batch 2: one window an
    epoch), 2 epochs with the device warp; then 1 epoch and a resume to 2:
    the checkpoints and EMA weights equal the uninterrupted run's bit for
    bit; evaluate main scores the EMA `.pth`."""
    from cabinet_tpu_torch.cli.evaluate import main as evaluate_main
    from cabinet_tpu_torch.cli.train import main
    from test_torch_cli_train import TINY_MODEL, make_uavid_tree, overrides

    data = make_uavid_tree(tmp_path / "data", n=4)
    extra = ["training_config.accum_steps=2", "runtime.pipeline=2",
             "runtime.device_geometric=true", "--device", "cpu"]
    res = main(overrides("uavid", data, tmp_path / "a", crop=32) + extra)
    main(overrides("uavid", data, tmp_path / "b", crop=32, epochs=1) + extra)
    res2 = main(overrides("uavid", data, tmp_path / "b", crop=32)
                + ["training_config.resume=true"] + extra)
    assert res["timing"]["optimizer_steps"] == 2 and res2["timing"]["optimizer_steps"] == 1
    assert res["timing"]["device_aug_seconds"] > 0
    lines = [json.loads(ln) for ln in (tmp_path / "a" / "metrics.jsonl").read_text().splitlines()]
    assert [ln["step"] for ln in lines[1:]] == [1, 2]
    assert all(np.isfinite(ln["train_loss"]) for ln in lines[1:])
    blob = torch.load(tmp_path / "a" / "checkpoint_last.pth", weights_only=True)
    assert len(blob["stages"]) == 2
    meta = json.loads((tmp_path / "a" / "checkpoint_last.meta.json").read_text())
    assert meta["pipeline_stages"] == 2 and meta["epoch"] == 1
    for name in ("checkpoint_last.pth", "tiny.pth"):
        assert _tree_equal(torch.load(tmp_path / "a" / name, weights_only=True),
                           torch.load(tmp_path / "b" / name, weights_only=True)), name
    ev = evaluate_main(TINY_MODEL + [f"checkpoint_path={tmp_path / 'a' / 'tiny.pth'}",
                                     "dataset=uavid", f"dataset.dataset_path={data}",
                                     "dataset.cropsize=[32,32]", "validation_config.batch_size=1",
                                     "validation_config.num_workers=0",
                                     "validation_config.eval_scales=[1.0]",
                                     "validation_config.flip=false", "--device", "cpu"])
    assert ev["mIoU"] == pytest.approx(res["final"]["mIoU"], abs=1e-12)


def test_train_yolo_main_three_stages(tmp_path):
    """`cli/train_yolo.py` main with +runtime.pipeline=3 and the device
    chain: 2 epochs of one window, a resume from `last` equal to the
    uninterrupted run's `final`, and mode=val on it."""
    from cabinet_tpu_torch.cli.train_yolo import main
    from test_torch_cli_train import make_uavid_tree

    data = make_uavid_tree(tmp_path / "data", n=4, size=(32, 32))

    def argv(exp, epochs, *extra):
        return ["dataset=uavid", f"dataset.dataset_path={data}", "training_config.imgsz=32",
                "training_config.batch_size=2", "training_config.nbs=4",
                f"training_config.epochs={epochs}", "training_config.num_workers=0",
                "validation_config.num_workers=0", "validation_config.batch_size=1",
                f"training_config.experiments_path={exp}", "runtime.compute_dtype=float32",
                "+runtime.pipeline=3", "+runtime.device_augs=true", *extra, "--device", "cpu"]

    res = main(argv(tmp_path / "a", 2))
    assert res["timing"]["optimizer_steps"] == 2 and all(np.isfinite(res["losses"]))
    main(argv(tmp_path / "b", 1))
    res2 = main(argv(tmp_path / "b", 2, "training_config.resume=true"))
    assert res2["losses"] == res["losses"][1:]
    assert len(torch.load(tmp_path / "a" / "last.pth", weights_only=True)["stages"]) == 3
    assert _tree_equal(torch.load(tmp_path / "a" / "final.pth", weights_only=True),
                       torch.load(tmp_path / "b" / "final.pth", weights_only=True))
    val = main(argv(tmp_path / "a", 2, "mode=val", f"weights={tmp_path / 'a' / 'final'}"))
    assert 0.0 <= val["mIoU"] <= 1.0
    with pytest.raises(ConfigurationError, match="2-stage"):
        main([a.replace("pipeline=3", "pipeline=4") for a in argv(tmp_path / "c", 1)])


# ---------------------------------------------------------------------------
# runtime.pipeline_dp: every rank runs the pipeline on its share
# ---------------------------------------------------------------------------

def test_pipeline_over_two_ranks_matches_one(tmp_path):
    """The 2-stage pipeline on 2 gloo ranks (each on its rows of every
    microbatch; BatchNorm, OHEM and the loss over the global microbatch,
    each stage's gradients all-reduced before the clip) against one rank
    on the ranks' BatchNorm formula: losses within 1e-5, weights and EMA
    within test_torch_dp.py's bound for ranks (the suite's of the update,
    plus 1e-6 of the largest update: a running mean whose update is ~0 in
    exact arithmetic moves by rounding alone), the ranks bit-identical,
    the collectives under their own tags."""
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from test_torch_dp import _updates_close, run_case
    from torch_dp_worker import case_pipeline

    torch.manual_seed(0)
    sd = CABiNet(8, mode="small", cfgs=[[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2],
                                        [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]]).state_dict()
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((4, 4, H, W, 3)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 8, (4, 4, H, W)))
    ys[:, 1, :7] = 255  # ignored unevenly across the ranks
    inputs = {"state_dict": sd, "xs": xs, "ys": ys, "opt": OPT, "ema": EMA,
              "n_min": 4 * H * W // 16}
    two = run_case(tmp_path, "pipeline", {**inputs, "global_bn": False})
    one = case_pipeline({**inputs, "global_bn": True}, 0, 1)  # in this process
    assert one["losses"][0] is None and one["losses"][2] is None
    for a, b in zip(one["losses"], two[0]["losses"]):
        assert (a is None and b is None) or abs(a - b) <= LOSS_REL * abs(a), (a, b)
    assert two[0]["steps"] == one["steps"] == [2, 2]
    _updates_close(two[0]["state"], one["state"], sd)
    _updates_close(two[0]["ema"], one["ema"], sd)
    for k in ("state", "ema"):
        assert all(torch.equal(two[0][k][t], two[1][k][t]) for t in two[0][k])
    comm = two[0]["comm"]
    assert comm["pipeline_grad_all_reduce"] == 4  # 2 stages x 2 windows
    assert comm["pipeline_loss"] == 2 and comm["batch_norm"] > 0
    assert "grad_all_reduce" not in comm and one["comm"] == {}
