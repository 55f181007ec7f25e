"""The port's YOLO-sem trainer and validator (cabinet_tpu_torch/cli/
train_yolo.py, train/trainer.py with loss_type="ce") against the JAX
package's (cabinet_tpu/cli/train_yolo.py, train/trainer.py) on the CPU: one
accumulated update of yolo26n-sem, `YoloEval`'s confusion matrix at native
sizes that imgsz does not divide, the nearest mapping back to them, the
class counts, and the CLI end to end on a tiny UAVid tree as
tests/integration/test_yolo_cli_end_to_end.py drives JAX's."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.cli.train_yolo import YoloEval as JaxYoloEval
from cabinet_tpu.models.yolosem import YOLOSem as JaxYOLOSem
from cabinet_tpu.train import optimizer as jopt
from cabinet_tpu.train.trainer import (
    create_train_state as j_state,
    make_flush_step as j_flush,
    make_train_step as j_step,
)
from cabinet_tpu_torch.cli import train_yolo as ty
from cabinet_tpu_torch.train import optimizer as topt
from cabinet_tpu_torch.train import trainer as T
from cabinet_tpu_torch.utils.convert import yolosem_state_dict_from_jax
from tests.integration.test_cli_end_to_end import _make_tree
from torch_port_utils import assert_updates_close, yolo_port_model, yolo_variables

REPO = Path(__file__).resolve().parent.parent
NC = 8
CW = (np.random.default_rng(5).random(NC) + 0.5).astype(np.float32)
# each micro-step's loss, of |ref|: XLA's f32 sum over the 8192 pixels of
# the CE mean is itself 1.0e-5 off the f64 value on the same logits (the
# port's 1e-7), so this bound is twice that, not the CABiNet step's 1e-5
LOSS_REL = 2e-5
UPDATE_REL = 2e-4   # params, BN statistics and EMA, of max|ref - start| a tensor


def test_accumulated_update_matches_jax():
    """yolo26n-sem at 64^2, batch 2, f32: three micro-batches at accum 2
    (an update after two, then a trailing flush), CE on both heads with
    aux_weight 0.4 and class weights, build_sgd on the cosine schedule with
    warmup and a clip of 1.0, EMA; against JAX's make_train_step(
    loss_type="ce") + make_flush_step + build_sgd. At 32^2 the /32 map is
    1x1 and train-mode BN over its 2 values amplifies the packages'
    rounding apart (4.3e-5 of the loss), so the step is held at 64^2."""
    v = yolo_variables(NC, "n", size=64, seed=2)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((3, 2, 64, 64, 3)).astype(np.float32)
    ys = rng.integers(0, NC, (3, 2, 64, 64))
    ys[:, :, :2] = 255
    sched = (0.05, 0.01, 4, 1)
    kw = dict(momentum=0.937, wd=5e-4, max_grad_norm=1.0)
    ema = dict(ema_decay=0.9, ema_tau=2.0)

    tx = jopt.build_sgd(v["params"], jopt.warmup_cosine_schedule(*sched), **kw)
    js = j_state(jax.tree_util.tree_map(jnp.asarray, v), tx, **ema)
    jstep = j_step(JaxYOLOSem(n_classes=NC, variant="n").apply, tx, n_min=1,
                   loss_type="ce", aux_weight=0.4, class_weights=CW, accum_steps=2)
    model = yolo_port_model(v, NC, "n")
    start = {k: t.clone() for k, t in model.state_dict().items()}
    ts = T.create_train_state(model, topt.build_sgd(
        model, topt.warmup_cosine_schedule(*sched), **kw), **ema)
    tstep = T.make_train_step(n_min=1, loss_type="ce", aux_weight=0.4, class_weights=CW,
                              accum_steps=2)
    for x, y in zip(xs, ys):
        js, jloss = jstep(js, jnp.asarray(x), jnp.asarray(y))
        ts, tloss = tstep(ts, torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(tloss) - float(jloss)) <= LOSS_REL * abs(float(jloss))
    js = j_flush(tx)(js)
    ts = T.make_flush_step()(ts)
    assert (ts.step, ts.micro_step) == (int(js.step), int(js.micro_step)) == (2, 0)

    def port(tree):
        return yolosem_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, tree), "n")

    ref = port(js.variables)
    got = {k: t for k, t in model.state_dict().items() if not k.endswith("tracked")}
    assert_updates_close(got, {k: ref[k] for k in got}, start, UPDATE_REL)
    ref_ema = port(js.ema_variables)
    got_ema = {k: t for k, t in ts.ema_variables.items() if not k.endswith("tracked")}
    assert_updates_close(got_ema, {k: ref_ema[k] for k in got_ema}, start, UPDATE_REL)


def test_ohem_defaults_unchanged_and_bad_loss_type():
    """The CABiNet defaults (OHEM, aux weight 1) are the loss they were;
    an unknown loss_type raises."""
    from cabinet_tpu_torch.train.losses import ohem_cross_entropy

    g = torch.Generator().manual_seed(0)
    final, aux = torch.randn(2, 4, 8, 8, generator=g), torch.randn(2, 4, 8, 8, generator=g)
    labels = torch.randint(0, 4, (2, 8, 8), generator=g)

    class Fixed(torch.nn.Module):
        def forward(self, x):
            return final, aux

    loss = T.make_eval_loss_step(Fixed(), n_min=16)(torch.zeros(2, 8, 8, 3), labels)
    want = (ohem_cross_entropy(final, labels, 16, 0.7, 255, None, method="bisect")
            + ohem_cross_entropy(aux, labels, 16, 0.7, 255, None, method="bisect"))
    assert torch.equal(loss, want)
    with pytest.raises(ValueError, match="loss_type"):
        T.make_train_step(n_min=1, loss_type="focal")


@pytest.mark.parametrize("n_in,n_out", [(1024, 2160), (1024, 3840), (1024, 4096),
                                        (896, 2160), (896, 3000), (32, 45), (32, 70)])
def test_nearest_indices_match_jax_resize(n_in, n_out):
    """The source pixel of every output of the nearest resize back to the
    native size equals jax.image.resize(..., "nearest")'s (half-pixel
    centres) at ratios that are not whole numbers."""
    src = jnp.arange(n_in, dtype=jnp.int32)[None, :]
    want = np.asarray(jax.jit(lambda p: jax.image.resize(p, (1, n_out), "nearest"))(src))[0]
    np.testing.assert_array_equal(ty.nearest_indices(n_in, n_out).numpy(), want)


@pytest.fixture(scope="module")
def eval_batches():
    """yolo26n-sem variables with noise, and (image, label) batches at
    native sizes 45x70 and 37x53 (imgsz 32 divides neither), labels with
    ignore pixels."""
    v = yolo_variables(NC, "n", size=32, seed=3)
    rng = np.random.default_rng(1)
    batches = []
    for b, (h, w) in ((2, (45, 70)), (1, (37, 53)), (2, (32, 32))):
        labels = rng.integers(0, NC, (b, h, w))
        labels[:, :3] = 255
        batches.append((rng.standard_normal((b, h, w, 3)).astype(np.float32), labels))
    return v, batches


def test_yolo_eval_confusion_matrix_equals_jax(eval_batches):
    """YoloEval's summed confusion matrix in f32 equal to JAX's YoloEval on
    the same weights and batches, and its metrics."""
    v, batches = eval_batches
    ref = JaxYoloEval(JaxYOLOSem(n_classes=NC, variant="n").apply, NC, 32, 255,
                      jnp.float32).evaluate(v, batches)
    ours = ty.YoloEval(yolo_port_model(v, NC, "n"), NC, 32, 255, torch.float32,
                       torch.device("cpu"))
    got = ours.evaluate(None, batches)
    np.testing.assert_array_equal(got["confusion_matrix"], ref["confusion_matrix"])
    assert got["mIoU"] == ref["mIoU"] and got["accuracy"] == ref["accuracy"]
    # `variables` are loaded into the held copy first
    got2 = ours.evaluate(yolosem_state_dict_from_jax(v, "n"), batches)
    np.testing.assert_array_equal(got2["confusion_matrix"], ref["confusion_matrix"])


def test_bf16_input_resize_within_a_bf16_step_of_jax():
    """In bf16 YoloEval resizes the cast images as JAX does (cast first,
    then the bilinear resize), but torch weights the taps in f32 and rounds
    once, where JAX's einsum rounds its interpolation matrix to bf16 first:
    a known difference, held here to 2^-6 of max |ref| (4 bf16 ulps at the
    top of the range) at 90x160 -> 64x64."""
    from cabinet_tpu.models.cab import resize_bilinear as jax_resize
    from cabinet_tpu_torch.models.cab import resize_bilinear

    x = np.random.default_rng(2).standard_normal((1, 90, 160, 3)).astype(np.float32)
    ref = np.asarray(jax_resize(jnp.asarray(x, jnp.bfloat16), (64, 64)), np.float32)
    got = resize_bilinear(torch.from_numpy(x).to(torch.bfloat16).permute(0, 3, 1, 2),
                          (64, 64)).permute(0, 2, 3, 1).float().numpy()
    err = np.abs(got - ref).max()
    assert err <= 2.0 ** -6 * np.abs(ref).max()


# --- the CLI ---------------------------------------------------------------

BASE = [
    "dataset=uavid",
    "training_config.batch_size=2",
    "training_config.num_workers=0",
    "training_config.imgsz=32",
    "training_config.patience=0",
    "validation_config.batch_size=1",
    "validation_config.num_workers=0",
    "runtime.compute_dtype=float32",
]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _make_tree(tmp_path_factory.mktemp("yolo") / "data", n=4, size=(48, 48))


def _argv(tree, exp, *extra):
    return [*BASE, f"dataset.dataset_path={tree}", f"training_config.experiments_path={exp}",
            *extra, "--device", "cpu"]


def test_cli_train_close_mosaic_and_val(tree, tmp_path, capsys):
    """2 epochs with accum 2 (nbs 4), cls_pw 0.5 and close_mosaic 1: the
    JSON line, finite losses, two optimizer steps, the `last` (full),
    `final` (EMA) checkpoints; mode=val on `final` prints the metrics and
    the metrics.json snippet."""
    exp = tmp_path / "exp"
    res = ty.main(_argv(tree, exp, "training_config.epochs=2", "training_config.nbs=4",
                        "training_config.cls_pw=0.5", "augmentation.close_mosaic=1"))
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"best_miou": res["best_miou"], "losses": res["losses"]}
    assert np.isfinite(res["best_miou"]) and len(res["losses"]) == 2
    assert all(np.isfinite(res["losses"]))
    assert res["timing"]["optimizer_steps"] == 2 and res["timing"]["micro_steps"] == 4
    assert (exp / "last.pth").exists() and (exp / "last.meta.json").exists()
    assert (exp / "final.pth").exists()
    val = ty.main(_argv(tree, exp, "mode=val", f"weights={exp / 'final'}"))
    out = capsys.readouterr().out
    assert 0.0 <= val["mIoU"] <= 1.0 and 0.0 <= val["accuracy"] <= 1.0
    assert len(val["iou_per_class"]) == NC
    snippet = json.loads(out.split("metrics.json snippet:\n", 1)[1])
    assert snippet["model"] == "yolo26n-sem" and snippet["split"] == "val"
    assert snippet["mIoU"] == round(val["mIoU"] * 100, 2)


@pytest.fixture
def one_thread():
    """torch on one CPU thread: a multi-threaded CPU convolution's backward
    may sum its partial gradients in another order from one run to the
    next (seen 1 ulp apart on a process's first training run), which a
    bit-for-bit comparison of two runs would catch."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_resume_continues_bit_exactly(tree, tmp_path, monkeypatch, one_thread):
    """A 2-epoch run (mosaic closed for the second) whose checkpoints after
    epoch 0 are copied aside; resume=true from the copy gives the run's EMA
    weights bit for bit."""
    import shutil

    from cabinet_tpu_torch.train.checkpoint import CheckpointManager

    save_full = CheckpointManager.save_full

    def save_and_copy(self, name, state, epoch, *args):
        path = save_full(self, name, state, epoch, *args)
        if epoch == 0:
            shutil.copytree(self.directory, tmp_path / "b")
        return path

    argv = ("training_config.epochs=2", "training_config.nbs=4", "training_config.cls_pw=0.5",
            "augmentation.close_mosaic=1")
    monkeypatch.setattr(CheckpointManager, "save_full", save_and_copy)
    ty.main(_argv(tree, tmp_path / "a", *argv))
    monkeypatch.undo()
    res = ty.main(_argv(tree, tmp_path / "b", *argv, "training_config.resume=true"))
    assert res["timing"]["micro_steps"] == 2 and res["timing"]["optimizer_steps"] == 1
    a = torch.load(tmp_path / "a" / "final.pth")
    b = torch.load(tmp_path / "b" / "final.pth")
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def test_cli_device_augs_and_refusals(tree, tmp_path):
    """+runtime.device_augs=true trains (the host mosaic's mixup off, the
    device chain's on); runtime.device_geometric raises ConfigurationError
    naming mosaic; +runtime.pipeline=3 trains (tests/test_torch_pipeline.py
    holds it), a stage count other than 2 or 3 raises ConfigurationError
    as in JAX; runtime.model_axis raises ConfigurationError (tensor
    parallelism shards CABiNet only, and JAX's YOLO main never reads the
    key), and runtime.mesh_data that does not tile the one rank raises
    ConfigurationError naming the key."""
    from cabinet_tpu_torch.core.exceptions import ConfigurationError

    exp = tmp_path / "exp"
    res = ty.main(_argv(tree, exp, "training_config.epochs=1", "training_config.nbs=2",
                        "training_config.cls_pw=0", "+runtime.device_augs=true"))
    assert np.isfinite(res["best_miou"]) and np.isfinite(res["losses"][0])
    assert (exp / "last.pth").exists()
    with pytest.raises(ConfigurationError, match="mosaic"):
        ty.main(_argv(tree, tmp_path / "g", "+runtime.device_geometric=true"))
    res = ty.main(_argv(tree, tmp_path / "p", "training_config.epochs=1",
                        "training_config.nbs=2", "training_config.cls_pw=0",
                        "+runtime.pipeline=3"))
    assert np.isfinite(res["losses"][0]) and (tmp_path / "p" / "last.pth").exists()
    with pytest.raises(ConfigurationError, match="2-stage"):
        ty.main(_argv(tree, tmp_path / "p4", "+runtime.pipeline=4"))
    with pytest.raises(ConfigurationError, match="runtime.model_axis > 1"):
        ty.main(_argv(tree, tmp_path / "m", "+runtime.model_axis=2"))
    with pytest.raises(ConfigurationError, match="runtime.mesh_data=2"):
        ty.main(_argv(tree, tmp_path / "d", "runtime.mesh_data=2"))


def test_class_counts_through_the_loader_equal_jax(tree):
    """The class counts read through a loader with worker threads equal
    get_class_pixel_counts over the mosaic-wrapped train set at epoch 0,
    the port's and the JAX package's on the same tree: over every sample,
    and over the evenly spaced few when the set holds more than the cap."""
    from cabinet_tpu.cli import common as jcommon
    from cabinet_tpu.core.config import compose as jcompose
    from cabinet_tpu.data.class_weights import get_class_pixel_counts as jcounts
    from cabinet_tpu.data.mosaic import MosaicSegDataset as JaxMosaic
    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.core.config import compose
    from cabinet_tpu_torch.data.class_weights import get_class_pixel_counts
    from cabinet_tpu_torch.data.mosaic import MosaicSegDataset

    overrides = [*BASE, f"dataset.dataset_path={tree}", "dataset.cropsize=[32,32]"]
    cfg = compose(common.CONFIG_DIR, "train_yolo", overrides)

    def mosaic():
        return MosaicSegDataset(common.build_datasets(cfg, ["train"])[0], seed=15)

    got = ty.class_pixel_counts(cfg, mosaic(), NC, 255, 2, 2)
    np.testing.assert_array_equal(got, get_class_pixel_counts(mosaic(), NC, 255))
    jcfg = jcompose(jcommon.CONFIG_DIR, "train_yolo", overrides)
    (jbase,) = jcommon.build_datasets(jcfg, ["train"])
    np.testing.assert_array_equal(got, jcounts(JaxMosaic(jbase, seed=15), NC, 255))
    n = len(mosaic())
    got = ty.class_pixel_counts(cfg, mosaic(), NC, 255, 2, 2, max_samples=n - 1)
    np.testing.assert_array_equal(got, get_class_pixel_counts(mosaic(), NC, 255, n - 1))
    np.testing.assert_array_equal(got, jcounts(JaxMosaic(jbase, seed=15), NC, 255, n - 1))


_GRAIN_CHILD = """
import sys
import torch
from cabinet_tpu_torch.cli.train_yolo import main

if __name__ == "__main__":
    torch.set_num_threads(1)  # as the fixture one_thread, for bit-equal runs
    argv, a, b = sys.argv[1:-2], sys.argv[-2], sys.argv[-1]
    main(argv[:-2] + [f"training_config.experiments_path={a}", "+runtime.loader=grain",
                      "training_config.num_workers=2", "--device", "cpu"])
    main(argv[:-2] + [f"training_config.experiments_path={b}", "--device", "cpu"])
    x, y = torch.load(f"{a}/final.pth"), torch.load(f"{b}/final.pth")
    print("EQUAL" if all(torch.equal(x[k], y[k]) for k in x) else "DIFFER")
"""


def test_cli_on_worker_processes_equals_threads(tree, tmp_path):
    """runtime.loader=grain (worker processes, started again when
    close_mosaic changes the dataset they hold) trains to the thread
    loader's EMA weights bit for bit; in a subprocess with a timeout, as
    every test that starts processes."""
    script = tmp_path / "child.py"
    script.write_text(_GRAIN_CHILD)
    argv = _argv(tree, tmp_path / "unused", "training_config.epochs=2", "training_config.nbs=4",
                 "training_config.cls_pw=0.5", "augmentation.close_mosaic=1")
    argv = [a for a in argv if "experiments_path" not in a]
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, str(script), *argv, str(tmp_path / "grain"),
                          str(tmp_path / "thread")], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "EQUAL"
