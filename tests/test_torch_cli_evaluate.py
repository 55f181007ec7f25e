"""The port's `cli/evaluate.py` main against the JAX package's
`evaluate_checkpoint` on a tiny UAVid tree (a Small CABiNet with a cut
cfg table, random weights from `model.init` written as a .pth through
`flax_to_torch`, float32), the staged `MscEval.evaluate`, and a run in a
subprocess with the packages the GPU machine may lack blocked."""

import json
import subprocess
import sys
import textwrap
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cabinet_tpu.cli import common as jcommon
from cabinet_tpu.cli.evaluate import evaluate_checkpoint as j_evaluate_checkpoint
from cabinet_tpu.core.config import compose as jcompose
from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.utils.torch_convert import flax_to_torch
from cabinet_tpu_torch.cli import evaluate as tev
from cabinet_tpu_torch.core.config import compose
from cabinet_tpu_torch.core.exceptions import ConfigurationError
from cabinet_tpu_torch.eval.evaluator import MscEval
from torch_port_utils import perturb

REPO = Path(__file__).resolve().parent.parent
# a prefix of the published Small table: the JAX .pth loader maps keys by
# the published table
CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [3, 3.67, 24, 0, 0, 1],
        [5, 4, 40, 1, 1, 2]]
SIZES = [(40, 56), (36, 52), (40, 56)]  # mixed resolutions, as UAVid has
TIE_EPS = 1e-5


@pytest.fixture(scope="module")
def tiny_eval(tmp_path_factory):
    """(overrides shared by both packages, data root, checkpoint path)."""
    base = tmp_path_factory.mktemp("tiny_eval")
    root = base / "uavid"
    rng = np.random.default_rng(0)
    for split in ("val",):
        (root / "images" / split).mkdir(parents=True)
        (root / "masks" / split).mkdir(parents=True)
        for i, (h, w) in enumerate(SIZES):
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                root / "images" / split / f"s{i}.png")
            mask = rng.integers(0, 8, (h, w)).astype(np.uint8)
            mask[:3] = 255
            Image.fromarray(mask, "L").save(root / "masks" / split / f"s{i}.png")
    model = JaxCABiNet(n_classes=8, mode="small", cfgs=CFGS)
    variables = jax.jit(lambda: model.init(jax.random.PRNGKey(0),
                                           jnp.zeros((1, 32, 32, 3)), train=False))()
    sd = flax_to_torch(perturb(variables, seed=3), CFGS)
    ckpt = base / "tiny.pth"
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, ckpt)
    overrides = [
        "model=mobilenetv3_small",
        "model.cfgs=" + json.dumps(CFGS).replace(" ", ""),
        "dataset=uavid", f"dataset.dataset_path={root}", "dataset.cropsize=[32,32]",
        f"checkpoint_path={ckpt}", "validation_config.batch_size=1",
        "validation_config.num_workers=2", "runtime.compute_dtype=float32",
        # the port evaluates on one device; JAX would shard the tiles over
        # the suite's 8 virtual CPU devices without this
        "+runtime.tile_parallel_eval=false",
    ]
    return overrides, root, ckpt


def _near_ties(overrides):
    """Pixels whose top-2 summed probabilities differ by < TIE_EPS (port)."""
    cfg = compose(jcommon.CONFIG_DIR, "evaluate", overrides)
    from cabinet_tpu_torch.cli import common

    (ds,) = common.build_datasets(cfg, ["val"])
    model = common.build_model(cfg, 8)
    model.load_state_dict(common.load_model_variables(cfg.checkpoint_path, model))
    fwd = tev.make_eval_forward(model, 32, "cpu")
    vc = cfg.validation_config
    ev = MscEval(fwd, 8, scales=tuple(vc.eval_scales), flip=bool(vc.flip),
                 cropsize=32, device="cpu")
    ties = 0
    for i in range(len(ds)):
        probs = ev.prob_batch(None, ds[i][0][None])
        top2 = np.sort(probs, axis=-1)[..., -2:]
        ties += int(((top2[..., 1] - top2[..., 0]) < TIE_EPS).sum())
    return ties


@pytest.mark.parametrize("protocol", [
    ["validation_config.eval_scales=[1.0]", "validation_config.flip=false"],
    ["validation_config.eval_scales=[0.75,1.25]", "validation_config.flip=true"],
], ids=["scale1", "two_scales_flip"])
def test_evaluate_checkpoint_matches_jax(tiny_eval, protocol):
    overrides, _, _ = tiny_eval
    ref = j_evaluate_checkpoint(jcompose(jcommon.CONFIG_DIR, "evaluate",
                                         overrides + protocol))
    got = tev.evaluate_checkpoint(compose(jcommon.CONFIG_DIR, "evaluate",
                                          overrides + protocol), device="cpu")
    hist, ref_hist = got["confusion_matrix"], ref["confusion_matrix"]
    assert hist.sum() == ref_hist.sum() == sum(h * w - 3 * w for h, w in SIZES)
    disagree = np.abs(hist - ref_hist).sum() / 2
    assert disagree <= _near_ties(overrides + protocol)
    # the metrics follow from the matrices
    from cabinet_tpu.eval.metrics import metrics_from_hist

    same = metrics_from_hist(hist)
    assert got["mIoU"] == same["mIoU"] and got["accuracy"] == same["accuracy"]
    assert got["iou_per_class"] == same["iou_per_class"]
    if disagree == 0:
        assert got["mIoU"] == ref["mIoU"] and got["accuracy"] == ref["accuracy"]
        assert got["iou_per_class"] == ref["iou_per_class"]
    assert got["timing"]["frames"] == len(SIZES)


@pytest.mark.parametrize("quantize", ["int8", "int8dw"])
def test_evaluate_checkpoint_quantized_matches_jax(tiny_eval, quantize, capsys):
    """`+runtime.quantize=int8|int8dw`: both packages calibrate on the first
    2 val batches (cropped to 32x32) and score with the quantized model,
    and the port prints its count of quantized convs, that of JAX's sites.
    Each package calibrates on its own forward, so a scale may differ from
    JAX's by float noise (tests/test_torch_quant.py bounds it at 2e-4
    relative); a site input within that noise of a rounding tie then takes
    the other int8 value, and on this random-weight model, whose class
    probabilities are nearly flat, a few argmaxes move (8 of 5860 pixels
    under int8dw). Bound: the quality gate's, at most 0.5% of the pixels
    moved and |delta mIoU| < 0.01."""
    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.quant import quantization_sites

    overrides, _, _ = tiny_eval
    argv = overrides + ["validation_config.eval_scales=[1.0]",
                        "validation_config.flip=false", f"+runtime.quantize={quantize}"]
    ref = j_evaluate_checkpoint(jcompose(jcommon.CONFIG_DIR, "evaluate", argv))
    cfg = compose(jcommon.CONFIG_DIR, "evaluate", argv)
    capsys.readouterr()
    got = tev.evaluate_checkpoint(cfg, device="cpu")
    n_sites = len(quantization_sites(common.build_model(cfg, 8),
                                     quantize_depthwise=quantize == "int8dw"))
    assert (f"int8 PTQ: {n_sites} convs quantized, calibrated on 2 batches"
            in capsys.readouterr().out)
    hist, ref_hist = got["confusion_matrix"], ref["confusion_matrix"]
    assert hist.sum() == ref_hist.sum() == sum(h * w - 3 * w for h, w in SIZES)
    assert np.abs(hist - ref_hist).sum() / 2 <= 5e-3 * hist.sum()
    assert abs(got["mIoU"] - ref["mIoU"]) < 0.01


def test_main_prints_the_jax_json_line(tiny_eval, capsys):
    overrides, _, _ = tiny_eval
    protocol = ["validation_config.eval_scales=[1.0]", "validation_config.flip=false"]
    res = tev.main(overrides + protocol + ["--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(last) == {"mIoU", "accuracy", "iou_per_class"}
    assert last["mIoU"] == res["mIoU"] and last["iou_per_class"] == res["iou_per_class"]
    assert set(last["iou_per_class"]) == {f"class_{i}" for i in range(8)}


def test_split_train_and_unported_options_raise(tiny_eval):
    overrides, _, _ = tiny_eval
    with pytest.raises(ConfigurationError, match="train"):
        tev.evaluate_checkpoint(compose(jcommon.CONFIG_DIR, "evaluate",
                                        overrides + ["split=train"]), device="cpu")
    # fused_tail=true where it cannot run (float32), as the JAX CLI refuses
    with pytest.raises(ConfigurationError, match="fused decoder tail"):
        tev.evaluate_checkpoint(compose(jcommon.CONFIG_DIR, "evaluate",
                                        overrides + ["runtime.fused_tail=true"]), device="cpu")
    # UAVid mixes resolutions: batch 2 is refused, as in JAX
    with pytest.raises(ConfigurationError, match="batch_size must be 1"):
        tev.evaluate_checkpoint(compose(jcommon.CONFIG_DIR, "evaluate",
                                        overrides + ["validation_config.batch_size=2"]),
                                device="cpu")


class _Batches:
    """A loader of fixed (images, labels) batches; raises at `fail_at`."""

    def __init__(self, batches, fail_at=None):
        self.batches, self.fail_at = batches, fail_at

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for i, b in enumerate(self.batches):
            if i == self.fail_at:
                raise OSError("disk went away")
            yield b


def _tiny_msc():
    from cabinet_tpu_torch.models.cabinet import CABiNet

    torch.manual_seed(0)
    model = CABiNet(6, "small", cfgs=CFGS[:2]).eval()
    fwd = tev.make_eval_forward(model, 32, "cpu")
    return MscEval(fwd, 6, scales=(0.75, 1.0), flip=True, cropsize=32, device="cpu",
                   pad_to=(40, 48))


def _batches(n=5):
    rng = np.random.default_rng(4)
    out = []
    for i in range(n):
        h, w = (40, 48) if i % 2 else (36, 44)
        labels = rng.integers(0, 6, (2, h, w))
        labels[:, 0] = 255
        out.append((rng.normal(size=(2, h, w, 3)).astype(np.float32), labels))
    return out


def test_staged_evaluate_equals_the_serial_sum():
    ev = _tiny_msc()
    batches = _batches()
    serial = sum(ev.hist_batch(None, x, y) for x, y in batches)
    res = ev.evaluate(None, _Batches(batches), progress=True)
    np.testing.assert_array_equal(res["confusion_matrix"], serial.astype(np.float64))
    assert res["timing"]["frames"] == 10
    assert 0 <= res["timing"]["loader_wait_seconds"] <= res["timing"]["seconds"]


def _stage_threads():
    return [t for t in threading.enumerate() if t.name == "MscEval-stage"]


def test_a_loader_error_reaches_the_caller_and_no_worker_is_left():
    ev = _tiny_msc()
    before = threading.active_count()
    with pytest.raises(OSError, match="disk went away"):
        ev.evaluate(None, _Batches(_batches(), fail_at=3))
    assert not _stage_threads() and threading.active_count() == before

    class Unlisted:  # fails before its first batch, in iter() itself
        def __iter__(self):
            raise OSError("no listing")

    with pytest.raises(OSError, match="no listing"):
        ev.evaluate(None, Unlisted())
    assert not _stage_threads() and threading.active_count() == before


def test_a_consumer_error_stops_the_worker():
    """The forward fails on the first batch while the worker has more to
    stage: the stop event lets it go instead of blocking on the queue."""
    ev = _tiny_msc()
    calls = []

    def broken(variables, images):
        calls.append(1)
        raise RuntimeError("forward failed")

    ev.apply_fn = broken
    before = threading.active_count()
    with pytest.raises(RuntimeError, match="forward failed"):
        ev.evaluate(None, _Batches(_batches(8)))
    assert calls == [1]
    assert not _stage_threads() and threading.active_count() == before


_BLOCKED = ("jax", "jaxlib", "PIL", "yaml", "cv2", "rich", "tqdm")

_GPU_MACHINE_RUN = textwrap.dedent("""
    import json, sys
    for m in {blocked!r}:
        sys.modules[m] = None          # import m now raises ImportError
    from pathlib import Path
    import numpy as np, torch
    from cabinet_tpu_torch.cli import evaluate
    from cabinet_tpu_torch.cli.infer import Segmenter, infer_image
    from cabinet_tpu_torch.data.decode import open_rgb, save_png
    from cabinet_tpu_torch.data.palettes import PALETTES
    from cabinet_tpu_torch.models.cabinet import CABiNet

    root, out = Path(sys.argv[1]), Path(sys.argv[2])
    rng = np.random.default_rng(0)
    for split in ("val",):
        (root / "images" / split).mkdir(parents=True)
        (root / "masks" / split).mkdir(parents=True)
        for i in range(2):
            save_png(root / "images" / split / f"s{{i}}.png",
                     rng.integers(0, 256, (40, 56, 3), dtype=np.uint8))
            save_png(root / "masks" / split / f"s{{i}}.png",
                     rng.integers(0, 8, (40, 56), dtype=np.uint8))
    torch.manual_seed(0)
    torch.save(CABiNet(8, "small").state_dict(), out / "ck.pth")
    res = evaluate.main(["model=mobilenetv3_small", "dataset=uavid", f"dataset.dataset_path={{root}}",
                         "dataset.cropsize=[32,32]", f"checkpoint_path={{out / 'ck.pth'}}",
                         "validation_config.batch_size=1",
                         "validation_config.eval_scales=[1.0]",
                         "validation_config.flip=false", "--device", "cpu"])
    assert 0.0 <= res["mIoU"] <= 1.0
    seg = Segmenter(str(out / "ck.pth"), "uavid", mode="small", imgsz=32,
                    dtype_name="float32", device="cpu")
    infer_image(seg, PALETTES["uavid"], root / "images" / "val" / "s0.png", out, 0.5)
    assert open_rgb(out / "s0_mask.png").shape == (40, 56, 3)
    assert open_rgb(out / "s0_overlay.png").shape == (40, 56, 3)
    bad = sorted(m for m in sys.modules if sys.modules[m] is not None
                 and m.split(".")[0] in {blocked!r})
    assert not bad, bad
    print("GPU-MACHINE-RUN OK")
""")


def test_evaluate_main_and_infer_image_need_no_pil_yaml_or_jax(tmp_path):
    """The GPU machine may lack PIL, PyYAML, OpenCV, rich, tqdm and JAX: with
    each blocked, evaluate's main runs over a PNG tree and infer_image reads
    and writes PNGs (CABiNet-Small with the published table, 40x56 frames)."""
    code = _GPU_MACHINE_RUN.format(blocked=_BLOCKED)
    (tmp_path / "out").mkdir()
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path / "data"),
                          str(tmp_path / "out")], cwd=REPO, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "GPU-MACHINE-RUN OK" in res.stdout
    lines = res.stdout.strip().splitlines()
    assert set(json.loads(lines[-2])) == {"mIoU", "accuracy", "iou_per_class"}
