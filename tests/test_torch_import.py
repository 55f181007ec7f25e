"""The port stands alone: cabinet_tpu_torch imports no JAX, no Flax and
nothing of cabinet_tpu, and its entry points never drop to the CPU
unasked."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parent.parent / "cabinet_tpu_torch"

_GUARD = r"""
import importlib, pkgutil, sys
import cabinet_tpu_torch
names = [m.name for m in pkgutil.walk_packages(cabinet_tpu_torch.__path__,
                                              "cabinet_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "cabinet_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 53, names
required = {"cabinet_tpu_torch." + m for m in (
    "cli.train", "cli.common", "core.logging", "core.config", "core.yaml_subset",
    "data.transforms", "data.class_weights", "data.datasets", "train",
    "train.losses", "train.optimizer", "train.ema", "train.early_stopping",
    "train.trainer", "train.checkpoint", "ops.photometric", "ops.geometric",
    "export", "cli.export", "cli.serve", "data.grain_loader", "data.converters",
    "data.stats", "cli.convert", "cli.compute_stats", "models.yolosem", "data.mosaic",
    "cli.train_yolo", "core.legacy_config", "core.mesh", "cli.convert_checkpoint",
    "cli.visualize", "utils.profiler", "train.pipeline")}
assert required <= set(names), sorted(required - set(names))
"""


def test_import_guard_subprocess():
    """A fresh interpreter (tests/conftest.py imports jax into this one)
    imports every submodule and finds no JAX-side module loaded."""
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=PKG.parent,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_source_scan_has_no_jax_imports():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|cabinet_tpu)(\.|\s|$)",
        re.MULTILINE)
    offenders = [str(p) for p in PKG.rglob("*.py")
                 if pattern.search(p.read_text())]
    assert not offenders, offenders


def test_no_kernel_build_at_import():
    """Importing the kernel modules compiles and loads nothing."""
    from cabinet_tpu_torch.ops import _build

    import cabinet_tpu_torch.ops.attention  # noqa: F401
    import cabinet_tpu_torch.ops.decoder_tail  # noqa: F401
    import cabinet_tpu_torch.ops.early_stage  # noqa: F401

    assert _build._LOADED == {}


@pytest.mark.parametrize("entry", ["segmenter", "fused_tail", "fused_apply",
                                   "msc_eval", "eval_forward", "evaluate_main",
                                   "resolve_device", "train_main", "train_and_evaluate",
                                   "export_serving", "export_main", "serve_engine",
                                   "train_yolo_main", "train_yolo_val", "yolo_export_main",
                                   "visualize_main", "train_main_pipeline",
                                   "pipeline_devices"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    """Without device="cpu" the entry points ask for CUDA, and raise where
    there is none instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default runs there")
    from cabinet_tpu_torch.cli.evaluate import main as evaluate_main
    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.cli.common import CONFIG_DIR
    from cabinet_tpu_torch.cli.export import main as export_main
    from cabinet_tpu_torch.cli.serve import _Engine
    from cabinet_tpu_torch.export import export_serving
    from cabinet_tpu_torch.cli.infer import Segmenter
    from cabinet_tpu_torch.cli.train import main as train_main
    from cabinet_tpu_torch.cli.train import train_and_evaluate
    from cabinet_tpu_torch.core.config import compose
    from cabinet_tpu_torch.core.device import resolve_device
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.fused import make_fused_apply, make_fused_tail_apply

    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "segmenter":
            Segmenter(str(tmp_path / "unused.pth"), "uavid", imgsz=64)
        elif entry == "fused_tail":
            make_fused_tail_apply(CABiNet(8, "small", cfgs=[[3, 1, 16, 1, 0, 2]]))
        elif entry == "fused_apply":
            make_fused_apply(CABiNet(8, "large", cfgs=[[3, 1, 16, 0, 0, 1]]))
        elif entry == "msc_eval":
            MscEval(lambda v, x: (x, x), 8)
        elif entry == "eval_forward":
            make_eval_forward(CABiNet(8, "small", cfgs=[[3, 1, 16, 1, 0, 2]]), 256)
        elif entry == "evaluate_main":
            evaluate_main([f"checkpoint_path={tmp_path / 'unused.pth'}",
                           f"dataset.dataset_path={tmp_path}"])
        elif entry == "train_main":
            train_main([f"dataset.dataset_path={tmp_path}"])
        elif entry == "train_main_pipeline":
            train_main([f"dataset.dataset_path={tmp_path}", "runtime.pipeline=2"])
        elif entry == "pipeline_devices":
            from cabinet_tpu_torch.train.pipeline import make_pipeline_devices

            make_pipeline_devices(2)
        elif entry == "train_and_evaluate":
            train_and_evaluate(compose(CONFIG_DIR, "train",
                                       [f"dataset.dataset_path={tmp_path}"]))
        elif entry == "export_serving":
            export_serving(CABiNet(8, "small", cfgs=[[3, 1, 16, 1, 0, 2]]),
                           mean=(0.5,) * 3, std=(0.5,) * 3, imgsz=32)
        elif entry == "export_main":
            export_main(["--checkpoint", str(tmp_path / "unused.pth"), "--dataset",
                         "uavid", "--out", str(tmp_path / "art")])
        elif entry in ("train_yolo_main", "train_yolo_val"):
            from cabinet_tpu_torch.cli.train_yolo import main as train_yolo_main

            mode = "val" if entry == "train_yolo_val" else "train"
            train_yolo_main([f"dataset.dataset_path={tmp_path}", f"mode={mode}"])
        elif entry == "yolo_export_main":
            export_main(["--family", "yolosem", "--checkpoint", str(tmp_path / "unused.pth"),
                         "--dataset", "uavid", "--out", str(tmp_path / "art")])
        elif entry == "visualize_main":
            from cabinet_tpu_torch.cli.visualize import main as visualize_main

            visualize_main([f"checkpoint_path={tmp_path / 'unused.pth'}",
                            f"dataset.dataset_path={tmp_path}"])
        elif entry == "serve_engine":
            _Engine(None, str(tmp_path / "unused.pth"), "uavid", "large", 64,
                    "bfloat16")
        else:
            resolve_device()


_BLOCKED = ("jax", "jaxlib", "PIL", "yaml", "cv2", "rich", "tqdm")

_SERVE_WITHOUT_JAX_PIL_YAML = textwrap.dedent("""
    import json, sys, threading, urllib.request
    for m in {blocked!r}:
        sys.modules[m] = None          # import m now raises ImportError
    from pathlib import Path
    import numpy as np, torch
    from cabinet_tpu_torch.cli import export, serve
    from cabinet_tpu_torch.data.decode import decode_png, encode_png, png_mask
    from cabinet_tpu_torch.models.cabinet import CABiNet

    out = Path(sys.argv[1])
    torch.manual_seed(0)
    torch.save(CABiNet(8, "small").state_dict(), out / "ck.pth")
    export.main(["--checkpoint", str(out / "ck.pth"), "--dataset", "uavid",
                 "--out", str(out / "art"), "--imgsz", "32", "--batch", "b",
                 "--mode", "small", "--dtype", "float32", "--device", "cpu",
                 "--check"])
    rgb = np.random.default_rng(0).integers(0, 256, (40, 56, 3), dtype=np.uint8)
    for art, ck in ((str(out / "art"), None), (None, str(out / "ck.pth"))):
        engine = serve._Engine(art, ck, "uavid", "small", 32, "float32",
                               max_batch=2, device="cpu")
        srv = serve.make_server(engine, "127.0.0.1", 0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        req = urllib.request.Request(
            f"http://127.0.0.1:{{srv.server_address[1]}}/segment?format=color_png",
            data=encode_png(rgb), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            assert decode_png(r.read()).samples.shape == (40, 56, 3)
        srv.shutdown()
        srv.server_close()
        engine.batcher.close()
    bad = sorted(m for m in sys.modules if sys.modules[m] is not None
                 and m.split(".")[0] in {blocked!r})
    assert not bad, bad
    print("SERVE-WITHOUT-JAX-PIL-YAML OK")
""")


def test_export_and_serve_need_no_pil_yaml_or_jax(tmp_path):
    """The GPU machine may lack PIL, PyYAML, OpenCV, rich, tqdm and JAX: with
    each blocked, cli.export main writes and checks an artifact, and the
    server answers a PNG request on both routes (artifact and checkpoint)."""
    code = _SERVE_WITHOUT_JAX_PIL_YAML.format(blocked=_BLOCKED)
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                         cwd=PKG.parent, capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "SERVE-WITHOUT-JAX-PIL-YAML OK" in res.stdout


_DATA_TOOLS_WITHOUT_PIL = textwrap.dedent("""
    import sys
    from pathlib import Path
    import numpy as np
    from cabinet_tpu_torch.cli import compute_stats, convert
    from cabinet_tpu_torch.data.decode import open_mask, save_png
    from cabinet_tpu_torch.data.palettes import UAVID_CLASSES

    root = Path(sys.argv[1])
    colors = np.array([c["color"] for c in UAVID_CLASSES], np.uint8)
    rng = np.random.default_rng(0)
    for seq in ("seq1", "seq2"):
        for sub in ("Images", "Labels"):
            (root / "raw" / "train" / seq / sub).mkdir(parents=True)
        for i in range(2):
            ids = rng.integers(0, 8, (12, 20))
            save_png(root / "raw" / "train" / seq / "Images" / f"{i:06d}.png",
                     rng.integers(0, 256, (12, 20, 3), dtype=np.uint8))
            save_png(root / "raw" / "train" / seq / "Labels" / f"{i:06d}.png", colors[ids])
            np.save(root / f"{seq}_{i:06d}.npy", ids)
    convert.main(["uavid", "--src", str(root / "raw"), "--dst", str(root / "out"),
                  "--workers", "2"])
    for f in sorted((root / "out" / "masks" / "train").iterdir()):
        assert (open_mask(f) == np.load(root / (f.stem + ".npy"))).all(), f
    compute_stats.main([str(root / "out" / "images" / "train")])
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not bad, bad
    print("DATA-TOOLS-WITHOUT-PIL OK")
""")


def test_convert_and_compute_stats_need_no_pil_or_jax(tmp_path):
    """With JAX, PIL, PyYAML and OpenCV unimportable (shadowed on the path,
    so the converter's spawned pool workers cannot import them either),
    cli.convert uavid writes the masks and cli.compute_stats reads PNGs."""
    blocked = ("jax", "jaxlib", "PIL", "yaml", "cv2")
    shadow = tmp_path / "shadow"
    for m in blocked:
        (shadow / m).mkdir(parents=True)
        (shadow / m / "__init__.py").write_text(f"raise ImportError('{m} is blocked')\n")
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(shadow), str(PKG.parent)])}
    code = _DATA_TOOLS_WITHOUT_PIL.replace("BLOCKED", repr(blocked))
    res = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=PKG.parent,
                         env=env, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "[DONE] Total masks written: 4" in res.stdout
    assert "mean: (" in res.stdout and "DATA-TOOLS-WITHOUT-PIL OK" in res.stdout
