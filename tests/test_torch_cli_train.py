"""The port's training CLI (cabinet_tpu_torch.cli.train) on the CPU, as a
user runs it: `main` over a tiny UAVid-layout tree and a tiny
Cityscapes-layout tree for 2 epochs, then a resume for a third; the same
with the device augmentation (`runtime.device_geometric=true` on UAVid,
the aerial chain with mixup; `=shared` on Cityscapes, the street chain),
whose resume must equal the uninterrupted run; `runtime.loader=grain`
(worker processes) against the thread loader, with evaluate main on the
weights it wrote; and one run in a process where JAX, Flax, optax, orbax,
PyYAML, rich and tqdm cannot be imported."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cabinet_tpu_torch.cli.common import CONFIG_DIR
from cabinet_tpu_torch.core.config import compose
from cabinet_tpu_torch.core.exceptions import ConfigurationError

REPO = Path(__file__).resolve().parent.parent
TINY_MODEL = ["model=mobilenetv3_small",
              "model.cfgs=[[3,1,16,1,0,2],[3,4.5,24,0,0,2],[5,4,40,1,1,2],[5,6,96,1,1,2]]"]
CITY_IDS = np.array([0, 7, 8, 11, 12, 13, 21, 26], np.uint8)


def make_uavid_tree(root, n=4, size=(40, 48), seed=0):
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "masks" / split).mkdir(parents=True)
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
                root / "images" / split / f"s{i}.png")
            Image.fromarray(rng.integers(0, 8, size, dtype=np.uint8), "L").save(
                root / "masks" / split / f"s{i}.png")
    return root


def make_city_tree(root, n=2, size=(32, 64), seed=1):
    rng = np.random.default_rng(seed)
    for split in ("train", "val"):
        for city in ("aachen", "bremen"):
            (root / "leftImg8bit" / split / city).mkdir(parents=True)
            (root / "gtFine" / split / city).mkdir(parents=True)
            for i in range(n):
                base = f"{city}_{i:06d}_000019"
                Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
                    root / "leftImg8bit" / split / city / f"{base}_leftImg8bit.png")
                Image.fromarray(rng.choice(CITY_IDS, size), "L").save(
                    root / "gtFine" / split / city / f"{base}_gtFine_labelIds.png")
    return root


def overrides(name, data, exp, crop=32, epochs=2):
    return TINY_MODEL + [
        f"dataset={name}", f"dataset.dataset_path={data}", f"dataset.cropsize=[{crop},{crop}]",
        "training_config.batch_size=2", "training_config.num_workers=0",
        f"training_config.epochs={epochs}", "training_config.warmup_steps=1",
        "training_config.cls_pw=0.5", "training_config.patience=0", "training_config.log_iter=1",
        f"training_config.experiments_path={exp}", "training_config.model_save_name=tiny",
        "validation_config.batch_size=1", "validation_config.num_workers=0",
        "validation_config.eval_scales=[1.0]", "validation_config.flip=false",
        "runtime.compute_dtype=float32"]


def _epochs(exp):
    lines = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()]
    return lines


@pytest.mark.parametrize("name", ["uavid", "cityscapes"])
def test_train_main_two_epochs_then_resume(tmp_path, name):
    from cabinet_tpu_torch.cli.train import main

    data = (make_uavid_tree if name == "uavid" else make_city_tree)(tmp_path / "data")
    exp = tmp_path / "exp"
    args = overrides(name, data, exp)
    res = main(args + ["--device", "cpu"])
    lines = _epochs(exp)
    assert len(lines) == 3 and lines[0] == {"run_start": lines[0]["run_start"], "start_epoch": 0}
    steps_per_epoch = 2  # 4 train frames, batch 2, accum 1
    for e, ln in enumerate(lines[1:]):
        assert ln["run"] == lines[0]["run_start"] and ln["epoch"] == e
        assert ln["step"] == steps_per_epoch * (e + 1)
        assert np.isfinite(ln["train_loss"]) and np.isfinite(ln["val_loss"])
        assert 0.0 <= ln["mIoU"] <= 1.0
    for f in ("checkpoint_last.pth", "checkpoint_last.meta.json", "tiny_best.pth",
              "tiny.pth", "config.yaml"):
        assert (exp / f).is_file(), f
    assert np.isfinite(res["final"]["mIoU"]) and res["timing"]["optimizer_steps"] == 4
    # config.yaml composes back to the tree that trained
    saved = compose(exp, "config", [])
    assert saved.to_dict() == compose(CONFIG_DIR, "train", args).to_dict(resolve=True)

    res2 = main(args + ["training_config.resume=true", "training_config.epochs=3",
                        "--device", "cpu"])
    lines = _epochs(exp)
    assert len(lines) == 5 and lines[3] == {"run_start": lines[3]["run_start"],
                                            "start_epoch": 2}
    assert lines[4]["epoch"] == 2 and lines[4]["step"] == 6
    assert res2["timing"]["optimizer_steps"] == 2


def test_train_main_refuses_what_is_not_ported(tmp_path):
    """Spatial partitioning raises, naming its ROADMAP item (Queue 1 item
    7c); tensor parallelism's axes and runtime.mesh_data that do not tile
    the one rank raise a ConfigurationError naming the key
    (tests/test_torch_tensor_parallel.py, test_torch_pipeline_tp.py and
    test_torch_tp_mains.py hold them on ranks); runtime.pipeline=2 trains
    (tests/test_torch_pipeline.py holds it), and its JAX refusals are
    ConfigurationError."""
    from cabinet_tpu_torch.cli.train import main

    data = make_uavid_tree(tmp_path / "data", n=2)
    base = overrides("uavid", data, tmp_path / "exp")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7c, spatial"):
        main(base + ["runtime.spatial_axis=true", "--device", "cpu"])
    for extra, key in ((["runtime.model_axis=2"], "runtime.model_axis=2"),
                       (["runtime.mesh_data=2"], "runtime.mesh_data=2"),
                       (["runtime.model_axis=1", "runtime.mesh_data=4"], "runtime.mesh_data=4"),
                       (["runtime.pipeline=2", "+runtime.pipeline_tp=2"], "runtime.pipeline_tp=2"),
                       (["runtime.pipeline=2", "+runtime.eval_model_axis=2"],
                        "runtime.eval_model_axis=2")):
        with pytest.raises(ConfigurationError, match=key):
            main(base + extra + ["--device", "cpu"])
    res = main(base + ["runtime.pipeline=2", "training_config.epochs=1", "--device", "cpu"])
    assert res["timing"]["optimizer_steps"] == 1 and (tmp_path / "exp" / "tiny.pth").is_file()
    for extra, match in ((["runtime.pipeline=3"], "pins at 2 stages"),
                         (["runtime.pipeline=2", "runtime.model_axis=2"], "cannot combine")):
        with pytest.raises(ConfigurationError, match=match):
            main(base + extra + ["--device", "cpu"])
    # --legacy-config runs (core/legacy_config.py); a missing file is refused
    with pytest.raises(ConfigurationError, match="legacy config not found"):
        main(["--legacy-config", "old.json", "--device", "cpu"])
    # the JAX package's refusals of the device pipeline's knobs
    with pytest.raises(ConfigurationError, match="spatial_axis"):
        main(base + ["runtime.device_geometric=true", "runtime.spatial_axis=true",
                     "--device", "cpu"])
    with pytest.raises(ConfigurationError, match="remat"):
        main(base + ["runtime.remat=some", "--device", "cpu"])


DEVICE_AUG = {"uavid": ["runtime.device_geometric=true", "dataset.augmentation.mixup=0.5"],
              "cityscapes": ["runtime.device_geometric=shared", "runtime.remat=true"]}


def _same(a, b, where="") -> None:
    """Two checkpoint blobs hold equal values, tensors bit for bit."""
    if isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}/{i}")
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("name", ["uavid", "cityscapes"])
def test_train_main_device_augs_resume_equals_uninterrupted(tmp_path, name):
    """main with the device pipeline for 2 epochs, then a resume to epoch 3,
    ends where 3 epochs in one run end: the same draws, bit for bit (both
    with max_iterations=6, so that they share the poly schedule)."""
    from cabinet_tpu_torch.cli.train import main

    data = (make_uavid_tree if name == "uavid" else make_city_tree)(tmp_path / "data")
    runs = {}
    for run in ("whole", "resumed"):
        exp = tmp_path / run
        args = overrides(name, data, exp) + DEVICE_AUG[name] + [
            "training_config.max_iterations=6"]
        if run == "whole":
            res = main(args + ["training_config.epochs=3", "--device", "cpu"])
        else:
            main(args + ["--device", "cpu"])
            res = main(args + ["training_config.resume=true", "training_config.epochs=3",
                               "--device", "cpu"])
        assert res["timing"]["device_aug_seconds"] > 0
        lines = [ln for ln in _epochs(exp) if "epoch" in ln]
        assert [ln["step"] for ln in lines] == [2, 4, 6]
        assert all(np.isfinite(ln["train_loss"]) for ln in lines)
        runs[run] = (lines[-1]["train_loss"],
                     torch.load(exp / "checkpoint_last.pth", map_location="cpu",
                                weights_only=False))
    assert runs["whole"][0] == runs["resumed"][0]
    _same(runs["whole"][1], runs["resumed"][1])


def test_micro_batches_of_a_window_draw_apart(tmp_path, monkeypatch):
    """At accum_steps=2 the augmentation of each micro-batch is keyed on
    (seed + 1, step, micro_step): the two micro-batches of a window draw
    different parameters from the same batch, and a key draws the same
    ones again. main keys them so."""
    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.cli import train as train_mod

    data = make_uavid_tree(tmp_path / "data")
    args = overrides("uavid", data, tmp_path / "exp") + DEVICE_AUG["uavid"] + [
        "training_config.accum_steps=2"]
    cfg = compose(CONFIG_DIR, "train", args)
    ds = common.build_datasets(cfg, ["train"])[0]
    batch = tuple(np.stack(f) for f in zip(ds[0], ds[1]))
    aug = train_mod.DeviceAugment(cfg, ds, torch.device("cpu"), (32, 32))
    a, b, again = aug(batch, 3, 0), aug(batch, 3, 1), aug(batch, 3, 0)
    assert not torch.equal(a[0], b[0])
    assert torch.equal(a[0], again[0]) and torch.equal(a[1], again[1])

    keys = []
    draws = train_mod.DeviceAugment.draws

    def spy(self, step, micro_step):
        keys.append((step, micro_step))
        return draws(self, step, micro_step)

    monkeypatch.setattr(train_mod.DeviceAugment, "draws", spy)
    train_mod.main(args + ["training_config.epochs=1", "--device", "cpu"])
    assert keys == [(0, 0), (0, 1)]


_BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "yaml", "rich", "tqdm")

_NO_JAX_RUN = textwrap.dedent("""
    import json, sys
    for m in {blocked!r}:
        sys.modules[m] = None          # import m now raises ImportError
    from cabinet_tpu_torch.cli.train import main
    res = main(json.loads(sys.argv[1]) + ["--device", "cpu"])
    bad = sorted(m for m in sys.modules if sys.modules[m] is not None
                 and m.split(".")[0] in {blocked!r})
    assert not bad, bad
    print("NO-JAX-TRAIN OK", res["timing"]["optimizer_steps"])
""")


def test_train_main_needs_no_jax_yaml_or_rich(tmp_path):
    """With JAX, Flax, optax, orbax, PyYAML, rich and tqdm blocked (PIL is
    allowed: the train recipe is PIL's), main trains 2 epochs."""
    data = make_uavid_tree(tmp_path / "data")
    args = overrides("uavid", data, tmp_path / "exp")
    res = subprocess.run([sys.executable, "-c", _NO_JAX_RUN.format(blocked=_BLOCKED),
                          json.dumps(args)], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert "NO-JAX-TRAIN OK 4" in res.stdout
    assert set(json.loads(res.stdout.strip().splitlines()[-2])) == {
        "best_miou", "mIoU", "accuracy"}


_LOADERS_RUN = textwrap.dedent("""
    import json, multiprocessing as mp, sys
    from pathlib import Path
    import numpy as np
    from cabinet_tpu_torch.cli.evaluate import main as evaluate_main
    from cabinet_tpu_torch.cli.train import main as train_main

    args, data, tmp = json.loads(sys.argv[1]), sys.argv[2], Path(sys.argv[3])
    out = {}
    for i, loader in enumerate(("thread", "grain", "thread")):
        exp = tmp / f"exp_{i}_{loader}"
        res = train_main([a.replace("EXP", str(exp)) for a in args]
                         + [f"runtime.loader={loader}", "--device", "cpu"])
        lines = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()
                 if '"epoch"' in ln]
        ev = evaluate_main(["dataset=uavid", f"dataset.dataset_path={data}",
                            f"checkpoint_path={exp / 'tiny.pth'}",
                            "model=mobilenetv3_small", args[1],
                            "validation_config.batch_size=1", "validation_config.num_workers=2",
                            "validation_config.eval_scales=[1.0]", "validation_config.flip=false",
                            f"runtime.loader={loader}", "--device", "cpu"])
        out.setdefault(loader, []).append({
            "losses": [(ln["train_loss"], ln["val_loss"], ln["mIoU"]) for ln in lines],
            "steps": res["timing"]["optimizer_steps"],
            "hist": np.asarray(ev["confusion_matrix"]).tolist(),
            "children": len(mp.active_children())})
    print(json.dumps(out))
""")


def test_train_main_grain_loader_matches_thread_loader(tmp_path):
    """main with runtime.loader=grain (two worker processes) trains as the
    thread loader does: the same train and val losses and mIoU at every
    epoch; evaluate main on the weights it wrote, on the process loader,
    gives the thread loader's confusion matrix; no worker outlives either
    main. In a subprocess under a timeout (it starts worker processes)."""
    data = make_uavid_tree(tmp_path / "data", n=6)
    args = overrides("uavid", data, "EXP") + ["training_config.num_workers=2"]
    assert args[1].startswith("model.cfgs=")
    res = subprocess.run([sys.executable, "-c", _LOADERS_RUN, json.dumps(args), str(data),
                          str(tmp_path)], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    (thread, thread_again), (grain,) = out["thread"], out["grain"]
    assert thread == thread_again  # the thread loader repeats itself
    assert grain["steps"] == thread["steps"] == 6
    assert len(grain["losses"]) == 2
    assert grain["losses"] == thread["losses"]
    assert grain["hist"] == thread["hist"] and np.sum(grain["hist"]) > 0
    assert grain["children"] == 0
