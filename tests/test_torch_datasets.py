"""The port's val/test datasets, thread loader and the CLI plumbing around
them (cabinet_tpu_torch.data.{datasets,loader}, cli.common) against the JAX
package's, on small trees of all four layouts: PNG images for UAVid and
Cityscapes, JPEG images for AeroScapes and VDD, masks in L and P."""

import json
import threading

import numpy as np
import pytest
from PIL import Image

from cabinet_tpu.cli import common as jcommon
from cabinet_tpu.core.config import compose as jcompose
from cabinet_tpu.core.exceptions import ConfigurationError as JConfigurationError
from cabinet_tpu.core.exceptions import DatasetError as JDatasetError
from cabinet_tpu.data import datasets as jds
from cabinet_tpu.data import palettes as jpal
from cabinet_tpu.data.loader import DataLoader as JDataLoader
from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.core.config import compose
from cabinet_tpu_torch.core.exceptions import ConfigurationError, DatasetError
from cabinet_tpu_torch.data import datasets as tds
from cabinet_tpu_torch.data.loader import DataLoader

H, W = 20, 28
CITY_IDS = np.array([0, 1, 7, 8, 11, 12, 13, 21, 24, 26, 33, 255, 250], np.uint8)


def _mask_image(labels, mode, rng):
    if mode == "L":
        return Image.fromarray(labels.astype(np.uint8), "L")
    im = Image.fromarray(labels.astype(np.uint8), "P")  # luminance of colours
    im.putpalette(rng.integers(0, 256, 768).astype(np.uint8).tolist())
    return im


def _make_folder_tree(root, ext, splits, n=3, mask_mode="L", seed=0, sizes=None):
    rng = np.random.default_rng(seed)
    for split in splits:
        (root / "images" / split).mkdir(parents=True)
        (root / "masks" / split).mkdir(parents=True)
        for i in range(n):
            h, w = sizes[i] if sizes else (H, W)
            img = Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            img.save(root / "images" / split / f"f{i}{ext}", quality=92)
            _mask_image(rng.integers(0, 8, (h, w)), mask_mode, rng).save(
                root / "masks" / split / f"f{i}.png")
    return root


def _make_city_tree(root, splits, n=2, mask_mode="L", seed=1):
    rng = np.random.default_rng(seed)
    for split in splits:
        for city in ("aachen", "bremen"):
            (root / "leftImg8bit" / split / city).mkdir(parents=True)
            (root / "gtFine" / split / city).mkdir(parents=True)
            for i in range(n):
                base = f"{city}_{i:06d}_000019"
                Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(
                    root / "leftImg8bit" / split / city / f"{base}_leftImg8bit.png")
                _mask_image(rng.choice(CITY_IDS, (H, W)), mask_mode, rng).save(
                    root / "gtFine" / split / city / f"{base}_gtFine_labelIds.png")
    return root


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    base = tmp_path_factory.mktemp("datasets")
    return {
        "uavid": _make_folder_tree(base / "uavid", ".png", ("val", "test", "train"),
                                   mask_mode="P", sizes=[(H, W), (H + 4, W), (H, W + 6)]),
        "aeroscapes": _make_folder_tree(base / "aeroscapes", ".jpg", ("val",), seed=2),
        "vdd": _make_folder_tree(base / "vdd", ".jpg", ("val", "test"), mask_mode="P",
                                 seed=3),
        "cityscapes": _make_city_tree(base / "cityscapes", ("val", "test", "train")),
        "cityscapes_p": _make_city_tree(base / "cityscapes_p", ("val",), mask_mode="P"),
        "aeroscapes_big": _make_folder_tree(base / "aeroscapes_big", ".jpg", ("train",),
                                            n=2, seed=4, sizes=[(64, 96), (48, 80)]),
    }


CASES = [("uavid", "uavid", "val"), ("uavid", "uavid", "test"),
         ("aeroscapes", "aeroscapes", "val"), ("vdd", "vdd", "val"),
         ("vdd", "vdd", "test"), ("cityscapes", "cityscapes", "val"),
         ("cityscapes", "cityscapes", "test"), ("cityscapes", "cityscapes_p", "val"),
         ("uavid", "uavid", "train"), ("cityscapes", "cityscapes", "train")]


@pytest.mark.parametrize("name,tree,mode", CASES, ids=[f"{t}-{m}" for _, t, m in CASES])
def test_getitem_matches_jax(trees, name, tree, mode):
    """Image float32 bit for bit, label int64; the kwargs built from the
    same config by both packages' DATASET_KWARGS_BUILDERS are equal. Train
    mode (16x16 crops; UAVid with mixup forced on, so that every sample
    blends two) at epochs 0 and 1, which draw different samples."""
    cfg_args = [f"dataset={name}", f"dataset.dataset_path={trees[tree]}"]
    config = "evaluate"
    if mode == "train":
        config = "train"
        cfg_args.append("dataset.cropsize=[16,16]")
        if name == "uavid":
            cfg_args.append("dataset.augmentation.mixup=1.0")
    else:
        cfg_args.append("checkpoint_path=x")
    kw = tds.DATASET_KWARGS_BUILDERS[name](
        compose(jcommon.CONFIG_DIR, config, cfg_args), mode)
    jkw = jds.DATASET_KWARGS_BUILDERS[name](
        jcompose(jcommon.CONFIG_DIR, config, cfg_args), mode)
    assert kw == jkw
    ours = tds.DATASET_REGISTRY[name](**kw)
    ref = jds.DATASET_REGISTRY[name](**jkw)
    assert [s for s in ours.samples] == [s for s in ref.samples]
    assert len(ours) == len(ref) > 0
    epochs = (0, 1) if mode == "train" else (0,)
    firsts = []
    for epoch in epochs:
        if mode == "train":
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
        for i in range(len(ref)):
            (img, lb), (rimg, rlb) = ours[i], ref[i]
            assert img.dtype == rimg.dtype == np.float32
            assert lb.dtype == rlb.dtype == np.int64
            np.testing.assert_array_equal(img, rimg)
            np.testing.assert_array_equal(lb, rlb)
        firsts.append(ours[0][0])
        if mode == "train":
            assert img.shape == (16, 16, 3) and lb.shape == (16, 16)
    if mode == "train":
        assert not np.array_equal(firsts[0], firsts[1])
        assert ours.mixup_p == (1.0 if name == "uavid" else 0.0)
    if name == "cityscapes":
        assert set(np.unique(lb)) <= set(range(19)) | {255}


@pytest.mark.parametrize("cls_pw", [0.0, 0.5, 1.2])
def test_class_weights_match_jax(trees, cls_pw):
    """get_class_pixel_counts over the augmented train samples and the ENet
    weights of compute_class_weights equal the JAX package's."""
    from cabinet_tpu.data import class_weights as jcw
    from cabinet_tpu_torch.data import class_weights as tcw

    ours = tds.CityScapes(255, str(trees["cityscapes"]), [16, 16], mode="train")
    ref = jds.CityScapes(255, str(trees["cityscapes"]), [16, 16], mode="train")
    counts = tcw.get_class_pixel_counts(ours, 19, 255)
    ref_counts = jcw.get_class_pixel_counts(ref, 19, 255)
    np.testing.assert_array_equal(counts, ref_counts)
    assert counts.sum() > 0
    w, rw = tcw.compute_class_weights(counts, cls_pw), jcw.compute_class_weights(ref_counts, cls_pw)
    assert w.dtype == rw.dtype == np.float32
    np.testing.assert_array_equal(w, rw)
    np.testing.assert_array_equal(tcw.get_class_pixel_counts(ours, 19, 255, max_samples=1),
                                  jcw.get_class_pixel_counts(ref, 19, 255, max_samples=1))


def test_stats_and_flags_match_jax():
    for name, cls in tds.DATASET_REGISTRY.items():
        ref = jds.DATASET_REGISTRY[name]
        for attr in ("NAME", "NUM_CLASSES", "MEAN", "STD", "IMG_EXT", "SPLITS",
                     "UNIFORM_RESOLUTION"):
            assert getattr(cls, attr) == getattr(ref, attr), (name, attr)


def test_cityscapes_config_file_and_lut(trees, tmp_path):
    info = tmp_path / "cityscapes_info.json"
    jpal.write_info_json("cityscapes", info)
    classes = json.loads(info.read_text())
    classes[3]["trainId"] = 4  # an edited table must reach the LUT
    info.write_text(json.dumps(classes))
    kw = dict(ignore_lb=255, rootpth=str(trees["cityscapes"]), cropsize=[16, 16],
              mode="val", config_file=str(info))
    ours, ref = tds.CityScapes(**kw), jds.CityScapes(**kw)
    np.testing.assert_array_equal(ours._lut, ref._lut)
    for i in range(len(ref)):
        np.testing.assert_array_equal(ours[i][1], ref[i][1])


def test_cityscapes_skips_a_missing_label(trees, tmp_path):
    import shutil

    root = tmp_path / "cs"
    shutil.copytree(trees["cityscapes"], root)
    next((root / "gtFine" / "val" / "aachen").iterdir()).unlink()
    with pytest.warns(UserWarning, match="Missing label"):
        ours = tds.CityScapes(255, str(root), [16, 16], mode="val")
    with pytest.warns(UserWarning, match="Missing label"):
        ref = jds.CityScapes(255, str(root), [16, 16], mode="val")
    assert ours.samples == ref.samples and len(ours) == 3


def test_folder_skips_an_image_without_mask(trees, tmp_path):
    import shutil

    root = tmp_path / "u"
    shutil.copytree(trees["uavid"], root)
    (root / "masks" / "val" / "f1.png").unlink()
    with pytest.warns(UserWarning, match="no matching mask"):
        ours = tds.UAVid(255, str(root), [16, 16], mode="val")
    with pytest.warns(UserWarning, match="no matching mask"):
        ref = jds.UAVid(255, str(root), [16, 16], mode="val")
    assert ours.samples == ref.samples and len(ours) == 2


def _raises_both(fn_ours, fn_ref, ours_exc, ref_exc):
    with pytest.raises(ref_exc):
        fn_ref()
    with pytest.raises(ours_exc):
        fn_ours()


def test_error_paths_match_jax(trees, tmp_path):
    # a missing split directory
    _raises_both(lambda: tds.VDD(255, str(trees["aeroscapes"]), [16, 16], mode="test"),
                 lambda: jds.VDD(255, str(trees["aeroscapes"]), [16, 16], mode="test"),
                 FileNotFoundError, FileNotFoundError)
    # a missing root
    _raises_both(lambda: tds.UAVid(255, str(tmp_path / "no"), [16, 16], mode="val"),
                 lambda: jds.UAVid(255, str(tmp_path / "no"), [16, 16], mode="val"),
                 FileNotFoundError, FileNotFoundError)
    # no pairs
    empty = tmp_path / "empty"
    (empty / "images" / "val").mkdir(parents=True)
    (empty / "masks" / "val").mkdir(parents=True)
    (empty / "leftImg8bit" / "val" / "x").mkdir(parents=True)
    (empty / "gtFine" / "val" / "x").mkdir(parents=True)
    _raises_both(lambda: tds.UAVid(255, str(empty), [16, 16], mode="val"),
                 lambda: jds.UAVid(255, str(empty), [16, 16], mode="val"),
                 DatasetError, JDatasetError)
    _raises_both(lambda: tds.CityScapes(255, str(empty), [16, 16], mode="val"),
                 lambda: jds.CityScapes(255, str(empty), [16, 16], mode="val"),
                 DatasetError, JDatasetError)
    # AeroScapes has no test split
    _raises_both(lambda: tds.AeroScapes(255, str(trees["aeroscapes"]), [16, 16], mode="test"),
                 lambda: jds.AeroScapes(255, str(trees["aeroscapes"]), [16, 16], mode="test"),
                 DatasetError, JDatasetError)
    # a mode that does not exist
    _raises_both(lambda: tds.UAVid(255, str(trees["uavid"]), [16, 16], mode="eval"),
                 lambda: jds.UAVid(255, str(trees["uavid"]), [16, 16], mode="eval"),
                 ValueError, ValueError)
    # the device augmentation pipeline constructs, as the JAX package's does
    root = str(trees["uavid"])
    for kwargs in (dict(photometric="device"), dict(photometric="device", geometric="device"),
                   dict(photometric="device", geometric="device", reduced_decode=True,
                        decode_cache=str(tmp_path / "cache")),
                   dict(decode_cache=str(tmp_path / "cache"))):
        for cls, jcls, tree in ((tds.UAVid, jds.UAVid, root),
                                (tds.CityScapes, jds.CityScapes, str(trees["cityscapes"]))):
            ours = cls(255, tree, [16, 16], mode="train", **kwargs)
            ref = jcls(255, tree, [16, 16], mode="train", **kwargs)
            for attr in ("photometric", "geometric", "reduced_decode", "mixup_p", "aug",
                         "RECIPE"):
                assert getattr(ours, attr) == getattr(ref, attr), attr
            assert getattr(ours, "canvas", None) == getattr(ref, "canvas", None)
            assert (ours._cache_dir is None) == (ref._cache_dir is None)
    # where the JAX package refuses a combination, so does the port
    for kwargs in (dict(geometric="device"), dict(reduced_decode=True),
                   dict(photometric="gpu"), dict(geometric="cpu"),
                   dict(photometric="device", geometric="device", ignore_lb=300)):
        kwargs = {"ignore_lb": 255, **kwargs}
        ignore = kwargs.pop("ignore_lb")
        _raises_both(lambda: tds.UAVid(ignore, root, [16, 16], mode="train", **kwargs),
                     lambda: jds.UAVid(ignore, root, [16, 16], mode="train", **kwargs),
                     ValueError, ValueError)
        city = str(trees["cityscapes"])
        _raises_both(lambda: tds.CityScapes(ignore, city, [16, 16], mode="train", **kwargs),
                     lambda: jds.CityScapes(ignore, city, [16, 16], mode="train", **kwargs),
                     ValueError, ValueError)


DEVICE_CASES = [("uavid", "uavid", "runtime.device_augs=true"),
                ("uavid", "uavid", "runtime.device_geometric=true"),
                ("uavid", "uavid", "runtime.device_geometric=shared"),
                ("cityscapes", "cityscapes", "runtime.device_augs=true"),
                ("cityscapes", "cityscapes", "runtime.device_geometric=true"),
                ("aeroscapes", "aeroscapes_big", "runtime.device_geometric=true")]


@pytest.mark.parametrize("name,tree,knob", DEVICE_CASES,
                         ids=[f"{t}-{k.split('=')[0][8:]}-{k.split('=')[1]}"
                              for _, t, k in DEVICE_CASES])
def test_device_pipeline_samples_match_jax(trees, tmp_path, name, tree, knob):
    """The train side of the device pipeline, bit for bit the JAX package's:
    raw [0, 1] crops (device_augs) or the canvas triples (device_geometric,
    the UAVid frames box-reduced into a 16^2 canvas, Cityscapes' native
    frame kept, AeroScapes' JPEGs reduced in the DCT), the decode cache's
    file names and arrays, and the cached triples read back."""
    args = [f"dataset={name}", f"dataset.dataset_path={trees[tree]}",
            "dataset.cropsize=[8,8]", knob, f"+runtime.decode_cache={tmp_path / 'cache'}"]
    if tree == "aeroscapes_big":
        args.append("+runtime.reduced_decode=true")
    kw = tds.DATASET_KWARGS_BUILDERS[name](compose(jcommon.CONFIG_DIR, "train", args), "train")
    jkw = jds.DATASET_KWARGS_BUILDERS[name](jcompose(jcommon.CONFIG_DIR, "train", args),
                                            "train")
    assert kw == jkw
    jkw["decode_cache"] = str(tmp_path / "jcache")
    ours, ref = tds.DATASET_REGISTRY[name](**kw), jds.DATASET_REGISTRY[name](**jkw)
    for _ in range(2):  # cold, then from the cache
        for i in range(len(ref)):
            got, want = ours[i], ref[i]
            assert len(got) == len(want) == (3 if "geometric" in knob else 2)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype and g.shape == w.shape
                np.testing.assert_array_equal(g, w)
    if "geometric" not in knob:
        assert ours.mixup_p == 0.0 and got[0].max() <= 1.0
        return
    assert ours.canvas == (28 if name == "cityscapes" else 16)
    assert got[2].tolist() != [ours.canvas] * 2 or name == "cityscapes"
    files = sorted(p.name for p in (tmp_path / "cache" / f"{name}_train").iterdir())
    jfiles = sorted(p.name for p in (tmp_path / "jcache" / f"{name}_train").iterdir())
    assert files == jfiles and len(files) == len(ref)
    for f in files:
        with np.load(tmp_path / "cache" / f"{name}_train" / f) as d, \
                np.load(tmp_path / "jcache" / f"{name}_train" / f) as e:
            for k in ("ci", "cl", "hw"):
                np.testing.assert_array_equal(d[k], e[k])


def test_decode_cache_redoes_a_broken_file(trees, tmp_path):
    kw = dict(photometric="device", geometric="device", decode_cache=str(tmp_path))
    ds = tds.UAVid(255, str(trees["uavid"]), [8, 8], mode="train", **kw)
    want = ds[0]
    f = ds._cache_file(0)
    f.write_bytes(b"PK\x03\x04 not a whole zip")
    got = ds[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with np.load(f) as d:
        np.testing.assert_array_equal(d["ci"], want[0])


@pytest.mark.parametrize("decoder", ["pil", "cv2"])
def test_reduced_jpeg_decode_matches_jax(trees, decoder):
    """open_rgb(reduce_to=) on a JPEG written by PIL: PIL's draft or cv2's
    reduced read, as the JAX package's; a PNG decodes full size."""
    from cabinet_tpu.data import decode as jdecode
    from cabinet_tpu_torch.data import decode as tdecode

    for longest, cap in ((3840, 2048), (2048, 2048), (4096, 1024), (4096, 256),
                         (512, 2048), (3000, 1024), (100, 0)):
        assert tdecode._reduce_factor(longest, cap) == jdecode._reduce_factor(longest, cap)
    jpg = sorted((trees["aeroscapes_big"] / "images" / "train").iterdir())[0]
    for cap, shape in ((16, (16, 24, 3)), (40, (32, 48, 3)), (0, (64, 96, 3))):
        got = tdecode.open_rgb(jpg, decoder, reduce_to=cap)
        want = np.asarray(jdecode.open_rgb(str(jpg), decoder, reduce_to=cap))
        np.testing.assert_array_equal(got, want)
        assert got.shape == shape
    png = sorted((trees["uavid"] / "images" / "train").iterdir())[0]
    np.testing.assert_array_equal(tdecode.open_rgb(png, decoder, reduce_to=8),
                                  tdecode.open_rgb(png, decoder))


@pytest.mark.parametrize("name,batch,ok", [("uavid", 2, False), ("uavid", 1, True),
                                           ("vdd", 2, True), ("cityscapes", 4, True)])
def test_guard_val_batch_matches_jax(trees, name, batch, ok):
    root = trees[name]
    args = ["checkpoint_path=x", f"dataset={name}", f"dataset.dataset_path={root}"]
    cfg, jcfg = (compose(jcommon.CONFIG_DIR, "evaluate", args),
                 jcompose(jcommon.CONFIG_DIR, "evaluate", args))
    (ours,) = common.build_datasets(cfg, ["val"])
    (ref,) = jcommon.build_datasets(jcfg, ["val"])
    if ok:
        common.guard_val_batch(cfg, ours, batch)
        jcommon.guard_val_batch(jcfg, ref, batch)
    else:
        _raises_both(lambda: common.guard_val_batch(cfg, ours, batch),
                     lambda: jcommon.guard_val_batch(jcfg, ref, batch),
                     ConfigurationError, JConfigurationError)


def test_build_datasets_errors_match_jax(monkeypatch):
    monkeypatch.delenv("UAVID_YOLO_ROOT", raising=False)
    for args in (["checkpoint_path=x", "dataset=uavid"],             # empty root
                 ["checkpoint_path=x", "dataset.name=nope"]):       # unknown name
        _raises_both(
            lambda: common.build_datasets(compose(jcommon.CONFIG_DIR, "evaluate", args), ["val"]),
            lambda: jcommon.build_datasets(jcompose(jcommon.CONFIG_DIR, "evaluate", args), ["val"]),
            ConfigurationError, JConfigurationError)


class _Numbers:
    """A dataset of small arrays whose values name the index."""

    def __init__(self, n):
        self.n = n
        self.epochs = []

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return np.full((2, 3, 3), i, np.float32), np.full((2, 3), i, np.int64)

    def set_epoch(self, e):
        self.epochs.append(e)


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_last", [False, True])
def test_loader_batches_match_jax(num_workers, shuffle, drop_last):
    kw = dict(batch_size=3, shuffle=shuffle, drop_last=drop_last,
              num_workers=num_workers, seed=7)
    ours, ref = DataLoader(_Numbers(10), **kw), JDataLoader(_Numbers(10), **kw)
    assert len(ours) == len(ref) == (3 if drop_last else 4)
    for epoch in range(2):  # each pass advances the epoch, as in JAX
        got, want = list(ours), list(ref)
        assert len(got) == len(want)
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)
            assert gi.dtype == np.float32 and gl.dtype == np.int64
    assert ours.dataset.epochs == ref.dataset.epochs == [1, 2]
    ours.set_epoch(5)
    ref.set_epoch(5)
    assert [b[1][:, 0, 0].tolist() for b in ours] == [b[1][:, 0, 0].tolist() for b in ref]


def test_loader_over_a_real_dataset_matches_jax(trees):
    kw = dict(ignore_lb=255, rootpth=str(trees["vdd"]), cropsize=[16, 16], mode="val")
    got = list(DataLoader(tds.VDD(**kw), 2, num_workers=2))
    want = list(JDataLoader(jds.VDD(**kw), 2, num_workers=2))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_loader_stops_its_pool_when_the_consumer_stops():
    before = threading.active_count()
    it = iter(DataLoader(_Numbers(50), 2, num_workers=3))
    next(it)
    it.close()  # cancels what has not started and shuts the pool down
    assert threading.active_count() == before


def test_loader_passes_a_worker_error_on():
    class Bad(_Numbers):
        def __getitem__(self, i):
            if i == 4:
                raise OSError("unreadable")
            return super().__getitem__(i)

    before = threading.active_count()
    with pytest.raises(OSError, match="unreadable"):
        list(DataLoader(Bad(10), 2, num_workers=2))
    assert threading.active_count() == before


def test_make_loader_and_eval_settings_match_jax():
    base = ["checkpoint_path=x"]
    for extra in ([], ["runtime.eval_tile_batch=8", "runtime.eval_acc_dtype=bfloat16",
                       "validation_config.eval_pad_to=[2160,4096]"],
                  ["runtime.eval_acc_dtype=float32", "dataset=uavid"]):
        cfg = compose(jcommon.CONFIG_DIR, "evaluate", base + extra)
        jcfg = jcompose(jcommon.CONFIG_DIR, "evaluate", base + extra)
        assert common.eval_pad_to(cfg) == jcommon.eval_pad_to(jcfg)
        # auto: the port's own tile batch (16), not the TPU's 64
        assert common.eval_tile_batch(cfg) == jcommon.eval_tile_batch(jcfg)
        acc = common.eval_acc_dtype(cfg)
        jacc = jcommon.eval_acc_dtype(jcfg)
        assert (acc is None) == (jacc is None)
        if acc is not None:
            assert str(acc).split(".")[-1] == np.dtype(jacc).name
        assert str(common.compute_dtype_of(cfg)).split(".")[-1] == \
            np.dtype(jcommon.compute_dtype_of(jcfg)).name
    loader = common.make_loader(compose(jcommon.CONFIG_DIR, "evaluate", base),
                                _Numbers(4), 2, num_workers=0)
    assert isinstance(loader, DataLoader) and len(loader) == 2
    from cabinet_tpu_torch.data.grain_loader import GrainLoader

    grain = common.make_loader(compose(jcommon.CONFIG_DIR, "evaluate",
                                       base + ["runtime.loader=grain"]), _Numbers(4), 2,
                               num_workers=0)
    assert isinstance(grain, GrainLoader) and len(grain) == 2
    bad = base + ["runtime.loader=procs"]
    _raises_both(lambda: common.make_loader(compose(jcommon.CONFIG_DIR, "evaluate", bad),
                                            _Numbers(4), 2),
                 lambda: jcommon.make_loader(jcompose(jcommon.CONFIG_DIR, "evaluate", bad),
                                             _Numbers(4), 2),
                 ConfigurationError, JConfigurationError)
    bad = base + ["runtime.eval_acc_dtype=float16"]
    _raises_both(lambda: common.eval_acc_dtype(compose(jcommon.CONFIG_DIR, "evaluate", bad)),
                 lambda: jcommon.eval_acc_dtype(jcompose(jcommon.CONFIG_DIR, "evaluate", bad)),
                 ConfigurationError, JConfigurationError)


def test_parse_cli_and_checkpoints_not_ported_raise(tmp_path):
    cfg, args = common.parse_cli(["checkpoint_path=a.pth", "dataset=vdd", "--device", "cpu"],
                                 "evaluate", "test")
    assert cfg.dataset.name == "vdd" and args.device == "cpu"
    assert common.parse_cli(["checkpoint_path=a"], "evaluate", "t")[1].device == "cuda"
    legacy = common.REPO_ROOT / "legacy" / "train_uavid.json"
    cfg, args = common.parse_cli(["--legacy-config", str(legacy), "--device", "cpu"],
                                 "train", "test")
    assert cfg.dataset.name == "uavid" and cfg.training_config.warmup_steps == 3000
    with pytest.raises(ConfigurationError, match="legacy config not found"):
        common.parse_cli(["--legacy-config", "old.json"], "train", "test")
    with pytest.raises(NotImplementedError, match="orbax"):
        common.load_model_variables(str(tmp_path), None)
