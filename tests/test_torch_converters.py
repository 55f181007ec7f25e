"""The port's dataset converters (cabinet_tpu_torch.data.converters and
cli.convert) against the JAX package's on the same raw trees: the same
files under the same names, masks equal pixel for pixel (decoded with PIL),
the same [INFO]/[WARN]/[DONE] lines and the same counts. The pool of
`convert_uavid` (spawned workers) runs in a subprocess under a timeout."""

import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from cabinet_tpu import native
from cabinet_tpu.cli import convert as jconvert_cli
from cabinet_tpu.data import converters as jconv
from cabinet_tpu.data.palettes import UAVID_CLASSES as JUAVID_CLASSES
from cabinet_tpu_torch.cli import convert as convert_cli
from cabinet_tpu_torch.data import converters as conv
from cabinet_tpu_torch.data.palettes import UAVID_CLASSES

REPO = Path(__file__).resolve().parent.parent
COLORS = np.array([c["color"] for c in UAVID_CLASSES], np.uint8)
UNKNOWN = np.array([[1, 2, 3], [250, 250, 250]], np.uint8)


def make_uavid_raw(root, splits=("train",), seqs=("seq1", "seq2"), n=2, size=(8, 10),
                   seed=0):
    """Raw UAVid: <split>/<seq>/{Images,Labels}/*.png, labels colour-coded
    with the palette and a few unknown colours (-> 255)."""
    rng = np.random.default_rng(seed)
    palette = np.vstack([COLORS, UNKNOWN])
    for split in splits:
        for seq in seqs:
            (root / split / seq / "Images").mkdir(parents=True)
            (root / split / seq / "Labels").mkdir(parents=True)
            for i in range(n):
                Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
                    root / split / seq / "Images" / f"{i:06d}.png")
                ids = rng.integers(0, len(palette), size)
                Image.fromarray(palette[ids]).save(
                    root / split / seq / "Labels" / f"{i:06d}.png")
    return root


def _listing(dst):
    """(relative path, is symlink) of every file under dst."""
    return sorted((str(p.relative_to(dst)), p.is_symlink())
                  for p in dst.rglob("*") if p.is_file() or p.is_symlink())


def _same_outputs(port_dst, jax_dst):
    assert _listing(port_dst) == _listing(jax_dst)
    for rel, _ in _listing(jax_dst):
        a, b = port_dst / rel, jax_dst / rel
        if rel.startswith("masks"):
            with Image.open(a) as ia, Image.open(b) as ib:
                assert ia.mode == ib.mode
                np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))
        else:
            assert a.read_bytes() == b.read_bytes()


def _both(capsys, port_fn, jax_fn):
    """Run both; their return values and printed lines, port first."""
    n_port = port_fn()
    out_port = capsys.readouterr().out
    n_jax = jax_fn()
    out_jax = capsys.readouterr().out
    return n_port, n_jax, out_port, out_jax


def test_colour_map_and_lut_match_jax():
    assert conv.build_colour_map(UAVID_CLASSES) == jconv.build_colour_map(JUAVID_CLASSES)
    np.testing.assert_array_equal(conv.build_rgb_lut(conv.build_colour_map(UAVID_CLASSES)),
                                  jconv.build_rgb_lut(jconv.build_colour_map(JUAVID_CLASSES)))
    classes = [dict(c) for c in UAVID_CLASSES]
    classes[2]["ignoreInEval"] = True
    assert conv.build_colour_map(classes) == jconv.build_colour_map(classes)


@pytest.mark.parametrize("shape", [(1, 3), (7, 9, 3), (2, 5, 6, 3)])
def test_lut_remap_rgb_matches_native(shape):
    rng = np.random.default_rng(len(shape))
    lut = rng.integers(0, 256, (256, 256, 256), dtype=np.uint8)
    rgb = rng.integers(0, 256, shape, dtype=np.uint8)
    got = conv.lut_remap_rgb(rgb, lut)
    assert got.dtype == np.uint8 and got.shape == shape[:-1]
    np.testing.assert_array_equal(got, native.lut_remap_rgb(rgb, lut))
    with pytest.raises(ValueError):
        conv.lut_remap_rgb(rgb, lut[:128])


def test_convert_rgb_mask_matches_jax(tmp_path):
    lut = conv.build_rgb_lut(conv.build_colour_map(UAVID_CLASSES))
    rng = np.random.default_rng(3)
    rgb = np.vstack([COLORS, UNKNOWN])[rng.integers(0, 10, (9, 11))]
    Image.fromarray(rgb).save(tmp_path / "m.png")
    assert conv.convert_rgb_mask(tmp_path / "m.png", tmp_path / "p.png", lut) == "m.png"
    jconv.convert_rgb_mask(tmp_path / "m.png", tmp_path / "j.png", lut)
    with Image.open(tmp_path / "p.png") as a, Image.open(tmp_path / "j.png") as b:
        assert a.mode == b.mode == "L"
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert set(np.unique(np.asarray(a)).tolist()) <= set(range(8)) | {255}


@pytest.mark.parametrize("copy_images", [False, True])
def test_convert_uavid_matches_jax(tmp_path, capsys, copy_images):
    src = make_uavid_raw(tmp_path / "raw", splits=("train", "val"))
    n_port, n_jax, out_port, out_jax = _both(
        capsys,
        lambda: conv.convert_uavid(src, tmp_path / "port", UAVID_CLASSES, workers=1,
                                   copy_images=copy_images),
        lambda: jconv.convert_uavid(src, tmp_path / "jax", JUAVID_CLASSES, workers=1,
                                    copy_images=copy_images))
    assert n_port == n_jax == 8
    assert out_port == out_jax
    assert "[WARN] Missing split directory" in out_port  # no test split
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    img = tmp_path / "port" / "images" / "train" / "seq1_000000.png"
    assert img.is_symlink() != copy_images


def test_convert_uavid_dry_run_and_missing_label_match_jax(tmp_path, capsys):
    src = make_uavid_raw(tmp_path / "raw", seqs=("seq1",), n=3)
    (src / "train" / "seq1" / "Labels" / "000001.png").unlink()
    (src / "train" / "empty").mkdir()
    for dry in (True, False):
        n_port, n_jax, out_port, out_jax = _both(
            capsys,
            lambda: conv.convert_uavid(src, tmp_path / "port", UAVID_CLASSES, workers=1,
                                       dry_run=dry),
            lambda: jconv.convert_uavid(src, tmp_path / "jax", JUAVID_CLASSES, workers=1,
                                        dry_run=dry))
        assert n_port == n_jax == 2 and out_port == out_jax
        assert "No Labels/ mask for seq1/000001.png" in out_port
        if dry:
            assert "would convert 2 masks" in out_port
            assert not (tmp_path / "port").exists() and not (tmp_path / "jax").exists()
    _same_outputs(tmp_path / "port", tmp_path / "jax")


def test_uavid_sequence_discovery_matches_jax(tmp_path):
    src = make_uavid_raw(tmp_path / "raw", seqs=("seq2", "seq10", "seq1"), n=1)
    (src / "train" / "notes").mkdir()
    root = src / "train"
    assert conv.discover_uavid_sequences(root) == jconv.discover_uavid_sequences(root) == [
        "seq1", "seq10", "seq2"]


def _id_mask(path, ids, mode, palette=None):
    if mode == "P":
        im = Image.fromarray(ids.astype(np.uint8), "P")
        im.putpalette(palette.reshape(-1).tolist())
    elif mode == "RGB":
        im = Image.fromarray(np.stack([ids, ids, (ids * 7) % 256], -1).astype(np.uint8))
    else:
        im = Image.fromarray(ids.astype(np.uint8), mode)
    im.save(path)
    return path


@pytest.mark.parametrize("mode", ["L", "P", "RGB"])
@pytest.mark.parametrize("bad", [False, True])
def test_validate_id_mask_matches_jax(tmp_path, mode, bad):
    """A paletted mask is validated by its indices (whose colours'
    luminance is far past the class count here), a colour one by every
    channel, as `np.asarray(Image.open(p))` reads them."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 12, (6, 7))
    if bad:
        ids[0, 0] = 77
    palette = np.full((256, 3), 200, np.uint8)
    path = _id_mask(tmp_path / f"{mode}.png", ids, mode, palette)
    got, want = conv.validate_id_mask(path, 12), jconv.validate_id_mask(path, 12)
    assert got == want
    assert got[0] == (not bad and mode != "RGB")


def make_aeroscapes_raw(root, n=4, bad=(), mode="L", size=(8, 8)):
    rng = np.random.default_rng(0)
    for d in ("JPEGImages", "SegmentationClass", "ImageSets"):
        (root / d).mkdir(parents=True)
    stems = [f"im{i}" for i in range(n)]
    palette = np.tile(np.arange(256, dtype=np.uint8)[::-1, None], (1, 3))
    for i, stem in enumerate(stems):
        Image.fromarray(rng.integers(0, 255, (*size, 3), dtype=np.uint8)).save(
            root / "JPEGImages" / f"{stem}.jpg")
        ids = rng.integers(0, 12, size)
        if i in bad:
            ids[0, 0] = 77
        _id_mask(root / "SegmentationClass" / f"{stem}.png", ids, mode, palette)
    (root / "ImageSets" / "trn.txt").write_text("\n".join(stems[:-1] + ["ghost", ""]))
    (root / "ImageSets" / "val.txt").write_text(stems[-1])
    return root


@pytest.mark.parametrize("mode", ["L", "P"])
def test_convert_aeroscapes_matches_jax(tmp_path, capsys, mode):
    src = make_aeroscapes_raw(tmp_path / "raw", bad=(1,), mode=mode)
    for dry in (True, False):
        n_port, n_jax, out_port, out_jax = _both(
            capsys, lambda: conv.convert_aeroscapes(src, tmp_path / "port", dry_run=dry),
            lambda: jconv.convert_aeroscapes(src, tmp_path / "jax", dry_run=dry))
        assert n_port == n_jax == 3 and out_port == out_jax
        assert "im1.png: invalid pixel values [77]" in out_port
        assert "Missing pair for stem 'ghost'" in out_port
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    assert not (tmp_path / "port" / "images" / "test").exists()
    assert not next((tmp_path / "port" / "images" / "train").iterdir()).is_symlink()


def make_vdd_raw(root, n=2, bad=None):
    rng = np.random.default_rng(0)
    for split in ("train", "val", "test"):
        (root / split / "src").mkdir(parents=True)
        (root / split / "gt").mkdir()
        for i in range(n):
            Image.fromarray(rng.integers(0, 255, (8, 8, 3), dtype=np.uint8)).save(
                root / split / "src" / f"{i:03d}.JPG")
            ids = rng.integers(0, 7, (8, 8)).astype(np.uint8)
            if bad == (split, i):
                ids[1, 1] = 9
            Image.fromarray(ids, "L").save(root / split / "gt" / f"{i:03d}.png")
    Image.fromarray(np.zeros((8, 8), np.uint8), "L").save(root / "train" / "gt" / "lone.png")
    return root


def test_convert_vdd_matches_jax(tmp_path, capsys):
    src = make_vdd_raw(tmp_path / "raw", bad=("val", 1))
    (tmp_path / "raw2").mkdir()
    for dry in (True, False):
        n_port, n_jax, out_port, out_jax = _both(
            capsys, lambda: conv.convert_vdd(src, tmp_path / "port", dry_run=dry),
            lambda: jconv.convert_vdd(src, tmp_path / "jax", dry_run=dry))
        assert n_port == n_jax == 5 and out_port == out_jax
        assert "001.png: invalid pixel values [9]" in out_port
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    img = tmp_path / "port" / "images" / "train" / "000.jpg"
    assert img.is_symlink() and img.resolve() == (src / "train" / "src" / "000.JPG").resolve()
    for split in ("train", "val"):
        assert conv.discover_vdd_stems(src / split) == jconv.discover_vdd_stems(src / split)
    assert conv.discover_vdd_stems(tmp_path / "raw2") == []
    n_port, n_jax, out_port, out_jax = _both(
        capsys, lambda: conv.convert_vdd(tmp_path / "raw2", tmp_path / "p2"),
        lambda: jconv.convert_vdd(tmp_path / "raw2", tmp_path / "j2"))
    assert n_port == n_jax == 0 and out_port == out_jax


@pytest.mark.parametrize("dataset", ["uavid", "uavid_info", "aeroscapes", "vdd"])
def test_cli_convert_prints_what_jax_prints(tmp_path, capsys, dataset):
    if dataset.startswith("uavid"):
        src, name = make_uavid_raw(tmp_path / "raw"), "uavid"
        extra = ["--workers", "1"]
        if dataset == "uavid_info":
            info = tmp_path / "UAVid_info.json"
            info.write_text(json.dumps(UAVID_CLASSES))
            extra += ["--info", str(info)]
    elif dataset == "aeroscapes":
        src, name, extra = make_aeroscapes_raw(tmp_path / "raw"), "aeroscapes", []
    else:
        src, name, extra = make_vdd_raw(tmp_path / "raw"), "vdd", []
    for dry in ([], ["--dry-run"]):
        args = [name, "--src", str(src)] + extra + dry
        convert_cli.main(args + ["--dst", str(tmp_path / "port")])
        out_port = capsys.readouterr().out
        jconvert_cli.main(args + ["--dst", str(tmp_path / "jax")])
        out_jax = capsys.readouterr().out
        assert out_port.replace(str(tmp_path / "port"), "DST") == \
            out_jax.replace(str(tmp_path / "jax"), "DST")
        assert "[DONE] Total masks" in out_port.splitlines()[-1 if dry else -2]
    _same_outputs(tmp_path / "port", tmp_path / "jax")
    with pytest.raises(FileNotFoundError, match="--src does not exist"):
        convert_cli.main([name, "--src", str(tmp_path / "nowhere"), "--dst", "x"])


_POOL_RUN = textwrap.dedent("""
    import sys
    from pathlib import Path
    from cabinet_tpu_torch.cli import convert
    src, dst = sys.argv[1], sys.argv[2]
    convert.main(["uavid", "--src", src, "--dst", dst, "--workers", "3"])
""")


def test_convert_uavid_process_pool_matches_jax(tmp_path):
    """cli.convert uavid with three spawned workers writes what the JAX
    converter writes in one process, and prints the same lines."""
    src = make_uavid_raw(tmp_path / "raw", splits=("train", "val"), n=3, size=(30, 50))
    res = subprocess.run([sys.executable, "-c", _POOL_RUN, str(src), str(tmp_path / "port")],
                         cwd=REPO, capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    n = jconv.convert_uavid(src, tmp_path / "jax", JUAVID_CLASSES, workers=1)
    assert n == 12
    assert f"[DONE] Total masks written: {n}" in res.stdout
    _same_outputs(tmp_path / "port", tmp_path / "jax")
