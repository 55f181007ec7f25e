"""The port's dataset statistics (cabinet_tpu_torch.data.stats and
cli.compute_stats) against the JAX package's: the same float32 mean and std
on PNGs of every colour type and bit depth (read by the port's PNG reader,
by PIL in JAX) and on JPEG, `max_images`, the empty directory's error, and
the CLI's two lines."""

import numpy as np
import pytest
from PIL import Image
from test_torch_decode import _forms, _samples, write_png

from cabinet_tpu.cli import compute_stats as jcompute_stats_cli
from cabinet_tpu.data.stats import compute_dataset_stats as jcompute
from cabinet_tpu_torch.cli import compute_stats as compute_stats_cli
from cabinet_tpu_torch.data.stats import compute_dataset_stats


def _png_dir(root, forms, interlace=0):
    """One PNG per form, random samples, every row filter in turn."""
    root.mkdir()
    for k, (name, ct, depth, paletted) in enumerate(forms):
        rng = np.random.default_rng([ct, depth, k])
        n_pal = min(1 << depth, 200) if paletted else None
        pal = rng.integers(0, 256, (n_pal, 3)) if paletted else None
        write_png(root / f"{k:02d}_{name}.png", _samples(rng, ct, depth, n_pal), ct, depth,
                  "cycle", interlace=interlace, palette=pal)
    return root


@pytest.mark.parametrize("interlace", [0, 1])
def test_every_png_form_matches_jax(tmp_path, interlace):
    root = _png_dir(tmp_path / "pngs", _forms(), interlace)
    mean, std = compute_dataset_stats(str(root))
    jmean, jstd = jcompute(str(root))
    assert mean.dtype == std.dtype == np.float32
    np.testing.assert_array_equal(mean, jmean)
    np.testing.assert_array_equal(std, jstd)


@pytest.mark.parametrize("depth", [8, 16])
def test_each_sixteen_bit_and_eight_bit_form_alone_matches_jax(tmp_path, depth):
    forms = [f for f in _forms() if f[2] == depth]
    for name, *rest in forms:
        root = _png_dir(tmp_path / name, [(name, *rest)])
        for a, b in zip(compute_dataset_stats(str(root)), jcompute(str(root))):
            np.testing.assert_array_equal(a, b)


def test_jpeg_and_extensions_and_max_images_match_jax(tmp_path):
    root = tmp_path / "mixed"
    root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        img = Image.fromarray(rng.integers(0, 256, (12, 17, 3), dtype=np.uint8))
        img.save(root / f"f{i}.{('png', 'jpg', 'JPEG', 'png', 'jpg')[i]}")
    (root / "notes.txt").write_text("not an image")
    for k in (0, 1, 3):
        got, want = compute_dataset_stats(str(root), max_images=k), jcompute(
            str(root), max_images=k)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    only_png = compute_dataset_stats(str(root), extensions=(".png",))
    for a, b in zip(only_png, jcompute(str(root), extensions=(".png",))):
        np.testing.assert_array_equal(a, b)


def test_empty_directory_raises(tmp_path):
    (tmp_path / "empty").mkdir()
    (tmp_path / "empty" / "a.txt").write_text("")
    with pytest.raises(FileNotFoundError, match="No images found"):
        compute_dataset_stats(str(tmp_path / "empty"))


def test_cli_prints_the_two_lines_jax_prints(tmp_path, capsys):
    root = _png_dir(tmp_path / "pngs", _forms()[:6])
    for extra in ([], ["--max-images", "2"]):
        compute_stats_cli.main([str(root)] + extra)
        out = capsys.readouterr().out
        jcompute_stats_cli.main([str(root)] + extra)
        assert out == capsys.readouterr().out
        assert [ln.split(":")[0] for ln in out.splitlines()] == ["mean", "std"]
