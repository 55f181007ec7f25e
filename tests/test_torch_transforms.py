"""The port's train transforms (cabinet_tpu_torch.data.transforms) against
the JAX package's: for every transform of both recipes, the same input and
`default_rng(seed)` give the same image and label bit for bit, and leave
the generator in the same state."""

import numpy as np
import pytest
from PIL import Image

from cabinet_tpu.data import transforms as JT
from cabinet_tpu_torch.data import transforms as TT

# (name, kwargs): the aerial and the street recipe's transforms, with their
# defaults and their settings in data/datasets.py, and the blur.
CASES = [
    ("ResizeIfLarger", dict(max_size=40)),
    ("ResizeIfLarger", dict(max_size=100)),
    ("ResizeIfLarger", dict(max_size=20, fast=True)),
    ("ResizeIfLarger", dict(max_size=40, fast=True)),
    ("RandomScale", dict(scales=(0.7, 1.3), continuous=True)),
    ("RandomScale", dict(scales=(0.75, 1.0, 1.25, 1.5, 1.75, 2.0))),
    ("RandomHorizontalFlip", dict(p=0.5)),
    ("RandomVerticalFlip", dict(p=0.2)),
    ("RandomTranslate", dict(translate=0.05, ignore_label=255)),
    ("RandomRotate", dict(degrees=(-10.0, 10.0), ignore_label=255)),
    ("RandomCrop", dict(size=(24, 24), pad_if_needed=True, ignore_label=255)),
    ("RandomCrop", dict(size=(80, 40), pad_if_needed=True, ignore_label=255)),
    ("RandomCrop", dict(size=(80, 40), pad_if_needed=False, ignore_label=255)),
    ("RandomHSV", dict(hgain=0.01, sgain=0.4, vgain=0.3)),
    ("RandomColorJitter", dict(contrast=0.5)),
    ("RandomColorJitter", dict(brightness=0.5, contrast=0.5, saturation=0.5)),
    ("RandomGamma", dict(gamma_range=(0.8, 1.2), p=0.3)),
    ("RandomNoise", dict(mode="gaussian", sigma=0.03, p=0.3)),
    ("RandomNoise", dict(mode="poisson", sigma=0.03, p=0.9)),
    ("RandomCutout", dict(p=0.3, size=16)),
    ("RandomGrayscale", dict(p=0.2)),
    ("RandomGaussianBlur", dict(p=0.5, radius=(0.1, 2.0))),
]


def _sample(seed):
    rng = np.random.default_rng(seed)
    return {"image": Image.fromarray(rng.integers(0, 256, (36, 52, 3), dtype=np.uint8)),
            "label": Image.fromarray(rng.integers(0, 8, (36, 52), dtype=np.uint8))}


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_transform_matches_jax(case):
    name, kwargs = CASES[case]
    ours, ref = getattr(TT, name)(**kwargs), getattr(JT, name)(**kwargs)
    for seed in range(6):  # both outcomes of every coin
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = ours(_sample(seed), rng), ref(_sample(seed), jrng)
        for key in ("image", "label"):
            assert got[key].mode == want[key].mode
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
        assert rng.bit_generator.state == jrng.bit_generator.state


@pytest.mark.parametrize("recipe", ["aerial", "street"])
def test_compose_of_a_recipe_matches_jax(recipe, tmp_path):
    """The datasets' whole host recipes, composed, on one generator."""
    from cabinet_tpu.data import datasets as jds
    from cabinet_tpu_torch.data import datasets as tds

    root = tmp_path / "t"
    if recipe == "aerial":
        for sub in ("images/train", "masks/train"):
            (root / sub).mkdir(parents=True)
        s = _sample(0)
        s["image"].save(root / "images/train/a.png")
        s["label"].save(root / "masks/train/a.png")
        ours = tds.UAVid(255, str(root), [24, 24], mode="train").trans_train
        ref = jds.UAVid(255, str(root), [24, 24], mode="train").trans_train
    else:
        for sub in ("leftImg8bit/train/c", "gtFine/train/c"):
            (root / sub).mkdir(parents=True)
        s = _sample(0)
        s["image"].save(root / "leftImg8bit/train/c/c_0_0_leftImg8bit.png")
        s["label"].save(root / "gtFine/train/c/c_0_0_gtFine_labelIds.png")
        ours = tds.CityScapes(255, str(root), [24, 24], mode="train").trans_train
        ref = jds.CityScapes(255, str(root), [24, 24], mode="train").trans_train
    assert [type(t).__name__ for t in ours.transforms] == [
        type(t).__name__ for t in ref.transforms]
    for seed in range(8):
        rng, jrng = np.random.default_rng(seed), np.random.default_rng(seed)
        got, want = ours(_sample(seed), rng), ref(_sample(seed), jrng)
        for key in ("image", "label"):
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
        assert rng.bit_generator.state == jrng.bit_generator.state


def test_fast_resize_waits_for_the_device_canvas():
    """ResizeIfLarger(fast=True), the device canvas' resize, as the JAX
    package's: PIL's box reduce by k = ceil(longest / max) (52 -> 26 even
    for a cap of 50, and 18), nothing at or under the cap; the label
    NEAREST to the image's size."""
    for max_size, size in ((26, (26, 18)), (20, (18, 12)), (50, (26, 18)), (52, (52, 36))):
        ours, ref = TT.ResizeIfLarger(max_size, fast=True), JT.ResizeIfLarger(max_size, fast=True)
        got, want = ours(_sample(1), np.random.default_rng(0)), ref(_sample(1), None)
        assert got["image"].size == got["label"].size == size
        for key in ("image", "label"):
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(want[key]))
