"""The port's mosaic / mixup / copy-paste wrapper
(cabinet_tpu_torch/data/mosaic.py) against the JAX package's
(cabinet_tpu/data/mosaic.py) on the CPU: samples bit-equal over seeds,
epochs and indices on the same base dataset, for each augmentation alone,
all together, disabled by close_mosaic and with a mean pad value; then
JAX's contract tests (tests/unit/test_yolosem_mosaic.py) on the port's
class."""

import numpy as np
import pytest

from cabinet_tpu.data.mosaic import MosaicSegDataset as JaxMosaic
from cabinet_tpu_torch.data.mosaic import MosaicSegDataset


class ToySeg:
    """JAX's contract tests' base: constant images and labels."""

    def __init__(self, n=6, hw=(32, 32)):
        self.n, self.hw = n, hw

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        img = np.full((*self.hw, 3), float(i), np.float32)
        lbl = np.full(self.hw, i % 4, np.int64)
        return img, lbl


class NoiseSeg:
    """Seeded noise images and blocky labels (with ignore pixels), one
    sample of another size, and an epoch the samples depend on."""

    def __init__(self, n=7, hw=(24, 40), odd=5):
        self.n, self.hw, self.odd, self.epoch = n, hw, odd, 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        rng = np.random.default_rng([self.epoch, i])
        hw = (self.hw[0] + 8, self.hw[1]) if i == self.odd else self.hw
        img = rng.standard_normal((*hw, 3)).astype(np.float32)
        lbl = np.kron(rng.integers(0, 6, (hw[0] // 8, hw[1] // 8)), np.ones((8, 8), np.int64))
        lbl[rng.random(hw) < 0.05] = 255
        return img, lbl


CASES = {
    "mosaic": dict(mosaic=1.0, mixup=0.0, copy_paste=0.0),
    "copy_paste": dict(mosaic=0.0, mixup=0.0, copy_paste=1.0),
    "mixup": dict(mosaic=0.0, mixup=1.0, copy_paste=0.0),
    "recipe": dict(mosaic=0.8, mixup=0.1, copy_paste=0.15),
    "all": dict(mosaic=0.6, mixup=0.5, copy_paste=0.5),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("enabled", [True, False], ids=["on", "closed"])
def test_samples_bit_equal_to_jax(case, enabled):
    """Seeds 0 and 15, epochs 0-2, every index: image and label arrays
    equal (dtype and bits) to JAX's wrapper's on the same base."""
    for seed in (0, 15):
        ours = MosaicSegDataset(NoiseSeg(), seed=seed, **CASES[case])
        ref = JaxMosaic(NoiseSeg(), seed=seed, **CASES[case])
        ours.set_mosaic(enabled)
        ref.set_mosaic(enabled)
        for epoch in range(3):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert ours.base.epoch == epoch
            for i in range(len(ref)):
                (gi, gl), (ri, rl) = ours[i], ref[i]
                assert gi.dtype == ri.dtype == np.float32 and gl.dtype == rl.dtype == np.int64
                np.testing.assert_array_equal(gi, ri)
                np.testing.assert_array_equal(gl, rl)


def test_mean_pad_value_bit_equal_to_jax():
    """A per-channel pad value (the device-augs mode's dataset mean) fills
    the uncovered canvas as JAX's does."""
    mean = np.asarray([0.4, 0.5, 0.6], np.float32)
    ours = MosaicSegDataset(NoiseSeg(hw=(16, 24), odd=-1), mosaic=1.0, seed=3,
                            pad_value=mean)
    ref = JaxMosaic(NoiseSeg(hw=(16, 24), odd=-1), mosaic=1.0, seed=3, pad_value=mean)
    padded = 0
    for i in range(len(ref)):
        (gi, gl), (ri, rl) = ours[i], ref[i]
        np.testing.assert_array_equal(gi, ri)
        np.testing.assert_array_equal(gl, rl)
        padded += int(np.all(gi == mean, axis=-1).sum())
    assert padded > 0  # some crops reach past the four tiles


# --- JAX's contract tests (tests/unit/test_yolosem_mosaic.py:50-95) ---------

def test_mosaic_output_shape_preserved():
    ds = MosaicSegDataset(ToySeg(), mosaic=1.0, mixup=0.0, copy_paste=0.0)
    img, lbl = ds[0]
    assert img.shape == (32, 32, 3)
    assert lbl.shape == (32, 32)
    assert len(np.unique(img[..., 0])) > 1


def test_mosaic_disabled_passthrough():
    ds = MosaicSegDataset(ToySeg(), mosaic=1.0, mixup=0.0, copy_paste=0.0)
    ds.set_mosaic(False)
    img, lbl = ds[2]
    np.testing.assert_array_equal(img, np.full((32, 32, 3), 2.0))
    np.testing.assert_array_equal(lbl, np.full((32, 32), 2))


def test_copy_paste_brings_partner_classes():
    base = ToySeg()
    ds = MosaicSegDataset(base, mosaic=0.0, mixup=0.0, copy_paste=1.0)
    assert any(not np.array_equal(ds[i][1], base[i][1]) for i in range(6))


def test_mixup_hard_label():
    ds = MosaicSegDataset(ToySeg(), mosaic=0.0, mixup=1.0, copy_paste=0.0)
    img, lbl = ds[1]
    assert not np.all(img == np.round(img)) or len(np.unique(lbl)) == 1
    assert lbl.dtype == np.int64


def test_mixup_survives_close_mosaic():
    """Mixup is drawn after set_mosaic(False) too, as in the JAX wrapper."""
    ds = MosaicSegDataset(ToySeg(), mosaic=1.0, mixup=1.0, copy_paste=1.0)
    ds.set_mosaic(False)
    img, _ = ds[1]
    assert not np.all(img == 1.0)


def test_deterministic_per_epoch():
    ds = MosaicSegDataset(ToySeg(), mosaic=1.0)
    a, b = ds[0], ds[0]
    np.testing.assert_array_equal(a[0], b[0])
    ds.set_epoch(3)
    assert not np.array_equal(a[0], ds[0][0])
