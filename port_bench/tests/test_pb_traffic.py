"""Every generator repeats exactly for one seed and differs for another,
whatever the seed's size; the benchmark's PNG files decode to their
arrays through the port's reader."""

import numpy as np
import pytest
import torch

from port_bench import frames
from port_bench.weights import make_state_dict

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("make", [
    lambda s: frames.smooth_frames(s, 2, 40, 72, "cpu"),
    lambda s: frames.block_labels(s, 2, 40, 72, 19, "cpu"),
    lambda s: make_state_dict(8, s, "cpu", calib_hw=32)["sb.conv1.conv.weight"].numpy(),
    lambda s: make_state_dict(8, s, "cpu", calib_hw=32)["mobile.conv.1.running_var"].numpy(),
])
def test_a_seed_gives_the_same_inputs(make):
    a, b, c = make(BIG), make(BIG), make(BIG + 1)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_reference_augmentation_draws_repeat():
    from port_bench.reference import augment

    r1, n1 = augment.draws(BIG, 4000, 0, "cpu")
    r2, n2 = augment.draws(BIG, 4000, 0, "cpu")
    assert np.array_equal(augment.sample_params(r1, 4, np.full((4, 2), 64), 32, 32)["crop_u"],
                          augment.sample_params(r2, 4, np.full((4, 2), 64), 32, 32)["crop_u"])
    assert torch.equal(torch.randn(5, generator=n1), torch.randn(5, generator=n2))


def test_png_round_trip_through_the_port_reader(tmp_path):
    from cabinet_tpu_torch.data.decode import open_mask, open_rgb

    img = frames.smooth_frames(3, 2, 24, 40, "cpu")
    raw = frames.city_raw_labels(frames.block_labels(3, 2, 24, 40, 19, "cpu", block=8))
    frames.write_city_split(tmp_path, img, raw)
    files = sorted((tmp_path / "leftImg8bit" / "train" / "aachen").iterdir())
    masks = sorted((tmp_path / "gtFine" / "train" / "aachen").iterdir())
    for i, (f, m) in enumerate(zip(files, masks)):
        assert np.array_equal(open_rgb(f), img[i])
        assert np.array_equal(open_mask(m), raw[i])
    assert (raw[:, :1] == frames.CITY_UNLABELED).all()
    assert set(np.unique(frames.city_trainids(raw))) <= set(range(19)) | {255}
