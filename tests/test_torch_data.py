"""The port's own copies of the JAX package's tables (dataset statistics,
palettes, the model constants) against the originals, and the mask
colouring built on them."""

import numpy as np
import pytest

from cabinet_tpu.core.constants import MODEL_CONFIG as J_MODEL_CONFIG
from cabinet_tpu.data import palettes as j_pal
from cabinet_tpu.data.datasets import DATASET_REGISTRY as J_REGISTRY
from cabinet_tpu_torch.core.constants import MODEL_CONFIG
from cabinet_tpu_torch.data import palettes as t_pal
from cabinet_tpu_torch.data.datasets import DATASET_REGISTRY

DATASETS = ["cityscapes", "uavid", "aeroscapes", "vdd"]


def test_registries_cover_the_same_datasets():
    assert set(DATASET_REGISTRY) == set(J_REGISTRY) == set(DATASETS)
    assert set(t_pal.PALETTES) == set(j_pal.PALETTES)


@pytest.mark.parametrize("name", DATASETS)
def test_dataset_stats_and_palette_match_jax(name):
    """NUM_CLASSES/MEAN/STD that Segmenter reads, the class records, and
    colorize_mask on a mask with every train id and the ignore label."""
    ours, ref = DATASET_REGISTRY[name], J_REGISTRY[name]
    assert ours.NUM_CLASSES == ref.NUM_CLASSES
    assert tuple(ours.MEAN) == tuple(ref.MEAN)
    assert tuple(ours.STD) == tuple(ref.STD)
    assert t_pal.PALETTES[name] == j_pal.PALETTES[name]
    mask = np.random.default_rng(0).integers(0, ours.NUM_CLASSES, (9, 7))
    mask[0, 0] = 255
    np.testing.assert_array_equal(
        t_pal.colorize_mask(mask, t_pal.PALETTES[name]),
        j_pal.colorize_mask(mask, j_pal.PALETTES[name]))


def test_model_config_matches_jax():
    for mode, cfg in MODEL_CONFIG.items():
        for key, value in cfg.items():
            assert J_MODEL_CONFIG[mode][key] == value, (mode, key)
