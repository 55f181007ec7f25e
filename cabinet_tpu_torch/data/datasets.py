"""Per-dataset class counts and normalisation statistics (copy of the
`NUM_CLASSES`/`MEAN`/`STD` of the dataset classes in
`cabinet_tpu.data.datasets`). `Segmenter` reads this table."""

from typing import Dict, NamedTuple, Tuple


class DatasetStats(NamedTuple):
    NUM_CLASSES: int
    MEAN: Tuple[float, float, float]
    STD: Tuple[float, float, float]


DATASET_REGISTRY: Dict[str, DatasetStats] = {
    "cityscapes": DatasetStats(19, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)),
    "uavid": DatasetStats(8, (0.480, 0.499, 0.457), (0.225, 0.208, 0.228)),
    "aeroscapes": DatasetStats(12, (0.439, 0.508, 0.460), (0.176, 0.157, 0.194)),
    "vdd": DatasetStats(7, (0.486, 0.487, 0.441), (0.190, 0.178, 0.214)),
}
