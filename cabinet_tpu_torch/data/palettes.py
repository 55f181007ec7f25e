"""Per-dataset class tables and mask colouring (copy of
`cabinet_tpu.data.palettes`: the class records, `PALETTES`,
`load_labels_info`, `id_to_trainid_lut` and `colorize_mask`). numpy only."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Sequence, Union

import numpy as np


def _rec(name: str, id_: int, train_id: int, color, category: str,
         catid: int, ignore: bool = False, has_instances: bool = False) -> Dict:
    return {
        "hasInstances": has_instances,
        "category": category,
        "catid": catid,
        "name": name,
        "ignoreInEval": ignore,
        "id": id_,
        "color": list(color),
        "trainId": train_id,
    }


UAVID_CLASSES: List[Dict] = [
    _rec("Clutter", 0, 0, (0, 0, 0), "void", 0),
    _rec("Building", 1, 1, (128, 0, 0), "construction", 1),
    _rec("Road", 2, 2, (128, 64, 128), "flat", 2),
    _rec("Static Car", 3, 3, (192, 0, 192), "vehicle", 3),
    _rec("Tree", 4, 4, (0, 128, 0), "vegetation", 4),
    _rec("Vegetation", 5, 5, (128, 128, 0), "vegetation", 4),
    _rec("Human", 6, 6, (64, 64, 0), "person", 5),
    _rec("Moving Car", 7, 7, (64, 0, 128), "vehicle", 3),
]

AEROSCAPES_CLASSES: List[Dict] = [
    _rec("Background", 0, 0, (0, 0, 0), "void", 0),
    _rec("Person", 1, 1, (192, 128, 128), "human", 1),
    _rec("Bike", 2, 2, (0, 128, 0), "vehicle", 2),
    _rec("Car", 3, 3, (128, 128, 128), "vehicle", 2),
    _rec("Drone", 4, 4, (128, 0, 0), "vehicle", 2),
    _rec("Boat", 5, 5, (0, 0, 128), "vehicle", 2),
    _rec("Animal", 6, 6, (192, 0, 128), "animal", 3),
    _rec("Obstacle", 7, 7, (192, 0, 0), "void", 0),
    _rec("Construction", 8, 8, (192, 128, 0), "construction", 4),
    _rec("Vegetation", 9, 9, (0, 64, 0), "nature", 5),
    _rec("Road", 10, 10, (128, 128, 0), "flat", 6),
    _rec("Sky", 11, 11, (0, 128, 128), "nature", 5),
]

VDD_CLASSES: List[Dict] = [
    _rec("Other", 0, 0, (0, 0, 0), "void", 0),
    _rec("Wall", 1, 1, (128, 64, 0), "construction", 1),
    _rec("Road", 2, 2, (128, 64, 128), "flat", 2),
    _rec("Vegetation", 3, 3, (0, 128, 0), "vegetation", 3),
    _rec("Vehicle", 4, 4, (64, 0, 128), "vehicle", 4),
    _rec("Roof", 5, 5, (192, 0, 0), "construction", 1),
    _rec("Water", 6, 6, (0, 128, 192), "water", 5),
]

# Cityscapes: (name, id, trainId, color, category, catid, ignoreInEval, hasInstances)
_CS = [
    ("unlabeled", 0, 255, (0, 0, 0), "void", 0, True, False),
    ("ego vehicle", 1, 255, (0, 0, 0), "void", 0, True, False),
    ("rectification border", 2, 255, (0, 0, 0), "void", 0, True, False),
    ("out of roi", 3, 255, (0, 0, 0), "void", 0, True, False),
    ("static", 4, 255, (0, 0, 0), "void", 0, True, False),
    ("dynamic", 5, 255, (111, 74, 0), "void", 0, True, False),
    ("ground", 6, 255, (81, 0, 81), "void", 0, True, False),
    ("road", 7, 0, (128, 64, 128), "flat", 1, False, False),
    ("sidewalk", 8, 1, (244, 35, 232), "flat", 1, False, False),
    ("parking", 9, 255, (250, 170, 160), "flat", 1, True, False),
    ("rail track", 10, 255, (230, 150, 140), "flat", 1, True, False),
    ("building", 11, 2, (70, 70, 70), "construction", 2, False, False),
    ("wall", 12, 3, (102, 102, 156), "construction", 2, False, False),
    ("fence", 13, 4, (190, 153, 153), "construction", 2, False, False),
    ("guard rail", 14, 255, (180, 165, 180), "construction", 2, True, False),
    ("bridge", 15, 255, (150, 100, 100), "construction", 2, True, False),
    ("tunnel", 16, 255, (150, 120, 90), "construction", 2, True, False),
    ("pole", 17, 5, (153, 153, 153), "object", 3, False, False),
    ("polegroup", 18, 255, (153, 153, 153), "object", 3, True, False),
    ("traffic light", 19, 6, (250, 170, 30), "object", 3, False, False),
    ("traffic sign", 20, 7, (220, 220, 0), "object", 3, False, False),
    ("vegetation", 21, 8, (107, 142, 35), "nature", 4, False, False),
    ("terrain", 22, 9, (152, 251, 152), "nature", 4, False, False),
    ("sky", 23, 10, (70, 130, 180), "sky", 5, False, False),
    ("person", 24, 11, (220, 20, 60), "human", 6, False, True),
    ("rider", 25, 12, (255, 0, 0), "human", 6, False, True),
    ("car", 26, 13, (0, 0, 142), "vehicle", 7, False, True),
    ("truck", 27, 14, (0, 0, 70), "vehicle", 7, False, True),
    ("bus", 28, 15, (0, 60, 100), "vehicle", 7, False, True),
    ("caravan", 29, 255, (0, 0, 90), "vehicle", 7, True, True),
    ("trailer", 30, 255, (0, 0, 110), "vehicle", 7, True, True),
    ("train", 31, 16, (0, 80, 100), "vehicle", 7, False, True),
    ("motorcycle", 32, 17, (0, 0, 230), "vehicle", 7, False, True),
    ("bicycle", 33, 18, (119, 11, 32), "vehicle", 7, False, True),
    ("license plate", -1, -1, (0, 0, 142), "vehicle", 7, True, False),
]
CITYSCAPES_CLASSES: List[Dict] = [
    _rec(n, i, t, c, cat, cid, ign, inst) for n, i, t, c, cat, cid, ign, inst in _CS
]

PALETTES: Dict[str, List[Dict]] = {
    "uavid": UAVID_CLASSES,
    "aeroscapes": AEROSCAPES_CLASSES,
    "vdd": VDD_CLASSES,
    "cityscapes": CITYSCAPES_CLASSES,
}


def load_labels_info(path: Union[str, Path]) -> List[Dict]:
    with open(path) as f:
        return json.load(f)


def id_to_trainid_lut(classes: Sequence[Dict], ignore_label: int = 255) -> np.ndarray:
    """256-entry raw-id -> trainId LUT (reference cityscapes.py:53-61)."""
    lut = np.full(256, ignore_label, dtype=np.int64)
    for el in classes:
        if 0 <= el["id"] < 256:
            lut[el["id"]] = el["trainId"]
    return lut


def trainid_palette(classes: Sequence[Dict]) -> np.ndarray:
    """(256, 3) uint8 colour palette indexed by trainId (reference
    infer_yolo.py:86-97: trainId-ordered colours; unknown -> black)."""
    pal = np.zeros((256, 3), dtype=np.uint8)
    for el in classes:
        t = el["trainId"]
        if 0 <= t < 256 and not el["ignoreInEval"]:
            pal[t] = el["color"]
    return pal


def colorize_mask(mask: np.ndarray, classes: Sequence[Dict]) -> np.ndarray:
    """Class-ID mask (H,W) -> RGB (H,W,3)."""
    return trainid_palette(classes)[np.clip(mask, 0, 255)]
