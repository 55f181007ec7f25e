"""The folder datasets, val and test side (counterpart of
`cabinet_tpu.data.datasets`): UAVid, AeroScapes and VDD in the converted
images/{split} + masks/{split} layout, Cityscapes in leftImg8bit/gtFine, the
registry, and `DATASET_KWARGS_BUILDERS`.

A sample is (image float32 (H, W, 3) normalised as `(u8 / 255 - mean) / std`
with float32 mean and std, label int64 (H, W)) at native resolution, decoded
by `data.decode` (the port's PNG reader; JPEG through the named decoder).
Cityscapes remaps raw ids to trainIds through a 256-entry LUT, clipping
first. `DATASET_REGISTRY[name]` is the class, whose `NUM_CLASSES`, `MEAN` and
`STD` `cli.infer.Segmenter` reads.

`mode="train"` is not ported: the train transforms, mixup and the device
canvas come with training (ROADMAP Queue 1 item 2), and with them the
kwargs that only train mode reads (augmentation, seed, photometric,
geometric, reduced_decode, decode_cache).
"""

from __future__ import annotations

import os
import os.path as osp
import warnings
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from cabinet_tpu_torch.core.exceptions import DatasetError
from cabinet_tpu_torch.data import decode
from cabinet_tpu_torch.data.palettes import (
    CITYSCAPES_CLASSES,
    id_to_trainid_lut,
    load_labels_info,
)

Array = np.ndarray


def _check_mode(mode: str) -> None:
    if mode not in ("train", "val", "test"):
        raise ValueError(f"Mode '{mode}' not supported. "
                         "Choose 'train', 'val', or 'test'.")
    if mode == "train":
        raise NotImplementedError(
            "mode='train' is not ported yet: the train transforms, mixup and "
            "the device canvas come with training (ROADMAP Queue 1 item 2)")


class FolderSegDataset:
    """Base loader for the converted images/{split} + masks/{split} layout."""

    NAME = "base"
    NUM_CLASSES = 0
    MEAN: Tuple[float, float, float] = (0.5, 0.5, 0.5)
    STD: Tuple[float, float, float] = (0.25, 0.25, 0.25)
    IMG_EXT = ".png"
    SPLITS = ("train", "val", "test")
    UNIFORM_RESOLUTION = False  # True => val/test may batch >1

    def __init__(
        self,
        ignore_lb: int,
        rootpth: str,
        cropsize: Sequence[int],
        mode: str = "train",
        decoder: str = "pil",
    ) -> None:
        _check_mode(mode)
        if mode not in self.SPLITS:
            raise DatasetError(f"{self.NAME} has no '{mode}' split")
        if not osp.exists(rootpth):
            raise FileNotFoundError(f"Dataset root does not exist: {rootpth}")
        self.mode = mode
        self.ignore_lb = ignore_lb
        self.rootpth = rootpth
        self.cropsize = tuple(int(c) for c in cropsize)
        self.decoder = decode.check_decoder(decoder)
        self.samples = self._pairs(rootpth, mode)

    def _pairs(self, rootpth: str, mode: str) -> List[Tuple[str, str]]:
        img_dir = osp.join(rootpth, "images", mode)
        mask_dir = osp.join(rootpth, "masks", mode)
        for d in (img_dir, mask_dir):
            if not osp.exists(d):
                raise FileNotFoundError(f"Directory not found: {d}")
        samples, skipped = [], []
        for fn in sorted(os.listdir(img_dir)):
            if not fn.lower().endswith(self.IMG_EXT):
                continue
            stem = osp.splitext(fn)[0]
            mask_path = osp.join(mask_dir, stem + ".png")
            if not osp.exists(mask_path):
                skipped.append(stem)
                continue
            samples.append((osp.join(img_dir, fn), mask_path))
        if skipped:
            warnings.warn(
                f"{len(skipped)} image(s) have no matching mask in {mask_dir} "
                f"and will be skipped: {sorted(skipped)[:5]}...")
        if not samples:
            raise DatasetError(
                f"No valid image-mask pairs found for mode='{mode}' in {rootpth}.")
        return samples

    def _normalize(self, img: Array) -> Array:
        """uint8 (H, W, 3) -> ((x / 255) - mean) / std in float32, the
        expression `cabinet_tpu.native.normalize_u8_f32` is bit-equal to."""
        m = np.asarray(self.MEAN, np.float32)
        s = np.asarray(self.STD, np.float32)
        return (np.ascontiguousarray(img, np.uint8).astype(np.float32) / 255.0 - m) / s

    def _decode_label(self, label: Array) -> Array:
        return np.asarray(label, dtype=np.int64)

    def __getitem__(self, idx: int) -> Tuple[Array, Array]:
        img_path, mask_path = self.samples[idx]
        img = decode.open_rgb(img_path, self.decoder)
        label = decode.open_mask(mask_path, self.decoder)
        return self._normalize(img), self._decode_label(label)

    def __len__(self) -> int:
        return len(self.samples)


class UAVid(FolderSegDataset):
    """UAVid: 8 classes, mixed native resolutions (3840x2160 & 4096x2160) =>
    val/test batch must be 1 (reference uavid.py:105-110)."""

    NAME = "uavid"
    NUM_CLASSES = 8
    MEAN = (0.480, 0.499, 0.457)
    STD = (0.225, 0.208, 0.228)
    IMG_EXT = ".png"
    UNIFORM_RESOLUTION = False


class AeroScapes(FolderSegDataset):
    """AeroScapes: 12 classes, uniform 1280x720, .jpg images, NO test split."""

    NAME = "aeroscapes"
    NUM_CLASSES = 12
    MEAN = (0.439, 0.508, 0.460)
    STD = (0.176, 0.157, 0.194)
    IMG_EXT = ".jpg"
    SPLITS = ("train", "val")
    UNIFORM_RESOLUTION = True


class VDD(FolderSegDataset):
    """VDD: 7 classes, uniform 4000x3000, .jpg images, real train/val/test."""

    NAME = "vdd"
    NUM_CLASSES = 7
    MEAN = (0.486, 0.487, 0.441)
    STD = (0.190, 0.178, 0.214)
    IMG_EXT = ".jpg"
    UNIFORM_RESOLUTION = True


class CityScapes(FolderSegDataset):
    """Cityscapes: leftImg8bit/gtFine layout, raw-id -> trainId LUT remap,
    ImageNet normalization."""

    NAME = "cityscapes"
    NUM_CLASSES = 19
    MEAN = (0.485, 0.456, 0.406)
    STD = (0.229, 0.224, 0.225)
    UNIFORM_RESOLUTION = True  # all 2048x1024

    def __init__(
        self,
        ignore_lb: int,
        rootpth: str,
        cropsize: Sequence[int],
        mode: str = "train",
        config_file: Optional[str] = None,
        decoder: str = "pil",
    ) -> None:
        _check_mode(mode)
        if not osp.exists(rootpth):
            raise FileNotFoundError(f"Dataset root does not exist: {rootpth}")
        self.mode = mode
        self.ignore_lb = ignore_lb
        self.rootpth = rootpth
        self.cropsize = tuple(int(c) for c in cropsize)
        self.decoder = decode.check_decoder(decoder)
        classes = (load_labels_info(config_file) if config_file
                   else CITYSCAPES_CLASSES)
        self._lut = id_to_trainid_lut(classes, ignore_lb)
        self.samples = self._pairs(rootpth, mode)

    def _pairs(self, rootpth: str, mode: str) -> List[Tuple[str, str]]:
        impth = osp.join(rootpth, "leftImg8bit", mode)
        gtpth = osp.join(rootpth, "gtFine", mode)
        for d in (impth, gtpth):
            if not osp.exists(d):
                raise FileNotFoundError(f"Directory not found: {d}")
        samples = []
        for city in sorted(os.listdir(impth)):
            im_folder = osp.join(impth, city)
            gt_folder = osp.join(gtpth, city)
            for im_name in sorted(os.listdir(im_folder)):
                if not im_name.endswith("_leftImg8bit.png"):
                    continue
                base = im_name[: -len("_leftImg8bit.png")]
                lb_path = osp.join(gt_folder, f"{base}_gtFine_labelIds.png")
                if not osp.exists(lb_path):
                    warnings.warn(f"Missing label for {base}, skipping.")
                    continue
                samples.append((osp.join(im_folder, im_name), lb_path))
        if not samples:
            raise DatasetError(f"No valid image-label pairs found in {mode} set.")
        return samples

    def _decode_label(self, label: Array) -> Array:
        raw = np.asarray(label, dtype=np.int64)
        return self._lut[np.clip(raw, 0, 255)]


# ---------------------------------------------------------------------------
# Registry (reference src/datasets/registry.py:13-50)
# ---------------------------------------------------------------------------

DATASET_REGISTRY: Dict[str, type] = {
    "cityscapes": CityScapes,
    "uavid": UAVid,
    "aeroscapes": AeroScapes,
    "vdd": VDD,
}


def _aerial_kwargs(cfg: Any, mode: str) -> Dict[str, Any]:
    d = cfg.dataset
    return {"ignore_lb": d.ignore_idx, "rootpth": d.dataset_path,
            "cropsize": list(d.cropsize), "mode": mode,
            "decoder": str(cfg.select("runtime.decoder", "pil"))}


def _cityscapes_kwargs(cfg: Any, mode: str) -> Dict[str, Any]:
    return {**_aerial_kwargs(cfg, mode), "config_file": cfg.dataset.get("config_file")}


DATASET_KWARGS_BUILDERS = {
    "cityscapes": _cityscapes_kwargs,
    "uavid": _aerial_kwargs,
    "aeroscapes": _aerial_kwargs,
    "vdd": _aerial_kwargs,
}
