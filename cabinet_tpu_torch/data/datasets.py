"""The folder datasets (counterpart of `cabinet_tpu.data.datasets`): UAVid,
AeroScapes and VDD in the converted images/{split} + masks/{split} layout,
Cityscapes in leftImg8bit/gtFine, the registry, and
`DATASET_KWARGS_BUILDERS`.

A sample is (image float32 (H, W, 3) normalised as `(u8 / 255 - mean) / std`
with float32 mean and std, label int64 (H, W)), decoded by `data.decode` (the
port's PNG reader; JPEG through the named decoder). Cityscapes remaps raw
ids to trainIds through a 256-entry LUT, clipping first.
`DATASET_REGISTRY[name]` is the class, whose `NUM_CLASSES`, `MEAN` and `STD`
`cli.infer.Segmenter` reads.

val/test samples are at native resolution, untransformed. Train mode
applies the host recipe of `data.transforms` (PIL, imported only then):
the aerial one (ResizeIfLarger -> flips -> translate -> rotate ->
continuous scale -> crop(pad) -> HSV -> contrast -> gamma -> noise ->
cutout, reference uavid.py:192-229) with MixUp (Beta(32, 32) blend, the
label of the larger share, uavid.py:253-271), or Cityscapes' street one
(flip -> discrete scale -> crop(pad) -> colour jitter -> grayscale ->
gamma -> noise -> cutout). Randomness comes from
`default_rng([seed, epoch, idx])`, so equal seeds and epochs give equal
samples, bit for bit those of the JAX package. The device pipeline
(`photometric="device"`, `geometric="device"`, `reduced_decode`,
`decode_cache`) raises: it waits for ROADMAP Queue 1 item 3.
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


# The aerial recipe's knobs (reference uavid.py:37-47).
DEFAULT_AUGMENTATION: Dict[str, float] = {
    "degrees": 10.0,
    "translate": 0.05,
    "scale": 0.3,
    "flipud": 0.2,
    "fliplr": 0.5,
    "hsv_h": 0.01,
    "hsv_s": 0.4,
    "hsv_v": 0.3,
    "mixup": 0.1,
}


def _check_mode(mode: str) -> None:
    if mode not in ("train", "val", "test"):
        raise ValueError(f"Mode '{mode}' not supported. "
                         "Choose 'train', 'val', or 'test'.")


def _check_pipeline(mode: str, ignore_lb: int, photometric: str, geometric: str,
                    reduced_decode: bool, decode_cache: Optional[str]) -> None:
    """The JAX package's checks of the pipeline knobs, then a raise for the
    device pipeline, which is not ported."""
    if photometric not in ("host", "device"):
        raise ValueError(f"photometric must be host|device, got {photometric}")
    if geometric not in ("host", "device"):
        raise ValueError(f"geometric must be host|device, got {geometric}")
    if geometric == "device" and mode == "train" and photometric != "device":
        raise ValueError("geometric='device' requires photometric='device' "
                         "(the device pipeline normalizes after cropping)")
    if geometric == "device" and not (0 <= ignore_lb <= 255):
        raise ValueError("geometric='device' ships labels as uint8; "
                         f"ignore_lb={ignore_lb} does not fit")
    if reduced_decode and mode == "train" and geometric != "device":
        raise ValueError(
            "reduced_decode requires geometric='device' "
            "(runtime.device_geometric): the exact-recipe host path "
            "keeps full-resolution reference decode semantics")
    if mode == "train":
        for name, on in (("photometric='device'", photometric == "device"),
                         ("geometric='device'", geometric == "device"),
                         ("reduced_decode", reduced_decode),
                         ("decode_cache", bool(decode_cache))):
            if on:
                raise NotImplementedError(
                    f"{name} belongs to the device augmentation pipeline, not "
                    f"ported yet (ROADMAP Queue 1 item 3); train with the host "
                    f"recipe (runtime.device_augs=false, "
                    f"runtime.device_geometric=false)")


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
        augmentation: Optional[Dict[str, Any]] = None,
        seed: int = 15,
        photometric: str = "host",
        geometric: str = "host",
        decoder: str = "pil",
        reduced_decode: bool = False,
        decode_cache: Optional[str] = None,
    ) -> None:
        _check_mode(mode)
        if mode not in self.SPLITS:
            raise DatasetError(f"{self.NAME} has no '{mode}' split")
        if not osp.exists(rootpth):
            raise FileNotFoundError(f"Dataset root does not exist: {rootpth}")
        _check_pipeline(mode, ignore_lb, photometric, geometric, reduced_decode,
                        decode_cache)
        self.mode = mode
        self.ignore_lb = ignore_lb
        self.rootpth = rootpth
        self.cropsize = tuple(int(c) for c in cropsize)
        self.aug = {**DEFAULT_AUGMENTATION, **(augmentation or {})}
        self.seed = seed
        self.epoch = 0
        self.decoder = decode.check_decoder(decoder)
        self.samples = self._pairs(rootpth, mode)
        self.trans_train = self._build_train_transforms() if mode == "train" else None
        self.mixup_p = float(self.aug["mixup"]) if mode == "train" else 0.0

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

    def _build_train_transforms(self):
        from cabinet_tpu_torch.data import transforms as T

        degrees = float(self.aug["degrees"])
        scale = float(self.aug["scale"])
        return T.Compose([
            T.ResizeIfLarger(max_size=2 * max(self.cropsize)),
            T.RandomHorizontalFlip(p=float(self.aug["fliplr"])),
            T.RandomVerticalFlip(p=float(self.aug["flipud"])),
            T.RandomTranslate(translate=float(self.aug["translate"]),
                              ignore_label=self.ignore_lb),
            T.RandomRotate(degrees=(-degrees, degrees), ignore_label=self.ignore_lb),
            T.RandomScale((1.0 - scale, 1.0 + scale), continuous=True),
            T.RandomCrop(size=self.cropsize, pad_if_needed=True,
                         ignore_label=self.ignore_lb),
            T.RandomHSV(hgain=float(self.aug["hsv_h"]), sgain=float(self.aug["hsv_s"]),
                        vgain=float(self.aug["hsv_v"])),
            T.RandomColorJitter(contrast=0.5),
            T.RandomGamma(gamma_range=(0.8, 1.2), p=0.3),
            T.RandomNoise(mode="gaussian", sigma=0.03, p=0.3),
            T.RandomCutout(p=0.3, size=64),
        ])

    def set_epoch(self, epoch: int) -> None:
        """Advance the deterministic augmentation stream."""
        self.epoch = int(epoch)

    def _rng_for(self, idx: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, self.epoch, idx])

    def _normalize(self, img: Array) -> Array:
        """uint8 (H, W, 3) -> ((x / 255) - mean) / std in float32, the
        expression `cabinet_tpu.native.normalize_u8_f32` is bit-equal to."""
        m = np.asarray(self.MEAN, np.float32)
        s = np.asarray(self.STD, np.float32)
        return (np.ascontiguousarray(img, np.uint8).astype(np.float32) / 255.0 - m) / s

    def _decode_label(self, label: Array) -> Array:
        return np.asarray(label, dtype=np.int64)

    def _load_one(self, idx: int, rng: np.random.Generator) -> Tuple[Array, Array]:
        img_path, mask_path = self.samples[idx]
        img = decode.open_rgb(img_path, self.decoder)
        label = decode.open_mask(mask_path, self.decoder)
        if self.trans_train is not None:
            from PIL import Image

            out = self.trans_train({"image": Image.fromarray(img),
                                    "label": Image.fromarray(label)}, rng)
            img, label = np.asarray(out["image"]), np.asarray(out["label"])
        return self._normalize(img), self._decode_label(label)

    def __getitem__(self, idx: int) -> Tuple[Array, Array]:
        rng = self._rng_for(idx)
        img, label = self._load_one(idx, rng)
        if self.mixup_p > 0 and rng.random() < self.mixup_p:
            other = int(rng.integers(0, len(self.samples)))
            img2, label2 = self._load_one(other, rng)
            r = float(rng.beta(32.0, 32.0))
            img = img * r + img2 * (1.0 - r)
            label = label if r >= 0.5 else label2
        return img, label

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
    ImageNet normalization, the street recipe in train mode (reference
    cityscapes.py:114-136), no mixup."""

    NAME = "cityscapes"
    NUM_CLASSES = 19
    MEAN = (0.485, 0.456, 0.406)
    STD = (0.229, 0.224, 0.225)
    UNIFORM_RESOLUTION = True  # all 2048x1024
    SCALE_CHOICES = (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)  # reference cityscapes.py:119

    def __init__(
        self,
        ignore_lb: int,
        rootpth: str,
        cropsize: Sequence[int],
        mode: str = "train",
        config_file: Optional[str] = None,
        seed: int = 15,
        photometric: str = "host",
        geometric: str = "host",
        decoder: str = "pil",
        reduced_decode: bool = False,
        decode_cache: Optional[str] = None,
    ) -> None:
        _check_mode(mode)
        if not osp.exists(rootpth):
            raise FileNotFoundError(f"Dataset root does not exist: {rootpth}")
        _check_pipeline(mode, ignore_lb, photometric, geometric, reduced_decode,
                        decode_cache)
        self.mode = mode
        self.ignore_lb = ignore_lb
        self.rootpth = rootpth
        self.cropsize = tuple(int(c) for c in cropsize)
        self.seed = seed
        self.epoch = 0
        self.mixup_p = 0.0
        self.decoder = decode.check_decoder(decoder)
        classes = (load_labels_info(config_file) if config_file
                   else CITYSCAPES_CLASSES)
        self._lut = id_to_trainid_lut(classes, ignore_lb)
        self.samples = self._pairs(rootpth, mode)
        self.trans_train = self._build_train_transforms() if mode == "train" else None

    def _build_train_transforms(self):
        from cabinet_tpu_torch.data import transforms as T

        return T.Compose([
            T.RandomHorizontalFlip(p=0.5),
            T.RandomScale(self.SCALE_CHOICES),
            T.RandomCrop(size=self.cropsize, pad_if_needed=True,
                         ignore_label=self.ignore_lb),
            T.RandomColorJitter(brightness=0.5, contrast=0.5, saturation=0.5),
            T.RandomGrayscale(p=0.2),
            T.RandomGamma(gamma_range=(0.8, 1.2), p=0.3),
            T.RandomNoise(mode="gaussian", sigma=0.03, p=0.3),
            T.RandomCutout(p=0.3, size=64),
        ])

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


def _pipeline_kwargs(cfg: Any, mode: str) -> Dict[str, Any]:
    """The train pipeline's knobs, as the JAX package reads them: device
    geometric implies device photometric, both only in train mode."""
    device_geom = bool(cfg.select("runtime.device_geometric", False))
    device_augs = device_geom or bool(cfg.select("runtime.device_augs", False))
    return {
        "seed": cfg.dataset.get("seed", 15),
        "geometric": "device" if (device_geom and mode == "train") else "host",
        "photometric": "device" if (device_augs and mode == "train") else "host",
        "decoder": str(cfg.select("runtime.decoder", "pil")),
        "reduced_decode": bool(cfg.select("runtime.reduced_decode", False))
        and mode == "train",
        "decode_cache": cfg.select("runtime.decode_cache", None) or None,
    }


def _aerial_kwargs(cfg: Any, mode: str) -> Dict[str, Any]:
    d = cfg.dataset
    aug = d.get("augmentation")
    return {"ignore_lb": d.ignore_idx, "rootpth": d.dataset_path,
            "cropsize": list(d.cropsize), "mode": mode,
            "augmentation": aug.to_dict() if aug is not None else None,
            **_pipeline_kwargs(cfg, mode)}


def _cityscapes_kwargs(cfg: Any, mode: str) -> Dict[str, Any]:
    d = cfg.dataset
    return {"ignore_lb": d.ignore_idx, "rootpth": d.dataset_path,
            "cropsize": list(d.cropsize), "mode": mode,
            "config_file": d.get("config_file"), **_pipeline_kwargs(cfg, mode)}


DATASET_KWARGS_BUILDERS = {
    "cityscapes": _cityscapes_kwargs,
    "uavid": _aerial_kwargs,
    "aeroscapes": _aerial_kwargs,
    "vdd": _aerial_kwargs,
}
