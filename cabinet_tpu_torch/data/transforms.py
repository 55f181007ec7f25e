"""Paired image/label augmentations of the train recipes (counterpart of
`cabinet_tpu.data.transforms`; reference src/datasets/transform.py:19-384).

The semantics are PIL's, as in the JAX package: images resample bilinear,
labels nearest; labels are filled with the ignore value where geometry
creates pixels (translate, rotate, crop padding); the photometric formulas
(Ultralytics HSV, PIL's enhancers, gamma, gaussian noise, cutout, PIL's
GaussianBlur) are the same. Every transform takes an explicit
`numpy.random.Generator` and draws from it in the JAX package's order, so
that equal seeds give equal samples.

PIL is imported here and nowhere else in the port: only train mode reads
this module (evaluation and inference need no PIL). A sample is
{"image": PIL RGB image, "label": PIL L image}.

`ResizeIfLarger(fast=True)` belongs to the device canvas
(runtime.device_geometric) and raises until that is ported (ROADMAP
Queue 1 item 3).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
from PIL import Image, ImageEnhance, ImageFilter

Sample = Dict[str, Any]


class Compose:
    def __init__(self, transforms: Sequence[Any]):
        self.transforms = list(transforms)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class ResizeIfLarger:
    """Cap the longer side at `max_size` (never upscale; reference
    transform.py:29-62)."""

    def __init__(self, max_size: int, fast: bool = False):
        if fast:
            raise NotImplementedError(
                "ResizeIfLarger(fast=True) belongs to the device canvas "
                "(runtime.device_geometric), not ported yet (ROADMAP Queue 1 item 3)")
        self.max_size = int(max_size)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        im, lb = sample["image"], sample["label"]
        w, h = im.size
        longest = max(w, h)
        if longest <= self.max_size:
            return sample
        s = self.max_size / longest
        new = (max(1, round(w * s)), max(1, round(h * s)))
        return {"image": im.resize(new, Image.BILINEAR),
                "label": lb.resize(new, Image.NEAREST)}


class RandomScale:
    """Resize by a factor drawn from a discrete list, or uniformly from
    (lo, hi) with continuous=True."""

    def __init__(self, scales: Sequence[float] = (1.0,), continuous: bool = False):
        self.continuous = continuous
        self.scales = tuple(float(s) for s in scales)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if self.continuous:
            lo, hi = self.scales
            s = float(rng.uniform(lo, hi))
        else:
            s = self.scales[int(rng.integers(len(self.scales)))]
        im, lb = sample["image"], sample["label"]
        W, H = im.size
        new = (int(round(W * s)), int(round(H * s)))
        return {"image": im.resize(new, Image.BILINEAR),
                "label": lb.resize(new, Image.NEAREST)}


class RandomHorizontalFlip:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if rng.random() >= self.p:
            return sample
        return {"image": sample["image"].transpose(Image.FLIP_LEFT_RIGHT),
                "label": sample["label"].transpose(Image.FLIP_LEFT_RIGHT)}


class RandomVerticalFlip:
    """flipud, for top-down aerial imagery."""

    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if rng.random() >= self.p:
            return sample
        return {"image": sample["image"].transpose(Image.FLIP_TOP_BOTTOM),
                "label": sample["label"].transpose(Image.FLIP_TOP_BOTTOM)}


class RandomTranslate:
    """Shift by up to +-translate of each side; label fill = ignore."""

    def __init__(self, translate: float = 0.05, ignore_label: int = 255):
        self.translate = translate
        self.ignore_label = ignore_label

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        im, lb = sample["image"], sample["label"]
        w, h = im.size
        dx = float(rng.uniform(-self.translate, self.translate)) * w
        dy = float(rng.uniform(-self.translate, self.translate)) * h
        matrix = (1, 0, dx, 0, 1, dy)
        return {
            "image": im.transform(im.size, Image.AFFINE, matrix,
                                  resample=Image.BILINEAR),
            "label": lb.transform(lb.size, Image.AFFINE, matrix,
                                  resample=Image.NEAREST,
                                  fillcolor=self.ignore_label),
        }


class RandomCrop:
    """Random fixed-size window. A smaller input is reflect-padded (image)
    and ignore-padded (label) at the bottom right, then, if still small,
    upscaled (reference transform.py:161-210)."""

    def __init__(self, size: Sequence[int], pad_if_needed: bool = True,
                 ignore_label: int = 255):
        self.size = tuple(size) if hasattr(size, "__iter__") else (size, size)
        self.pad_if_needed = pad_if_needed
        self.ignore_label = ignore_label

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        im, lb = sample["image"], sample["label"]
        tw, th = self.size
        w, h = im.size

        if self.pad_if_needed and (w < tw or h < th):
            pw, ph = max(tw - w, 0), max(th - h, 0)
            im_np = np.asarray(im)
            pad = ((0, ph), (0, pw), (0, 0)) if im_np.ndim == 3 else ((0, ph), (0, pw))
            im = Image.fromarray(np.pad(im_np, pad, mode="reflect"))
            lb_np = np.pad(np.asarray(lb), ((0, ph), (0, pw)),
                           constant_values=self.ignore_label).astype(np.uint8)
            lb = Image.fromarray(lb_np)
            w, h = im.size

        if w < tw or h < th:
            s = max(tw / w, th / h)
            new = (int(w * s + 1), int(h * s + 1))
            im = im.resize(new, Image.BILINEAR)
            lb = lb.resize(new, Image.NEAREST)
            w, h = im.size

        sw = int(rng.integers(0, w - tw + 1)) if w > tw else 0
        sh = int(rng.integers(0, h - th + 1)) if h > th else 0
        box = (sw, sh, sw + tw, sh + th)
        return {"image": im.crop(box), "label": lb.crop(box)}


class RandomHSV:
    """Ultralytics HSV jitter on PIL's 0-255 hue circle (reference
    transform.py:213-251): additive wrapping hue, multiplicative clipped
    saturation and value, gains ~ uniform(-1, 1) * g."""

    def __init__(self, hgain: float = 0.015, sgain: float = 0.4, vgain: float = 0.3):
        self.hgain, self.sgain, self.vgain = hgain, sgain, vgain

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if not (self.hgain or self.sgain or self.vgain):
            return sample
        hsv = np.asarray(sample["image"].convert("HSV"), dtype=np.int16).copy()
        r_h = float(rng.uniform(-1, 1)) * self.hgain
        r_s = float(rng.uniform(-1, 1)) * self.sgain
        r_v = float(rng.uniform(-1, 1)) * self.vgain
        hsv[..., 0] = (hsv[..., 0] + round(r_h * 255)) % 255
        hsv[..., 1] = np.clip(hsv[..., 1] * (r_s + 1), 0, 255)
        hsv[..., 2] = np.clip(hsv[..., 2] * (r_v + 1), 0, 255)
        hsv = hsv.astype(np.uint8)
        im = Image.merge("HSV", [Image.fromarray(hsv[..., c]) for c in range(3)])
        return {"image": im.convert("RGB"), "label": sample["label"]}


class RandomColorJitter:
    def __init__(self, brightness: Optional[float] = None,
                 contrast: Optional[float] = None,
                 saturation: Optional[float] = None):
        def rng_of(v):
            return None if v is None else (max(1 - v, 0.0), 1 + v)

        self.brightness = rng_of(brightness)
        self.contrast = rng_of(contrast)
        self.saturation = rng_of(saturation)

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        im = sample["image"]
        if self.brightness:
            im = ImageEnhance.Brightness(im).enhance(float(rng.uniform(*self.brightness)))
        if self.contrast:
            im = ImageEnhance.Contrast(im).enhance(float(rng.uniform(*self.contrast)))
        if self.saturation:
            im = ImageEnhance.Color(im).enhance(float(rng.uniform(*self.saturation)))
        return {"image": im, "label": sample["label"]}


class RandomCutout:
    """Zero a random `size` x `size` square of the image (label untouched)."""

    def __init__(self, p: float = 0.5, size: int = 64):
        self.p, self.size = p, size

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if rng.random() >= self.p:
            return sample
        im = np.asarray(sample["image"]).copy()
        h, w = im.shape[:2]
        if h <= self.size or w <= self.size:
            return sample
        y = int(rng.integers(0, h - self.size + 1))
        x = int(rng.integers(0, w - self.size + 1))
        im[y:y + self.size, x:x + self.size] = 0
        return {"image": Image.fromarray(im), "label": sample["label"]}


class RandomGaussianBlur:
    def __init__(self, p: float = 0.5, radius: Tuple[float, float] = (0.1, 2.0)):
        self.p, self.radius = p, radius

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if rng.random() >= self.p:
            return sample
        r = float(rng.uniform(*self.radius))
        return {"image": sample["image"].filter(ImageFilter.GaussianBlur(radius=r)),
                "label": sample["label"]}


class RandomGrayscale:
    def __init__(self, p: float = 0.5):
        self.p = p

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if rng.random() >= self.p:
            return sample
        return {"image": sample["image"].convert("L").convert("RGB"),
                "label": sample["label"]}


class RandomGamma:
    def __init__(self, gamma_range: Tuple[float, float] = (0.7, 1.5), p: float = 0.5):
        self.gamma_range, self.p = gamma_range, p

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if rng.random() >= self.p:
            return sample
        gamma = float(rng.uniform(*self.gamma_range))
        arr = np.asarray(sample["image"], dtype=np.float32) / 255.0
        arr = np.clip(arr ** gamma, 0, 1)
        return {"image": Image.fromarray((arr * 255).astype(np.uint8)),
                "label": sample["label"]}


class RandomNoise:
    def __init__(self, mode: str = "gaussian", sigma: float = 0.05, p: float = 0.5):
        self.mode, self.sigma, self.p = mode, sigma, p

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        if rng.random() >= self.p:
            return sample
        arr = np.asarray(sample["image"], dtype=np.float32)
        if self.mode == "gaussian":
            arr = arr + rng.normal(0, self.sigma * 255, arr.shape)
        elif self.mode == "poisson":
            vals = 2 ** np.ceil(np.log2(len(np.unique(arr))))
            arr = rng.poisson(arr * vals) / float(vals)
        arr = np.clip(arr, 0, 255).astype(np.uint8)
        return {"image": Image.fromarray(arr), "label": sample["label"]}


class RandomRotate:
    """Small rotation (expand=True), UAV yaw; label fill = ignore."""

    def __init__(self, degrees: Tuple[float, float] = (-15, 15),
                 ignore_label: int = 255):
        self.degrees = degrees
        self.ignore_label = ignore_label

    def __call__(self, sample: Sample, rng: np.random.Generator) -> Sample:
        angle = float(rng.uniform(*self.degrees))
        return {
            "image": sample["image"].rotate(angle, resample=Image.BILINEAR,
                                            expand=True),
            "label": sample["label"].rotate(angle, resample=Image.NEAREST,
                                            expand=True,
                                            fillcolor=self.ignore_label),
        }
