"""Synthetic frames and labels made from a seed, and the PNG writer that
lays out a Cityscapes-style split for the port's dataset to read.

Frames are smooth colour fields with fine noise, made on the device from
one `torch.Generator` and copied to host memory once; labels are blocks of
classes. The writer is the benchmark's own (zlib, filter 0, no ancillary
chunks), so that the files the program decodes were not encoded by it.
"""

from __future__ import annotations

import concurrent.futures
import os
import struct
import zlib
from pathlib import Path
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from port_bench.weights import torch_seed

# Cityscapes' raw label ids of the 19 train classes, in trainId order, and
# the raw id of an unlabeled pixel (cityscapesScripts' labels.py).
CITY_RAW_IDS = (7, 8, 11, 12, 13, 17, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 31, 32, 33)
CITY_UNLABELED = 0


def city_trainids(raw: np.ndarray, ignore: int = 255) -> np.ndarray:
    """Raw label ids -> trainIds (others -> ignore), uint8."""
    lut = np.full(256, ignore, np.uint8)
    lut[list(CITY_RAW_IDS)] = np.arange(len(CITY_RAW_IDS), dtype=np.uint8)
    return lut[raw]


def smooth_frames(seed: int, n: int, h: int, w: int, device, cell: int = 32
                  ) -> np.ndarray:
    """(n, h, w, 3) uint8: a bilinear field of random colours on a
    `cell`-pixel grid plus fine noise."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed))
    coarse = torch.rand((n, 3, -(-h // cell) + 1, -(-w // cell) + 1), generator=gen,
                        device=device)
    field = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)
    fine = torch.randn((n, 3, h, w), generator=gen, device=device) * 0.04
    u8 = ((field + fine).clamp(0.0, 1.0) * 255.0).round().to(torch.uint8)
    return u8.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def block_labels(seed: int, n: int, h: int, w: int, n_classes: int, device,
                 block: int = 64) -> np.ndarray:
    """(n, h, w) uint8 class indices, constant on `block`-pixel squares."""
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed) ^ 0x5EED)
    coarse = torch.randint(0, n_classes, (n, 1, -(-h // block), -(-w // block)),
                           generator=gen, device=device, dtype=torch.int32)
    full = F.interpolate(coarse.float(), scale_factor=block, mode="nearest")
    return full[:, 0, :h, :w].to(torch.uint8).cpu().numpy()


def city_raw_labels(classes: np.ndarray) -> np.ndarray:
    """Class indices (n, h, w) -> Cityscapes raw ids, the top sixteenth of
    the rows unlabeled (64 of 1024, as the ego car's hood is in the
    real frames, at the bottom)."""
    raw = np.asarray(CITY_RAW_IDS, np.uint8)[classes]
    raw[:, :classes.shape[1] // 16] = CITY_UNLABELED
    return raw


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(a: np.ndarray) -> bytes:
    """An 8-bit grey (h, w) or RGB (h, w, 3) PNG of `a`, every row filter 0."""
    a = np.ascontiguousarray(a, np.uint8)
    h, w = a.shape[:2]
    colour = 2 if a.ndim == 3 else 0
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], axis=1)
    return (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour, 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_city_split(root: Path, images: np.ndarray, raw_labels: np.ndarray,
                     split: str = "train") -> None:
    """leftImg8bit/<split>/aachen/*_leftImg8bit.png and
    gtFine/<split>/aachen/*_gtFine_labelIds.png, one frame a thread, named
    so that the dataset's sorted order is the frames' order."""
    city = "aachen"
    (root / "leftImg8bit" / split / city).mkdir(parents=True, exist_ok=True)
    (root / "gtFine" / split / city).mkdir(parents=True, exist_ok=True)

    def one(i: int) -> None:
        base = f"{city}_{i:06d}_000019"
        (root / "leftImg8bit" / split / city / f"{base}_leftImg8bit.png").write_bytes(
            png_bytes(images[i]))
        (root / "gtFine" / split / city / f"{base}_gtFine_labelIds.png").write_bytes(
            png_bytes(raw_labels[i]))

    with concurrent.futures.ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        list(pool.map(one, range(len(images))))


def normalised(u8: np.ndarray, mean: Tuple[float, ...], std: Tuple[float, ...]
               ) -> np.ndarray:
    """(x / 255 - mean) / std in float32, as a val loader hands frames."""
    m = np.asarray(mean, np.float32)
    s = np.asarray(std, np.float32)
    return (u8.astype(np.float32) / np.float32(255.0) - m) / s
