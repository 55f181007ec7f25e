"""One-time dataset converters to the shared images/ + masks/ layout
(counterpart of `cabinet_tpu.data.converters`, with the same files, names,
messages and counts).

- UAVid: RGB colour-coded Labels/ -> single-channel class-ID masks through a
  (256, 256, 256) LUT (unknown colours -> 255), sequence discovery
  (<split>/<seq>/{Images,Labels}), images symlinked (or copied) as
  {seq}_{stem}.png, a process pool over the masks, --dry-run.
- AeroScapes: split membership from ImageSets/{trn,val}.txt, masks already
  class IDs (validated to {0..11, 255}), files copied, no test split.
- VDD: stems common to <split>/src/*.JPG and <split>/gt/*.png, masks
  validated to {0..6, 255}, symlinks with the .JPG -> .jpg rename.

PNG is read and written by `data.decode`, so no conversion needs PIL; JPEG
images are only copied or linked, never decoded. The pool's workers are
spawned (never forked from the caller).
"""

from __future__ import annotations

import multiprocessing
import shutil
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

from cabinet_tpu_torch.core.constants import DEFAULT_IGNORE_LABEL
from cabinet_tpu_torch.data import decode

IGNORE_LABEL = DEFAULT_IGNORE_LABEL


# ---------------------------------------------------------------------------
# RGB -> class-ID LUT (UAVid)
# ---------------------------------------------------------------------------


def build_colour_map(classes: Sequence[dict]) -> Dict[Tuple[int, int, int], int]:
    """RGB -> class ID; ignoreInEval colours map to IGNORE_LABEL, the rest get
    consecutive IDs ordered by trainId."""
    colour_map: Dict[Tuple[int, int, int], int] = {}
    kept = sorted((c for c in classes if not c["ignoreInEval"]),
                  key=lambda c: c["trainId"])
    for new_id, cls in enumerate(kept):
        colour_map[tuple(cls["color"])] = new_id
    for cls in classes:
        if cls["ignoreInEval"]:
            colour_map[tuple(cls["color"])] = IGNORE_LABEL
    return colour_map


def build_rgb_lut(colour_map: Dict[Tuple[int, int, int], int]) -> np.ndarray:
    """(256,256,256) uint8 LUT; unknown colours -> IGNORE_LABEL."""
    lut = np.full((256, 256, 256), IGNORE_LABEL, dtype=np.uint8)
    for (r, g, b), cid in colour_map.items():
        lut[r, g, b] = cid
    return lut


def lut_remap_rgb(rgb: np.ndarray, lut: np.ndarray) -> np.ndarray:
    """RGB uint8 (..., 3) -> class IDs through a (256,256,256) uint8 LUT: the
    gather at (R << 16) | (G << 8) | B of the flat LUT."""
    rgb = np.asarray(rgb, np.uint8)
    lut = np.ascontiguousarray(lut, np.uint8)
    if lut.shape != (256, 256, 256) or rgb.shape[-1] != 3:
        raise ValueError(f"lut_remap_rgb takes (..., 3) and (256, 256, 256) uint8, "
                         f"got {rgb.shape} and {lut.shape}")
    flat = ((rgb[..., 0].astype(np.int32) << 16) | (rgb[..., 1].astype(np.int32) << 8)
            | rgb[..., 2])
    return lut.reshape(-1)[flat]


def convert_rgb_mask(src: Path, dst: Path, lut: np.ndarray,
                     dry_run: bool = False) -> str:
    ids = lut_remap_rgb(decode.open_rgb(src), lut)
    if not dry_run:
        dst.parent.mkdir(parents=True, exist_ok=True)
        decode.save_png(dst, ids)
    return src.name


def _rgb_worker(args: Tuple[Path, Path, np.ndarray, bool]) -> str:
    return convert_rgb_mask(*args)


def validate_id_mask(path: Path, num_classes: int) -> Tuple[bool, str]:
    """Every stored value must be a valid class ID or IGNORE_LABEL: a
    paletted mask's indices, each channel of a colour one (as
    `np.asarray(PIL.Image.open(path))` reads them)."""
    vals = np.unique(decode.open_array(path))
    bad = [int(v) for v in vals if v >= num_classes and v != IGNORE_LABEL]
    if bad:
        return False, f"{path.name}: invalid pixel values {bad}"
    return True, ""


def _place(src: Path, dst: Path, copy: bool, dry_run: bool) -> None:
    if dry_run:
        return
    dst.parent.mkdir(parents=True, exist_ok=True)
    if dst.exists() or dst.is_symlink():
        dst.unlink()
    if copy:
        shutil.copy2(src, dst)
    else:
        dst.symlink_to(src.resolve())


# ---------------------------------------------------------------------------
# UAVid
# ---------------------------------------------------------------------------


def discover_uavid_sequences(split_root: Path) -> List[str]:
    return sorted(d.name for d in split_root.iterdir()
                  if d.is_dir() and (d / "Images").exists())


def convert_uavid(src: Path, dst: Path, classes: Sequence[dict],
                  workers: int = 4, copy_images: bool = False,
                  dry_run: bool = False,
                  splits: Iterable[str] = ("train", "val", "test")) -> int:
    """Convert raw UAVid (<src>/<split>/<seq>/{Images,Labels}) to
    <dst>/{images,masks}/<split>/{seq}_{stem}.png. Returns masks written."""
    lut = build_rgb_lut(build_colour_map(classes))
    total = 0
    for split in splits:
        split_root = src / split
        if not split_root.exists():
            print(f"[WARN] Missing split directory, skipping: {split_root}")
            continue
        seqs = discover_uavid_sequences(split_root)
        if not seqs:
            print(f"[WARN] No sequences under {split_root}, skipping.")
            continue

        jobs = []
        for seq in seqs:
            for img in sorted((split_root / seq / "Images").glob("*.png")):
                label = split_root / seq / "Labels" / img.name
                if not label.exists():
                    print(f"[WARN] No Labels/ mask for {seq}/{img.name} — skipping")
                    continue
                mask_dst = dst / "masks" / split / f"{seq}_{img.stem}.png"
                img_dst = dst / "images" / split / f"{seq}_{img.stem}.png"
                _place(img, img_dst, copy_images, dry_run)
                jobs.append((label, mask_dst, lut, dry_run))

        if workers > 1 and not dry_run:
            spawn = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=workers, mp_context=spawn) as pool:
                list(pool.map(_rgb_worker, jobs))
        else:
            for job in jobs:
                _rgb_worker(job)
        total += len(jobs)
        print(f"[INFO] {split}: {'would convert' if dry_run else 'converted'} "
              f"{len(jobs)} masks")
    return total


# ---------------------------------------------------------------------------
# AeroScapes
# ---------------------------------------------------------------------------

AEROSCAPES_SPLIT_FILES = {"train": "trn.txt", "val": "val.txt"}


def convert_aeroscapes(src: Path, dst: Path, num_classes: int = 12,
                       workers: int = 4, dry_run: bool = False) -> int:
    """Copy JPEGImages/SegmentationClass pairs into images/+masks/ by the
    ImageSets split lists; masks validated as class IDs. No test split.
    `workers` is accepted as the JAX package's signature has it; the copies
    run in this process."""
    total = 0
    for split, list_name in AEROSCAPES_SPLIT_FILES.items():
        list_path = src / "ImageSets" / list_name
        if not list_path.exists():
            print(f"[WARN] Missing split list, skipping: {list_path}")
            continue
        stems = sorted(s.strip() for s in list_path.read_text().splitlines()
                       if s.strip())
        n = 0
        for stem in stems:
            img = src / "JPEGImages" / f"{stem}.jpg"
            mask = src / "SegmentationClass" / f"{stem}.png"
            if not img.exists() or not mask.exists():
                print(f"[WARN] Missing pair for stem '{stem}' — skipping")
                continue
            ok, msg = validate_id_mask(mask, num_classes)
            if not ok:
                print(f"[WARN] {msg} — skipping")
                continue
            _place(img, dst / "images" / split / f"{stem}.jpg", copy=True,
                   dry_run=dry_run)
            _place(mask, dst / "masks" / split / f"{stem}.png", copy=True,
                   dry_run=dry_run)
            n += 1
        total += n
        print(f"[INFO] {split}: {'would copy' if dry_run else 'copied'} {n} pairs")
    return total


# ---------------------------------------------------------------------------
# VDD
# ---------------------------------------------------------------------------


def discover_vdd_stems(split_dir: Path) -> List[str]:
    src_dir, gt_dir = split_dir / "src", split_dir / "gt"
    if not src_dir.exists() or not gt_dir.exists():
        return []
    imgs = {p.stem: p for p in src_dir.iterdir() if p.suffix.lower() == ".jpg"}
    gts = {p.stem for p in gt_dir.iterdir() if p.suffix == ".png"}
    return sorted(set(imgs) & gts)


def convert_vdd(src: Path, dst: Path, num_classes: int = 7,
                dry_run: bool = False,
                splits: Iterable[str] = ("train", "val", "test")) -> int:
    """Symlink <split>/src/*.JPG (renamed .jpg) + <split>/gt/*.png into
    images/+masks/; masks validated as class IDs {0..6, 255}."""
    total = 0
    for split in splits:
        split_dir = src / split
        stems = discover_vdd_stems(split_dir)
        if not stems:
            print(f"[WARN] No pairs under {split_dir}, skipping.")
            continue
        n = 0
        for stem in stems:
            img = next(p for p in (split_dir / "src").iterdir()
                       if p.stem == stem and p.suffix.lower() == ".jpg")
            mask = split_dir / "gt" / f"{stem}.png"
            ok, msg = validate_id_mask(mask, num_classes)
            if not ok:
                print(f"[WARN] {msg} — skipping")
                continue
            _place(img, dst / "images" / split / f"{stem}.jpg", copy=False,
                   dry_run=dry_run)
            _place(mask, dst / "masks" / split / f"{stem}.png", copy=False,
                   dry_run=dry_run)
            n += 1
        total += n
        print(f"[INFO] {split}: {'would link' if dry_run else 'linked'} {n} pairs")
    return total
