"""Image and mask decoding for the port (counterpart of `cabinet_tpu.data.decode`),
with a PNG reader and writer of its own on `zlib` and numpy, so that reading
the datasets needs neither PIL nor OpenCV.

`open_rgb` returns what `PIL.Image.open(p).convert("RGB")` returns and
`open_mask` what `cabinet_tpu.data.decode.open_mask` returns, as uint8
arrays. PNG goes through `read_png`, whatever the decoder: every form the
datasets and their converters write (8-bit L, LA, RGB, RGBA and P; 1-, 2- and
4-bit grey and palette; 16-bit grey, grey+alpha, RGB and RGBA), all five row
filters, and Adam7 interlacing. The conversions follow PIL's:
  - 1-, 2- and 4-bit grey scale to 0..255 (x255, x85, x17);
  - 16-bit grey is PIL's "I;16" and clips to 255; 16-bit colour keeps the
    high byte;
  - a mask that is not 8-bit grey goes through PIL's `convert("L")`: a
    paletted or colour mask becomes the luminance of its colours,
    (19595 R + 38470 G + 7471 B + 2^15) >> 16, not its indices;
  - transparency (tRNS, alpha) is dropped.
A palette index past the palette's end, a bad CRC, a truncated stream or an
unknown form raise `DatasetError`; no pixel is guessed.

Other formats (the JPEG images of AeroScapes and VDD) go through the backend
`decoder` names, "pil" or "cv2", imported when first needed; where it cannot
be imported, `DatasetError` names it. There is no switch to another backend.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path
from typing import Optional, Union

import numpy as np
from numpy.lib.stride_tricks import as_strided

from cabinet_tpu_torch.core.exceptions import DatasetError

DECODERS = ("pil", "cv2")

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"

# colour type -> channels; the bit depths PNG allows for it
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))

PathLike = Union[str, Path]


def check_decoder(decoder: str) -> str:
    if decoder not in DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS}, got {decoder!r}")
    return decoder


# ---------------------------------------------------------------------------
# PNG reading
# ---------------------------------------------------------------------------


class PngImage:
    """A decoded PNG: `samples` (H, W, channels) uint8 or uint16 as stored
    (1-, 2- and 4-bit samples unscaled), its colour type, bit depth and
    palette ((N, 3) uint8, or None)."""

    def __init__(self, samples: np.ndarray, color_type: int, bit_depth: int,
                 palette: Optional[np.ndarray]):
        self.samples = samples
        self.color_type = color_type
        self.bit_depth = bit_depth
        self.palette = palette


def _chunks(data: bytes, path: PathLike):
    """(type, payload) of each chunk, CRC checked, up to IEND."""
    pos = len(PNG_SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise DatasetError(f"{path}: truncated PNG (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise DatasetError(f"{path}: truncated PNG chunk {ctype!r}")
        payload = data[pos + 8:end]
        crc, = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + payload) != crc:
            raise DatasetError(f"{path}: bad CRC in PNG chunk {ctype!r}")
        yield ctype, payload
        if ctype == b"IEND":
            return
        pos = end + 4


def _unfilter_simple(filt: np.ndarray, ftype: np.ndarray, prev: np.ndarray,
                     bpp: int) -> np.ndarray:
    """Rows whose filters are None, Sub or Up: Sub as a per-channel uint8
    cumulative sum along the row, Up as a uint8 cumulative sum down each run
    of Up rows from the row above the run."""
    h, rb = filt.shape
    out = filt.copy()
    sub = ftype == 1
    if sub.any():
        out[sub] = np.cumsum(filt[sub].reshape(-1, rb // bpp, bpp), axis=1,
                             dtype=np.uint8).reshape(-1, rb)
    y = 0
    while y < h:
        if ftype[y] != 2:
            y += 1
            continue
        y1 = y
        while y1 < h and ftype[y1] == 2:
            y1 += 1
        above = out[y - 1] if y else prev
        out[y:y1] = np.cumsum(filt[y:y1], axis=0, dtype=np.uint8) + above
        y = y1
    return out


def _skewed(arr: np.ndarray, n: int, m: int, k0: int, i0: int) -> np.ndarray:
    """The (n, m, bpp) view V[i, x] = arr[x + i + k0, i + i0] of a
    (K, rows, bpp) array: rows of an image held along anti-diagonals."""
    s0, s1, s2 = arr.strides
    return as_strided(arr[k0, i0:], shape=(n, m, arr.shape[2]),
                      strides=(s0 + s1, s0, s2), writeable=True)


def _unfilter_wavefront(filt: np.ndarray, ftype: np.ndarray, prev: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Rows with any of the five filters. Average and Paeth read the pixel to
    the left, so the rows are swept along anti-diagonals: step d reconstructs
    pixel x = d - i of every row i at once, whose left, upper and upper-left
    neighbours steps d - 1 and d - 2 made. The image is held skewed,
    T[x' + i', i'] = R[i', x'] with R padded by the row above and a zero
    column, so that each step reads and writes contiguous slices; every
    filter's predictor is computed and the row's own one kept by a 0/1
    weight (np.choose and boolean indexing cost more a step)."""
    n, rb = filt.shape
    m = rb // bpp
    Fs = np.zeros((m + n - 1, n, bpp), np.int16)
    _skewed(Fs, n, m, 0, 0)[...] = filt.reshape(n, m, bpp)
    T = np.zeros((m + n + 1, n + 1, bpp), np.int16)
    T[1:m + 1, 0] = prev.reshape(m, bpp)
    is_sub, is_up, is_avg, is_paeth = (
        np.repeat((ftype == k)[:, None], bpp, 1).astype(np.int16) for k in (1, 2, 3, 4))
    for d in range(m + n - 1):
        lo, hi = max(0, d - m + 1), min(n - 1, d) + 1
        a = T[d + 1, lo + 1:hi + 1]
        b = T[d + 1, lo:hi]
        c = T[d, lo:hi]
        bc, ac = b - c, a - c
        pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        out = T[d + 2, lo + 1:hi + 1]
        out[...] = Fs[d, lo:hi]
        out += a * is_sub[lo:hi]
        out += b * is_up[lo:hi]
        out += ((a + b) >> 1) * is_avg[lo:hi]
        out += paeth * is_paeth[lo:hi]
        out &= 255
    return _skewed(T, n, m, 2, 1).astype(np.uint8).reshape(n, rb)


def _unfilter(data: memoryview, h: int, row_bytes: int, bpp: int,
              path: PathLike) -> np.ndarray:
    """(h, row_bytes) uint8 scanlines of one (pass of an) image."""
    need = h * (row_bytes + 1)
    if len(data) < need:
        raise DatasetError(f"{path}: truncated PNG image data")
    rows = np.frombuffer(data[:need], np.uint8).reshape(h, row_bytes + 1)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if (ftype > 4).any():
        raise DatasetError(f"{path}: unknown PNG filter type {int(ftype.max())}")
    serial = np.flatnonzero(ftype >= 3)
    prev = np.zeros(row_bytes, np.uint8)
    if serial.size == 0:
        return _unfilter_simple(filt, ftype, prev, bpp)
    y0 = int(serial[0])
    out = np.empty((h, row_bytes), np.uint8)
    out[:y0] = _unfilter_simple(filt[:y0], ftype[:y0], prev, bpp)
    out[y0:] = _unfilter_wavefront(filt[y0:], ftype[y0:],
                                   out[y0 - 1] if y0 else prev, bpp)
    return out


def _samples(rows: np.ndarray, w: int, channels: int, depth: int) -> np.ndarray:
    """(h, w, channels) samples of unfiltered scanlines."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, w, channels)
    if depth == 16:
        pairs = rows.reshape(h, w, channels, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    bits = np.unpackbits(rows, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def read_png(path: PathLike) -> PngImage:
    """Decode a PNG file into its samples (see `PngImage`)."""
    data = Path(path).read_bytes()
    if not data.startswith(PNG_SIGNATURE):
        raise DatasetError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for ctype, payload in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", payload[:13])
        elif ctype == b"PLTE":
            palette = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(payload)
    if header is None or not idat:
        raise DatasetError(f"{path}: PNG without IHDR or IDAT")
    w, h, depth, ctype, compression, filter_method, interlace = header
    if (ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or compression
            or filter_method or interlace not in (0, 1) or not w or not h):
        raise DatasetError(f"{path}: unsupported PNG form (colour type {ctype}, "
                           f"bit depth {depth}, compression {compression}, "
                           f"filter method {filter_method}, interlace {interlace})")
    if ctype == 3 and palette is None:
        raise DatasetError(f"{path}: paletted PNG without a PLTE chunk")
    try:
        raw = memoryview(zlib.decompress(b"".join(idat)))
    except zlib.error as e:
        raise DatasetError(f"{path}: corrupt PNG image data: {e}") from None
    channels = _CHANNELS[ctype]
    bpp = max(1, channels * depth // 8)

    def one(buf, pw, ph):
        row_bytes = (pw * channels * depth + 7) // 8
        rows = _unfilter(buf, ph, row_bytes, bpp, path)
        return _samples(rows, pw, channels, depth), ph * (row_bytes + 1)

    if interlace == 0:
        samples, _ = one(raw, w, h)
    else:
        samples = np.empty((h, w, channels), np.uint16 if depth == 16 else np.uint8)
        pos = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw <= 0 or ph <= 0:
                continue
            part, used = one(raw[pos:], pw, ph)
            samples[y0::dy, x0::dx] = part
            pos += used
    return PngImage(samples, ctype, depth, palette)


def _palette_colours(png: PngImage, path: PathLike) -> np.ndarray:
    idx = png.samples[..., 0]
    if int(idx.max()) >= len(png.palette):
        raise DatasetError(f"{path}: palette index {int(idx.max())} past the "
                           f"palette's {len(png.palette)} entries")
    return png.palette[idx]


def _grey_levels(png: PngImage) -> np.ndarray:
    """Grey samples as PIL's mode L (or "1", "I;16" clipped) values."""
    v = png.samples[..., 0]
    if png.bit_depth == 16:
        return np.minimum(v, 255).astype(np.uint8)
    return v * np.uint8(255 // ((1 << png.bit_depth) - 1))


def png_rgb(png: PngImage, path: PathLike = "") -> np.ndarray:
    """(H, W, 3) uint8: PIL's `convert("RGB")` of the PNG."""
    ct, s = png.color_type, png.samples
    if ct == 3:
        return _palette_colours(png, path)
    if ct in (0, 4):
        grey = _grey_levels(png) if ct == 0 else (s[..., 0] >> 8 if png.bit_depth == 16
                                                  else s[..., 0])
        return np.repeat(grey.astype(np.uint8)[..., None], 3, axis=2)
    rgb = s[..., :3]
    return (rgb >> 8).astype(np.uint8) if png.bit_depth == 16 else np.ascontiguousarray(rgb)


def luminance(rgb: np.ndarray) -> np.ndarray:
    """PIL's RGB -> L: (19595 R + 38470 G + 7471 B + 2^15) >> 16."""
    r, g, b = (rgb[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def png_mask(png: PngImage, path: PathLike = "") -> np.ndarray:
    """(H, W) uint8: the PNG as PIL's mode L, `convert("L")` where it is not."""
    if png.color_type == 0:
        return _grey_levels(png)
    if png.color_type == 4:
        return png_rgb(png, path)[..., 0]
    return luminance(png_rgb(png, path))


def _is_png(path: PathLike) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG_SIGNATURE


# ---------------------------------------------------------------------------
# Other formats through a named backend
# ---------------------------------------------------------------------------


def _import_backend(decoder: str):
    check_decoder(decoder)
    try:
        if decoder == "pil":
            from PIL import Image

            return Image
        import cv2

        return cv2
    except ImportError as e:
        raise DatasetError(
            f"decoder={decoder!r} needs the package "
            f"{'PIL (Pillow)' if decoder == 'pil' else 'cv2 (OpenCV)'}, which "
            f"cannot be imported here ({e}); PNG needs neither") from None


def _reduce_factor(longest: int, max_size: int) -> int:
    """The largest power-of-2 JPEG DCT reduction r that cannot land below
    `ResizeIfLarger(fast=True)`'s own output: that shrinks by k =
    ceil(longest / max_size), so any r <= k keeps the longer side at or
    above longest / k."""
    if max_size <= 0 or longest <= max_size:
        return 1
    k = -(-longest // max_size)
    for r in (8, 4, 2):
        if r <= k:
            return r
    return 1


def _backend_rgb(path: PathLike, decoder: str, reduce_to: int = 0) -> np.ndarray:
    """reduce_to > 0: a JPEG decodes at 1/r of its size in the DCT
    (`_reduce_factor`), through PIL's `draft` or cv2's IMREAD_REDUCED_COLOR_r,
    which give the same pixels; the size is read from the header by PIL."""
    lib = _import_backend(decoder)
    r = 1
    if reduce_to:
        Image = _import_backend("pil")
        with Image.open(path) as probe:
            if probe.format == "JPEG":
                r = _reduce_factor(max(probe.size), reduce_to)
    if decoder == "pil":
        with lib.open(path) as im:
            if r > 1:
                im.draft("RGB", (im.size[0] // r, im.size[1] // r))
            return np.asarray(im.convert("RGB"))
    flag = getattr(lib, f"IMREAD_REDUCED_COLOR_{r}") if r > 1 else lib.IMREAD_COLOR
    bgr = lib.imread(str(path), flag)
    if bgr is None or bgr.ndim != 3 or bgr.dtype != np.uint8:
        raise DatasetError(f"{path}: cv2 cannot decode this file")
    return lib.cvtColor(bgr, lib.COLOR_BGR2RGB)


def _backend_mask(path: PathLike, decoder: str) -> np.ndarray:
    if decoder == "cv2":
        cv2 = _import_backend("cv2")
        arr = cv2.imread(str(path), cv2.IMREAD_UNCHANGED)
        if arr is not None and arr.ndim == 2 and arr.dtype == np.uint8:
            return arr
    Image = _import_backend("pil")
    with Image.open(path) as label:
        return np.asarray(label if label.mode == "L" else label.convert("L"))


def open_rgb(path: PathLike, decoder: str = "pil", reduce_to: int = 0) -> np.ndarray:
    """(H, W, 3) uint8 RGB, as `Image.open(path).convert("RGB")` gives it.
    reduce_to > 0 (the device canvas only) decodes a JPEG reduced in the DCT
    towards a longer side of reduce_to, never below what
    `ResizeIfLarger(fast=True)` would give; other formats decode full size."""
    check_decoder(decoder)
    if _is_png(path):
        return png_rgb(read_png(path), path)
    return _backend_rgb(path, decoder, reduce_to)


def png_size(path: PathLike) -> tuple:
    """(width, height) of a PNG from its IHDR chunk, no pixel decoded."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != PNG_SIGNATURE or head[12:16] != b"IHDR":
        raise DatasetError(f"{path}: not a PNG")
    return struct.unpack(">II", head[16:24])


def open_mask(path: PathLike, decoder: str = "pil") -> np.ndarray:
    """(H, W) uint8 label mask, as `cabinet_tpu.data.decode.open_mask` gives
    it (mode L, through PIL's `convert("L")` where the file is not L)."""
    check_decoder(decoder)
    if _is_png(path):
        return png_mask(read_png(path), path)
    return _backend_mask(path, decoder)


# ---------------------------------------------------------------------------
# PNG writing
# ---------------------------------------------------------------------------


def _chunk(ctype: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + ctype + payload
            + struct.pack(">I", zlib.crc32(ctype + payload)))


def save_png(path: PathLike, array: np.ndarray, compress_level: int = 6) -> None:
    """Write an (H, W) L or (H, W, 3) RGB uint8 array as an 8-bit PNG, every
    row with filter 0 (None)."""
    a = np.asarray(array)
    if a.dtype != np.uint8 or not (a.ndim == 2 or (a.ndim == 3 and a.shape[2] == 3)):
        raise ValueError(f"save_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{a.shape} {a.dtype}")
    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + a[0].size), np.uint8)
    rows[:, 1:] = a.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    Path(path).write_bytes(
        PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), compress_level))
        + _chunk(b"IEND", b""))
