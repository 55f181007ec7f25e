"""The port's PNG reader (cabinet_tpu_torch.data.decode) against PIL and
against the JAX package's `open_rgb`/`open_mask`, value for value, on every
PNG form the datasets and their converters write: files from PIL, from cv2,
and from an encoder below that forces each of the five row filters, the
bit depths PIL does not write, and Adam7 interlacing."""

import struct
import zlib

import cv2
import numpy as np
import pytest
from PIL import Image

from cabinet_tpu.data import decode as jdecode
from cabinet_tpu_torch.core.exceptions import DatasetError
from cabinet_tpu_torch.data import decode

H, W = 37, 53  # odd sizes: partial bytes at 1-4 bits, every Adam7 pass short
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter_rows(rows, bpp, filters):
    """Forward-filter (h, row_bytes) uint8 scanlines; filters[y] is row y's
    type. Returns the bytes with one filter byte before each row."""
    r = rows.astype(np.int16)
    up = np.vstack([np.zeros((1, r.shape[1]), np.int16), r[:-1]])
    left = np.hstack([np.zeros((r.shape[0], bpp), np.int16), r[:, :-bpp]])
    upleft = np.hstack([np.zeros((r.shape[0], bpp), np.int16), up[:, :-bpp]])
    preds = [0 * r, left, up, (left + up) >> 1, _paeth(left, up, upleft)]
    out = np.empty((r.shape[0], r.shape[1] + 1), np.uint8)
    for y, t in enumerate(filters):
        out[y, 0] = t
        out[y, 1:] = (r[y] - preds[t][y]) & 255
    return out.tobytes()


def _pack(samples, depth):
    """(h, w, c) samples -> (h, row_bytes) scanlines at `depth` bits."""
    h, w, c = samples.shape
    if depth == 16:
        v = samples.astype(np.uint16)
        return np.stack([v >> 8, v & 255], -1).astype(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, -1)
    bits = ((samples[..., 0, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
    return np.packbits(bits.reshape(h, -1), axis=1)


def write_png(path, samples, color_type, depth, filters="cycle", interlace=0,
              palette=None, trns=None):
    """A PNG of `samples` (h, w, channels) with the given row filters:
    an int for every row, or "cycle" for 0, 1, 2, 3, 4, 0, ..."""
    h, w, c = samples.shape
    bpp = max(1, c * depth // 8)

    def scan(part, offset=0):
        n = part.shape[0]
        f = [(y + offset) % 5 for y in range(n)] if filters == "cycle" else [filters] * n
        return _filter_rows(_pack(part, depth), bpp, f)

    if interlace:
        raw = b"".join(scan(samples[y0::dy, x0::dx], k) for k, (x0, y0, dx, dy)
                       in enumerate(ADAM7) if samples[y0::dy, x0::dx].size)
    else:
        raw = scan(samples)

    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                                      interlace))
    if palette is not None:
        body += chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        body += chunk(b"tRNS", trns)
    body += chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")
    path.write_bytes(decode.PNG_SIGNATURE + body)
    return path


def _forms():
    """(name, color_type, depth, with palette) of every form the reader takes."""
    return ([("grey%d" % d, 0, d, False) for d in (1, 2, 4, 8, 16)]
            + [("rgb8", 2, 8, False), ("rgb16", 2, 16, False)]
            + [("pal%d" % d, 3, d, True) for d in (1, 2, 4, 8)]
            + [("la8", 4, 8, False), ("la16", 4, 16, False),
               ("rgba8", 6, 8, False), ("rgba16", 6, 16, False)])


def _samples(rng, color_type, depth, n_pal=None):
    c = CHANNELS[color_type]
    top = n_pal if color_type == 3 else (1 << depth)
    dtype = np.uint16 if depth == 16 else np.uint8
    return rng.integers(0, top, (H, W, c)).astype(dtype)


def assert_same_as_pil(path):
    """open_rgb equals PIL's convert("RGB"), open_mask the JAX open_mask."""
    with Image.open(path) as im:
        ref_rgb = np.asarray(im.convert("RGB"))
    ref_mask = np.asarray(jdecode.open_mask(str(path)))
    got_rgb = decode.open_rgb(path)
    got_mask = decode.open_mask(path)
    assert got_rgb.dtype == np.uint8 and got_mask.dtype == np.uint8
    np.testing.assert_array_equal(got_rgb, ref_rgb)
    np.testing.assert_array_equal(got_mask, ref_mask)
    np.testing.assert_array_equal(got_rgb, np.asarray(jdecode.open_rgb(str(path))))


@pytest.mark.parametrize("name,color_type,depth,paletted", _forms(),
                         ids=[f[0] for f in _forms()])
@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "cycle"])
def test_every_form_and_filter_matches_pil(tmp_path, name, color_type, depth,
                                           paletted, filters):
    rng = np.random.default_rng([color_type, depth, 7])
    n_pal = min(1 << depth, 200) if paletted else None
    pal = rng.integers(0, 256, (n_pal, 3)) if paletted else None
    path = write_png(tmp_path / f"{name}.png", _samples(rng, color_type, depth, n_pal),
                     color_type, depth, filters, palette=pal)
    assert_same_as_pil(path)


@pytest.mark.parametrize("name,color_type,depth,paletted", _forms(),
                         ids=[f[0] for f in _forms()])
def test_adam7_interlaced_matches_pil(tmp_path, name, color_type, depth, paletted):
    rng = np.random.default_rng([color_type, depth, 11])
    n_pal = min(1 << depth, 200) if paletted else None
    pal = rng.integers(0, 256, (n_pal, 3)) if paletted else None
    path = write_png(tmp_path / f"{name}_i.png", _samples(rng, color_type, depth, n_pal),
                     color_type, depth, "cycle", interlace=1, palette=pal)
    assert_same_as_pil(path)


def _pil_files(tmp_path, rng):
    L = rng.integers(0, 256, (H, W), dtype=np.uint8)
    rgba = rng.integers(0, 256, (H, W, 4), dtype=np.uint8)
    out = {"L": Image.fromarray(L), "RGB": Image.fromarray(rgba[..., :3].copy()),
           "RGBA": Image.fromarray(rgba), "LA": Image.fromarray(rgba[..., :2].copy(), "LA"),
           "1": Image.fromarray(L > 128),
           "I16": Image.fromarray(rng.integers(0, 1000, (H, W)).astype(np.uint16))}
    for n in (2, 4, 16, 256):  # PIL writes 1-, 2-, 4- and 8-bit palettes
        p = Image.fromarray((L.astype(np.int64) % n).astype(np.uint8), "P")
        p.putpalette(rng.integers(0, 256, 3 * n).astype(np.uint8).tolist())
        out[f"P{n}"] = p
    paths = {}
    for k, im in out.items():
        paths[k] = tmp_path / f"pil_{k}.png"
        im.save(paths[k])
    paths["P_trns"] = tmp_path / "pil_P_trns.png"
    out["P16"].save(paths["P_trns"], transparency=3)
    return paths


def _cv2_files(tmp_path, rng):
    arrays = {"L": rng.integers(0, 256, (H, W)).astype(np.uint8),
              "BGR": rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
              "BGRA": rng.integers(0, 256, (H, W, 4)).astype(np.uint8),
              "L16": rng.integers(0, 65536, (H, W)).astype(np.uint16),
              "BGR16": rng.integers(0, 65536, (H, W, 3)).astype(np.uint16),
              "BGRA16": rng.integers(0, 65536, (H, W, 4)).astype(np.uint16)}
    paths = {}
    for k, a in arrays.items():
        paths[k] = tmp_path / f"cv2_{k}.png"
        assert cv2.imwrite(str(paths[k]), a)
    return paths


@pytest.mark.parametrize("writer", ["pil", "cv2"])
def test_files_written_by_pil_and_cv2_match_pil(tmp_path, writer):
    rng = np.random.default_rng(3)
    paths = (_pil_files if writer == "pil" else _cv2_files)(tmp_path, rng)
    for path in paths.values():
        assert_same_as_pil(path)


def test_paletted_mask_is_luminance_of_its_colours_not_its_indices(tmp_path):
    """The trap of open_mask: PIL's convert("L") of a P mask."""
    idx = np.arange(H * W).reshape(H, W, 1) % 7
    pal = [[255, 0, 0], [0, 255, 0], [0, 0, 255], [7, 8, 11], [128, 64, 128],
           [255, 255, 255], [0, 0, 0]]
    path = write_png(tmp_path / "p.png", idx.astype(np.uint8), 3, 8, 4, palette=pal)
    mask = decode.open_mask(path)
    assert not np.array_equal(mask, idx[..., 0])
    np.testing.assert_array_equal(mask[0, :7], [76, 150, 29, 8, 90, 255, 0])
    assert_same_as_pil(path)


def test_wavefront_matches_a_row_loop_at_every_filter_mix(tmp_path):
    """A bigger RGB image with filters drawn per row: the anti-diagonal
    sweep against PIL, and the rows above the first Average/Paeth row
    taken by the vectorised path."""
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (96, 160, 3)).astype(np.uint8)
    for k, filters in enumerate([rng.integers(0, 5, 96), [1] * 40 + [4] * 56,
                                 [2] * 95 + [3]]):
        path = tmp_path / f"mix{k}.png"
        rows = _filter_rows(img.reshape(96, -1), 3, list(filters))

        def chunk(t, p):
            return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

        path.write_bytes(decode.PNG_SIGNATURE
                         + chunk(b"IHDR", struct.pack(">IIBBBBB", 160, 96, 8, 2, 0, 0, 0))
                         + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
        np.testing.assert_array_equal(decode.open_rgb(path), img)


def test_save_png_round_trips_through_pil_and_the_reader(tmp_path):
    rng = np.random.default_rng(9)
    for a in (rng.integers(0, 256, (H, W), dtype=np.uint8),
              rng.integers(0, 256, (H, W, 3), dtype=np.uint8)):
        path = tmp_path / "s.png"
        decode.save_png(path, a)
        with Image.open(path) as im:
            assert im.mode == ("L" if a.ndim == 2 else "RGB")
            np.testing.assert_array_equal(np.asarray(im), a)
        got = decode.open_mask(path) if a.ndim == 2 else decode.open_rgb(path)
        np.testing.assert_array_equal(got, a)
    with pytest.raises(ValueError):
        decode.save_png(tmp_path / "bad.png", np.zeros((4, 4), np.float32))


def test_broken_files_raise_dataset_error(tmp_path):
    rng = np.random.default_rng(1)
    good = write_png(tmp_path / "g.png", rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
                     2, 8, 0)
    data = good.read_bytes()
    cases = {"crc": data[:40] + bytes([data[40] ^ 1]) + data[41:],
             "truncated": data[:len(data) // 2]}
    for name, blob in cases.items():
        (tmp_path / f"{name}.png").write_bytes(blob)
        with pytest.raises(DatasetError):
            decode.open_rgb(tmp_path / f"{name}.png")
    short = write_png(tmp_path / "short.png", np.full((H, W, 1), 9, np.uint8), 3, 8, 0,
                      palette=[[1, 2, 3]] * 4)
    with pytest.raises(DatasetError, match="palette index"):
        decode.open_rgb(short)


@pytest.mark.parametrize("side,error", [(20000, "exceeds the limit"),
                                        (64, "more PNG image data")])
def test_decompression_bomb_is_refused_without_inflating_it(side, error):
    """A 64 KiB PNG whose image data inflates to 64 MiB: with a header past
    PIL's pixel limit it is refused before inflating, with a 64x64 header
    after inflating what 64x64 needs; neither allocates more than 1 MiB."""
    import tracemalloc

    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    body = (decode.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", side, side, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(64 << 20), 9)) + chunk(b"IEND", b""))
    assert len(body) < 128 << 10
    tracemalloc.start()
    try:
        with pytest.raises(DatasetError, match=error):
            decode.decode_png(body)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 1 << 20


def test_png_stream_must_end_with_the_image():
    """Image data cut short inside the zlib stream is corrupt, as
    `zlib.decompress` had it."""
    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    rows = bytes(8 * (1 + 8 * 3))
    for data, error in ((zlib.compress(rows)[:-4], "truncated stream"),
                        (zlib.compress(rows[:-5]), "truncated PNG image data")):
        body = (decode.PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", data) + chunk(b"IEND", b""))
        with pytest.raises(DatasetError, match=error):
            decode.decode_png(body)
    ok = (decode.PNG_SIGNATURE
          + chunk(b"IHDR", struct.pack(">IIBBBBB", 8, 8, 8, 2, 0, 0, 0))
          + chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))
    assert decode.png_rgb(decode.decode_png(ok)).shape == (8, 8, 3)


def test_jpeg_goes_through_the_named_decoder(tmp_path, monkeypatch):
    """JPEG with decoder="pil" equals the JAX open_rgb; with the backend not
    importable it raises DatasetError naming the package, never switching."""
    import sys

    rng = np.random.default_rng(2)
    path = tmp_path / "a.jpg"
    Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(path, quality=90)
    np.testing.assert_array_equal(decode.open_rgb(path, "pil"),
                                  np.asarray(jdecode.open_rgb(str(path), "pil")))
    np.testing.assert_array_equal(decode.open_rgb(path, "cv2"),
                                  np.asarray(jdecode.open_rgb(str(path), "cv2")))
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(DatasetError, match="PIL"):
        decode.open_rgb(path, "pil")
    with pytest.raises(DatasetError, match="cv2"):
        decode.open_rgb(path, "cv2")
    with pytest.raises(ValueError):
        decode.open_rgb(path, "turbo")
    # PNG needs neither backend
    png = write_png(tmp_path / "x.png", np.zeros((H, W, 3), np.uint8), 2, 8, 0)
    assert decode.open_rgb(png, "cv2").shape == (H, W, 3)


@pytest.mark.parametrize("writer", ["pil", "cv2"])
def test_bytes_decoding_equals_path_decoding(tmp_path, writer):
    """decode_rgb of a file's bytes (a request body) equals open_rgb of the
    file: every PNG file PIL and cv2 write, an interlaced one with every
    filter, and a JPEG through the named backend."""
    rng = np.random.default_rng(4)
    paths = list((_pil_files if writer == "pil" else _cv2_files)(tmp_path, rng).values())
    paths.append(write_png(tmp_path / "i.png", _samples(rng, 2, 8), 2, 8, "cycle",
                           interlace=1))
    for path in paths:
        np.testing.assert_array_equal(decode.decode_rgb(path.read_bytes(), writer),
                                      decode.open_rgb(path, writer))
    jpg = tmp_path / "a.jpg"
    Image.fromarray(rng.integers(0, 256, (H, W, 3), dtype=np.uint8)).save(jpg, quality=90)
    np.testing.assert_array_equal(decode.decode_rgb(jpg.read_bytes(), writer),
                                  decode.open_rgb(jpg, writer))
    data = paths[0].read_bytes()
    with pytest.raises(DatasetError):
        decode.decode_rgb(data[:len(data) // 2])


def _png_as_written_before(a, level):
    """The file save_png wrote before it was split into encode_png and a
    write: 8-bit L or RGB, filter 0 on every row, one IDAT."""
    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    h, w = a.shape[:2]
    rows = np.zeros((h, 1 + a[0].size), np.uint8)
    rows[:, 1:] = a.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if a.ndim == 2 else 2, 0, 0, 0)
    return (decode.PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


@pytest.mark.parametrize("level", [1, 6])
def test_encode_png_is_what_save_png_writes(tmp_path, level):
    rng = np.random.default_rng(8)
    for a in (rng.integers(0, 256, (H, W), dtype=np.uint8),
              rng.integers(0, 256, (H, W, 3), dtype=np.uint8)):
        path = tmp_path / "s.png"
        decode.save_png(path, a, level)
        assert decode.encode_png(a, level) == path.read_bytes()
        assert path.read_bytes() == _png_as_written_before(a, level)
    with pytest.raises(ValueError, match="encode_png takes"):
        decode.encode_png(np.zeros((4, 4, 4), np.uint8))
