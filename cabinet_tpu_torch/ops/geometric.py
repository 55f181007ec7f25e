"""Geometric augmentation on device tensors (counterpart of
`cabinet_tpu.ops.geometric`): the train recipes' flip -> flip -> translate
-> rotate(expand) -> scale -> crop as one inverse warp per sample, from the
fixed u8 canvas the datasets ship (`geometric="device"`) to the crop.

Each sample's content fills the top-left (h, w) = src_hw[b] of the canvas;
the rest is padding and is never sampled. Fill semantics, as the host
recipe's PIL ops: pixels that translate and rotate expose are black in the
image and ignore in the label; a crop beyond the scaled extent (RandomCrop's
pad_if_needed) reflects the image and ignores the label. Coordinates follow
PIL's (pixel centres, resize's half-pixel offsets, rotate's output->input
matrix), so flips, integer translates, 90-degree turns and crops are exact.

`sample_geometric_params` draws the per-sample parameters on the host from
a `numpy.random.Generator` (`ops.photometric.params_to_device` moves them);
the apply functions take them as tensors on the canvas' device and compute
the JAX package's results with plain gathers:
  - `apply_geometric` on a u8 canvas gives JAX's u8 branch: bilinear taps
    at the clamped, reflected coordinate; the label is the tap of that
    quad nearest to it (the JAX package's <= 0.5 px crop-edge sliver, where
    the label reads the reflected position, included). On a float canvas
    it gives JAX's float branch: the label at the unreflected coordinate.
  - `apply_geometric_shared` gives `apply_geometric_shared`'s results: one
    (theta, scale) per batch, the continuous 1/s scale, edge-clamped
    content where the exact path reflects, flips as content reversal. JAX
    gathers shared indices from a (S*S, B*9) lane array, a TPU layout; this
    computes each tap's canvas position directly, through the same integer
    steps (the edge replication of the padding, the flips, the clamped
    integer shift and the 3x3 window whose base is clipped to [0, S-3]), so
    it matches JAX at the canvas edges too.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from cabinet_tpu_torch.ops.photometric import params_to_device

Params = Dict[str, np.ndarray]


def sample_geometric_params(rng: np.random.Generator, batch: int, aug: Dict,
                            src_hw: np.ndarray, shared_linear: bool = False) -> Params:
    """Per-sample parameters, with the host recipe's distributions: flips ~
    Bernoulli(fliplr / flipud), translate ~ U(-t, t) * (w, h) pixels, angle
    ~ U(-degrees, degrees) (radians out), scale ~ U(1 - s, 1 + s) or a
    uniform choice of `scale_choices` (the street recipe), crop_u ~ U[0, 1)^2.

    src_hw: (B, 2) valid (h, w) of each sample in the canvas.
    shared_linear: one (theta, scale) for the batch, 0-dim (the shared warp).
    """
    hw = np.asarray(src_hw, np.float32)
    t = float(aug.get("translate", 0.0))
    deg = float(aug.get("degrees", 0.0))
    s = float(aug.get("scale", 0.0))
    lin = () if shared_linear else (batch,)
    out = {"flip_h": rng.random(batch) < float(aug.get("fliplr", 0.0)),
           "flip_v": rng.random(batch) < float(aug.get("flipud", 0.0)),
           "dx": np.float32(rng.uniform(-t, t, batch)) * hw[:, 1],
           "dy": np.float32(rng.uniform(-t, t, batch)) * hw[:, 0],
           "theta": np.asarray(np.deg2rad(rng.uniform(-deg, deg, lin)), np.float32)}
    choices = aug.get("scale_choices")
    if choices is not None:
        scale = np.asarray(choices, np.float32)[rng.integers(0, len(choices), lin)]
    else:
        scale = rng.uniform(1.0 - s, 1.0 + s, lin)
    out["scale"] = np.asarray(scale, np.float32)
    out["crop_u"] = np.asarray(rng.random((batch, 2)), np.float32)
    return out


def _reflect(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x reflected into [0, n-1] (np.pad mode="reflect", no repeated edge);
    0 where n == 1."""
    period = 2.0 * torch.clamp(n - 1.0, min=1.0)
    xm = torch.remainder(x.abs(), period)
    refl = torch.minimum(xm, period - xm)
    return torch.where(n > 1.0, refl, torch.zeros_like(refl))


def _cos_sin(theta: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos and sin of f32 angles, correctly rounded to f32 (through f64):
    torch's f32 sin on the CPU can miss by an ulp, which moves a coordinate
    of tens of pixels by 1e-5 px; this way the CPU, the card and XLA agree."""
    t = theta.double()
    return torch.cos(t).float(), torch.sin(t).float()


def _gather(canvas: torch.Tensor, iy: torch.Tensor, ix: torch.Tensor) -> torch.Tensor:
    """canvas (B, S_h, S_w, ...)[b, iy, ix] for (B, H, W) integer indices."""
    B, Sh, Sw = canvas.shape[:3]
    flat = canvas.reshape((B * Sh * Sw,) + tuple(canvas.shape[3:]))
    base = torch.arange(B, device=canvas.device).view(B, 1, 1) * (Sh * Sw)
    return flat[base + iy.long() * Sw + ix.long()]


def _bilinear(v00, v10, v01, v11, fx, fy):
    """((v00 (1-fx) + v10 fx) (1-fy) + (v01 (1-fx) + v11 fx) fy) in f32,
    the taps' channels last."""
    fx, fy = fx[..., None], fy[..., None]
    return ((v00.float() * (1 - fx) + v10.float() * fx) * (1 - fy)
            + (v01.float() * (1 - fx) + v11.float() * fx) * fy)


def geometric_coords(src_hw: torch.Tensor, params: Dict[str, torch.Tensor],
                     crop_hw: Tuple[int, int]) -> Dict[str, torch.Tensor]:
    """The exact warp's coordinates over the (B, Hc, Wc) output grid, f32:
    (xi, yi) where the image samples (the crop reflected), (xc, yc) the same
    clamped to the frame (the u8 branch's taps and label), (xl, yl) where
    the float branch's label samples (unreflected), `crop_oob` (the crop
    beyond the scaled extent), and the frames' (h, w) as (B, 1, 1)."""
    B = src_hw.shape[0]
    Hc, Wc = int(crop_hw[0]), int(crop_hw[1])
    dev = src_hw.device

    def col(v):  # (B,) or a shared 0-dim -> (B, 1, 1) f32
        v = v.to(torch.float32)
        return (v.expand(B) if v.ndim == 0 else v).reshape(B, 1, 1)

    h, w = col(src_hw[:, 0]), col(src_hw[:, 1])
    theta, scale = col(params["theta"]), col(params["scale"])
    cosb, sinb = _cos_sin(theta)
    wr = w * cosb.abs() + h * sinb.abs()               # rotate expand=True
    hr = w * sinb.abs() + h * cosb.abs()
    ws = torch.round(wr * scale)                        # RandomScale
    hs = torch.round(hr * scale)
    cu = params["crop_u"].to(torch.float32)
    cx = torch.floor(cu[:, 0, None, None] * (torch.clamp(ws - Wc, min=0.0) + 1.0 - 1e-6))
    cy = torch.floor(cu[:, 1, None, None] * (torch.clamp(hs - Hc, min=0.0) + 1.0 - 1e-6))
    x1 = torch.arange(Wc, dtype=torch.float32, device=dev)[None, None, :] + cx
    y1 = torch.arange(Hc, dtype=torch.float32, device=dev)[None, :, None] + cy
    crop_oob = (x1 < -0.5) | (x1 > ws - 0.5) | (y1 < -0.5) | (y1 > hs - 0.5)
    flip_h, flip_v = col(params["flip_h"]) > 0, col(params["flip_v"]) > 0
    dx, dy = col(params["dx"]), col(params["dy"])

    def chain(x1c, y1c):
        """Scaled-image coords -> original-image coords."""
        xr = (x1c + 0.5) * wr / torch.clamp(ws, min=1.0) - 0.5   # undo the scale
        yr = (y1c + 0.5) * hr / torch.clamp(hs, min=1.0) - 0.5
        dxr = xr - (wr - 1.0) / 2.0                               # undo the rotation
        dyr = yr - (hr - 1.0) / 2.0
        xt = cosb * dxr - sinb * dyr + (w - 1.0) / 2.0
        yt = sinb * dxr + cosb * dyr + (h - 1.0) / 2.0
        xf, yf = xt + dx, yt + dy                                 # undo the translate
        return (torch.where(flip_h, (w - 1.0) - xf, xf),          # undo the flips
                torch.where(flip_v, (h - 1.0) - yf, yf))

    xi, yi = chain(_reflect(x1, ws), _reflect(y1, hs))
    xl, yl = chain(x1, y1)
    return {"xi": xi, "yi": yi, "xl": xl, "yl": yl, "crop_oob": crop_oob, "h": h, "w": w,
            "xc": torch.minimum(torch.clamp(xi, min=0.0), w - 1.0),
            "yc": torch.minimum(torch.clamp(yi, min=0.0), h - 1.0)}


def apply_geometric(images: torch.Tensor, labels: torch.Tensor, src_hw: torch.Tensor,
                    params: Dict[str, torch.Tensor], crop_hw: Tuple[int, int],
                    ignore_label: int = 255) -> Tuple[torch.Tensor, torch.Tensor]:
    """The composed warp with explicit params.

    images: (B, S_h, S_w, 3) uint8 canvas (or float in [0, 255]); labels:
    (B, S_h, S_w) integer canvas; src_hw: (B, 2) integer valid (h, w).
    Returns (images (B, Hc, Wc, 3) float32 in [0, 1], labels (B, Hc, Wc)
    int64).
    """
    c = geometric_coords(src_hw, params, crop_hw)
    xi, yi, h, w = c["xi"], c["yi"], c["h"], c["w"]
    wi, hi = w - 1.0, h - 1.0
    img_oob = (xi < -0.5) | (xi > w - 0.5) | (yi < -0.5) | (yi > h - 0.5)
    xn, yn = torch.round(c["xl"]), torch.round(c["yl"])
    lbl_oob = c["crop_oob"] | (xn < 0) | (xn > wi) | (yn < 0) | (yn > hi)

    if images.dtype == torch.uint8:
        # coordinates clamped before the floor: a +1 tap past the valid
        # region then has weight exactly 0
        xic, yic = c["xc"], c["yc"]
        x0, y0 = torch.floor(xic), torch.floor(yic)
        x1, y1 = torch.minimum(x0 + 1.0, wi), torch.minimum(y0 + 1.0, hi)
        out = _bilinear(_gather(images, y0, x0), _gather(images, y0, x1),
                        _gather(images, y1, x0), _gather(images, y1, x1),
                        xic - x0, yic - y0)
        # the label: the quad's tap nearest to the clamped coordinate
        lbl = _gather(labels, torch.round(yic), torch.round(xic))
    else:
        x0, y0 = torch.floor(xi), torch.floor(yi)

        def in_x(v):  # an index clamped to the frame: the padding is never read
            return torch.minimum(torch.clamp(v, min=0.0), wi)

        def in_y(v):
            return torch.minimum(torch.clamp(v, min=0.0), hi)

        out = _bilinear(_gather(images, in_y(y0), in_x(x0)),
                        _gather(images, in_y(y0), in_x(x0 + 1.0)),
                        _gather(images, in_y(y0 + 1.0), in_x(x0)),
                        _gather(images, in_y(y0 + 1.0), in_x(x0 + 1.0)), xi - x0, yi - y0)
        lbl = _gather(labels, in_y(yn), in_x(xn))
    out = torch.where(img_oob[..., None], torch.zeros_like(out), out / 255.0)
    lbl = torch.where(lbl_oob, torch.full_like(lbl, ignore_label), lbl)
    return out, lbl.long()


def shared_coords(src_hw: torch.Tensor, params: Dict[str, torch.Tensor],
                  crop_hw: Tuple[int, int], canvas: int) -> Dict[str, torch.Tensor]:
    """The shared warp's coordinates over the (B, Hc, Wc) output grid:
    (xf, yf) in the source frame, where the validity masks and the label's
    rounding are taken; (px, py), the same points in the frame of the
    canvas shifted by each sample's integer offset (kx, ky); the 3x3
    window's base (basex, basey), shared, (Hc, Wc); the content offsets of
    the flips (ox, oy); and `crop_oob`."""
    S = canvas
    Hc, Wc = int(crop_hw[0]), int(crop_hw[1])
    dev = src_hw.device
    h = src_hw[:, 0].to(torch.float32)
    w = src_hw[:, 1].to(torch.float32)
    theta = params["theta"].to(torch.float32)
    scale = params["scale"].to(torch.float32)
    cosb, sinb = _cos_sin(theta)
    wr = w * cosb.abs() + h * sinb.abs()
    hr = w * sinb.abs() + h * cosb.abs()
    ws, hs = wr * scale, hr * scale                     # the continuous ratio
    cu = params["crop_u"].to(torch.float32)
    cx = torch.floor(cu[:, 0] * (torch.clamp(ws - Wc, min=0.0) + 1.0 - 1e-6))
    cy = torch.floor(cu[:, 1] * (torch.clamp(hs - Hc, min=0.0) + 1.0 - 1e-6))
    rhox = (cx + 0.5) / scale - 0.5
    rhoy = (cy + 0.5) / scale - 0.5
    dx_ = rhox - (wr - 1.0) / 2.0
    dy_ = rhoy - (hr - 1.0) / 2.0
    Dx = cosb * dx_ - sinb * dy_ + (w - 1.0) / 2.0 + params["dx"].to(torch.float32)
    Dy = sinb * dx_ + cosb * dy_ + (h - 1.0) / 2.0 + params["dy"].to(torch.float32)
    zero = torch.zeros_like(w)
    ox = torch.where(params["flip_h"], S - w, zero)
    oy = torch.where(params["flip_v"], S - h, zero)
    shiftx, shifty = Dx + ox, Dy + oy
    kx, ky = torch.floor(shiftx), torch.floor(shifty)
    xs = torch.arange(Wc, dtype=torch.float32, device=dev)[None, :]
    ys = torch.arange(Hc, dtype=torch.float32, device=dev)[:, None]
    ux = (cosb * xs - sinb * ys) / scale                # (Hc, Wc), shared
    uy = (sinb * xs + cosb * ys) / scale

    def per_b(v):
        return v.view(-1, 1, 1)

    x1c = xs[None] + per_b(cx)
    y1c = ys[None] + per_b(cy)
    crop_oob = ((x1c < -0.5) | (x1c > per_b(ws) - 0.5)
                | (y1c < -0.5) | (y1c > per_b(hs) - 0.5))
    return {"xf": ux[None] + per_b(Dx), "yf": uy[None] + per_b(Dy),
            "px": ux[None] + per_b(shiftx - kx), "py": uy[None] + per_b(shifty - ky),
            "basex": torch.clamp(torch.floor(ux), 0.0, S - 3.0).long(),
            "basey": torch.clamp(torch.floor(uy), 0.0, S - 3.0).long(),
            "kx": kx, "ky": ky, "ox": ox, "oy": oy, "crop_oob": crop_oob}


def apply_geometric_shared(images: torch.Tensor, labels: torch.Tensor,
                           src_hw: torch.Tensor, params: Dict[str, torch.Tensor],
                           crop_hw: Tuple[int, int], ignore_label: int = 255
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batch-shared warp (`runtime.device_geometric=shared`): theta and
    scale 0-dim (`sample_geometric_params(..., shared_linear=True)`), a
    square u8 canvas. Returns what `apply_geometric` returns."""
    B, Sh, Sw = images.shape[:3]
    if Sh != Sw:
        raise ValueError("shared-mode canvas must be square (fixed loader "
                         f"canvas); got {(Sh, Sw)}")
    if images.dtype != torch.uint8:
        raise ValueError("shared mode requires a uint8 canvas")
    if params["theta"].ndim or params["scale"].ndim:
        raise ValueError("shared mode needs scalar theta/scale: draw params "
                         "with sample_geometric_params(shared_linear=True)")
    S = Sh
    c = shared_coords(src_hw, params, crop_hw, S)
    wi = (src_hw[:, 1] - 1).long().view(B, 1, 1)
    hi = (src_hw[:, 0] - 1).long().view(B, 1, 1)
    kx = torch.clamp(c["kx"], -S, S).long().view(B, 1, 1)
    ky = torch.clamp(c["ky"], -S, S).long().view(B, 1, 1)
    flip_h = params["flip_h"].view(B, 1, 1)
    flip_v = params["flip_v"].view(B, 1, 1)

    def col(shifted):
        """A column of the shifted canvas -> the content column it holds:
        the clamped integer shift, the flip's reversal, the padding's edge
        replication."""
        x = torch.clamp(shifted + kx, 0, S - 1)
        x = torch.where(flip_h, S - 1 - x, x)
        return torch.minimum(x, wi)

    def row(shifted):
        y = torch.clamp(shifted + ky, 0, S - 1)
        y = torch.where(flip_v, S - 1 - y, y)
        return torch.minimum(y, hi)

    px, py = c["px"], c["py"]
    fxp, fyp = torch.floor(px), torch.floor(py)
    bx, by = c["basex"][None], c["basey"][None]
    # the bilinear pair inside the 3x3 window at (by, bx)
    x0 = bx + torch.clamp(fxp.long() - bx, 0, 1)
    y0 = by + torch.clamp(fyp.long() - by, 0, 1)
    c0, c1, r0, r1 = col(x0), col(x0 + 1), row(y0), row(y0 + 1)
    out = _bilinear(_gather(images, r0, c0), _gather(images, r0, c1),
                    _gather(images, r1, c0), _gather(images, r1, c1),
                    px - fxp, py - fyp)

    xf, yf = c["xf"], c["yf"]
    w = src_hw[:, 1].to(torch.float32).view(B, 1, 1)
    h = src_hw[:, 0].to(torch.float32).view(B, 1, 1)
    img_oob = (xf < -0.5) | (xf > w - 0.5) | (yf < -0.5) | (yf > h - 0.5)
    out = torch.where(img_oob[..., None], torch.zeros_like(out), out / 255.0)

    # the label: the window's tap nearest in the source frame (half to even
    # there), moved by the integer offset between the frames
    xn, yn = torch.round(xf), torch.round(yf)
    oxk = (c["ox"] - c["kx"]).long().view(B, 1, 1)
    oyk = (c["oy"] - c["ky"]).long().view(B, 1, 1)
    tnx = torch.clamp(xn.long() + oxk - bx, 0, 2)
    tny = torch.clamp(yn.long() + oyk - by, 0, 2)
    lbl = _gather(labels, row(by + tny), col(bx + tnx))
    lbl_oob = c["crop_oob"] | (xn < 0) | (xn > w - 1.0) | (yn < 0) | (yn > h - 1.0)
    lbl = torch.where(lbl_oob, torch.full_like(lbl, ignore_label), lbl)
    return out, lbl.long()


def geometric_pipeline(images: torch.Tensor, labels: torch.Tensor, src_hw: np.ndarray,
                       rng: np.random.Generator, aug: Optional[Dict],
                       crop_hw: Tuple[int, int], ignore_label: int = 255,
                       shared_linear: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw the params from `rng` on the host (src_hw: the batch's (B, 2)
    valid sizes, numpy) and apply them on the canvas' device: the training
    entry point. `shared_linear` picks `apply_geometric_shared`
    (`runtime.device_geometric=shared`)."""
    params = sample_geometric_params(rng, images.shape[0], aug or {}, src_hw,
                                     shared_linear=shared_linear)
    params, hw = params_to_device((params, np.asarray(src_hw, np.int32)), images.device)
    fn = apply_geometric_shared if shared_linear else apply_geometric
    return fn(images, labels, hw, params, crop_hw, ignore_label)
