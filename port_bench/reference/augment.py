"""The Cityscapes street recipe's device augmentation in plain PyTorch, the
benchmark's frozen reference for what the port's `DeviceAugment` makes of
a batch of u8 canvases: per sample a flip, a discrete scale and a crop
(one inverse warp with bilinear taps from the u8 canvas, the label at the
nearest tap, a crop past the scaled extent reflected in the image and
ignored in the label), then brightness, contrast, saturation, grayscale,
gamma, noise and cutout, then the normalisation.

The draws follow the recipe's order from one `numpy.random.Generator`
keyed [seed, step, micro_step], the noise from a `torch.Generator` on the
device seeded from the same key, so that the program's and the
reference's batches hold the same samples.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

# configs/dataset/cityscapes.yaml's train recipe (reference cityscapes.py:114-136)
SCALE_CHOICES = (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)
FLIP_P = 0.5
LUMA = (0.299, 0.587, 0.114)


def draws(seed: int, step: int, micro_step: int, device) -> Tuple[np.random.Generator,
                                                                    torch.Generator]:
    key = [int(seed), int(step), int(micro_step)]
    noise = torch.Generator(device=device)
    noise.manual_seed(int(np.random.SeedSequence(key).generate_state(1)[0]))
    return np.random.default_rng(key), noise


def sample_params(rng: np.random.Generator, B: int, hw: np.ndarray, H: int, W: int) -> Dict:
    f32 = np.float32
    hwf = np.asarray(hw, f32)
    geo = {"flip_h": rng.random(B) < FLIP_P, "flip_v": rng.random(B) < 0.0,
           "dx": f32(rng.uniform(-0.0, 0.0, B)) * hwf[:, 1],
           "dy": f32(rng.uniform(-0.0, 0.0, B)) * hwf[:, 0],
           "theta": np.asarray(np.deg2rad(rng.uniform(-0.0, 0.0, (B,))), f32)}
    geo["scale"] = np.asarray(SCALE_CHOICES, f32)[rng.integers(0, len(SCALE_CHOICES), (B,))]
    geo["crop_u"] = np.asarray(rng.random((B, 2)), f32)
    return geo


def sample_photometric(rng: np.random.Generator, B: int, H: int, W: int) -> Dict:
    f32 = np.float32

    def factor():
        return f32(rng.uniform(0.5, 1.5, B))

    out = {"brightness": factor(), "contrast": factor(), "saturation": factor(),
           "grayscale": rng.random(B) < 0.2}
    out["gamma"] = f32(rng.uniform(0.8, 1.2, B))
    out["gamma_apply"] = rng.random(B) < 0.3
    out["noise"] = rng.random(B) < 0.3
    out["cut_y0"] = rng.integers(0, max(H - 64, 1), B)
    out["cut_x0"] = rng.integers(0, max(W - 64, 1), B)
    out["cut_apply"] = rng.random(B) < 0.3
    return out


def _col(v: torch.Tensor, B: int) -> torch.Tensor:
    return v.to(torch.float32).reshape(B, 1, 1)


def warp(canvas: torch.Tensor, labels: torch.Tensor, hw: torch.Tensor, p: Dict,
         crop: Tuple[int, int], ignore: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,S,S,3) u8 and (B,S,S) u8 canvases -> (B,Hc,Wc,3) f32 in [0,1] and
    (B,Hc,Wc) int64, PIL's coordinates (pixel centres)."""
    B = canvas.shape[0]
    Hc, Wc = crop
    dev = canvas.device
    h, w = _col(hw[:, 0], B), _col(hw[:, 1], B)
    t = _col(p["theta"], B).double()
    cosb, sinb = torch.cos(t).float(), torch.sin(t).float()
    scale = _col(p["scale"], B)
    wr = w * cosb.abs() + h * sinb.abs()
    hr = w * sinb.abs() + h * cosb.abs()
    ws, hs = torch.round(wr * scale), torch.round(hr * scale)
    cu = p["crop_u"].to(torch.float32)
    cx = torch.floor(cu[:, 0, None, None] * (torch.clamp(ws - Wc, min=0.0) + 1.0 - 1e-6))
    cy = torch.floor(cu[:, 1, None, None] * (torch.clamp(hs - Hc, min=0.0) + 1.0 - 1e-6))
    x1 = torch.arange(Wc, dtype=torch.float32, device=dev)[None, None, :] + cx
    y1 = torch.arange(Hc, dtype=torch.float32, device=dev)[None, :, None] + cy
    crop_oob = (x1 < -0.5) | (x1 > ws - 0.5) | (y1 < -0.5) | (y1 > hs - 0.5)
    flip_h, flip_v = _col(p["flip_h"], B) > 0, _col(p["flip_v"], B) > 0
    dx, dy = _col(p["dx"], B), _col(p["dy"], B)

    def reflect(x, n):
        period = 2.0 * torch.clamp(n - 1.0, min=1.0)
        xm = torch.remainder(x.abs(), period)
        return torch.where(n > 1.0, torch.minimum(xm, period - xm), torch.zeros_like(xm))

    def back(xs, ys):  # scaled-image coordinates -> the frame's
        xr = (xs + 0.5) * wr / torch.clamp(ws, min=1.0) - 0.5
        yr = (ys + 0.5) * hr / torch.clamp(hs, min=1.0) - 0.5
        dxr, dyr = xr - (wr - 1.0) / 2.0, yr - (hr - 1.0) / 2.0
        xf = cosb * dxr - sinb * dyr + (w - 1.0) / 2.0 + dx
        yf = sinb * dxr + cosb * dyr + (h - 1.0) / 2.0 + dy
        return (torch.where(flip_h, (w - 1.0) - xf, xf),
                torch.where(flip_v, (h - 1.0) - yf, yf))

    xi, yi = back(reflect(x1, ws), reflect(y1, hs))
    xl, yl = back(x1, y1)
    wi, hi = w - 1.0, h - 1.0
    img_oob = (xi < -0.5) | (xi > w - 0.5) | (yi < -0.5) | (yi > h - 0.5)
    xn, yn = torch.round(xl), torch.round(yl)
    lbl_oob = crop_oob | (xn < 0) | (xn > wi) | (yn < 0) | (yn > hi)
    xc = torch.minimum(torch.clamp(xi, min=0.0), wi)
    yc = torch.minimum(torch.clamp(yi, min=0.0), hi)
    x0, y0 = torch.floor(xc), torch.floor(yc)
    xp, yp = torch.minimum(x0 + 1.0, wi), torch.minimum(y0 + 1.0, hi)
    S_h, S_w = canvas.shape[1:3]
    base = torch.arange(B, device=dev).view(B, 1, 1) * (S_h * S_w)

    def at(t, iy, ix):
        flat = t.reshape((B * S_h * S_w,) + tuple(t.shape[3:]))
        return flat[base + iy.long() * S_w + ix.long()]

    fx, fy = (xc - x0)[..., None], (yc - y0)[..., None]
    img = ((at(canvas, y0, x0).float() * (1 - fx) + at(canvas, y0, xp).float() * fx) * (1 - fy)
           + (at(canvas, yp, x0).float() * (1 - fx) + at(canvas, yp, xp).float() * fx) * fy)
    lbl = at(labels, torch.round(yc), torch.round(xc))
    img = torch.where(img_oob[..., None], torch.zeros_like(img), img / 255.0)
    lbl = torch.where(lbl_oob, torch.full_like(lbl, ignore), lbl)
    return img, lbl.long()


def _luma(x: torch.Tensor) -> torch.Tensor:
    return (x[..., 0] * LUMA[0] + x[..., 1] * LUMA[1] + x[..., 2] * LUMA[2])[..., None]


def photometric(x: torch.Tensor, p: Dict, z: torch.Tensor, mean: Sequence[float],
                std: Sequence[float]) -> torch.Tensor:
    B, H, W, _ = x.shape

    def per(v, nd=4):
        return v.reshape(v.shape[:1] + (1,) * (nd - 1))

    x = torch.clamp(x * per(p["brightness"]), 0.0, 1.0)
    m = _luma(x).mean(dim=(1, 2), keepdim=True)
    x = torch.clamp(m + (x - m) * per(p["contrast"]), 0.0, 1.0)
    g = _luma(x)
    x = torch.clamp(g + (x - g) * per(p["saturation"]), 0.0, 1.0)
    x = torch.where(per(p["grayscale"]), _luma(x).expand_as(x), x)
    x = torch.where(per(p["gamma_apply"]), torch.clamp(x, 0.0, 1.0) ** per(p["gamma"]), x)
    x = torch.where(per(p["noise"]), torch.clamp(x + z * 0.03, 0.0, 1.0), x)
    yy = torch.arange(H, device=x.device)[None, :, None]
    xx = torch.arange(W, device=x.device)[None, None, :]
    y0, x0 = per(p["cut_y0"], 3), per(p["cut_x0"], 3)
    inside = (yy >= y0) & (yy < y0 + 64) & (xx >= x0) & (xx < x0 + 64) & per(p["cut_apply"], 3)
    x = torch.where(inside[..., None], torch.zeros_like(x), x)
    m = torch.tensor(np.asarray(mean, np.float32), device=x.device)
    s = torch.tensor(np.asarray(std, np.float32), device=x.device)
    return (x - m) / s


def augment(canvas: torch.Tensor, labels: torch.Tensor, hw: np.ndarray, seed: int,
            step: int, micro_step: int, crop: Tuple[int, int], ignore: int,
            mean: Sequence[float], std: Sequence[float]) -> Tuple[torch.Tensor, torch.Tensor]:
    """A batch of canvases -> (normalised images (B,Hc,Wc,3), labels)."""
    dev = canvas.device
    rng, noise = draws(seed, step, micro_step, dev)
    B = canvas.shape[0]
    geo = sample_params(rng, B, hw, *crop)
    geo_t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in geo.items()}
    img, lbl = warp(canvas, labels, torch.from_numpy(np.asarray(hw)).to(dev), geo_t, crop,
                    ignore)
    z = torch.randn((B,) + tuple(img.shape[1:]), generator=noise, device=dev)
    ph = sample_photometric(rng, B, *crop)
    ph_t = {k: torch.from_numpy(np.array(v)).to(dev) for k, v in ph.items()}
    return photometric(img, ph_t, z, mean, std), lbl
