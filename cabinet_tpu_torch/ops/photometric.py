"""Photometric augmentation on device tensors (counterpart of
`cabinet_tpu.ops.photometric`): the aerial and the street recipes' colour
tail and mixup over a batch, channel-last (B, H, W, 3) float32 in [0, 1].

The JAX package draws each op's parameters inside the op from a PRNG key.
Here drawing and applying are apart:
  - `sample_*` draw an op's per-sample parameters (O(B) numbers) on the host
    from an explicit `numpy.random.Generator`, as numpy arrays;
  - the op itself applies given parameters, as tensors on the images'
    device (`params_to_device` moves a drawn tree there without a host
    sync);
  - the gaussian noise is the one per-pixel draw: its standard normal
    values `z` come in as a tensor, which the trainer draws on the device.
So a CPU and a CUDA run of the same draws compute the same function, and
tests feed the ops with the parameters that JAX's own key schedule drew.

The formulas are the JAX package's (and so the host recipe's): HSV with an
additive wrapping hue and multiplicative saturation and value, the hue back
to RGB by the branchless sector form; PIL's enhancers (brightness, contrast
against the mean luma, saturation against the per-pixel luma); gamma on
[0, 1]; noise of `sigma` in [0, 1] units; zeroed cutout squares; mixup with a
rolled partner, a Beta(32, 32) ratio and the label of the larger share. No
op here has a kernel of its own: each is plain PyTorch on device tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

Params = Dict[str, Any]

_LUMA = (0.299, 0.587, 0.114)  # PIL's convert("L"), ITU-R 601


def params_to_device(tree: Any, device: torch.device) -> Any:
    """A tree (nested dicts) of numpy arrays as tensors on `device`. A CUDA
    copy goes from pinned memory without blocking, so the host never waits
    on the device here."""
    if isinstance(tree, dict):
        return {k: params_to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_device(v, device) for v in tree]
    t = torch.from_numpy(np.array(tree))
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def take_rows(tree: Any, rows: Any, shared: Sequence[str] = ()) -> Any:
    """The rows `rows` (an index or a slice) of a sampler's parameters: every
    leaf is per-sample (batch first) but those named in `shared`, which hold
    one value for the batch and come back as they are."""
    if isinstance(tree, dict):
        return {k: v if k in shared else take_rows(v, rows, shared)
                for k, v in tree.items()}
    return np.asarray(tree)[rows]


def _per_sample(v: torch.Tensor, ndim: int) -> torch.Tensor:
    """(B,) -> (B, 1, ..., 1) with `ndim` dims in all."""
    return v.reshape(v.shape[:1] + (1,) * (ndim - 1))


def _f32(rng_values) -> np.ndarray:
    return np.asarray(rng_values, np.float32)


# ---------------------------------------------------------------------------
# colour space
# ---------------------------------------------------------------------------


def rgb_to_hsv(rgb: torch.Tensor) -> torch.Tensor:
    """RGB [0, 1] -> HSV [0, 1], channel-last."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    maxc = rgb.amax(dim=-1)
    minc = rgb.amin(dim=-1)
    rang = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, rang / torch.clamp(maxc, min=1e-12), zero)
    safe = torch.clamp(rang, min=1e-12)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(r == maxc, bc - gc,
                    torch.where(g == maxc, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.remainder(h / 6.0, 1.0)
    h = torch.where(rang == 0, zero, h)
    return torch.stack([h, s, maxc], dim=-1)


def hsv_to_rgb(hsv: torch.Tensor) -> torch.Tensor:
    """HSV [0, 1] -> RGB, the branchless sector formula."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]

    def chan(n: float) -> torch.Tensor:
        k = torch.remainder(n + h * 6.0, 6.0)
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)

    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], dim=-1)


def _luma(images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) -> (B, H, W, 1) luma."""
    return (images[..., 0] * _LUMA[0] + images[..., 1] * _LUMA[1]
            + images[..., 2] * _LUMA[2])[..., None]


# ---------------------------------------------------------------------------
# samplers: per-sample parameters from a numpy Generator
# ---------------------------------------------------------------------------


def sample_hsv(rng: np.random.Generator, batch: int, hgain: float = 0.015,
               sgain: float = 0.4, vgain: float = 0.3) -> Params:
    """The HSV gains: U(-1, 1) times each gain, per sample."""
    return {"r_h": _f32(rng.uniform(-1.0, 1.0, batch) * hgain),
            "r_s": _f32(rng.uniform(-1.0, 1.0, batch) * sgain),
            "r_v": _f32(rng.uniform(-1.0, 1.0, batch) * vgain)}


def sample_factor(rng: np.random.Generator, batch: int, strength: float = 0.5) -> Params:
    """An enhancer's factor ~ U(max(1 - strength, 0), 1 + strength)."""
    return {"factor": _f32(rng.uniform(max(1.0 - strength, 0.0), 1.0 + strength, batch))}


def sample_apply(rng: np.random.Generator, batch: int, p: float) -> Params:
    """A per-sample coin of probability p."""
    return {"apply": rng.random(batch) < p}


def sample_gamma(rng: np.random.Generator, batch: int,
                 gamma_range: Tuple[float, float] = (0.8, 1.2), p: float = 0.3) -> Params:
    return {"gamma": _f32(rng.uniform(gamma_range[0], gamma_range[1], batch)),
            **sample_apply(rng, batch, p)}


def sample_cutout(rng: np.random.Generator, batch: int, height: int, width: int,
                  size: int = 64, p: float = 0.3) -> Params:
    """Square corners uniform over [0, max(H - size, 1)) x [0, max(W - size, 1))."""
    return {"y0": rng.integers(0, max(height - size, 1), batch),
            "x0": rng.integers(0, max(width - size, 1), batch),
            **sample_apply(rng, batch, p)}


def sample_mixup(rng: np.random.Generator, batch: int, p: float = 0.1) -> Params:
    """The mixup coin and ratio r ~ Beta(32, 32)."""
    return {**sample_apply(rng, batch, p), "r": _f32(rng.beta(32.0, 32.0, batch))}


# ---------------------------------------------------------------------------
# ops: explicit parameters, tensors on the images' device
# ---------------------------------------------------------------------------


def hsv(images: torch.Tensor, r_h: torch.Tensor, r_s: torch.Tensor,
        r_v: torch.Tensor) -> torch.Tensor:
    """Hue shifted by r_h (wrapping), saturation and value scaled by
    1 + r_s and 1 + r_v and clipped to [0, 1]."""
    x = rgb_to_hsv(images)
    h = torch.remainder(x[..., 0] + _per_sample(r_h, 3), 1.0)
    s = torch.clamp(x[..., 1] * (_per_sample(r_s, 3) + 1.0), 0.0, 1.0)
    v = torch.clamp(x[..., 2] * (_per_sample(r_v, 3) + 1.0), 0.0, 1.0)
    return hsv_to_rgb(torch.stack([h, s, v], dim=-1))


def contrast(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """ImageEnhance.Contrast: a blend with the image's mean luma."""
    mean = _luma(images).mean(dim=(1, 2), keepdim=True)
    return torch.clamp(mean + (images - mean) * _per_sample(factor, 4), 0.0, 1.0)


def brightness(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """ImageEnhance.Brightness: a blend with black."""
    return torch.clamp(images * _per_sample(factor, 4), 0.0, 1.0)


def saturation(images: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """ImageEnhance.Color: a blend with the per-pixel luma."""
    gray = _luma(images)
    return torch.clamp(gray + (images - gray) * _per_sample(factor, 4), 0.0, 1.0)


def grayscale(images: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """PIL convert("L").convert("RGB") where `apply`."""
    return torch.where(_per_sample(apply, 4), _luma(images).expand_as(images), images)


def gamma(images: torch.Tensor, gamma: torch.Tensor, apply: torch.Tensor) -> torch.Tensor:
    """clip(x, 0, 1) ** gamma where `apply`."""
    out = torch.clamp(images, 0.0, 1.0) ** _per_sample(gamma, 4)
    return torch.where(_per_sample(apply, 4), out, images)


def noise(images: torch.Tensor, z: torch.Tensor, apply: torch.Tensor,
          sigma: float = 0.03) -> torch.Tensor:
    """clip(x + sigma * z, 0, 1) where `apply`; z standard normal, the
    images' shape."""
    return torch.where(_per_sample(apply, 4),
                       torch.clamp(images + z * sigma, 0.0, 1.0), images)


def cutout(images: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
           apply: torch.Tensor, size: int = 64) -> torch.Tensor:
    """Zero the size x size square at (y0, x0) where `apply`."""
    _, H, W, _ = images.shape
    yy = torch.arange(H, device=images.device)[None, :, None]
    xx = torch.arange(W, device=images.device)[None, None, :]
    y0, x0 = _per_sample(y0, 3), _per_sample(x0, 3)
    inside = (yy >= y0) & (yy < y0 + size) & (xx >= x0) & (xx < x0 + size)
    mask = inside & _per_sample(apply, 3)
    return torch.where(mask[..., None], torch.zeros_like(images), images)


def mixup(images: torch.Tensor, labels: torch.Tensor, apply: torch.Tensor,
          r: torch.Tensor, partner: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blend each sample where `apply` with its rolled partner (the one
    before it), x * r + partner * (1 - r); the partner's label where it has
    the larger share (r < 0.5). `partner` gives the partners' images and
    labels instead (data parallelism: the sample before may be another
    rank's)."""
    if partner is None:
        partner = (torch.roll(images, 1, dims=0), torch.roll(labels, 1, dims=0))
    partner_img, partner_lbl = partner
    r_img = _per_sample(r, 4)
    blended = images * r_img + partner_img * (1.0 - r_img)
    out_img = torch.where(_per_sample(apply, 4), blended, images)
    take_partner = apply & (r < 0.5)
    out_lbl = torch.where(_per_sample(take_partner, 3), partner_lbl, labels)
    return out_img, out_lbl


def normalize(images: torch.Tensor, mean: Sequence[float],
              std: Sequence[float]) -> torch.Tensor:
    """(x - mean) / std with float32 mean and std."""
    m, s = params_to_device([np.asarray(v, np.float32) for v in (mean, std)],
                            images.device)
    return (images - m) / s


# ---------------------------------------------------------------------------
# the two recipes' chains
# ---------------------------------------------------------------------------


def sample_photometric(rng: np.random.Generator, batch: int, height: int, width: int,
                       aug: Optional[Dict] = None) -> Params:
    """The aerial chain's parameters (`photometric_pipeline`)."""
    aug = aug or {}
    return {
        "hsv": sample_hsv(rng, batch, aug.get("hsv_h", 0.01), aug.get("hsv_s", 0.4),
                          aug.get("hsv_v", 0.3)),
        "contrast": sample_factor(rng, batch, 0.5),
        "gamma": sample_gamma(rng, batch, (0.8, 1.2), 0.3),
        "noise": sample_apply(rng, batch, 0.3),
        "cutout": sample_cutout(rng, batch, height, width, 64, 0.3),
        "mixup": sample_mixup(rng, batch, aug.get("mixup", 0.1)),
    }


def photometric_pipeline(images: torch.Tensor, labels: torch.Tensor, params: Params,
                         z: torch.Tensor, mean=None, std=None, partners=None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The aerial recipe's tail: HSV -> contrast -> gamma -> noise -> cutout
    -> mixup -> normalize (when mean and std are given). `images` are raw
    [0, 1] RGB, `params` `sample_photometric`'s on the images' device, `z`
    the noise's standard normal values. `partners(x, labels)`, when given,
    returns mixup's partners of the cut-out batch (`mixup`'s `partner`)."""
    x = hsv(images, **params["hsv"])
    x = contrast(x, **params["contrast"])
    x = gamma(x, **params["gamma"])
    x = noise(x, z, params["noise"]["apply"], 0.03)
    x = cutout(x, **params["cutout"], size=64)
    x, labels = mixup(x, labels, **params["mixup"],
                      partner=None if partners is None else partners(x, labels))
    if mean is not None:
        x = normalize(x, mean, std)
    return x, labels


def sample_street_photometric(rng: np.random.Generator, batch: int, height: int,
                              width: int) -> Params:
    """The street chain's parameters (`street_photometric_pipeline`)."""
    return {
        "brightness": sample_factor(rng, batch, 0.5),
        "contrast": sample_factor(rng, batch, 0.5),
        "saturation": sample_factor(rng, batch, 0.5),
        "grayscale": sample_apply(rng, batch, 0.2),
        "gamma": sample_gamma(rng, batch, (0.8, 1.2), 0.3),
        "noise": sample_apply(rng, batch, 0.3),
        "cutout": sample_cutout(rng, batch, height, width, 64, 0.3),
    }


def street_photometric_pipeline(images: torch.Tensor, labels: torch.Tensor,
                                params: Params, z: torch.Tensor, mean=None, std=None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Cityscapes street recipe's tail (reference cityscapes.py:114-136):
    brightness -> contrast -> saturation -> grayscale -> gamma -> noise ->
    cutout -> normalize. No HSV and no mixup; the labels pass through."""
    x = brightness(images, **params["brightness"])
    x = contrast(x, **params["contrast"])
    x = saturation(x, **params["saturation"])
    x = grayscale(x, **params["grayscale"])
    x = gamma(x, **params["gamma"])
    x = noise(x, z, params["noise"]["apply"], 0.03)
    x = cutout(x, **params["cutout"], size=64)
    if mean is not None:
        x = normalize(x, mean, std)
    return x, labels
