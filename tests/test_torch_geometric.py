"""The port's device geometric augmentation (cabinet_tpu_torch.ops.geometric)
against the JAX package's (cabinet_tpu.ops.geometric) on the CPU, with the
parameters JAX's own sampler drew: `apply_geometric` on a u8 and on a float
canvas, and `apply_geometric_shared`. Images agree within 1e-5 on [0, 1];
labels exactly on integer geometries, and otherwise on >= 99.9% of the
pixels and on every pixel whose sampling coordinate lies more than 1e-3 px
from a rounding tie. The canvas padding never reaches the output and no
label class is invented (as tests/unit/test_geometric*.py hold JAX's).

Sizes: B=4, canvas 64, crop 32, one compiled JAX program per warp."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from cabinet_tpu.ops import geometric as JG
from cabinet_tpu_torch.ops import geometric as TG

IGN = 255
B, S, CROP = 4, 64, (32, 32)
HW = np.array([[64, 64], [40, 48], [64, 50], [33, 64]], np.int32)
AUG = {"degrees": 30.0, "translate": 0.2, "scale": 0.5, "fliplr": 0.5, "flipud": 0.5}
IMG_ATOL = 1e-5
TIE = 1e-3
LABEL_SHARE = 0.999

_j_exact = jax.jit(JG.apply_geometric, static_argnums=(4, 5))
_j_shared = jax.jit(JG.apply_geometric_shared, static_argnums=(4, 5))


def canvases(seed=0, hw=HW, poison=None):
    rng = np.random.default_rng(seed)
    ci = np.zeros((B, S, S, 3), np.uint8)
    cl = np.full((B, S, S), IGN, np.uint8)
    for b, (h, w) in enumerate(hw):
        ci[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
        cl[b, :h, :w] = rng.integers(0, 8, (h, w))
        if poison is not None:
            ci[b, h:], ci[b, :, w:] = poison, poison
    return ci, cl


def jax_params(key, shared=False):
    p = JG.sample_geometric_params(jax.random.PRNGKey(key), B, AUG, jnp.asarray(HW),
                                   shared_linear=shared)
    return {k: np.asarray(v) for k, v in p.items()}


def identity(**kw):
    p = {"flip_h": np.zeros(B, bool), "flip_v": np.zeros(B, bool),
         "dx": np.zeros(B, np.float32), "dy": np.zeros(B, np.float32),
         "theta": np.zeros(B, np.float32), "scale": np.ones(B, np.float32),
         "crop_u": np.zeros((B, 2), np.float32)}
    for k, v in kw.items():
        p[k] = np.broadcast_to(np.asarray(v, p[k].dtype), p[k].shape).copy()
    return p


def shared(p):
    return {**p, "theta": p["theta"][0], "scale": p["scale"][0]}


def t(p):
    return {k: torch.from_numpy(np.array(v)) for k, v in p.items()}


def run(ci, cl, p, warp="u8"):
    """(JAX image, JAX label, port image, port label) as numpy."""
    jfn, tfn = ((_j_shared, TG.apply_geometric_shared) if warp == "shared"
                else (_j_exact, TG.apply_geometric))
    img = ci.astype(np.float32) if warp == "float" else ci
    jo, jl = jfn(jnp.asarray(img), jnp.asarray(cl), jnp.asarray(HW),
                 {k: jnp.asarray(v) for k, v in p.items()}, CROP, IGN)
    to, tl = tfn(torch.from_numpy(img), torch.from_numpy(cl), torch.from_numpy(HW),
                 t(p), CROP, IGN)
    return np.asarray(jo), np.asarray(jl), to.numpy(), tl.numpy()


def near_tie(*coords):
    """Pixels where a coordinate lies within TIE px of a rounding tie (a
    half-integer)."""
    out = np.zeros(coords[0].shape, bool)
    for c in coords:
        c = np.asarray(c, np.float64)
        out |= np.abs(c - np.floor(c) - 0.5) < TIE
    return out


def label_ties(p, warp):
    tp = t(p)
    hw = torch.from_numpy(HW)
    if warp == "shared":
        c = TG.shared_coords(hw, tp, CROP, S)
        return near_tie(c["xf"], c["yf"])
    c = TG.geometric_coords(hw, tp, CROP)
    if warp == "float":
        return near_tie(c["xl"], c["yl"])
    return near_tie(c["xl"], c["yl"], c["xc"], c["yc"])


@pytest.mark.parametrize("warp", ["u8", "float", "shared"])
@pytest.mark.parametrize("key", [0, 1, 2])
def test_warp_matches_jax_on_jax_drawn_params(warp, key):
    ci, cl = canvases(seed=key)
    p = jax_params(key, shared=warp == "shared")
    jo, jl, to, tl = run(ci, cl, p, warp)
    assert to.shape == jo.shape == (B, *CROP, 3) and tl.shape == jl.shape == (B, *CROP)
    assert float(np.abs(to - jo).max()) <= IMG_ATOL
    differ = tl != jl
    assert differ.mean() <= 1.0 - LABEL_SHARE, differ.mean()
    assert not (differ & ~label_ties(p, warp)).any()
    assert (tl != IGN).any() and (tl == IGN).any()  # the draws crop and fill


INTEGER = {
    "identity": {},
    "flip_h": dict(flip_h=True),
    "flips": dict(flip_h=True, flip_v=True),
    "translate": dict(dx=5.0, dy=-3.0),
    "crop": dict(crop_u=0.999),
    "rot90": dict(theta=np.pi / 2),
    "rot90_flip_crop": dict(theta=-np.pi / 2, flip_v=True, crop_u=0.5, dx=2.0),
}


@pytest.mark.parametrize("warp", ["u8", "float", "shared"])
@pytest.mark.parametrize("geom", sorted(INTEGER))
def test_integer_geometries_match_jax_exactly(warp, geom):
    ci, cl = canvases(seed=3)
    p = identity(**INTEGER[geom])
    if warp == "shared":
        p = shared(p)
    jo, jl, to, tl = run(ci, cl, p, warp)
    assert float(np.abs(to - jo).max()) <= IMG_ATOL
    np.testing.assert_array_equal(tl, jl)


def test_integer_geometries_against_pil_and_numpy():
    """What tests/unit/test_geometric.py pins for JAX, on the port: identity,
    flips and an integer translate with its fill, a 90-degree turn as PIL's
    rotate(expand=True), the crop window and its reflect padding."""
    ci, cl = canvases(seed=4)
    hw = torch.from_numpy(HW)

    def warp(crop=CROP, **kw):
        o, lb = TG.apply_geometric(torch.from_numpy(ci), torch.from_numpy(cl), hw,
                                   t(identity(**kw)), crop, IGN)
        return o.numpy(), lb.numpy()

    img, lbl = ci[0, :, :], cl[0, :, :]  # sample 0 fills the canvas
    o, lb = warp((64, 64))
    np.testing.assert_allclose(o[0], img / 255.0, atol=1e-6)
    np.testing.assert_array_equal(lb[0], lbl)
    o, lb = warp((64, 64), flip_h=True, flip_v=True)
    np.testing.assert_allclose(o[0], img[::-1, ::-1] / 255.0, atol=1e-5)
    np.testing.assert_array_equal(lb[0], lbl[::-1, ::-1])
    o, lb = warp((64, 64), dx=3.0)
    np.testing.assert_allclose(o[0, :, :61], img[:, 3:] / 255.0, atol=1e-5)
    np.testing.assert_array_equal(lb[0, :, :61], lbl[:, 3:])
    assert (o[0, :, 61:] == 0).all() and (lb[0, :, 61:] == IGN).all()
    o, lb = warp((64, 64), theta=np.pi / 2)
    ref = np.asarray(Image.fromarray(img).rotate(90, resample=Image.BILINEAR, expand=True))
    np.testing.assert_allclose(o[0], ref / 255.0, atol=1e-4)
    ref_l = np.asarray(Image.fromarray(lbl).rotate(90, resample=Image.NEAREST, expand=True,
                                                   fillcolor=IGN))
    np.testing.assert_array_equal(lb[0], ref_l)
    o, _ = warp((16, 16), crop_u=0.999)  # the last window: offset 64 - 16
    np.testing.assert_allclose(o[0], img[48:, 48:] / 255.0, atol=1e-5)
    h, w = HW[1]  # sample 1 is 40x48: a 64^2 crop reflects the image, ignores the label
    o, lb = warp((64, 64))
    ref = np.pad(ci[1, :h, :w], ((0, 64 - h), (0, 64 - w), (0, 0)), mode="reflect")
    np.testing.assert_allclose(o[1, :62, :62], ref[:62, :62] / 255.0, atol=1e-5)
    assert (lb[1, h:] == IGN).all() and (lb[1, :, w:] == IGN).all()


@pytest.mark.parametrize("warp", ["u8", "float", "shared"])
def test_padding_never_leaks_and_classes_are_real(warp):
    """The same draws on canvases whose padding differs (0 against 199) give
    the same output, and every label is a class of the input or ignore."""
    p = jax_params(5, shared=warp == "shared")
    outs = []
    for poison in (0, 199):
        ci, cl = canvases(seed=5, poison=poison)
        img = ci.astype(np.float32) if warp == "float" else ci
        fn = TG.apply_geometric_shared if warp == "shared" else TG.apply_geometric
        o, lb = fn(torch.from_numpy(img), torch.from_numpy(cl), torch.from_numpy(HW),
                   t(p), CROP, IGN)
        outs.append((o.numpy(), lb.numpy()))
    np.testing.assert_array_equal(outs[0][0], outs[1][0])
    np.testing.assert_array_equal(outs[0][1], outs[1][1])
    assert set(np.unique(outs[0][1]).tolist()) <= set(range(8)) | {IGN}


def test_shared_mode_refuses_what_jax_refuses():
    ci, cl = canvases()
    p = t(jax_params(0))  # per-sample theta: not shared params
    with pytest.raises(ValueError, match="scalar theta"):
        TG.apply_geometric_shared(torch.from_numpy(ci), torch.from_numpy(cl),
                                  torch.from_numpy(HW), p, CROP, IGN)
    with pytest.raises(ValueError, match="uint8"):
        TG.apply_geometric_shared(torch.from_numpy(ci).float(), torch.from_numpy(cl),
                                  torch.from_numpy(HW), t(shared(jax_params(0))), CROP, IGN)


@pytest.mark.parametrize("shared_linear", [False, True])
def test_pipeline_draws_from_the_generator(shared_linear):
    """geometric_pipeline: equal generators give equal crops, another seed
    another crop; shared params are 0-dim."""
    ci, cl = canvases()
    outs = [TG.geometric_pipeline(torch.from_numpy(ci), torch.from_numpy(cl), HW,
                                  np.random.default_rng(s), AUG, CROP, IGN,
                                  shared_linear=shared_linear) for s in (7, 7, 8)]
    np.testing.assert_array_equal(outs[0][0].numpy(), outs[1][0].numpy())
    np.testing.assert_array_equal(outs[0][1].numpy(), outs[1][1].numpy())
    assert not np.array_equal(outs[0][0].numpy(), outs[2][0].numpy())
    p = TG.sample_geometric_params(np.random.default_rng(0), B, AUG, HW,
                                   shared_linear=shared_linear)
    assert p["theta"].shape == p["scale"].shape == (() if shared_linear else (B,))
    assert p["crop_u"].shape == (B, 2) and p["dx"].dtype == np.float32
