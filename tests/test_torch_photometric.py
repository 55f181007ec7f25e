"""The port's device photometric augmentation (cabinet_tpu_torch.ops.
photometric) against the JAX package's (cabinet_tpu.ops.photometric) on the
CPU: every op and both recipes' chains on the same images, made by numpy
from a seed, with the parameters and the noise that JAX's own key schedule
drew, read out here and passed to the port's ops. Bound: 1e-5 absolute on
[0, 1] values (1e-5 / min(std) after normalisation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.ops import photometric as JP
from cabinet_tpu_torch.ops import photometric as TP

B, H, W = 4, 32, 32
ATOL = 1e-5
MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
AUG = {"hsv_h": 0.01, "hsv_s": 0.4, "hsv_v": 0.3, "mixup": 0.5}


def images(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((B, H, W, 3), dtype=np.float32)
    x[0, :4] = 0.5      # grey pixels: rang == 0, hue 0
    x[1, :2] = 1.0      # saturated white
    x[2, :2, :, 1] = x[2, :2, :, 0]  # r == g == max ties
    return x, rng.integers(0, 8, (B, H, W)).astype(np.int32)


def u(key, shape=(B,), lo=0.0, hi=1.0):
    return np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi)).reshape(B)


# JAX's draws, read out of each op's key schedule (cabinet_tpu/ops/photometric.py)

def d_hsv(key, hgain, sgain, vgain):
    kh, ks, kv = jax.random.split(key, 3)
    return {"r_h": u(kh, (B, 1, 1), -1, 1) * np.float32(hgain),
            "r_s": u(ks, (B, 1, 1), -1, 1) * np.float32(sgain),
            "r_v": u(kv, (B, 1, 1), -1, 1) * np.float32(vgain)}


def d_factor(key, strength=0.5):
    return {"factor": u(key, (B, 1, 1, 1), max(1 - strength, 0.0), 1 + strength)}


def d_gamma(key, rng=(0.8, 1.2), p=0.3):
    kg, kp = jax.random.split(key)
    return {"gamma": u(kg, (B, 1, 1, 1), *rng), "apply": u(kp, (B, 1, 1, 1)) < p}


def d_noise(key, p=0.3):
    kn, kp = jax.random.split(key)
    z = np.array(jax.random.normal(kn, (B, H, W, 3), jnp.float32))
    return {"apply": u(kp, (B, 1, 1, 1)) < p}, z


def d_cutout(key, size=64, p=0.3):
    ky, kx, kp = jax.random.split(key, 3)
    return {"y0": np.asarray(jax.random.randint(ky, (B,), 0, max(H - size, 1))),
            "x0": np.asarray(jax.random.randint(kx, (B,), 0, max(W - size, 1))),
            "apply": u(kp) < p}


def d_mixup(key, p):
    kp, kr = jax.random.split(key)
    return {"apply": u(kp) < p, "r": np.asarray(jax.random.beta(kr, 32.0, 32.0, (B,)))}


def d_aerial(key):
    k = jax.random.split(key, 6)
    noise, z = d_noise(k[3])
    return {"hsv": d_hsv(k[0], AUG["hsv_h"], AUG["hsv_s"], AUG["hsv_v"]),
            "contrast": d_factor(k[1]), "gamma": d_gamma(k[2]), "noise": noise,
            "cutout": d_cutout(k[4]), "mixup": d_mixup(k[5], AUG["mixup"])}, z


def d_street(key):
    k = jax.random.split(key, 6)
    kn, kc = jax.random.split(k[5])
    noise, z = d_noise(kn)
    return {"brightness": d_factor(k[0]), "contrast": d_factor(k[1]),
            "saturation": d_factor(k[2]), "grayscale": {"apply": u(k[3], (B, 1, 1, 1)) < 0.2},
            "gamma": d_gamma(k[4]), "noise": noise, "cutout": d_cutout(kc)}, z


def tt(tree):
    return TP.params_to_device(tree, "cpu")


def close(got, ref, atol=ATOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    err = float(np.abs(got - ref).max())
    assert err <= atol, err


def test_colour_space_matches_jax():
    x, _ = images()
    close(TP.rgb_to_hsv(torch.from_numpy(x)), JP.rgb_to_hsv(jnp.asarray(x)))
    hsv = np.array(JP.rgb_to_hsv(jnp.asarray(x)))
    close(TP.hsv_to_rgb(torch.from_numpy(hsv)), JP.hsv_to_rgb(jnp.asarray(hsv)))
    close(TP.hsv_to_rgb(TP.rgb_to_hsv(torch.from_numpy(x))), x)


# op -> (its draws from JAX's key schedule, the JAX op's keyword arguments)
OPS = {
    "hsv": (lambda k: d_hsv(k, 0.1, 0.4, 0.3), dict(hgain=0.1, sgain=0.4, vgain=0.3)),
    "contrast": (d_factor, dict(strength=0.5)),
    "brightness": (d_factor, dict(strength=0.5)),
    "saturation": (d_factor, dict(strength=0.5)),
    "grayscale": (lambda k: {"apply": u(k, (B, 1, 1, 1)) < 0.5}, dict(p=0.5)),
    "gamma": (lambda k: d_gamma(k, (0.8, 1.2), 0.5), dict(gamma_range=(0.8, 1.2), p=0.5)),
    "noise": (lambda k: d_noise(k, 0.5), dict(sigma=0.03, p=0.5)),
    "cutout": (lambda k: d_cutout(k, 12, 0.5), dict(size=12, p=0.5)),
    "mixup": (lambda k: d_mixup(k, 0.5), dict(p=0.5)),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax_with_jax_draws(name):
    draw, kwargs = OPS[name]
    applied = []
    for key in range(4):
        x, lb = images(key)
        k = jax.random.PRNGKey(key)
        params = draw(k)
        if name == "mixup":
            ref_img, ref_lbl = JP.mixup(jnp.asarray(x), jnp.asarray(lb), k, **kwargs)
            got_img, got_lbl = TP.mixup(torch.from_numpy(x), torch.from_numpy(lb),
                                        **tt(params))
            np.testing.assert_array_equal(got_lbl.numpy(), np.asarray(ref_lbl))
        else:
            ref_img = getattr(JP, f"random_{name}")(jnp.asarray(x), k, **kwargs)
            if name == "noise":
                params, z = params
                got_img = TP.noise(torch.from_numpy(x), torch.from_numpy(z),
                                   **tt(params), sigma=kwargs["sigma"])
            elif name == "cutout":
                got_img = TP.cutout(torch.from_numpy(x), **tt(params), size=kwargs["size"])
            else:
                got_img = getattr(TP, name)(torch.from_numpy(x), **tt(params))
        close(got_img, ref_img)
        if "apply" in params:
            applied += list(np.asarray(params["apply"]).reshape(-1))
    if applied:  # both outcomes of the coin were held
        assert any(applied) and not all(applied)


def test_normalize_matches_jax():
    x, _ = images()
    close(TP.normalize(torch.from_numpy(x), MEAN, STD), JP.normalize(jnp.asarray(x), MEAN, STD),
          ATOL / min(STD))


@pytest.mark.parametrize("recipe", ["aerial", "street"])
@pytest.mark.parametrize("norm", [False, True])
def test_chain_matches_jax_with_jax_draws(recipe, norm):
    mean, std = (MEAN, STD) if norm else (None, None)
    for key in range(3):
        x, lb = images(10 + key)
        k = jax.random.PRNGKey(key)
        if recipe == "aerial":
            params, z = d_aerial(k)
            ref = JP.photometric_pipeline(jnp.asarray(x), jnp.asarray(lb), k, AUG, mean, std)
            got = TP.photometric_pipeline(torch.from_numpy(x), torch.from_numpy(lb),
                                          tt(params), torch.from_numpy(z), mean, std)
        else:
            params, z = d_street(k)
            ref = JP.street_photometric_pipeline(jnp.asarray(x), jnp.asarray(lb), k, None,
                                                 mean, std)
            got = TP.street_photometric_pipeline(torch.from_numpy(x), torch.from_numpy(lb),
                                                 tt(params), torch.from_numpy(z), mean, std)
        close(got[0], ref[0], ATOL / min(STD) if norm else ATOL)
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))


@pytest.mark.parametrize("recipe", ["aerial", "street"])
def test_samplers_give_the_chains_their_params(recipe):
    """The port's samplers draw a tree the chain takes, equal for equal
    generators: dtypes and shapes as the ops want them."""
    rng = np.random.default_rng(3)
    if recipe == "aerial":
        p = TP.sample_photometric(rng, B, H, W, AUG)
        q = TP.sample_photometric(np.random.default_rng(3), B, H, W, AUG)
        chain = TP.photometric_pipeline
    else:
        p = TP.sample_street_photometric(rng, B, H, W)
        q = TP.sample_street_photometric(np.random.default_rng(3), B, H, W)
        chain = TP.street_photometric_pipeline
    for op, d in p.items():
        for name, v in d.items():
            np.testing.assert_array_equal(v, q[op][name])
            assert v.shape == (B,), (op, name, v.shape)
            assert v.dtype in (np.float32, np.bool_, np.int64), (op, name, v.dtype)
    x, lb = images()
    out, lbl = chain(torch.from_numpy(x), torch.from_numpy(lb), tt(p),
                     torch.zeros(B, H, W, 3), MEAN, STD)
    assert out.shape == (B, H, W, 3) and out.dtype == torch.float32 and lbl.shape == (B, H, W)
