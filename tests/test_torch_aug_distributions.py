"""The port's augmentation samplers (numpy, on the host) against the JAX
package's draws, by distribution: two-sample Kolmogorov-Smirnov tests at
n >= 2000 and alpha = 1e-6 for every continuous parameter, two-proportion
bounds (5 sigma) for the flips, the apply coins and the street scale
choices. Each KS test carries a negative control: the port's draw with its
range halved must fail the same bound, as in
tests/unit/test_aug_distributions.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cabinet_tpu.ops.geometric import sample_geometric_params as j_sample_geometric
from cabinet_tpu_torch.ops import geometric as TG
from cabinet_tpu_torch.ops import photometric as TP

N = 4096
SRC = 48
AUG = {"degrees": 10.0, "translate": 0.05, "scale": 0.3, "fliplr": 0.5, "flipud": 0.2,
       "hsv_h": 0.01, "hsv_s": 0.4, "hsv_v": 0.3, "mixup": 0.1}
STREET = {"fliplr": 0.5, "flipud": 0.0, "degrees": 0.0, "translate": 0.0,
          "scale_choices": (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)}


def ks2(a, b) -> float:
    a = np.sort(np.asarray(a, np.float64))
    b = np.sort(np.asarray(b, np.float64))
    both = np.concatenate([a, b])
    return float(np.max(np.abs(np.searchsorted(a, both, side="right") / len(a)
                               - np.searchsorted(b, both, side="right") / len(b))))


def ks_crit(n: int, m: int, alpha: float = 1e-6) -> float:
    return float(np.sqrt(-0.5 * np.log(alpha / 2.0)) * np.sqrt((n + m) / (n * m)))


def rate_bound(p: float, n: int, m: int, sigmas: float = 5.0) -> float:
    return sigmas * float(np.sqrt(p * (1 - p) * (1.0 / n + 1.0 / m)))


def assert_ks(port, ref, halved):
    """port ~ ref within the bound; the halved-range draw is caught."""
    crit = ks_crit(len(port), len(ref))
    assert ks2(port, ref) < crit, (ks2(port, ref), crit)
    assert ks2(halved, ref) > crit, (ks2(halved, ref), crit)


def assert_rate(port, ref, p):
    port, ref = np.asarray(port, np.float64), np.asarray(ref, np.float64)
    bound = rate_bound(p, port.size, ref.size)
    assert abs(port.mean() - ref.mean()) < bound, (port.mean(), ref.mean())
    assert abs(port.mean() / 2 - ref.mean()) > bound  # a halved rate is caught


@pytest.fixture(scope="module")
def geometric_draws():
    hw = np.tile(np.array([[SRC, SRC]], np.int32), (N, 1))
    port = TG.sample_geometric_params(np.random.default_rng(21), N, AUG, hw)
    ref = jax.jit(lambda k: j_sample_geometric(k, N, AUG, jnp.asarray(hw)))(
        jax.random.PRNGKey(3))
    return port, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("name", ["theta", "scale", "dx", "dy", "crop_x", "crop_y"])
def test_ks_geometric_exact(geometric_draws, name):
    port, ref = geometric_draws
    if name.startswith("crop"):
        i = int(name == "crop_y")
        p, r = port["crop_u"][:, i], ref["crop_u"][:, i]
        assert_ks(p, r, p / 2)
    elif name == "scale":
        assert_ks(port["scale"], ref["scale"], 1.0 + (port["scale"] - 1.0) / 2)
    else:
        assert_ks(port[name], ref[name], port[name] / 2)


@pytest.mark.parametrize("name,p", [("flip_h", 0.5), ("flip_v", 0.2)])
def test_flip_rates(geometric_draws, name, p):
    port, ref = geometric_draws
    assert_rate(port[name], ref[name], p)


def test_ks_geometric_shared():
    """One (theta, scale) per batch: their marginals over many batches, and
    the per-sample draws beside them, as JAX's shared sampler's."""
    K, Bs = 2048, 2
    hw = np.tile(np.array([[SRC, SRC]], np.int32), (Bs, 1))
    draws = [TG.sample_geometric_params(np.random.default_rng([5, i]), Bs, AUG, hw,
                                        shared_linear=True) for i in range(K)]
    ref = jax.jit(jax.vmap(lambda k: j_sample_geometric(
        k, Bs, AUG, jnp.asarray(hw), shared_linear=True)))(
        jax.random.split(jax.random.PRNGKey(4), K))
    theta = np.array([d["theta"] for d in draws])
    scale = np.array([d["scale"] for d in draws])
    assert all(d["theta"].shape == () for d in draws)
    assert_ks(theta, np.asarray(ref["theta"]), theta / 2)
    assert_ks(scale, np.asarray(ref["scale"]), 1.0 + (scale - 1.0) / 2)
    dx = np.concatenate([d["dx"] for d in draws])
    assert_ks(dx, np.asarray(ref["dx"]).reshape(-1), dx / 2)


def test_street_scale_choice_rates():
    """Each of the six scales at 1/6, as JAX's `jax.random.choice`."""
    n = 6000
    hw = np.tile(np.array([[SRC, SRC]], np.int32), (n, 1))
    port = TG.sample_geometric_params(np.random.default_rng(9), n, STREET, hw)["scale"]
    ref = np.asarray(j_sample_geometric(jax.random.PRNGKey(9), n, STREET,
                                        jnp.asarray(hw))["scale"])
    assert set(np.unique(port).tolist()) == set(np.float32(STREET["scale_choices"]).tolist())
    for c in STREET["scale_choices"]:
        assert_rate(port == np.float32(c), ref == np.float32(c), 1 / 6)


def _u(key, lo=0.0, hi=1.0):
    return np.asarray(jax.random.uniform(key, (N,), minval=lo, maxval=hi))


@pytest.fixture(scope="module")
def photometric_draws():
    """The port's aerial and street samplers at N, and JAX's draws for the
    same parameters as its ops make them (cabinet_tpu/ops/photometric.py)."""
    size, hc = 64, 128
    port = {**TP.sample_photometric(np.random.default_rng(30), N, hc, hc, AUG),
            **{f"street_{k}": v for k, v in
               TP.sample_street_photometric(np.random.default_rng(31), N, hc, hc).items()}}
    k = iter(jax.random.split(jax.random.PRNGKey(32), 16))
    ref = {
        "r_h": _u(next(k), -1, 1) * np.float32(AUG["hsv_h"]),
        "r_s": _u(next(k), -1, 1) * np.float32(AUG["hsv_s"]),
        "r_v": _u(next(k), -1, 1) * np.float32(AUG["hsv_v"]),
        "factor": _u(next(k), 0.5, 1.5),
        "gamma": _u(next(k), 0.8, 1.2),
        "coin": _u(next(k)),
        "y0": np.asarray(jax.random.randint(next(k), (N,), 0, max(hc - size, 1))),
        "r": np.asarray(jax.random.beta(next(k), 32.0, 32.0, (N,))),
    }
    return port, ref


KS_PHOTOMETRIC = [
    ("hsv", "r_h", "r_h"), ("hsv", "r_s", "r_s"), ("hsv", "r_v", "r_v"),
    ("contrast", "factor", "factor"), ("street_brightness", "factor", "factor"),
    ("street_saturation", "factor", "factor"), ("gamma", "gamma", "gamma"),
    ("street_gamma", "gamma", "gamma"), ("cutout", "y0", "y0"), ("cutout", "x0", "y0"),
    ("mixup", "r", "r"),
]


@pytest.mark.parametrize("op,name,ref_name", KS_PHOTOMETRIC,
                         ids=[f"{o}-{n}" for o, n, _ in KS_PHOTOMETRIC])
def test_ks_photometric(photometric_draws, op, name, ref_name):
    port, ref = photometric_draws
    p = port[op][name].astype(np.float64)
    centre = {"factor": 1.0, "gamma": 1.0, "r": 0.5}.get(name, 0.0)
    assert_ks(p, ref[ref_name], centre + (p - centre) / 2)


COINS = [("gamma", 0.3), ("noise", 0.3), ("cutout", 0.3), ("mixup", AUG["mixup"]),
         ("street_grayscale", 0.2), ("street_gamma", 0.3), ("street_noise", 0.3),
         ("street_cutout", 0.3)]


@pytest.mark.parametrize("op,p", COINS, ids=[o for o, _ in COINS])
def test_apply_rates(photometric_draws, op, p):
    port, ref = photometric_draws
    assert_rate(port[op]["apply"], ref["coin"] < p, p)
