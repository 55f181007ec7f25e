"""The kernels' plain versions (K1 attention, K2+K3 decoder tail) and the
tail's BN fold against the JAX package on the CPU, and the wrappers'
CPU routing. The CUDA kernels themselves are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.ops import attention as j_attn
from cabinet_tpu.ops import decoder_tail as j_tail
from cabinet_tpu_torch.ops import attention as t_attn
from cabinet_tpu_torch.ops import decoder_tail as t_tail
from torch_port_utils import assert_close_f32, perturb, port_model

# The decoder tail's widths (128/256/384) are architecture constants, so a
# truncated backbone still gives the kernels their real channel shapes.
CFGS = [[3, 1, 16, 0, 0, 1], [3, 4, 24, 0, 0, 2], [5, 3, 40, 1, 0, 2],
        [5, 6, 96, 1, 1, 2]]


def _qkv(B, N, K, V, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, N, d)).astype(np.float32) for d in (K, K, V)]


def _pallas_attention(q, k, v):
    """The Pallas body `_attention_kernel` itself, in interpret mode."""
    B, N, K = q.shape
    V = v.shape[-1]
    spec = lambda d: pl.BlockSpec((1, N, d), lambda b: (b, 0, 0))  # noqa: E731
    return pl.pallas_call(
        functools.partial(j_attn._attention_kernel, scale=K ** -0.5),
        grid=(B,), in_specs=[spec(K), spec(K), spec(V)], out_specs=spec(V),
        out_shape=jax.ShapeDtypeStruct((B, N, V), v.dtype), interpret=True,
    )(q, k, v)


@pytest.mark.parametrize("shape", [(2, 64, 32, 16), (1, 100, 128, 128)])
def test_attention_plain_matches_jax(shape):
    """f32: the plain version against both JAX forms, the einsum path that
    `fused_global_attention` takes on the CPU and the Pallas body run in
    interpret mode; in f32 the two JAX forms agree to rounding."""
    q, k, v = _qkv(*shape, seed=0)
    got = t_attn.global_attention_plain(*map(torch.from_numpy, (q, k, v))).numpy()
    ref_einsum = j_attn.fused_global_attention(*map(jnp.asarray, (q, k, v)))
    ref_pallas = _pallas_attention(*map(jnp.asarray, (q, k, v)))
    assert_close_f32(got, ref_einsum)
    assert_close_f32(got, ref_pallas)


def test_attention_bf16_probability_dtype_difference():
    """bf16: the plain version keeps f32 probabilities (the Pallas body),
    JAX's einsum path casts them to bf16 first. Against the Pallas body the
    port differs by at most one bf16 rounding of the output (2^-8 of
    its magnitude, taken as 2^-7 of the max); against the einsum path the
    bf16 probabilities add up to 2^-8 relative error per term, which the
    main-path shape keeps under 2e-2 of the max."""
    q, k, v = _qkv(2, 256, 128, 128, seed=1)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (qb, kb, vb))
    got = t_attn.global_attention_plain(tq, tk, tv).float().numpy()
    pallas = np.asarray(_pallas_attention(qb, kb, vb), np.float32)
    einsum = np.asarray(j_attn.fused_global_attention(qb, kb, vb), np.float32)
    top = float(np.abs(pallas).max())
    assert float(np.abs(got - pallas).max()) <= 2 ** -7 * top
    assert float(np.abs(got - einsum).max()) <= 2e-2 * top


def test_attention_past_the_pallas_vmem_budget_matches_einsum_path():
    """At N=1600 (the /32 map of a 1280^2 input), 4*(N^2 + 2NK + 2NV)
    bytes exceed the Pallas wrapper's 12 MB VMEM budget, so JAX takes its
    einsum path with bf16 probabilities on the TPU too. The port's kernel
    path (its plain version on the CPU) keeps f32 probabilities: in bf16 it
    stays within the 2e-2 of max that the main-path shape is held to."""
    B, N, K, V = 1, 1600, 128, 128
    assert 4 * (N * N + 2 * N * K + 2 * N * V) > 12 * 2 ** 20
    q, k, v = _qkv(B, N, K, V, seed=5)
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32)))
                  .to(torch.bfloat16) for a in (qb, kb, vb))
    got = t_attn.fused_global_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16 and got.shape == (B, N, V)
    einsum = np.asarray(j_attn.fused_global_attention(qb, kb, vb), np.float32)
    top = float(np.abs(einsum).max())
    assert float(np.abs(got.float().numpy() - einsum).max()) <= 2e-2 * top


def test_attention_wrapper_takes_plain_version_on_cpu():
    q, k, v = map(torch.from_numpy, _qkv(1, 40, 16, 32, seed=2))
    before = t_attn.fused_global_attention.launches
    got = t_attn.fused_global_attention(q, k, v)
    assert torch.equal(got, t_attn.global_attention_plain(q, k, v))
    assert t_attn.fused_global_attention.launches == before


@pytest.fixture(scope="module")
def tail_setup():
    jm = JaxCABiNet(n_classes=8, mode="large", cfgs=CFGS)
    v = jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)), train=False)
    v = perturb(v, seed=0)
    return jm, v, port_model(v, 8, "large", CFGS)


def test_fold_tail_params_matches_jax(tail_setup):
    _, v, tm = tail_setup
    ref = j_tail.fold_tail_params(v, dtype=jnp.float32)
    got = t_tail.fold_tail_params(tm, dtype=torch.float32)
    assert got["n_classes"] == ref["n_classes"] == 8
    assert got["wc"].shape == (256, 16)  # padded to the 16-wide MMA tile
    for key in ("w1_sp", "w1_cp", "b1", "w_se1", "w_se2", "w3", "b3"):
        assert_close_f32(got[key].numpy(), ref[key], rel=1e-6)
    assert_close_f32(got["wc"][:, :8].numpy(), ref["wc"][:, :8], rel=1e-6)
    assert not got["wc"][:, 8:].any()


@pytest.mark.parametrize("S", [32, 90])
def test_fused_ffm_head_matches_jax_interpret(tail_setup, S):
    """K2 -> SE glue -> K3 (plain versions, through the CPU wrappers)
    against the Pallas kernels in interpret mode: S=32 (256^2 input) and
    S=90 (720^2, row tile 15; 8100 pixels leave a ragged last K2 tile)."""
    _, v, tm = tail_setup
    rng = np.random.default_rng(S)
    fsp = rng.standard_normal((2, S, S, 128)).astype(np.float32)
    fcp = rng.standard_normal((2, S, S, 256)).astype(np.float32)
    ref = j_tail.fused_ffm_head(jnp.asarray(fsp), jnp.asarray(fcp),
                                j_tail.fold_tail_params(v, dtype=jnp.float32),
                                interpret=True)
    folded = t_tail.fold_tail_params(tm, dtype=torch.float32)
    launches = (t_tail.ffm_pointwise.launches, t_tail.head_conv3x3.launches)
    got = t_tail.fused_ffm_head(torch.from_numpy(fsp), torch.from_numpy(fcp),
                                folded)
    assert (t_tail.ffm_pointwise.launches, t_tail.head_conv3x3.launches) == launches
    assert_close_f32(got.numpy(), ref)


def test_ffm_pointwise_plain_tile_sums():
    """The per-tile sums cover FFM_TILE pixels of the flattened image each,
    the ragged last tile included, and add up to the channel totals."""
    rng = np.random.default_rng(4)
    fsp = torch.from_numpy(rng.standard_normal((1, 9, 9, 128)).astype(np.float32))
    fcp = torch.from_numpy(rng.standard_normal((1, 9, 9, 256)).astype(np.float32))
    w_sp = torch.from_numpy(rng.standard_normal((128, 256)).astype(np.float32))
    w_cp = torch.from_numpy(rng.standard_normal((256, 256)).astype(np.float32))
    b1 = torch.from_numpy(rng.standard_normal(256).astype(np.float32))
    feat, sums = t_tail.ffm_pointwise(fsp, fcp, w_sp, w_cp, b1)
    assert sums.shape == (1, 2, 256)  # 81 pixels = 64 + 17
    flat = feat.reshape(1, 81, 256)
    torch.testing.assert_close(sums[0, 0], flat[0, :64].sum(0))
    torch.testing.assert_close(sums[0, 1], flat[0, 64:].sum(0))


def test_fused_tail_supported_matches_jax():
    for s_h, s_w, n in [(128, 128, None), (90, 90, 12), (16, 16, 5),
                        (128, 64, None), (6, 6, None), (272, 272, None),
                        (127, 127, None), (128, 128, 129)]:
        assert (t_tail.fused_tail_supported(s_h, s_w, n)
                == j_tail.fused_tail_supported(s_h, s_w, n))

