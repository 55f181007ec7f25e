"""The CUDA kernels against their plain versions on the card, at edge
shapes the main path does not reach (ragged query and pixel tiles,
non-square grids, 1 and 128 classes). Skipped without a CUDA device.

Imports nothing of JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from cabinet_tpu_torch.ops import attention as attn
from cabinet_tpu_torch.ops import decoder_tail as dt

pytestmark = pytest.mark.cuda

# max abs error over max |plain|: one bf16 rounding (2^-7 of the largest
# value) for K1 and K2 outputs, two for K3 (relu output and logits).
ONE_ROUNDING = 2 ** -7
TWO_ROUNDINGS = 2 ** -6


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _close(got, ref, rel):
    err = float((got.float() - ref.float()).abs().max())
    bound = rel * float(ref.float().abs().max())
    assert err <= bound, f"max abs err {err} > bound {bound}"


@pytest.mark.parametrize("B,N,K,V", [(1, 1, 16, 16), (2, 100, 32, 64),
                                     (1, 1024, 128, 128), (3, 257, 128, 256)])
def test_attention_kernel_matches_plain(gen, B, N, K, V):
    q = torch.randn(B, N, K, generator=gen, device="cuda").bfloat16()
    k = torch.randn(B, N, K, generator=gen, device="cuda").bfloat16()
    v = torch.randn(B, N, V, generator=gen, device="cuda").bfloat16()
    before = attn.fused_global_attention.launches
    got = attn.fused_global_attention(q, k, v)
    torch.cuda.synchronize()
    assert attn.fused_global_attention.launches == before + 1
    _close(got, attn.global_attention_plain(q, k, v), ONE_ROUNDING)


def test_attention_kernel_rejects_what_it_does_not_take(gen):
    q = torch.randn(1, 64, 128, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        attn.fused_global_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError, match="share a dtype"):
        attn.fused_global_attention(q, q, q.bfloat16())
    qb = q.bfloat16()
    strided = torch.randn(1, 128, 64, generator=gen, device="cuda").bfloat16()
    with pytest.raises(ValueError, match="contiguous"):
        attn.fused_global_attention(qb, qb, strided.transpose(1, 2))
    with pytest.raises(ValueError, match="multiples of 16"):
        attn.fused_global_attention(qb[..., :24].contiguous(),
                                    qb[..., :24].contiguous(), qb)
    shifted = torch.empty(64 * 128 + 1, dtype=torch.bfloat16,
                          device="cuda")[1:].view(1, 64, 128)
    with pytest.raises(ValueError, match="16-byte"):
        attn.fused_global_attention(shifted, qb, qb)


def _tail(gen, B, H, W, n_classes):
    def rnd(*shape, std=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    n_pad = -(-n_classes // 16) * 16
    wc = torch.zeros(256, n_pad, device="cuda")
    wc[:, :n_classes] = rnd(256, n_classes, std=256 ** -0.5)
    return dict(fsp=torch.relu(rnd(B, H, W, 128)).bfloat16(),
                fcp=rnd(B, H, W, 256).bfloat16(),
                w1_sp=rnd(128, 256, std=384 ** -0.5).bfloat16(),
                w1_cp=rnd(256, 256, std=384 ** -0.5).bfloat16(),
                b1=rnd(256, std=0.1), scale=1 + torch.rand(B, 256, device="cuda"),
                w3=rnd(9, 256, 256, std=2304 ** -0.5).bfloat16(),
                b3=rnd(256, std=0.1), wc=wc.bfloat16())


@pytest.mark.parametrize("B,H,W", [(1, 9, 9), (2, 8, 12), (1, 128, 128)])
def test_ffm_pointwise_kernel_matches_plain(gen, B, H, W):
    o = _tail(gen, B, H, W, 8)
    args = (o["fsp"], o["fcp"], o["w1_sp"], o["w1_cp"], o["b1"])
    feat, sums = dt.ffm_pointwise(*args)
    torch.cuda.synchronize()
    feat_ref, sums_ref = dt.ffm_pointwise_plain(*args)
    assert sums.shape == sums_ref.shape
    _close(feat, feat_ref, ONE_ROUNDING)
    _close(sums, sums_ref, 1e-4)


@pytest.mark.parametrize("B,H,W,n", [(1, 9, 9, 1), (2, 8, 12, 16),
                                     (1, 90, 90, 12), (1, 16, 16, 128)])
def test_head_conv3x3_kernel_matches_plain(gen, B, H, W, n):
    o = _tail(gen, B, H, W, n)
    feat = torch.relu(torch.randn(B, H, W, 256, generator=gen, device="cuda")).bfloat16()
    args = (feat, o["scale"], o["w3"], o["b3"], o["wc"], n)
    got = dt.head_conv3x3(*args)
    torch.cuda.synchronize()
    assert got.shape == (B, H, W, n)
    _close(got, dt.head_conv3x3_plain(*args), TWO_ROUNDINGS)


def test_fused_tail_forward_kernel_path_matches_plain(gen):
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.fused import make_fused_tail_apply

    cfgs = [[3, 1, 16, 0, 0, 1], [3, 4, 24, 0, 0, 2], [5, 3, 40, 1, 0, 2],
            [5, 6, 96, 1, 1, 2]]
    models = []
    for attention in ("kernel", "plain"):
        torch.manual_seed(0)
        m = CABiNet(8, "large", cfgs=cfgs, attention=attention)
        with torch.no_grad():
            m.ab.a2block.gamma.fill_(0.5)
            torch.nn.init.normal_(m.ab.a2block.global_attn.project_out.weight, 0, 0.05)
        models.append(m)
    kern = make_fused_tail_apply(models[0], "cuda")
    plain = make_fused_tail_apply(models[1], "cuda", kernels=False)
    images = torch.rand(2, 256, 256, 3, generator=gen, device="cuda")
    counts = (attn.fused_global_attention.launches, dt.ffm_pointwise.launches,
              dt.head_conv3x3.launches)
    got, _ = kern(images)
    assert (attn.fused_global_attention.launches, dt.ffm_pointwise.launches,
            dt.head_conv3x3.launches) == tuple(c + 1 for c in counts)
    ref, _ = plain(images)
    _close(got, ref, 2 ** -5)


def test_segmenter_float32_with_attention_kernel(gen, tmp_path):
    """float32 `Segmenter` with the attention kernel: at batch 8 it routes
    Large through K4 and the f32 K1 (`make_fused_apply`), and its masks
    agree with `kernel_attn=False` (the einsum path, same K4) on every pixel
    whose margin exceeds twice the f32 bound of 1e-4 of max|logit|."""
    from cabinet_tpu_torch.cli.infer import Segmenter
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.ops.early_stage import fused_stem_block0

    torch.manual_seed(0)
    model = CABiNet(8, "large")
    with torch.no_grad():
        model.ab.a2block.gamma.fill_(0.5)
        torch.nn.init.normal_(model.ab.a2block.global_attn.project_out.weight, 0, 0.05)
    ckpt = tmp_path / "large.pth"
    torch.save(model.state_dict(), ckpt)
    kw = dict(mode="large", imgsz=128, dtype_name="float32", batch=8, device="cuda")
    kern = Segmenter(str(ckpt), "uavid", **kw)
    ein = Segmenter(str(ckpt), "uavid", kernel_attn=False, **kw)
    assert kern.route == ein.route == "fused_early"
    x = torch.stack([kern._preprocess(torch.randint(
        0, 256, (128, 128, 3), dtype=torch.uint8,
        generator=torch.Generator().manual_seed(i)).numpy()) for i in range(8)])
    counts = (attn.fused_global_attention.launches_f32, fused_stem_block0.launches)
    got = kern._logits(x).float()
    assert (attn.fused_global_attention.launches_f32,
            fused_stem_block0.launches) == (counts[0] + 1, counts[1] + 1)
    ref = ein._logits(x).float()
    assert attn.fused_global_attention.launches_f32 == counts[0] + 1
    bound = 1e-4 * float(ref.abs().max())
    assert float((got - ref).abs().max()) <= bound
    top2 = ref.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * bound
    assert bool((got.argmax(-1) == ref.argmax(-1))[sure].all())


@pytest.mark.parametrize("B,N", [(1, 1), (2, 100), (1, 1024), (8, 1024)])
def test_attention_f32_kernel_matches_plain(gen, B, N):
    """The f32 K1 against its plain version in f32 with TF32 off: f32 sums
    in another order over N keys, within 1e-5 of max|plain|."""
    q, k, v = (torch.randn(B, N, 128, generator=gen, device="cuda")
               for _ in range(3))
    before = (attn.fused_global_attention.launches,
              attn.fused_global_attention.launches_f32)
    got = attn.fused_global_attention(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32
    assert (attn.fused_global_attention.launches,
            attn.fused_global_attention.launches_f32) == (before[0], before[1] + 1)
    _close(got, attn.global_attention_plain(q, k, v), 1e-5)


def _early_weights(gen):
    def rnd(*shape, std):
        return torch.randn(*shape, generator=gen, device="cuda") * std

    return (rnd(16, 27, std=0.2), rnd(16, std=0.1), rnd(3, 3, 16, std=0.2),
            rnd(16, std=0.1), rnd(16, 16, std=0.2), rnd(16, std=0.1))


@pytest.mark.parametrize("shape", [(1, 66, 98, 3), (2, 720, 1280, 3),
                                   (1, 2, 2, 3), (3, 34, 70, 3)])
@pytest.mark.parametrize("x_dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_stem_block0_kernel_matches_plain(gen, shape, x_dtype, out_dtype):
    """K4 against its plain version at tile edges the 16x32 output tiles do
    not divide: the same bf16-rounded input, f32 sums over 27, 9 and 16
    terms in another order; within 1e-5 of max|plain| for f32 planes and
    one bf16 rounding (2^-7) for bf16 planes."""
    from cabinet_tpu_torch.ops import early_stage as es

    x = torch.randn(*shape, generator=gen, device="cuda").to(x_dtype)
    w = _early_weights(gen)
    before = es.fused_stem_block0.launches
    got = es.fused_stem_block0(x, *w, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert es.fused_stem_block0.launches == before + 1
    B, H, W, _ = shape
    assert got.shape == (B, 16, H // 2, W // 2) and got.dtype == out_dtype
    assert got.is_contiguous(memory_format=torch.channels_last)
    ref = es.stem_block0_plain(x, *w, out_dtype=out_dtype)
    _close(got, ref, 1e-5 if out_dtype == torch.float32 else ONE_ROUNDING)


def test_stem_block0_kernel_rejects_what_it_does_not_take(gen):
    from cabinet_tpu_torch.ops import early_stage as es

    w = _early_weights(gen)
    x = torch.randn(1, 64, 64, 3, generator=gen, device="cuda")
    with pytest.raises(ValueError, match="even"):
        es.fused_stem_block0(x[:, :63].contiguous(), *w)
    with pytest.raises(ValueError, match="contiguous"):
        es.fused_stem_block0(x.transpose(1, 2), *w)
    with pytest.raises(ValueError, match="must be one of"):
        es.fused_stem_block0(x.half(), *w)
    with pytest.raises(ValueError, match="wstem"):
        es.fused_stem_block0(x, w[0].bfloat16(), *w[1:])
    with pytest.raises(ValueError, match="NHWC"):
        es.fused_stem_block0(x.permute(0, 3, 1, 2).contiguous(), *w)
    shifted = torch.empty(64 * 64 * 3 + 4, device="cuda")[1:-3].view(1, 64, 64, 3)
    with pytest.raises(ValueError, match="16-byte"):
        es.fused_stem_block0(shifted, *w)


def test_msc_eval_kernel_path_matches_plain_path(gen):
    """bf16 `MscEval` through `make_eval_forward(fused_tail="true",
    use_pallas=True)` (K1-K3 on every tile forward) against the same
    protocol on the plain path (attention and tail plain versions), on the
    trained Large fixture: crop 256, scales (0.75, 1.0), flip, a 256x384
    palette image of 64-pixel blocks. Argmax agreement >= 99.9%."""
    import numpy as np

    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.fused import make_fused_tail_apply
    from cabinet_tpu_torch.utils.convert import state_dict_from_jax

    fixture = (__import__("pathlib").Path(__file__).resolve().parent
               / "fixtures" / "miou_large_cabinet_v1.npz")
    with np.load(fixture) as data:
        flat = {k: data[k] for k in data.files}

    def model(attention):
        m = CABiNet(5, "large", attention=attention)
        m.load_state_dict(state_dict_from_jax(flat, m.cfgs), strict=True)
        return m

    palette = np.array([[220, 40, 40], [40, 220, 40], [40, 40, 220],
                        [220, 220, 40], [140, 40, 220]], np.float32) / 255.0
    rng = np.random.default_rng(0)
    labels = np.kron(rng.integers(0, 5, (4, 6)), np.ones((64, 64), np.int64))
    image = (palette[labels] + rng.normal(0, 0.02, (*labels.shape, 3)))[None]
    protocol = dict(n_classes=5, scales=(0.75, 1.0), flip=True, cropsize=256,
                    compute_dtype=torch.bfloat16, device="cuda")
    fwd = make_eval_forward(model("plain"), 256, "cuda", torch.bfloat16,
                            use_pallas=True, fused_tail="true")
    plain = make_fused_tail_apply(model("plain"), "cuda", torch.bfloat16,
                                  kernels=False)
    before = dt.head_conv3x3.launches
    got = MscEval(fwd, **protocol).prob_batch(None, image)
    assert dt.head_conv3x3.launches > before
    ref = MscEval(lambda v, x: plain(x), **protocol).prob_batch(None, image)
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.999
