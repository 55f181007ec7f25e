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


def _qkv(gen, B, N, K, V):
    return [torch.randn(B, N, d, generator=gen, device="cuda").bfloat16()
            for d in (K, K, V)]


# On the H100's 132 SMs (attn.key_splits): (1, 1024) the main path's batch
# 1, 8 splits; (1, 1000) a ragged last key tile, 8 splits; (1, 1500) 5
# uneven splits of 24 key tiles; (1, 4096) 2 splits of 32; (8, 1024) the
# batch-8 shape, 1 split, no merge; (2, 100, 32, 64) the 64-column
# instance, 2 splits; (3, 257, 128, 256) two passes of 128 value columns;
# K of 80, 192 and 256: q and k padded to 2, 3 and 4 panels of 64 columns,
# with V of 48 (a partial 64-column instance) and 256 (two passes).
@pytest.mark.parametrize("B,N,K,V", [
    (1, 1, 16, 16), (2, 100, 32, 64), (1, 1024, 128, 128), (3, 257, 128, 256),
    (1, 1000, 128, 128), (1, 1500, 128, 128), (1, 4096, 128, 128),
    (8, 1024, 128, 128), (1, 70, 80, 48), (1, 300, 192, 128), (2, 130, 256, 256)])
def test_attention_kernel_matches_plain(gen, B, N, K, V):
    q, k, v = _qkv(gen, B, N, K, V)
    before = attn.fused_global_attention.launches
    got = attn.fused_global_attention(q, k, v)
    torch.cuda.synchronize()
    assert attn.fused_global_attention.launches == before + 1
    _close(got, attn.global_attention_plain(q, k, v), ONE_ROUNDING)


@pytest.mark.parametrize("B,N", [(1, 1024), (8, 1024)])
def test_attention_kernel_is_deterministic(gen, B, N):
    """The splits merge in a fixed order, with no atomics: two launches on
    the same inputs give the same bits, split (B=1) or not (B=8)."""
    q, k, v = _qkv(gen, B, N, 128, 128)
    first = attn.fused_global_attention(q, k, v)
    second = attn.fused_global_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


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


# (1, 7, 300): 2100 pixels, so the last 128-pixel block's second warpgroup
# has no pixel and n_tiles = 33 is odd; (1, 90, 90): 64 blocks, a ragged
# last one; (8, 128, 128): the batch-8 main path's shape.
@pytest.mark.parametrize("B,H,W", [(1, 9, 9), (2, 8, 12), (1, 128, 128),
                                   (1, 7, 300), (1, 90, 90), (8, 128, 128)])
def test_ffm_pointwise_kernel_matches_plain(gen, B, H, W):
    o = _tail(gen, B, H, W, 8)
    args = (o["fsp"], o["fcp"], o["w1_sp"], o["w1_cp"], o["b1"])
    before = dt.ffm_pointwise.launches
    feat, sums = dt.ffm_pointwise(*args)
    torch.cuda.synchronize()
    assert dt.ffm_pointwise.launches == before + 1
    feat_ref, sums_ref = dt.ffm_pointwise_plain(*args)
    assert sums.shape == sums_ref.shape
    _close(feat, feat_ref, ONE_ROUNDING)
    _close(sums, sums_ref, 1e-4)


def test_ffm_pointwise_kernel_is_deterministic(gen):
    """The sums are reduced in a fixed order, with no atomics: two launches
    on the same inputs give the same feat and sums, to the bit."""
    o = _tail(gen, 1, 7, 300, 8)
    args = (o["fsp"], o["fcp"], o["w1_sp"], o["w1_cp"], o["b1"])
    (f1, s1), (f2, s2) = dt.ffm_pointwise(*args), dt.ffm_pointwise(*args)
    torch.cuda.synchronize()
    assert torch.equal(f1.view(torch.int16), f2.view(torch.int16))
    assert torch.equal(s1.view(torch.int32), s2.view(torch.int32))


def _head_args(gen, B, H, W, n, scale_span=1.0):
    """K3's operands; the SE scale is drawn from [1, 1 + scale_span)."""
    o = _tail(gen, B, H, W, n)
    feat = torch.relu(torch.randn(B, H, W, 256, generator=gen, device="cuda")).bfloat16()
    scale = 1 + scale_span * torch.rand(B, 256, generator=gen, device="cuda")
    return (feat, scale, o["w3"], o["b3"], o["wc"], n)


# (1, 7, 300): 2100 pixels, so the last 128-pixel tile is ragged and tiles
# straddle image rows; (8, 128, 128): the batch-8 main path's shape; a
# scale in [1, 5): feat * bf16(scale) rounds to bf16 in most lanes, once,
# from the exact f32 product, in the kernel as in the plain version.
@pytest.mark.parametrize("B,H,W,n,scale_span", [
    (1, 9, 9, 1, 1.0), (2, 8, 12, 16, 1.0), (1, 90, 90, 12, 1.0),
    (1, 16, 16, 128, 1.0), (1, 7, 300, 8, 1.0), (8, 128, 128, 8, 1.0),
    (2, 33, 40, 8, 4.0)])
def test_head_conv3x3_kernel_matches_plain(gen, B, H, W, n, scale_span):
    args = _head_args(gen, B, H, W, n, scale_span)
    got = dt.head_conv3x3(*args)
    torch.cuda.synchronize()
    assert got.shape == (B, H, W, n)
    _close(got, dt.head_conv3x3_plain(*args), TWO_ROUNDINGS)


def test_head_conv3x3_kernel_is_deterministic(gen):
    """No atomics and no order between blocks: two launches on the same
    inputs give the same bits."""
    args = _head_args(gen, 2, 64, 64, 8)
    first = dt.head_conv3x3(*args)
    second = dt.head_conv3x3(*args)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


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


# (3, 257, 128, 256): a ragged query and key tile, 5 splits, two passes of
# 128 value columns; (2, 64, 128, 128): the f32 MscEval's 256^2 crops, one
# tile; (1, 1500, 128, 128): 5 uneven splits of 24 key tiles; K of 80 (rows
# of q and k padded to 96 words in shared memory) with V of 48 (a partial
# pass); K=V=256 (the largest shared-memory use).
@pytest.mark.parametrize("B,N,K,V", [
    (3, 257, 128, 256), (2, 64, 128, 128), (1, 1500, 128, 128), (1, 70, 80, 48),
    (2, 130, 256, 256)])
def test_attention_f32_kernel_matches_plain_at_other_widths(gen, B, N, K, V):
    q, k = (torch.randn(B, N, K, generator=gen, device="cuda") for _ in range(2))
    v = torch.randn(B, N, V, generator=gen, device="cuda")
    before = attn.fused_global_attention.launches_f32
    got = attn.fused_global_attention(q, k, v)
    torch.cuda.synchronize()
    assert attn.fused_global_attention.launches_f32 == before + 1
    _close(got, attn.global_attention_plain(q, k, v), 1e-5)


def test_attention_f32_kernel_is_deterministic(gen):
    """At B=1, N=1024 the f32 kernel splits the keys (8 ranges on 132 SMs)
    and merges them in split order: two launches give the same bits."""
    q, k, v = (torch.randn(1, 1024, 128, generator=gen, device="cuda")
               for _ in range(3))
    first = attn.fused_global_attention(q, k, v)
    second = attn.fused_global_attention(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


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
    """K4 against its plain version at shapes its 64-column, 32-row strips
    do not divide: the same bf16-rounded input, f32 sums over 27, 9 and 16
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


# Output grids (H/2, W/2) at the strips' edges: exactly one strip (32, 64);
# one row and one column past it (33, 65); one short (31, 63); fewer rows
# than an 8-row step, three strips across (5, 129); a ragged last step (14,
# 64); and an image of 2 x 2 pixels, whose 24 bytes put the second image
# of the batch off a 16-byte boundary. All of these take 32-row strips; at
# batch 8 the launcher takes 64-row strips once the grid has two blocks an
# SM (132 SMs): a 720^2 input (360 = 5 x 64 + 40 rows, 40 columns in the
# last strip) and (150, 650) (a last strip of 22 rows, 2 steps and 6 rows,
# and 10 columns).
@pytest.mark.parametrize("shape", [(1, 64, 128, 3), (1, 66, 130, 3), (2, 62, 126, 3),
                                   (1, 10, 258, 3), (2, 28, 128, 3), (3, 2, 2, 3),
                                   (8, 720, 720, 3), (8, 300, 1300, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_block0_kernel_matches_plain_at_strip_edges(gen, shape, dtype):
    from cabinet_tpu_torch.ops import early_stage as es

    x = torch.randn(*shape, generator=gen, device="cuda").to(dtype)
    w = _early_weights(gen)
    got = es.fused_stem_block0(x, *w, out_dtype=dtype)
    torch.cuda.synchronize()
    ref = es.stem_block0_plain(x, *w, out_dtype=dtype)
    _close(got, ref, 1e-5 if dtype == torch.float32 else ONE_ROUNDING)


def test_stem_block0_kernel_is_deterministic(gen):
    from cabinet_tpu_torch.ops import early_stage as es

    x = torch.randn(2, 130, 258, 3, generator=gen, device="cuda")
    w = _early_weights(gen)
    first = es.fused_stem_block0(x, *w)
    second = es.fused_stem_block0(x, *w)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))


def test_stem_block0_kernel_takes_packed_views_as_they_are(gen):
    """The weights as `pack_stem_block0_weights` views (the form the fused
    forwards hold them in) launch with no packing of their own, and give
    the bits that the same weights packed by the wrapper give."""
    from cabinet_tpu_torch.ops import early_stage as es

    x = torch.randn(2, 66, 130, 3, generator=gen, device="cuda")
    w = _early_weights(gen)
    views = es.pack_stem_block0_weights(*w)
    es.fused_stem_block0(x, *views)
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_stats()["allocation.all.allocated"]
    from_views = es.fused_stem_block0(x, *views)
    # the output alone: no packed buffer was allocated
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocated + 1
    from_six = es.fused_stem_block0(x, *w)
    torch.cuda.synchronize()
    assert torch.equal(from_views.view(torch.int32), from_six.view(torch.int32))


def test_stem_block0_weights_are_stream_ordered_in_a_graph(gen):
    """The launcher copies the weights to the kernel's constant block on the
    launch's stream: two launches with different weights captured in one
    CUDA graph each see their own."""
    from cabinet_tpu_torch.ops import early_stage as es

    x = torch.randn(1, 64, 128, 3, generator=gen, device="cuda")
    w1, w2 = _early_weights(gen), _early_weights(gen)
    es.fused_stem_block0(x, *w1)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out1 = es.fused_stem_block0(x, *w1)
        out2 = es.fused_stem_block0(x, *w2)
    graph.replay()
    torch.cuda.synchronize()
    _close(out1, es.stem_block0_plain(x, *w1), 1e-5)
    _close(out2, es.stem_block0_plain(x, *w2), 1e-5)


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


def test_staged_evaluate_on_cuda_equals_the_serial_sum(gen):
    """`MscEval.evaluate` on CUDA, which copies each batch on a side stream
    while the previous one runs, gives the confusion matrix that
    `hist_batch` gives batch by batch, bit for bit, through the kernel
    path (bf16, K1-K3), with bucket padding on some batches; and a loader
    that fails mid-way raises and leaves no staging thread."""
    import threading

    import numpy as np

    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.models.cabinet import CABiNet

    torch.manual_seed(0)
    fwd = make_eval_forward(CABiNet(5, "large"), 256, "cuda", torch.bfloat16,
                            use_pallas=True, fused_tail="true")
    ev = MscEval(fwd, 5, scales=(0.75, 1.0), flip=True, cropsize=256,
                 compute_dtype=torch.bfloat16, pad_to=(320, 384), device="cuda")
    rng = np.random.default_rng(1)
    batches = []
    for i in range(5):
        h, w = (320, 384) if i % 2 else (300, 360)
        labels = rng.integers(0, 5, (2, h, w))
        labels[:, :8] = 255
        batches.append((rng.normal(size=(2, h, w, 3)).astype(np.float32), labels))
    serial = sum(ev.hist_batch(None, x, y) for x, y in batches)
    before = dt.head_conv3x3.launches
    res = ev.evaluate(None, batches)
    assert dt.head_conv3x3.launches > before
    np.testing.assert_array_equal(res["confusion_matrix"], serial.astype(np.float64))
    assert res["timing"]["frames"] == 10

    def failing():
        yield batches[0]
        raise OSError("disk went away")

    with pytest.raises(OSError, match="disk went away"):
        ev.evaluate(None, failing())
    assert not [t for t in threading.enumerate() if t.name == "MscEval-stage"]


def test_kernel_wrappers_refuse_autograd_on_cuda(gen):
    """On CUDA tensors too, each wrapper (K1, K2+K3, K4) raises under
    autograd on an input that requires grad, before launching anything,
    and launches under no_grad."""
    from cabinet_tpu_torch.ops import early_stage as es

    q, k, v = _qkv(gen, 1, 64, 32, 32)
    bf = torch.bfloat16

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device="cuda").to(dtype)

    folded = {"w1_sp": r(128, 256, dtype=bf), "w1_cp": r(256, 256, dtype=bf),
              "b1": r(256), "w_se1": r(256, 64), "w_se2": r(64, 256),
              "w3": r(9, 256, 256, dtype=bf), "b3": r(256), "wc": r(256, 16, dtype=bf),
              "n_classes": 8}
    calls = [
        (attn.fused_global_attention, "launches",
         lambda x: attn.fused_global_attention(x, k, v), q),
        (dt.ffm_pointwise, "launches",
         lambda x: dt.fused_ffm_head(x, r(1, 8, 8, 256, dtype=bf), folded),
         r(1, 8, 8, 128, dtype=bf)),
        (es.fused_stem_block0, "launches",
         lambda x: es.fused_stem_block0(x, r(16, 27), r(16), r(3, 3, 16), r(16),
                                        r(16, 16), r(16)), r(1, 8, 8, 3)),
    ]
    for fn, attr, call, x in calls:
        before = getattr(fn, attr)
        with pytest.raises(RuntimeError, match="no backward"):
            call(x.clone().requires_grad_())
        assert getattr(fn, attr) == before
        with torch.no_grad():
            out = call(x.clone().requires_grad_())
        torch.cuda.synchronize()
        assert getattr(fn, attr) == before + 1 and out.grad_fn is None


# ---------------------------------------------------------------------------
# device augmentation (ops/geometric.py, ops/photometric.py) and remat
# ---------------------------------------------------------------------------

AUG_ATOL = 1e-5      # [0, 1] values; / min(std) after the normalisation
LABEL_SHARE = 0.999  # labels off a rounding tie agree exactly


def _aug_batch(B=4, S=256, seed=0):
    import numpy as np

    rng = np.random.default_rng(seed)
    hw = np.array([[S, S], [S // 2 + 3, S - 5], [S - 9, S // 2 + 1], [S, S - 17]],
                  np.int32)[:B]
    ci = np.zeros((B, S, S, 3), np.uint8)
    cl = np.full((B, S, S), 255, np.uint8)
    for b, (h, w) in enumerate(hw):
        ci[b, :h, :w] = rng.integers(0, 256, (h, w, 3))
        cl[b, :h, :w] = rng.integers(0, 19, (h, w))
    return ci, cl, hw


def _near_tie(*coords, tie=1e-3):
    out = torch.zeros(coords[0].shape, dtype=torch.bool)
    for c in coords:
        c = c.double().cpu()
        out |= (c - c.floor() - 0.5).abs() < tie
    return out


@pytest.mark.parametrize("warp", ["u8", "float", "shared"])
@pytest.mark.parametrize("recipe", ["aerial", "street"])
def test_device_augmentation_on_cuda_matches_cpu(gen, warp, recipe):
    """The warp and the photometric chain on the card against the same on
    the CPU, from the same host-drawn params and the same noise."""
    import numpy as np

    from cabinet_tpu_torch.ops import geometric as G
    from cabinet_tpu_torch.ops import photometric as P

    ci, cl, hw = _aug_batch()
    crop = (128, 128)
    rng = np.random.default_rng(1)
    aug = ({"degrees": 10.0, "translate": 0.05, "scale": 0.3, "fliplr": 0.5,
            "flipud": 0.2, "mixup": 0.5} if recipe == "aerial" else
           {"fliplr": 0.5, "scale_choices": (0.75, 1.0, 1.25, 1.5, 1.75, 2.0)})
    geo = G.sample_geometric_params(rng, 4, aug, hw, shared_linear=warp == "shared")
    pho = (P.sample_photometric(rng, 4, *crop, aug) if recipe == "aerial"
           else P.sample_street_photometric(rng, 4, *crop))
    chain = P.photometric_pipeline if recipe == "aerial" else P.street_photometric_pipeline
    z = torch.randn((4, *crop, 3), generator=torch.Generator().manual_seed(2))
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    outs = {}
    for dev in ("cpu", "cuda"):
        img = torch.from_numpy(ci if warp != "float" else ci.astype(np.float32)).to(dev)
        fn = G.apply_geometric_shared if warp == "shared" else G.apply_geometric
        x, y = fn(img, torch.from_numpy(cl).to(dev), torch.from_numpy(hw).to(dev),
                  P.params_to_device(geo, dev), crop, 255)
        x, y = chain(x, y, P.params_to_device(pho, dev), z.to(dev), mean, std)
        outs[dev] = (x.cpu(), y.cpu())
    err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    assert err <= AUG_ATOL / min(std), err
    differ = outs["cuda"][1] != outs["cpu"][1]
    assert float(differ.float().mean()) <= 1.0 - LABEL_SHARE
    tp = P.params_to_device(geo, "cpu")
    if warp == "shared":
        c = G.shared_coords(torch.from_numpy(hw), tp, crop, ci.shape[1])
        ties = _near_tie(c["xf"], c["yf"])
    else:
        c = G.geometric_coords(torch.from_numpy(hw), tp, crop)
        ties = _near_tie(c["xl"], c["yl"], c["xc"], c["yc"])
    assert not bool((differ & ~ties).any())


def test_remat_step_on_cuda_updates_statistics_once(gen):
    """A train step of a small CABiNet on the card with remat=True against
    the step without remat: the BatchNorm statistics counted once and equal
    to 1e-6, the loss to 1e-4, each gradient to 1e-4 of its largest value
    plus 1e-6 of the step's largest gradient (cuDNN's backward adds in
    another order in each run, and a gradient that is zero in exact
    arithmetic, the bias of a BN behind a conv and a train-mode BN, is
    rounding alone)."""
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import GroupedSGD

    cfgs = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2],
            [5, 6, 96, 1, 1, 2]]
    torch.manual_seed(0)
    sd = CABiNet(8, "small", cfgs=cfgs).state_dict()
    x = torch.randn(2, 128, 128, 3, generator=gen, device="cuda")
    y = torch.randint(0, 8, (2, 128, 128), generator=gen, device="cuda")
    out = {}
    for remat in (False, True):
        model = CABiNet(8, "small", cfgs=cfgs, remat=remat)
        model.load_state_dict(sd)
        model.cuda()
        ts = T.create_train_state(model, GroupedSGD(model, lr0=0.1, max_iter=4))
        _, loss = T.make_train_step(n_min=2 * 128 * 128 // 16, accum_steps=2)(ts, x, y)
        out[remat] = (float(loss), {n: p.grad.clone() for n, p in model.named_parameters()},
                      {k: t.clone() for k, t in model.state_dict().items()})
    (l0, g0, s0), (l1, g1, s1) = out[False], out[True]
    assert abs(l1 - l0) <= 1e-4 * abs(l0)
    largest = max(float(g.abs().max()) for g in g0.values())
    for k in g0:
        err = float((g1[k] - g0[k]).abs().max())
        assert err <= 1e-4 * float(g0[k].abs().max()) + 1e-6 * largest, (k, err)
    for k in s0:
        if k.endswith("num_batches_tracked"):
            assert int(s1[k]) == int(s0[k]) == 1, k
        elif k.endswith(("running_mean", "running_var")):
            assert float((s1[k] - s0[k]).abs().max()) <= 1e-6, k


def test_train_main_with_device_augs_on_cuda(gen, tmp_path):
    """cli/train.py main on the card over a tiny Cityscapes tree with the
    shared warp, the street chain and remat: finite losses, the device
    augmentation timed by CUDA events."""
    import json
    import math

    import numpy as np

    from cabinet_tpu_torch.cli.train import main
    from cabinet_tpu_torch.data.decode import save_png

    rng = np.random.default_rng(3)
    for split in ("train", "val"):
        for i in range(4):
            (tmp_path / "leftImg8bit" / split / "c").mkdir(parents=True, exist_ok=True)
            (tmp_path / "gtFine" / split / "c").mkdir(parents=True, exist_ok=True)
            save_png(tmp_path / "leftImg8bit" / split / "c" / f"c_{i}_0_leftImg8bit.png",
                     rng.integers(0, 256, (96, 160, 3), dtype=np.uint8))
            save_png(tmp_path / "gtFine" / split / "c" / f"c_{i}_0_gtFine_labelIds.png",
                     rng.choice(np.array([7, 8, 11, 0], np.uint8), (96, 160)))
    exp = tmp_path / "exp"
    res = main(["model=mobilenetv3_small", "model.cfgs=[[3,1,16,1,0,2],[5,6,96,1,1,2]]",
                "dataset=cityscapes", f"dataset.dataset_path={tmp_path}",
                "dataset.cropsize=[64,64]", "training_config.batch_size=2",
                "training_config.epochs=2", "training_config.num_workers=2",
                f"training_config.experiments_path={exp}", "training_config.log_iter=1",
                "validation_config.eval_scales=[1.0]", "validation_config.flip=false",
                "runtime.device_geometric=shared", "runtime.remat=true",
                f"+runtime.decode_cache={tmp_path / 'cache'}", "--device", "cuda"])
    lines = [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()]
    assert all(math.isfinite(ln["train_loss"]) for ln in lines if "epoch" in ln)
    assert res["timing"]["device_aug_seconds"] > 0 and res["timing"]["optimizer_steps"] == 4
    assert len(list((tmp_path / "cache" / "cityscapes_train").iterdir())) == 4


def _seeded_large(path, seed=0):
    from cabinet_tpu_torch.models.cabinet import CABiNet

    torch.manual_seed(seed)
    model = CABiNet(8, "large")
    with torch.no_grad():
        model.ab.a2block.gamma.fill_(0.5)
        torch.nn.init.normal_(model.ab.a2block.global_attn.project_out.weight, 0, 0.05)
    torch.save(model.state_dict(), path)
    return path


def test_predict_batch_copies_once_each_way_on_cuda(gen, tmp_path):
    """`Segmenter.predict_batch` (bf16, batch 8, K1-K4) makes one
    host-to-device copy (the frames' bytes at their own size, pinned; the
    resize runs on the card) and one device-to-host copy (the uint8 class
    IDs of the real rows) per batch, as the profiler's memcpy records
    show."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from cabinet_tpu_torch.cli.infer import Segmenter

    seg = Segmenter(str(_seeded_large(tmp_path / "l.pth")), "uavid", imgsz=256,
                    dtype_name="bfloat16", batch=8, device="cuda")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, (300, 200, 3), dtype=np.uint8) for _ in range(5)]
    seg.predict_batch(frames)  # first call: allocations, cuDNN plans
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        masks = seg.predict_batch(frames)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()]
    assert sum("Memcpy HtoD" in n for n in names) == 1, sorted(set(names))
    assert sum("Memcpy DtoH" in n for n in names) == 1, sorted(set(names))
    assert [m.shape for m in masks] == [(300, 200)] * 5
    assert all(m.dtype == np.uint8 for m in masks)


@pytest.mark.parametrize("hw", [(1080, 1920), (2160, 3840), (700, 1000), (200, 300)])
def test_frame_resize_on_cuda_follows_pil_bilinear(gen, hw):
    """The request path's resize on the card (`resize_frame`, each pass in
    f32 rounded half up) against PIL's BILINEAR on the uint8 frame, down
    and up to 1024^2: within one level on every pixel and equal on >= 99%
    of them, as tests/test_torch_slice.py holds the CPU's uint8 form; and
    within one level of the CPU's form."""
    import numpy as np
    from PIL import Image

    from cabinet_tpu_torch.cli.infer import resize_frame

    rgb = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3), dtype=np.uint8)
    pil = np.asarray(Image.fromarray(rgb).resize((1024, 1024), Image.BILINEAR))
    got = resize_frame(torch.from_numpy(rgb).cuda(), 1024)
    assert got.dtype == torch.uint8 and got.shape == (1024, 1024, 3)
    got = got.cpu().numpy().astype(np.int64)
    diff = np.abs(got - pil)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    cpu = resize_frame(torch.from_numpy(rgb), 1024).numpy().astype(np.int64)
    assert np.abs(got - cpu).max() <= 1


def test_batch_step_on_cuda_keeps_each_frame_on_its_row(gen):
    """On the card, `BatchStep` packs frames of mixed sizes into one pinned
    staging buffer (grown and reused across calls of other sizes) and
    answers each frame with its own row, equal to `resize_frame` of that
    frame alone on the card."""
    import numpy as np

    from cabinet_tpu_torch.cli.infer import BatchStep, resize_frame

    step = BatchStep(lambda x: x[..., 2], "cuda", 256)
    rng = np.random.default_rng(3)
    for sizes in ([(1080, 1920), (256, 256), (1080, 1920), (300, 200)],
                  [(2160, 3840)] * 2, [(256, 256)]):
        frames = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in sizes]
        out = step(frames, 4)
        assert out.shape == (len(frames), 256, 256)
        for f, row in zip(frames, out):
            want = resize_frame(torch.from_numpy(f).cuda(), 256)[..., 2].cpu().numpy()
            np.testing.assert_array_equal(row, want)


def test_serve_route_on_cuda_launches_k1_to_k4(gen, tmp_path):
    """The checkpoint server in bf16 at max_batch 8 answers concurrent PNG
    requests through K1, K2, K3 and K4, and its masks agree with the plain
    path's argmax on the same resized frames on >= 99% of pixels."""
    import threading
    import urllib.request
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from cabinet_tpu_torch.cli.infer import load_state_dict, resize_frame
    from cabinet_tpu_torch.cli.serve import _Engine, make_server
    from cabinet_tpu_torch.data.datasets import DATASET_REGISTRY
    from cabinet_tpu_torch.data.decode import decode_png, encode_png, png_mask
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.fused import make_fused_tail_apply
    from cabinet_tpu_torch.ops.early_stage import fused_stem_block0

    ckpt = _seeded_large(tmp_path / "l.pth")
    engine = _Engine(None, str(ckpt), "uavid", "large", 256, "bfloat16",
                     max_batch=8, deadline_ms=20.0, device="cuda")
    assert engine.meta["route"] == "fused_tail_early"
    counters = [(attn.fused_global_attention, "launches"), (dt.ffm_pointwise, "launches"),
                (dt.head_conv3x3, "launches"), (fused_stem_block0, "launches")]
    before = [getattr(f, a) for f, a in counters]
    srv = make_server(engine, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}/segment"
    rng = np.random.default_rng(1)
    frames = [rng.integers(0, 256, (270, 480, 3), dtype=np.uint8) for _ in range(8)]

    def one(rgb):
        req = urllib.request.Request(url, data=encode_png(rgb), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            return png_mask(decode_png(r.read()))

    try:
        with ThreadPoolExecutor(8) as pool:
            masks = list(pool.map(one, frames))
    finally:
        srv.shutdown()
        srv.server_close()
        engine.batcher.close()
    after = [getattr(f, a) for f, a in counters]
    assert all(a > b for a, b in zip(after, before)), (before, after)

    plain_model = CABiNet(8, "large", attention="plain")
    plain_model.load_state_dict(load_state_dict(ckpt, plain_model), strict=True)
    plain = make_fused_tail_apply(plain_model, "cuda", torch.bfloat16, kernels=False,
                                  use_early=True)
    stats = DATASET_REGISTRY["uavid"]
    mean = torch.tensor(stats.MEAN, device="cuda")
    std = torch.tensor(stats.STD, device="cuda")
    for rgb, mask in zip(frames, masks):
        x = resize_frame(torch.from_numpy(rgb).cuda(), 256)
        with torch.no_grad():
            logits = plain(((x.float() / 255.0 - mean) / std)[None])[0][0]
        ref = torch.nn.functional.interpolate(
            logits.argmax(-1).to(torch.uint8)[None, None], size=(270, 480),
            mode="nearest-exact")[0, 0].cpu().numpy()
        assert mask.shape == (270, 480)
        assert (mask == ref).mean() >= 0.99


def test_cuda_export_roundtrip_is_bit_equal(gen, tmp_path, capsys):
    """cli.export on the card (Large, bf16, symbolic batch, --check) and the
    loaded CUDA program at batch 1 and 3 against the live serving module,
    bit for bit with cuDNN's autotuner off; the CUDA artifact refuses to
    load for the CPU."""
    import numpy as np

    from cabinet_tpu_torch.cli.export import main
    from cabinet_tpu_torch.cli.infer import load_state_dict
    from cabinet_tpu_torch.export import load_artifact, make_serving_fn
    from cabinet_tpu_torch.models.cabinet import CABiNet

    ckpt = _seeded_large(tmp_path / "l.pth")
    out = tmp_path / "art"
    main(["--checkpoint", str(ckpt), "--dataset", "uavid", "--out", str(out),
          "--imgsz", "256", "--batch", "b", "--dtype", "bfloat16", "--check"])
    assert "round-trip check passed" in capsys.readouterr().out
    serve, meta = load_artifact(out, "cuda")
    assert meta["device"] == "cuda" and meta["batch"] == "b"
    model = CABiNet(8, "large", attention="einsum")
    model.load_state_dict(load_state_dict(ckpt, model), strict=True)
    live = make_serving_fn(model, meta["mean"], meta["std"], torch.bfloat16).cuda()
    torch.backends.cudnn.benchmark = False
    for b in (1, 3):
        x = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, 256, 256, 3), dtype=np.uint8)).cuda()
        with torch.no_grad():
            assert torch.equal(serve(x), live(x))
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        load_artifact(out, "cpu")


def _large_site_shapes(size):
    """{site module name: (conv, its input's (C, H, W))} of every int8dw
    site of a seeded CABiNet-Large in a size^2 forward (CPU, f32)."""
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.quant import quantization_sites

    torch.manual_seed(0)
    model = CABiNet(8, "large").eval()
    sites = quantization_sites(model, quantize_depthwise=True)
    shapes = {}

    def shape_of(name):
        def hook(mod, args):
            shapes[name] = tuple(args[0].shape[1:])
        return hook

    hooks = [m.register_forward_pre_hook(shape_of(n)) for n, m in sites.items()]
    with torch.no_grad():
        model(torch.zeros(1, 3, size, size))
    for h in hooks:
        h.remove()
    return {n: (m, shapes[n]) for n, m in sites.items()}


@pytest.mark.parametrize("batch", [1, 8])
def test_int8_site_sums_on_cuda_equal_cpu(gen, batch):
    """Every int8dw site of Large at its 1024^2 input shape: the same int8
    operands give the same int32 sums on the card (`torch._int_mm`; the
    FFM's 1x1 maps through the 16 padded rows; the depthwise f32
    convolution of integers) as on the CPU, and the same bf16 input the
    same int8 input and output, bit for bit."""
    import copy

    from cabinet_tpu_torch.quant import Int8Site

    sites = _large_site_shapes(1024)
    assert len(sites) == 64
    for name, (conv, shape) in sites.items():
        x_d = torch.randn((batch, *shape), generator=gen, device="cuda").bfloat16()
        x = x_d.cpu()
        site = Int8Site(conv, float(x.float().abs().max()) / 127.0)
        site_d = copy.deepcopy(site).cuda()
        xq, xq_d = site.quantize_input(x), site_d.quantize_input(x_d)
        assert torch.equal(xq_d.cpu(), xq), name
        assert torch.equal(site_d.sums(xq_d).cpu(), site.sums(xq)), name
        assert torch.equal(site_d(x_d).cpu(), site(x)), name


@pytest.mark.parametrize("cout", [184, 200])
def test_int8_site_takes_many_rows_on_cuda(gen, cout):
    """The 1x1 sites 80 -> 184 and 80 -> 200 of Large's block 7-9 at 32
    tiles of 64x64 (131072 GEMM rows, as a bf16 evaluation's tile batch
    gives them): cuBLASLt refuses those widths unpadded from 65536 rows;
    the padded weight rows give the CPU's sums."""
    import copy

    from cabinet_tpu_torch.quant import Int8Site

    torch.manual_seed(cout)
    conv = torch.nn.Conv2d(80, cout, 1, bias=False)
    x_d = torch.randn((32, 80, 64, 64), generator=gen, device="cuda").bfloat16()
    x = x_d.cpu()
    site = Int8Site(conv, float(x.float().abs().max()) / 127.0)
    site_d = copy.deepcopy(site).cuda()
    xq = site.quantize_input(x)
    assert torch.equal(site_d.sums(xq.cuda()).cpu(), site.sums(xq))


def test_cuda_int8dw_export_roundtrip_is_bit_equal(gen, tmp_path, capsys):
    """cli.export --quantize int8dw --calib on the card (Large, bf16,
    symbolic batch, --check), and the loaded program at batch 1 and 3
    against the live quantized serving module calibrated the same way."""
    import numpy as np

    from cabinet_tpu_torch.cli.export import calibrate, main
    from cabinet_tpu_torch.cli.infer import load_state_dict
    from cabinet_tpu_torch.data.decode import save_png
    from cabinet_tpu_torch.export import load_artifact, make_serving_fn
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.quant import make_quantized_apply

    ckpt = _seeded_large(tmp_path / "l.pth")
    rng = np.random.default_rng(2)
    frames = [tmp_path / f"calib_{i}.png" for i in range(2)]
    for f in frames:
        save_png(f, rng.integers(0, 256, (300, 400, 3), dtype=np.uint8))
    out = tmp_path / "art"
    main(["--checkpoint", str(ckpt), "--dataset", "uavid", "--out", str(out),
          "--imgsz", "256", "--batch", "b", "--dtype", "bfloat16", "--check",
          "--quantize", "int8dw", "--calib", str(tmp_path / "calib_*.png")])
    printed = capsys.readouterr().out
    assert "calibrated 64 conv sites on 2 frames" in printed
    assert "round-trip check passed" in printed
    serve, meta = load_artifact(out, "cuda")
    assert meta["quantize"] == "int8dw"
    model = CABiNet(8, "large", attention="einsum")
    model.load_state_dict(load_state_dict(ckpt, model), strict=True)
    scales = calibrate(model, [str(f) for f in frames], meta["mean"], meta["std"], 256,
                       torch.bfloat16, torch.device("cuda"), depthwise=True)
    live = make_serving_fn(make_quantized_apply(model, scales), meta["mean"], meta["std"],
                           torch.bfloat16).cuda()
    torch.backends.cudnn.benchmark = False
    for b in (1, 3):
        x = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, 256, 256, 3), dtype=np.uint8)).cuda()
        with torch.no_grad():
            assert torch.equal(serve(x), live(x))


# ---------------------------------------------------------------------------
# YOLO-sem (no kernel: cuDNN and cuBLAS under the port's own modules)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["n", "x"])
def test_yolosem_f32_forward_on_cuda_matches_cpu(gen, variant):
    """The f32 forward of a seeded YOLOSem on the card (TF32 off) against
    the same on the CPU at 128^2, batch 2: logits and aux within 1e-4 of
    max |cpu|."""
    from cabinet_tpu_torch.models.yolosem import YOLOSem

    torch.manual_seed(0)
    model = YOLOSem(8, variant).eval()
    x = torch.randn(2, 3, 128, 128, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        ref = model(x)
        got = model.cuda()(x.cuda())
    for g, r in zip(got, ref):
        _close(g.cpu(), r, 1e-4)


def _uavid_tree(root, n=4, hw=(72, 120)):
    import numpy as np

    from cabinet_tpu_torch.data.decode import save_png

    rng = np.random.default_rng(0)
    for split in ("train", "val"):
        (root / "images" / split).mkdir(parents=True)
        (root / "masks" / split).mkdir(parents=True)
        for i in range(n):
            save_png(root / "images" / split / f"s{i}.png",
                     rng.integers(0, 256, (*hw, 3), dtype=np.uint8))
            save_png(root / "masks" / split / f"s{i}.png",
                     rng.integers(0, 8, hw, dtype=np.uint8))
    return root


def test_train_yolo_main_on_cuda(gen, tmp_path):
    """cli/train_yolo.py main on the card (bf16, accum 2, close_mosaic,
    device augs): finite losses, a resume one epoch on, and mode=val on
    `final` at the native 72x120."""
    import math

    from cabinet_tpu_torch.cli.train_yolo import main

    data = _uavid_tree(tmp_path / "data")
    exp = tmp_path / "exp"
    argv = ["dataset=uavid", f"dataset.dataset_path={data}", "training_config.imgsz=64",
            "training_config.batch_size=2", "training_config.nbs=4",
            "training_config.num_workers=2", "augmentation.close_mosaic=1",
            "validation_config.num_workers=0", "+runtime.device_augs=true",
            f"training_config.experiments_path={exp}"]
    res = main(argv + ["training_config.epochs=2", "--device", "cuda"])
    assert len(res["losses"]) == 2 and all(math.isfinite(v) for v in res["losses"])
    res = main(argv + ["training_config.epochs=3", "training_config.resume=true",
                       "--device", "cuda"])
    assert res["timing"]["micro_steps"] == 2 and math.isfinite(res["losses"][0])
    val = main(argv + ["mode=val", f"weights={exp / 'final'}", "--device", "cuda"])
    assert 0.0 <= val["mIoU"] <= 1.0


def test_yolosem_cuda_export_roundtrip_is_bit_equal(gen, tmp_path, capsys):
    """cli.export --family yolosem on the card (yolo26n-sem, bf16, symbolic
    batch, --check), and the loaded program at batch 1 and 3 against the
    live serving module."""
    import numpy as np

    from cabinet_tpu_torch.cli.export import main
    from cabinet_tpu_torch.export import load_artifact, make_serving_fn
    from cabinet_tpu_torch.models.yolosem import YOLOSem

    torch.manual_seed(0)
    model = YOLOSem(8, "n")
    torch.save(model.state_dict(), tmp_path / "final.pth")
    out = tmp_path / "art"
    main(["--family", "yolosem", "--variant", "n", "--checkpoint", str(tmp_path / "final.pth"),
          "--dataset", "uavid", "--out", str(out), "--imgsz", "256", "--batch", "b",
          "--dtype", "bfloat16", "--check"])
    assert "round-trip check passed" in capsys.readouterr().out
    serve, meta = load_artifact(out, "cuda")
    assert (meta["family"], meta["variant"]) == ("yolosem", "n")
    live = make_serving_fn(model, meta["mean"], meta["std"], torch.bfloat16).cuda()
    torch.backends.cudnn.benchmark = False
    for b in (1, 3):
        x = torch.from_numpy(np.random.default_rng(b).integers(
            0, 256, (b, 256, 256, 3), dtype=np.uint8)).cuda()
        with torch.no_grad():
            assert torch.equal(serve(x), live(x))


# ---------------------------------------------------------------------------
# The tools and data parallelism on the card
# ---------------------------------------------------------------------------

_DP_RANK = """
import sys, torch
from cabinet_tpu_torch.core import mesh
from cabinet_tpu_torch.models.layers import batch_norm
from cabinet_tpu_torch.train.losses import ohem_cross_entropy
device = mesh.setup("cuda", "gloo", timeout_s=60)
rank, ranks = mesh.world()
inp = torch.load(sys.argv[1])
bn = batch_norm(inp["x"].shape[1]).to(device)
bn.load_state_dict(inp["state"])
x = inp["x"][rank::ranks].to(device).requires_grad_(True)
with torch.autocast("cuda", dtype=torch.bfloat16):
    y = bn(x.bfloat16())
(y.float() * inp["g"][rank::ranks].to(device)).sum().backward()
logits = inp["logits"][rank::ranks].to(device).requires_grad_(True)
loss = ohem_cross_entropy(logits, inp["labels"][rank::ranks].to(device), inp["n_min"],
                          method="bisect", share=True)
loss.backward()
torch.save({"y": y.detach().cpu(), "x_grad": x.grad.cpu(), "state": {k: v.cpu() for k, v in
            bn.state_dict().items()}, "loss": loss.cpu(), "l_grad": logits.grad.cpu()},
           sys.argv[1] + f".{rank}")
mesh.teardown()
"""


def _two_ranks_on_one_card(script, arg, timeout=180):
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    repo = str(Path(__file__).resolve().parents[1])
    procs = []
    try:
        for r in range(2):
            env = dict(os.environ, RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                       LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       PYTHONPATH=repo)
            procs.append(subprocess.Popen([sys.executable, "-c", script, arg], env=env,
                                          cwd=repo, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]


def test_dp_batch_norm_and_ohem_on_one_card_gloo(gen, tmp_path):
    """Two ranks sharing the card under gloo (CUDA tensors): BatchNorm
    under bf16 autocast (statistics in f32) and OHEM (bisect) over the
    global batch against one process on the concatenated batch: the
    outputs within one bf16 rounding, the input gradients (through the
    bf16 cast back to f32) within two, the running statistics and OHEM's
    gradients within the f32 bound, the losses' shares summing to the loss
    within 1e-5, the two ranks' statistics bit-equal."""
    from cabinet_tpu_torch.models.layers import batch_norm
    from cabinet_tpu_torch.train.losses import ohem_cross_entropy

    x = torch.randn(4, 16, 24, 20, generator=gen, device="cuda").cpu() * 3 + 2
    g = torch.randn(4, 16, 24, 20, generator=gen, device="cuda").cpu()
    logits = torch.randn(4, 6, 24, 20, generator=gen, device="cuda").cpu() * 2
    labels = torch.randint(0, 6, (4, 24, 20), generator=gen, device="cuda").cpu()
    labels[0, :12] = 255
    bn = batch_norm(16)
    state = {k: v.clone() for k, v in bn.state_dict().items()}
    n_min = 4 * 24 * 20 // 16
    path = tmp_path / "inputs.pt"
    torch.save({"x": x, "g": g, "state": state, "logits": logits, "labels": labels,
                "n_min": n_min}, path)
    _two_ranks_on_one_card(_DP_RANK, str(path))
    got = [torch.load(f"{path}.{r}") for r in range(2)]

    ref = bn.cuda().train()
    xr = x.cuda().requires_grad_(True)
    with torch.autocast("cuda", dtype=torch.bfloat16):
        y = ref(xr.bfloat16())
    (y.float() * g.cuda()).sum().backward()
    lr = logits.cuda().requires_grad_(True)
    loss = ohem_cross_entropy(lr, labels.cuda(), n_min, method="bisect")
    loss.backward()

    def inter(key):
        out = torch.empty_like(got[0][key].repeat(2, *[1] * (got[0][key].dim() - 1)))
        out[0::2], out[1::2] = got[0][key], got[1][key]
        return out
    _close(inter("y"), y.detach().cpu(), ONE_ROUNDING)
    _close(inter("x_grad"), xr.grad.cpu(), TWO_ROUNDINGS)
    for k in ("running_mean", "running_var"):
        _close(got[0]["state"][k], ref.state_dict()[k].cpu(), 2e-4)
        assert torch.equal(got[0]["state"][k], got[1]["state"][k])
    total = float(got[0]["loss"]) + float(got[1]["loss"])
    assert abs(total - float(loss)) <= 1e-5 * abs(float(loss))
    _close(inter("l_grad"), lr.grad.cpu(), 2e-4)


def test_tools_profiler_counts_the_kernels_flops_on_cuda(gen, tmp_path):
    """PerformanceProfiler on the bf16 fused-tail forward of CABiNet-Large
    at 512^2, batch 2 (K1-K3 launched): its FLOPs equal FlopCounterMode's
    count of the plain route (the einsum attention and the model's own
    tail), the latency keys are JAX's, the memory peak is measured, and
    the trace holds device ops and a busy share."""
    from torch.utils.flop_counter import FlopCounterMode

    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.fused import make_fused_tail_apply
    from cabinet_tpu_torch.utils.profiler import PerformanceProfiler

    torch.manual_seed(0)
    model = CABiNet(8, "large", attention="kernel")
    x = torch.randn(2, 512, 512, 3, generator=gen, device="cuda")
    fwd = make_fused_tail_apply(model, "cuda", torch.bfloat16)
    prof = PerformanceProfiler(warmup=1, repeats=2, chain=2)
    res = prof.run_full_benchmark(lambda v, img: fwd(img), model, x)
    assert set(prof.last_kernel_flops) == {"attention", "ffm_pointwise", "head_conv3x3"}
    plain = CABiNet(8, "large", attention="einsum").cuda().eval()
    plain.load_state_dict(model.state_dict())
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        plain(x.permute(0, 3, 1, 2))
    assert res["flops"]["flops"] == counter.get_total_flops()
    assert sorted(res["latency"]) == ["fps", "max_ms", "mean_ms", "median_ms", "min_ms",
                                      "std_ms"]
    assert res["memory"]["temp_size_mb"] > 0 and res["memory"]["generated_code_size_mb"] > 0
    with torch.no_grad(), prof.trace(str(tmp_path)) as p:
        fwd(x)
    brk = prof.device_breakdown(p)
    assert brk["device_ops"] > 0 and 0 < brk["busy_share"] <= 1 and brk["top_ops"]
    assert (tmp_path / "trace.pt.trace.json").is_file()


def test_tools_visualize_main_on_cuda(gen, tmp_path):
    """cli/visualize.py main on the card (bf16, use_pallas: K1-K3 on the
    tile forwards) over a tiny UAVid tree: the four PNGs of each sample,
    the pred PNG in the palette's colours."""
    import numpy as np

    from cabinet_tpu_torch.cli.visualize import main
    from cabinet_tpu_torch.data.decode import open_rgb
    from cabinet_tpu_torch.data.palettes import PALETTES, trainid_palette

    data = _uavid_tree(tmp_path / "data")
    ckpt = _seeded_large(tmp_path / "ck.pth")
    before = attn.fused_global_attention.launches
    out = main([f"checkpoint_path={ckpt}", "dataset=uavid", f"dataset.dataset_path={data}",
                "dataset.cropsize=[64,64]", "validation_config.eval_scales=[1.0]",
                "runtime.compute_dtype=bfloat16", "runtime.use_pallas=true",
                "+num_samples=2", f"+output_dir={tmp_path / 'viz'}", "--device", "cuda"])
    assert attn.fused_global_attention.launches > before
    names = sorted(p.name for p in out.iterdir())
    assert names == sorted(f"{i:04d}_{k}.png" for i in range(2)
                           for k in ("input", "pred", "overlay", "gt"))
    pred = open_rgb(out / "0000_pred.png")
    colours = {tuple(c) for c in trainid_palette(PALETTES["uavid"]).tolist()}
    assert {tuple(c) for c in pred.reshape(-1, 3).tolist()} <= colours
    assert np.isfinite(pred).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tp_bounded_conv_matches_conv2d_on_cuda(gen, dtype):
    """`models/tensor_parallel.py:bounded_conv2d` (the sharded convs with
    cuDNN off, forward and backward) against F.conv2d with cuDNN: f32, and
    under bf16 autocast (its output and gradients in autocast's dtypes)."""
    import torch.nn.functional as F

    from cabinet_tpu_torch.models.tensor_parallel import bounded_conv2d

    x = torch.randn(2, 16, 33, 20, generator=gen, device="cuda").requires_grad_(True)
    w = (0.1 * torch.randn(8, 16, 3, 3, generator=gen, device="cuda")).requires_grad_(True)
    b = torch.randn(8, generator=gen, device="cuda").requires_grad_(True)
    g = torch.randn(2, 8, 17, 10, generator=gen, device="cuda")
    outs = []
    for conv in (bounded_conv2d, F.conv2d):
        with torch.autocast("cuda", dtype=dtype, enabled=dtype != torch.float32):
            y = conv(x, w, b, (2, 2), (1, 1), (1, 1), 1)
        grads = torch.autograd.grad((y.float() * g).sum(), (x, w, b))
        outs.append((y.detach(), *grads))
    rel = 2e-4 if dtype == torch.float32 else TWO_ROUNDINGS
    for got, ref in zip(*outs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        _close(got, ref, rel)
    assert torch.backends.cudnn.enabled  # the flag comes back


def test_sp_striped_ops_on_one_rank_on_cuda(gen):
    """The stripe collectives on CUDA tensors with one data rank (the
    all-reduces are the values themselves): a striped 5x5 s2 conv is the
    padded conv, `resize_rows` from a whole source the bilinear resize."""
    from torch import nn

    from cabinet_tpu_torch.core import mesh
    from cabinet_tpu_torch.models import spatial_parallel as sp
    from cabinet_tpu_torch.models.cab import resize_bilinear

    m = mesh.Mesh(1, 1, 0)
    conv = nn.Conv2d(4, 6, 5, 2, 2).cuda()
    x = torch.randn(2, 4, 16, 12, generator=gen, device="cuda")
    ref = conv(x)
    conv.__class__ = sp._striped_class(nn.Conv2d)
    conv.sp_mesh, conv.sp_on = m, True
    _close(conv(x), ref, 2e-6)
    src = torch.randn(1, 3, 8, 6, generator=gen, device="cuda")
    _close(sp.resize_rows(src, 0, 8, (64, 48), (0, 64)), resize_bilinear(src, (64, 48)), 2e-6)
