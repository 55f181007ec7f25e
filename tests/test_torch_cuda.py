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
