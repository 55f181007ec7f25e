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
    with pytest.raises(ValueError, match="bfloat16"):
        attn.fused_global_attention(q, q, q)
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


def test_segmenter_float32_with_attention_kernel_raises(gen, tmp_path):
    """The attention kernel takes bf16: float32 on CUDA asks for the einsum
    path explicitly instead of leaving the kernel quietly."""
    from cabinet_tpu_torch.cli.infer import Segmenter
    from cabinet_tpu_torch.models.cabinet import CABiNet

    ckpt = tmp_path / "small.pth"
    torch.save(CABiNet(8, "small").state_dict(), ckpt)
    with pytest.raises(ValueError, match="kernel_attn=False"):
        Segmenter(str(ckpt), "uavid", mode="small", imgsz=64,
                  dtype_name="float32", device="cuda")
    seg = Segmenter(str(ckpt), "uavid", mode="small", imgsz=64,
                    dtype_name="float32", kernel_attn=False, device="cuda")
    assert seg.predict(torch.randint(0, 256, (64, 64, 3), dtype=torch.uint8,
                                     generator=torch.Generator().manual_seed(0)
                                     ).numpy()).shape == (64, 64)
