"""The port's main path as a whole against the JAX package on the CPU: the
weight bridge, the fused-tail forward, and `Segmenter.predict`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.models.fused import make_fused_tail_apply as j_fused_tail
from cabinet_tpu.utils.torch_convert import flax_to_torch
from cabinet_tpu_torch.models.cabinet import CABiNet
from cabinet_tpu_torch.models.fused import make_fused_tail_apply
from cabinet_tpu_torch.models.mobilenetv3 import MOBILENETV3_LARGE_CFGS
from cabinet_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_utils import (
    LARGE_FIXTURE,
    assert_close_f32,
    load_large_fixture,
    perturb,
    port_model,
)

CFGS = [[3, 1, 16, 0, 0, 1], [3, 4, 24, 0, 0, 2], [5, 3, 40, 1, 0, 2],
        [5, 6, 96, 1, 1, 2]]


@pytest.fixture(scope="module")
def large_fixture():
    """The trained Large fixture with its (zero) gamma and project_out
    perturbed, so the attention reaches the logits."""
    flat, v = load_large_fixture()
    rng = np.random.default_rng(8)
    ga = v["params"]["ab"]["a2block"]
    ga["gamma"] = np.asarray([0.5], np.float32)
    po = ga["global_attn"]["project_out"]
    po["kernel"] = (0.05 * rng.standard_normal(po["kernel"].shape)).astype(np.float32)
    return flat, v


def test_bridge_matches_flax_to_torch_and_loads_strict(large_fixture):
    """Flat npz keys (f16 values upcast) go through the bridge to the same
    keys and values as the JAX package's flax_to_torch, plus one BN step
    counter per BatchNorm, and load with strict=True."""
    flat, nested = load_large_fixture()
    sd = state_dict_from_jax(flat, MOBILENETV3_LARGE_CFGS)
    ref = flax_to_torch(nested, MOBILENETV3_LARGE_CFGS)
    weights = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")}
    assert set(weights) == set(ref)
    for k, v in ref.items():
        assert weights[k].dtype == torch.float32, k
        np.testing.assert_array_equal(weights[k].numpy(), v, err_msg=k)
    model = CABiNet(5, "large")
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    # the CLI's loader takes the same npz file
    from cabinet_tpu_torch.cli.infer import load_state_dict

    loaded = load_state_dict(LARGE_FIXTURE, model)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_fused_tail_forward_matches_jax(use_kernel):
    """Logits of the fused-tail forward (plain kernels on the CPU) against
    JAX make_fused_tail_apply(interpret=True) at 256^2 (S=32), f32."""
    jm = JaxCABiNet(n_classes=8, mode="large", cfgs=CFGS, use_pallas=use_kernel)
    v = perturb(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, 64, 64, 3)),
                        train=False), seed=1)
    images = np.random.default_rng(2).standard_normal((1, 256, 256, 3)
                                                      ).astype(np.float32)
    ref_final, ref_aux = j_fused_tail(jm, v, interpret=True)(jnp.asarray(images))
    tm = port_model(v, 8, "large", CFGS,
                    attention="kernel" if use_kernel else "einsum")
    fwd = make_fused_tail_apply(tm, device="cpu", dtype=torch.float32)
    final, aux = fwd(torch.from_numpy(images))
    assert_close_f32(final.numpy(), ref_final)
    assert_close_f32(aux.numpy(), ref_aux)


def test_attention_choice_is_checked():
    """One selector picks the CAB attention; a name outside it raises, and
    the plain-tail reference refuses a model that would launch K1."""
    with pytest.raises(ValueError, match="attention must be one of"):
        CABiNet(8, "large", cfgs=CFGS, attention="pallas")
    with pytest.raises(ValueError, match="attention='plain'"):
        make_fused_tail_apply(CABiNet(8, "large", cfgs=CFGS, attention="kernel"),
                              device="cpu", kernels=False)


def test_fused_tail_forward_large_fixture(large_fixture):
    """The same forward on the trained Large weights (full published
    table) at 128^2 (S=16, row tile 8), against the JAX fused forward."""
    flat, v = large_fixture
    jm = JaxCABiNet(n_classes=5, mode="large", use_pallas=True)
    images = np.random.default_rng(4).random((1, 128, 128, 3)).astype(np.float32)
    ref_final, _ = j_fused_tail(jm, v, interpret=True)(jnp.asarray(images))
    tm = port_model(v, 5, "large", MOBILENETV3_LARGE_CFGS, attention="kernel")
    final, _ = make_fused_tail_apply(tm, device="cpu", dtype=torch.float32)(
        torch.from_numpy(images))
    assert_close_f32(final.numpy(), ref_final)


def test_segmenter_predict_matches_jax_argmax(tmp_path):
    """Segmenter(device="cpu") with seeded uavid weights (Large, saved as a
    reference .pth) at imgsz 64 == input size, against argmax of JAX
    model.apply on the same normalised input: every pixel whose JAX top-2
    logit margin exceeds 1e-3 agrees."""
    from cabinet_tpu_torch.cli.infer import Segmenter
    from cabinet_tpu_torch.data.datasets import DATASET_REGISTRY

    jm = JaxCABiNet(n_classes=8, mode="large")
    v = perturb(jm.init(jax.random.PRNGKey(5), jnp.zeros((1, 64, 64, 3)),
                        train=False), seed=6)
    ckpt = tmp_path / "uavid_large.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in flax_to_torch(v, MOBILENETV3_LARGE_CFGS).items()}, ckpt)
    seg = Segmenter(str(ckpt), "uavid", mode="large", imgsz=64,
                    dtype_name="float32", device="cpu")

    rgb = np.random.default_rng(7).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    stats = DATASET_REGISTRY["uavid"]
    x = (rgb.astype(np.float32) / 255.0 - np.asarray(stats.MEAN, np.float32)
         ) / np.asarray(stats.STD, np.float32)
    logits, _ = jm.apply(v, jnp.asarray(x[None]), train=False)
    logits = np.asarray(logits)[0]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 1e-3

    mask = seg.predict(rgb)
    assert mask.shape == (64, 64)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(mask[sure], logits.argmax(-1)[sure])
    batch = seg.predict_batch([rgb, rgb[:32, :48]])
    np.testing.assert_array_equal(batch[0], mask)
    assert batch[1].shape == (32, 48)


@pytest.mark.parametrize("n_in,n_out", [(64, 37), (64, 50), (64, 97),
                                         (64, 130), (1024, 720)])
def test_mask_resize_follows_pil_nearest(n_in, n_out):
    """Masks go back to the input size with "nearest-exact": source pixel
    floor((o + 0.5) * n_in / n_out), PIL NEAREST's pixel-centre rule, which
    the JAX engine uses (plain "nearest" drops the +0.5). Where a centre
    falls exactly on a pixel boundary float rounding decides, in PIL
    (incremental sums) and in torch (float32) alike; there the two may pick
    neighbouring pixels. Everywhere else they pick the same one."""
    from PIL import Image

    from cabinet_tpu_torch.cli.infer import Segmenter

    src = np.tile(np.arange(n_in, dtype=np.int64), (n_in, 1)) % 251
    pil = np.asarray(Image.fromarray(src.astype(np.uint8)).resize(
        (n_out, n_in), Image.NEAREST))[0].astype(np.int64)
    got = Segmenter._postprocess(torch.from_numpy(src), (n_in, n_out))[0]
    o = np.arange(n_out)
    tie = ((2 * o + 1) * n_in) % (2 * n_out) == 0
    np.testing.assert_array_equal(got[~tie], pil[~tie])
    assert np.all(np.abs(got[tie] - pil[tie]) <= 1)
    exact = np.minimum((2 * o + 1) * n_in // (2 * n_out), n_in - 1) % 251
    np.testing.assert_array_equal(got[~tie], exact[~tie])


@pytest.mark.parametrize("hw", [(700, 1000), (200, 300)])
def test_input_resize_follows_pil_bilinear(hw):
    """Frames of another size than imgsz are resized as PIL BILINEAR
    resizes the uint8 frame in the JAX engine: a 1000x700 frame down to
    512^2 (anti-aliased) and a 300x200 frame up to it. Within one level on
    every pixel, and equal on at least 99% of them."""
    from PIL import Image

    from cabinet_tpu_torch.cli.infer import _resize_like_pil

    rgb = np.random.default_rng(11).integers(0, 256, (*hw, 3), dtype=np.uint8)
    pil = np.asarray(Image.fromarray(rgb).resize((512, 512), Image.BILINEAR))
    got = _resize_like_pil(torch.from_numpy(rgb).permute(2, 0, 1)[None].float(),
                           (512, 512))[0].permute(1, 2, 0).numpy()
    diff = np.abs(got.astype(np.int64) - pil.astype(np.int64))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def test_segmenter_float32_matches_jax_segmenter(tmp_path):
    """The f32 Segmenter on the CPU against the JAX f32 Segmenter, both
    from one .pth: the normalised input within one level (1/255/std) of
    the JAX engine's for a 1000x700 frame and equal at imgsz; masks equal
    on every pixel whose JAX top-2 margin exceeds 1e-3 at imgsz, and on
    >= 99% of the 1000x700 frame's pixels."""
    from cabinet_tpu.cli.infer import Segmenter as JaxSegmenter
    from cabinet_tpu_torch.cli.infer import Segmenter

    jm = JaxCABiNet(n_classes=8, mode="large")
    v = perturb(jm.init(jax.random.PRNGKey(9), jnp.zeros((1, 64, 64, 3)),
                        train=False), seed=10)
    ckpt = tmp_path / "uavid_large.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in flax_to_torch(v, MOBILENETV3_LARGE_CFGS).items()}, ckpt)
    kw = dict(mode="large", imgsz=64, dtype_name="float32", batch=8)
    jseg = JaxSegmenter(str(ckpt), "uavid", **kw)
    seg = Segmenter(str(ckpt), "uavid", device="cpu", **kw)

    rng = np.random.default_rng(12)
    frame = rng.integers(0, 256, (700, 1000, 3), dtype=np.uint8)
    step = 1 / 255 / min(seg.std.tolist())
    d = np.abs(seg._preprocess(frame).numpy() - jseg._preprocess(frame))
    assert d.max() <= step * 1.001 and (d < 1e-6).mean() >= 0.99

    rgb = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
    np.testing.assert_allclose(seg._preprocess(rgb).numpy(),
                               jseg._preprocess(rgb), rtol=0, atol=1e-6)
    logits, _ = jm.apply(v, jnp.asarray(jseg._preprocess(rgb)[None]), train=False)
    logits = np.asarray(logits)[0]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 1e-3
    got, want = seg.predict_batch([rgb, frame]), jseg.predict_batch([rgb, frame])
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got[0][sure], want[0][sure])
    assert got[1].shape == want[1].shape == (700, 1000)
    assert (got[1] == want[1]).mean() >= 0.99


def test_cli_main_writes_mask_and_overlay(tmp_path):
    """`python -m cabinet_tpu_torch.cli.infer` on one image, on the CPU."""
    from PIL import Image

    from cabinet_tpu_torch.cli.infer import main

    torch.manual_seed(0)
    ckpt = tmp_path / "small.pth"
    torch.save(CABiNet(8, "small").state_dict(), ckpt)
    img = tmp_path / "frame.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 256, (40, 56, 3), dtype=np.uint8)).save(img)
    out = tmp_path / "out"
    main(["--checkpoint", str(ckpt), "--dataset", "uavid", "--source", str(img),
          "--mode", "small", "--imgsz", "64", "--device", "cpu",
          "--out-dir", str(out)])
    mask = np.asarray(Image.open(out / "frame_mask.png"))
    assert mask.shape == (40, 56, 3)
    assert (out / "frame_overlay.png").is_file()
