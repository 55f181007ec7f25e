"""The port's eval protocol (cabinet_tpu_torch.eval, cli.evaluate's choice of
forward) against the JAX package on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.eval import evaluator as jev
from cabinet_tpu.eval import metrics as jmet
from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.models.cab import resize_bilinear as j_resize
from cabinet_tpu_torch.cli.evaluate import make_eval_forward
from cabinet_tpu_torch.eval import evaluator as ev
from cabinet_tpu_torch.eval import metrics as met
from cabinet_tpu_torch.models.cab import resize_bilinear
from torch_port_utils import perturb, port_model

CFGS = [[3, 1, 16, 0, 0, 1], [3, 4, 24, 0, 0, 2], [5, 3, 40, 1, 0, 2],
        [5, 6, 96, 1, 1, 2]]
N_CLASSES = 5
TIE_EPS = 1e-5  # the at-scale gate's near-tie margin on summed probabilities


@pytest.mark.parametrize("full_h,full_w,crop", [(64, 64, 64), (80, 48, 32),
                                                (1080, 1920, 1024),
                                                (2160, 3840, 1024), (33, 97, 32)])
def test_tile_grid_matches_jax(full_h, full_w, crop):
    np.testing.assert_array_equal(ev.tile_grid(full_h, full_w, crop),
                                  jev.tile_grid(full_h, full_w, crop))


def test_confusion_matrix_and_metrics_match_jax():
    """Ignore labels left out, out-of-range predictions and labels clipped,
    exact integers; the metrics from it as in the JAX package."""
    rng = np.random.default_rng(0)
    pred = rng.integers(-1, 7, (2, 40, 30))
    label = rng.integers(0, 6, (2, 40, 30))
    label[rng.random(label.shape) < 0.2] = 255
    got = met.confusion_matrix(torch.from_numpy(pred), torch.from_numpy(label), 5)
    want = np.asarray(jmet.confusion_matrix(jnp.asarray(pred), jnp.asarray(label), 5))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int((label != 255).sum())
    mine, theirs = met.metrics_from_hist(got.numpy()), jmet.metrics_from_hist(want)
    assert mine["mIoU"] == theirs["mIoU"] and mine["accuracy"] == theirs["accuracy"]
    assert mine["iou_per_class"] == theirs["iou_per_class"]


def test_resize_bilinear_matches_jax_banded_resize():
    """At eval sizes (>= 1024 input rows) the JAX resize switches to its
    banded matmul; the port's F.interpolate against it, f32."""
    x = np.random.default_rng(1).standard_normal((1, 1024, 1280, 3)
                                                 ).astype(np.float32)
    want = np.asarray(j_resize(jnp.asarray(x), (768, 960)))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (768, 960))
    got = got.permute(0, 2, 3, 1).numpy()
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), err


@pytest.fixture(scope="module")
def tiny_cabinet():
    """A tiny CABiNet (4-row cfg table) with perturbed JAX weights, its
    JAX apply and the port model on the same weights."""
    jm = JaxCABiNet(n_classes=N_CLASSES, mode="large", cfgs=CFGS)
    v = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)),
                        train=False), seed=3, scale=0.1)
    return jm, v


def _protocol(**kw):
    return dict(n_classes=N_CLASSES, ignore_label=255, scales=(0.5, 1.0),
                flip=True, cropsize=64, **kw)


def _hist_of(pred, labels):
    valid = labels != 255
    idx = pred[valid] * N_CLASSES + labels[valid]
    return np.bincount(idx, minlength=N_CLASSES ** 2).reshape(N_CLASSES, N_CLASSES)


def test_msc_eval_matches_jax(tiny_cabinet):
    """The whole protocol at crop 64, scales (0.5, 1.0), flip, on a 48x80
    image (smaller than the crop in H, larger in W; tiles of both scales
    folded into one forward): summed probabilities within 1e-5 of their
    max; confusion matrices equal except on pixels within TIE_EPS of a tie.
    Then pad_to: a 40x72 image padded to the same 48x80 canvas with
    ignore-filled labels."""
    jm, v = tiny_cabinet
    rng = np.random.default_rng(4)
    img = rng.random((1, 48, 80, 3)).astype(np.float32)
    lbl = rng.integers(0, N_CLASSES, (1, 48, 80))
    lbl[:, :4] = 255

    j_ev = jev.MscEval(lambda vv, x, train=False: jm.apply(vv, x, train=train),
                       **_protocol())
    want = np.asarray(j_ev.prob_batch(v, img))
    fwd = make_eval_forward(port_model(v, N_CLASSES, "large", CFGS), cropsize=64,
                            device="cpu", fused_tail="false")
    t_ev = ev.MscEval(fwd, device="cpu", tile_batch=16, **_protocol())
    got = t_ev.prob_batch(None, img)
    assert got.shape == want.shape == (1, 48, 80, N_CLASSES)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()

    top2 = np.sort(want, axis=-1)[..., -2:]
    ties = (top2[..., 1] - top2[..., 0]) < TIE_EPS
    preds, hist = t_ev.evaluate_batch(None, img, lbl)
    jpred = want.argmax(-1)
    np.testing.assert_array_equal(preds[~ties], jpred[~ties])
    diff = np.abs(hist - _hist_of(jpred, lbl)).sum() / 2
    assert diff <= ties.sum()
    res = t_ev.evaluate(None, [(img, lbl)])
    np.testing.assert_array_equal(res["confusion_matrix"], hist)

    # pad_to: right/bottom zero pad, ignore-filled labels, preds cut back
    small, slbl = img[:, :40, :72], lbl[:, :40, :72]
    jp_img, jp_lbl, _ = jev.MscEval(None, **_protocol(), pad_to=(48, 80)
                                    )._pad_to_bucket(small, slbl)
    assert jp_img.shape == img.shape
    want_p = np.asarray(j_ev.prob_batch(v, jp_img))
    t_pad = ev.MscEval(fwd, device="cpu", pad_to=(48, 80), **_protocol())
    preds_p, hist_p = t_pad.evaluate_batch(None, small, slbl)
    assert preds_p.shape == (1, 40, 72)
    top2 = np.sort(want_p, axis=-1)[..., -2:]
    ties_p = (top2[..., 1] - top2[..., 0]) < TIE_EPS
    diff = np.abs(hist_p - _hist_of(want_p.argmax(-1), jp_lbl)).sum() / 2
    assert diff <= ties_p.sum()
    assert hist_p.sum() == (slbl != 255).sum()


def test_msc_eval_bf16_accumulation(tiny_cabinet):
    """acc_dtype=bf16 (the bf16 eval chain's softmax and overlap-add in
    bf16) against the f32 chain on the same forward: each summed map is 2
    scales of probabilities in [0, 1] rounded in bf16 a few times, so
    within 2 * 2^-8 * 4 = 0.03125 of the f32 map. The tile fold changes
    only the forwards' batch: tile_batch 1 gives the same map up to the
    float rounding of the CPU's convolutions at another batch (1e-5 of
    max)."""
    jm, v = tiny_cabinet
    img = np.random.default_rng(5).random((1, 48, 80, 3)).astype(np.float32)
    fwd = make_eval_forward(port_model(v, N_CLASSES, "large", CFGS), cropsize=64,
                            device="cpu", fused_tail="false")
    f32 = ev.MscEval(fwd, device="cpu", **_protocol()).prob_batch(None, img)
    b16 = ev.MscEval(fwd, device="cpu", acc_dtype=torch.bfloat16,
                     **_protocol()).prob_batch(None, img)
    assert np.abs(b16 - f32).max() <= 0.03125
    # the JAX bf16 chain rounds at the same steps (its softmax in bf16)
    j_b16 = jev.MscEval(lambda vv, x, train=False: jm.apply(vv, x, train=train),
                        acc_dtype=jnp.bfloat16, **_protocol()).prob_batch(v, img)
    assert np.abs(b16 - np.asarray(j_b16, np.float32)).max() <= 0.03125
    one =ev.MscEval(fwd, device="cpu", tile_batch=1, **_protocol()).prob_batch(None, img)
    assert np.abs(one - f32).max() <= 1e-5 * np.abs(f32).max()


def test_make_eval_forward_routes_as_jax_cli():
    """auto: the fused tail only on CUDA; true: raises where it cannot be
    honoured (f32, or a grid outside the kernels' support) and otherwise
    runs it (on the CPU, the kernels' plain versions); use_pallas sets the
    CAB attention; quantize is not ported yet."""
    from cabinet_tpu_torch.models.cabinet import CABiNet

    def model():
        return CABiNet(8, "large", cfgs=CFGS)

    assert make_eval_forward(model(), 256, "cpu", torch.bfloat16).route == "model"
    with pytest.raises(ValueError, match="compute_dtype=bfloat16"):
        make_eval_forward(model(), 256, "cpu", torch.float32, fused_tail="true")
    with pytest.raises(ValueError, match="outside kernel support"):
        make_eval_forward(model(), 72, "cpu", torch.bfloat16, fused_tail="true")
    m = model()
    fwd = make_eval_forward(m, 256, "cpu", torch.bfloat16, use_pallas=True,
                            fused_tail="true")
    assert fwd.route == "fused_tail"
    assert m.ab.a2block.global_attn.attention == "kernel"
    logits, aux = fwd(None, torch.zeros(1, 256, 256, 3))
    assert logits.shape == aux.shape == (1, 256, 256, 8)
    m = model()
    make_eval_forward(m, 256, "cpu", use_pallas=False)
    assert m.ab.a2block.global_attn.attention == "einsum"
    with pytest.raises(NotImplementedError, match="not ported"):
        make_eval_forward(model(), 256, "cpu", quantize="int8")
