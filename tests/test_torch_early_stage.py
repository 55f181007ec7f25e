"""The port's stem+block_0 stage (K4's plain version, the BN fold), the
early-stage forwards and `Segmenter`'s routing rule against the JAX package
on the CPU, where the Pallas kernel runs in interpret mode."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.models.fused import fused_early_supported as j_early_supported
from cabinet_tpu.models.fused import make_fused_apply as j_fused_apply
from cabinet_tpu.models.fused import make_fused_tail_apply as j_fused_tail
from cabinet_tpu.ops import early_stage as jes
from cabinet_tpu.ops.decoder_tail import fused_tail_supported as j_tail_supported
from cabinet_tpu_torch.cli.infer import choose_route
from cabinet_tpu_torch.models.fused import (
    fused_early_supported,
    make_fused_apply,
    make_fused_tail_apply,
)
from cabinet_tpu_torch.ops import early_stage as es
from torch_port_utils import assert_close_f32, perturb, port_model

CFGS = [[3, 1, 16, 0, 0, 1], [3, 4, 24, 0, 0, 2], [5, 3, 40, 1, 0, 2],
        [5, 6, 96, 1, 1, 2]]


def _folded(rng):
    """Random folded weights, as tests/unit/test_early_stage.py draws them."""
    shapes = [(16, 27), (16,), (3, 3, 16), (16,), (16, 16), (16,)]
    scales = [0.2, 0.1, 0.2, 0.1, 0.2, 0.1]
    return [(rng.normal(size=s) * sc).astype(np.float32)
            for s, sc in zip(shapes, scales)]


@pytest.mark.parametrize("H,W", [(256, 256), (128, 256)])
def test_stem_block0_plain_matches_pallas_kernel(H, W):
    """K4's plain version against the Pallas kernel (interpret mode) on the
    same bf16-rounded input, at the JAX suite's bound (atol 2e-4, rtol
    1e-3, tests/unit/test_early_stage.py:52); the unrounded reference
    against the JAX reference in f32."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, H, W, 3)).astype(np.float32)
    params = _folded(rng)
    want = np.asarray(jes.fused_stem_block0(jnp.asarray(x),
                                            *map(jnp.asarray, params),
                                            interpret=True))
    tparams = [torch.from_numpy(p) for p in params]
    got = es.stem_block0_plain(torch.from_numpy(x), *tparams)
    assert got.shape == (2, 16, H // 2, W // 2) and got.dtype == torch.float32
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=1e-3)
    # the wrapper takes the plain version for CPU tensors, in out_dtype
    wrapped = es.fused_stem_block0(torch.from_numpy(x), *tparams,
                                   out_dtype=torch.bfloat16)
    assert wrapped.dtype == torch.bfloat16
    torch.testing.assert_close(wrapped, got.to(torch.bfloat16), rtol=0, atol=0)

    ref = np.asarray(jes.stem_block0_reference(jnp.asarray(x),
                                               *map(jnp.asarray, params)))
    assert_close_f32(es.stem_block0_reference(torch.from_numpy(x), *tparams
                                              ).numpy(), ref)


def test_packed_weights_follow_the_fold_layouts():
    """K4's launcher takes the folded weights packed into one buffer: each
    weight of `fold_stem_block0_params` flattened at its offset, the
    offsets those of the kernel's constant block (csrc/early_stage.cu).
    `pack_stem_block0_weights` returns views of that buffer, which the
    wrapper recognises as packed; the weights as folded it does not."""
    import re
    from pathlib import Path

    _, v = _jax_model_and_vars()
    folded = es.fold_stem_block0_params(port_model(v, 6, "large", CFGS).mobile)
    views = es.pack_stem_block0_weights(*folded)
    assert es.is_packed(views) and not es.is_packed(folded)
    assert views[0].untyped_storage().nbytes() == 4 * es.N_PACKED
    packed = views[0].as_strided((es.N_PACKED,), (1,))
    assert packed.dtype == torch.float32
    names = ("wstem", "bstem", "wdw", "bdw", "wpw", "bpw")
    starts = [es.PACKED_OFFSETS[n] for n in names]
    assert starts == sorted(starts) and starts[0] == 0
    for name, t, view, start, end in zip(names, folded, views, starts,
                                         starts[1:] + [es.N_PACKED]):
        assert end - start == t.numel(), name
        assert view.shape == t.shape and torch.equal(view, t), name
        assert torch.equal(packed[start:end].view(t.shape), t), name
    # wdw (3,3,16) at tap i*3+j, channel c; wpw [co, ci]: the orders the
    # kernel indexes.
    wdw, wpw = folded[2], folded[4]
    assert packed[es.PACKED_OFFSETS["wdw"] + (2 * 3 + 1) * 16 + 5] == wdw[2, 1, 5]
    assert packed[es.PACKED_OFFSETS["wpw"] + 7 * 16 + 3] == wpw[7, 3]
    src = (Path(es.__file__).resolve().parent.parent / "csrc" / "early_stage.cu").read_text()
    cu = dict(re.findall(r"\b([WB]_(?:STEM|DW|PW)) = (\d+)", src))
    assert {k: int(n) for k, n in cu.items()} == {
        "W_STEM": 0, "B_STEM": es.PACKED_OFFSETS["bstem"],
        "W_DW": es.PACKED_OFFSETS["wdw"], "B_DW": es.PACKED_OFFSETS["bdw"],
        "W_PW": es.PACKED_OFFSETS["wpw"], "B_PW": es.PACKED_OFFSETS["bpw"]}


def test_is_packed_takes_only_the_packed_order():
    """Views of one buffer count as packed only at PACKED_OFFSETS, in the
    packed order: two weights swapped, a buffer laid out in another order,
    or one view replaced by a copy of it, each must be packed anew."""
    g = torch.Generator().manual_seed(0)
    shapes = ((16, 27), (16,), (3, 3, 16), (16,), (16, 16), (16,))
    views = es.pack_stem_block0_weights(*(torch.randn(*s, generator=g) for s in shapes))
    assert es.is_packed(views)
    assert not es.is_packed(views[:1] + views[3:4] + views[2:3] + views[1:2] + views[4:])
    backwards = torch.cat([t.reshape(-1) for t in reversed(views)])
    ends = torch.tensor([0] + [t.numel() for t in reversed(views)]).cumsum(0).tolist()
    reordered = [backwards[a:b].view(t.shape)
                 for t, a, b in zip(reversed(views), ends, ends[1:])][::-1]
    assert not es.is_packed(tuple(reordered))
    assert not es.is_packed(views[:5] + (views[5].clone(),))


def _jax_model_and_vars(n_classes=6, seed=0):
    jm = JaxCABiNet(n_classes=n_classes, mode="large", cfgs=CFGS)
    v = perturb(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)),
                        train=False), seed=seed + 1)
    return jm, v


def test_fold_matches_jax_fold():
    """The fold from the port's modules against the JAX fold of the same
    (converted) weights, with random batch stats."""
    jm, v = _jax_model_and_vars()
    want = jes.fold_stem_block0_params(v["params"]["mobile"],
                                       v["batch_stats"]["mobile"])
    got = es.fold_stem_block0_params(port_model(v, 6, "large", CFGS).mobile)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("forward", ["fused_apply", "fused_tail_early"])
def test_early_stage_forwards_match_jax(forward):
    """make_fused_apply and make_fused_tail_apply(use_early=True) against
    their JAX twins (Pallas in interpret mode), f32, 128^2 input, within
    2e-4 of max|ref|."""
    jm, v = _jax_model_and_vars(n_classes=8, seed=2)
    x = np.random.default_rng(3).standard_normal((2, 128, 128, 3)
                                                 ).astype(np.float32)
    tm = port_model(v, 8, "large", CFGS, attention="kernel")
    if forward == "fused_apply":
        ref = j_fused_apply(jm, v, interpret=True)(jnp.asarray(x))
        got = make_fused_apply(tm, "cpu", torch.float32)(torch.from_numpy(x))
    else:
        ref = j_fused_tail(jm, v, interpret=True, use_early=True)(jnp.asarray(x))
        got = make_fused_tail_apply(tm, "cpu", torch.float32, use_early=True)(
            torch.from_numpy(x))
    for g, r in zip(got, ref):
        assert_close_f32(g.numpy(), np.asarray(r))


def test_fused_apply_rejects_small_block0_and_odd_input():
    from cabinet_tpu_torch.models.cabinet import CABiNet

    small = CABiNet(4, "small", cfgs=[[3, 1, 16, 1, 0, 2]])
    with pytest.raises(ValueError, match="block_0"):
        make_fused_apply(small, "cpu", torch.float32)
    fwd = make_fused_apply(CABiNet(4, "large", cfgs=CFGS), "cpu", torch.float32)
    with pytest.raises(ValueError, match="unsupported"):
        fwd(torch.zeros(1, 66, 64, 3))  # H/2 = 33 rows: no whole band


SHAPES = [(1, 1024, 1024, 3), (1, 64, 64, 3), (1, 63, 64, 3), (1, 96, 256, 3),
          (1, 720, 1280, 3), (2, 66, 98, 3), (1, 2, 2, 3), (1, 130, 64, 3),
          (1, 128, 72, 3), (4, 512, 512, 3), (1, 1080, 1920, 3)]


@pytest.mark.parametrize("shape", SHAPES)
def test_fused_early_supported_matches_jax(shape):
    """The JAX predicate in interpret mode; where W/2 % 128 == 0 (Mosaic's
    lane rule) also its compiled form."""
    assert fused_early_supported(shape) == j_early_supported(shape, interpret=True)
    if (shape[2] // 2) % 128 == 0:
        assert fused_early_supported(shape) == j_early_supported(shape)


def _jax_route(mode, backend, dtype, batch, imgsz, n_classes):
    """`cabinet_tpu.cli.infer.Segmenter`'s rule (:71-93), with its
    predicates in their interpret-mode form."""
    if mode == "large" and backend == "tpu":
        s8 = imgsz // 8
        early = batch >= 8 and j_early_supported((1, imgsz, imgsz, 3),
                                                 interpret=True)
        if j_tail_supported(s8, s8, n_classes) and dtype == jnp.bfloat16:
            return "fused_tail_early" if early else "fused_tail"
        if early:
            return "fused_early"
    return "model"


def test_choose_route_matches_jax_rule_table():
    dtypes = [(torch.bfloat16, jnp.bfloat16), (torch.float32, jnp.float32)]
    seen = set()
    for mode, (dev, backend), (tdt, jdt), batch, imgsz, n in itertools.product(
            ["large", "small"], [("cuda", "tpu"), ("cpu", "cpu")], dtypes,
            [1, 4, 8, 16], [64, 96, 256, 512, 720, 1024, 1030], [8, 19, 200]):
        want = _jax_route(mode, backend, jdt, batch, imgsz, n)
        assert choose_route(mode, dev, tdt, batch, imgsz, n) == want, (
            mode, dev, tdt, batch, imgsz, n)
        seen.add(want)
    assert seen == {"model", "fused_tail", "fused_tail_early", "fused_early"}


def test_segmenter_exposes_its_route(tmp_path):
    """On the CPU every configuration runs the model's forward, as the JAX
    engine does off the TPU; batch 8 pads a short chunk."""
    from cabinet_tpu_torch.cli.infer import Segmenter
    from cabinet_tpu_torch.models.cabinet import CABiNet

    ckpt = tmp_path / "large.pth"
    torch.save(CABiNet(8, "large").state_dict(), ckpt)
    seg = Segmenter(str(ckpt), "uavid", imgsz=64, batch=8, device="cpu")
    assert seg.route == "model"
    rgb = np.random.default_rng(0).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    masks = seg.predict_batch([rgb, rgb])
    assert len(masks) == 2 and masks[0].shape == (64, 64)
    np.testing.assert_array_equal(masks[0], masks[1])
