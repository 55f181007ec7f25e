"""int8 post-training quantization of the port (cabinet_tpu_torch/quant.py)
against the JAX package's (cabinet_tpu/quant.py) on the CPU, case by case
as tests/unit/test_quant.py holds JAX's: the sites, the calibration, each
site's arithmetic, the whole forward, the contract cases, the quality gate
of tests/parity/test_miou_at_scale.py on the trained Small fixture, and
`cli/export.py --quantize` with the server on its artifact."""

import json
import threading
import urllib.request

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import unflatten_dict
from jax import lax

from cabinet_tpu import quant as jquant
from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.models.layers import DepthwiseConv2D as JaxDepthwise
from cabinet_tpu_torch import quant
from cabinet_tpu_torch.models.cabinet import CABiNet
from cabinet_tpu_torch.models.layers import DepthwiseConv2D
from cabinet_tpu_torch.ops.decoder_tail import fold_tail_params
from cabinet_tpu_torch.utils.convert import (
    jax_site_keys,
    port_module_names,
    state_dict_from_jax,
)
from torch_port_utils import F32_REL, FIXTURE_DIR, LARGE_FIXTURE, nchw, nhwc

SMALL_FIXTURE = FIXTURE_DIR / "miou_small_cabinet_v1.npz"
N_CLASSES = 5  # the fixtures' palette task
PALETTE = np.array([[220, 40, 40], [40, 220, 40], [40, 40, 220], [220, 220, 40],
                    [140, 40, 220]], np.float32) / 255.0
# the JAX unit tests' cut Small table (tests/unit/test_quant.py)
CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2],
        [5, 6, 96, 1, 1, 2]]


def _fixture(path, mode):
    """(JAX variables in f32, the port's model in eval mode) of a trained
    fixture."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    variables = unflatten_dict({
        tuple(k.split("/")): jnp.asarray(v, jnp.float32 if v.dtype == np.float16 else v.dtype)
        for k, v in flat.items()})
    model = CABiNet(N_CLASSES, mode)
    model.load_state_dict(state_dict_from_jax(flat, model.cfgs), strict=True)
    return variables, model.eval()


def _to_port(scales, cfgs):
    names = port_module_names(cfgs)
    return {names[k]: v for k, v in scales.items()}


def _to_jax(scales, cfgs):
    keys = jax_site_keys(cfgs)
    return {keys[k]: v for k, v in scales.items()}


def _synthetic(rng, size, block):
    """Blocky labels and their palette rendering with noise 0.02
    (tests/parity/miou_fixture.py:synthetic)."""
    grid = rng.integers(0, N_CLASSES, (size // block, size // block))
    labels = np.kron(grid, np.ones((block, block), np.int64))
    image = PALETTE[labels] + rng.normal(0, 0.02, (*labels.shape, 3))
    return image.astype(np.float32), labels


# ---------------------------------------------------------------------------
# CABiNet-Large: JAX's sites, scales and per-site arithmetic
# ---------------------------------------------------------------------------

def _jax_site_arithmetic(model, variables, x, scales):
    """For every site of `scales`: its input as the JAX forward gives it,
    and JAX's xq, wq, int32 sums and output (the steps of
    cabinet_tpu/quant.py:_quantized_conv and _quantized_dw)."""

    def run(variables, x):
        stash = {}

        def interceptor(next_fn, args, kwargs, context):
            mod = context.module
            key = "/".join(mod.path)
            if (context.method_name == "__call__" and key in scales
                    and isinstance(mod, (nn.Conv, JaxDepthwise))):
                # one materialised input for the stash and the arithmetic:
                # XLA would otherwise recompute it inside each consumer's
                # fusion, where its rounding may differ from the stashed one
                xin, s = lax.optimization_barrier(args[0]), scales[key]
                w = mod.variables["params"]["kernel"].astype(jnp.float32)
                sw = jnp.maximum(jnp.max(jnp.abs(w), axis=(0, 1, 2)) / 127.0, 1e-12)
                wq = jnp.clip(jnp.round(w / sw), -127, 127).astype(jnp.int8)
                xq = jnp.clip(jnp.round(xin.astype(jnp.float32) * (1.0 / s)),
                              -127, 127).astype(jnp.int8)
                dn = lax.conv_dimension_numbers(xin.shape, wq.shape, jquant._DN)
                if isinstance(mod, JaxDepthwise):
                    k = mod.kernel_size
                    pad = mod.padding if mod.padding is not None else (k - 1) // 2
                    sums = lax.conv_general_dilated(
                        xq, wq, (mod.stride, mod.stride), [(pad, pad), (pad, pad)],
                        dimension_numbers=dn, feature_group_count=xin.shape[-1],
                        preferred_element_type=jnp.int32)
                    out = jquant._quantized_dw(mod, xin, s)
                else:
                    sums = lax.conv_general_dilated(
                        xq, wq, dimension_numbers=dn, preferred_element_type=jnp.int32,
                        **jquant._conv_geometry(mod))
                    out = jquant._quantized_conv(mod, xin, s)
                stash[key] = {"x": xin, "xq": xq, "wq": wq, "sums": sums, "out": out}
            return next_fn(*args, **kwargs)

        with nn.intercept_methods(interceptor):
            model.apply(variables, x, train=False)
        return stash

    return jax.device_get(jax.jit(run)(variables, x))


@pytest.fixture(scope="module")
def large():
    """The trained Large fixture on one (2, 64, 64, 3) batch: JAX variables,
    the port's model, the batch, JAX's int8 and int8dw scales, and JAX's
    arithmetic at each int8dw site."""
    variables, model = _fixture(LARGE_FIXTURE, "large")
    x = np.random.default_rng(0).normal(size=(2, 64, 64, 3)).astype(np.float32)
    jmodel = JaxCABiNet(n_classes=N_CLASSES, mode="large")
    scales = {dw: jquant.collect_act_scales(jmodel, variables, [jnp.asarray(x)],
                                            quantize_depthwise=dw)
              for dw in (False, True)}
    sites = _jax_site_arithmetic(jmodel, variables, jnp.asarray(x), scales[True])
    return variables, model, x, scales, sites


@pytest.mark.parametrize("depthwise,n_sites", [(False, 46), (True, 64)],
                         ids=["int8", "int8dw"])
def test_large_sites_are_jax_sites(large, depthwise, n_sites):
    """CABiNet-Large: the port's sites are JAX's calibrated sites, key for
    key through the key table: 46 under int8, 64 under int8dw (the 18
    depthwise convs added)."""
    _, model, _, scales, _ = large
    sites = quant.quantization_sites(model, quantize_depthwise=depthwise)
    assert set(_to_jax(dict.fromkeys(sites, 1.0), model.cfgs)) == set(scales[depthwise])
    assert len(sites) == n_sites
    n_dw = sum(isinstance(m, DepthwiseConv2D) for m in sites.values())
    assert n_dw == (18 if depthwise else 0)


@pytest.mark.parametrize("depthwise", [False, True], ids=["int8", "int8dw"])
def test_small_sites_are_jax_sites(small, depthwise):
    """The Small table: the same site keys as JAX."""
    _, model, _, scales = small
    sites = quant.quantization_sites(model, quantize_depthwise=depthwise)
    assert set(_to_jax(dict.fromkeys(sites, 1.0), model.cfgs)) == set(scales[depthwise])


def test_site_key_map_both_ways():
    """Every conv of Large has a JAX key and back; the head rule reads the
    JAX name (sb.conv_out.conv is a site, conv_out.conv_out and ab.b4 are
    not; the CAB's to_query.0 is JAX's to_query)."""
    model = CABiNet(N_CLASSES, "large")
    keys, names = jax_site_keys(model.cfgs), port_module_names(model.cfgs)
    convs = {n for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)}
    assert set(keys) == convs and {names[k] for k in keys.values()} == convs
    assert keys["sb.conv_out.conv"] == "sb/conv_out/conv"
    assert keys["ab.a2block.global_attn.to_query.0"] == "ab/a2block/global_attn/to_query"
    assert keys["mobile.features.1.conv.0"] == "mobile/block_0/dw"
    sites = quant.quantization_sites(model, quantize_depthwise=True)
    assert "sb.conv_out.conv" in sites and "ab.a2block.global_attn.to_key.0" in sites
    assert "conv_out.conv_out" not in sites and "ab.b4" not in sites


def test_site_predicate_contract():
    """tests/unit/test_quant.py's predicate cases on the port's copies."""
    p = quant.default_site_predicate
    assert p(("x",), (3, 3, 256, 256))
    assert not p(("x",), (7, 7, 3, 64))
    assert not p(("x",), (1, 1, 256, 8))
    assert not p(("conv_out", "conv_out"), (1, 1, 256, 19))
    assert not p(("ab", "b4"), (1, 1, 128, 19))
    assert not p(("classifier",), (1, 1, 256, 19))
    assert not p(("aux_classifier",), (1, 1, 256, 19))
    assert p(("conv_out", "conv", "conv"), (3, 3, 256, 256))
    assert quant.dw_site_predicate(("m", "dw"), (3, 3, 1, 16))
    assert not quant.dw_site_predicate(("m", "dw"), (3, 3, 1, 8))


@pytest.mark.parametrize("kernel,stride,padding", [(1, 1, 0), (3, 2, 1), (3, 1, 1), (5, 2, 2)])
def test_im2col_columns_match_unfold_and_are_row_major(kernel, stride, padding):
    """The int8 columns of an NCHW-strided input (as a site permutes it)
    are F.unfold's of the same values, tap-major, in row-major memory
    (cuBLASLt's int8 GEMM takes no other layout)."""
    x = torch.randint(-127, 128, (2, 24, 9, 11), dtype=torch.int8)
    cols, (B, Ho, Wo) = quant.im2col_int8(x.permute(0, 2, 3, 1), (kernel, kernel),
                                          (stride, stride), (padding, padding), (1, 1))
    assert cols.is_contiguous() and cols.dtype == torch.int8
    ref = torch.nn.functional.unfold(x.float(), kernel, padding=padding, stride=stride)
    ref = ref.view(2, 24, kernel * kernel, Ho * Wo).permute(0, 3, 2, 1).reshape(B * Ho * Wo, -1)
    assert torch.equal(cols.float(), ref)


def test_calibrated_scales_match_jax(large):
    """collect_act_scales on the same batch: JAX's 64 int8dw scales within
    2e-4 relative, key for key (the site inputs differ by f32 reordering
    upstream)."""
    _, model, x, scales, _ = large
    got = _to_jax(quant.collect_act_scales(model, [nchw(x)], quantize_depthwise=True),
                  model.cfgs)
    ref = scales[True]
    assert set(got) == set(ref)
    for key in ref:
        assert abs(got[key] - ref[key]) <= 2e-4 * ref[key], (key, got[key], ref[key])


def test_site_arithmetic_matches_jax(large):
    """Every int8dw site of Large fed JAX's own input and scale: xq, wq and
    the int32 sums equal JAX's exactly; the f32 output within one f32 ulp
    of its max |ref| (the rescale and bias are separate f32 roundings in
    both, which XLA may fuse). The FFM's attention convs run on 1x1 maps
    (the padded GEMM rows), sb.conv2 and sb.conv3 at stride 2."""
    _, model, _, scales, sites = large
    modules = dict(model.named_modules())
    names = port_module_names(model.cfgs)
    assert len(sites) == 64
    for key, ref in sites.items():
        site = quant.Int8Site(modules[names[key]], scales[True][key])
        x = nchw(ref["x"])
        xq = site.quantize_input(x)
        np.testing.assert_array_equal(nhwc(xq), ref["xq"], err_msg=key)
        if site.depthwise:
            wq = ref["wq"].transpose(3, 2, 0, 1)
        else:  # the rows past the conv's outputs are zeros
            wq = ref["wq"].transpose(3, 0, 1, 2).reshape(ref["wq"].shape[3], -1)
            wq = np.pad(wq, ((0, site.weight_q.shape[0] - wq.shape[0]), (0, 0)))
            assert site.weight_q.shape[0] % 32 == 0
        np.testing.assert_array_equal(site.weight_q.numpy(), wq, err_msg=key)
        sums = site.sums(xq)
        if site.depthwise:
            assert torch.equal(sums, sums.round()), key
            sums = sums.permute(0, 2, 3, 1).to(torch.int32)
        assert sums.dtype == torch.int32
        np.testing.assert_array_equal(sums.numpy(), ref["sums"], err_msg=key)
        out = nhwc(site(x))
        ulp = np.spacing(np.float32(np.abs(ref["out"]).max()))
        assert np.abs(out - ref["out"]).max() <= ulp, key


# ---------------------------------------------------------------------------
# The whole forward and the contract cases
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """The trained Small fixture: JAX variables, the port's model, one
    (1, 128, 128, 3) palette batch, and JAX's int8 and int8dw scales on
    it."""
    variables, model = _fixture(SMALL_FIXTURE, "small")
    image, _ = _synthetic(np.random.default_rng(7), 128, 32)
    jmodel = JaxCABiNet(n_classes=N_CLASSES, mode="small")
    scales = {dw: jquant.collect_act_scales(jmodel, variables, [jnp.asarray(image[None])],
                                            quantize_depthwise=dw)
              for dw in (False, True)}
    return variables, model, image[None], scales


# Bound: the suite's f32 bound, 2e-4 of max |ref| (torch_port_utils.F32_REL).
# The f32 layers between the sites differ from XLA's by reordering noise,
# and so do the sites' inputs. Where an input lies within that noise of a
# rounding tie (x / sx = n + 0.5), one package takes n and the other n + 1,
# which moves the site's output by one quantization step, sx * sw * |w|,
# at that pixel: more than this bound absorbs, so such a flip would fail
# the test rather than hide. Measured on the Small fixture at 128^2: max
# |delta| 3.8e-6 against max |logit| 11.2 (int8 and int8dw), no argmax
# moved; int8 itself moves the logits by 0.063 (int8) and 0.090 (int8dw).
FORWARD_REL = F32_REL


@pytest.mark.parametrize("depthwise", [False, True], ids=["int8", "int8dw"])
def test_quantized_forward_matches_jax_on_jax_scales(small, depthwise):
    """The port's quantized forward, fed JAX's scales, against JAX's
    make_quantized_apply on the trained Small fixture in f32."""
    variables, model, image, jax_scales = small
    scales = jax_scales[depthwise]
    jmodel = JaxCABiNet(n_classes=N_CLASSES, mode="small")
    q_apply = jquant.make_quantized_apply(jmodel, scales)
    ref, ref_aux = jax.jit(lambda v, x: q_apply(v, x, train=False))(variables,
                                                                    jnp.asarray(image))
    ref, ref_aux = np.asarray(ref), np.asarray(ref_aux)
    qmodel = quant.make_quantized_apply(model, _to_port(scales, model.cfgs))
    with torch.no_grad():
        got, got_aux = (nhwc(t) for t in qmodel(nchw(image)))
    for g, r in ((got, ref), (got_aux, ref_aux)):
        assert np.abs(g - r).max() <= FORWARD_REL * np.abs(r).max()
    assert (got.argmax(-1) == ref.argmax(-1)).mean() >= 0.999


def test_empty_scales_give_the_float_model_bit_for_bit(small):
    _, model, image, _ = small
    with torch.no_grad():
        ref = model(nchw(image))
        got = quant.make_quantized_apply(model, {})(nchw(image))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


def test_partial_scales_quantize_only_the_sites_they_name(small):
    """A decoder-only subset: those convs run int8, the rest (and the
    model given) stay float; an unknown name raises."""
    _, model, image, _ = small
    scales = quant.collect_act_scales(model, [nchw(image)])
    decoder = {k: v for k, v in scales.items() if k.startswith(("ffm", "conv_out", "ab"))}
    assert 0 < len(decoder) < len(scales)
    qmodel = quant.make_quantized_apply(model, decoder)
    quantized = {n for n, m in qmodel.named_modules() if hasattr(m, "int8")}
    assert quantized == set(decoder)
    assert not any(hasattr(m, "int8") for m in model.modules())
    with torch.no_grad():
        out, _ = qmodel(nchw(image))
        ref, _ = model(nchw(image))
    assert torch.isfinite(out).all() and not torch.equal(out, ref)
    with pytest.raises(ValueError, match="not a conv"):
        quant.make_quantized_apply(model, {"ab.b2": 1.0})


def test_calibration_max_over_batches(small):
    _, model, image, _ = small
    x = nchw(image)
    low = quant.collect_act_scales(model, [x * 0.1])
    both = quant.collect_act_scales(model, [x * 0.1, x])
    high = quant.collect_act_scales(model, [x])
    assert set(both) == set(high) == set(low)
    for key in high:
        assert both[key] == max(high[key], low[key])


def test_wide_class_heads_stay_float():
    """19 classes (Cityscapes): the class heads pass the width rule and
    stay float by name; the 3x3 before the head is a site."""
    model = CABiNet(19, "small", cfgs=CFGS)
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(1, 3, 64, 64))
                         .astype(np.float32))
    scales = quant.collect_act_scales(model, [x])
    assert "conv_out.conv_out" not in scales and "ab.b4" not in scales
    assert "conv_out.conv.conv" in scales


def test_quantization_report_keys(small):
    """JAX's keys; the trained model keeps its argmax under int8."""
    _, model, image, _ = small
    x = nchw(image)
    scales = quant.collect_act_scales(model, [x], quantize_depthwise=True)
    report = quant.quantization_report(model, scales, x)
    assert set(report) == {"argmax_agreement", "mean_abs_logit_delta",
                           "max_abs_logit_delta", "n_quantized_convs"}
    assert report["n_quantized_convs"] == len(scales) > 5
    assert report["argmax_agreement"] > 0.99
    assert 0 < report["mean_abs_logit_delta"] <= report["max_abs_logit_delta"]


def test_quantized_copy_keeps_state_dict_and_f32_scales(small):
    """The quantized copy's state dict is the float model's (strict load,
    fold_tail_params); cast to bf16, its int8 weights stay int8 and its
    scales and biases f32, and it runs in bf16."""
    _, model, image, _ = small
    scales = quant.collect_act_scales(model, [nchw(image)])
    qmodel = quant.make_quantized_apply(model, scales)
    assert qmodel.state_dict().keys() == model.state_dict().keys()
    qmodel.load_state_dict(model.state_dict(), strict=True)
    folded = fold_tail_params(qmodel, dtype=torch.float32)
    ref = fold_tail_params(model, dtype=torch.float32)
    assert all(torch.equal(folded[k], ref[k]) for k in ref if torch.is_tensor(ref[k]))
    qmodel.to(torch.bfloat16)
    sites = [m.int8 for m in qmodel.modules() if hasattr(m, "int8")]
    assert len(sites) == len(scales)
    assert all(s.weight_q.dtype == torch.int8 and s.scale.dtype == torch.float32
               for s in sites)
    assert all(s.bias is None or s.bias.dtype == torch.float32 for s in sites)
    with torch.no_grad():
        out, _ = qmodel(nchw(image).to(torch.bfloat16))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out.float()).all()


# ---------------------------------------------------------------------------
# Quality gate: tests/parity/test_miou_at_scale.py:test_int8_ptq_miou_at_scale
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def gate(small):
    """The gate's protocol on the port: calibration on one 256^2 palette
    image, one 512^2 image (top 32 rows ignored) at scales 0.75 and 1.25
    with flip, crop 256; the float leg's result."""
    from cabinet_tpu_torch.eval.evaluator import MscEval

    _, model, _, _ = small
    rng = np.random.default_rng(23)
    calib, _ = _synthetic(rng, 256, 64)
    image, labels = _synthetic(rng, 512, 64)
    labels[:32] = 255
    batch = [(image[None], labels[None])]

    def evaluate(m):
        @torch.no_grad()
        def fwd(v, x):
            return tuple(t.permute(0, 2, 3, 1) for t in m(x.permute(0, 3, 1, 2)))

        return MscEval(fwd, N_CLASSES, ignore_label=255, scales=(0.75, 1.25), flip=True,
                       cropsize=256, device="cpu").evaluate(None, batch)

    res_f = evaluate(model)
    assert res_f["mIoU"] > 0.9  # the comparison is not vacuous
    return model, nchw(calib[None]), evaluate, res_f


@pytest.mark.parametrize("depthwise", [False, True], ids=["int8", "int8dw"])
def test_int8_ptq_miou_at_scale(gate, depthwise):
    """|delta mIoU| < 0.01 and at most 0.5% of the pixels moved against the
    float model, for int8 and int8dw."""
    model, calib, evaluate, res_f = gate
    scales = quant.collect_act_scales(model, [calib], quantize_depthwise=depthwise)
    assert len(scales) > 5
    res_q = evaluate(quant.make_quantized_apply(model, scales))
    assert abs(res_q["mIoU"] - res_f["mIoU"]) < 0.01
    total = res_f["confusion_matrix"].sum()
    moved = np.abs(res_q["confusion_matrix"] - res_f["confusion_matrix"]).sum() / 2
    assert moved <= 5e-3 * total, f"{moved} of {total} pixels moved"


# ---------------------------------------------------------------------------
# cli/export.py --quantize --calib, and the server on its artifact
# ---------------------------------------------------------------------------

IMGSZ = 64


@pytest.fixture(scope="module")
def int8_artifact(tmp_path_factory):
    """`cli/export.py --quantize int8dw --calib ... --check` on a seeded
    Small CABiNet (the published table, as the CLI builds it), on the CPU,
    with a symbolic batch: (directory, the CLI's arguments, artifact,
    printed lines)."""
    import contextlib
    import io

    from cabinet_tpu_torch.cli.export import main
    from cabinet_tpu_torch.data.decode import save_png

    base = tmp_path_factory.mktemp("int8_export")
    torch.manual_seed(1)
    ckpt = base / "small.pth"
    torch.save(CABiNet(8, "small").state_dict(), ckpt)
    rng = np.random.default_rng(4)
    for i in range(3):
        save_png(base / f"calib_{i}.png", rng.integers(0, 256, (48, 80, 3), np.uint8))
    argv = ["--checkpoint", str(ckpt), "--dataset", "uavid", "--imgsz", str(IMGSZ),
            "--mode", "small", "--dtype", "float32", "--device", "cpu"]
    out, printed = base / "art", io.StringIO()
    with contextlib.redirect_stdout(printed):
        main(argv + ["--out", str(out), "--batch", "b", "--check", "--quantize",
                     "int8dw", "--calib", str(base / "calib_*.png")])
    return base, argv, out, printed.getvalue()


def test_cli_export_int8dw_check_on_cpu(int8_artifact):
    """The artifact loads back bit-equal to the live quantized module
    (--check), its metadata records the mode; without --calib, or with a
    glob that matches nothing, the CLI exits."""
    from cabinet_tpu_torch.cli.export import main
    from cabinet_tpu_torch.export import METADATA_NAME

    base, argv, out, printed = int8_artifact
    assert "calibrated 52 conv sites on 3 frames" in printed
    assert "round-trip check passed" in printed
    assert json.loads((out / METADATA_NAME).read_text())["quantize"] == "int8dw"
    with pytest.raises(SystemExit, match="requires --calib"):
        main(argv + ["--out", str(base / "x"), "--quantize", "int8dw"])
    with pytest.raises(SystemExit, match="matched no files"):
        main(argv + ["--out", str(base / "x"), "--quantize", "int8",
                     "--calib", str(base / "none_*.png")])
    assert not (base / "x").exists()


def test_server_answers_with_the_int8_artifacts_masks(int8_artifact):
    """The checkpoint-less server on the int8dw artifact: /healthz shows
    its metadata, and /segment answers 64x64 frames (no resize) with the
    masks the artifact itself gives."""
    from cabinet_tpu_torch.cli.serve import _Engine, make_server
    from cabinet_tpu_torch.data.decode import decode_png, encode_png, png_mask
    from cabinet_tpu_torch.export import load_artifact

    _, _, art, _ = int8_artifact
    engine = _Engine(str(art), None, None, "small", IMGSZ, "float32", max_batch=2,
                     deadline_ms=5.0, queue_depth=8, device="cpu")
    srv = make_server(engine, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            meta = json.loads(r.read())
        assert meta["quantize"] == "int8dw" and meta["status"] == "ok"
        serve, _ = load_artifact(art, "cpu")
        rng = np.random.default_rng(9)
        for _ in range(2):
            rgb = rng.integers(0, 256, (IMGSZ, IMGSZ, 3), np.uint8)
            req = urllib.request.Request(f"{url}/segment", data=encode_png(rgb),
                                         method="POST",
                                         headers={"Content-Type": "image/png"})
            with urllib.request.urlopen(req, timeout=120) as r:
                mask = png_mask(decode_png(r.read()))
            with torch.no_grad():
                want = serve(torch.from_numpy(rgb)[None])[0].numpy()
            np.testing.assert_array_equal(mask, want)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.batcher.close()
