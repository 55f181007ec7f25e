"""The port's YOLO-sem family (cabinet_tpu_torch/models/yolosem.py) and its
weight bridge (utils/convert.py) against the JAX package's
(cabinet_tpu/models/yolosem.py) on the CPU: parameter counts of all five
variants, strict loading of converted variables, the f32 forward (logits
and aux), the pipeline cut, train-mode BatchNorm statistics, the name
lookup. Bound: the suite's 2e-4 of max |ref| in f32 unless named."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.models.yolosem import YOLOSem as JaxYOLOSem
from cabinet_tpu.models.yolosem import build_yolosem as jax_build
from cabinet_tpu_torch.models.yolosem import YOLOSem, build_yolosem
from cabinet_tpu_torch.utils.convert import (
    BN,
    yolosem_mapping,
    yolosem_site_keys,
    yolosem_state_dict_from_jax,
)
from torch_port_utils import (
    assert_close_f32,
    assert_updates_close,
    nchw,
    nhwc,
    yolo_port_model,
    yolo_variables,
)

VARIANTS = "nsmlx"
PUBLISHED_M = {"n": 1.63, "s": 6.50, "m": 14.32, "l": 17.87, "x": 40.16}
NC = 5


def _jax_shapes(variant):
    x = jnp.zeros((1, 64, 64, 3), jnp.float32)
    model = JaxYOLOSem(n_classes=8, variant=variant)
    return jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), x, train=False))


@pytest.fixture(scope="module")
def n_model():
    """JAX variables of the n variant with noise, the port's model on them,
    and a (2, 64, 64, 3) input."""
    v = yolo_variables(NC, "n", seed=1)
    x = np.random.default_rng(0).standard_normal((2, 64, 64, 3)).astype(np.float32)
    return v, yolo_port_model(v, NC, "n"), x


@pytest.mark.parametrize("variant", VARIANTS)
def test_param_counts_equal_jax_and_published(variant):
    """The port's parameter count equals jax.eval_shape's exactly, and the
    published yolo26-sem count within 2.5% (tests/unit/test_param_counts.py)."""
    shapes = _jax_shapes(variant)
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    with torch.device("meta"):
        got = sum(p.numel() for p in YOLOSem(8, variant).parameters())
    assert got == want
    assert got / 1e6 == pytest.approx(PUBLISHED_M[variant], rel=0.025)


@pytest.mark.parametrize("variant", VARIANTS)
def test_strict_load_of_converted_variables(variant):
    """Variables of every shape that JAX's init gives, seeded, nested and
    flat, load strictly; each tensor lands transposed (HWIO -> OIHW)."""
    shapes = _jax_shapes(variant)
    rng = np.random.default_rng(3)
    nested = jax.tree_util.tree_map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)
    model = YOLOSem(8, variant)
    sd = yolosem_state_dict_from_jax(nested, variant)
    model.load_state_dict(sd, strict=True)
    flat = {"/".join(str(getattr(p, "key", p)) for p in path): a
            for path, a in jax.tree_util.tree_flatten_with_path(nested)[0]}
    sd_flat = yolosem_state_dict_from_jax(flat, variant)
    assert set(sd_flat) == set(sd)
    assert all(torch.equal(sd[k], sd_flat[k]) for k in sd)
    kernel = nested["params"]["c2f_2"]["m0"]["cv1"]["conv"]["kernel"]
    assert torch.equal(model.c2f_2.m0.cv1.conv.weight.detach(),
                       torch.from_numpy(kernel).permute(3, 2, 0, 1))
    assert torch.equal(model.classifier.bias.detach(),
                       torch.from_numpy(nested["params"]["classifier"]["bias"]))


def test_module_names_read_as_flax_paths():
    """A state-dict key is its flax path joined by dots: the table maps
    conv.weight <-> conv/kernel, bn.* <-> bn/{scale,bias,mean,var}, and
    the site keys are the conv paths."""
    for torch_key, flax_path, kind in yolosem_mapping("n"):
        stem = torch_key if kind == BN else torch_key.rsplit(".", 1)[0]
        assert stem == ".".join(flax_path[:len(stem.split("."))])
    keys = yolosem_site_keys("n")
    assert keys["c2f_2.m0.cv1.conv"] == "c2f_2/m0/cv1/conv"
    assert keys["classifier"] == "classifier" and keys["sppf.cv2.conv"] == "sppf/cv2/conv"
    assert set(keys) == {n for n, m in YOLOSem(8, "n").named_modules()
                         if isinstance(m, torch.nn.Conv2d)}


def test_forward_matches_jax(n_model):
    """yolo26n-sem in f32 at 64^2, batch 2: logits and aux against
    YOLOSem.apply."""
    v, model, x = n_model
    ref, ref_aux = JaxYOLOSem(n_classes=NC, variant="n").apply(v, jnp.asarray(x), train=False)
    with torch.no_grad():
        got, got_aux = model(nchw(x))
    assert got.shape == (2, NC, 64, 64) and got_aux.shape == (2, NC, 64, 64)
    assert_close_f32(nhwc(got), ref)
    assert_close_f32(nhwc(got_aux), ref_aux)


def test_non_square_input_keeps_its_size():
    """(2, 3, 64, 96) -> logits and aux of (2, 5, 64, 96), as the JAX
    test_forward_shapes_and_dual_output holds."""
    torch.manual_seed(0)
    with torch.no_grad():
        out, aux = build_yolosem(NC, "yolo26n-sem").eval()(torch.zeros(2, 3, 64, 96))
    assert out.shape == aux.shape == (2, NC, 64, 96)


def test_backbone_cut_equals_backbone(n_model):
    """backbone_back(backbone_front(x)) == backbone(x) bit for bit, and
    decode(x, backbone(x)) is the forward (the pipeline engine's cuts)."""
    _, model, x = n_model
    t = nchw(x)
    with torch.no_grad():
        whole = model.backbone(t)
        cut = model.backbone_back(model.backbone_front(t))
        assert all(torch.equal(a, b) for a, b in zip(whole, cut))
        assert whole[0].shape[2:] == (8, 8) and whole[2].shape[2:] == (2, 2)
        for a, b in zip(model.decode(t, whole), model(t)):
            assert torch.equal(a, b)


def test_train_mode_batch_stats_match_flax(n_model):
    """One train-mode forward: every BN's running mean and (biased)
    running variance against flax's mutated batch_stats at momentum 0.97,
    eps 1e-3, and the train-mode logits; within the f32 bound of each
    tensor's change from its start, plus a few ulps of its magnitude."""
    v, _, x = n_model
    (ref, _), mutated = JaxYOLOSem(n_classes=NC, variant="n").apply(
        v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    model = yolo_port_model(v, NC, "n").train()
    start = {k: t.clone() for k, t in model.state_dict().items()}
    with torch.no_grad():
        got, _ = model(nchw(x))
    assert_close_f32(nhwc(got), ref)
    stats_jax = jax.tree_util.tree_map(np.asarray, mutated["batch_stats"])
    want = yolosem_state_dict_from_jax({"params": v["params"], "batch_stats": stats_jax}, "n")
    stats = {k: t for k, t in model.state_dict().items() if k.endswith(("running_mean",
                                                                       "running_var"))}
    assert len(stats) == 2 * sum(1 for m in model.modules()
                                 if isinstance(m, torch.nn.BatchNorm2d))
    assert_updates_close(stats, {k: want[k] for k in stats}, {k: start[k] for k in stats},
                         rel=2e-4)


def test_batch_norm_is_flax_s():
    """eps 1e-3 and torch momentum 0.03 (flax's 0.97) on every BN."""
    bns = [m for m in YOLOSem(8, "n").modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert bns and all(m.eps == 1e-3 and m.momentum == 0.03 for m in bns)


def test_build_yolosem_name_lookup():
    """Reference names, bare letters and *-sem suffixes give the variant
    that JAX's factory gives; an unknown name raises in both."""
    with torch.device("meta"):
        for name in [f"yolo26{v}-sem" for v in VARIANTS] + list(VARIANTS) + ["YOLO26X-SEM"]:
            assert build_yolosem(8, name).variant == jax_build(8, name).variant
    for bad in ("resnet50", "yolov8n-seg"):
        with pytest.raises(ValueError):
            build_yolosem(8, bad)
        with pytest.raises(ValueError):
            jax_build(8, bad)
    with pytest.raises(ValueError, match="variant"):
        YOLOSem(8, "q")
