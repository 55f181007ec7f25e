"""The port's prediction visualizer (cabinet_tpu_torch.cli.visualize) on the
CPU against the JAX package's `visualize` on a tiny UAVid-layout tree and
a small CABiNet (the truncated cfg table, perturbed weights): the input
and GT PNGs equal JAX's, and the pred and overlay PNGs equal JAX's at
every pixel whose top-2 margin of the summed multi-scale probabilities
exceeds the suite's f32 bound (2e-4 of the largest summed probability);
the sample cap is VISUALIZATION_SAMPLE_LIMIT's. The PNGs are read back
with PIL, so the port's encoder is held too."""

import numpy as np
import pytest
from PIL import Image

from cabinet_tpu.cli import common as jcommon
from cabinet_tpu.cli.visualize import visualize as jvisualize
from cabinet_tpu.core.config import compose as jcompose
from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.cli.visualize import main
from cabinet_tpu_torch.core.config import compose
from cabinet_tpu_torch.utils.convert import flat_variables
from test_torch_cli_train import TINY_MODEL, make_uavid_tree
from torch_port_utils import F32_REL, perturb

KINDS = ("input", "pred", "overlay", "gt")


def _png(path):
    return np.asarray(Image.open(path))


@pytest.fixture(scope="module")
def runs(tmp_path_factory, small_cabinet):
    root = tmp_path_factory.mktemp("viz")
    data = make_uavid_tree(root / "data", n=3, seed=4)
    variables = perturb(small_cabinet[1], seed=7)
    ckpt = root / "w.npz"
    np.savez(ckpt, **flat_variables(variables))
    base = TINY_MODEL + [f"checkpoint_path={ckpt}", "dataset=uavid",
                         f"dataset.dataset_path={data}", "dataset.cropsize=[32,32]",
                         "validation_config.eval_scales=[0.75,1.0]",
                         "validation_config.flip=true", "+num_samples=2"]
    ours = main(base + [f"+output_dir={root / 'port'}", "--device", "cpu"])
    jcfg = jcompose(jcommon.CONFIG_DIR, "evaluate", base + [f"+output_dir={root / 'jax'}"])
    orig = jcommon.load_model_variables
    jcommon.load_model_variables = lambda path, template: variables
    try:
        ref = jvisualize(jcfg)
    finally:
        jcommon.load_model_variables = orig
    cfg = compose(common.CONFIG_DIR, "evaluate", base)
    return ours, ref, cfg


@pytest.mark.parametrize("i", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_pngs_equal_jax(runs, kind, i):
    ours, ref, cfg = runs
    got, want = _png(ours / f"{i:04d}_{kind}.png"), _png(ref / f"{i:04d}_{kind}.png")
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    if kind in ("input", "gt"):
        assert np.array_equal(got, want)
        return
    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.eval.evaluator import MscEval

    (dataset,) = common.build_datasets(cfg, ["val"])
    img, _ = dataset[i]
    model = common.build_model(cfg, 8)
    model.load_state_dict(common.load_model_variables(cfg.checkpoint_path, model))
    probs = MscEval(make_eval_forward(model, 32, "cpu"), 8, scales=(0.75, 1.0), flip=True,
                    cropsize=32, device="cpu").prob_batch(None, img[None])[0]
    top2 = np.sort(probs, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > F32_REL * float(probs.max())
    assert clear.mean() > 0.9
    assert np.array_equal(got[clear], want[clear])


def test_only_the_samples_asked_for(runs):
    from cabinet_tpu.core.constants import VISUALIZATION_SAMPLE_LIMIT as JLIMIT
    from cabinet_tpu_torch.core.constants import VISUALIZATION_SAMPLE_LIMIT

    ours, ref, _ = runs
    assert VISUALIZATION_SAMPLE_LIMIT == JLIMIT
    assert sorted(p.name for p in ours.iterdir()) == sorted(p.name for p in ref.iterdir())
    assert len(list(ours.iterdir())) == 2 * len(KINDS)
