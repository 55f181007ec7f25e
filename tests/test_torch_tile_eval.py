"""Tile-sharded eval in the port (`MscEval(tile_mesh=(rank, R))`,
cabinet_tpu_torch.eval.evaluator) on two gloo ranks on the CPU, each rank a
process of tests/torch_dp_worker.py under a time limit, against the
one-process `MscEval` and against the JAX package's tile-sharded sliding
window (`_sliding_probs_tile_sharded` over 8 virtual devices), on the JAX
test's saturated toy model (tests/unit/test_mesh_and_sharded_eval.py):
  - the confusion matrix at one scale bit-equal to one process's, on every
    rank, at tile_batch 16 and 8, the frame counted once;
  - one scale's probabilities at 0.5 and 1.0 with flip within 1e-5 of
    JAX's (the sums over ranks run in another order than over 8 devices),
    and with bf16 accumulation within 2e-2 of the f32 chain, as JAX holds
    its own;
  - the grid split: each rank's contiguous block of tiles, pad tiles not
    run; `cli/common.py:eval_tile_mesh` only inside a group of several
    ranks and with runtime.tile_parallel_eval on."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu_torch.core.config import Config
from cabinet_tpu_torch.eval import evaluator as ev
from test_torch_dp import run_case
from torch_dp_worker import toy_apply

N_CLASSES = 3


def _inputs():
    rng = np.random.default_rng(1)
    image = np.where(rng.random((1, 100, 88, 3)) > 0.5, 1.0, -1.0).astype(np.float32)
    labels = rng.integers(0, N_CLASSES, (1, 100, 88)).astype(np.int64)
    return image, labels


def _jax_apply(variables, images, train=False):
    m = (images.mean(axis=-1) > 0).astype(jnp.float32)
    logits = jnp.stack([1 - m, m, jnp.zeros_like(m)], axis=-1) * 7.0
    return logits, logits


@pytest.fixture(scope="module")
def ranks_out(tmp_path_factory):
    image, labels = _inputs()
    return run_case(tmp_path_factory.mktemp("tile"), "tile_eval",
                    {"image": image, "labels": labels})


@pytest.mark.parametrize("tile_batch", [16, 8])
def test_histogram_equals_one_process(ranks_out, tile_batch):
    image, labels = _inputs()
    one = ev.MscEval(toy_apply, N_CLASSES, scales=(1.0,), cropsize=32, device="cpu")
    _, hist = one.evaluate_batch(None, image, labels)
    for out in ranks_out:  # every rank holds the one-process matrix, counted once
        np.testing.assert_array_equal(out["hist"][tile_batch], hist)
    assert hist.sum() == 100 * 88


def test_histogram_equals_jax_tile_sharded(ranks_out):
    from cabinet_tpu.core.mesh import make_mesh
    from cabinet_tpu.eval.evaluator import MscEval as JaxMscEval

    image, labels = _inputs()
    _, want = JaxMscEval(_jax_apply, N_CLASSES, scales=(1.0,), cropsize=32,
                         tile_mesh=make_mesh()).evaluate_batch({}, image, labels)
    np.testing.assert_array_equal(ranks_out[0]["hist"][16], want)


@pytest.mark.parametrize("scale", [0.5, 1.0])
def test_probabilities_match_jax(ranks_out, scale):
    from cabinet_tpu.core.mesh import make_mesh
    from cabinet_tpu.eval.evaluator import _scale_probs

    image, _ = _inputs()
    want = np.asarray(_scale_probs(_jax_apply, N_CLASSES, 32, True, scale, {},
                                   jnp.asarray(image), make_mesh()))
    for out in ranks_out:
        np.testing.assert_allclose(out["probs"][scale].numpy(), want, atol=1e-5)
    np.testing.assert_array_equal(ranks_out[0]["probs"][scale].numpy(),
                                  ranks_out[1]["probs"][scale].numpy())
    # the one-device engine at that scale agrees too
    one = ev._summed_probs(toy_apply, N_CLASSES, 32, True, (scale,), None,
                           torch.from_numpy(image), ev.TILE_BATCH, torch.float32)
    np.testing.assert_allclose(one.numpy(), want, atol=1e-5)


def test_bf16_accumulation_within_cast_tolerance(ranks_out):
    from cabinet_tpu.core.mesh import make_mesh
    from cabinet_tpu.eval.evaluator import _scale_probs

    image, _ = _inputs()
    f32 = np.asarray(_scale_probs(_jax_apply, N_CLASSES, 32, False, 1.0, {},
                                  jnp.asarray(image), make_mesh(), tile_batch=8,
                                  acc_dtype=jnp.float32))
    for out in ranks_out:
        got = out["probs"]["bf16"]
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), f32, atol=2e-2)


def test_collectives_are_tallied_apart(ranks_out):
    """One f32 all-reduce a scale (probabilities and counts in one buffer),
    tagged apart; no confusion-matrix sum over the ranks."""
    for out in ranks_out:
        comm = out["comm"]
        # 2 evaluations at 1 scale, then 2 + 1 single-scale probability maps
        assert comm["tile_all_reduce"] == 5 and "eval" not in comm


def test_grid_split_is_jaxs_blocks():
    """Each rank forwards its contiguous block of the padded grid,
    `group` tiles a forward, and no pad tile."""
    image, _ = _inputs()
    full_h, full_w = 100, 88
    grid = ev.tile_grid(full_h, full_w, 32)
    seen = {}
    for rank in range(3):  # no process group here: the all-reduce is the identity
        calls = []

        def apply(_, chips, calls=calls):
            calls.append(chips.shape[0])
            return toy_apply(None, chips)

        ev._sliding_probs_tile_sharded(apply, N_CLASSES, 32, False, (rank, 3), None,
                                       torch.from_numpy(image), tile_batch=4)
        seen[rank] = calls
    # 16 tiles, group min(4, ceil(16/3)=6) = 4, t_pad 24: blocks of 8
    assert len(grid) == 16
    assert seen == {0: [4, 4], 1: [4, 4], 2: []}


def test_eval_tile_mesh_needs_ranks(monkeypatch):
    from cabinet_tpu_torch.cli.common import eval_tile_mesh

    on = Config({"runtime": {"tile_parallel_eval": True}})
    off = Config({"runtime": {"tile_parallel_eval": False}})
    assert eval_tile_mesh(on) is None  # no group
    monkeypatch.setattr(ev.mesh, "is_distributed", lambda: True)
    monkeypatch.setattr(ev.mesh, "world", lambda: (1, 2))
    assert eval_tile_mesh(on) == (1, 2)
    assert eval_tile_mesh(Config({"runtime": {}})) == (1, 2)  # JAX's default: on
    assert eval_tile_mesh(off) is None


_EVALUATE = """
import json, os, sys, torch
torch.set_num_threads(1)
from cabinet_tpu_torch.cli.evaluate import main
res = main(json.loads(sys.argv[1]))
torch.save({"hist": res["confusion_matrix"], "frames": res["timing"]["frames"]},
           os.path.join(sys.argv[2], "rank%s.pt" % os.environ.get("RANK", "0")))
"""


@pytest.mark.parametrize("mode", ["tiles", "frames_int8"])
def test_evaluate_main_on_two_ranks(tmp_path, mode):
    """`cli/evaluate.py` main under torchrun's environment on 2 gloo ranks
    against 1 rank, f32 on a small CABiNet: tile-sharded (the default), each
    rank scoring every frame, the matrices equal; with
    runtime.tile_parallel_eval=false and int8 PTQ, each rank scoring its
    share of the frames after calibrating on the split's first batches,
    the summed matrix equal to one rank's."""
    import json

    from cabinet_tpu_torch.cli.evaluate import main
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from test_torch_cli_train import TINY_MODEL, make_uavid_tree
    from test_torch_dp import run_ranks

    data = make_uavid_tree(tmp_path / "data", n=3, size=(40, 56))
    torch.manual_seed(3)
    model = CABiNet(8, mode="small", cfgs=[[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2],
                                           [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]])
    torch.save(model.state_dict(), tmp_path / "ck.pth")
    argv = TINY_MODEL + [f"checkpoint_path={tmp_path / 'ck.pth'}", "dataset=uavid",
                         f"dataset.dataset_path={data}", "dataset.cropsize=[32,32]",
                         "validation_config.batch_size=1", "validation_config.num_workers=0",
                         "validation_config.eval_scales=[0.75,1.0]",
                         "+runtime.dist_backend=gloo", "+runtime.dist_timeout_s=60"]
    if mode == "frames_int8":
        argv += ["+runtime.tile_parallel_eval=false", "+runtime.quantize=int8"]
    argv.append("--device=cpu")
    run_ranks(["-c", _EVALUATE, json.dumps(argv), str(tmp_path)], 2)
    two = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # as the ranks run
    try:
        res = main(argv)  # one rank, in this process
    finally:
        torch.set_num_threads(threads)
    assert res["timing"]["frames"] == 3 and res["confusion_matrix"].sum() == 3 * 40 * 56
    for rec in two:
        np.testing.assert_array_equal(rec["hist"], res["confusion_matrix"])
    frames = [rec["frames"] for rec in two]
    assert frames == ([3, 3] if mode == "tiles" else [2, 1])
