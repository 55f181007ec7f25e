"""The port's checkpoints (cabinet_tpu_torch.train.checkpoint) and the
weight loaders of cli/common: a save/restore in the middle of an
accumulation window resumes bit-exactly, the EMA `.pth` scores through the
port's evaluate CLI, and the warm start and the backbone load take the
tensors the JAX package's `merge_variables` and `backbone_torch_to_flax`
take."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.utils.torch_convert import backbone_torch_to_flax, merge_variables
from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.core.exceptions import ModelLoadError
from cabinet_tpu_torch.train import trainer as T
from cabinet_tpu_torch.train.checkpoint import CheckpointManager, load_any_checkpoint
from cabinet_tpu_torch.train.optimizer import GroupedSGD
from cabinet_tpu_torch.utils.convert import state_dict_from_jax
from torch_port_utils import jax_tree_from_state_dict, perturb, port_model

CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]]
S, B, NC = 64, 2, 8
OPT = dict(lr0=0.1, max_iter=10, momentum=0.9, wd=5e-4, warmup_steps=1,
           warmup_start_lr=0.02, max_grad_norm=1.0)


def _jax_variables(n_classes, seed):
    jm = JaxCABiNet(n_classes=n_classes, mode="small", cfgs=CFGS)
    return perturb(jm.init(jax.random.PRNGKey(seed), jnp.zeros((1, S, S, 3)), train=False),
                   seed=seed)


def _state(v):
    model = port_model(v, NC, "small", CFGS)
    return T.create_train_state(model, GroupedSGD(model, **OPT), 0.9, 2.0)


def _snapshot(state):
    return {"model": {k: t.clone() for k, t in state.model.state_dict().items()},
            "ema": {k: t.clone() for k, t in state.ema.shadow.items()},
            "momentum": [state.optimizer.sgd.state[p]["momentum_buffer"].clone()
                         for p in state.optimizer.parameters()],
            "counters": (state.step, state.micro_step, state.ema.updates)}


def test_resume_is_bit_exact(tmp_path):
    """5 micro-steps at accum_steps=2 uninterrupted, against 3 steps, a
    save_full with the window half full, a restore into a fresh trainer
    (other weights, no momentum), 2 more steps: params, BN statistics,
    momentum, EMA and counters bit-equal on the CPU."""
    v = _jax_variables(NC, 1)
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((5, B, S, S, 3)).astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, NC, (5, B, S, S)))
    step = T.make_train_step(n_min=B * S * S // 16, accum_steps=2)

    whole = _state(v)
    for i in range(5):
        step(whole, xs[i], ys[i])
    first = _state(v)
    for i in range(3):
        step(first, xs[i], ys[i])
    assert first.micro_step == 1 and any(g.abs().sum() > 0
                                         for g in first.accum_grads.values())
    ckpt = CheckpointManager(tmp_path / "exp")
    ckpt.save_full("checkpoint_last", first, epoch=4, best_miou=0.25, best_loss=1.5,
                   stopper_state={"best_fitness": 0.25, "best_epoch": 3})
    resumed = _state(_jax_variables(NC, 7))
    meta = ckpt.restore_full("checkpoint_last", resumed)
    assert meta["epoch"] == 4 and meta["best_miou"] == 0.25
    assert meta["early_stop_best_epoch"] == 3
    assert json.loads((tmp_path / "exp" / "checkpoint_last.meta.json").read_text()) == {
        k: meta[k] for k in ("epoch", "best_miou", "best_loss", "early_stop_best_fitness",
                             "early_stop_best_epoch")}
    for i in range(3, 5):
        step(resumed, xs[i], ys[i])
    a, b = _snapshot(whole), _snapshot(resumed)
    assert a["counters"] == b["counters"] == (2, 1, 2)
    for k in a["model"]:
        assert torch.equal(a["model"][k], b["model"][k]), k
    for k in a["ema"]:
        assert torch.equal(a["ema"][k], b["ema"][k]), k
    assert all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"]))
    for n, p in whole.model.named_parameters():
        assert torch.equal(p.grad, dict(resumed.model.named_parameters())[n].grad)
    assert ckpt.restore_full("absent", resumed) is None


def test_ema_pth_scores_through_evaluate(tmp_path):
    """save_variables of the EMA weights writes a state dict that the
    port's evaluate CLI takes as checkpoint_path; the full checkpoint
    loads through it too (its raw weights)."""
    from cabinet_tpu_torch.cli.evaluate import main as evaluate_main
    from cabinet_tpu_torch.data.decode import save_png

    state = _state(_jax_variables(NC, 2))
    ckpt = CheckpointManager(tmp_path / "exp")
    ema_path = ckpt.save_variables("tiny", state.ema_variables)
    full_path = ckpt.save_full("checkpoint_last", state, 0, 0.0, 1.0,
                               {"best_fitness": 0.0, "best_epoch": 0})
    root = tmp_path / "data"
    rng = np.random.default_rng(0)
    for sub in ("images/val", "masks/val"):
        (root / sub).mkdir(parents=True)
    for i in range(2):
        save_png(root / "images/val" / f"s{i}.png",
                 rng.integers(0, 256, (40, 56, 3), dtype=np.uint8))
        save_png(root / "masks/val" / f"s{i}.png",
                 rng.integers(0, NC, (40, 56), dtype=np.uint8))
    model_args = ["model=mobilenetv3_small", f"model.cfgs={json.dumps(CFGS)}"]
    results = []
    for path in (ema_path, full_path):
        results.append(evaluate_main(model_args + [
            "dataset=uavid", f"dataset.dataset_path={root}", "dataset.cropsize=[32,32]",
            f"checkpoint_path={path}", "validation_config.batch_size=1",
            "validation_config.eval_scales=[1.0]", "validation_config.flip=false",
            "--device", "cpu"]))
    assert all(0.0 <= r["mIoU"] <= 1.0 and r["timing"]["frames"] == 2 for r in results)
    assert torch.equal(load_any_checkpoint(ema_path)["ab.a2block.gamma"],
                       state.ema_variables["ab.a2block.gamma"])
    restored = ckpt.restore_variables("tiny")
    assert all(torch.equal(restored[k], v) for k, v in state.ema_variables.items())
    with pytest.raises(ModelLoadError, match="not found"):
        ckpt.restore_variables("absent")


def test_orbax_directory_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="convert_checkpoint"):
        load_any_checkpoint(tmp_path)


def test_warm_start_matches_merge_variables(tmp_path):
    """A 5-class model warm-started from an 8-class `.pth` takes every
    tensor of matching name and shape and keeps its own classifier heads,
    as merge_variables(match_shapes=True) of the JAX package merges them."""
    base, other = _jax_variables(5, 3), _jax_variables(NC, 4)
    path = tmp_path / "other.pth"
    torch.save(state_dict_from_jax(other, CFGS), path)
    model = port_model(base, 5, "small", CFGS)
    keys = common.warm_start(model, str(path))
    merged = merge_variables(jax.tree_util.tree_map(jnp.asarray, base), other,
                             match_shapes=True)
    ref = state_dict_from_jax(jax.tree_util.tree_map(np.asarray, merged), CFGS)
    got = model.state_dict()
    for k, r in ref.items():
        assert torch.equal(got[k], r), k
    skipped = {k for k in got if k not in keys}
    assert {"ab.b4.weight", "ab.b4.bias", "conv_out.conv_out.weight"} <= skipped
    assert "mobile.features.0.0.weight" in keys


def test_backbone_pth_matches_backbone_torch_to_flax(tmp_path):
    """An ImageNet-layout backbone `.pth` (features.*, conv.*, classifier.*)
    loads into the same `mobile` tensors that JAX's backbone_torch_to_flax
    gives; the rest of the model is untouched."""
    v = _jax_variables(NC, 5)
    donor = port_model(_jax_variables(NC, 6), NC, "small", CFGS).state_dict()
    bb = {k[len("mobile."):]: t for k, t in donor.items() if k.startswith("mobile.")}
    bb["classifier.0.weight"] = torch.ones(1280, 96)
    path = tmp_path / "mobilenetv3.pth"
    torch.save(bb, path)
    model = port_model(v, NC, "small", CFGS)
    before = {k: t.clone() for k, t in model.state_dict().items()}
    common.load_pretrained_backbone(model, path)
    flax_bb = backbone_torch_to_flax({k: t.numpy() for k, t in bb.items()}, CFGS)
    tree = jax_tree_from_state_dict(before, CFGS)
    tree["params"]["mobile"] = flax_bb["params"]
    tree["batch_stats"]["mobile"] = flax_bb["batch_stats"]
    ref = state_dict_from_jax(tree, CFGS)
    got = model.state_dict()
    for k, r in ref.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(got[k], r), k
    assert torch.equal(got["sb.conv1.conv.weight"], before["sb.conv1.conv.weight"])
    del bb["features.0.0.weight"]
    torch.save(bb, path)
    with pytest.raises(Exception, match="lacks backbone tensors"):
        common.load_pretrained_backbone(model, path)
