"""The port's checkpoint conversion (cabinet_tpu_torch.cli.convert_checkpoint
and the numpy-only tables of utils/convert.py) against the JAX package's
`torch_to_flax` / `flax_to_torch`, bit for bit, on a small CABiNet (the
truncated cfg table of tests/conftest.py) and, through the CLI, on a
CABiNet-Small of the default table:
  - export (the port's .pth, or a JAX variables .npz) equals
    `flax_to_torch` of the same variables;
  - import of a reference .pth (a raw state dict, a training checkpoint
    with model_state/ema_state, the port's full training checkpoint) to a
    .npz equals `torch_to_flax(..., strict=False)`, and to a .pth loads
    strict into the port's CABiNet;
  - export then import round-trips bit for bit."""

import numpy as np
import pytest
import torch

from cabinet_tpu.utils.torch_convert import flax_to_torch, torch_to_flax
from cabinet_tpu_torch.cli import convert_checkpoint as cc
from cabinet_tpu_torch.models.cabinet import CABiNet
from cabinet_tpu_torch.utils.convert import flat_variables, state_dict_from_jax
from torch_port_utils import perturb

CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]]


@pytest.fixture(scope="module")
def variables(small_cabinet):
    """Numpy JAX variables of the small CABiNet, perturbed (every tensor
    distinct from its init)."""
    return perturb(small_cabinet[1], seed=3)


def _same(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        g, r = np.asarray(got[k]), np.asarray(ref[k])
        assert g.dtype == r.dtype and g.shape == r.shape, k
        assert np.array_equal(g, r), k


@pytest.mark.parametrize("source", ["npz", "port_pth"])
def test_export_equals_flax_to_torch(tmp_path, variables, source):
    if source == "npz":
        src = tmp_path / "v.npz"
        np.savez(src, **flat_variables(variables))
    else:
        src = tmp_path / "port.pth"
        torch.save(state_dict_from_jax(variables, CFGS), src)
    sd = cc.do_export(src, tmp_path / "ref.pth", mode="small", n_classes=8, cfgs=CFGS)
    ref = flax_to_torch(variables, CFGS)
    _same({k: v.numpy() for k, v in sd.items()}, ref)
    _same({k: v.numpy() for k, v in torch.load(tmp_path / "ref.pth").items()}, ref)


def _reference_pth(path, variables, kind):
    sd = {k: torch.from_numpy(v.copy()) for k, v in flax_to_torch(variables, CFGS).items()}
    if kind == "model_state":
        torch.save({"model_state": {k: v * 0 for k, v in sd.items()}, "ema_state": sd,
                    "epoch": 3}, path)
    elif kind == "full":
        from cabinet_tpu_torch.train.checkpoint import CheckpointManager
        from cabinet_tpu_torch.train.optimizer import GroupedSGD
        from cabinet_tpu_torch.train.trainer import create_train_state

        model = CABiNet(8, "small", cfgs=CFGS)
        model.load_state_dict(state_dict_from_jax(variables, CFGS))
        state = create_train_state(model, GroupedSGD(model, lr0=0.1, max_iter=4))
        CheckpointManager(path.parent).save_full(path.stem, state, 0, 0.0, 1.0,
                                                 {"best_fitness": 0.0, "best_epoch": 0})
    else:
        sd["mobile.classifier.0.weight"] = torch.zeros(3, 3)  # skipped, as in JAX
        torch.save(sd, path)
    return sd


@pytest.mark.parametrize("kind", ["raw", "model_state", "full"])
def test_import_npz_equals_torch_to_flax(tmp_path, variables, kind):
    src = tmp_path / "ck.pth"
    _reference_pth(src, variables, kind)
    flat = cc.do_import(src, tmp_path / "out.npz", mode="small", cfgs=CFGS)
    from cabinet_tpu.utils.torch_convert import load_torch_checkpoint

    blob = load_torch_checkpoint(src)
    if "opt_state" in blob:  # the port's full checkpoint: its raw weights
        blob = {**blob["params"], **blob["batch_stats"]}
    ref = flat_variables(torch_to_flax(blob, CFGS, strict=False))
    _same(flat, ref)
    with np.load(tmp_path / "out.npz") as data:
        _same({k: data[k] for k in ref}, ref)


def test_import_pth_loads_strict(tmp_path, variables):
    src = tmp_path / "ck.pth"
    sd = _reference_pth(src, variables, "raw")
    cc.do_import(src, tmp_path / "port.pth", mode="auto", cfgs=CFGS)
    port = torch.load(tmp_path / "port.pth")
    model = CABiNet(8, "small", cfgs=CFGS)
    own = model.state_dict()
    model.load_state_dict({**{k: v for k, v in own.items() if "num_batches" in k}, **port},
                          strict=True)
    for k, v in port.items():
        assert torch.equal(v, sd[k]), k


def test_cli_round_trip_default_small(tmp_path):
    """`main export` then `main import` of a CABiNet-Small (default table)
    state dict: every tensor back bit for bit; `_detect_mode` as JAX's."""
    from cabinet_tpu.cli.convert_checkpoint import _detect_mode as j_detect

    torch.manual_seed(0)
    model = CABiNet(6, "small")
    src = tmp_path / "ema.pth"
    torch.save(model.state_dict(), src)
    cc.main(["export", str(src), str(tmp_path / "ref.pth"), "--mode", "small",
             "--n-classes", "6"])
    ref = torch.load(tmp_path / "ref.pth")
    assert cc._detect_mode(ref) == j_detect(ref) == "small"
    cc.main(["import", str(tmp_path / "ref.pth"), str(tmp_path / "back.pth")])
    back = torch.load(tmp_path / "back.pth")
    want = {k: v for k, v in model.state_dict().items() if "num_batches" not in k}
    assert set(back) == set(want)
    assert all(torch.equal(back[k], want[k]) for k in want)
    with pytest.raises(RuntimeError):  # the class count is checked
        cc.main(["export", str(src), str(tmp_path / "x.pth"), "--mode", "small",
                 "--n-classes", "8"])
