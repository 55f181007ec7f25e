"""The port's training CLI against the JAX package's on the same tiny
UAVid-layout tree from the same weights (the port warm-starts from a `.pth`
of them; the JAX CLI's warm start is handed them as they are), in f32:
epoch 0's train_loss and val_loss within 1e-4 of the JAX run's. The
augmented samples, class weights, OHEM, clipping, SGD and schedule are the
same, so the two runs differ by f32 rounding only."""

import json

import jax
import jax.numpy as jnp
import torch

from cabinet_tpu.cli import common as jcommon
from cabinet_tpu.cli.train import train_and_evaluate as j_train
from cabinet_tpu.core.config import compose as jcompose
from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu_torch.utils.convert import state_dict_from_jax
from test_torch_cli_train import TINY_MODEL, make_uavid_tree, overrides
from torch_port_utils import perturb

CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]]
REL = 1e-4


def test_epoch0_losses_match_the_jax_cli(tmp_path, monkeypatch):
    from cabinet_tpu_torch.cli.train import main

    data = make_uavid_tree(tmp_path / "data", size=(72, 80))
    jm = JaxCABiNet(n_classes=8, mode="small", cfgs=CFGS)
    v = perturb(jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False),
                seed=2)
    pth = tmp_path / "start.pth"
    torch.save(state_dict_from_jax(v, CFGS), pth)
    monkeypatch.setattr(jcommon, "warm_start",
                        lambda variables, path, cfgs: jax.tree_util.tree_map(jnp.asarray, v))
    results = {}
    for who in ("jax", "port"):
        exp = tmp_path / who
        args = overrides("uavid", data, exp, crop=64, epochs=1) + [
            f"training_config.pretrained_ckpt_path={pth}"]
        assert TINY_MODEL[1] in args
        if who == "jax":
            j_train(jcompose(jcommon.CONFIG_DIR, "train", args))
        else:
            main(args + ["--device", "cpu"])
        results[who] = [json.loads(ln) for ln in
                        (exp / "metrics.jsonl").read_text().splitlines()][1]
    ref, got = results["jax"], results["port"]
    assert got["step"] == ref["step"] == 2
    for key in ("train_loss", "val_loss"):
        assert abs(got[key] - ref[key]) <= REL * abs(ref[key]), (key, got[key], ref[key])
