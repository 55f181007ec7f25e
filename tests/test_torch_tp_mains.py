"""The train mains with tensor parallelism on 2 gloo CPU ranks, each rank a
process under a time limit, against the same main on 1 rank:
`cli/train.py` with runtime.model_axis=2, and with runtime.pipeline=2
+runtime.pipeline_tp=2 +runtime.eval_model_axis=2: the losses within 1e-5
of |ref|, the weights within tests/test_torch_dp.py's bound for ranks, one
set of files, the `.pth` the one-rank layout's, and evaluate main scores
it (tests/test_torch_tensor_parallel.py and test_torch_pipeline_tp.py hold
the layers against JAX)."""

import torch

from test_torch_dp import _updates_close, run_main

LOSS_REL = 1e-5


def test_train_main_model_axis_on_two_ranks(tmp_path):
    """runtime.model_axis=2 on 2 ranks (data 1 x model 2; tp_min_features
    64, so that the small model's wide layers split), 2 epochs of 2 steps,
    against 1 rank: one set of files, the losses within 1e-5, the weights
    and EMA within the bound for ranks, the `.pth` loaded strict=True and
    scored by evaluate main."""
    from cabinet_tpu_torch.cli.evaluate import main as evaluate_main
    from test_torch_cli_train import TINY_MODEL, make_uavid_tree, overrides
    from test_torch_dp import _files, _init_weights, _metrics

    data = make_uavid_tree(tmp_path / "data", n=8)
    extra = ["training_config.batch_size=4", "+runtime.dist_backend=gloo",
             "+runtime.dist_timeout_s=60", "runtime.tp_min_features=64"]
    runs = {}
    for ranks, axis in ((1, []), (2, ["runtime.model_axis=2"])):
        exp = tmp_path / f"exp{ranks}"
        argv = overrides("uavid", data, exp, crop=64) + extra + axis
        runs[ranks] = (exp, run_main("train", argv + ["--device", "cpu"], ranks)[0], argv)
    (exp1, res1, argv1), (exp2, res2, _) = runs[1], runs[2]
    assert _files(exp2) == _files(exp1)
    for a, b in zip(_metrics(exp1), _metrics(exp2)):
        if "epoch" in a:
            for k in ("train_loss", "val_loss"):
                assert abs(a[k] - b[k]) <= LOSS_REL * abs(a[k]), (k, a, b)
    coll = res2["timing"]["collectives"]
    assert coll["tp_forward"]["calls"] > 0 and coll["tp_grad_broadcast"]["calls"] == 4
    assert "grad_all_reduce" not in coll or coll["grad_all_reduce"]["calls"] == 0
    start = _init_weights("train", argv1)
    for name in ("tiny.pth", "checkpoint_last.pth"):
        a, b = torch.load(exp1 / name), torch.load(exp2 / name)
        if "params" in a:
            assert a["opt_state"]["state"].keys() == b["opt_state"]["state"].keys()
            a, b = {**a["params"], **a["batch_stats"]}, {**b["params"], **b["batch_stats"]}
        assert a.keys() == b.keys() and all(a[k].shape == b[k].shape for k in a)
        _updates_close(b, a, start)
    res = evaluate_main(TINY_MODEL + [
        f"checkpoint_path={exp2 / 'tiny.pth'}", "dataset=uavid", f"dataset.dataset_path={data}",
        "validation_config.batch_size=1", "dataset.cropsize=[64,64]", "--device", "cpu"])
    assert 0.0 <= res["mIoU"] <= 1.0


def test_train_main_pipeline_tp_on_two_ranks(tmp_path):
    """runtime.pipeline=2 with +runtime.pipeline_tp=2 and
    +runtime.eval_model_axis=2 on 2 ranks (tp_min_features 64), accum 2
    (one window an epoch), 2 epochs, against the one-rank pipeline main:
    the losses within 1e-5, the stages' checkpoint and the EMA `.pth` the
    one-rank layout's and within the bound for ranks."""
    from test_torch_cli_train import make_uavid_tree, overrides
    from test_torch_dp import _files, _init_weights, _metrics

    data = make_uavid_tree(tmp_path / "data", n=8)
    extra = ["training_config.batch_size=4", "training_config.accum_steps=2",
             "+runtime.dist_backend=gloo", "+runtime.dist_timeout_s=60",
             "runtime.tp_min_features=64", "runtime.pipeline=2"]
    runs = {}
    for ranks, axis in ((1, []), (2, ["+runtime.pipeline_tp=2", "+runtime.eval_model_axis=2"])):
        exp = tmp_path / f"exp{ranks}"
        argv = overrides("uavid", data, exp, crop=64) + extra + axis
        runs[ranks] = (exp, run_main("train", argv + ["--device", "cpu"], ranks)[0], argv)
    (exp1, _, argv1), (exp2, res2, _) = runs[1], runs[2]
    assert _files(exp2) == _files(exp1)
    for a, b in zip(_metrics(exp1), _metrics(exp2)):
        if "epoch" in a:
            for k in ("train_loss", "val_loss"):
                assert abs(a[k] - b[k]) <= LOSS_REL * abs(a[k]), (k, a, b)
    coll = res2["timing"]["collectives"]
    assert coll["tp_forward"]["calls"] > 0 and coll["tp_grad_broadcast"]["calls"] == 4
    start = _init_weights("train", argv1)
    a, b = torch.load(exp1 / "checkpoint_last.pth"), torch.load(exp2 / "checkpoint_last.pth")
    assert len(a["stages"]) == len(b["stages"]) == 2
    for ta, tb in zip(a["stages"], b["stages"]):
        assert {k: v.shape for k, v in ta["params"].items()} == {
            k: v.shape for k, v in tb["params"].items()}
    a, b = torch.load(exp1 / "tiny.pth"), torch.load(exp2 / "tiny.pth")
    assert a.keys() == b.keys()
    _updates_close(b, a, start)
