"""One rank of a case over ranks of tests/test_torch_dp.py (data
parallelism), tests/test_torch_tile_eval.py (tile-sharded eval),
tests/test_torch_pipeline.py (the pipeline's intra-stage data parallelism)
or tests/test_torch_tensor_parallel.py and tests/test_torch_pipeline_tp.py
(tensor parallelism on a (data, model) mesh).

    python -m torch_dp_worker CASE DIR

runs under torchrun's environment (RANK, WORLD_SIZE, LOCAL_RANK,
MASTER_ADDR, MASTER_PORT), joins a gloo group on the CPU through
`cabinet_tpu_torch.core.mesh.setup`, reads `DIR/inputs.pt`, runs CASE on
its share and writes `DIR/rank<r>.pt`. Imports nothing of JAX."""

import sys
from pathlib import Path

import torch

from cabinet_tpu_torch.core import mesh

CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]]


def case_batch_norm(inp, rank, ranks):
    """The port's BatchNorm2d in train mode on this rank's rows."""
    from cabinet_tpu_torch.models.layers import batch_norm

    x, g = inp["x"], inp["grad"]
    bn = batch_norm(x.shape[1])
    bn.load_state_dict(inp["state"])
    bn.train()
    mine = x[rank::ranks].clone().requires_grad_(True)
    y = bn(mine)
    (y * g[rank::ranks]).sum().backward()
    return {"y": y.detach(), "x_grad": mine.grad, "w_grad": bn.weight.grad,
            "b_grad": bn.bias.grad, "state": bn.state_dict()}


def case_losses(inp, rank, ranks):
    """Each loss's share on this rank's rows, and its gradient."""
    from cabinet_tpu_torch.train.losses import cross_entropy_mean, ohem_cross_entropy

    out = {}
    for name, spec in inp["cases"].items():
        logits = spec["logits"][rank::ranks].clone().requires_grad_(True)
        labels = spec["labels"][rank::ranks]
        cw = spec.get("cw")
        if spec["kind"] == "ce":
            loss = cross_entropy_mean(logits, labels, 255, cw, share=True)
        else:
            loss = ohem_cross_entropy(logits, labels, spec["n_min"], 0.7, 255, cw,
                                      method=spec["kind"], share=True)
        loss.backward()
        out[name] = {"loss": loss.detach(), "grad": logits.grad}
    return out


def case_augment(inp, rank, ranks):
    """DeviceAugment with shard=(rank, ranks) on this rank's loader rows."""
    from cabinet_tpu_torch.cli.train import DeviceAugment

    out = {}
    for name, spec in inp["cases"].items():
        aug = DeviceAugment(spec["cfg"], spec["ds"], torch.device("cpu"), spec["crop"],
                            shard=(rank, ranks))
        batch = tuple(a[rank::ranks] for a in spec["batch"])
        out[name] = aug(batch, 3, 1)
    return out


def case_train(inp, rank, ranks):
    """The port's train step on this rank's rows of each global batch,
    then the flush: losses, weights, EMA, momentum, counters."""
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import GroupedSGD

    model = CABiNet(8, mode="small", cfgs=CFGS, remat=inp["remat"])
    model.load_state_dict(inp["state_dict"], strict=True)
    names = {id(p): n for n, p in model.named_parameters()}
    opt = GroupedSGD(model, max_grad_norm=1.0, **inp["opt"])
    state = T.create_train_state(model, opt, **inp["ema"])
    step = T.make_train_step(n_min=inp["n_min"], class_weights=inp["cw"],
                             accum_steps=inp["accum"], ohem_method=inp["method"])
    losses = []
    for x, y in zip(inp["xs"], inp["ys"]):
        state, loss = step(state, x[rank::ranks], y[rank::ranks])
        losses.append(loss)
    T.make_flush_step()(state)
    momentum = {names[id(p)]: s["momentum_buffer"].clone()
                for p, s in opt.sgd.state.items() if "momentum_buffer" in s}
    return {"losses": torch.stack(losses), "state": model.state_dict(),
            "ema": state.ema.state_dict(), "momentum": momentum,
            "counters": (state.step, state.micro_step, state.ema.updates)}


def case_eval(inp, rank, ranks):
    """MscEval.evaluate over this rank's share of the frames."""
    from cabinet_tpu_torch.data.loader import DataLoader
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.models.cabinet import CABiNet

    model = CABiNet(8, mode="small", cfgs=CFGS)
    model.load_state_dict(inp["state_dict"], strict=True)
    model.eval()

    def fwd(_, images):
        with torch.no_grad():
            return tuple(t.permute(0, 2, 3, 1) for t in model(images.permute(0, 3, 1, 2)))

    frames = list(zip(inp["images"], inp["labels"]))
    loader = DataLoader(frames, 1, num_workers=0, shard=(rank, ranks))
    res = MscEval(fwd, 8, scales=(0.75, 1.0), flip=True, cropsize=32,
                  device="cpu").evaluate(None, loader)
    return {"hist": res["confusion_matrix"], "frames": res["timing"]["frames"]}


def toy_apply(_, images):
    """The JAX test's saturated toy model (tests/unit/test_mesh_and_sharded_
    eval.py): class 1 where the pixel's mean is positive, else 0, logits 7."""
    m = (images.float().mean(dim=-1) > 0).float()
    logits = torch.stack([1 - m, m, torch.zeros_like(m)], dim=-1) * 7.0
    return logits, logits


def case_tile_eval(inp, rank, ranks):
    """Tile-sharded eval over this group (`tile_mesh=(rank, ranks)`): the
    confusion matrices of MscEval.evaluate at one scale (tile_batch 16 and
    8), one scale's probabilities at 0.5 and 1.0 with flip, and in bf16
    accumulation, with the collectives' tally."""
    from cabinet_tpu_torch.data.loader import DataLoader
    from cabinet_tpu_torch.eval import evaluator as ev

    image, labels = inp["image"], inp["labels"]
    tile = (rank, ranks)
    loader = DataLoader(list(zip(image, labels)), 1, num_workers=0)
    out = {"hist": {}, "probs": {}}
    for tb in (16, 8):
        res = ev.MscEval(toy_apply, 3, scales=(1.0,), cropsize=32, tile_batch=tb,
                         device="cpu", tile_mesh=tile).evaluate(None, loader)
        out["hist"][tb] = res["confusion_matrix"]
    x = torch.from_numpy(image)
    for s in (0.5, 1.0):
        out["probs"][s] = ev._scale_probs(toy_apply, 3, 32, True, s, None, x, tile)
    out["probs"]["bf16"] = ev._scale_probs(toy_apply, 3, 32, False, 1.0, None, x, tile,
                                           tile_batch=8, acc_dtype=torch.bfloat16)
    out["comm"] = {k: v["calls"] for k, v in mesh.COMM.items()}
    return out


def case_pipeline(inp, rank, ranks):
    """The 2-stage CABiNet pipeline (both stages on the CPU) over this
    rank's rows of every microbatch, 2 windows of 2: losses, merged
    weights and EMA, counters, the case's collectives. With `global_bn`
    (one rank; the tests run it in their own process) the BatchNorm takes
    the ranks' formula (`_global_forward`) for the case's length."""
    from cabinet_tpu_torch.models import layers
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.train.optimizer import GroupedSGD
    from cabinet_tpu_torch.train.pipeline import CabinetPipeline, PipelineTrainLoop

    plain, comm0 = layers.BatchNorm2d.forward, {k: dict(v) for k, v in mesh.COMM.items()}
    if inp["global_bn"]:
        layers.BatchNorm2d.forward = (lambda self, x: self._global_forward(x)
                                      if self.training else plain(self, x))
    try:
        model = CABiNet(8, mode="small", cfgs=CFGS)
        pipe = CabinetPipeline(model, lambda st: GroupedSGD(st, **inp["opt"]),
                               n_min=inp["n_min"], num_microbatches=2, devices=["cpu", "cpu"],
                               max_grad_norm=1.0, **inp["ema"])
        loop = PipelineTrainLoop(pipe, pipe.init_state(inp["state_dict"]))
        losses = [loop.feed(x[rank::ranks], y[rank::ranks])
                  for x, y in zip(inp["xs"], inp["ys"])]
    finally:
        layers.BatchNorm2d.forward = plain
    return {"losses": losses, "state": loop.weights(), "ema": loop.weights(ema=True),
            "steps": [s.step for s in loop.state],
            "comm": {k: v["calls"] for k, v in mesh.comm_since(comm0).items() if v["calls"]}}


TP_CFGS = [[3, 1, 16, 0, 0, 1], [3, 4, 24, 0, 0, 2], [5, 3, 40, 1, 0, 2], [5, 6, 96, 1, 1, 2]]


def _tp_model(inp, m, attention="einsum"):
    """The JAX test's small CABiNet (5 classes) holding the case's weights,
    cut to this rank's slices on mesh `m` at min_features 48."""
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.models.tensor_parallel import tensor_parallel

    model = CABiNet(5, mode="small", cfgs=TP_CFGS, attention=attention)
    model.load_state_dict(inp["state_dict"], strict=True)
    return tensor_parallel(model, m, inp.get("min_features", 48))


def _tp_state(inp, m):
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import GroupedSGD

    model = _tp_model(inp, m)
    opt = GroupedSGD(model, max_grad_norm=1.0, **inp["opt"])
    return T.create_train_state(model, opt, **inp["ema"])


def _clone(tree):
    if torch.is_tensor(tree):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    return tree


def _tp_record(state):
    """The state's whole tensors (gathered), its slices, and its counters."""
    from cabinet_tpu_torch.models import tensor_parallel as tp
    from cabinet_tpu_torch.train.checkpoint import CheckpointManager

    model = state.model
    tree = _clone(CheckpointManager._state_tree(state))  # the live tensors move on
    names = tp.by_name(state.optimizer.parameters(), model)
    momentum = {names[i]: st["momentum_buffer"] for i, st in tree["opt_state"]["state"].items()}
    return {"state": {**tree["params"], **tree["batch_stats"]}, "ema": tree["ema_variables"],
            "momentum": momentum, "slices": {k: v.clone() for k, v in model.state_dict().items()},
            "dims": tp.state_dims(model),
            "counters": (state.step, state.micro_step, state.ema.updates)}


def case_tp_train(inp, rank, ranks):
    """One train step of the tensor-parallel model on mesh `inp["mesh"]`
    (this data rank's rows of the global batch); with `inp["ckpt"]`, a
    checkpoint after it, a second step, and the same second step from the
    checkpoint restored into a fresh state."""
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.checkpoint import CheckpointManager

    m = mesh.make_mesh(*inp["mesh"])
    mesh.set_mesh(m)
    comm0 = {k: dict(v) for k, v in mesh.COMM.items()}
    step = T.make_train_step(n_min=inp["n_min"])
    d, nd = m.data_rank, m.n_data
    x, y = inp["x"][d::nd], inp["y"][d::nd]
    state, loss = step(_tp_state(inp, m), x, y)
    out = {"loss": loss, **_tp_record(state),
           "comm": {k: v["calls"] for k, v in mesh.comm_since(comm0).items() if v["calls"]},
           "mesh": (m.n_data, m.n_model, m.data_rank, m.model_rank)}
    if inp.get("ckpt"):
        ckpt = CheckpointManager(inp["ckpt"])
        ckpt.save_full("checkpoint_last", state, 0, 0.5, 1.0,
                       {"best_fitness": 0.5, "best_epoch": 0})
        ckpt.save_variables("ema", T.TrainLoop(state, step, "cpu").full_weights(ema=True))
        state, loss2 = step(state, x, y)
        fresh = _tp_state(inp, m)
        restored = ckpt.restore_full("checkpoint_last", fresh)
        fresh, loss2r = step(restored["state"], x, y)
        out["resume"] = {"loss": (loss2, loss2r), "straight": state.model.state_dict(),
                         "resumed": fresh.model.state_dict(),
                         "ema": (state.ema.state_dict(), fresh.ema.state_dict())}
    return out


def case_tp_eval(inp, rank, ranks):
    """MscEval of the tensor-parallel model (K1's plain version on the CPU)
    on mesh `inp["mesh"]`, its tiles shared over the data axis: the
    summed probabilities and the confusion matrix."""
    from cabinet_tpu_torch.cli.evaluate import make_eval_forward
    from cabinet_tpu_torch.eval.evaluator import MscEval

    m = mesh.make_mesh(*inp["mesh"])
    mesh.set_mesh(m)
    model = _tp_model(inp, m, attention="kernel")
    fwd = make_eval_forward(model, 32, "cpu", torch.float32, use_pallas=True,
                            fused_tail="false")
    tile = (m.data_rank, m.n_data) if m.n_data > 1 else None
    ev = MscEval(fwd, 5, scales=(1.0,), cropsize=32, device="cpu", tile_mesh=tile)
    return {"probs": torch.from_numpy(ev.prob_batch(None, inp["images"])),
            "hist": ev.hist_batch(None, inp["images"], inp["labels"]),
            "comm": {k: v["calls"] for k, v in mesh.COMM.items() if v["calls"]}}


def case_tp_pipeline(inp, rank, ranks):
    """The 2-stage pipeline of the tensor-parallel model on mesh
    `inp["mesh"]` (stages on the CPU; this data rank's rows of each
    microbatch), one window: its loss and whole weights; then the merged
    EMA weights cut for an eval mesh of `inp["eval_model_axis"]` model
    ranks, and MscEval's matrix over them."""
    from cabinet_tpu_torch.eval.evaluator import MscEval
    from cabinet_tpu_torch.models import tensor_parallel as tp
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.train.optimizer import GroupedSGD
    from cabinet_tpu_torch.train.pipeline import CabinetPipeline, PipelineTrainLoop

    m = mesh.make_mesh(*inp["mesh"])
    mesh.set_mesh(m)
    model = _tp_model(inp, m)
    pipe = CabinetPipeline(model, lambda st: GroupedSGD(st, **inp["opt"]), n_min=inp["n_min"],
                           num_microbatches=len(inp["xs"]), devices=["cpu", "cpu"],
                           max_grad_norm=1.0, **inp["ema"])
    loop = PipelineTrainLoop(pipe, pipe.init_state(model.state_dict()))  # the slices
    d, nd = m.data_rank, m.n_data
    losses = [loop.feed(x[d::nd], y[d::nd]) for x, y in zip(inp["xs"], inp["ys"])]
    full, ema = loop.full_weights(), loop.full_weights(ema=True)
    resliced = tp.shard_state(full, model)
    e = inp["eval_model_axis"]
    eval_m = mesh.make_mesh(ranks // e, e)
    eval_model = tp.tensor_parallel(CABiNet(5, mode="small", cfgs=TP_CFGS), eval_m, 48)
    eval_model.load_state_dict(tp.reshard_state(loop.weights(ema=True), model, eval_model))
    eval_model.eval()

    def fwd(_, images):
        with torch.no_grad():
            return tuple(t.permute(0, 2, 3, 1) for t in eval_model(images.permute(0, 3, 1, 2)))

    with mesh.using(eval_m):
        tile = (eval_m.data_rank, eval_m.n_data) if eval_m.n_data > 1 else None
        hist = MscEval(fwd, 5, scales=(1.0,), cropsize=32, device="cpu",
                       tile_mesh=tile).hist_batch(None, inp["images"], inp["labels"])
    return {"losses": losses, "state": full, "ema": ema,
            "slices_equal": all(torch.equal(resliced[k], v)
                                for k, v in loop.weights().items()),
            "n_sharded": sum(v is not None for v in tp.state_dims(model).values()),
            "eval_sharded": sum(v is not None for v in tp.state_dims(eval_model).values()),
            "hist": hist, "steps": [s.step for s in loop.state]}


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


def main() -> None:
    case, folder = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    mesh.setup("cpu", "gloo", timeout_s=60)
    rank, ranks = mesh.world()
    try:
        inp = torch.load(folder / "inputs.pt", weights_only=False)
        out = CASES[case](inp, rank, ranks)
        torch.save(out, folder / f"rank{rank}.pt")
    finally:
        mesh.teardown()


if __name__ == "__main__":
    main()
