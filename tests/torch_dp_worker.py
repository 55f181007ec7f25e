"""One rank of a case over ranks of tests/test_torch_dp.py (data
parallelism), tests/test_torch_tile_eval.py (tile-sharded eval) or
tests/test_torch_pipeline.py (the pipeline's intra-stage data parallelism).

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
