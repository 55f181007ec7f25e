"""Data parallelism across processes in the port (cabinet_tpu_torch.core.mesh
and the global-batch reductions), on the CPU with gloo groups of 2 ranks,
each rank a process under a time limit (`run_ranks`; every process reaped
in a `finally`, none may outlive its test):
  - the loader's interleaved shard and the mesh helpers against the JAX
    package's;
  - BatchNorm over the global batch: the 2-rank forward, backward and
    running statistics against the single process on the concatenated
    batch;
  - OHEM (topk and bisect, both branches) and the CE mean with pixels
    ignored unevenly across the ranks: the ranks' shares summed and their
    gradients against JAX's on the global batch;
  - DeviceAugment: the ranks' augmented batches, interleaved, bit-equal to
    the 1-rank global batch (exact and shared warp, aerial mixup across
    ranks, street chain);
  - the train step (accumulation 2, two updates and the flush, OHEM bisect
    and topk, clipping, class weights, EMA; bisect also with every backbone
    block rematerialised, whose recomputation repeats BatchNorm's
    all-reduce in the backward) against JAX's `make_train_step` +
    `make_flush_step` on the global batch, and the ranks bit-identical;
  - the confusion matrix of a 2-rank MscEval equal to the 1-rank one;
  - `cli/train.py` main on 2 ranks against 1 rank: one set of outputs,
    from rank 0; a resume; losses and final weights within the stated
    bounds; `cli/train_yolo.py` main likewise.

Bounds: the suite's f32 bound (2e-4 of the largest reference magnitude, or
of the largest update where a step is compared; for the SGD momentum, of
the largest momentum of the model), and 1e-5 of |ref| for a loss. The
2-rank sums are the 1-rank sums in another order.

The 2-rank BatchNorm merges the ranks' means and squared deviations
(Chan's formula) where one rank takes torch's own BatchNorm (Welford's); a
main's steps at random init, backward through 15 blocks of train-mode BN,
amplify the difference in rounding (to 1.2x the bound on one conv after 6
steps). So the mains' weights are held against a 1-rank run on the
ranks' formula (`_GLOBAL_BN`), and their losses against the unmodified
1-rank run's."""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu_torch.core import mesh
from cabinet_tpu_torch.core.config import Config
from cabinet_tpu_torch.core.exceptions import ConfigurationError
from torch_port_utils import F32_REL, assert_close_f32, assert_updates_close, perturb

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]]
LOSS_REL = 1e-5
RANK_TIMEOUT_S = 240


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_env(rank: int, ranks: int, port: int) -> dict:
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")}
    env.update(PYTHONPATH=f"{REPO}{os.pathsep}{TESTS}", OMP_NUM_THREADS="1",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    if ranks > 1:
        env.update(RANK=str(rank), WORLD_SIZE=str(ranks), LOCAL_RANK=str(rank),
                   LOCAL_WORLD_SIZE=str(ranks))
    return env


def run_ranks(cmd, ranks: int = 2, timeout: float = RANK_TIMEOUT_S):
    """Run `cmd` (argv after the interpreter) once per rank, all at once, and
    wait for all; every process is killed and reaped by the end, whatever
    happens. Returns each rank's output; fails unless every rank exits 0."""
    port, procs = free_port(), []
    try:
        for r in range(ranks):
            procs.append(subprocess.Popen([sys.executable, *cmd], cwd=REPO,
                                          env=rank_env(r, ranks, port),
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        outs = [p.communicate(timeout=timeout)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    assert all(p.returncode is not None for p in procs)  # none outlives its caller
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{out[-4000:]}"
    return outs


def run_case(tmp_path: Path, case: str, inputs: dict, ranks: int = 2):
    torch.save(inputs, tmp_path / "inputs.pt")
    run_ranks(["-m", "torch_dp_worker", case, str(tmp_path)], ranks)
    return [torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(ranks)]


def interleave(parts):
    """Rank r's row i is global row r + R*i."""
    out = torch.empty((sum(p.shape[0] for p in parts),) + tuple(parts[0].shape[1:]),
                      dtype=parts[0].dtype)
    for r, p in enumerate(parts):
        out[r::len(parts)] = p
    return out


# ---------------------------------------------------------------------------
# The loader's shard and the mesh helpers (one process)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,epoch,pid,nproc", [(0, 0, 0, 2), (0, 3, 1, 2), (5, 1, 2, 3),
                                                  (7, 2, 0, 4), (7, 2, 3, 4), (1, 0, 0, 1)])
@pytest.mark.parametrize("n", [10, 13])
def test_thread_loader_shard_is_jaxs(seed, epoch, pid, nproc, n):
    from cabinet_tpu.data.loader import DataLoader as JLoader
    from cabinet_tpu_torch.data.loader import DataLoader

    kw = dict(shuffle=True, seed=seed, num_workers=0, shard=(pid, nproc))
    port, ref = DataLoader(list(range(n)), 2, **kw), JLoader(list(range(n)), 2, **kw)
    port.epoch = ref.epoch = epoch
    assert np.array_equal(port._indices(), ref._indices())
    assert len(port) == len(ref)


def test_make_loader_shards_the_thread_loader_as_jax():
    from cabinet_tpu.cli import common as jcommon
    from cabinet_tpu.core.config import compose as jcompose
    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.core.config import compose

    args = ["checkpoint_path=x"]
    kw = dict(shuffle=True, drop_last=True, num_workers=0, seed=4, shard=(1, 2))
    samples = [(np.array([i]), np.array([-i])) for i in range(9)]
    port = common.make_loader(compose(common.CONFIG_DIR, "evaluate", args), samples, 2, **kw)
    ref = jcommon.make_loader(jcompose(jcommon.CONFIG_DIR, "evaluate", args), samples, 2, **kw)
    assert [b[0].tolist() for b in port] == [b[0].tolist() for b in ref]
    assert len(port) == len(ref) == 2


@pytest.mark.parametrize("batch,n", [(8, 4), (6, 4), (7, 4), (3, 8), (1, 2)])
def test_mesh_helpers_are_jaxs(batch, n):
    from cabinet_tpu.core import mesh as jmesh

    assert mesh.auto_data_axis(batch, n) == jmesh.auto_data_axis(batch, n)
    for items in (10, 11, 3):
        for pid in range(n):
            per, extra = items // n, items % n
            start = pid * per + min(pid, extra)
            assert mesh.process_shard(items, pid, n) == slice(
                start, start + per + (1 if pid < extra else 0))
    if batch % n:
        with pytest.raises(ValueError, match="not divisible"):
            mesh.local_batch_size(batch, n)
    else:
        jm = jmesh.make_mesh(n_data=n, devices=jax.devices()[:n])
        assert mesh.local_batch_size(batch, n) == jmesh.local_batch_size(batch, jm)
    assert mesh.DATA_AXIS == jmesh.DATA_AXIS and mesh.MODEL_AXIS == jmesh.MODEL_AXIS


def test_backend_choice_and_what_is_not_ported(monkeypatch):
    cpu, cuda = torch.device("cpu"), torch.device("cuda")
    assert mesh.resolve_backend("auto", cpu) == "gloo"
    assert mesh.resolve_backend("auto", cuda) == "nccl"
    assert mesh.resolve_backend("gloo", cuda) == "gloo"
    with pytest.raises(ConfigurationError, match="dist_backend"):
        mesh.resolve_backend("mpi", cpu)
    with pytest.raises(ConfigurationError, match="gloo"):
        mesh.resolve_backend("nccl", cpu)
    # two ranks on one card under NCCL raise, naming gloo, before any group
    for k, v in dict(RANK="0", WORLD_SIZE="2", LOCAL_RANK="0", LOCAL_WORLD_SIZE="2").items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ConfigurationError, match="dist_backend=gloo"):
        mesh.setup("cuda", "nccl")
    assert not torch.distributed.is_initialized()
    monkeypatch.delenv("WORLD_SIZE")  # not under torchrun: no group is joined
    assert mesh.setup("cpu", "gloo") == cpu and mesh.world() == (0, 1)
    assert not torch.distributed.is_initialized()
    # tensor parallelism is ported (tests/test_torch_tensor_parallel.py);
    # spatial partitioning alone still raises, naming its ROADMAP item
    assert mesh.tensor_parallel_spec((4, 256), 2) == (None, mesh.MODEL_AXIS)
    assert mesh.shard_model_parallel({}, mesh.current(), {}) == {}
    with pytest.raises(NotImplementedError, match="Queue 1 item 7c, spatial"):
        mesh.spatial_sharding(None, 4)


# ---------------------------------------------------------------------------
# BatchNorm and the losses over the global batch
# ---------------------------------------------------------------------------

def test_batch_norm_over_the_global_batch(tmp_path):
    from cabinet_tpu_torch.models.layers import batch_norm

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((4, 6, 5, 3)).astype(np.float32) * 2 + 1)
    g = torch.from_numpy(rng.standard_normal((4, 6, 5, 3)).astype(np.float32))
    ref_bn = batch_norm(6)
    with torch.no_grad():
        ref_bn.weight.uniform_(0.5, 1.5)
        ref_bn.bias.uniform_(-0.5, 0.5)
        ref_bn.running_var.uniform_(0.5, 2.0)
    state = {k: v.clone() for k, v in ref_bn.state_dict().items()}
    ref_bn.train()
    xr = x.clone().requires_grad_(True)
    y = ref_bn(xr)
    (y * g).sum().backward()
    got = run_case(tmp_path, "batch_norm", {"x": x, "grad": g, "state": state})
    assert_close_f32(interleave([o["y"] for o in got]), y.detach())
    assert_close_f32(interleave([o["x_grad"] for o in got]), xr.grad)
    assert_close_f32(sum(o["w_grad"] for o in got), ref_bn.weight.grad)
    assert_close_f32(sum(o["b_grad"] for o in got), ref_bn.bias.grad)
    for o in got:
        for k in ("running_mean", "running_var"):
            assert_close_f32(o["state"][k], ref_bn.state_dict()[k])
        assert int(o["state"]["num_batches_tracked"]) == 1
    assert all(torch.equal(got[0]["state"][k], got[1]["state"][k]) for k in state)


def _loss_cases():
    """Logits (4, 5, 6, 7) NCHW; rank 0's rows (0 and 2) ignore most of
    their pixels, rank 1's few. "hard": random logits, the k-th loss above
    the threshold; "easy": logits favouring the label, below it."""
    rng = np.random.default_rng(1)
    B, C, H, W = 4, 5, 6, 7
    labels = rng.integers(0, C, (B, H, W))
    labels[0, :5] = 255
    labels[2, 1:] = 255
    labels[3, 0, :2] = 255
    hard = rng.standard_normal((B, C, H, W)).astype(np.float32) * 2
    easy = hard * 0.3 + 4.0 * np.eye(C, dtype=np.float32)[np.clip(labels, 0, C - 1)
                                                           ].transpose(0, 3, 1, 2)
    cw = (rng.random(C) + 0.5).astype(np.float32)
    cases = {}
    for lname, logits in (("hard", hard), ("easy", easy)):
        for kind in ("topk", "bisect", "ce"):
            for weighted in (False, True):
                cases[f"{kind}_{lname}_{'cw' if weighted else 'plain'}"] = {
                    "kind": kind, "logits": torch.from_numpy(logits),
                    "labels": torch.from_numpy(labels),
                    "n_min": B * H * W // 16, "cw": torch.from_numpy(cw) if weighted else None}
    return cases


def _jax_loss(spec):
    from cabinet_tpu.train.losses import cross_entropy_mean, ohem_cross_entropy

    logits = jnp.asarray(spec["logits"].numpy().transpose(0, 2, 3, 1))
    labels = jnp.asarray(spec["labels"].numpy())
    cw = None if spec["cw"] is None else jnp.asarray(spec["cw"].numpy())
    if spec["kind"] == "ce":
        fn = lambda lg: cross_entropy_mean(lg, labels, 255, cw)  # noqa: E731
    else:
        fn = lambda lg: ohem_cross_entropy(lg, labels, spec["n_min"], 0.7, 255, cw,  # noqa
                                           method=spec["kind"])
    value, grad = jax.value_and_grad(fn)(logits)
    return float(value), np.asarray(grad).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module")
def loss_runs(tmp_path_factory):
    cases = _loss_cases()
    got = run_case(tmp_path_factory.mktemp("losses"), "losses", {"cases": cases})
    return cases, got


@pytest.mark.parametrize("name", list(_loss_cases()))
def test_loss_shares_match_jax_on_the_global_batch(loss_runs, name):
    cases, got = loss_runs
    ref, ref_grad = _jax_loss(cases[name])
    total = sum(float(o[name]["loss"]) for o in got)
    assert abs(total - ref) <= LOSS_REL * abs(ref), (total, ref)
    assert_close_f32(interleave([o[name]["grad"] for o in got]), ref_grad)


def test_loss_cases_take_both_branches(loss_runs):
    """The hard cases pick the mean above the threshold, the easy ones the
    mean of the top n_min (JAX's OHEM at the global batch decides)."""
    cases, _ = loss_runs
    from cabinet_tpu.train.losses import _per_pixel_ce

    for lname, above in (("hard", True), ("easy", False)):
        spec = cases[f"topk_{lname}_plain"]
        loss, valid = _per_pixel_ce(jnp.asarray(spec["logits"].numpy().transpose(0, 2, 3, 1)),
                                    jnp.asarray(spec["labels"].numpy()), 255, None)
        vals = np.sort(np.asarray(loss)[np.asarray(valid)])[::-1]
        assert (vals[spec["n_min"] - 1] > 0.7) == above


# ---------------------------------------------------------------------------
# DeviceAugment's draws over the global batch
# ---------------------------------------------------------------------------

class _Recipe:
    """The attributes DeviceAugment reads from a train dataset."""

    def __init__(self, recipe, geometric, aug):
        self.RECIPE, self.geometric, self.aug = recipe, geometric, aug
        self.MEAN, self.STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


def _augment_cases():
    rng = np.random.default_rng(2)
    B, S, crop = 4, 40, (24, 24)
    canvas = rng.integers(0, 256, (B, S, S, 3), dtype=np.uint8)
    labels = rng.integers(0, 8, (B, S, S), dtype=np.uint8)
    hw = np.array([[40, 36], [30, 40], [40, 40], [34, 28]], np.int32)
    raw = rng.random((B, 24, 24, 3)).astype(np.float32)
    aerial = {"degrees": 10.0, "translate": 0.05, "scale": 0.3, "fliplr": 0.5,
              "flipud": 0.2, "hsv_h": 0.01, "hsv_s": 0.4, "hsv_v": 0.3}
    street = {"fliplr": 0.5, "degrees": 0.0, "translate": 0.0,
              "scale_choices": (0.75, 1.0, 1.25), "mixup": 0.0}

    def cfg(geometric):
        return Config({"runtime": {"seed": 3, "device_geometric": geometric},
                       "dataset": {"ignore_idx": 255}})
    return {
        "aerial_exact_mixup_all": {"cfg": cfg("true"), "crop": crop,
                                   "ds": _Recipe("aerial", "device", {**aerial, "mixup": 1.0}),
                                   "batch": (canvas, labels, hw)},
        "aerial_raw_mixup_half": {"cfg": cfg(False), "crop": crop,
                                  "ds": _Recipe("aerial", "host", {**aerial, "mixup": 0.5}),
                                  "batch": (raw, labels[:, :24, :24].astype(np.int64))},
        "street_shared": {"cfg": cfg("shared"), "crop": crop,
                          "ds": _Recipe("street", "device", street),
                          "batch": (canvas, labels, hw)},
    }


def test_device_augment_ranks_make_the_global_batch(tmp_path):
    from cabinet_tpu_torch.cli.train import DeviceAugment

    cases = _augment_cases()
    got = run_case(tmp_path, "augment", {"cases": cases})
    for name, spec in cases.items():
        one = DeviceAugment(spec["cfg"], spec["ds"], torch.device("cpu"), spec["crop"])
        images, labels = one(spec["batch"], 3, 1)
        assert torch.equal(interleave([o[name][0] for o in got]), images), name
        assert torch.equal(interleave([o[name][1] for o in got]), labels), name


# ---------------------------------------------------------------------------
# The train step against JAX's on the global batch
# ---------------------------------------------------------------------------

S, B, NC, ACCUM, MICRO = 64, 4, 8, 2, 4
OPT = dict(lr0=0.2, max_iter=10, momentum=0.9, wd=5e-4, power=0.9, warmup_steps=1,
           warmup_start_lr=0.05)
EMA = dict(ema_decay=0.9, ema_tau=2.0)
CW = (np.random.default_rng(5).random(NC) + 0.5).astype(np.float32)


def _momentum_of_jax(opt_state, batch_stats):
    """The SGD momentum (optax trace) of every parameter, by the port's
    parameter name: the groups' masked traces merged."""
    import optax
    from flax.traverse_util import flatten_dict, unflatten_dict

    from cabinet_tpu_torch.utils.convert import state_dict_from_jax

    merged = {}
    for st in jax.tree_util.tree_leaves(opt_state,
                                        is_leaf=lambda x: isinstance(x, optax.TraceState)):
        if isinstance(st, optax.TraceState):
            flat = flatten_dict(jax.tree_util.tree_map(np.asarray, st.trace),
                                is_leaf=lambda _, x: isinstance(x, optax.MaskedNode))
            merged.update({k: v for k, v in flat.items()
                           if not isinstance(v, optax.MaskedNode)})
    return state_dict_from_jax({"params": unflatten_dict(merged),
                                "batch_stats": jax.tree_util.tree_map(np.asarray, batch_stats)},
                               CFGS)


_JAX_TRAIN = {}  # the JAX reference by OHEM method (remat changes no value)


@pytest.fixture(scope="module", params=[("bisect", False), ("topk", False), ("bisect", True)],
                ids=["bisect", "topk", "bisect-remat"])
def train_runs(request, small_cabinet, tmp_path_factory):
    from cabinet_tpu.train.optimizer import build_optimizer
    from cabinet_tpu.train.trainer import create_train_state
    from cabinet_tpu.train.trainer import make_flush_step as j_flush
    from cabinet_tpu.train.trainer import make_train_step as j_train_step
    from cabinet_tpu_torch.utils.convert import state_dict_from_jax

    method, remat = request.param
    jm = small_cabinet[0]
    v = perturb(small_cabinet[1], seed=1)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((MICRO, B, S, S, 3)).astype(np.float32)
    ys = rng.integers(0, NC, (MICRO, B, S, S))
    ys[:, 0, :20] = 255  # rank 0's rows ignore more pixels
    if method not in _JAX_TRAIN:
        tx = build_optimizer(v["params"], max_grad_norm=1.0, **OPT)
        js = create_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx, **EMA)
        step = j_train_step(jm.apply, tx, n_min=B * S * S // 16, class_weights=CW,
                            accum_steps=ACCUM, ohem_method=method)
        losses = []
        for i in range(MICRO):
            js, loss = step(js, jnp.asarray(xs[i]), jnp.asarray(ys[i]))
            losses.append(float(loss))
        js = j_flush(tx)(js)

        def sd(tree):
            return state_dict_from_jax(
                jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree), CFGS)
        _JAX_TRAIN[method] = {
            "losses": losses, "state": sd({"params": js.params, "batch_stats": js.batch_stats}),
            "ema": sd(js.ema.variables),
            "momentum": _momentum_of_jax(js.opt_state, js.batch_stats),
            "counters": (int(js.step), int(js.micro_step), int(js.ema.updates))}
    start = state_dict_from_jax(v, CFGS)
    got = run_case(tmp_path_factory.mktemp(f"train_{method}_{remat}"), "train", {
        "state_dict": start, "opt": OPT, "ema": EMA, "n_min": B * S * S // 16, "cw": CW,
        "accum": ACCUM, "method": method, "remat": remat, "xs": torch.from_numpy(xs),
        "ys": torch.from_numpy(ys)})
    return _JAX_TRAIN[method], got, start


def test_train_step_matches_jax_on_the_global_batch(train_runs):
    ref, got, start = train_runs
    for r, o in enumerate(got):
        for i, (g, w) in enumerate(zip(o["losses"].tolist(), ref["losses"])):
            assert abs(g - w) <= LOSS_REL * abs(w), (r, i, g, w)
        assert o["counters"] == ref["counters"] == (MICRO // ACCUM, 0, MICRO // ACCUM)
        for kind in ("state", "ema"):
            keys = [k for k in ref[kind] if not k.endswith("num_batches_tracked")]
            assert_updates_close({k: o[kind][k] for k in keys}, {k: ref[kind][k] for k in keys},
                                 {k: start[k] for k in keys}, rel=F32_REL)
        assert set(o["momentum"]) == {k for k in o["state"] if k in ref["momentum"]
                                      and not k.endswith(("running_mean", "running_var",
                                                          "num_batches_tracked"))}
        # momentum: 2e-4 of the largest reference momentum (a tensor whose
        # gradient nearly cancels carries the sums' reordering at its scale)
        scale = max(float(ref["momentum"][k].abs().max()) for k in o["momentum"])
        for k, m in o["momentum"].items():
            err = float((m - ref["momentum"][k]).abs().max())
            assert err <= F32_REL * scale, (k, err, scale)


def test_train_step_ranks_are_bit_identical(train_runs):
    _, (a, b), _ = train_runs
    assert torch.equal(a["losses"], b["losses"])
    for kind in ("state", "ema", "momentum"):
        assert a[kind].keys() == b[kind].keys()
        assert all(torch.equal(a[kind][k], b[kind][k]) for k in a[kind]), kind


def test_eval_matrix_over_ranks_is_the_one_rank_matrix(tmp_path, small_cabinet):
    from cabinet_tpu_torch.utils.convert import state_dict_from_jax

    rng = np.random.default_rng(6)
    images = [rng.standard_normal((40, 48, 3)).astype(np.float32) for _ in range(5)]
    labels = [rng.integers(0, NC, (40, 48)) for _ in range(5)]
    labels[1][:10] = 255
    sd = state_dict_from_jax(perturb(small_cabinet[1], seed=2), CFGS)
    inputs = {"state_dict": sd, "images": images, "labels": labels}
    got = run_case(tmp_path, "eval", inputs)
    one = run_case(tmp_path, "eval", inputs, ranks=1)[0]
    assert sorted(o["frames"] for o in got) == [2, 3]
    for o in got:  # summed over the ranks as int64 (metrics_from_hist gives f64)
        assert np.array_equal(o["hist"], one["hist"])
    assert one["hist"].sum() == 5 * 40 * 48 - 10 * 48


# ---------------------------------------------------------------------------
# The train mains on 2 ranks
# ---------------------------------------------------------------------------

# One rank on the 2-rank BatchNorm's formula, so that the two runs differ
# by the order of their sums alone.
_GLOBAL_BN = textwrap.dedent("""
    from cabinet_tpu_torch.models import layers
    _bn = layers.BatchNorm2d.forward
    layers.BatchNorm2d.forward = (lambda self, x: self._global_forward(x)
                                  if self.training else _bn(self, x))
""")
_MAIN = textwrap.dedent("""
    import json, os, sys, torch
    torch.set_num_threads(1)
    {patch}
    from cabinet_tpu_torch.cli.{module} import main
    res = main(json.loads(sys.argv[1]))
    if os.environ.get("RANK", "0") == "0":
        print("RESULT " + json.dumps({{"timing": res["timing"], "best_miou": res["best_miou"],
                                      "losses": res.get("losses")}}))
""")


def run_main(module: str, argv, ranks: int, global_bn: bool = False):
    code = _MAIN.format(module=module, patch=_GLOBAL_BN if global_bn else "")
    outs = run_ranks(["-c", code, json.dumps(argv)], ranks)
    line = [ln for ln in outs[0].splitlines() if ln.startswith("RESULT ")][-1]
    assert not any("RESULT " in o for o in outs[1:])
    return json.loads(line[len("RESULT "):]), outs


def _init_weights(config: str, argv):
    """The weights a main starts from: its model built after seeding with
    runtime.seed, as the main builds it."""
    from cabinet_tpu_torch.cli import common
    from cabinet_tpu_torch.core.config import compose

    cfg = compose(common.CONFIG_DIR, config, [a for a in argv if "=" in a])
    common.seed_everything(cfg.runtime.seed)
    if config == "train_yolo":
        from cabinet_tpu_torch.cli.train_yolo import _build_model

        return _build_model(cfg).state_dict()
    return common.build_model(cfg, cfg.dataset.num_classes).state_dict()


def _updates_close(got, ref, start):
    """Each tensor within the f32 bound of its own update from the init,
    4 f32 ulps of its magnitude, plus 1e-6 of the model's largest update: a
    tensor whose update is zero in exact arithmetic (a BN bias before a
    train-mode BN) moves by rounding alone."""
    floats = [k for k in ref if ref[k].is_floating_point()]
    largest = max(float((ref[k].float() - start[k].float()).abs().max()) for k in floats)
    for k in floats:
        d = float((ref[k].float() - start[k].float()).abs().max())
        err = float((got[k].float() - ref[k].float()).abs().max())
        bound = F32_REL * d + 2.0 ** -21 * float(ref[k].abs().max()) + 1e-6 * largest
        assert err <= bound, (k, err, bound)


def _metrics(exp):
    return [json.loads(ln) for ln in (exp / "metrics.jsonl").read_text().splitlines()]


def _files(exp):
    return sorted(p.name if not p.name.startswith("run-") else "run-*.log"
                  for p in exp.iterdir())


@pytest.mark.parametrize("recipe", ["host", "device_mixup"])
def test_train_main_on_two_ranks(tmp_path, recipe):
    """Global batch 4 (2 a rank), 2 epochs of 2 steps, then a resume to a
    third: the same files as a 1-rank run and one run log, the same
    metrics lines, losses within 1e-5 of the 1-rank run's, and weights
    within the f32 bound of the 1-rank run's on the ranks' BN formula."""
    from test_torch_cli_train import make_uavid_tree, overrides

    data = make_uavid_tree(tmp_path / "data", n=8)
    extra = ["training_config.batch_size=4", "+runtime.dist_backend=gloo",
             "+runtime.dist_timeout_s=60", "--device", "cpu"]
    if recipe == "device_mixup":
        extra = ["runtime.device_geometric=true", "dataset.augmentation.mixup=0.5"] + extra
    runs = {}
    for ranks, global_bn in ((1, False), (1, True), (2, False)):
        exp = tmp_path / f"exp{ranks}{'g' if global_bn else ''}"
        argv = overrides("uavid", data, exp, crop=64) + extra[:-2]
        res, outs = run_main("train", argv + extra[-2:], ranks, global_bn)
        res2, _ = run_main("train", argv + ["training_config.resume=true",
                                             "training_config.epochs=3"] + extra[-2:],
                           ranks, global_bn)
        runs[ranks, global_bn] = (exp, res, res2)
    (exp1, res1, res1b), (exp2, res2, res2b) = runs[1, False], runs[2, False]
    assert _files(exp2) == _files(exp1)
    assert [p.name for p in exp2.iterdir()].count("config.yaml") == 1
    assert len([p for p in exp2.iterdir() if p.name.startswith("run-")]) == 2  # rank 0's, twice
    assert not [p for p in exp2.iterdir() if ".tmp" in p.name]
    m1, m2 = _metrics(exp1), _metrics(exp2)
    assert len(m2) == len(m1) == 5
    for a, b in zip(m1, m2):
        if "epoch" not in a:
            continue
        assert (a["epoch"], a["step"]) == (b["epoch"], b["step"])
        for k in ("train_loss", "val_loss"):
            assert abs(a[k] - b[k]) <= LOSS_REL * abs(a[k]), (k, a, b)
    assert res2["timing"]["optimizer_steps"] == res1["timing"]["optimizer_steps"] == 4
    assert res2b["timing"]["optimizer_steps"] == 2
    coll = res2["timing"]["collectives"]
    assert coll["grad_all_reduce"]["calls"] == 4 and coll["batch_norm"]["calls"] > 0
    assert res1["timing"]["collectives"] == {}
    start = _init_weights("train", argv)
    for name in ("tiny.pth", "checkpoint_last.pth"):
        a, b = torch.load(runs[1, True][0] / name), torch.load(exp2 / name)
        if "params" in a:
            a, b = {**a["params"], **a["batch_stats"]}, {**b["params"], **b["batch_stats"]}
        _updates_close(b, a, start)


def test_train_yolo_main_on_two_ranks(tmp_path):
    """Two steps of YOLO-sem on 2 ranks (global batch 4, accumulation 2)
    against 1 rank, in f32: one set of checkpoints and one run log; the
    losses within 1e-5 of the 1-rank run's, and `final` within the f32
    bound of the 1-rank run's on the ranks' BN formula."""
    from test_torch_cli_train import make_uavid_tree

    data = make_uavid_tree(tmp_path / "data", n=4, size=(32, 32))
    runs = {}
    for ranks, global_bn in ((1, False), (1, True), (2, False)):
        exp = tmp_path / f"exp{ranks}{'g' if global_bn else ''}"
        argv = ["dataset=uavid", f"dataset.dataset_path={data}", "training_config.imgsz=32",
                "training_config.batch_size=4", "training_config.nbs=8",
                "training_config.epochs=2", "training_config.num_workers=0",
                "validation_config.num_workers=0", "validation_config.batch_size=1",
                f"training_config.experiments_path={exp}", "+runtime.dist_backend=gloo",
                "runtime.compute_dtype=float32", "--device", "cpu"]
        runs[ranks, global_bn] = (exp, run_main("train_yolo", argv, ranks, global_bn)[0])
    (exp1, res1), (exp2, res2) = runs[1, False], runs[2, False]
    assert _files(exp2) == _files(exp1)
    assert res2["timing"]["optimizer_steps"] == res1["timing"]["optimizer_steps"] == 2
    assert res2["timing"]["collectives"]["grad_all_reduce"]["calls"] == 2
    for a, b in zip(res1["losses"], res2["losses"]):
        assert abs(a - b) <= LOSS_REL * abs(a), (res1["losses"], res2["losses"])
    a, b = torch.load(runs[1, True][0] / "final.pth"), torch.load(exp2 / "final.pth")
    _updates_close(b, a, _init_weights("train_yolo", argv[:-2]))
