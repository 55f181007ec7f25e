"""Spatial partitioning in the port (`runtime.spatial_axis`;
cabinet_tpu_torch.models.spatial_parallel and the stripe collectives of
cabinet_tpu_torch.core.mesh), on gloo CPU ranks, each a process of
tests/torch_dp_worker.py under a time limit (the `sp` case), held against
the JAX package's own equivalence test
(tests/unit/test_mesh_and_sharded_eval.py:164
`test_spatial_sharded_train_step_matches_replicated`: its small CABiNet,
5 classes, batch 1, 128x64, on the 8 virtual CPU devices of
tests/conftest.py) and against the port's one-process step:
  - each striped op on 2 and 4 stripes against the whole op, forward and
    input gradient: convs at every (k, s, p) of CABiNet's striped convs
    (3x3 s1/s2, 5x5 s1/s2 depthwise, 7x7 s2 p3, whose halo spans several
    2-row stripes), the half-pixel resizes from a stripe with its halo and
    from a whole source, the whole image's mean, and the attention branch
    (PSP's pooling, the CAB's attention over every token) on the gathered
    map, whose BatchNorm statistics are the image's and count it once;
  - one train step on 2 and 4 ranks against JAX's spatially sharded step:
    the loss within 1e-4 of |ref| (JAX's test's bound), and weights, BN
    statistics, EMA and momentum against the port's one-process step and
    JAX's within the suite's bound of the update, with an absolute floor
    (1e-6 of the largest update of the tree) for leaves whose update is
    ~1e-15, where two JAX runs differ at that level too;
  - the step with every backbone block rematerialised, whose backward
    repeats the halo exchanges, bit-equal to the step without;
  - spatial x tensor parallelism at 2 x 2 against the one-process step.
The train main on 2 ranks with runtime.spatial_axis=true is in
tests/test_torch_cli_train.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_dp import run_case
from torch_dp_worker import TP_CFGS as CFGS
from torch_port_utils import F32_REL, perturb

B, H, W, NC = 1, 128, 64, 5
LOSS_REL = 1e-4  # JAX's own test's bound (spatial against replicated)
FLOOR = 1e-6     # of the largest update of a tree: the absolute floor
OPT = dict(lr0=1e-2, max_iter=100, momentum=0.9, wd=5e-4, power=0.9, warmup_steps=10,
           warmup_start_lr=1e-5)
EMA = dict(ema_decay=0.9, ema_tau=2.0)
RANKS = {2: [(2, 1, False), (2, 1, True)], 4: [(4, 1, False), (4, 1, True), (2, 2, False)]}


def _batch():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(B, H, W, 3)).astype(np.float32)
    y = rng.integers(0, NC, (B, H, W))
    y[0, :9] = 255  # ignored rows in the first stripe only
    return x, y


@pytest.fixture(scope="module")
def jax_step():
    from cabinet_tpu.core.mesh import make_mesh, replicate, spatial_sharding
    from cabinet_tpu.models import CABiNet
    from cabinet_tpu.train.optimizer import build_optimizer
    from cabinet_tpu.train.trainer import create_train_state, make_train_step
    from cabinet_tpu_torch.models.cabinet import CABiNet as PortCABiNet
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import GroupedSGD
    from cabinet_tpu_torch.utils.convert import state_dict_from_jax
    from test_torch_tensor_parallel import _jax_momentum

    model = CABiNet(n_classes=NC, mode="small", cfgs=CFGS)
    v = perturb(model.init(jax.random.PRNGKey(0), jnp.zeros((1, H, W, 3)), train=True), seed=3)
    tx = build_optimizer(v["params"], max_grad_norm=1.0, **OPT)
    state0 = jax.device_get(create_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx,
                                               **EMA))
    jmesh = make_mesh()
    x, y = _batch()
    im = jax.device_put(jnp.asarray(x), spatial_sharding(jmesh, 4))
    lb = jax.device_put(jnp.asarray(y), spatial_sharding(jmesh, 3))
    assert im.sharding.spec[1] == "data"  # rows are the sharded dim
    st, loss = make_train_step(model.apply, tx, n_min=B * H * W // 16)(
        replicate(state0, jmesh), im, lb)

    def sd(tree):
        return state_dict_from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), tree), CFGS)

    start = state_dict_from_jax(v, CFGS)
    one = PortCABiNet(NC, mode="small", cfgs=CFGS)
    one.load_state_dict(start)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ost = T.create_train_state(one, GroupedSGD(one, max_grad_norm=1.0, **OPT), **EMA)
        ost, oloss = T.make_train_step(n_min=B * H * W // 16)(ost, torch.from_numpy(x),
                                                             torch.from_numpy(y))
    finally:
        torch.set_num_threads(threads)
    names = {id(p): n for n, p in one.named_parameters()}
    return {"loss": float(loss), "start": start,
            "jax": {"state": sd({"params": st.params, "batch_stats": st.batch_stats}),
                    "ema": sd(st.ema.variables),
                    "momentum": _jax_momentum(st.opt_state, st.batch_stats)},
            "one": {"loss": float(oloss), "state": one.state_dict(),
                    "ema": ost.ema.state_dict(),
                    "momentum": {names[id(p)]: s["momentum_buffer"]
                                 for p, s in ost.optimizer.sgd.state.items()}}}


# ---------------------------------------------------------------------------
# The ops, and the runs on 2 and 4 ranks
# ---------------------------------------------------------------------------

CONVS = {  # (c_in, c_out, k, s, p, groups): CABiNet's striped convs
    "3x3_s1": (4, 6, 3, 1, 1, 1), "3x3_s2": (4, 6, 3, 2, 1, 1),
    "dw5x5_s1": (6, 6, 5, 1, 2, 6), "dw5x5_s2": (6, 6, 5, 2, 2, 6),
    "7x7_s2_p3": (3, 5, 7, 2, 3, 1), "dw3x3_s2": (6, 6, 3, 2, 1, 6)}
RESIZES = {"resize_halo": ((1, 3, 8, 6), (64, 48)), "resize_halo_odd": ((2, 2, 8, 5), (24, 7)),
           "resize_whole": ((1, 3, 4, 6), (16, 12)), "resize_whole_down": ((1, 2, 16, 6), (8, 6))}


def _whole_op(spec):
    """The op `spec` names on the whole input (the reference)."""
    import torch.nn.functional as F

    from cabinet_tpu_torch.models.cab import resize_bilinear

    x = spec["x"]
    if spec["kind"] == "conv":
        return F.conv2d(x, spec["weight"], spec["bias"], spec["stride"], spec["padding"],
                        groups=spec["groups"])
    if spec["kind"] == "mean":
        return x.mean(dim=(2, 3), keepdim=True)
    return resize_bilinear(x, spec["size"])


@pytest.fixture(scope="module")
def op_specs():
    g = torch.Generator().manual_seed(4)
    ops = {}
    for name, (ci, co, k, s, p, groups) in CONVS.items():
        x = torch.randn(2, ci, 8, 6, generator=g)
        spec = {"kind": "conv", "x": x, "weight": torch.randn(co, ci // groups, k, k, generator=g),
                "bias": torch.randn(co, generator=g) if groups == 1 else None, "stride": s,
                "padding": p, "groups": groups}
        spec["g"] = torch.randn(_whole_op(spec).shape, generator=g)
        ops[name] = spec
    for name, (shape, size) in RESIZES.items():
        spec = {"kind": name.rsplit("_", 1)[0] if name.endswith(("_odd", "_down")) else name,
                "x": torch.randn(shape, generator=g), "size": size}
        spec["g"] = torch.randn(_whole_op(spec).shape, generator=g)
        ops[name] = spec
    spec = {"kind": "mean", "x": torch.randn(2, 5, 8, 6, generator=g) * 3 + 1}
    spec["g"] = torch.randn(2, 5, 1, 1, generator=g)
    ops["mean"] = spec
    return ops


@pytest.fixture(scope="module")
def sp_runs(jax_step, op_specs, tmp_path_factory):
    """Each rank count's records: the ops, the branch, the train steps."""
    from cabinet_tpu_torch.models.cabinet import CABiNet

    g = torch.Generator().manual_seed(5)
    c = CABiNet(NC, mode="small", cfgs=CFGS).mobile.out_channels
    bx = torch.randn(2, c, 8, 4, generator=g)
    branch = {"x": bx, "g": [torch.randn(2, 256, 8, 4, generator=g),
                             torch.randn(2, NC, 8, 4, generator=g)]}
    x, y = _batch()
    runs = {}
    for ranks, train in RANKS.items():
        inputs = {"state_dict": jax_step["start"], "opt": OPT, "ema": EMA,
                  "n_min": B * H * W // 16, "x": torch.from_numpy(x), "y": torch.from_numpy(y),
                  "ops": op_specs, "branch": branch, "train": train}
        runs[ranks] = run_case(tmp_path_factory.mktemp(f"sp{ranks}"), "sp", inputs, ranks=ranks)
    return runs, branch


def _close(got, ref, what):
    err = float((got - ref).abs().max())
    assert err <= F32_REL * (float(ref.abs().max()) + 1e-6), (what, err)


@pytest.mark.parametrize("ranks", list(RANKS))
@pytest.mark.parametrize("op", list(CONVS) + list(RESIZES) + ["mean"])
def test_striped_op_equals_the_whole_op(op_specs, sp_runs, ranks, op):
    spec = op_specs[op]
    x = spec["x"].clone().requires_grad_(True)
    y = _whole_op({**spec, "x": x})
    (y * spec["g"]).sum().backward()
    got = [r["ops"][op] for r in sp_runs[0][ranks]]
    if spec["kind"] == "mean":  # the whole mean on every rank
        for o in got:
            _close(o["y"], y.detach(), op)
    else:
        _close(torch.cat([o["y"] for o in got], dim=2), y.detach(), op)
    _close(torch.cat([o["gx"] for o in got], dim=2), x.grad, (op, "input gradient"))


@pytest.mark.parametrize("ranks", list(RANKS))
def test_attention_branch_on_the_gathered_map(jax_step, sp_runs, ranks):
    """PSP's pooling and the CAB's attention read every token: the branch
    runs on the gathered map with BatchNorm's statistics taken locally, and
    each rank keeps its rows; forward, the stripes' gradient and the BN
    running statistics equal the whole branch's (no rank counts the map
    twice)."""
    from cabinet_tpu_torch.models.cabinet import CABiNet

    runs, branch = sp_runs
    model = CABiNet(NC, mode="small", cfgs=CFGS)
    model.load_state_dict(jax_step["start"])
    model.train()
    x = branch["x"].clone().requires_grad_(True)
    outs = model.ab(x)
    sum((y * g).sum() for y, g in zip(outs, branch["g"])).backward()
    got = runs[ranks]
    for i, y in enumerate(outs):
        _close(torch.cat([r["branch"]["y"][i] for r in got], dim=2), y.detach(), i)
    _close(torch.cat([r["branch"]["gx"] for r in got], dim=2), x.grad, "input gradient")
    stats = {k: v for k, v in model.ab.state_dict().items() if "running" in k}
    for r in got:
        assert r["branch"]["stats"].keys() == stats.keys()
        for k, v in stats.items():
            _close(r["branch"]["stats"][k], v, k)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

def _updates_close(got, ref, start):
    """Every float tensor within the suite's bound of its update from
    `start`, plus 4 f32 ulps of its magnitude, plus FLOOR of the tree's
    largest update. Returns the worst ratio of error to bound."""
    floats = [k for k in ref if torch.as_tensor(ref[k]).is_floating_point()]
    ups = {k: float((ref[k].float() - start[k].float()).abs().max()) for k in floats}
    largest = max(ups.values())
    worst = 0.0
    for k in floats:
        err = float((got[k].float() - ref[k].float()).abs().max())
        bound = F32_REL * ups[k] + 2.0 ** -21 * float(ref[k].abs().max()) + FLOOR * largest
        assert err <= bound, (k, err, bound)
        worst = max(worst, err / bound)
    return worst


def _held(o, ref, start):
    keys = [k for k in ref["state"] if not k.endswith("num_batches_tracked")]
    for kind in ("state", "ema"):
        _updates_close({k: o[kind][k] for k in keys}, {k: ref[kind][k] for k in keys},
                       {k: start[k] for k in keys})
    mom = {k: ref["momentum"][k] for k in o["momentum"]}  # JAX's tree adds batch_stats
    _updates_close(o["momentum"], mom, {k: torch.zeros_like(v) for k, v in mom.items()})


@pytest.mark.parametrize("ranks", list(RANKS))
def test_spatial_train_step_matches_jax_and_one_process(jax_step, sp_runs, ranks):
    n_data = ranks
    recs = [r["train"][n_data, 1, False] for r in sp_runs[0][ranks]]
    ref, start = jax_step, jax_step["start"]
    assert abs(ref["one"]["loss"] - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
    for o in recs:
        assert abs(float(o["loss"]) - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
        assert o["counters"] == (1, 0, 1)
        _held(o, ref["one"], start)
        _held(o, ref["jax"], start)
        comm = o["comm"]
        assert comm["sp_halo"] > 0 and comm["sp_gather"] == 2 and comm["sp_sum"] > 0
        assert comm["grad_all_reduce"] == 1 and comm["batch_norm"] > 0
    for o in recs[1:]:  # one copy of the weights on every rank
        assert all(torch.equal(o["state"][k], recs[0]["state"][k]) for k in o["state"])


@pytest.mark.parametrize("ranks", list(RANKS))
def test_spatial_step_with_remat_equals_without(sp_runs, ranks):
    """Every backbone block rematerialised: the recomputation repeats the
    blocks' halo exchanges in the backward, in the same order on every
    rank; the step is the one without remat, bit for bit."""
    for r in sp_runs[0][ranks]:
        a, b = r["train"][ranks, 1, False], r["train"][ranks, 1, True]
        assert torch.equal(a["loss"], b["loss"])
        for kind in ("state", "ema", "momentum"):
            assert all(torch.equal(a[kind][k], b[kind][k]) for k in a[kind]), kind
        assert b["comm"]["sp_halo"] > a["comm"]["sp_halo"]


def test_spatial_and_tensor_parallel_2x2(jax_step, sp_runs):
    """Stripes on the data axis, channel slices on the model axis (the
    model cut by `tensor_parallel` at min_features 48, then striped): the
    whole weights (gathered) against the one-process step."""
    recs = [r["train"][2, 2, False] for r in sp_runs[0][4]]
    for o in recs:
        assert abs(float(o["loss"]) - jax_step["loss"]) <= LOSS_REL * abs(jax_step["loss"])
        _held(o, jax_step["one"], jax_step["start"])
        assert sum(d is not None for d in o["dims"].values()) > 0, "no leaf split"
        assert o["comm"]["tp_forward"] > 0 and o["comm"]["sp_halo"] > 0


def test_stripe_layout_and_refusals():
    """The stripe of each data index (JAX's `spatial_sharding`: dim 1 of
    NHWC images and (B, H) labels), and the refusals: rows the axis does
    not split, and a model other than CABiNet."""
    from cabinet_tpu_torch.core import mesh
    from cabinet_tpu_torch.models.spatial_parallel import spatial_parallel, stripe_multiple
    from cabinet_tpu_torch.models.yolosem import YOLOSem

    x = torch.arange(2 * 8 * 3 * 1).reshape(2, 8, 3, 1)
    for d in range(4):
        m = mesh.Mesh(4, 1, d)
        assert mesh.stripe(8, m) == (2 * d, 2 * d + 2)
        assert torch.equal(mesh.spatial_sharding(m, 4)(x), x[:, 2 * d:2 * d + 2])
        assert torch.equal(mesh.spatial_sharding(m, 3)(x[..., 0]), x[:, 2 * d:2 * d + 2, :, 0])
    with pytest.raises(ValueError, match="equal stripes"):
        mesh.stripe(10, mesh.Mesh(4, 1, 0))
    with pytest.raises(ValueError, match="CABiNet only"):
        spatial_parallel(YOLOSem(5, "n"), mesh.Mesh(2, 1, 0))
    from cabinet_tpu_torch.models.cabinet import CABiNet

    assert stripe_multiple(CABiNet(NC, mode="small", cfgs=CFGS)) == 16
    assert stripe_multiple(CABiNet(19, mode="large")) == 32
    assert spatial_parallel(CABiNet(NC, mode="small", cfgs=CFGS), mesh.Mesh(1, 2, 0)) is not None
