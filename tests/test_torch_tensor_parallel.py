"""Tensor parallelism in the port (`runtime.model_axis`;
cabinet_tpu_torch.models.tensor_parallel on a (data, model) mesh of
cabinet_tpu_torch.core.mesh), on gloo CPU ranks, each a process of
tests/torch_dp_worker.py under a time limit, held against the JAX
package's own equivalence tests (tests/unit/test_mesh_and_sharded_eval.py)
on its small CABiNet (5 classes), with JAX on the 8 virtual CPU devices of
tests/conftest.py:
  - the rule: the port's split of every leaf of the converted state, keyed
    by its JAX name, is JAX's `tensor_parallel_spec` (`:153`);
  - one train step on 1x2 and 2x2 ranks at min_features 48 against JAX's
    step on a (4, 2) mesh with its state `shard_model_parallel`-placed
    (`:205`): the loss within 1e-5 of |ref|, the whole weights, BatchNorm
    statistics and EMA (gathered) within 2e-4 of max|ref|, and within the
    suite's bound of the update of the port's one-process step, as is the
    momentum (the clipped gradient), held to the one-process step's only:
    JAX's (4, 2) program is not its one-device step there, since it
    doubles the gradient of block_0's replicated depthwise kernel, and so
    its clip's norm, and every clipped gradient moves by 8% (asserted on
    its own); the steps' small learning rate keeps the weights within
    2e-4 of max|ref| all the same. Leaves really split (JAX's too), the
    replicated leaves bit-equal across the model ranks;
  - MscEval of the sharded model on 1x2 and 2x2 ranks (K1's plain version;
    tiles shared over the data axis) against JAX's model-sharded eval on
    the (4, 2) mesh (`:318`): probabilities within 1e-5 of max, the
    matrices equal;
  - the checkpoint (`:248`): a 1x2 run's `.pth` holds the one-rank run's
    keys and shapes, loads strict=True into the one-rank model and is read
    whole by a one-rank restore; a 1x2 resume continues bit-exactly;
  - the train mains' mesh: JAX's default data axis, and
    runtime.mesh_data that does not tile the ranks raising (the mains on
    ranks are in tests/test_torch_tp_mains.py).

Bounds: 1e-5 of |ref| for a loss and 2e-4 of max|ref| (the suite's f32
bound) for a tensor, as the issue of the port states them; the sharded
sums run in another order than JAX's GSPMD program."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu_torch.core import mesh
from test_torch_dp import run_case
from torch_dp_worker import TP_CFGS as CFGS
from torch_port_utils import F32_REL, assert_close_f32, assert_updates_close, perturb

B, S, NC = 8, 64, 5
MIN_FEATURES = 48
LOSS_REL = 1e-5
OPT = dict(lr0=1e-2, max_iter=100, momentum=0.9, wd=5e-4, power=0.9, warmup_steps=10,
           warmup_start_lr=1e-5)
EMA = dict(ema_decay=0.9, ema_tau=2.0)


@pytest.fixture(scope="module")
def jax_model():
    from cabinet_tpu.models import CABiNet

    model = CABiNet(n_classes=NC, mode="small", cfgs=CFGS)
    variables = model.init(jax.random.PRNGKey(0), jnp.zeros((1, S, S, 3)), train=True)
    return model, perturb(variables, seed=3)


# ---------------------------------------------------------------------------
# The rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_model,min_features", [(2, 48), (2, 256), (4, 48), (3, 16)])
def test_tensor_parallel_spec_rule_is_jaxs(jax_model, n_model, min_features):
    from flax.traverse_util import flatten_dict

    from cabinet_tpu.core.mesh import tensor_parallel_spec as jax_spec
    from cabinet_tpu_torch.models import tensor_parallel as tp
    from cabinet_tpu_torch.models.cabinet import CABiNet

    model = CABiNet(NC, mode="small", cfgs=CFGS)
    leaves = tp.jax_leaves(model)
    dims = tp.sharded_dims(model, n_model, min_features)
    flat = {"/".join(k): v for k, v in flatten_dict(jax_model[1]).items()}
    by_name = {name: key for key, (name, _, _) in leaves.items()}
    assert set(by_name) == set(flat)  # every JAX leaf, once
    split = 0
    for name, arr in flat.items():
        key = by_name[name]
        assert leaves[key][1] == arr.shape, name
        want = tuple(jax_spec(arr.shape, n_model, min_features))
        assert mesh.tensor_parallel_spec(arr.shape, n_model, min_features) == want
        assert (dims[key] is not None) == bool(want), name
        if want:  # JAX's trailing dim is the torch dim the port splits
            split += 1
            assert model.state_dict()[key].shape[dims[key]] == arr.shape[-1], name
    assert split > 0 or min_features == 256
    # the JAX test's own shapes
    for shape, n, mf in (((3, 3, 32, 256), 2, 256), ((256,), 2, 256), ((3, 3, 16, 64), 2, 256),
                         ((3, 3, 16, 255), 2, 128), ((), 2, 256)):
        assert mesh.tensor_parallel_spec(shape, n, mf) == tuple(jax_spec(shape, n, mf))


def test_model_cut_to_slices_keeps_keys_and_modules():
    """One rank of a 1x2 mesh (no process group needed to cut): the state
    dict keeps the model's keys, split leaves hold half of dim 0, the
    optimizer's groups and the module types are the model's."""
    from cabinet_tpu_torch.models import tensor_parallel as tp
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.train.optimizer import param_labels

    torch.manual_seed(0)
    whole = CABiNet(NC, mode="small", cfgs=CFGS)
    labels = param_labels(whole)
    sd = {k: v.clone() for k, v in whole.state_dict().items()}
    m = mesh.Mesh(1, 2, 1, mesh.SELF, None)
    cut = tp.tensor_parallel(whole, m, MIN_FEATURES)
    dims = tp.sharded_dims(CABiNet(NC, mode="small", cfgs=CFGS), 2, MIN_FEATURES)
    split = {k: d for k, d in dims.items() if d is not None}
    assert {k: d for k, d in tp.state_dims(cut).items() if d is not None} == split
    assert set(dims) <= set(tp.state_dims(cut)) and split
    got = cut.state_dict()
    assert got.keys() == sd.keys()
    for k, v in sd.items():
        want = v if dims.get(k) is None else v.narrow(0, v.shape[0] // 2, v.shape[0] // 2)
        assert torch.equal(got[k], want), k
    assert param_labels(cut) == labels
    assert tp.shard_state(sd, cut).keys() == sd.keys()
    assert all(torch.equal(tp.shard_state(sd, cut)[k], got[k]) for k in sd)
    assert tp.mesh_of(cut) is m and tp.tensor_parallel(whole, mesh.Mesh(2, 1, 0)) is whole


# ---------------------------------------------------------------------------
# One train step against JAX's (4, 2) mesh
# ---------------------------------------------------------------------------

def _batch():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, S, S, 3)).astype(np.float32)
    y = rng.integers(0, NC, (B, S, S))
    y[1, :20] = 255
    return x, y


def _jax_momentum(opt_state, batch_stats):
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


@pytest.fixture(scope="module")
def jax_step(jax_model):
    from cabinet_tpu.core.mesh import (
        MODEL_AXIS,
        batch_sharding,
        make_mesh,
        shard_model_parallel,
    )
    from cabinet_tpu.train.optimizer import build_optimizer
    from cabinet_tpu.train.trainer import create_train_state, make_train_step
    from cabinet_tpu_torch.utils.convert import state_dict_from_jax

    model, v = jax_model
    tx = build_optimizer(v["params"], max_grad_norm=1.0, **OPT)
    state0 = jax.device_get(create_train_state(jax.tree_util.tree_map(jnp.asarray, v), tx,
                                               **EMA))
    jmesh = make_mesh(n_data=4, n_model=2)
    st = shard_model_parallel(state0, jmesh, min_features=MIN_FEATURES)
    specs = [a.sharding.spec for a in jax.tree_util.tree_leaves(st.params)]
    n_split = sum(MODEL_AXIS in tuple(s) for s in specs)
    x, y = _batch()
    step = make_train_step(model.apply, tx, n_min=B * S * S // 16)
    st, loss = step(st, jax.device_put(jnp.asarray(x), batch_sharding(jmesh, 4)),
                    jax.device_put(jnp.asarray(y), batch_sharding(jmesh, 3)))

    def sd(tree):
        return state_dict_from_jax(jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float32), tree), CFGS)
    # the port's one-process step on the same weights and batch
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.optimizer import GroupedSGD

    start = state_dict_from_jax(v, CFGS)
    one = CABiNet(NC, mode="small", cfgs=CFGS)
    one.load_state_dict(start)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ost = T.create_train_state(one, GroupedSGD(one, max_grad_norm=1.0, **OPT), **EMA)
        ost, _ = T.make_train_step(n_min=B * S * S // 16)(ost, torch.from_numpy(x),
                                                          torch.from_numpy(y))
    finally:
        torch.set_num_threads(threads)
    names = {id(p): n for n, p in one.named_parameters()}
    return {"loss": float(loss), "n_split": n_split,
            "one": {"state": one.state_dict(), "ema": ost.ema.state_dict(),
                    "momentum": {names[id(p)]: st["momentum_buffer"]
                                 for p, st in ost.optimizer.sgd.state.items()}},
            "state": sd({"params": st.params, "batch_stats": st.batch_stats}),
            "ema": sd(st.ema.variables), "momentum": _jax_momentum(st.opt_state, st.batch_stats),
            "counters": (int(st.step), int(st.micro_step), int(st.ema.updates)),
            "start": start}


LAYOUTS = {"1x2": (1, 2), "2x2": (2, 2)}


@pytest.fixture(scope="module")
def tp_steps(jax_step, tmp_path_factory):
    """Each layout's ranks' records; the 1x2 run also checkpoints."""
    x, y = _batch()
    runs = {}
    for name, layout in LAYOUTS.items():
        folder = tmp_path_factory.mktemp(f"tp_{name}")
        inputs = {"state_dict": jax_step["start"], "opt": OPT, "ema": EMA,
                  "n_min": B * S * S // 16, "x": torch.from_numpy(x), "y": torch.from_numpy(y),
                  "mesh": layout, "ckpt": folder / "ckpt" if layout == (1, 2) else None}
        runs[name] = (run_case(folder, "tp_train", inputs, ranks=layout[0] * layout[1]),
                      folder)
    return runs


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_tensor_parallel_train_step_matches_jax(jax_step, tp_steps, layout):
    (n_data, n_model), (got, _) = LAYOUTS[layout], tp_steps[layout]
    ref = jax_step
    assert ref["n_split"] > 0  # JAX's placement split leaves too
    for o in got:
        assert sum(d is not None for d in o["dims"].values()) > 0, "no leaf split"
        assert abs(float(o["loss"]) - ref["loss"]) <= LOSS_REL * abs(ref["loss"])
        assert o["counters"] == ref["counters"] == (1, 0, 1)
        for kind in ("state", "ema"):
            keys = [k for k in ref[kind] if not k.endswith("num_batches_tracked")]
            assert all(k in o[kind] for k in keys), kind
            for k in keys:
                err = float((o[kind][k].float() - ref[kind][k].float()).abs().max())
                assert err <= F32_REL * (float(ref[kind][k].abs().max()) + 1e-6), (kind, k, err)
            # and the port's one-process step, within the suite's bound of the update
            assert_updates_close({k: o[kind][k] for k in keys},
                                 {k: ref["one"][kind][k] for k in keys},
                                 {k: ref["start"][k] for k in keys}, rel=F32_REL)
        # the momentum (the clipped gradient) against the one-process step's:
        # JAX's mesh program doubles block_0's depthwise gradient (module doc)
        mom = ref["one"]["momentum"]
        assert o["momentum"].keys() == mom.keys()
        scale = max(float(v.abs().max()) for v in mom.values())
        for k, v in o["momentum"].items():
            assert float((v - mom[k]).abs().max()) <= F32_REL * scale, k
    # one copy of every replicated leaf on the model ranks of a data group,
    # and each model rank its own slice of a split one
    for d in range(n_data):
        group = [o for o in got if o["mesh"][2] == d]
        assert len(group) == n_model
        for k, dim in group[0]["dims"].items():
            same = [torch.equal(group[0]["slices"][k], g["slices"][k]) for g in group[1:]]
            assert all(same) if dim is None else not all(same) or group[0]["slices"][k].abs().max() == 0, k
    comm = got[0]["comm"]
    assert comm["tp_forward"] > 0 and comm["tp_backward"] > 0 and comm["tp_grad_broadcast"] == 1
    assert ("batch_norm" in comm) == (n_data > 1) and ("loss" in comm) == (n_data > 1)


def test_jax_mesh_step_doubles_block0_depthwise_gradient(jax_step):
    """Why the port's TP step holds its momentum to its one-process step's and
    not to JAX's: JAX's (4, 2) step's momentum (its clipped gradient) is the
    one-process step's times one factor c < 1, the clip of a larger norm, on
    every leaf of the backbone but block_0's replicated depthwise kernel,
    which is at 2c: its gradient is doubled, and every clipped one moves."""
    one, jm = jax_step["one"]["momentum"], jax_step["momentum"]
    dw = "mobile.features.1.conv.0.weight"  # block_0's depthwise 3x3
    backbone = [k for k in one if k.startswith("mobile.")]
    scale = max(float(one[k].abs().max()) for k in backbone)

    def ratio(k):  # the least-squares factor from the one-process leaf to JAX's
        a, b = jm[k].double(), one[k].double()
        return float((a * b).sum() / (b * b).sum())
    c = float(np.median([ratio(k) for k in backbone if k != dw]))
    assert 0.85 < c < 0.95, c
    assert abs(ratio(dw) / c - 2.0) < 1e-2, (ratio(dw), c)
    for k in backbone:
        err = float((jm[k] - (2.0 if k == dw else 1.0) * c * one[k]).abs().max())
        assert err <= 5e-3 * scale, (k, err, scale)


def test_sharded_checkpoint_roundtrip(jax_step, tp_steps):
    """The 1x2 run's `.pth` files against the one-rank layout: the same
    keys and shapes, strict loads, a one-rank restore of the whole tree,
    and the 1x2 resume bit-equal to the uninterrupted second step."""
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.train import trainer as T
    from cabinet_tpu_torch.train.checkpoint import CheckpointManager, load_any_checkpoint
    from cabinet_tpu_torch.train.optimizer import GroupedSGD

    got, folder = tp_steps["1x2"]
    one = CABiNet(NC, mode="small", cfgs=CFGS)
    want = one.state_dict()
    for name in ("checkpoint_last.pth", "ema.pth"):
        sd = load_any_checkpoint(folder / "ckpt" / name)
        assert sd.keys() == want.keys() and all(sd[k].shape == want[k].shape for k in sd)
        one.load_state_dict(sd, strict=True)
    saved = load_any_checkpoint(folder / "ckpt" / "checkpoint_last.pth")
    for k, v in got[0]["state"].items():  # the file holds the gathered weights
        assert torch.equal(saved[k], v)
    state = T.create_train_state(one, GroupedSGD(one, max_grad_norm=1.0, **OPT), **EMA)
    restored = CheckpointManager(folder / "ckpt").restore_full("checkpoint_last", state)
    assert restored["epoch"] == 0 and state.step == 1
    names = {id(p): n for n, p in one.named_parameters()}
    for p, st in state.optimizer.sgd.state.items():
        assert torch.equal(st["momentum_buffer"], got[0]["momentum"][names[id(p)]])
    assert all(torch.equal(state.ema.state_dict()[k], v) for k, v in got[0]["ema"].items())
    for o in got:
        res = o["resume"]
        assert torch.equal(res["loss"][0], res["loss"][1])
        for a, b in ((res["straight"], res["resumed"]), res["ema"]):
            assert all(torch.equal(a[k], b[k]) for k in a)


# ---------------------------------------------------------------------------
# Model-sharded eval against JAX's (4, 2) mesh
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_inputs(jax_model):
    from cabinet_tpu.core.mesh import MODEL_AXIS, make_mesh, shard_model_parallel
    from cabinet_tpu.eval.evaluator import MscEval as JaxMscEval
    from cabinet_tpu_torch.utils.convert import state_dict_from_jax

    model, v = jax_model
    rng = np.random.default_rng(2)
    images = rng.normal(size=(1, 80, 72, 3)).astype(np.float32)
    labels = rng.integers(0, NC, (1, 80, 72)).astype(np.int64)
    jmesh = make_mesh(n_data=4, n_model=2)
    tp_vars = shard_model_parallel(jax.device_get(v), jmesh, min_features=MIN_FEATURES)
    assert any(MODEL_AXIS in tuple(a.sharding.spec)
               for a in jax.tree_util.tree_leaves(tp_vars["params"]))
    ev = JaxMscEval(model.apply, n_classes=NC, scales=(1.0,), cropsize=32, tile_mesh=jmesh)
    return {"images": images, "labels": labels, "state_dict": state_dict_from_jax(v, CFGS),
            "probs": ev.prob_batch(tp_vars, images),
            "hist": ev.hist_batch(tp_vars, images, labels)}


@pytest.mark.parametrize("layout", [(1, 2), (2, 2)], ids=["1x2", "2x2"])
def test_model_sharded_eval_matches_jax(eval_inputs, layout, tmp_path):
    inp = {k: eval_inputs[k] for k in ("images", "labels", "state_dict")}
    got = run_case(tmp_path, "tp_eval", {**inp, "mesh": layout}, ranks=layout[0] * layout[1])
    for o in got:
        assert_close_f32(o["probs"].numpy(), eval_inputs["probs"], rel=1e-5)
        np.testing.assert_array_equal(o["hist"], eval_inputs["hist"])
        assert o["comm"]["tp_forward"] > 0
        assert ("tile_all_reduce" in o["comm"]) == (layout[0] > 1)
    assert eval_inputs["hist"].sum() == 80 * 72


# ---------------------------------------------------------------------------
# The mesh of the train mains
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ranks,runtime,axes", [
    (4, {"model_axis": 2}, (2, 2)), (4, {"model_axis": 2, "mesh_data": 2}, (2, 2)),
    (2, {"model_axis": 2}, (1, 2)), (8, {"model_axis": 4, "mesh_data": 0}, (2, 4)),
    (4, {}, (4, 1)), (4, {"mesh_data": 4}, (4, 1)),
    (4, {"mesh_data": 1}, "runtime.mesh_data=1"), (2, {"model_axis": 2, "mesh_data": 2},
                                                   "runtime.mesh_data=2"),
    (3, {"model_axis": 2}, "runtime.model_axis=2"), (8, {}, "runtime.mesh_data=0"),
])
def test_mesh_axes_take_jaxs_default_and_tile_the_ranks(ranks, runtime, axes):
    """JAX's sizing (`auto_data_axis(batch 4, ranks / model_axis)` when
    runtime.mesh_data is 0), and a ConfigurationError naming the key where
    the grid would leave a rank out."""
    from cabinet_tpu_torch.cli.train import mesh_axes
    from cabinet_tpu_torch.core.config import Config
    from cabinet_tpu_torch.core.exceptions import ConfigurationError

    cfg = Config({"runtime": runtime, "training_config": {"batch_size": 4}})
    if isinstance(axes, str):
        with pytest.raises(ConfigurationError, match=axes):
            mesh_axes(cfg, ranks)
    else:
        assert mesh_axes(cfg, ranks) == axes
        if "model_axis" not in runtime:  # YOLO-sem's: the same data axis
            assert mesh_axes(cfg, ranks, family="yolosem") == axes
