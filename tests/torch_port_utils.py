"""Helpers shared by the tests/test_torch_*.py files, which hold the
PyTorch port (cabinet_tpu_torch) against the JAX package on the CPU."""

from pathlib import Path

import jax
import numpy as np
import torch

FIXTURE_DIR = Path(__file__).resolve().parent / "fixtures"
LARGE_FIXTURE = FIXTURE_DIR / "miou_large_cabinet_v1.npz"

# The suite's f32 bound for activations (docs/ARCHITECTURE.md): 2e-4 of the
# largest reference magnitude.
F32_REL = 2e-4


def assert_close_f32(got, ref, rel=F32_REL):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    err = float(np.max(np.abs(got - ref)))
    bound = rel * (float(np.max(np.abs(ref))) + 1e-6)
    assert err <= bound, f"max abs err {err} > bound {bound}"


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def perturb(variables, seed=0, scale=0.05):
    """Numpy copy of JAX variables with seeded noise on every array, BN
    variances kept positive, and the CAB's zero-initialised gamma and
    project_out made non-zero so the global attention reaches the output."""
    rng = np.random.default_rng(seed)
    v = to_numpy_tree(variables)

    def noisy(path, a):
        names = [getattr(p, "key", "") for p in path]
        a = a + scale * rng.standard_normal(a.shape).astype(a.dtype)
        if names[-1] == "var":
            a = np.abs(a) + 0.5
        if names[-1] == "gamma":
            a = a + 0.7
        return a

    v = jax.tree_util.tree_map_with_path(noisy, v)
    po = v["params"]["ab"]["a2block"]["global_attn"]["project_out"]
    po["kernel"] = (0.1 * rng.standard_normal(po["kernel"].shape)
                    ).astype(np.float32)
    return v


def port_model(variables, n_classes, mode, cfgs, attention="einsum"):
    """The port's CABiNet holding `variables` (through the weight bridge)."""
    from cabinet_tpu_torch.models.cabinet import CABiNet
    from cabinet_tpu_torch.utils.convert import state_dict_from_jax

    model = CABiNet(n_classes, mode=mode, cfgs=cfgs, attention=attention)
    model.load_state_dict(state_dict_from_jax(variables, cfgs), strict=True)
    return model.eval()


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x)).permute(0, 3, 1, 2)


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def load_large_fixture():
    """(flat numpy arrays, nested JAX variables in f32) of the trained
    CABiNet-Large fixture (5 classes, full published cfg table)."""
    from flax.traverse_util import unflatten_dict

    with np.load(LARGE_FIXTURE) as data:
        flat = {k: data[k] for k in data.files}
    nested = unflatten_dict({
        tuple(k.split("/")): v.astype(np.float32) if v.dtype == np.float16 else v
        for k, v in flat.items()})
    return flat, nested


def jax_tree_from_state_dict(sd, cfgs, mapping=None):
    """The inverse of the weight bridge: the port's state dict (tensors or
    arrays) -> nested JAX variables {"params", "batch_stats"} of numpy
    arrays, through the port's copy of the key table (CABiNet's of `cfgs`,
    or the `mapping` given, e.g. `yolosem_mapping(variant)`)."""
    from cabinet_tpu_torch.utils.convert import BN, CONV, LINEAR, cabinet_mapping

    tree = {"params": {}, "batch_stats": {}}

    def put(coll, path, value):
        node = tree[coll]
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.asarray(value.detach().cpu() if hasattr(value, "detach")
                                    else value)

    for torch_key, flax_path, kind in mapping or cabinet_mapping(cfgs):
        if kind == BN:
            if f"{torch_key}.weight" in sd:
                put("params", flax_path + ("scale",), sd[f"{torch_key}.weight"])
                put("params", flax_path + ("bias",), sd[f"{torch_key}.bias"])
            if f"{torch_key}.running_mean" in sd:
                put("batch_stats", flax_path + ("mean",), sd[f"{torch_key}.running_mean"])
                put("batch_stats", flax_path + ("var",), sd[f"{torch_key}.running_var"])
            continue
        t = sd[torch_key]
        t = t.detach().cpu() if hasattr(t, "detach") else torch.from_numpy(np.asarray(t))
        if kind == CONV:
            t = t.permute(2, 3, 1, 0)
        elif kind == LINEAR:
            t = t.t()
        put("params", flax_path, t.contiguous())
    return tree


def assert_updates_close(got, ref, start, rel, ulps=2.0 ** -21):
    """Every float tensor of `got` within rel * max|ref - start| + ulps *
    max|ref| of `ref` (state dicts keyed alike). The second term is a few
    f32 ulps of the tensor's magnitude (2^-21 is 4 ulps at 2^-23 each): a
    parameter moved by much less than its magnitude is rounded at every
    step, and a tensor whose update is zero in exact arithmetic (the bias of
    a BN that a 1x1 conv and a train-mode BN follow) moves by rounding alone.
    Returns the largest ratio of error to bound."""
    worst, where = 0.0, None
    for k, r in ref.items():
        r = torch.as_tensor(r)
        if not torch.is_floating_point(r):
            continue
        r = r.float()
        g = torch.as_tensor(got[k]).float()
        d = (r - torch.as_tensor(start[k]).float()).abs().max().item()
        err = (g - r).abs().max().item()
        bound = rel * d + ulps * r.abs().max().item()
        ratio = err / bound if bound > 0 else (0.0 if err == 0 else float("inf"))
        if ratio > worst:
            worst, where = ratio, (k, err, d)
    assert worst <= 1.0, f"{where}: error {worst:.3g} x its bound"
    return worst


def yolo_variables(n_classes, variant="n", size=64, seed=0, scale=0.05):
    """Numpy copy of JAX YOLOSem variables (init at size^2) with seeded noise
    on every array and the BN variances kept positive."""
    from cabinet_tpu.models.yolosem import YOLOSem

    v = to_numpy_tree(YOLOSem(n_classes=n_classes, variant=variant).init(
        jax.random.PRNGKey(seed), np.zeros((1, size, size, 3), np.float32), train=False))
    rng = np.random.default_rng(seed)

    def noisy(path, a):
        a = a + scale * rng.standard_normal(a.shape).astype(a.dtype)
        return np.abs(a) + 0.5 if getattr(path[-1], "key", "") == "var" else a

    return jax.tree_util.tree_map_with_path(noisy, v)


def yolo_port_model(variables, n_classes, variant="n"):
    """The port's YOLOSem holding `variables` (through the weight bridge),
    in eval mode."""
    from cabinet_tpu_torch.models.yolosem import YOLOSem
    from cabinet_tpu_torch.utils.convert import yolosem_state_dict_from_jax

    model = YOLOSem(n_classes, variant)
    model.load_state_dict(yolosem_state_dict_from_jax(variables, variant), strict=True)
    return model.eval()
