"""The port's serving export (cabinet_tpu_torch/export.py, cli/export.py)
against the JAX package's (cabinet_tpu/export.py, cli/export.py) on the
CPU: the serving function's masks, the artifact's round trip, its
metadata, and the CLI's refusals."""

import ast
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.export import make_serving_fn as jax_serving_fn
from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu_torch.export import (
    ARTIFACT_NAME,
    METADATA_NAME,
    export_serving,
    load_artifact,
    make_serving_fn,
    save_artifact,
)
from cabinet_tpu_torch.models.cabinet import CABiNet
from cabinet_tpu_torch.models.mobilenetv3 import MOBILENETV3_LARGE_CFGS
from torch_port_utils import perturb, port_model

IMGSZ = 64
MEAN = (0.5, 0.5, 0.5)
STD = (0.25, 0.25, 0.25)
# the JAX export tests' small table (tests/integration/test_export.py)
CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2],
        [5, 6, 96, 1, 1, 2]]
JAX_CLI = Path(__file__).resolve().parent.parent / "cabinet_tpu" / "cli" / "export.py"


def _random_u8(batch, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (batch, IMGSZ, IMGSZ, 3), np.uint8)


@pytest.fixture(scope="module")
def small_model():
    torch.manual_seed(0)
    return CABiNet(4, "small", cfgs=CFGS).eval()


@pytest.fixture(scope="module")
def symbolic_artifact(small_model, tmp_path_factory):
    program = export_serving(small_model, mean=MEAN, std=STD, imgsz=IMGSZ,
                             batch="b", device="cpu")
    return save_artifact(program, tmp_path_factory.mktemp("art_b"),
                         {"dataset": "test", "imgsz": IMGSZ, "batch": "b"})


@pytest.mark.parametrize("mode,cfgs", [("small", CFGS), ("large", None)])
def test_serving_fn_matches_jax(mode, cfgs):
    """The port's make_serving_fn against cabinet_tpu.export.make_serving_fn
    in f32 on the same seeded uint8 batch, weights through the bridge:
    masks equal on every pixel whose JAX top-2 logit margin exceeds 1e-3,
    and on at least 99% of all pixels."""
    jm = JaxCABiNet(n_classes=8, mode=mode, cfgs=cfgs)
    v = perturb(jm.init(jax.random.PRNGKey(3), jnp.zeros((1, IMGSZ, IMGSZ, 3)),
                        train=False), seed=4)
    tm = port_model(v, 8, mode, MOBILENETV3_LARGE_CFGS if cfgs is None else cfgs)
    x = _random_u8(2, seed=5)

    want = np.asarray(jax.jit(jax_serving_fn(jm, v, MEAN, STD))(jnp.asarray(x)))
    with torch.no_grad():
        got = make_serving_fn(tm, MEAN, STD, torch.float32)(torch.from_numpy(x))
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, IMGSZ, IMGSZ)
    got = got.numpy()

    norm = (x.astype(np.float32) / 255.0 - np.float32(0.5)) / np.float32(0.25)
    logits = np.asarray(jm.apply(v, jnp.asarray(norm), train=False)[0])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got[sure], want[sure])
    assert (got == want).mean() >= 0.99


def test_serving_fn_leaves_the_model_as_it_is(small_model):
    before = {k: v.clone() for k, v in small_model.state_dict().items()}
    make_serving_fn(small_model, MEAN, STD, torch.bfloat16)
    after = small_model.state_dict()
    assert all(torch.equal(before[k], after[k]) and before[k].dtype == after[k].dtype
               for k in before)


def test_roundtrip_fixed_batch_1_bit_exact(small_model, tmp_path):
    program = export_serving(small_model, mean=MEAN, std=STD, imgsz=IMGSZ,
                             batch=1, device="cpu")
    out = save_artifact(program, tmp_path / "art", {"dataset": "test"})
    assert (out / ARTIFACT_NAME).is_file()
    meta = json.loads((out / METADATA_NAME).read_text())
    assert meta == {"dataset": "test", "device": "cpu"}

    serve, meta2 = load_artifact(out, "cpu")
    assert meta2 == meta
    x = torch.from_numpy(_random_u8(1))
    with torch.no_grad():
        got = serve(x)
        want = make_serving_fn(small_model, MEAN, STD)(x)
    assert got.dtype == torch.int32 and tuple(got.shape) == (1, IMGSZ, IMGSZ)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b", [1, 3])
def test_symbolic_batch_roundtrip_bit_exact(small_model, symbolic_artifact, b):
    serve, meta = load_artifact(symbolic_artifact, "cpu")
    assert meta["batch"] == "b" and meta["device"] == "cpu"
    x = torch.from_numpy(_random_u8(b, seed=b))
    with torch.no_grad():
        got = serve(x)
        want = make_serving_fn(small_model, MEAN, STD)(x)
    assert tuple(got.shape) == (b, IMGSZ, IMGSZ)
    assert torch.equal(got, want)


def test_load_bare_file_picks_up_sibling_metadata(symbolic_artifact):
    """Pointing load_artifact at the serving.pt2 FILE (not its directory)
    must still find the metadata.json beside it."""
    serve, meta = load_artifact(symbolic_artifact / ARTIFACT_NAME, "cpu")
    assert meta["dataset"] == "test" and meta["imgsz"] == IMGSZ
    with torch.no_grad():
        got = serve(torch.from_numpy(_random_u8(2)))
    assert tuple(got.shape) == (2, IMGSZ, IMGSZ)


def test_load_refuses_another_device_type(symbolic_artifact, tmp_path):
    """A program exported for one device type does not move to another: the
    load raises and says so. Without CUDA the default device raises too."""
    moved = tmp_path / "cuda_art"
    shutil.copytree(symbolic_artifact, moved)
    meta = json.loads((moved / METADATA_NAME).read_text())
    (moved / METADATA_NAME).write_text(json.dumps({**meta, "device": "cuda"}))
    with pytest.raises(ValueError, match="exported for cuda, not cpu"):
        load_artifact(moved, "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            load_artifact(symbolic_artifact)


def test_export_refuses_the_attention_kernel():
    """The artifact holds no kernel: a model with the kernel attention is
    refused before tracing."""
    model = CABiNet(4, "small", cfgs=CFGS, attention="kernel")
    with pytest.raises(ValueError, match="holds no kernel"):
        export_serving(model, mean=MEAN, std=STD, imgsz=IMGSZ, device="cpu")


def _jax_cli_metadata_keys():
    """The keys of the metadata dict cabinet_tpu/cli/export.py passes to
    save_artifact, read from its source."""
    for node in ast.walk(ast.parse(JAX_CLI.read_text())):
        if (isinstance(node, ast.Call) and getattr(node.func, "id", "") == "save_artifact"
                and isinstance(node.args[2], ast.Dict)):
            return {k.value for k in node.args[2].keys}
    raise AssertionError("no save_artifact call with a dict literal")


def test_cli_export_main_check_on_cpu(tmp_path, capsys):
    """`python -m cabinet_tpu_torch.cli.export ... --device cpu --check`:
    the artifact loads back bit-equal to the live module, and its metadata
    has the JAX CLI's keys, with `device` for JAX's `platforms`."""
    from cabinet_tpu_torch.cli.export import main

    torch.manual_seed(1)
    ckpt = tmp_path / "small.pth"
    torch.save(CABiNet(8, "small").state_dict(), ckpt)
    out = tmp_path / "art"
    main(["--checkpoint", str(ckpt), "--dataset", "uavid", "--out", str(out),
          "--imgsz", "32", "--batch", "b", "--mode", "small",
          "--dtype", "float32", "--device", "cpu", "--check"])
    assert "round-trip check passed" in capsys.readouterr().out
    meta = json.loads((out / METADATA_NAME).read_text())
    assert set(meta) == _jax_cli_metadata_keys() | {"device"}
    assert (meta["dataset"], meta["n_classes"], meta["imgsz"], meta["batch"],
            meta["device"]) == ("uavid", 8, 32, "b", "cpu")
    assert len(meta["palette"]) == 256


@pytest.mark.parametrize("argv,item", [(["--family", "yolosem"], "item 6")])
def test_cli_export_refuses_what_is_not_ported(tmp_path, argv, item):
    from cabinet_tpu_torch.cli.export import main

    with pytest.raises(NotImplementedError, match=item):
        main(["--checkpoint", str(tmp_path / "unused.pth"), "--dataset", "uavid",
              "--out", str(tmp_path / "art"), "--device", "cpu", *argv])
