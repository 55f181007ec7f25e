"""The port's serving export (cabinet_tpu_torch/export.py, cli/export.py)
against the JAX package's (cabinet_tpu/export.py, cli/export.py) on the
CPU: the serving function's masks, the artifact's round trip, its
metadata, and the CLI with CABiNet and with YOLO-sem (`--family yolosem`,
whose artifact the server serves)."""

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


def test_yolosem_serving_fn_matches_jax():
    """make_serving_fn on a YOLOSem (n variant, f32) against the JAX
    package's on the same seeded uint8 batch, weights through the bridge:
    masks equal on every pixel whose JAX top-2 margin exceeds 1e-3, and on
    at least 99% of all pixels."""
    from cabinet_tpu.models.yolosem import YOLOSem as JaxYOLOSem
    from torch_port_utils import yolo_port_model, yolo_variables

    v = yolo_variables(8, "n", size=IMGSZ, seed=6)
    jm = JaxYOLOSem(n_classes=8, variant="n")
    x = _random_u8(2, seed=7)
    want = np.asarray(jax.jit(jax_serving_fn(jm, v, MEAN, STD))(jnp.asarray(x)))
    with torch.no_grad():
        got = make_serving_fn(yolo_port_model(v, 8, "n"), MEAN, STD,
                              torch.float32)(torch.from_numpy(x)).numpy()
    norm = (x.astype(np.float32) / 255.0 - np.float32(0.5)) / np.float32(0.25)
    top2 = np.sort(np.asarray(jm.apply(v, jnp.asarray(norm), train=False)[0]), axis=-1)[..., -2:]
    sure = (top2[..., 1] - top2[..., 0]) > 1e-3
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got[sure], want[sure])
    assert (got == want).mean() >= 0.99


@pytest.fixture(scope="module")
def yolo_artifacts(tmp_path_factory):
    """`cli/export.py --family yolosem --variant n --check` on the CPU from
    a `.pth` of the port's state dict and from the JAX variables `.npz` it
    was converted from (float32, symbolic batch, 32^2), and with
    `--quantize int8 --calib`: (directory, {name: (artifact, printed)})."""
    import contextlib
    import io

    from cabinet_tpu_torch.cli.export import main
    from cabinet_tpu_torch.data.decode import save_png
    from cabinet_tpu_torch.utils.convert import yolosem_state_dict_from_jax
    from torch_port_utils import yolo_variables

    base = tmp_path_factory.mktemp("yolo_export")
    v = yolo_variables(8, "n", size=32, seed=8)
    np.savez(base / "vars.npz", **{"/".join(str(getattr(k, "key", k)) for k in path): a
                                   for path, a in jax.tree_util.tree_flatten_with_path(v)[0]})
    torch.save(yolosem_state_dict_from_jax(v, "n"), base / "final.pth")
    rng = np.random.default_rng(4)
    for i in range(2):
        save_png(base / f"calib_{i}.png", rng.integers(0, 256, (40, 56, 3), np.uint8))
    runs = {"pth": ["--checkpoint", str(base / "final.pth")],
            "npz": ["--checkpoint", str(base / "vars.npz")],
            "int8": ["--checkpoint", str(base / "final.pth"), "--quantize", "int8",
                     "--calib", str(base / "calib_*.png")]}
    out = {}
    for name, argv in runs.items():
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            main(argv + ["--family", "yolosem", "--variant", "n", "--dataset", "uavid",
                         "--out", str(base / name), "--imgsz", "32", "--batch", "b",
                         "--dtype", "float32", "--device", "cpu", "--check"])
        out[name] = (base / name, printed.getvalue())
    return base, out


def test_cli_export_yolosem_check_on_cpu(yolo_artifacts):
    """Each artifact loads back bit-equal to its live module (--check); the
    metadata has the JAX CLI's keys with family yolosem and variant n; the
    .npz and the .pth give the same masks; the int8 one reports its
    sites."""
    _, runs = yolo_artifacts
    for name, (art, printed) in runs.items():
        assert "round-trip check passed" in printed, name
        meta = json.loads((art / METADATA_NAME).read_text())
        assert set(meta) == _jax_cli_metadata_keys() | {"device"}
        assert (meta["family"], meta["variant"], meta["n_classes"], meta["imgsz"]) == (
            "yolosem", "n", 8, 32)
    assert "int8 PTQ: calibrated" in runs["int8"][1]
    assert json.loads((runs["int8"][0] / METADATA_NAME).read_text())["quantize"] == "int8"
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (3, 32, 32, 3), np.uint8))
    with torch.no_grad():
        masks = {n: load_artifact(runs[n][0], "cpu")[0](x) for n in ("pth", "npz")}
    assert torch.equal(masks["pth"], masks["npz"])


def test_server_answers_with_the_yolosem_artifacts_masks(yolo_artifacts):
    """The checkpoint-less server on the YOLO-sem artifact, as it serves a
    CABiNet one: /healthz shows its metadata and /segment answers 32x32
    frames with the artifact's own masks."""
    import threading
    import urllib.request

    from cabinet_tpu_torch.cli.serve import _Engine, make_server
    from cabinet_tpu_torch.data.decode import decode_png, encode_png, png_mask

    _, runs = yolo_artifacts
    art = runs["pth"][0]
    engine = _Engine(str(art), None, None, "large", 32, "float32", max_batch=2,
                     deadline_ms=5.0, queue_depth=8, device="cpu")
    srv = make_server(engine, "127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{srv.server_address[1]}"
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            meta = json.loads(r.read())
        assert meta["family"] == "yolosem" and meta["status"] == "ok"
        serve, _ = load_artifact(art, "cpu")
        rng = np.random.default_rng(9)
        for _ in range(2):
            rgb = rng.integers(0, 256, (32, 32, 3), np.uint8)
            req = urllib.request.Request(f"{url}/segment", data=encode_png(rgb), method="POST",
                                         headers={"Content-Type": "image/png"})
            with urllib.request.urlopen(req, timeout=120) as r:
                mask = png_mask(decode_png(r.read()))
            with torch.no_grad():
                want = serve(torch.from_numpy(rgb)[None])[0].numpy()
            np.testing.assert_array_equal(mask, want)
    finally:
        srv.shutdown()
        srv.server_close()
        engine.batcher.close()
