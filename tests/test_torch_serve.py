"""The port's HTTP server (cabinet_tpu_torch/cli/serve.py) on the CPU: the
micro-batcher's contract (the JAX suite's tests of
tests/integration/test_serve.py, run against the port's class), the HTTP
surface over an exported artifact, and the checkpoint route against the
JAX server's engine."""

import json
import shutil
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.models import CABiNet as JaxCABiNet
from cabinet_tpu.utils.torch_convert import flax_to_torch
from cabinet_tpu_torch.cli.serve import (
    MAX_BODY_BYTES,
    ServerBusy,
    _Engine,
    _MicroBatcher,
    make_server,
)
from cabinet_tpu_torch.data.decode import decode_png, encode_png, png_mask, png_rgb
from cabinet_tpu_torch.export import (
    ARTIFACT_NAME,
    METADATA_NAME,
    export_serving,
    save_artifact,
)
from cabinet_tpu_torch.models.cabinet import CABiNet
from cabinet_tpu_torch.models.mobilenetv3 import MOBILENETV3_LARGE_CFGS
from torch_port_utils import perturb

IMGSZ = 64
# the JAX server tests' small table (tests/integration/test_serve.py)
CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2],
        [5, 6, 96, 1, 1, 2]]
PALETTE = [[0, 0, 0], [255, 0, 0], [0, 255, 0], [0, 0, 255]]


# ---------------------------------------------------------------------------
# Dynamic micro-batching (the JAX suite's contract tests)
# ---------------------------------------------------------------------------

def test_microbatcher_coalesces_and_routes():
    """Concurrent submits coalesce into one power-of-two-regime forward;
    each result routes to its own waiter; only the real rows reach
    infer_batch; errors propagate to every member of the failed batch and
    stay out of the served requests."""
    seen_batches = []

    def infer(xs, regime):
        seen_batches.append((len(xs), regime))
        time.sleep(0.02)  # let the queue fill while a batch runs
        return np.stack(xs)[:, 0, 0] + 1  # distinct per input -> routing check

    mb = _MicroBatcher(infer, max_batch=4, deadline_ms=50, queue_depth=16)
    try:
        with ThreadPoolExecutor(8) as pool:
            futs = [pool.submit(mb.submit, np.full((2, 2), i, np.uint8))
                    for i in range(8)]
            results = [f.result(timeout=30) for f in futs]
        for i, r in enumerate(results):
            assert int(r) == i + 1  # each waiter got ITS result
        st = mb.stats()
        assert st["requests"] == 8
        assert st["batches"] < 8, "no coalescing happened"
        assert st["mean_batch_size"] > 1
        for n, regime in seen_batches:
            assert regime in (1, 2, 4)  # pow2 regimes, capped at max_batch
            assert n <= regime  # only real rows cross to infer_batch

        def boom(xs, regime):
            raise RuntimeError("kaboom")

        mb2 = _MicroBatcher(boom, max_batch=2, deadline_ms=5)
        with pytest.raises(RuntimeError, match="kaboom"):
            mb2.submit(np.zeros((2, 2), np.uint8))
        assert mb2.stats()["requests"] == 0
        assert mb2.stats()["errors"] == 1
        mb2.close()
    finally:
        mb.close()


def test_microbatcher_errors_reach_every_waiter_of_the_batch():
    """A batch whose forward fails gives each of its members the error (no
    result), and the next batch is served. The deadline is long enough for
    the four requests to share one batch; the batch runs once it is full."""
    calls = []

    def flaky(xs, regime):
        calls.append(len(xs))
        if len(calls) == 1:
            raise RuntimeError("device fault")
        return np.stack(xs)[:, 0, 0]

    mb = _MicroBatcher(flaky, max_batch=4, deadline_ms=5000, queue_depth=8)
    try:
        def one(i):
            try:
                return ("ok", int(mb.submit(np.full((2, 2), i, np.uint8))))
            except RuntimeError as e:
                return ("error", str(e))

        with ThreadPoolExecutor(4) as pool:
            outcomes = list(pool.map(one, range(4)))
        assert calls == [4]
        assert outcomes == [("error", "device fault")] * 4
        mb.deadline_s = 0.0  # a solo request need not wait for company
        assert int(mb.submit(np.full((2, 2), 9, np.uint8))) == 9
        assert mb.stats()["errors"] == 4 and mb.stats()["requests"] == 1
    finally:
        mb.close()


def test_microbatcher_close_under_load_releases_all_waiters():
    """close() while producers keep a tiny queue full terminates within the
    join timeout and releases every waiter (result or ServerBusy)."""
    def slow_infer(xs, regime):
        time.sleep(0.05)  # keep the queue saturated
        return np.stack(xs)[:, 0, 0]

    mb = _MicroBatcher(slow_infer, max_batch=2, deadline_ms=1,
                       queue_depth=2, submit_timeout_s=2.0)

    def one(i):
        try:
            return ("ok", mb.submit(np.full((2, 2), i, np.uint8)))
        except ServerBusy as e:
            return ("busy", str(e))

    with ThreadPoolExecutor(12) as pool:
        futs = [pool.submit(one, i) for i in range(24)]
        time.sleep(0.1)  # mid-flight, queue full
        t0 = time.perf_counter()
        mb.close()
        close_s = time.perf_counter() - t0
        outcomes = [f.result(timeout=10) for f in futs]  # nobody hangs
    assert close_s < 6.0, f"close() blocked {close_s:.1f}s"
    assert all(kind in ("ok", "busy") for kind, _ in outcomes)
    assert any(kind == "ok" for kind, _ in outcomes)


def test_microbatcher_warms_each_regime_on_its_worker_thread():
    """With `warmup`, the worker runs one forward per regime (1, 2, 4, ...,
    max_batch) on its own thread before the constructor returns; the
    warm-up is no served request; its error raises from the constructor."""
    seen = []

    def infer(xs, regime):
        seen.append((threading.current_thread().name, len(xs), regime))
        return np.stack(xs)[:, 0, 0]

    mb = _MicroBatcher(infer, max_batch=6, warmup=np.zeros((2, 2), np.uint8))
    try:
        assert seen == [("serve-microbatch", 1, r) for r in (1, 2, 4, 6)]
        assert sorted(mb.warmup_ms) == [1, 2, 4, 6]
        assert mb.stats()["requests"] == mb.stats()["batches"] == 0
        assert int(mb.submit(np.full((2, 2), 5, np.uint8))) == 5
    finally:
        mb.close()

    def broken(xs, regime):
        raise RuntimeError("no device")

    before = threading.active_count()
    with pytest.raises(RuntimeError, match="no device"):
        _MicroBatcher(broken, warmup=np.zeros((2, 2), np.uint8))
    assert threading.active_count() == before


@pytest.mark.parametrize("sizes", [[(70, 100), (64, 64), (70, 100), (30, 200)],
                                   [(70, 100)] * 3])
def test_batch_step_keeps_each_frame_on_its_row(sizes):
    """`BatchStep` on frames of mixed sizes: every frame's answer is its
    own row, resized alone, the rows past the frames are zero, and only
    the frames' rows come back."""
    from cabinet_tpu_torch.cli.infer import BatchStep, resize_frame

    rng = np.random.default_rng(len(sizes))
    frames = [rng.integers(0, 256, (*hw, 3), dtype=np.uint8) for hw in sizes]
    seen = []

    def forward(x):
        seen.append(x.clone())
        return x[..., 1]

    out = BatchStep(forward, "cpu", IMGSZ)(frames, 8)
    assert out.shape == (len(frames), IMGSZ, IMGSZ) and out.dtype == np.uint8
    assert seen[0].shape == (8, IMGSZ, IMGSZ, 3) and not seen[0][len(frames):].any()
    for f, row in zip(frames, out):
        np.testing.assert_array_equal(row, resize_frame(torch.from_numpy(f), IMGSZ)[..., 1])
    with pytest.raises(ValueError, match="RGB uint8"):
        BatchStep(forward, "cpu", IMGSZ)([np.zeros((4, 4), np.uint8)])


# ---------------------------------------------------------------------------
# HTTP over a CPU artifact
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A symbolic-batch CPU artifact of a small seeded CABiNet."""
    torch.manual_seed(0)
    model = CABiNet(4, "small", cfgs=CFGS)
    program = export_serving(model, mean=(0.5,) * 3, std=(0.25,) * 3,
                             imgsz=IMGSZ, batch="b", device="cpu")
    return save_artifact(program, tmp_path_factory.mktemp("art_b"), {
        "dataset": "test", "imgsz": IMGSZ, "n_classes": 4, "batch": "b",
        "palette": PALETTE})


def _serve(engine):
    srv = make_server(engine, "127.0.0.1", 0)  # ephemeral port
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


@pytest.fixture(scope="module")
def server(artifact):
    engine = _Engine(str(artifact), None, None, "small", IMGSZ, "float32",
                     max_batch=4, deadline_ms=50.0, queue_depth=32, device="cpu")
    srv, url = _serve(engine)
    yield url, engine
    srv.shutdown()
    srv.server_close()
    engine.batcher.close()


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers or {"Content-Type": "image/png"})
    return urllib.request.urlopen(req, timeout=120)


def _status(url, body=b"x", headers=None, method="POST"):
    req = urllib.request.Request(url, data=body if method == "POST" else None,
                                 headers=headers or {}, method=method)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    return e.value.code, json.loads(e.value.read())


def test_healthz_and_warmup(server):
    url, engine = server
    with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
        meta = json.loads(r.read())
    assert meta["status"] == "ok" and meta["dataset"] == "test"
    assert meta["device"] == "cpu"
    assert sorted(engine.warmup_ms) == [1, 2, 4]


def test_segment_mask(server):
    url, _ = server
    rgb = (np.random.default_rng(0).random((80, 120, 3)) * 255).astype(np.uint8)
    with _post(f"{url}/segment", encode_png(rgb)) as r:
        assert r.headers["Content-Type"] == "image/png"
        n_classes = int(r.headers["X-Classes"])
        assert float(r.headers["X-Infer-Millis"]) >= 0
        mask = png_mask(decode_png(r.read()))
    # the mask comes back at the INPUT resolution with valid class IDs
    assert mask.shape == (80, 120)
    assert 1 <= n_classes <= 4 and mask.max() < 4 and mask.max() + 1 == n_classes


def test_segment_color(server):
    url, _ = server
    rgb = (np.random.default_rng(1).random((64, 64, 3)) * 255).astype(np.uint8)
    with _post(f"{url}/segment?format=mask_png", encode_png(rgb)) as r:
        mask = png_mask(decode_png(r.read()))
    with _post(f"{url}/segment?format=color_png", encode_png(rgb)) as r:
        img = png_rgb(decode_png(r.read()))
    assert img.shape == (64, 64, 3)
    np.testing.assert_array_equal(img, np.asarray(PALETTE, np.uint8)[mask])


@pytest.mark.parametrize("path,body,headers,code", [
    ("/segment", b"not an image", None, 400),
    ("/segment?format=jpeg", b"x", None, 400),
    ("/segment", b"x", {"Content-Length": "abc"}, 400),
    ("/segment", b"x", {"Content-Length": "-5"}, 400),
    ("/segment", b"x", {"Content-Length": str(MAX_BODY_BYTES + 1)}, 413),
    ("/other", b"x", None, 404)])
def test_bad_requests(server, path, body, headers, code):
    """A bad body, format or length is a 400, an oversized declared length a
    413 (refused before the body is read), another path a 404."""
    url, _ = server
    got, payload = _status(f"{url}{path}", body, headers)
    assert got == code and "error" in payload


def _bomb(kind):
    """A small PNG body that would inflate far past its size: a header
    declaring more pixels than the reader takes ("pixels"), or a 64x64
    header whose image data inflates to 64 MiB ("data")."""
    import struct
    import zlib

    from cabinet_tpu_torch.data.decode import PNG_SIGNATURE

    def chunk(t, p):
        return struct.pack(">I", len(p)) + t + p + struct.pack(">I", zlib.crc32(t + p))

    side = 20000 if kind == "pixels" else 64
    data = zlib.compress(bytes(64 << 20), 9)
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", side, side, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", data) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind,error", [("pixels", "exceeds the limit"),
                                        ("data", "more PNG image data")])
def test_decompression_bomb_is_a_400(server, kind, error):
    """A body under the size limit that inflates to 64 MiB or more is a 400
    from the decoder, which inflates no more than the header's image
    needs."""
    url, engine = server
    code, payload = _status(f"{url}/segment", _bomb(kind))
    assert code == 400 and error in payload["error"]


def test_unknown_get_is_404(server):
    url, _ = server
    assert _status(f"{url}/nope", method="GET")[0] == 404


def test_concurrent_clients_microbatch(server):
    """Concurrent clients all get the same mask as a solo request, and the
    server coalesces them into fewer batches."""
    url, engine = server
    rgb = (np.random.default_rng(7).random((48, 72, 3)) * 255).astype(np.uint8)
    body = encode_png(rgb)
    with _post(f"{url}/segment", body) as r:
        ref = png_mask(decode_png(r.read()))
    engine.batcher.reset_stats()

    def one(_):
        with _post(f"{url}/segment", body) as r:
            return png_mask(decode_png(r.read()))

    with ThreadPoolExecutor(8) as pool:
        masks = list(pool.map(one, range(12)))
    for m in masks:
        np.testing.assert_array_equal(m, ref)  # batching never changes math
    with urllib.request.urlopen(f"{url}/metrics", timeout=30) as r:
        st = json.loads(r.read())
    assert st["requests"] == 12 and st["errors"] == 0
    assert st["batches"] < st["requests"], "no coalescing under load"
    assert st["mean_batch_size"] > 1
    assert st["latency_ms_p50"] is not None and st["latency_ms_p99"] is not None


def test_forward_failure_is_a_500_not_a_mask(artifact):
    """An error in the batch's forward (a kernel or the card failing)
    reaches the request as a 500 and is counted as an error."""
    engine = _Engine(str(artifact), None, None, "small", IMGSZ, "float32",
                     max_batch=2, device="cpu")
    engine.batcher.close()

    def broken(xs, regime):
        raise RuntimeError("CUDA error: an illegal memory access")

    engine.batcher = _MicroBatcher(broken, max_batch=2, deadline_ms=1)
    srv, url = _serve(engine)
    try:
        rgb = np.zeros((20, 30, 3), np.uint8)
        code, payload = _status(f"{url}/segment", encode_png(rgb))
        assert code == 500 and "illegal memory access" in payload["error"]
        assert engine.stats()["errors"] == 1 and engine.stats()["requests"] == 0
    finally:
        srv.shutdown()
        srv.server_close()
        engine.batcher.close()


def test_metadataless_artifact_fails_at_startup(artifact, tmp_path):
    """A bare serving.pt2 with no metadata.json beside it fails at startup,
    not per request on a shape mismatch."""
    bare = tmp_path / ARTIFACT_NAME
    shutil.copy(artifact / ARTIFACT_NAME, bare)
    with pytest.raises(SystemExit, match="metadata.json"):
        _Engine(str(bare), None, None, "small", IMGSZ, "float32", device="cpu")


@pytest.mark.parametrize("batch,ok", [("2", False), ("1", True)])
def test_fixed_batch_artifacts(artifact, tmp_path, batch, ok):
    """An artifact exported with a fixed batch other than 1 fails at
    startup; a batch-1 artifact serves without coalescing (max_batch 1)."""
    art = tmp_path / "art"
    shutil.copytree(artifact, art)
    meta = json.loads((art / METADATA_NAME).read_text())
    (art / METADATA_NAME).write_text(json.dumps({**meta, "batch": batch}))
    if not ok:
        with pytest.raises(SystemExit, match="fixed batch 2"):
            _Engine(str(art), None, None, "small", IMGSZ, "float32", device="cpu")
        return
    engine = _Engine(str(art), None, None, "small", IMGSZ, "float32",
                     max_batch=8, device="cpu")
    try:
        assert engine.batcher.max_batch == 1 and sorted(engine.warmup_ms) == [1]
        assert engine.predict(np.zeros((10, 10, 3), np.uint8)).shape == (IMGSZ, IMGSZ)
    finally:
        engine.batcher.close()


# ---------------------------------------------------------------------------
# The checkpoint route against the JAX server's engine
# ---------------------------------------------------------------------------

def test_checkpoint_route_matches_jax_engine(tmp_path):
    """The port's /segment response for a 100x70 PNG, served from a .pth of
    seeded uavid weights (Large, f32, imgsz 64), against JAX's
    `cabinet_tpu.cli.serve._Engine(None, ckpt, "uavid", "large", 64,
    "float32").predict` on the same frame, brought to the frame's size by
    the same nearest-exact rule. The two engines resize the frame apart
    (PIL there, torch's uint8 resize here: within one level, equal on >=
    99% of the input's values), so the masks are held as a resized frame
    is in tests/test_torch_slice.py: equal on at least 99% of pixels; and
    the port's mask is equal to the argmax of the JAX model on the port's
    own resized input on every pixel whose top-2 margin there exceeds 1e-3."""
    from cabinet_tpu.cli.serve import _Engine as JaxEngine
    from cabinet_tpu_torch.cli.infer import Segmenter, resize_frame
    from cabinet_tpu_torch.data.datasets import DATASET_REGISTRY

    jm = JaxCABiNet(n_classes=8, mode="large")
    v = perturb(jm.init(jax.random.PRNGKey(21), jnp.zeros((1, IMGSZ, IMGSZ, 3)),
                        train=False), seed=22)
    ckpt = tmp_path / "uavid_large.pth"
    torch.save({k: torch.from_numpy(np.ascontiguousarray(a))
                for k, a in flax_to_torch(v, MOBILENETV3_LARGE_CFGS).items()}, ckpt)
    rgb = np.random.default_rng(23).integers(0, 256, (70, 100, 3), dtype=np.uint8)

    jeng = JaxEngine(None, str(ckpt), "uavid", "large", IMGSZ, "float32",
                     max_batch=2)
    try:
        want = jeng.predict(rgb)
        jax_input = jeng._preprocess(rgb)
    finally:
        jeng.batcher.close()

    engine = _Engine(None, str(ckpt), "uavid", "large", IMGSZ, "float32",
                     max_batch=2, device="cpu")
    srv, url = _serve(engine)
    try:
        with _post(f"{url}/segment", encode_png(rgb)) as r:
            got = png_mask(decode_png(r.read()))
    finally:
        srv.shutdown()
        srv.server_close()
        engine.batcher.close()

    stats = DATASET_REGISTRY["uavid"]
    own = ((resize_frame(torch.from_numpy(rgb), IMGSZ).numpy().astype(np.float32) / 255.0
            - np.asarray(stats.MEAN, np.float32)) / np.asarray(stats.STD, np.float32))
    step = 1 / 255 / min(stats.STD)
    d = np.abs(own - jax_input)
    assert d.max() <= step * 1.001 and (d < 1e-6).mean() >= 0.99
    logits = np.asarray(jm.apply(v, jnp.asarray(own[None]), train=False)[0])[0]
    top2 = np.sort(logits, axis=-1)[..., -2:]
    sure = torch.from_numpy((top2[..., 1] - top2[..., 0] > 1e-3).astype(np.uint8))
    sure = Segmenter._postprocess(sure, rgb.shape[:2]).astype(bool)
    model_mask = Segmenter._postprocess(torch.from_numpy(logits.argmax(-1)),
                                        rgb.shape[:2])
    want = Segmenter._postprocess(torch.from_numpy(want), rgb.shape[:2])
    assert got.shape == want.shape == (70, 100)
    assert sure.mean() > 0.9
    np.testing.assert_array_equal(got[sure], model_mask[sure])
    assert (got == want).mean() >= 0.99
