"""Minimal HTTP inference server over an exported artifact or a checkpoint,
on the GPU (counterpart of `cabinet_tpu.cli.serve`).

Load either a `cli.export` artifact (one `torch.export` program with the
normalisation and the argmax inside; the model's own path, no kernel) or a
checkpoint (`cli/infer.py:Segmenter`, whose route runs the hand-written
kernels K1-K4 on the card), and serve masks over plain HTTP with the
standard library alone: PNG is read and written by the port's own codec,
other formats (JPEG) are read by PIL where it is installed.

Endpoints:
  GET  /healthz            -> JSON {"status": "ok", ...artifact metadata}
  GET  /metrics            -> JSON serving stats (req/s, p50/p99 latency ms,
                              mean batch size, queue depth, errors)
  POST /segment            -> body: PNG/JPEG bytes
       ?format=mask_png    -> grayscale class-ID PNG (default)
       ?format=color_png   -> palette-colorized PNG (artifact palette or
                              dataset palette)
       response headers: X-Classes, X-Infer-Millis
  400 for a bad format, body or length, 404 for another path, 413 past the
  body limit, 503 when the queue stays full (or the server is closing),
  500 when the batch's forward failed: an error on the card reaches every
  request of its batch as an error, never as a mask.

Concurrent requests are dynamically micro-batched: one worker thread owns
the device and coalesces whatever requests arrive within
--batch-deadline-ms of the first (up to --max-batch) into one forward at
the next power-of-two regime. The HTTP threads stay on the host: they
decode the body. The worker copies the batch's frames to the card in one
copy, resizes them to the engine's resolution and pads the batch there,
runs the forward and the argmax, and copies the uint8 class IDs of the
real rows back (`cli/infer.py:BatchStep`). A bounded queue gives backpressure (503)
instead of unbounded memory growth. Each regime's first forward runs
before the server is made (`_Engine.warmup_ms`).

Usage (CUDA unless --device cpu):
    python -m cabinet_tpu_torch.cli.serve --artifact artifacts/uavid_large
    python -m cabinet_tpu_torch.cli.serve --checkpoint ck.pth --dataset uavid
"""

from __future__ import annotations

import argparse
import collections
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Sequence, Union

import numpy as np
import torch

from cabinet_tpu_torch.cli.infer import BatchStep, Segmenter, check_frame

# request-body ceiling: a lossless 8K PNG is ~100 MB; anything larger is
# not a plausible single image for a segmentation request
MAX_BODY_BYTES = 128 << 20


class ServerBusy(RuntimeError):
    """Bounded request queue stayed full past the submit timeout."""


class _Item:
    __slots__ = ("x", "event", "result", "error")

    def __init__(self, x):
        self.x = x
        self.event = threading.Event()
        self.result = None
        self.error: Optional[BaseException] = None


class _MicroBatcher:
    """Dynamic micro-batching: one worker thread owns the accelerator.

    submit() enqueues an input and blocks until its result is ready. The worker coalesces requests that arrive within `deadline_ms`
    of the first one (up to `max_batch`) and runs ONE forward at the next
    power-of-two regime (bounding the shapes the device sees to
    log2(max_batch)+1). infer_batch(xs, regime) receives only the real
    inputs, as a list (frames of different sizes do not stack), and is
    responsible for padding to the regime on the device and returning
    exactly len(xs) results: padding on the host would double the bytes
    copied each way. A solo request under no load pays at most
    the deadline in extra latency; under load the deadline never waits, as
    the queue is already non-empty when a batch completes.

    With `warmup` (one input), the worker first runs one forward at each
    regime on it and the constructor waits for them (their ms in
    `warmup_ms`): the first call of a shape pays one-time costs that do not
    depend on the input, and some of them are kept per thread (cuDNN's
    plans, the cuBLAS handle), so they are paid on the worker's own thread.
    A warm-up error raises from the constructor.
    """

    def __init__(self,
                 infer_batch: Callable[[list, int], np.ndarray],
                 max_batch: int = 8, deadline_ms: float = 3.0,
                 queue_depth: int = 64, submit_timeout_s: float = 30.0,
                 warmup: Optional[np.ndarray] = None):
        self.infer_batch = infer_batch
        self.max_batch = max(1, int(max_batch))
        self.deadline_s = max(0.0, float(deadline_ms)) / 1e3
        self.submit_timeout_s = float(submit_timeout_s)
        self._q: "queue.Queue[Optional[_Item]]" = queue.Queue(
            maxsize=max(1, int(queue_depth)))
        self._closing = threading.Event()
        self._stats_lock = threading.Lock()
        self._lat_ms: collections.deque = collections.deque(maxlen=4096)
        self.n_requests = 0
        self.n_errors = 0
        self.n_batches = 0
        self.n_coalesced_inputs = 0
        self._started = time.perf_counter()
        self.warmup_ms: Dict[int, float] = {}
        self._warmup = warmup
        self._warm = threading.Event()
        self._warmup_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-microbatch")
        self._thread.start()
        self._warm.wait()
        if self._warmup_error is not None:
            self.close()
            raise self._warmup_error

    def submit(self, x: np.ndarray) -> np.ndarray:
        if self._closing.is_set():
            raise ServerBusy("server is shutting down")
        item = _Item(x)
        t0 = time.perf_counter()
        try:
            self._q.put(item, timeout=self.submit_timeout_s)
        except queue.Full:
            raise ServerBusy(
                f"request queue full ({self._q.maxsize}) for "
                f"{self.submit_timeout_s:.0f}s") from None
        # Bounded wait: a put() can land AFTER close() drained the queue (a
        # producer blocked on a full queue wins the race against the drain);
        # once the worker thread is dead nobody will ever set that item's
        # event, so detect it instead of hanging forever.
        while not item.event.wait(timeout=0.5):
            if self._closing.is_set() and not self._thread.is_alive():
                self._drain("server closed")  # release any same-race peers
                if item.event.is_set():
                    break
                raise ServerBusy("server closed")
        if item.error is not None:
            # errored requests are not served throughput: count them
            # separately and keep their latencies out of the percentiles
            with self._stats_lock:
                self.n_errors += 1
            raise item.error
        lat_ms = (time.perf_counter() - t0) * 1e3
        with self._stats_lock:
            self._lat_ms.append(lat_ms)
            self.n_requests += 1
        return item.result

    def close(self) -> None:
        """Signal shutdown and release every waiter. The flag (not a
        blocking sentinel put) is the shutdown channel: a blocking put on
        the bounded queue could deadlock against producers that keep it
        full while the worker (the only consumer) is the one blocked."""
        self._closing.set()
        try:
            self._q.put_nowait(None)  # wake a worker idle on q.get()
        except queue.Full:
            pass  # worker is busy; it checks the flag between batches
        self._thread.join(timeout=5)
        self._drain("server closed")

    def _drain(self, reason: str) -> None:
        """Error out anything still queued so no submit() waits forever."""
        while True:
            try:
                it = self._q.get_nowait()
            except queue.Empty:
                return
            if it is not None:
                it.error = ServerBusy(reason)
                it.event.set()

    def reset_stats(self) -> None:
        """Zero counters/latencies (warmup exclusion)."""
        with self._stats_lock:
            self._lat_ms.clear()
            self.n_requests = self.n_batches = self.n_coalesced_inputs = 0
            self.n_errors = 0
            self._started = time.perf_counter()

    def stats(self) -> dict:
        with self._stats_lock:
            lat = sorted(self._lat_ms)
            n_req, n_b = self.n_requests, self.n_batches
            n_co = self.n_coalesced_inputs

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 2) \
                if lat else None

        elapsed = time.perf_counter() - self._started
        return {
            "requests": n_req,
            "errors": self.n_errors,
            "batches": n_b,
            "mean_batch_size": round(n_co / n_b, 3) if n_b else None,
            "max_batch": self.max_batch,
            "deadline_ms": self.deadline_s * 1e3,
            "queue_depth": self._q.qsize(),
            "latency_ms_p50": pct(0.50),
            "latency_ms_p99": pct(0.99),
            "requests_per_s": round(n_req / elapsed, 2) if elapsed else None,
        }

    def _run_warmup(self) -> None:
        try:
            for regime in _regimes(self.max_batch) if self._warmup is not None else ():
                t0 = time.perf_counter()
                self.infer_batch([self._warmup], regime)
                self.warmup_ms[regime] = (time.perf_counter() - t0) * 1e3
        except BaseException as e:  # reaches the constructor
            self._warmup_error = e
        finally:
            self._warm.set()

    def _loop(self) -> None:
        self._run_warmup()
        while not self._closing.is_set():
            try:  # bounded get so the flag is re-checked while idle
                first = self._q.get(timeout=0.2)
            except queue.Empty:
                continue
            if first is None:
                break
            items = [first]
            deadline = time.perf_counter() + self.deadline_s
            while len(items) < self.max_batch:
                remaining = deadline - time.perf_counter()
                try:
                    nxt = (self._q.get_nowait() if remaining <= 0
                           else self._q.get(timeout=remaining))
                except queue.Empty:
                    break
                if nxt is None:  # close() raced a live batch: finish it
                    break
                items.append(nxt)
            n = len(items)
            regime = min(1 << (n - 1).bit_length(), self.max_batch)
            # only the n real inputs: infer_batch pads to the regime on the
            # device and brings back n rows
            xs = [it.x for it in items]
            try:
                preds = self.infer_batch(xs, regime)
                for i, it in enumerate(items):
                    it.result = np.asarray(preds[i]).astype(np.uint8)
            except BaseException as e:  # propagate to every waiter
                for it in items:
                    it.error = e
            with self._stats_lock:
                self.n_batches += 1
                self.n_coalesced_inputs += n
            for it in items:
                it.event.set()
        self._drain("server closed")


def _regimes(max_batch: int) -> list:
    """The batch sizes `_MicroBatcher` runs: powers of two below
    `max_batch`, and `max_batch`."""
    return sorted({min(1 << k, max_batch) for k in range(max_batch.bit_length() + 1)})


class _Engine:
    """predict(rgb uint8 HxWx3) -> mask (imgsz, imgsz) uint8.

    Runs on CUDA unless `device="cpu"`; raises when CUDA is asked for and
    there is none. Before it returns, the batcher's worker has run one
    forward at each regime it can pick (`_MicroBatcher`'s `warmup`; their
    ms in `warmup_ms`)."""

    def __init__(self, artifact: Optional[str], checkpoint: Optional[str],
                 dataset: Optional[str], mode: str, imgsz: int,
                 dtype: str, max_batch: int = 8, deadline_ms: float = 3.0,
                 queue_depth: int = 64, submit_timeout_s: float = 30.0,
                 device: Union[str, torch.device] = "cuda"):
        from cabinet_tpu_torch.core.device import resolve_device

        device = resolve_device(device)
        self.palette = None
        if artifact:
            from cabinet_tpu_torch.export import load_artifact

            serve, meta = load_artifact(artifact, device)
            if "imgsz" not in meta:
                # without metadata the CLI default imgsz would be applied to
                # an artifact exported at another size: every request would
                # then die on a shape mismatch. Fail at startup.
                raise SystemExit(
                    f"artifact {artifact} has no metadata.json (bare file "
                    "moved away from its export directory?); serve needs "
                    "the exported imgsz/batch: point --artifact at the "
                    "cli.export output directory")
            self.meta = meta
            self.imgsz = int(meta["imgsz"])
            batch = str(meta.get("batch", "1"))
            if batch.isdigit():
                if int(batch) != 1:
                    # a fixed batch other than 1 would reject every
                    # single-image request: fail at startup, not per request
                    raise SystemExit(
                        f"artifact was exported with fixed batch {batch}; "
                        "serve needs batch 1 (solo) or a symbolic batch "
                        "(--batch b at export) for micro-batching")
                # a fixed batch-1 program cannot coalesce
                max_batch = 1
            if meta.get("palette"):
                self.palette = np.asarray(meta["palette"], np.uint8)
            infer_batch = BatchStep(serve, device, self.imgsz)
        else:
            from cabinet_tpu_torch.data.palettes import PALETTES, trainid_palette

            # batch=max_batch picks the kernel route once for every regime
            # (K4 in front of the fused tail at >= 8 in bf16 on Large)
            seg = Segmenter(checkpoint, dataset, mode=mode, imgsz=imgsz,
                            dtype_name=dtype, batch=max_batch, device=device)
            self.meta = {"dataset": dataset, "imgsz": imgsz,
                         "n_classes": seg.n_classes, "route": seg.route}
            self.imgsz = imgsz
            if dataset in PALETTES:
                self.palette = trainid_palette(PALETTES[dataset])
            infer_batch = seg.step

        # a frame of another size than imgsz, so that the warm-up runs the
        # resize too
        self.batcher = _MicroBatcher(
            infer_batch, max_batch=max_batch, deadline_ms=deadline_ms,
            queue_depth=queue_depth, submit_timeout_s=submit_timeout_s,
            warmup=np.zeros((self.imgsz // 2 + 1, self.imgsz + 1, 3), np.uint8))
        self.warmup_ms = self.batcher.warmup_ms

    def predict(self, rgb: np.ndarray) -> np.ndarray:
        # the frame is checked here, on the HTTP thread: a bad one must not
        # fail the other requests of its batch
        return self.batcher.submit(check_frame(rgb))

    def stats(self) -> dict:
        return self.batcher.stats()


def make_handler(engine: _Engine):
    from cabinet_tpu_torch.data.decode import decode_rgb, encode_png

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/healthz":
                self._json(200, {"status": "ok", **{
                    k: v for k, v in engine.meta.items()
                    if isinstance(v, (str, int, float, type(None)))}})
            elif path == "/metrics":
                self._json(200, engine.stats())
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            path, _, query = self.path.partition("?")
            if path != "/segment":
                return self._json(404, {"error": "unknown path"})
            fmt = "mask_png"
            for part in query.split("&"):
                if part.startswith("format="):
                    fmt = part.split("=", 1)[1]
            # validate before spending serialized accelerator time
            if fmt not in ("mask_png", "color_png"):
                return self._json(400, {"error": f"unknown format {fmt}"})
            if fmt == "color_png" and engine.palette is None:
                return self._json(400, {
                    "error": "artifact/dataset has no palette; "
                             "use format=mask_png"})
            try:
                n = int(self.headers.get("Content-Length", 0))
            except ValueError:
                return self._json(400, {"error": "bad Content-Length"})
            if n < 0:
                return self._json(400, {"error": "bad Content-Length"})
            if n > MAX_BODY_BYTES:
                # the client-declared length is buffered whole before
                # decoding: cap it so one request can't exhaust host RAM
                return self._json(413, {
                    "error": f"body {n} bytes exceeds the "
                             f"{MAX_BODY_BYTES >> 20} MiB limit"})
            try:
                rgb = decode_rgb(self.rfile.read(n))
            except Exception as e:  # any decoder's failure is a bad body
                return self._json(400, {"error": f"bad image: {e}"})
            t0 = time.perf_counter()
            try:
                mask = engine.predict(rgb)
            except ServerBusy as e:
                return self._json(503, {"error": str(e)})
            except Exception as e:  # the batch's forward failed
                return self._json(500, {"error": f"{type(e).__name__}: {e}"})
            ms = (time.perf_counter() - t0) * 1e3
            mask_native = Segmenter._postprocess(torch.from_numpy(mask),
                                                 rgb.shape[:2])
            body = encode_png(engine.palette[mask_native] if fmt == "color_png"
                              else mask_native)
            self.send_response(200)
            self.send_header("Content-Type", "image/png")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("X-Classes", str(int(mask_native.max()) + 1))
            self.send_header("X-Infer-Millis", f"{ms:.1f}")
            self.end_headers()
            self.wfile.write(body)

    return Handler


class _Server(ThreadingHTTPServer):
    # the listen backlog: with socketserver's default of 5, clients that
    # connect at once past it are reset before the micro-batcher (whose
    # bounded queue is the backpressure) ever sees them
    request_queue_size = 128


def make_server(engine: _Engine, host: str = "127.0.0.1",
                port: int = 8651) -> ThreadingHTTPServer:
    return _Server((host, port), make_handler(engine))


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--artifact", help="cli.export artifact directory")
    src.add_argument("--checkpoint",
                     help="reference .pth state dict, a .pth of the port's "
                          "trainer, or a JAX variables .npz")
    p.add_argument("--dataset", default=None,
                   help="dataset name (required with --checkpoint)")
    p.add_argument("--mode", default="large", choices=("large", "small"))
    p.add_argument("--imgsz", type=int, default=1024)
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8651)
    p.add_argument("--max-batch", type=int, default=8,
                   help="micro-batching ceiling (1 disables coalescing)")
    p.add_argument("--batch-deadline-ms", type=float, default=3.0,
                   help="how long the first queued request waits for "
                        "company before the forward launches")
    p.add_argument("--queue-depth", type=int, default=64,
                   help="bounded request queue; once full, submits wait up "
                        "to --submit-timeout-s before the 503")
    p.add_argument("--submit-timeout-s", type=float, default=30.0,
                   help="how long a request may wait on a full queue before "
                        "503 backpressure (lower = shed load sooner)")
    p.add_argument("--device", default="cuda",
                   help="torch device; 'cpu' runs the kernels' plain versions")
    args = p.parse_args(argv)
    if args.checkpoint and not args.dataset:
        raise SystemExit("--checkpoint requires --dataset")

    engine = _Engine(args.artifact, args.checkpoint, args.dataset,
                     args.mode, args.imgsz, args.dtype,
                     max_batch=args.max_batch,
                     deadline_ms=args.batch_deadline_ms,
                     queue_depth=args.queue_depth,
                     submit_timeout_s=args.submit_timeout_s,
                     device=args.device)
    server = make_server(engine, args.host, args.port)
    print(f"serving on http://{args.host}:{server.server_address[1]} "
          f"(meta: {engine.meta.get('dataset')}, {engine.imgsz}^2, "
          f"device {args.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        engine.batcher.close()


if __name__ == "__main__":
    main()
