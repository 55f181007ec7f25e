"""The port's span and counter recorder (cabinet_tpu_torch.utils.profiler):
off unless torch.profiler runs; under it, spans are events of the trace,
nested as the blocks are, and counters add up; the request path and the
multi-scale evaluation record their layers; the device's idle time splits
over the innermost span of the launching thread by intersection; the
store is a ring."""

import collections
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import Interval
from torch.profiler import ProfilerActivity, profile

from cabinet_tpu_torch.utils import profiler as P


@pytest.fixture(autouse=True)
def empty_store():
    P.clear_spans()
    yield
    P.clear_spans()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def _kept():
    return [r.name for r in P._SPANS]


def _span_children(event):
    return {c.name for c in event.cpu_children if c.name in P._NAMES}


def test_without_a_profiler_nothing_is_recorded():
    assert P.span("a") is P.span("b", device="cpu")  # one shared no-op
    with P.span("a", device="cpu"):
        P.count("n", 3)
    assert P.span_summary() == {"spans": {}, "counters": {}}
    assert _kept() == []


def test_spans_nest_share_their_root_and_are_events_of_the_trace():
    with _cpu_profile() as prof:
        with P.span("outer"):
            with P.span("mid", device="cpu"):
                with P.span("inner", device="cpu"):
                    torch.ones(64).sum()
                P.count("n", 2)
            P.count("n")
        with P.span("second"):
            pass
    ev = {e.name: e for e in prof.events()}
    assert {"outer", "mid", "inner", "second"} <= set(ev)
    assert ev["inner"].cpu_parent.name == "mid"
    assert ev["mid"].cpu_parent.name == "outer"
    assert ev["outer"].cpu_parent is None and ev["second"].cpu_parent is None
    root = ev["inner"]
    while root.cpu_parent is not None:
        root = root.cpu_parent
    assert root.name == "outer"
    assert _kept() == ["inner", "mid", "outer", "second"]  # as each closed
    s = P.span_summary()
    assert s["counters"] == {"n": 3}
    assert s["spans"]["outer"]["count"] == 1 and s["spans"]["outer"]["device_s"] is None
    # on the CPU a device span's clock is the host's
    assert 0 < s["spans"]["inner"]["device_s"] <= s["spans"]["mid"]["device_s"]
    assert s["spans"]["mid"]["host_s"] <= s["spans"]["outer"]["host_s"]


def test_the_request_path_records_the_call_and_its_five_layers(tmp_path):
    from cabinet_tpu_torch.cli.infer import Segmenter
    from cabinet_tpu_torch.models.cabinet import CABiNet

    torch.manual_seed(0)
    torch.save(CABiNet(8, "small").state_dict(), tmp_path / "ck.pth")
    seg = Segmenter(str(tmp_path / "ck.pth"), "uavid", mode="small", imgsz=32,
                    dtype_name="float32", device="cpu")
    rng = np.random.default_rng(0)
    frames = [rng.integers(0, 256, hw + (3,), dtype=np.uint8)
              for hw in ((40, 56), (32, 32), (20, 30))]
    with _cpu_profile() as prof:
        out = seg.step(frames, 4)
    assert out.shape == (3, 32, 32)
    calls = [e for e in prof.events() if e.name == "serve.call"]
    assert len(calls) == 1
    assert _span_children(calls[0]) == {"serve.stage", "serve.upload", "serve.resize",
                                        "serve.forward", "serve.download"}
    s = P.span_summary()
    assert s["spans"]["serve.stage"]["device_s"] is None
    assert all(s["spans"][n]["device_s"] is not None
               for n in ("serve.upload", "serve.resize", "serve.forward", "serve.download"))
    assert s["counters"] == {"serve.frames": 3}


def test_msc_eval_records_its_batches_and_the_staging_thread(monkeypatch):
    from cabinet_tpu_torch.eval import evaluator
    from cabinet_tpu_torch.eval.evaluator import MscEval

    opened = []

    def logged(name, device=None):
        opened.append((name, threading.get_ident()))
        return P.span(name, device)

    monkeypatch.setattr(evaluator, "span", logged)
    n_classes = 4
    w = torch.randn(3, n_classes, generator=torch.Generator().manual_seed(0))

    def apply_fn(_, x):
        return x.float() @ w, None

    ev = MscEval(apply_fn, n_classes, ignore_label=255, scales=(0.75, 1.0), flip=True,
                 cropsize=16, tile_batch=4, device="cpu")
    rng = np.random.default_rng(1)
    batches = [(rng.standard_normal((1, 24, 32, 3)).astype(np.float32),
                rng.integers(0, n_classes, (1, 24, 32))) for _ in range(2)]
    with _cpu_profile() as prof:
        res = ev.evaluate(None, batches)
    assert res["timing"]["frames"] == 2
    roots = [e for e in prof.events() if e.name == "eval.batch"]
    scored = [e for e in roots if _span_children(e) > {"eval.wait"}]
    assert len(scored) == 2
    for b in scored:
        assert b.cpu_parent is None
        assert _span_children(b) == {"eval.wait", "eval.resize", "eval.forward",
                                     "eval.accumulate", "eval.score"}
    me = threading.get_ident()
    stage = [t for name, t in opened if name == "eval.stage"]
    assert len(stage) == 2 and me not in stage
    assert all(t == me for name, t in opened if name != "eval.stage")
    s = P.span_summary()
    assert s["spans"]["eval.stage"]["count"] == 2
    assert s["counters"] == {"eval.frames": 2}
    # a frame: 2x2 tiles of 16 at 0.75 (18x24), 2x3 at 1.0 (24x32); 4 a fold
    assert s["spans"]["eval.forward"]["count"] == 6 and s["spans"]["eval.resize"]["count"] == 4


def _event(name, start, end, thread=1, device=False, launched=0.0):
    return SimpleNamespace(name=name, time_range=Interval(start, end), thread=thread,
                           device_type=DeviceType.CUDA if device else DeviceType.CPU,
                           is_user_annotation=False, self_device_time_total=launched)


def test_idle_time_splits_over_the_innermost_span_by_intersection(monkeypatch):
    busy = [(0.0, 10.0), (40.0, 50.0)]
    ranges = [(5.0, 25.0, "A"), (20.0, 45.0, "B"), (30.0, 35.0, "C")]
    got = P.idle_by_span(busy, (0.0, 60.0), ranges)
    # the gap 10-40 begins under A and runs through B and C inside B
    assert got == {"A": 10.0, "B": 15.0, "C": 5.0, P.NO_SPAN: 10.0}
    assert sum(got.values()) == 60.0 - 20.0
    # of two ranges that start together, the one that ends first is inner
    assert P.idle_by_span([], (0.0, 4.0), [(0.0, 4.0, "out"), (0.0, 1.0, "in")]) == {
        "in": 1.0, "out": 3.0}
    # two threads: a worker's span, started last, runs beside the launching
    # thread's work and takes none of its idle time
    monkeypatch.setattr(P, "_NAMES", {"main.work", "main.wait", "worker.stage"})
    events = [_event("main.work", 0.0, 100.0), _event("main.wait", 60.0, 80.0),
              _event("aten::mm", 1.0, 2.0, launched=10.0),
              _event("aten::mm", 91.0, 92.0, launched=10.0),
              _event("worker.stage", 20.0, 70.0, thread=2),
              _event("aten::copy_", 21.0, 22.0, thread=2),
              _event("gemm", 0.0, 10.0, device=True), _event("gemm", 90.0, 100.0, device=True)]
    brk = P.PerformanceProfiler.device_breakdown(SimpleNamespace(events=lambda: events))
    assert brk["idle_by_span"] == pytest.approx({"main.work": 60e-3, "main.wait": 20e-3})
    assert sum(brk["idle_by_span"].values()) == pytest.approx(brk["window_ms"] - brk["busy_ms"])
    host = [e for e in events if e.device_type == DeviceType.CPU]
    marked = [e for e in host if e.name in P._NAMES]
    assert P.launching_thread(host, marked) == 1
    # with no device work, the thread with the most spans
    assert P.launching_thread(host[4:], marked[2:]) == 2
    assert P.launching_thread(host, []) is None


def test_the_breakdown_of_a_trace_splits_its_idle_time_over_the_spans(tmp_path):
    prof_ = P.PerformanceProfiler()
    with P.span("before"):
        pass
    with _cpu_profile():
        with P.span("stale"):
            pass
    with prof_.trace(str(tmp_path)) as prof:
        with P.span("work"):
            torch.ones(256, 256).sum()
    assert set(P.span_summary()["spans"]) == {"work"}  # cleared when the trace began
    P.clear_spans()  # the trace still names its spans
    brk = P.PerformanceProfiler.device_breakdown(prof)
    idle = brk["idle_by_span"]
    assert idle["work"] > 0
    assert sum(idle.values()) == pytest.approx(brk["window_ms"] - brk["busy_ms"], rel=1e-9)


def test_the_ring_keeps_the_newest_spans(monkeypatch):
    assert P._SPANS.maxlen == P.SPAN_RING == 1 << 16
    monkeypatch.setattr(P, "_SPANS", collections.deque(maxlen=4))
    with _cpu_profile():
        for i in range(6):
            with P.span(f"s{i}"):
                pass
    assert _kept() == ["s2", "s3", "s4", "s5"]
