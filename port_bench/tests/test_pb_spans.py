"""The readers of the port's spans (`metrics/stage_ms.py`, `forward_ms.py`,
`resize_ms.py`, `accumulate_ms.py`) on a recorder filled by hand: the ms
they give, and nothing from an empty recorder or a port without one."""

import collections

import pytest

from cabinet_tpu_torch.utils import profiler as P
from port_bench import harness


@pytest.fixture
def recorder(monkeypatch):
    """The port's store, empty, and a function that adds a span to it:
    device seconds as a pair of host-clock marks, host seconds from its
    start and end."""
    monkeypatch.setattr(P, "_SPANS", collections.deque(maxlen=P.SPAN_RING))
    monkeypatch.setattr(P, "_COUNTS", {})

    def add(name, host_s=0.0, device_s=None):
        marks = None if device_s is None else (0.0, device_s)
        P._SPANS.append(P.SpanRecord(name, 0, int(host_s * 1e9), marks))

    return add


def read(name):
    return harness.metric_reader(name)(None)


NAMES = ("stage_ms.serve", "forward_ms.serve", "forward_ms.eval", "resize_ms.eval",
         "accumulate_ms.eval")


def test_serving_readers(recorder):
    for _ in range(4):
        recorder("serve.call", host_s=0.040)
        recorder("serve.stage", host_s=0.015)
        recorder("serve.forward", host_s=0.001, device_s=0.020)
    P._COUNTS.update({"serve.frames": 64})
    assert read("stage_ms.serve") == pytest.approx(15.0)
    assert read("forward_ms.serve") == pytest.approx(4 * 20.0 / 64)
    for name in ("resize_ms.eval", "accumulate_ms.eval"):
        assert read(name) is None


def test_evaluation_readers(recorder):
    for _ in range(30):
        recorder("eval.forward", device_s=0.010)
        recorder("eval.accumulate", device_s=0.002)
    for _ in range(12):
        recorder("eval.resize", device_s=0.0005)
    P._COUNTS.update({"eval.frames": 4})
    assert read("forward_ms.eval") == pytest.approx(30 * 10.0 / 4)
    assert read("resize_ms.eval") == pytest.approx(12 * 0.5 / 4)
    assert read("accumulate_ms.eval") == pytest.approx(30 * 2.0 / 4)
    assert read("stage_ms.serve") is None


def test_an_empty_recorder_or_a_port_without_one_gives_nothing(recorder, monkeypatch):
    for name in NAMES:
        assert read(name) is None
    recorder("eval.forward", device_s=0.010)  # a span, but no frames counted
    assert read("forward_ms.eval") is None
    P._COUNTS["eval.frames"] = 2
    assert read("forward_ms.eval") == pytest.approx(5.0)
    monkeypatch.delattr(P, "span_summary")
    for name in NAMES:
        assert read(name) is None
