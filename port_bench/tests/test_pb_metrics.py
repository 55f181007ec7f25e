"""Each per-layer reader's arithmetic on synthetic inputs, and the
yardstick's peaks and work counts."""

import pytest

from port_bench import harness, work
from port_bench.loops.base import Counters, leaf_gaps
from port_bench.trace import TraceSummary, _idle_gaps, _merge

H100 = work.peaks_of("NVIDIA H100 80GB HBM3")


class Ctx:
    def __init__(self, trace=None, counters=None, peaks=H100):
        self.trace, self.counters, self.peaks = trace, counters or Counters(), peaks


def read(name, ctx):
    return harness.metric_reader(name)(ctx)


def test_device_idle_is_the_unbusy_share_of_the_traced_window():
    assert read("device_idle.serve", Ctx(TraceSummary(busy_s=3.0, window_s=4.0))) == 25.0
    assert read("device_idle.train", Ctx(None)) is None
    assert read("device_idle.eval", Ctx(TraceSummary(busy_s=0.0, window_s=4.0))) is None


def test_mfu_is_model_flops_times_rate_over_the_bf16_peak():
    c = Counters(units_per_s=100.0, model_flops_per_unit=9.89e10)
    assert read("mfu.serve", Ctx(counters=c)) == pytest.approx(1.0)
    assert read("mfu.train", Ctx(counters=Counters(units_per_s=0.0))) is None
    assert read("mfu.eval", Ctx(counters=c, peaks=None)) is None


def test_roofline_sums_bound_time_over_device_time():
    w = work.Work(tensor_flops=989e12 * 1e-3)  # 1 ms at the bf16 peak
    t = TraceSummary(kernel_launches={"K1": 4, "K2": 0}, kernel_device_s={"K1": 0.008})
    c = Counters(kernel_work={"K1": w, "K2": w})
    assert read("kernel_roofline.serve", Ctx(t, c)) == pytest.approx(50.0)
    assert read("kernel_roofline.eval", Ctx(TraceSummary(), c)) is None


def test_bound_is_the_largest_of_bytes_and_both_operation_rates():
    p = work.Peaks(bf16=100.0, f32=10.0, bw=1.0)
    assert work.Work(tensor_flops=100, f32_flops=5, bytes=0.5).bound_s(p) == 1.0
    assert work.Work(tensor_flops=100, f32_flops=50, bytes=0.5).bound_s(p) == 5.0
    assert work.Work(bytes=7).bound_s(p) == 7.0


def test_kernel_work_counts():
    k1 = work.k1_attention(8, 1024, 128, 128)
    assert k1.tensor_flops == 2 * 8 * 1024 * 1024 * 256
    assert k1.bytes == 8 * 1024 * 512 * 2
    k3 = work.k3_head(8 * 128 * 128, 8, 8)
    assert k3.tensor_flops == 2 * 8 * 128 * 128 * 256 * (9 * 256 + 8)
    assert work.kernel_of("void attention_kernel<64>(bf16*)") == ("K1", True)
    assert work.kernel_of("attention_combine_kernel<float>") == ("K1", False)
    assert work.kernel_of("head_conv3x3_kernel") == ("K3", True)
    assert work.kernel_of("ampere_sgemm") == (None, False)


def test_p95_is_the_nearest_rank_over_every_call():
    c = Counters(batch_s=[i / 1000 for i in range(1, 101)])
    assert read("batch_ms_p95.serve", Ctx(counters=c)) == pytest.approx(95.0)
    assert read("batch_ms_p95.serve", Ctx(counters=Counters())) is None


def test_augmentation_ms_and_loader_share():
    assert read("device_aug_ms.train", Ctx(counters=Counters(aug_ms=[2.0, 4.0]))) == 3.0
    c = Counters(loop_s=10.0, loader_wait_s=0.5)
    assert read("loader_wait_share.eval", Ctx(counters=c)) == pytest.approx(5.0)
    assert read("loader_wait_share.eval", Ctx(counters=Counters())) is None


def test_idle_gaps_go_to_the_innermost_open_host_op():
    class E:
        def __init__(self, s, e, name):
            self.time_range = type("T", (), {"start": s, "end": e})()
            self.name = name

    busy = _merge([(0, 10), (5, 20), (40, 50), (55, 60)])
    assert busy == [(0, 20), (40, 50), (55, 60)]
    host = [E(0, 100, "outer"), E(15, 45, "aten::conv"), E(52, 53, "late")]
    gaps = dict(_idle_gaps(busy, host))
    assert gaps["aten::conv"] == pytest.approx(20e-6)
    assert gaps["gaps_under_10_us"] == pytest.approx(5e-6)


def test_the_leaf_gap_is_against_the_larger_of_the_leaf_and_the_median():
    import torch

    ref = {"a": torch.ones(4), "b": torch.ones(4) * 3, "c": torch.ones(4) * 1e-6}
    got = {"a": torch.ones(4) * 1.1, "b": torch.ones(4) * 3, "c": torch.ones(4) * 2e-6}
    gaps = leaf_gaps(got, ref, ["a", "b", "c"])
    assert gaps["a"] == pytest.approx(0.1, rel=1e-5)
    assert gaps["b"] == 0.0
    # c's own norm is tiny: its gap is read against the median leaf's (2.0)
    assert gaps["c"] == pytest.approx(2e-6 / 2.0, rel=1e-4)
    assert leaf_gaps(got, ref, []) == {}
