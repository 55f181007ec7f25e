"""The port's PerformanceProfiler (cabinet_tpu_torch.utils.profiler) on the
CPU against the JAX package's on a small CABiNet (the truncated cfg table
of tests/conftest.py): the result keys of every method equal JAX's, the
parameter count equals JAX's `count_parameters`, the FLOPs equal an
analytic count of the convolutions, the dense layers and the attention's
two products (2 per multiply-add), the kernels' analytic counts are what
the wrappers add, and `trace` writes a trace file."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cabinet_tpu.utils.profiler import PerformanceProfiler as JProfiler
from cabinet_tpu_torch.models import cab
from cabinet_tpu_torch.utils.profiler import PerformanceProfiler
from torch_port_utils import port_model

CFGS = [[3, 1, 16, 1, 0, 2], [3, 4.5, 24, 0, 0, 2], [5, 4, 40, 1, 1, 2], [5, 6, 96, 1, 1, 2]]
B, S = 2, 64


@pytest.fixture(scope="module")
def models(small_cabinet):
    jm, v = small_cabinet
    return jm, v, port_model(v, 8, "small", CFGS)


def _fwd(model, x):
    return model(x.permute(0, 3, 1, 2))


def test_result_keys_and_params_equal_jax(models):
    jm, v, model = models
    x = np.random.default_rng(0).standard_normal((B, S, S, 3)).astype(np.float32)
    ref = JProfiler(warmup=1, repeats=1, chain=2).run_full_benchmark(
        lambda var, img: jm.apply(var, img, train=False), v, jnp.asarray(x))
    got = PerformanceProfiler(warmup=1, repeats=2, chain=2).run_full_benchmark(
        _fwd, model, torch.from_numpy(x))
    assert list(got) == list(ref)
    for k in ref:
        assert sorted(got[k]) == sorted(ref[k]), k
    assert got["params"] == ref["params"]
    assert got["params"] == PerformanceProfiler.count_parameters(
        {k: t for k, t in model.named_parameters()})
    lat = got["latency"]
    assert 0 < lat["min_ms"] <= lat["median_ms"] <= lat["max_ms"]
    assert lat["fps"] == pytest.approx(B / (lat["mean_ms"] / 1e3))
    mem = got["memory"]
    assert mem["temp_size_mb"] is None  # not measured on the CPU
    assert mem["output_size_mb"] == pytest.approx(2 * B * S * S * 8 * 4 / 1e6)


def test_flops_equal_the_analytic_count(models, monkeypatch):
    """FlopCounterMode's total against the convolutions, the dense layers
    (the SE blocks) and the attention products counted from hooks."""
    _, _, model = models
    counted = []

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            kh, kw = mod.kernel_size
            counted.append(2 * out.numel() * mod.in_channels // mod.groups * kh * kw)
        elif isinstance(mod, torch.nn.Linear):
            counted.append(2 * out.numel() * mod.in_features)

    def attention(q, k, v, inner=cab.ATTENTION["einsum"]):
        n, d = q.shape[1], q.shape[2] + v.shape[2]
        counted.append(2 * q.shape[0] * n * k.shape[1] * d)
        return inner(q, k, v)

    monkeypatch.setitem(cab.ATTENTION, "einsum", attention)
    handles = [m.register_forward_hook(hook) for m in model.modules()]
    try:
        prof = PerformanceProfiler()
        got = prof.profile_model_flops(_fwd, model, torch.zeros(B, S, S, 3))
    finally:
        for h in handles:
            h.remove()
    assert got["flops"] == sum(counted) and got["flops"] > 0
    assert got["gflops"] == got["flops"] / 1e9 and np.isnan(got["bytes_accessed"])
    assert prof.last_kernel_flops == {}  # the plain route: no kernel launched


def test_kernel_flops_are_the_plain_versions_counts():
    """Each wrapper's analytic count equals what FlopCounterMode counts
    for its plain version on the same shapes."""
    from torch.utils.flop_counter import FlopCounterMode

    from cabinet_tpu_torch.ops import _build
    from cabinet_tpu_torch.ops.attention import global_attention_plain
    from cabinet_tpu_torch.ops.decoder_tail import (
        C_CP, C_MID, C_SP, ffm_pointwise_plain, head_conv3x3_plain)
    from cabinet_tpu_torch.ops.early_stage import C, stem_block0_plain

    b, n, kd, h, w, nc = 2, 16, 32, 8, 8, 5
    cases = [
        (lambda: global_attention_plain(*(torch.zeros(b, n, kd) for _ in range(3))),
         2 * b * n * n * (kd + kd)),
        (lambda: ffm_pointwise_plain(torch.zeros(b, h, w, C_SP), torch.zeros(b, h, w, C_CP),
                                     torch.zeros(C_SP, C_MID), torch.zeros(C_CP, C_MID),
                                     torch.zeros(C_MID)),
         2 * b * h * w * (C_SP + C_CP) * C_MID),
        (lambda: head_conv3x3_plain(torch.zeros(b, h, w, C_MID), torch.zeros(b, C_MID),
                                    torch.zeros(9, C_MID, C_MID), torch.zeros(C_MID),
                                    torch.zeros(C_MID, 16), nc),
         2 * b * h * w * C_MID * (9 * C_MID + nc)),
        (lambda: stem_block0_plain(torch.zeros(b, 2 * h, 2 * w, 3), torch.zeros(C, 27),
                                   torch.zeros(C), torch.zeros(3, 3, C), torch.zeros(C),
                                   torch.zeros(C, C), torch.zeros(C)),
         2 * b * h * w * C * (27 + 9 + C)),
    ]
    for fn, analytic in cases:
        with FlopCounterMode(display=False) as counter:
            fn()
        assert counter.get_total_flops() == analytic
    with _build.count_flops() as tally:
        _build.add_flops("attention", 3)
        _build.add_flops("attention", 4)
    _build.add_flops("attention", 5)  # outside: not counted
    assert tally == {"attention": 7}


def test_trace_writes_a_trace(models, tmp_path):
    _, _, model = models
    prof = PerformanceProfiler()
    with torch.no_grad(), prof.trace(str(tmp_path)) as p:
        _fwd(model, torch.zeros(1, S, S, 3))
    path = tmp_path / "trace.pt.trace.json"
    events = json.loads(path.read_text())["traceEvents"]
    assert any("conv" in str(e.get("name", "")) for e in events)
    brk = PerformanceProfiler.device_breakdown(p)
    assert brk["device_ops"] == 0 and brk["busy_share"] is None and brk["window_ms"] > 0
