"""Run one cell of the port's benchmark once and print its result line.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds `BENCHMARK.json`. The run makes its
weights and inputs from the seed, builds the port's path for the cell and
warms every shape it will use (set-up, `setup_s`), measures for
`--seconds` (with `--trace 1` the last `trace_seconds` of the traffic mix
under `torch.profiler`), reads the peak device memory, frees the
program's state, judges what the window produced against the plain
reference, and prints one JSON line: `correct`, `attempted`, `failed`,
`metrics`, `device`, with `--trace 1` `breakdown`, and last `checks`,
each compared number beside its limit (also the last lines on standard
error). It exits 3 without enough CUDA devices, 2 where the port cannot
be imported, 4 where JAX or the JAX package was loaded; in each case it
prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import List, Optional  # noqa: E402


def _cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    cache = root / ".bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(args: argparse.Namespace, root: Path, device: str = "cuda",
            bench_dir: Optional[Path] = None) -> int:
    """The run, on `device`; the CPU only from the harness's own tests,
    which skip the look for a chip."""
    from port_bench import harness

    bench_dir = harness.BENCH_DIR if bench_dir is None else bench_dir
    bench = harness.benchmark(root)
    cell = harness.cell_of(bench, args.workload)
    traffic = harness.traffic_of(cell["traffic"], bench_dir)
    config = harness.config_of(cell["config"], bench_dir)
    limits = harness.load_json(bench_dir / "limits" / f"{args.workload}.json")

    import torch

    if device == "cuda" and (not torch.cuda.is_available()
                             or torch.cuda.device_count() < int(cell["chips"])):
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 3
    try:
        import cabinet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"the port cannot be imported from {root}: {e}", file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, os.cpu_count() or 1))  # load from few threads

    from port_bench.loops.base import Context
    from port_bench.trace import Tracer
    from port_bench.work import peaks_of

    cuda = device == "cuda"
    with tempfile.TemporaryDirectory(prefix="port_bench_") as tmp:
        ctx = Context(args.workload, args.seed, config, traffic, limits,
                      torch.device(device), Path(tmp))
        runner = harness.loop_of(traffic).Loop(ctx)
        if cuda and args.trace:
            _start_profiler_once()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T_START

        tracer = Tracer() if args.trace else None
        t0 = time.perf_counter()
        end = t0 + args.seconds
        if tracer is not None:
            runner.run_until(end - min(float(traffic["trace_seconds"]), args.seconds))
            tracer.start()
        runner.run_until(end)
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
        if tracer is not None:
            tracer.stop()
        peak = torch.cuda.max_memory_allocated() if cuda else 0

        e2e = dict(runner.e2e(window_s))
        e2e.update(setup_s=setup_s, peak_mem_gib=peak / 2 ** 30)
        units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
        name = torch.cuda.get_device_name() if cuda else "cpu"
        device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                       "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
        breakdown = None
        if tracer is None:
            wanted = harness.metrics_of_cell(bench, "end_to_end", args.workload)
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in wanted if m["name"] in e2e}
        else:
            s = tracer.summary
            device_info.update(busy_s=s.busy_s, window_s=s.window_s)
            breakdown = {"device_ops": [[n, v] for n, v in s.device_ops],
                         "idle_gaps": [[n, v] for n, v in s.idle_gaps]}
            layer = LayerContext(s, runner.layer_counters(), peaks_of(name), e2e, window_s)
            metrics = {}
            for m in harness.metrics_of_cell(bench, "per_layer", args.workload):
                value = harness.metric_reader(m["name"], bench_dir)(layer)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": units[m["name"]]}

        attempted = runner.attempted
        runner.release()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        checks = runner.check()
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    found = harness.forbidden_modules()
    if found:
        print(f"loaded in the process that prints the result: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(harness.result_line(correct, attempted, 0, metrics, device_info, checks,
                              breakdown), flush=True)
    return 0


def _start_profiler_once() -> None:
    """The profiler's first start sets up CUPTI, which takes seconds: done
    in set-up, so that the traced part of the window holds the work."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class LayerContext:
    """What a per-layer reader gets: the trace summary (or None), the
    runner's counters, the card's peaks, the run's end-to-end values and the
    window's seconds."""

    def __init__(self, trace, counters, peaks, e2e, window_s):
        self.trace, self.counters, self.peaks = trace, counters, peaks
        self.e2e, self.window_s = e2e, window_s


def main(argv: Optional[List[str]] = None) -> int:
    root = Path.cwd()
    _cache_env(root)
    return execute(parse(argv), root)


if __name__ == "__main__":
    sys.exit(main())
