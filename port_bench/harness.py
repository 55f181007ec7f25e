"""The benchmark's registry and its result line.

Everything a cell needs is found by name, so that a later change adds a
cell, a configuration, a traffic mix or a per-layer metric by adding files
and entries, never by editing one:

  - a cell is an entry of `workloads` in `BENCHMARK.json`;
  - its configuration is `port_bench/configs/<config>.json`;
  - its traffic mix is `port_bench/traffic/<traffic>.json`, whose `loop`
    names the general loop (`port_bench/loops/<loop>.py`) that reads
    the mix's parameters;
  - a per-layer metric `<name>` is read by `port_bench/metrics/<name>.py`,
    or, where the name is a quantity split by cell (`device_idle.train`),
    by `port_bench/metrics/<part before the first dot>.py`; each reader
    defines `read(ctx) -> float | None`.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cabinet_tpu")


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


def cell_of(bench: Dict[str, Any], workload: str) -> Dict[str, Any]:
    for w in bench["workloads"]:
        if w["name"] == workload:
            return w
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    return load_json(bench_dir / "configs" / f"{name}.json")


def traffic_of(name: str, bench_dir: Path = BENCH_DIR) -> Dict[str, Any]:
    return load_json(bench_dir / "traffic" / f"{name}.json")


def loop_of(traffic: Dict[str, Any]):
    """The loop module a traffic mix names."""
    return importlib.import_module(f"port_bench.loops.{traffic['loop']}")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable[[Any], Optional[float]]:
    for stem in (name, name.split(".")[0]):
        path = bench_dir / "metrics" / f"{stem}.py"
        if path.is_file():
            spec = importlib.util.spec_from_file_location(
                f"port_bench.metrics.{stem.replace('.', '_')}", path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            return mod.read
    raise KeyError(f"no reader for metric {name!r} under {bench_dir / 'metrics'}")


def metrics_of_cell(bench: Dict[str, Any], section: str, workload: str) -> List[Dict]:
    """The cell's metrics of `end_to_end` or `per_layer`: those that list it
    under `workloads`, and those with no such list."""
    return [m for m in bench[section] if workload in m.get("workloads", [workload])]


def forbidden_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one the port's run must not
    load (JAX and the JAX package), compared whole: `cabinet_tpu_torch`
    is not `cabinet_tpu`."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def result_line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Any],
                device: Dict[str, Any], checks: Dict[str, Dict[str, float]],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The contract's last line; `checks` (each compared number beside its
    limit) comes last."""
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)
