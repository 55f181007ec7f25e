"""A tiny copy of the benchmark for the CPU: the real cells' files with the
sizes cut so that a run takes seconds, in a directory of their own."""

from __future__ import annotations

import contextlib
import io
import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

from port_bench import harness

ROOT = harness.BENCH_DIR.parent

# Per traffic mix, the parameters that shrink it; per configuration too.
TINY_TRAFFIC = {
    "serve-b16-1080p": {"batch": 2, "frame_hw": [256, 256], "pool": 4, "warmup_batches": 1,
                       "check_frames": 2, "trace_seconds": 0},
    "train-b32-deviceaug": {"batch": 2, "pool": 4, "frame_hw": [128, 256],
                            "trace_seconds": 0},
    "eval-msc6-flip": {"frames": 2, "frame_hw": [256, 512], "scales": [0.75, 1.25],
                       "trace_seconds": 0},
}
TINY_CONFIG = {
    "cabinet-large-uavid": {"imgsz": 256, "frame_hw": [256, 256]},
    "cabinet-large-cityscapes": {"crop": 128},
}


def make(tmp: Path, limits: Optional[Dict[str, Dict[str, float]]] = None,
         f32: bool = False) -> Path:
    """`tmp` holding BENCHMARK.json and a bench directory of tiny files;
    returns the bench directory. `limits` overrides a cell's limits; `f32`
    runs the program in float32, where only a fault sets it apart from the
    reference."""
    bench = harness.benchmark(ROOT)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    bd = tmp / "bench"
    for sub in ("configs", "traffic", "limits"):
        (bd / sub).mkdir(parents=True, exist_ok=True)
    shutil.copytree(harness.BENCH_DIR / "metrics", bd / "metrics", dirs_exist_ok=True)
    for c in bench["configs"]:
        cfg = harness.config_of(c["name"])
        cfg.update(TINY_CONFIG.get(c["name"], {}))
        if f32:
            cfg["dtype"] = "float32"
            if "train" in cfg:
                cfg["train"] = dict(cfg["train"], compute_dtype="float32")
            if "eval" in cfg:
                cfg["eval"] = {"overrides": cfg["eval"]["overrides"]
                               + ["runtime.compute_dtype=float32"]}
        (bd / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        tr = harness.traffic_of(w["traffic"])
        tr.update(TINY_TRAFFIC.get(w["traffic"], {}))
        (bd / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tr))
        lim = harness.load_json(harness.BENCH_DIR / "limits" / f"{w['name']}.json")
        lim.update((limits or {}).get(w["name"], {}))
        (bd / "limits" / f"{w['name']}.json").write_text(json.dumps(lim))
    return bd


def run(tmp: Path, workload: str, seed: int = 7, seconds: float = 1.0, trace: int = 0,
        limits: Optional[Dict[str, Dict[str, float]]] = None, f32: bool = False
        ) -> Dict[str, Any]:
    """One tiny run on the CPU; its result line, parsed."""
    from port_bench import run as runner

    bd = make(tmp, limits, f32)
    args = runner.parse(["--workload", workload, "--seed", str(seed),
                         "--seconds", str(seconds), "--trace", str(trace)])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = runner.execute(args, tmp, device="cpu", bench_dir=bd)
    assert rc == 0, rc
    return json.loads(out.getvalue().strip().splitlines()[-1])
