"""The control of a cell's correctness check: the plain reference put in
the program's place in float8 (`reference/model.py:set_fp8`), one step
below the bfloat16 that the configurations state, judged by the same
comparison as the program. Its readings set the upper end of each limit
(see PERF.md); the benchmark's runs never run it.

    python3 -m port_bench.control --workload <name> --seeds <n> [<n> ...]

prints, for each seed, one JSON line {"seed", "control": checks}, each
check's value beside the cell's limit. With `--fault <name>` it runs the
program instead, for a short window, with that fault of `faults.py`
planted underneath, and prints its checks under "fault". It needs a CUDA
device.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import List, Optional


def control_readings(workload: str, seed: int, root: Path, device: str = "cuda",
                     bench_dir: Optional[Path] = None, lowp: str = "fp8",
                     fault: Optional[str] = None, seconds: float = 2.0) -> dict:
    import torch

    from port_bench import harness
    from port_bench.loops.base import Context
    from port_bench.faults import planted

    bench_dir = harness.BENCH_DIR if bench_dir is None else bench_dir
    cell = harness.cell_of(harness.benchmark(root), workload)
    traffic = harness.traffic_of(cell["traffic"], bench_dir)
    ctx_args = (harness.config_of(cell["config"], bench_dir), traffic,
                harness.load_json(bench_dir / "limits" / f"{workload}.json"))
    with tempfile.TemporaryDirectory(prefix="port_bench_") as tmp, \
            (planted(fault) if fault else contextlib.nullcontext()):
        runner = harness.loop_of(traffic).Loop(
            Context(workload, seed, *ctx_args, torch.device(device), Path(tmp)))
        if fault:
            runner.run_until(time.perf_counter() + seconds)
        runner.release()
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
        return runner.check() if fault else runner.control(lowp)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--lowp", choices=("fp8", "bf16"), default="fp8",
                   help="the control's precision; bf16 reads what bfloat16 arithmetic "
                        "alone gives, beside the program's readings")
    p.add_argument("--fault", default=None, help="a fault of port_bench/faults.py")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control needs a CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        out = control_readings(args.workload, seed, Path.cwd(), lowp=args.lowp,
                               fault=args.fault)
        key = {"fault": args.fault} if args.fault else {"lowp": args.lowp}
        print(json.dumps({"seed": seed, **key, "checks": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
