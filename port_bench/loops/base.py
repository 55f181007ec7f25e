"""What every loop shares: the run's context, and the switch to the
reference's float32 (TF32 off), made only once the window has closed."""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from port_bench.work import Work


@dataclass
class Context:
    workload: str
    seed: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, float]
    device: torch.device
    tmp: Path


@dataclass
class Counters:
    """What a loop hands the per-layer readers."""
    units_per_s: float = 0.0
    model_flops_per_unit: float = 0.0
    kernel_work: Dict[str, Work] = field(default_factory=dict)
    batch_s: List[float] = field(default_factory=list)
    aug_ms: List[float] = field(default_factory=list)
    loop_s: float = 0.0
    loader_wait_s: float = 0.0


def reference_precision() -> None:
    """float32 products and convolutions, without TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def lowp_forward(lowp: Optional[str], device):
    """The context the reference's forward runs in: bf16 autocast for
    "bf16", the precision the configurations state, and for "fp8", the
    control one step below it, whose products also take float8 operands
    (`reference/model.py:set_fp8`, set on the model); float32 for None."""
    import contextlib

    if lowp in ("bf16", "fp8"):
        return torch.autocast(torch.device(device).type, dtype=torch.bfloat16)
    return contextlib.nullcontext()


def check(value: float, limit: float) -> Dict[str, float]:
    return {"value": float(value), "limit": float(limit)}


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    """‖got - ref‖ / ‖ref‖ in float64."""
    return float((got.double() - ref.double()).norm() / ref.double().norm().clamp_min(1e-300))


def sample(seed: int, population: List[int], n: int, salt: int) -> List[int]:
    """`n` of `population` drawn from the seed (sorted), all of them if fewer."""
    rng = np.random.default_rng([int(seed), salt])
    if len(population) <= n:
        return sorted(population)
    return sorted(int(i) for i in rng.choice(population, n, replace=False))


def leaf_gaps(got: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              names: List[str]) -> Dict[str, float]:
    """{leaf: |‖got‖ - ‖ref‖| / max(‖ref‖, the median leaf's ‖ref‖)}: the gap
    between the two norms of each leaf, against the reference's norm of
    that leaf or of the median leaf, whichever is larger."""
    g = [float(got[n].double().norm()) for n in names]
    r = [float(ref[n].double().norm()) for n in names]
    med = float(np.median(r)) if r else 0.0
    return {n: abs(a - b) / max(b, med, 1e-30) for n, a, b in zip(names, g, r)}
