"""What the span readers (`metrics/stage_ms.py`, `forward_ms.py`,
`resize_ms.py`, `accumulate_ms.py`) take from the port's own span
recorder (`cabinet_tpu_torch/utils/profiler.py`): its summary after the
traced part, which the run closed with a synchronise. Where the port has
no recorder, or recorded no such span, the readers give nothing."""

from __future__ import annotations

from typing import Any, Dict, Optional


def summary() -> Optional[Dict[str, Any]]:
    """`span_summary()` of the port, or None where it has none."""
    from cabinet_tpu_torch.utils import profiler

    read = getattr(profiler, "span_summary", None)
    return None if read is None else read()


def ms_per(span: str, unit: str, clock: str = "device_s") -> Optional[float]:
    """ms of `span`'s `clock` (`device_s` or `host_s`), summed, over the
    counter `unit`, or over the count of the span `unit` where no counter
    has that name; None where either is missing or zero."""
    s = summary()
    if s is None or span not in s["spans"]:
        return None
    seconds = s["spans"][span][clock]
    n = s["counters"].get(unit, s["spans"].get(unit, {}).get("count", 0))
    if seconds is None or n <= 0:
        return None
    return 1e3 * seconds / n
