"""Logging (counterpart of `setup_logger` of `cabinet_tpu.core.logging`;
reference src/utils/logger.py:17-119).

`setup_logger` gives a logger that writes timestamped lines to stderr and,
on the primary process, to `run-<time>.log` under `logpth`. The primary
process is rank 0 of torch.distributed's process group once one exists
(multi-process training, `core/mesh.py`), and the only process without
one. No rich: the CLI prints plain text.
"""

from __future__ import annotations

import logging
import sys
import time
from pathlib import Path
from typing import Optional


def is_primary_process() -> bool:
    """True on rank 0 of an initialised torch.distributed group, and
    always without one."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return dist.get_rank() == 0
    except ImportError:  # pragma: no cover - torch without distributed
        pass
    return True


def setup_logger(name: str = "cabinet_tpu_torch", logpth: Optional[str] = None,
                 level: int = logging.INFO) -> logging.Logger:
    """File and stream logger; other processes than the primary log ERROR
    only and write no file."""
    logger = logging.getLogger(name)
    logger.setLevel(level if is_primary_process() else logging.ERROR)
    if logger.handlers:
        return logger
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(name)s: %(message)s")
    stream = logging.StreamHandler(sys.stderr)
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    if logpth is not None and is_primary_process():
        logdir = Path(logpth)
        logdir.mkdir(parents=True, exist_ok=True)
        fh = logging.FileHandler(logdir / time.strftime("run-%Y-%m-%d-%H-%M-%S.log"))
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    return logger
