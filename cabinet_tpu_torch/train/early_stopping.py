"""Patience-based early stopping (copy of `cabinet_tpu.train.early_stopping`;
reference src/utils/early_stopping.py:17-45)."""

from __future__ import annotations

import math
from typing import Any, Dict, Optional


class EarlyStopping:
    """Stop when fitness (mIoU) hasn't improved for `patience` epochs.

    patience=0 disables stopping; fitness=None epochs are no-ops; a stored
    best of exactly 0.0 counts as "no best yet", so the first real
    measurement always becomes the best."""

    def __init__(self, patience: int = 0) -> None:
        self.best_fitness = 0.0
        self.best_epoch = 0
        self.patience = patience or math.inf

    def __call__(self, epoch: int, fitness: Optional[float]) -> bool:
        if fitness is None:
            return False
        if fitness > self.best_fitness or self.best_fitness == 0:
            self.best_epoch = epoch
            self.best_fitness = fitness
        return (epoch - self.best_epoch) >= self.patience

    def state_dict(self) -> Dict[str, Any]:
        return {"best_fitness": self.best_fitness, "best_epoch": self.best_epoch}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.best_fitness = state["best_fitness"]
        self.best_epoch = state["best_epoch"]
