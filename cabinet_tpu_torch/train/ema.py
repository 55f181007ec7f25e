"""Exponential moving average of a model's variables (counterpart of
`cabinet_tpu.train.ema`; reference src/utils/ema.py:27-72).

The shadow is a deep copy of the parameters and the BatchNorm buffers. Each
update takes d = decay * (1 - exp(-updates / tau)) in f32 and sets every
float entry to e * d + v * (1 - d), the JAX form (`torch.lerp` rounds
otherwise); integer buffers (`num_batches_tracked`) are left as they were.
The trainer updates it once per real optimizer step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


class ModelEMA:
    def __init__(self, model: nn.Module, decay: float = 0.9999, tau: float = 2000.0):
        self.decay = float(decay)
        self.tau = float(tau)
        self.updates = 0
        self.shadow: Dict[str, torch.Tensor] = {
            k: v.detach().clone() for k, v in model.state_dict().items()}
        self._names = [k for k, v in self.shadow.items() if v.is_floating_point()]

    def factor(self) -> np.float32:
        """d for the update count now, in f32."""
        f32 = np.float32
        return f32(self.decay) * (f32(1.0) - np.exp(-f32(self.updates) / f32(self.tau)))

    @torch.no_grad()
    def update(self, model: nn.Module) -> None:
        self.updates += 1
        d = self.factor()
        live = model.state_dict()
        shadow = [self.shadow[k] for k in self._names]
        torch._foreach_mul_(shadow, float(d))
        torch._foreach_add_(shadow, torch._foreach_mul(
            [live[k].detach() for k in self._names], float(np.float32(1.0) - d)))

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The shadow, as a state dict of the model."""
        return self.shadow

    def load_state_dict(self, shadow: Dict[str, torch.Tensor], updates: int) -> None:
        for k, v in shadow.items():
            self.shadow[k].copy_(v)
        self.updates = int(updates)
