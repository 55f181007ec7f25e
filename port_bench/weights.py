"""Seeded weights for CABiNet, made on the device in one draw.

The same state dict goes to the program and to the reference. Every
floating entry is cut from one standard-normal draw of a `torch.Generator`
on `device`, seeded from the run's seed, and scaled by the kind of entry:
convolution and linear weights by sqrt(2 / fan_in) (He), biases by 0.01,
BatchNorm scales near 1 and shifts near 0, and the context block's `gamma` near 0.5, so that the global attention
(zero at the published initialisation) weighs in the output and its
kernel is judged. As a trained network keeps its residual branches and
its attention logits small, the last BatchNorm scale of each residual
block and the query's and key's BatchNorm scales are cut to 0.3 of that
(`BRANCH_GAIN`): drawn all near 1, the random trunk grows its activations
60-fold and amplifies bfloat16 round-off to 10-20% of the logits, which
would leave no room between the program's round-off and a lower
precision's. The BatchNorm running statistics are then those of one
train-mode forward of the reference over a seeded batch, so that the
eval-mode forward keeps unit-scale activations, as a trained model's does.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch

from port_bench.reference.model import LARGE_CFGS, CABiNet, InvertedResidual, state_shapes

BRANCH_GAIN = 0.3


def torch_seed(seed: int) -> int:
    """A run's seed as a torch Generator takes it (a non-negative 63-bit
    integer); numpy's Generators take the seed itself."""
    return int(seed) % (2 ** 63)


def make_state_dict(n_classes: int, seed: int, device, cfgs: Sequence = LARGE_CFGS,
                    calib_hw: int = 256) -> Dict[str, torch.Tensor]:
    shapes = state_shapes(n_classes, cfgs)
    bn_names = {k[: -len(".running_mean")] for k in shapes if k.endswith(".running_mean")}
    small = _branch_scales(n_classes, cfgs)
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed))
    total = sum(math.prod(s) for s, d in shapes.values() if d.is_floating_point)
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, off = {}, 0
    for key, (shape, dtype) in shapes.items():
        if not dtype.is_floating_point:
            out[key] = torch.zeros(shape, dtype=dtype, device=device)
            continue
        n = math.prod(shape)
        v = z[off:off + n].view(shape)
        off += n
        owner, _, leaf = key.rpartition(".")
        if owner in bn_names:
            v = {"weight": 1.0 + 0.1 * v, "bias": 0.1 * v, "running_mean": 0.1 * v,
                 "running_var": 1.0 + 0.1 * v.abs()}[leaf]
            if key in small:
                v = v * BRANCH_GAIN
        elif leaf == "gamma":
            v = 0.5 + 0.1 * v
        elif leaf == "bias":
            v = 0.01 * v
        else:
            v = v * math.sqrt(2.0 / max(1, math.prod(shape[1:])))
        out[key] = v.contiguous()
    return _calibrated(out, n_classes, cfgs, gen, calib_hw)


def _branch_scales(n_classes: int, cfgs) -> set:
    """The BatchNorm scales cut to BRANCH_GAIN: each residual block's last,
    and the global attention's query and key."""
    with torch.device("meta"):
        model = CABiNet(n_classes, cfgs)
    keys = {f"{name}.conv.{len(m.conv) - 1}.weight" for name, m in model.named_modules()
            if isinstance(m, InvertedResidual) and m.identity}
    return keys | {"ab.a2block.global_attn.to_query.1.weight",
                   "ab.a2block.global_attn.to_key.1.weight"}


@torch.no_grad()
def _calibrated(sd: Dict[str, torch.Tensor], n_classes: int, cfgs, gen: torch.Generator,
                hw: int) -> Dict[str, torch.Tensor]:
    """`sd` with the running statistics of one train-mode forward of the
    reference over two seeded (hw, hw) images."""
    device = gen.device
    model = CABiNet(n_classes, cfgs).to(device)
    model.load_state_dict(sd)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.momentum = None  # the batch's statistics, not a blend
            m.reset_running_stats()
    model.train()
    model(torch.randn((2, 3, hw, hw), generator=gen, device=device))
    return {k: v.detach().clone() for k, v in model.state_dict().items()}
