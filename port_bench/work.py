"""The benchmark's frozen yardstick: the card's peak rates, the work of the
port's hand-written kernels computed from their shapes, and the model
FLOPs of a forward counted on the reference.

Each kernel's work is what the algorithm needs for one launch, the same
whatever implements it: each input byte read once, each output byte
written once, 2 FLOPs a multiply-add. A launch's bound is the largest of
its bytes over the memory rate, its tensor-core operations over the bf16
rate and its FMA-unit operations over the f32 rate.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

# Dense peaks by a fragment of `torch.cuda.get_device_name()` (NVIDIA H100
# SXM data sheet, at its 700 W limit): bf16 tensor FLOP/s, f32 FLOP/s
# outside the tensor cores, memory bytes/s.
PEAKS = {"H100": (989e12, 67e12, 3.35e12)}


@dataclass(frozen=True)
class Peaks:
    bf16: float
    f32: float
    bw: float


def peaks_of(device_name: str) -> Optional[Peaks]:
    for frag, (bf16, f32, bw) in PEAKS.items():
        if frag in device_name:
            return Peaks(bf16, f32, bw)
    return None


@dataclass(frozen=True)
class Work:
    """One launch's work: operations on the tensor cores, operations on the
    FMA units, bytes moved."""
    tensor_flops: float = 0.0
    f32_flops: float = 0.0
    bytes: float = 0.0

    def bound_s(self, p: Peaks) -> float:
        return max(self.bytes / p.bw, self.tensor_flops / p.bf16, self.f32_flops / p.f32)

    def scaled(self, k: float) -> "Work":
        return Work(self.tensor_flops * k, self.f32_flops * k, self.bytes * k)


def k1_attention(B: int, N: int, K: int, V: int, elem: int = 2) -> Work:
    """K1, softmax(q k^T) v over N tokens in bf16 (elem 2): q, k, v read,
    the context written."""
    return Work(tensor_flops=2.0 * B * N * N * (K + V),
                bytes=float(B * N * (2 * K + 2 * V) * elem))


def k2_ffm_pointwise(P: int, tiles: int, c_sp: int = 128, c_cp: int = 256,
                     c_mid: int = 256) -> Work:
    """K2 over P pixels: fsp and fcp read and feat written in bf16, the f32
    sums of `tiles` pixel tiles written, the weights read once."""
    return Work(tensor_flops=2.0 * P * (c_sp + c_cp) * c_mid,
                bytes=float(P * (c_sp + c_cp + c_mid) * 2 + tiles * c_mid * 4
                            + (c_sp + c_cp) * c_mid * 2 + c_mid * 4))


def k3_head(P: int, B: int, n_classes: int, c_mid: int = 256) -> Work:
    """K3 over P pixels: the scaled 3x3 conv 256->256 and the 1x1
    classifier; feat read and logits written in bf16, the weights once."""
    return Work(tensor_flops=2.0 * P * c_mid * (9 * c_mid + n_classes),
                bytes=float(P * (c_mid + n_classes) * 2 + B * c_mid * 4
                            + (9 * c_mid * c_mid + c_mid * n_classes) * 2 + c_mid * 4))


def k4_stem_block0(B: int, H: int, W: int, in_elem: int = 2, out_elem: int = 2,
                   c: int = 16) -> Work:
    """K4 over a (B, H, W, 3) input: the 3x3 s2 stem as three bf16 parts of
    each f32 weight on the tensor cores, the depthwise 3x3 and the
    pointwise 16x16 as f32 FMAs; the input read, the planes written."""
    n_out = B * (H // 2) * (W // 2)
    return Work(tensor_flops=3.0 * 2 * n_out * c * 27,
                f32_flops=2.0 * n_out * (c * 9 + c * c),
                bytes=float(B * H * W * 3 * in_elem + c * n_out * out_elem + 880 * 4))


# The trace names of the port's kernels: a launch of each kernel is one
# of its first names; the second (K1's merge of its key splits) adds to its
# device time but is the same launch.
KERNEL_NAMES = {"K1": (("attention_kernel", "attention_f32_kernel"),
                       ("attention_combine_kernel",)),
                "K2": (("ffm_pointwise_kernel",), ()),
                "K3": (("head_conv3x3_kernel",), ()),
                "K4": (("stem_block0_kernel",), ())}


def kernel_of(trace_name: str):
    """(kernel, whether the event is a launch of it), or (None, False)."""
    for kernel, (launch, extra) in KERNEL_NAMES.items():
        if any(n in trace_name for n in launch):
            return kernel, True
        if any(n in trace_name for n in extra):
            return kernel, False
    return None, False


def forward_flops(n_classes: int, batch: int, h: int, w: int) -> float:
    """Model FLOPs of one forward of the reference at (batch, 3, h, w): the
    products and convolutions `FlopCounterMode` counts, on meta tensors."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from port_bench.reference.model import CABiNet

    with torch.device("meta"):
        model = CABiNet(n_classes).eval()
        x = torch.empty((batch, 3, h, w))
        with FlopCounterMode(display=False) as counter, torch.no_grad():
            model(x)
    return float(counter.get_total_flops())


def roofline_share(launches: Dict[str, int], device_s: Dict[str, float],
                   work: Dict[str, Work], p: Peaks) -> Optional[float]:
    """100 x the kernels' summed bound time over their summed device time,
    over the kernels that launched; None when none did."""
    ran = [k for k in work if launches.get(k, 0) > 0 and device_s.get(k, 0.0) > 0.0]
    if not ran:
        return None
    bound = sum(launches[k] * work[k].bound_s(p) for k in ran)
    return 100.0 * bound / sum(device_s[k] for k in ran)
