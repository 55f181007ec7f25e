"""Fused MobileNetV3 stem + block_0 (kernel K4), its plain version and the
BN fold.

Counterpart of `cabinet_tpu/ops/early_stage.py`: with BN folded into the
weights,

    stem conv 3x3 s2 (3->16) -> hardswish
    -> dw 3x3 (16) -> relu -> pw 1x1 (16->16) -> + stem

on an input rounded to bf16 (the Pallas wrapper packs it so), written as
planes (B, 16, H/2, W/2), which is the port's NCHW: `mobile.tail` takes them
as they are. The planes lie in channels-last memory (the strides of
(B, H/2, W/2, 16)), the layout of the rest of the network, whose NHWC input
permuted to NCHW is channels-last too. The CUDA kernel is
`csrc/early_stage.cu`; see its header for the design. The Pallas kernel's
parity-plane packing, row bands and W/2 % 128 rule are Mosaic's and have no
counterpart here: any even H and W work.

Layouts are the JAX package's at the public functions: x is NHWC
(B, H, W, 3); wstem (16, 27) [co, ci*9 + i*3 + j], wdw (3, 3, 16),
wpw (16 out, 16 in).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from cabinet_tpu_torch.models.layers import hard_swish
from cabinet_tpu_torch.ops import _build

C = 16  # stem and block_0 width (MobileNetV3-Large)

Folded = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
               torch.Tensor, torch.Tensor]


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """(mult, add) with x*mult + add == BN(x) in eval mode."""
    s = scale / torch.sqrt(var + eps)
    return s, bias - mean * s


@torch.no_grad()
def fold_stem_block0_params(mobile) -> Folded:
    """Fold BN into the stem and block_0 weights of a MobileNetV3
    (`mobile.features.0` and `.1`), in f32: (wstem, bstem, wdw, bdw, wpw,
    bpw) in the JAX package's layouts."""
    stem_conv, stem_bn = mobile.features[0][0], mobile.features[0][1]
    blk = mobile.features[1].conv
    dw_conv, dw_bn, pw_conv, pw_bn = blk[0], blk[1], blk[4], blk[5]

    def bn_of(bn):
        return fold_bn(bn.weight.float(), bn.bias.float(),
                       bn.running_mean.float(), bn.running_var.float(), bn.eps)

    s1, b1 = bn_of(stem_bn)
    wstem = (stem_conv.weight.float() * s1[:, None, None, None]).reshape(C, 27)
    s2, b2 = bn_of(dw_bn)
    wdw = (dw_conv.weight.float()[:, 0] * s2[:, None, None]).permute(1, 2, 0)
    s3, b3 = bn_of(pw_bn)
    wpw = pw_conv.weight.float()[:, :, 0, 0] * s3[:, None]
    return tuple(t.contiguous() for t in (wstem, b1, wdw, b2, wpw, b3))


def _stem_block0_planes(x, wstem, bstem, wdw, bdw, wpw, bpw) -> torch.Tensor:
    """The folded sub-graph in f32 on NHWC x -> planes (B, 16, H/2, W/2)."""
    xc = x.float().permute(0, 3, 1, 2)
    stem = F.conv2d(xc, wstem.float().reshape(C, 3, 3, 3), stride=2, padding=1)
    stem = hard_swish(stem + bstem.float()[:, None, None])
    dw = F.conv2d(stem, wdw.float().permute(2, 0, 1)[:, None], padding=1,
                  groups=C)
    dw = torch.relu(dw + bdw.float()[:, None, None])
    pw = torch.einsum("bchw,oc->bohw", dw, wpw.float())
    return pw + bpw.float()[:, None, None] + stem


def stem_block0_reference(x, wstem, bstem, wdw, bdw, wpw, bpw) -> torch.Tensor:
    """The plain f32 graph on the given input, NHWC out (B, H/2, W/2, 16),
    as the JAX `stem_block0_reference`."""
    return _stem_block0_planes(x, wstem, bstem, wdw, bdw, wpw,
                               bpw).permute(0, 2, 3, 1)


def stem_block0_plain(x, wstem, bstem, wdw, bdw, wpw, bpw,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain version of K4: x rounded to bf16 (as the Pallas wrapper packs
    it), the f32 graph, planes (B, 16, H/2, W/2) in `out_dtype`, in
    channels-last memory as the kernel writes them."""
    xq = x.to(torch.bfloat16)
    planes = _stem_block0_planes(xq, wstem, bstem, wdw, bdw, wpw, bpw)
    return planes.to(out_dtype).contiguous(memory_format=torch.channels_last)


def _check(name, t, shape, dtypes, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name} must start on a 16-byte boundary")


# Where each folded weight starts in the packed buffer that K4 copies to
# its constant block (W_STEM, B_STEM, ... in csrc/early_stage.cu), each
# flattened row-major in the layout of `fold_stem_block0_params`.
PACKED_OFFSETS = {"wstem": 0, "bstem": 432, "wdw": 448, "bdw": 592,
                  "wpw": 608, "bpw": 864}
N_PACKED = 880


def pack_stem_block0_weights(wstem, bstem, wdw, bdw, wpw, bpw) -> Folded:
    """The six folded f32 weights copied into one buffer of N_PACKED values,
    each at its PACKED_OFFSETS entry, and returned as views of that buffer
    in their own shapes: `fused_stem_block0` launches from such views as
    they are, and packs any other weights on every call."""
    ws = (wstem, bstem, wdw, bdw, wpw, bpw)
    buf = torch.cat([t.reshape(-1) for t in ws])
    return tuple(buf[o:o + t.numel()].view(t.shape)
                 for t, o in zip(ws, PACKED_OFFSETS.values()))


def is_packed(ws: Folded) -> bool:
    """Whether the six (contiguous) weights lie one after another at their
    PACKED_OFFSETS entries from ws[0]'s start, as the views of
    `pack_stem_block0_weights` do: then the N_PACKED floats there are the
    packed buffer."""
    base = ws[0].data_ptr()
    return all(t.data_ptr() == base + 4 * o
               for t, o in zip(ws, PACKED_OFFSETS.values()))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library with its launcher's signature set, once."""
    lib = _build.load("early_stage")
    fn = lib.cabinet_stem_block0
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


_IO_DTYPES = (torch.float32, torch.bfloat16)


def fused_stem_block0(x: torch.Tensor, wstem: torch.Tensor,
                      bstem: torch.Tensor, wdw: torch.Tensor,
                      bdw: torch.Tensor, wpw: torch.Tensor, bpw: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K4 wrapper: x (B,H,W,3) -> planes (B,16,H/2,W/2) in `out_dtype`, in
    channels-last memory; see `stem_block0_plain` for the function. CPU
    tensors take the plain version. CUDA tensors launch the kernel, which
    takes f32 or bf16 x and out_dtype, even H and W, f32 folded weights,
    all contiguous and 16-byte aligned; anything else raises. The weights
    go to the kernel as one packed buffer: the views that
    `pack_stem_block0_weights` returns are launched from as they are (the
    form `models/fused.py` holds them in), other weights are packed first,
    one more launch. The launcher copies that buffer to the kernel's
    constant block on the same stream. The constant block is one for the
    process: this wrapper must not run on two streams at once with
    different weights, or one launch may read the other's."""
    if x.device.type == "cpu":
        return stem_block0_plain(x, wstem, bstem, wdw, bdw, wpw, bpw, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_stem_block0: unsupported device {x.device}")
    if x.dim() != 4 or x.shape[-1] != 3:
        raise ValueError(f"x must be (B,H,W,3) NHWC, got {tuple(x.shape)}")
    B, H, W, _ = x.shape
    if H % 2 or W % 2 or H == 0 or W == 0:
        raise ValueError(f"the stem+block_0 kernel takes even H and W, got {H}x{W}")
    if out_dtype not in _IO_DTYPES:
        raise ValueError(f"out_dtype must be one of {_IO_DTYPES}, got {out_dtype}")
    dev, f32 = x.device, (torch.float32,)
    _check("x", x, (B, H, W, 3), _IO_DTYPES, dev)
    for name, t, shape in (("wstem", wstem, (C, 27)), ("bstem", bstem, (C,)),
                           ("wdw", wdw, (3, 3, C)), ("bdw", bdw, (C,)),
                           ("wpw", wpw, (C, C)), ("bpw", bpw, (C,))):
        _check(name, t, shape, f32, dev)
    out = torch.empty((B, H // 2, W // 2, C), dtype=out_dtype,
                      device=dev).permute(0, 3, 1, 2)
    ws = (wstem, bstem, wdw, bdw, wpw, bpw)
    packed = ws[0] if is_packed(ws) else pack_stem_block0_weights(*ws)[0]
    rc = _lib().cabinet_stem_block0(
        x.data_ptr(), packed.data_ptr(), out.data_ptr(),
        B, H, W, int(x.dtype == torch.bfloat16),
        int(out_dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check_launch(rc, "stem_block0")
    fused_stem_block0.launches += 1
    return out


fused_stem_block0.launches = 0
