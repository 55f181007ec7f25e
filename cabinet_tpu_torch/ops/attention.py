"""Fused global-context attention (kernel K1) and its plain version.

softmax(q k^T * K^-0.5) v per batch element over all N tokens of the CAB's
/32 feature map, with f32 math, the (N, N) matrix never in device memory.
Replaces the Pallas kernel `cabinet_tpu/ops/attention.py:_attention_kernel`,
which takes any dtype. The CUDA kernels are in `csrc/attention.cu`, one for
bf16 (tensor cores) and one for f32 (f32 FMAs, no TF32); see its header for
the design.

Like the Pallas body, the kernel and its plain version keep the
probabilities in f32 through the value product. The JAX einsum path
(`cabinet_tpu/models/cab.py`, and the Pallas wrapper's off-TPU fallback)
casts them to v's dtype first; in bf16 the two differ by about 1e-2, in f32
they agree to rounding.
"""

from __future__ import annotations

import ctypes

import torch

from cabinet_tpu_torch.ops import _build


def global_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: q,k (B,N,K), v (B,N,V) -> (B,N,V) in v's dtype,
    computed in f32 with f32 probabilities (the Pallas body)."""
    attn = torch.matmul(q.float(), k.float().transpose(1, 2)) * (q.shape[-1] ** -0.5)
    attn = torch.softmax(attn, dim=-1)
    return torch.matmul(attn, v.float()).to(v.dtype)


def _lib() -> ctypes.CDLL:
    lib = _build.load("attention")
    for fn in (lib.cabinet_attention, lib.cabinet_attention_f32):
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


# The kernel launched for each input dtype: (C entry point, launch counter).
_KERNELS = {torch.bfloat16: ("cabinet_attention", "launches"),
            torch.float32: ("cabinet_attention_f32", "launches_f32")}


def fused_global_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T * K^-0.5) v; q,k (B,N,K), v (B,N,V) -> (B,N,V).

    CPU tensors take the plain version. CUDA tensors launch K1: its bf16
    kernel for bf16 inputs (counted in `launches`), its f32 kernel for f32
    inputs (counted in `launches_f32`). Both take contiguous, 16-byte
    aligned tensors of one dtype, K and V multiples of 16 up to 256;
    anything else raises."""
    if q.device.type == "cpu":
        return global_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_global_attention: unsupported device {q.device}")
    if q.dtype not in _KERNELS:
        raise ValueError(f"the attention kernel takes bfloat16 or float32, "
                         f"q is {q.dtype}")
    B, N, K = q.shape
    V = v.shape[-1]
    for name, t, shape in (("q", q, (B, N, K)), ("k", k, (B, N, K)),
                           ("v", v, (B, N, V))):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"q, k and v must share a dtype; q is {q.dtype}, "
                             f"{name} is {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary (the "
                             f"kernel reads 16 bytes at a time)")
    if K % 16 or V % 16 or not (16 <= K <= 256 and 16 <= V <= 256):
        raise ValueError(f"the attention kernel takes K, V in 16..256, "
                         f"multiples of 16; got K={K}, V={V}")
    if N < 1:
        raise ValueError("empty token dimension")
    entry, counter = _KERNELS[q.dtype]
    out = torch.empty_like(v)
    rc = getattr(_lib(), entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, N, K, V,
        float(K) ** -0.5, _build.stream_ptr(q.device))
    _build.check_launch(rc, entry)
    setattr(fused_global_attention, counter,
            getattr(fused_global_attention, counter) + 1)
    return out


fused_global_attention.launches = 0
fused_global_attention.launches_f32 = 0
