"""Fused global-context attention (kernel K1) and its plain version.

softmax(q k^T * K^-0.5) v per batch element over all N tokens of the CAB's
/32 feature map, with f32 math, the (N, N) matrix never in device memory.
Replaces the Pallas kernel `cabinet_tpu/ops/attention.py:_attention_kernel`,
which takes any dtype. The CUDA kernels are in `csrc/attention.cu`, one for
bf16 (tensor cores) and one for f32 (f32 FMAs, no TF32); see its header for
the design. When a batch has too few query tiles to fill the card, either
kernel splits each tile's keys into ranges (`key_splits`) and a second
kernel merges them in a fixed order.

Like the Pallas body, the kernel and its plain version keep the
probabilities in f32 through the value product. The JAX einsum path
(`cabinet_tpu/models/cab.py`, and the Pallas wrapper's fallback) casts them
to v's dtype first; in bf16 the two differ by about 1e-2, in f32 they agree
to rounding. The Pallas wrapper takes that fallback off the TPU, and on the
TPU whenever the kernel's VMEM working set 4*(N^2 + 2NK + 2NV) bytes
exceeds 12 MB (`cabinet_tpu/ops/attention.py:57-58`): at K=V=128, N > 1536,
e.g. the /32 map of a 1280^2 input (N=1600). The port keeps f32
probabilities at every N: that budget is the TPU's memory, not part of the
function.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from cabinet_tpu_torch.ops import _build


def global_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """Plain version of K1: q,k (B,N,K), v (B,N,V) -> (B,N,V) in v's dtype,
    computed in f32 with f32 probabilities (the Pallas body)."""
    attn = torch.matmul(q.float(), k.float().transpose(1, 2)) * (q.shape[-1] ** -0.5)
    attn = torch.softmax(attn, dim=-1)
    return torch.matmul(attn, v.float()).to(v.dtype)


# Queries per block and keys per tile of both kernels (BQ, BKV and F_BQ,
# F_BKV in csrc/attention.cu).
BLOCK = 64


def key_splits(B: int, N: int, n_sm: int) -> int:
    """How many contiguous ranges of key tiles either kernel splits each
    query tile's keys into (split i walks tiles [i*T//splits,
    (i+1)*T//splits) of the T = ceil(N/64)), on a card with `n_sm` SMs: as
    many as keep the grid within one block per SM, at most one per key
    tile. So 1 when the B x T query tiles alone exceed half the SMs (B=8,
    N=1024 on 132 SMs: 128 blocks): a second split would stack two blocks
    on some SMs, which shortens nothing there, and cost the merge. Both
    kernels hold one block an SM (the f32 one by its registers)."""
    tiles = -(-N // BLOCK)
    return max(1, min(tiles, n_sm // (B * tiles)))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The library with its launchers' signatures set, once."""
    lib = _build.load("attention")
    lib.cabinet_attention.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.cabinet_attention_f32.argtypes = lib.cabinet_attention.argtypes
    lib.cabinet_attention.restype = ctypes.c_int
    lib.cabinet_attention_f32.restype = ctypes.c_int
    return lib


def fused_global_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T * K^-0.5) v; q,k (B,N,K), v (B,N,V) -> (B,N,V).

    CPU tensors take the plain version. CUDA tensors launch K1: its bf16
    kernel for bf16 inputs (counted in `launches`, once a call whether or
    not the splits are merged by a second kernel), its f32 kernel for f32
    inputs (counted in `launches_f32`). Both take contiguous, 16-byte
    aligned tensors of one dtype, K and V multiples of 16 up to 256;
    anything else raises, and so does a call under autograd on inputs that
    require grad (`_build.refuse_grad`): K1 has no backward."""
    _build.refuse_grad("fused_global_attention", q, k, v)
    if q.device.type == "cpu":
        return global_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"fused_global_attention: unsupported device {q.device}")
    if q.dtype not in (torch.bfloat16, torch.float32):
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
    out = torch.empty_like(v)
    f32 = q.dtype == torch.float32
    splits = key_splits(B, N, _sm_count(q.device.index))
    ws = (torch.empty(splits * B * N * (V + 2), dtype=torch.float32, device=q.device)
          if splits > 1 else None)
    launcher = _lib().cabinet_attention_f32 if f32 else _lib().cabinet_attention
    rc = launcher(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  None if ws is None else ws.data_ptr(), B, N, K, V, splits,
                  float(K) ** -0.5, _build.stream_ptr(q.device))
    _build.check_launch(rc, "cabinet_attention_f32" if f32 else "cabinet_attention")
    if f32:
        fused_global_attention.launches_f32 += 1
    else:
        fused_global_attention.launches += 1
    _build.add_flops("attention_f32" if f32 else "attention", 2 * B * N * N * (K + V))
    return out


fused_global_attention.launches = 0
fused_global_attention.launches_f32 = 0
