"""Builds the CUDA sources under `csrc/` into shared libraries and loads them.

Each `csrc/<name>.cu` becomes `_build/<name>-<hash>.so`, compiled by `nvcc`
for `sm_90a` with a plain C interface and loaded with `ctypes`. The hash
covers the source, the shared headers (`csrc/*.cuh`) and the flags, so an
edited source or header is rebuilt. Nothing is compiled or loaded when
this module is imported: `load` builds on the first launch of a kernel,
and `build_all` builds every source at once, one `nvcc` process per
source, all started together.

`count_flops()` tallies the arithmetic of the kernels launched while it is
entered (`add_flops`, called by each wrapper beside its launch count):
`torch.utils.flop_counter.FlopCounterMode` sees aten operators, not a
ctypes launch, so `utils/profiler.py` adds this tally to its count.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Iterator, Optional

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("attention", "decoder_tail", "early_stage")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")

_LOADED: Dict[str, ctypes.CDLL] = {}
_FLOPS: Optional[Dict[str, int]] = None


@contextlib.contextmanager
def count_flops() -> Iterator[Dict[str, int]]:
    """While entered, {kernel: FLOPs} of the kernels launched, counted as
    FlopCounterMode counts their plain versions: 2 per multiply-add of the
    products and convolutions, nothing for elementwise work."""
    global _FLOPS
    saved, _FLOPS = _FLOPS, {}
    try:
        yield _FLOPS
    finally:
        _FLOPS = saved


def add_flops(kernel: str, flops: int) -> None:
    if _FLOPS is not None:
        _FLOPS[kernel] = _FLOPS.get(kernel, 0) + int(flops)


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME, /usr/local/cuda or PATH)")
    return found


def library_path(name: str) -> Path:
    """`_build/<name>-<hash>.so`, the hash over `<name>.cu`, every header
    of `csrc/` (any source may include any of them) and the flags."""
    h = hashlib.sha1((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str] = SOURCES) -> float:
    """Compile the named sources that are not built yet, in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure.
    `nvcc`'s own report (registers, shared memory, spills) is kept beside
    each library as `<name>.log`."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failures = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        (BUILD_DIR / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        _LOADED[name] = lib
    return lib


def check_launch(rc: int, kernel: str) -> None:
    """Raise if a launcher returned a CUDA error code (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: "
                           f"cudaError {rc}")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when autograd would record a call of `kernel` on `tensors`.

    The kernels are forward-only, as the Pallas kernels they replace are
    (nothing in `cabinet_tpu/ops/` defines a VJP): their outputs carry no
    `grad_fn`, so a call under autograd would silently drop every gradient
    through it. This holds on every device, the plain versions on CPU
    tensors included, so that the rule is the same wherever it is tested;
    under `torch.no_grad()` the call runs."""
    import torch

    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the kernel has no backward (as in the JAX package); "
            f"call it under torch.no_grad(), or train through the modules "
            f"(CABiNet(attention='einsum'), the model's own forward)")
