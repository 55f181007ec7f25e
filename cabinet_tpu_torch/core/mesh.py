"""Processes, devices and collectives: the port's distributed layer
(counterpart of `cabinet_tpu.core.mesh`).

The JAX package names a device mesh and lets XLA insert the collectives
from sharding annotations. Here data parallelism is explicit: one process
per rank, started by torchrun (`python -m torch.distributed.run`), which
sets `RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR`
and `MASTER_PORT`. `setup` joins the process group and gives each local
rank its device; every collective of the port goes through `all_reduce_`,
`all_reduce_grad` and `broadcast_`, built only on `all_reduce` and
`broadcast`, the two collectives gloo takes on CUDA tensors, so that the
same code runs under NCCL across cards and under gloo with ranks sharing
a card.

`runtime.dist_backend` (auto | nccl | gloo; no JAX counterpart, where XLA
picks the transport): auto is NCCL on CUDA and gloo on the CPU. NCCL
refuses two ranks on one device, so asking for it with more local ranks
than cards raises.

Axes: `DATA_AXIS` names data parallelism (the batch split over ranks,
gradients all-reduced), `MODEL_AXIS` tensor parallelism. The work-
partitioning half of model parallelism needs nothing here but the ranks
and `all_reduce_`: the pipeline (`train/pipeline.py`) places whole
modules on devices, and tile-sharded eval (`eval/evaluator.py`) shares
whole tiles over the ranks. The tensor-parallel and spatial helpers,
which split tensors, are not ported: they raise, naming their ROADMAP
item (`TENSOR_PARTITIONING`).

`COMM` holds, by tag, the calls and host seconds of the collectives this
process made (gloo blocks the host for its call, so that is its cost; an
NCCL call returns once enqueued).
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from cabinet_tpu_torch.core.exceptions import ConfigurationError

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("auto", "nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0
TENSOR_PARTITIONING = "ROADMAP Queue 1 item 7, its tensor-partitioning half"

COMM: Dict[str, Dict[str, float]] = {}


def _tally(tag: str, seconds: float) -> None:
    rec = COMM.setdefault(tag, {"calls": 0, "seconds": 0.0})
    rec["calls"] += 1
    rec["seconds"] += seconds


def comm_since(snapshot: Dict[str, Dict[str, float]]) -> Dict[str, Dict[str, float]]:
    """`COMM` less an earlier copy of it (`{k: dict(v) for k, v in COMM.items()}`)."""
    return {k: {"calls": v["calls"] - snapshot.get(k, {}).get("calls", 0),
                "seconds": v["seconds"] - snapshot.get(k, {}).get("seconds", 0.0)}
            for k, v in COMM.items()}


def is_distributed() -> bool:
    """True inside a process group of more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def world() -> Tuple[int, int]:
    """(rank, world size) of the process group, (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def env_world() -> Tuple[int, int]:
    """(RANK, WORLD_SIZE) from torchrun's environment, (0, 1) without it."""
    return int(os.environ.get("RANK", "0")), int(os.environ.get("WORLD_SIZE", "1"))


def resolve_backend(backend: str, device: torch.device) -> str:
    backend = str(backend).lower()
    if backend not in BACKENDS:
        raise ConfigurationError(f"runtime.dist_backend must be one of {BACKENDS}, "
                                 f"got {backend!r}")
    if backend == "auto":
        return "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.type != "cuda":
        raise ConfigurationError("runtime.dist_backend=nccl needs CUDA devices; "
                                 "use gloo on the CPU")
    return backend


def setup(device: Union[str, torch.device], backend: str = "auto",
          timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group that torchrun's environment describes and
    return this rank's device: cuda:(LOCAL_RANK mod the card count) on
    CUDA, the CPU as asked. Without that environment (WORLD_SIZE unset),
    or with a group already up, nothing is joined and `device` comes back
    as it is; a group of one rank (torchrun --nproc_per_node 1) is joined
    and takes no collective. Every collective of the group times out after
    `timeout_s`, so a lost rank ends the others."""
    device = torch.device(device)
    rank, size = env_world()
    if "WORLD_SIZE" not in os.environ or (dist.is_available() and dist.is_initialized()):
        return device
    backend = resolve_backend(backend, device)
    if device.type == "cuda":
        n_cards = torch.cuda.device_count()
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        if backend == "nccl" and local_size > n_cards:
            raise ConfigurationError(
                f"{local_size} ranks on {n_cards} CUDA device(s): NCCL takes one rank "
                f"per device; set +runtime.dist_backend=gloo to share a device")
        device = torch.device("cuda", local_rank % n_cards)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=float(timeout_s)))
    return device


def teardown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_tensor(values: Any, dtype: torch.dtype) -> torch.Tensor:
    """A tensor for a collective of host values: on the CPU under gloo, on
    this rank's card under NCCL (which takes CUDA tensors only)."""
    on_card = is_distributed() and dist.get_backend() == "nccl"
    return torch.tensor(values, dtype=dtype,
                        device=torch.cuda.current_device() if on_card else "cpu")


def all_reduce_(t: torch.Tensor, op: str = "sum", tag: str = "other") -> torch.Tensor:
    """In place: the sum (or max, min) of `t` over every rank; a no-op
    without a group of more than one rank."""
    if not is_distributed():
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                           "min": dist.ReduceOp.MIN}[op])
    _tally(tag, time.perf_counter() - t0)
    return t


def all_reduce_grad(t: torch.Tensor, tag: str = "other") -> torch.Tensor:
    """The sum of `t` over every rank, differentiable: the gradient of each
    rank's input is the sum of every rank's output gradient."""
    if not is_distributed():
        return t
    from torch.distributed.nn.functional import all_reduce

    t0 = time.perf_counter()
    out = all_reduce(t)
    _tally(tag, time.perf_counter() - t0)
    return out


def broadcast_(t: torch.Tensor, src: int = 0, tag: str = "other") -> torch.Tensor:
    """In place: rank `src`'s `t` on every rank."""
    if not is_distributed():
        return t
    t0 = time.perf_counter()
    dist.broadcast(t, src)
    _tally(tag, time.perf_counter() - t0)
    return t


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` set to rank `src`'s."""
    if not is_distributed():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t.data, src, tag="broadcast")


def auto_data_axis(batch_size: int, n_devices: Optional[int] = None) -> int:
    """Largest divisor of batch_size that fits the rank count — keeps the
    batch evenly shardable on the data axis regardless of batch/rank ratio."""
    n = n_devices if n_devices is not None else world()[1]
    d = min(batch_size, n)
    while d > 1 and batch_size % d != 0:
        d -= 1
    return max(d, 1)


def local_batch_size(global_batch: int, n_data: Optional[int] = None) -> int:
    """Each rank's share of the global batch; raises unless the data axis
    (the rank count by default) divides it."""
    n = n_data if n_data is not None else world()[1]
    if global_batch % n != 0:
        raise ValueError(f"Global batch {global_batch} not divisible by data axis {n}")
    return global_batch // n


def process_shard(n_items: int, pid: Optional[int] = None,
                  nproc: Optional[int] = None) -> slice:
    """Slice of a global index range owned by this rank (contiguous, the
    first n_items % nproc ranks one longer)."""
    rank, size = world()
    pid = rank if pid is None else pid
    nproc = size if nproc is None else nproc
    per = n_items // nproc
    extra = n_items % nproc
    start = pid * per + min(pid, extra)
    stop = start + per + (1 if pid < extra else 0)
    return slice(start, stop)


def tensor_parallel_spec(shape: Sequence[int], n_model: int, min_features: int = 256) -> Any:
    raise NotImplementedError(f"tensor parallelism is not ported yet ({TENSOR_PARTITIONING})")


def shard_model_parallel(tree: Any, mesh: Any, min_features: int = 256) -> Any:
    raise NotImplementedError(f"tensor parallelism is not ported yet ({TENSOR_PARTITIONING})")


def spatial_sharding(mesh: Any, ndim: int) -> Any:
    raise NotImplementedError(f"spatial partitioning is not ported yet ({TENSOR_PARTITIONING})")
