"""Processes, devices and collectives: the port's distributed layer
(counterpart of `cabinet_tpu.core.mesh`).

The JAX package names a device mesh and lets XLA insert the collectives
from sharding annotations. Here both axes are explicit: one process per
rank, started by torchrun (`python -m torch.distributed.run`), which sets
`RANK`, `WORLD_SIZE`, `LOCAL_RANK`, `LOCAL_WORLD_SIZE`, `MASTER_ADDR` and
`MASTER_PORT`. `setup` joins the process group and gives each local rank
its device; every collective of the port goes through `all_reduce_`,
`all_reduce_grad` and `broadcast_`, built only on `all_reduce` and
`broadcast`, the two collectives gloo takes on CUDA tensors, so that the
same code runs under NCCL across cards and under gloo with ranks sharing
a card. Each takes a `group` (the world by default).

`runtime.dist_backend` (auto | nccl | gloo; no JAX counterpart, where XLA
picks the transport): auto is NCCL on CUDA and gloo on the CPU. NCCL
refuses two ranks on one device, so asking for it with more local ranks
than cards raises.

Axes: `DATA_AXIS` names data parallelism (the batch split over ranks,
gradients all-reduced), `MODEL_AXIS` tensor parallelism (the wide layers'
channels split over ranks). `make_mesh(n_data, n_model)` lays the ranks
out as JAX's grid, rank = d * n_model + m (`devices.reshape(n_data,
n_model)`), and builds once the process groups of each axis: the ranks of
one data index form a model group, those of one model index a data group.
`set_mesh` makes a mesh the process's own (`current()`; without one, every
rank sits on the data axis, which is data parallelism over the world).
BatchNorm's statistics, the loss shares, the gradients, the loaders'
shards and the evaluations' shares reduce over the data group; the
sharded layers (`models/tensor_parallel.py`) over the model group.
`tensor_parallel_spec` is JAX's rule for which leaves split;
`shard_model_parallel` and `gather_model_parallel` cut a state dict to this
rank's slices and put the slices back together.

Spatial partitioning (`runtime.spatial_axis`) stripes image rows over the
data axis instead of the batch: `spatial_sharding` takes this data rank's
stripe, rows [d*H/n, (d+1)*H/n), and three differentiable collectives
over the data group serve the ops that read across rows
(`models/spatial_parallel.py`): `halo_exchange` (the rows a conv or a
resize reads beyond the stripe's edges, fetched from the ranks that own
them, zeros beyond the image's; the backward adds the halo's gradient
into its owner's rows), `gather_rows` (the whole map on every rank; the
backward is this rank's rows of the summed gradient) and `spatial_sum`
(a sum over the whole image's pixels). Each is one all-reduce of an f32
buffer that each rank fills with its part, zeros elsewhere, so that the
exchange is exact; tagged `sp_halo`, `sp_gather` and `sp_sum`, forward
and backward.

`COMM` holds, by tag, the calls and host seconds of the collectives this
process made (gloo blocks the host for its call, so that is its cost; an
NCCL call returns once enqueued).
"""

from __future__ import annotations

import datetime
import os
import time
import contextlib
from typing import Any, Dict, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from cabinet_tpu_torch.core.exceptions import ConfigurationError

DATA_AXIS = "data"
MODEL_AXIS = "model"
BACKENDS = ("auto", "nccl", "gloo")
DEFAULT_TIMEOUT_S = 300.0

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
    """Leave the process group, if there is one, and forget its meshes."""
    global _CURRENT
    _CURRENT = None
    _MESHES.clear()
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def host_tensor(values: Any, dtype: torch.dtype) -> torch.Tensor:
    """A tensor for a collective of host values: on the CPU under gloo, on
    this rank's card under NCCL (which takes CUDA tensors only)."""
    on_card = is_distributed() and dist.get_backend() == "nccl"
    return torch.tensor(values, dtype=dtype,
                        device=torch.cuda.current_device() if on_card else "cpu")


# A group of one rank: a collective over it is the value itself.
SELF = "self"


def group_size(group: Any = None) -> int:
    """The ranks of `group` (None: the world; `SELF`: 1)."""
    if group is SELF or not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def all_reduce_(t: torch.Tensor, op: str = "sum", tag: str = "other",
                group: Any = None) -> torch.Tensor:
    """In place: the sum (or max, min) of `t` over the ranks of `group`
    (the world by default); a no-op over one rank."""
    if group_size(group) == 1:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, op={"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                           "min": dist.ReduceOp.MIN}[op], group=group)
    _tally(tag, time.perf_counter() - t0)
    return t


def all_reduce_grad(t: torch.Tensor, tag: str = "other", group: Any = None) -> torch.Tensor:
    """The sum of `t` over the ranks of `group`, differentiable: the
    gradient of each rank's input is the sum of every rank's output
    gradient."""
    if group_size(group) == 1:
        return t
    from torch.distributed.nn.functional import all_reduce

    t0 = time.perf_counter()
    out = all_reduce(t, group=group if group is not None else dist.group.WORLD)
    _tally(tag, time.perf_counter() - t0)
    return out


def broadcast_(t: torch.Tensor, src: int = 0, tag: str = "other",
               group: Any = None) -> torch.Tensor:
    """In place: global rank `src`'s `t` on every rank of `group`."""
    if group_size(group) == 1:
        return t
    t0 = time.perf_counter()
    dist.broadcast(t, src, group=group)
    _tally(tag, time.perf_counter() - t0)
    return t


def broadcast_module_(module: torch.nn.Module, src: int = 0) -> None:
    """Every parameter and buffer of `module` set to rank `src`'s."""
    if not is_distributed():
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            broadcast_(t.data, src, tag="broadcast")


# ---------------------------------------------------------------------------
# The (data, model) grid of ranks
# ---------------------------------------------------------------------------

class Mesh:
    """The ranks as JAX's (n_data, n_model) device grid: rank = d * n_model
    + m. `data_group` holds the ranks of this rank's model index m (the
    batch is split and gradients summed over them), `model_group` those of
    its data index d (the wide layers' channels are split over them); each
    is None for the world or `SELF` for this rank alone. A mesh is shared,
    never copied (a module that holds one may be deep-copied)."""

    def __init__(self, n_data: int, n_model: int, rank: int,
                 data_group: Any = None, model_group: Any = SELF):
        self.n_data, self.n_model, self.rank = int(n_data), int(n_model), int(rank)
        self.data_group, self.model_group = data_group, model_group

    @property
    def data_rank(self) -> int:
        return self.rank // self.n_model

    @property
    def model_rank(self) -> int:
        return self.rank % self.n_model

    @property
    def shape(self) -> Dict[str, int]:
        return {DATA_AXIS: self.n_data, MODEL_AXIS: self.n_model}

    def model_src(self) -> int:
        """The global rank of model index 0 in this rank's model group."""
        return self.data_rank * self.n_model

    def __deepcopy__(self, memo: Dict[int, Any]) -> "Mesh":
        return self

    def __copy__(self) -> "Mesh":
        return self

    def __repr__(self) -> str:
        return f"Mesh(data={self.n_data}, model={self.n_model}, rank={self.rank})"


_CURRENT: Optional[Mesh] = None
_MESHES: Dict[Tuple[int, int], Mesh] = {}


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Mesh:
    """The (n_data, n_model) grid over every rank of the process group,
    n_data by default the rank count / n_model; builds its groups once
    (every rank must call it, in the same order). Unlike JAX's, which
    leaves devices out of a smaller grid, the grid must hold every rank:
    a process cannot sit idle."""
    rank, ranks = world()
    n_model = int(n_model)
    if n_model < 1 or ranks % n_model:
        raise ValueError(f"{ranks} ranks not divisible by model axis {n_model}")
    n_data = ranks // n_model if n_data is None else int(n_data)
    if n_data * n_model != ranks:
        raise ValueError(f"a {n_data} x {n_model} mesh does not hold the {ranks} ranks")
    key = (n_data, n_model)
    if key in _MESHES:
        return _MESHES[key]
    if n_model == 1:
        m = Mesh(n_data, 1, rank, None, SELF)
    elif n_data == 1:
        m = Mesh(1, n_model, rank, SELF, None)
    else:
        data_group = model_group = None
        for d in range(n_data):  # every rank creates every group, in one order
            g = dist.new_group([d * n_model + j for j in range(n_model)])
            if d == rank // n_model:
                model_group = g
        for j in range(n_model):
            g = dist.new_group([d * n_model + j for d in range(n_data)])
            if j == rank % n_model:
                data_group = g
        m = Mesh(n_data, n_model, rank, data_group, model_group)
    _MESHES[key] = m
    return m


def current() -> Mesh:
    """This process's mesh: the one `set_mesh` gave, else every rank on
    the data axis (data parallelism over the world)."""
    if _CURRENT is not None:
        return _CURRENT
    rank, ranks = world()
    return Mesh(ranks, 1, rank, None, SELF)


def set_mesh(m: Optional[Mesh]) -> None:
    global _CURRENT
    _CURRENT = m


@contextlib.contextmanager
def using(m: Mesh) -> Iterator[Mesh]:
    """`m` as the current mesh inside the block."""
    global _CURRENT
    saved, _CURRENT = _CURRENT, m
    try:
        yield m
    finally:
        _CURRENT = saved


def data_world() -> Tuple[int, int]:
    """(data index, data-axis size) of this rank in the current mesh: the
    rank and rank count of data parallelism."""
    m = current()
    return m.data_rank, m.n_data


def data_group() -> Any:
    return current().data_group


def replicated(m: Mesh) -> Mesh:
    """`m` with a data axis of one: a rank's own computation on data every
    data rank holds alike (BatchNorm takes its statistics locally), its
    model group kept."""
    return Mesh(1, m.n_model, m.model_rank, SELF, m.model_group)


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
    (the current mesh's by default) divides it."""
    n = n_data if n_data is not None else current().n_data
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


# ---------------------------------------------------------------------------
# Tensor parallelism: JAX's rule, and state dicts cut to slices and joined
# ---------------------------------------------------------------------------

def tensor_parallel_spec(shape: Sequence[int], n_model: int,
                         min_features: int = 256) -> Tuple[Optional[str], ...]:
    """JAX's rule (`cabinet_tpu/core/mesh.py:tensor_parallel_spec`) on a
    leaf of JAX shape `shape`: its trailing (channel) dim splits over the
    model axis when it holds at least `min_features` and the axis divides
    it; every other leaf is replicated. The partition spec as a tuple:
    (None, ..., MODEL_AXIS) or ()."""
    shape = tuple(int(d) for d in shape)
    if shape and shape[-1] >= min_features and shape[-1] % n_model == 0:
        return (None,) * (len(shape) - 1) + (MODEL_AXIS,)
    return ()


def shard_slice(t: torch.Tensor, dim: int, m: Mesh) -> torch.Tensor:
    """This rank's slice of `t` along `dim`: its model index's of n_model
    equal parts."""
    n = t.shape[dim] // m.n_model
    return t.narrow(dim, m.model_rank * n, n)


def shard_model_parallel(tree: Mapping[str, torch.Tensor], m: Mesh,
                         dims: Mapping[str, Optional[int]]) -> Dict[str, torch.Tensor]:
    """A state dict with every leaf that `dims` gives a dim cut to this
    rank's slice along it (a copy), the others as they are: JAX's
    `shard_model_parallel`, where the slice is what the device holds.
    Keys absent from `dims` are replicated."""
    return {k: (shard_slice(v, dims[k], m).clone() if dims.get(k) is not None
                and m.n_model > 1 else v) for k, v in tree.items()}


def gather_model_parallel(tree: Mapping[str, torch.Tensor], m: Mesh,
                          dims: Mapping[str, Optional[int]],
                          tag: str = "tp_gather") -> Dict[str, torch.Tensor]:
    """The inverse of `shard_model_parallel`, over the model group: every
    sliced leaf put back whole on every rank of the group, through one
    all-reduce a dtype of a zero buffer that each rank fills with its
    slices (so that the join is exact). Every rank of the group must call
    it with the same keys."""
    out = dict(tree)
    keys = [k for k in tree if dims.get(k) is not None]
    if m.n_model == 1 or not keys:
        return out
    by_dtype: Dict[Tuple[torch.dtype, torch.device], List[str]] = {}
    for k in keys:
        by_dtype.setdefault((tree[k].dtype, tree[k].device), []).append(k)
    for (dtype, device), names in by_dtype.items():
        fulls = []
        for k in names:
            part, dim = tree[k], dims[k]
            shape = list(part.shape)
            shape[dim] *= m.n_model
            full = torch.zeros(shape, dtype=dtype, device=device)
            shard_slice(full, dim, m).copy_(part)
            fulls.append(full)
        flat = torch.cat([f.reshape(-1) for f in fulls])
        all_reduce_(flat, tag=tag, group=m.model_group)
        offset = 0
        for k, f in zip(names, fulls):
            out[k] = flat[offset:offset + f.numel()].view(f.shape).clone()
            offset += f.numel()
    return out


# ---------------------------------------------------------------------------
# Spatial partitioning: image rows striped over the data axis
# ---------------------------------------------------------------------------

def stripe(height: int, m: Mesh) -> Tuple[int, int]:
    """This data rank's rows [start, stop) of `height` rows: equal stripes,
    data index d owning [d*height/n, (d+1)*height/n); raises unless the
    data axis divides `height`."""
    if height % m.n_data:
        raise ValueError(f"{height} rows do not split into {m.n_data} equal stripes")
    h = height // m.n_data
    return m.data_rank * h, (m.data_rank + 1) * h


def spatial_sharding(m: Mesh, ndim: int):
    """JAX's `spatial_sharding` (dim 1, the image rows, over the data
    axis): a function taking a (B, H, ...) array of `ndim` dims to this
    data rank's stripe of its rows (a view)."""
    if ndim < 2:
        raise ValueError("spatial sharding needs a (B, H, ...) array")

    def take(x: torch.Tensor) -> torch.Tensor:
        if x.dim() != ndim:
            raise ValueError(f"expected {ndim} dims, got {tuple(x.shape)}")
        start, stop = stripe(x.shape[1], m)
        return x[:, start:stop]
    return take


ROWS = 2  # the row dim of NCHW activations


def _halo_index(m: Mesh, h: int, above: int, below: int) -> Tuple[List[int], int]:
    """Where each row of the padded stripe [start - above, stop + below)
    outside the stripe sits in the exchange buffer: (B, C, n, ra + rb, W)
    viewed as (B, C, n * (ra + rb), W), rank q's slot holding its last ra =
    min(above, h) rows then its first rb = min(below, h); `n * (ra + rb)`
    stands for a row beyond the image (a zero). Returns (the indices of the
    rows above, then below; ra)."""
    n, d = m.n_data, m.data_rank
    ra, rb = min(above, h), min(below, h)
    slot = ra + rb
    idx = []
    for g in list(range(d * h - above, d * h)) + list(range((d + 1) * h, (d + 1) * h + below)):
        q = g // h
        if g < 0 or q >= n:
            idx.append(n * slot)
        elif q < d:  # a tail row of rank q
            idx.append(q * slot + (g - q * h) - (h - ra))
        else:  # a head row of rank q
            idx.append(q * slot + ra + (g - q * h))
    return idx, ra


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, above, below, m):
        B, C, h, W = x.shape
        idx, ra = _halo_index(m, h, above, below)
        rb = min(below, h)
        buf = torch.zeros((B, C, m.n_data, ra + rb, W), dtype=torch.float32, device=x.device)
        buf[:, :, m.data_rank, :ra] = x[:, :, h - ra:]
        buf[:, :, m.data_rank, ra:] = x[:, :, :rb]
        flat = all_reduce_(buf, tag="sp_halo", group=m.data_group).view(B, C, -1, W)
        flat = torch.cat([flat, flat.new_zeros((B, C, 1, W))], dim=ROWS)
        rows = flat.index_select(ROWS, torch.tensor(idx, device=x.device)).to(x.dtype)
        ctx.save = (idx, ra, rb, h, above, m)
        return torch.cat([rows[:, :, :above], x, rows[:, :, above:]], dim=ROWS)

    @staticmethod
    def backward(ctx, g):
        idx, ra, rb, h, above, m = ctx.save
        B, C, _, W = g.shape
        gx = g[:, :, above:above + h].clone()
        halo = torch.cat([g[:, :, :above], g[:, :, above + h:]], dim=ROWS).float()
        flat = torch.zeros((B, C, m.n_data * (ra + rb) + 1, W), dtype=torch.float32,
                           device=g.device)
        flat.index_add_(ROWS, torch.tensor(idx, device=g.device), halo)
        buf = all_reduce_(flat[:, :, :-1].contiguous().view(B, C, m.n_data, ra + rb, W),
                          tag="sp_halo", group=m.data_group)
        mine = buf[:, :, m.data_rank].to(g.dtype)
        gx[:, :, h - ra:] += mine[:, :, :ra]
        gx[:, :, :rb] += mine[:, :, ra:]
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, above: int, below: int, m: Mesh) -> torch.Tensor:
    """This rank's stripe `x` (B, C, h, W) of an image of n * h rows, with
    `above` rows before it and `below` after it from the ranks that own
    them (across several ranks when the halo is taller than a stripe),
    zeros beyond the image's own top and bottom edges: (B, C, above + h +
    below, W). Every rank of the data group calls it with the same
    arguments."""
    if above < 0 or below < 0:
        raise ValueError(f"negative halo ({above}, {below})")
    return _Halo.apply(x, int(above), int(below), m)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, m):
        B, C, h, W = x.shape
        full = torch.zeros((B, C, m.n_data * h, W), dtype=torch.float32, device=x.device)
        full[:, :, m.data_rank * h:(m.data_rank + 1) * h] = x
        ctx.save = (h, m)
        return all_reduce_(full, tag="sp_gather", group=m.data_group).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        h, m = ctx.save
        summed = all_reduce_(g.float().clone(), tag="sp_gather", group=m.data_group)
        return summed[:, :, m.data_rank * h:(m.data_rank + 1) * h].to(g.dtype), None


def gather_rows(x: torch.Tensor, m: Mesh) -> torch.Tensor:
    """The whole (B, C, n * h, W) map on every rank of the data group from
    each rank's stripe (exact: the others add zeros). Backward: this
    rank's rows of the gradient summed over the group (each rank's use of
    the whole map adds its part)."""
    return _GatherRows.apply(x, m)


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, s, m):
        ctx.m = m
        return all_reduce_(s.clone(), tag="sp_sum", group=m.data_group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), tag="sp_sum", group=ctx.m.data_group), None


def spatial_sum(x: torch.Tensor, m: Mesh, dims: Sequence[int] = (2, 3)) -> torch.Tensor:
    """The f32 sum of `x` over `dims` (rows and columns) of the whole
    image: each stripe's sum, summed over the data group; its gradient
    is every rank's, summed, on each rank's pixels."""
    return _Sum.apply(x.float().sum(dim=tuple(dims)), m)
