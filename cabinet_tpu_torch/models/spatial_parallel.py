"""Spatial partitioning for CABiNet: image rows striped over the ranks of a
data group (counterpart of the JAX package's `runtime.spatial_axis`,
`cabinet_tpu/core/mesh.py:66-78 spatial_sharding`, whose halo exchanges
GSPMD inserts; here they are placed by hand, and the math is the
one-device model's).

`spatial_parallel(model, mesh)` makes a CABiNet the row-striped twin of
itself in place, the sibling of `models/tensor_parallel.py:
tensor_parallel`: the weights stay whole and the same on every rank, the
state dict keeps its keys. Inside `stripes(model)` (the train step's
forward and backward) its input is this data rank's stripe of rows, data
index d owning [d*H/n, (d+1)*H/n) (`core/mesh.py:stripe`); outside it the
model takes whole frames as it always did (the val loss, the
evaluations). Every op that reads across rows has its own handling:
  - each conv of kernel k > 1 outside the attention branch (the stem,
    the backbone's depthwise convs, the spatial branch's 7x7 and 3x3s,
    the output head's 3x3) reads, for stride s and padding p, p rows
    above its stripe and k - p - s below (`core/mesh.py:halo_exchange`),
    then convolves without padding the rows; the stripe's first row is a
    multiple of s at every level, which `stripe_multiple` makes the
    crop's condition;
  - the global means (SE's pooling, the FFM's attention) sum their
    stripe and all-reduce the sums (`spatial_mean`);
  - the /32 context: the backbone's output is gathered whole on every
    rank (`gather_rows`), and the attention branch (conva, the CAB with
    its PSP pooling and its attention over all N tokens, convb, b1-b4)
    runs on it unchanged, its BatchNorm statistics taken locally
    (`core/mesh.py:replicated`: every rank holds the same whole map, so
    those statistics are the image's, and no rank counts the map twice);
    each rank then reads its own rows of the branch's outputs;
  - the half-pixel bilinear resizes take the output rows of the stripe
    (`resize_rows`) from a whole source (the branch's outputs) or from
    the stripe with one row of halo each side (the logits to full size),
    clamped only at the image's own edges;
  - BatchNorm over the data group and the losses with `share=True`
    already reduce over every rank's pixels (`models/layers.py`,
    `train/losses.py`), so they serve stripes as they are.

Each rank's loss is its stripe's share of the global loss, and the
collectives' backward sends each rank's gradient back to the rows it
read, so the gradients summed over the data group are the whole batch's:
the trainer reduces them as under data parallelism. Tensor parallelism
composes: cut the model first (`tensor_parallel`), then stripe it; the
convs' halos travel over the data group, their channels over the model
group.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cabinet_tpu_torch.core import mesh as _mesh


# ---------------------------------------------------------------------------
# The striped ops
# ---------------------------------------------------------------------------

class _StripedConv:
    """A conv whose input is a stripe of rows inside `stripes`: the halo
    its kernel reads beyond the stripe is exchanged first, and the rows
    are not padded (the columns are)."""

    def _conv_forward(self, x: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor]) -> torch.Tensor:
        if not getattr(self, "sp_on", False):
            return super()._conv_forward(x, weight, bias)
        k, s, p = self.kernel_size[0], self.stride[0], self.padding[0]
        if x.shape[2] % s:
            raise ValueError(f"a stripe of {x.shape[2]} rows into a conv of stride {s}")
        from cabinet_tpu_torch.models.tensor_parallel import ShardedConv2d, bounded_conv2d

        x = _mesh.halo_exchange(x, p, k - p - s, self.sp_mesh)
        conv = bounded_conv2d if isinstance(self, ShardedConv2d) else F.conv2d
        return conv(x, weight, bias, self.stride, (0, self.padding[1]), self.dilation,
                    self.groups)


_STRIPED: Dict[type, type] = {}


def _striped_class(cls: type) -> type:
    """`cls` (a conv class) with `_StripedConv` in front, made once."""
    if cls not in _STRIPED:
        _STRIPED[cls] = type(f"Striped{cls.__name__}", (_StripedConv, cls), {})
    return _STRIPED[cls]


def spatial_mean(x: torch.Tensor, owner: nn.Module, keepdim: bool = False) -> torch.Tensor:
    """The mean of `x` (B, C, H, W) over its rows and columns: of the whole
    image when `owner` runs on a stripe (its sum all-reduced over the data
    group, divided by the whole image's pixels), else `x.mean`."""
    if not getattr(owner, "sp_on", False):
        return x.mean(dim=(2, 3), keepdim=keepdim)
    m = owner.sp_mesh
    mean = (_mesh.spatial_sum(x, m) / (x.shape[2] * m.n_data * x.shape[3])).to(x.dtype)
    return mean[:, :, None, None] if keepdim else mean


def resize_rows(x: torch.Tensor, row0: int, in_h: int, size: Tuple[int, int],
                rows: Tuple[int, int]) -> torch.Tensor:
    """Rows [rows[0], rows[1]) of the half-pixel bilinear resize
    (`models/cab.py:resize_bilinear`) of an image of `in_h` rows to
    `size`, from `x` (B, C, r, W_in), which holds that image's rows
    [row0, row0 + r): all the rows the output rows read, after the clamp
    at the image's edges. The columns are resized first (F.interpolate,
    the rows unchanged), then each output row is torch's two-tap blend of
    its source rows, with torch's f32 weights."""
    out_h, out_w = int(size[0]), int(size[1])
    if x.shape[3] != out_w:
        x = F.interpolate(x, size=(x.shape[2], out_w), mode="bilinear", align_corners=False,
                          antialias=False)
    scale = np.float32(in_h) / np.float32(out_h)
    real = np.maximum((np.arange(rows[0], rows[1], dtype=np.float32) + np.float32(0.5))
                      * scale - np.float32(0.5), np.float32(0.0))
    i0 = np.floor(real)
    lam = torch.from_numpy(real - i0).to(x.device, x.dtype)[None, None, :, None]
    i0 = i0.astype(np.int64)
    i1 = np.minimum(i0 + 1, in_h - 1)
    if i0.min() < row0 or i1.max() >= row0 + x.shape[2]:
        raise ValueError(f"rows {rows} of a resize of {in_h} rows to {out_h} read beyond "
                         f"the source rows [{row0}, {row0 + x.shape[2]})")
    top = x.index_select(2, torch.from_numpy(i0 - row0).to(x.device))
    bottom = x.index_select(2, torch.from_numpy(i1 - row0).to(x.device))
    return top * (1 - lam) + bottom * lam


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def stripe_multiple(model: nn.Module) -> int:
    """The total stride of `model`'s deepest map (MobileNetV3's: the stem's
    2 times each block's stride; the spatial branch's 8): a stripe's
    height must be a multiple of it, so that every stride-s conv's stripe
    starts on a multiple of s."""
    backbone = 2 * int(np.prod([int(row[5]) for row in model.cfgs]))
    return max(backbone, 8)


def _striped_parts(model: nn.Module):
    """The modules that run on stripes: all but the attention branch."""
    return (model, model.sb, model.mobile, model.ffm, model.conv_out)


def spatial_parallel(model: nn.Module, m: _mesh.Mesh) -> nn.Module:
    """`model` (a CABiNet, the same on every rank of the data group; cut by
    `tensor_parallel` first, if at all) made its row-striped twin in place:
    every conv of kernel > 1 outside the attention branch gets the halo
    (its class `Striped<its class>`), and every module outside that branch
    carries `sp_mesh`. Returns `model`; a mesh of one data rank leaves it
    as it is."""
    if m.n_data == 1:
        return model
    if not all(hasattr(model, a) for a in ("sb", "mobile", "ab", "ffm", "conv_out")):
        raise ValueError("spatial partitioning covers CABiNet only (the JAX package's "
                         "YOLO-sem main never reads runtime.spatial_axis)")
    for part in _striped_parts(model)[1:]:
        for mod in part.modules():
            if isinstance(mod, nn.Conv2d) and mod.kernel_size[0] > 1:
                k, s, p = mod.kernel_size[0], mod.stride[0], mod.padding
                if (mod.padding_mode != "zeros" or mod.dilation != (1, 1)
                        or isinstance(p, str) or k - p[0] - s < 0):
                    raise ValueError(f"conv {mod} has no striped twin")
                if not isinstance(mod, _StripedConv):
                    mod.__class__ = _striped_class(type(mod))
    for part in _striped_parts(model):
        for mod in ([part] if part is model else part.modules()):
            mod.sp_mesh = m
    return model


def mesh_of(model: nn.Module) -> Optional[_mesh.Mesh]:
    """The mesh `model` is striped over, or None (not striped)."""
    return getattr(model, "sp_mesh", None)


@contextlib.contextmanager
def stripes(model: nn.Module) -> Iterator[None]:
    """Inside the block a striped `model` takes this rank's stripe of rows
    (nothing changes on a model that is not striped). A rematerialised
    block recomputes in the backward, so the block holds the backward too."""
    mods = [mod for mod in model.modules() if getattr(mod, "sp_mesh", None) is not None]
    for mod in mods:
        mod.sp_on = True
    try:
        yield
    finally:
        for mod in mods:
            mod.sp_on = False


def decode_stripe(model: nn.Module, x: torch.Tensor, mobile_feat: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`CABiNet._decode` on this rank's stripe `x` (B, 3, h, W) of images of
    n * h rows and the backbone's stripe `mobile_feat`: this rank's rows of
    (final, aux) at full size."""
    from cabinet_tpu_torch.models.cab import resize_bilinear
    from cabinet_tpu_torch.models.tensor_parallel import full_channels

    m = model.sp_mesh
    n = m.n_data
    H, W = x.shape[2] * n, x.shape[3]
    feat_sb = full_channels(model.sb(x), 128, model.ffm)  # the FFM's concatenation
    with _mesh.using(_mesh.replicated(m)):  # the whole /32 map on every rank
        low_res, aux = model.ab(_mesh.gather_rows(mobile_feat, m))
    low_res = full_channels(low_res, 256, model.ffm)
    h8 = feat_sb.shape[2]
    sb_hw = (h8 * n, feat_sb.shape[3])
    rows8, rows = _mesh.stripe(sb_hw[0], m), _mesh.stripe(H, m)
    feat_fuse = model.ffm(feat_sb, resize_rows(low_res, 0, low_res.shape[2], sb_hw, rows8))
    logits = _mesh.halo_exchange(model.conv_out(feat_fuse), 1, 1, m)
    final = resize_rows(logits, rows8[0] - 1, sb_hw[0], (H, W), rows)
    aux8 = resize_bilinear(aux, sb_hw)
    return final, resize_rows(aux8, 0, sb_hw[0], (H, W), rows)
