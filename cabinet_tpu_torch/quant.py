"""Post-training int8 quantization of CABiNet's convolutions (counterpart of
`cabinet_tpu.quant`).

Scheme, as the JAX package's, step for step:
  - weights: per-output-channel symmetric scales sw = max|W_c| / 127
    (a multiply by f32(1/127), as XLA computes it), floored at 1e-12, and
    int8 = clip(round(W / sw), -127, 127), from the f32 weights;
  - activations: one static scale per site, sx = absmax / 127 over the
    calibration batches (`collect_act_scales`), and int8 =
    clip(round(x * (1 / sx)), -127, 127) computed in f32;
  - int32 sums, then (sums * (sw * sx) + bias) in f32, cast to the site's
    dtype; everything between the sites runs as it did.

Sites: the model's `nn.Conv2d`s that are JAX's `nn.Conv` sites, both channel
dims >= 16 and the class heads float by name (`default_site_predicate`),
and, under int8dw, the `DepthwiseConv2D`s of >= 16 channels
(`dw_site_predicate`). They are judged by their JAX site keys, through the
key table of `utils/convert.py`; the scales are keyed by the port's module
names (`jax_site_keys` / `port_module_names` convert).

`make_quantized_apply` returns a copy of the model in which every site named
in the scales runs `Int8Site`, a per-instance forward swap in the place of
flax's `nn.intercept_methods`. The int8 weights and f32 scales are made once,
on the CPU, from the f32 weights, and stay f32 when the model is cast to a
compute dtype (JAX keeps its params in f32); the state dict is unchanged.

How the int32 sums are computed (no fallback to float anywhere):
  - dense sites: an int8 im2col of padded strided slices and
    `torch._int_mm` (cuBLASLt's int8 GEMM on CUDA). On CUDA it needs more
    than 16 rows, K-major columns and K and N multiples of 8: a site whose
    output map has at most 16 pixels (the FFM's attention convs on
    (B,C,1,1)) gets 16 zero rows whatever the batch (a branch on the batch
    would guard the symbolic batch of `torch.export`), the weights get
    zero rows up to a multiple of 32 outputs (on the H100 cuBLASLt refused
    K=80 with N=184 or 200 from 65536 rows on, and no padded width of
    Large's sites up to 2^21 rows), and a site whose K is not a multiple
    of 8 raises there;
  - depthwise sites: an f32 convolution of the integer values, exact since
    |sum| <= 127^2 * k^2 < 2^24 (an f32 convolution is not exact for dense
    sites with K*kh*kw > 1040, which Large has).
"""

from __future__ import annotations

import contextlib
import copy
import types
from typing import Callable, Dict, Iterable, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from cabinet_tpu_torch.models.layers import DepthwiseConv2D
from cabinet_tpu_torch.utils.convert import jax_site_keys

# nn.Conv names (JAX's) of the class-logit projections: CABiNet's main head
# `conv_out/conv_out` and aux head `ab/b4`, YOLO-sem's `classifier` and
# `aux_classifier`. Matched by the conv's own name: the inner convs of
# ConvBNReLU blocks under a module named conv_out are called `conv` and pass.
_HEAD_CONV_NAMES = frozenset({"conv_out", "b4", "classifier", "aux_classifier"})

# rows a dense site's GEMM gets added when its output map is this small
_MIN_ROWS = 16
# a dense site's weight rows are padded with zeros to a multiple of this
_OUT_ALIGN = 32
_INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)


def default_site_predicate(path: Tuple[str, ...], kernel_shape) -> bool:
    """JAX's rule for an `nn.Conv` site: both channel dims >= 16, and not a
    class head. `path` is the JAX module path, `kernel_shape` JAX's HWIO
    (kh, kw, cin per group, cout)."""
    if path and path[-1] in _HEAD_CONV_NAMES:
        return False
    kh, kw, cin, cout = kernel_shape
    return cin >= 16 and cout >= 16


def dw_site_predicate(path: Tuple[str, ...], kernel_shape) -> bool:
    """JAX's rule for a depthwise site (int8dw): C >= 16 of its (k, k, 1, C)
    kernel."""
    return kernel_shape[3] >= 16


def _kernel_shape(conv: nn.Conv2d) -> Tuple[int, int, int, int]:
    """JAX's HWIO kernel shape of a torch OIHW conv."""
    cout, cin, kh, kw = conv.weight.shape
    return (kh, kw, cin, cout)


def quantization_sites(model: nn.Module,
                       site_predicate: Callable = default_site_predicate,
                       quantize_depthwise: bool = False) -> Dict[str, nn.Conv2d]:
    """{module name: conv} of the sites of a CABiNet, in module order."""
    keys = jax_site_keys(model.cfgs)
    sites = {}
    for name, m in model.named_modules():
        if not isinstance(m, nn.Conv2d):
            continue
        path = tuple(keys[name].split("/"))
        if isinstance(m, DepthwiseConv2D):
            selected = quantize_depthwise and dw_site_predicate(path, _kernel_shape(m))
        else:
            selected = site_predicate(path, _kernel_shape(m))
        if selected:
            sites[name] = m
    return sites


@contextlib.contextmanager
def _eval_mode(model: nn.Module):
    training = model.training
    model.eval()
    try:
        with torch.no_grad():
            yield
    finally:
        model.train(training)


def collect_act_scales(model: nn.Module, batches: Iterable[torch.Tensor],
                       site_predicate: Callable = default_site_predicate,
                       quantize_depthwise: bool = False) -> Dict[str, float]:
    """Run `model(x)` in eval mode for every x of `batches` (the model's
    own input: NCHW, on its device, in its dtype) and return {site module
    name: act_scale}: each site's max |input| in f32, the max over the
    batches, over 127 in Python floats (1.0 for a site that saw only
    zeros). `quantize_depthwise` adds the depthwise sites (int8dw)."""
    sites = quantization_sites(model, site_predicate, quantize_depthwise)
    stash: Dict[str, torch.Tensor] = {}

    def observer(name):
        def hook(mod, args):
            absmax = args[0].detach().abs().amax().float()
            stash[name] = torch.maximum(stash[name], absmax) if name in stash else absmax
        return hook

    handles = [m.register_forward_pre_hook(observer(n)) for n, m in sites.items()]
    maxima: Dict[str, float] = {}
    try:
        with _eval_mode(model):
            for x in batches:
                stash.clear()
                model(x)
                values = torch.stack(list(stash.values())).tolist() if stash else []
                for key, val in zip(stash, values):
                    maxima[key] = max(maxima.get(key, 0.0), val)
    finally:
        for h in handles:
            h.remove()
    return {k: (v / 127.0 if v > 0 else 1.0) for k, v in maxima.items()}


def im2col_int8(x: torch.Tensor, kernel_size, stride, padding, dilation
                ) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """NHWC int8 (B,H,W,C) -> ((B*Ho*Wo, kh*kw*C) row-major columns,
    (B, Ho, Wo)): the zero-padded input's strided slices, one a tap,
    concatenated in (kh, kw, C) order. `F.unfold` has no int8 kernel on
    the CPU. Row-major, whatever x's strides: cuBLASLt's int8 GEMM takes
    the columns K-major only."""
    B, H, W, C = x.shape
    (kh, kw), (sh, sw), (ph, pw), (dh, dw) = kernel_size, stride, padding, dilation
    Ho = (H + 2 * ph - dh * (kh - 1) - 1) // sh + 1
    Wo = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
    if (kh, kw, sh, sw, ph, pw) == (1, 1, 1, 1, 0, 0):
        return x.contiguous().view(B * H * W, C), (B, H, W)
    xp = F.pad(x, (0, 0, pw, pw, ph, ph))
    taps = [xp[:, i * dh:i * dh + sh * (Ho - 1) + 1:sh,
               j * dw:j * dw + sw * (Wo - 1) + 1:sw]
            for i in range(kh) for j in range(kw)]
    return torch.cat(taps, dim=-1).reshape(B * Ho * Wo, kh * kw * C), (B, Ho, Wo)


class Int8Site(nn.Module):
    """One conv site in int8: `forward(x)` is JAX's `_quantized_conv` (or
    `_quantized_dw` for a `DepthwiseConv2D`) on the conv it was made from.

    Holds `weight_q` (int8: dense (O', kh*kw*I), taps in im2col order,
    O' the O outputs padded with zero rows to a multiple of 32; depthwise
    (C, 1, kh, kw)), `scale` (f32 (O,), sw * f32(sx)) and `bias` (f32, or
    None) as buffers that are not in the state dict. They follow the
    model's moves between devices but never its casts."""

    def __init__(self, conv: nn.Conv2d, act_scale: float):
        super().__init__()
        self.depthwise = isinstance(conv, DepthwiseConv2D)
        if isinstance(conv.padding, str) or conv.padding_mode != "zeros":
            raise ValueError(f"int8 sites take zero padding given as ints, got "
                             f"{conv.padding!r} ({conv.padding_mode})")
        if conv.groups != 1 and not self.depthwise:
            raise ValueError(f"a grouped conv (groups={conv.groups}) is not an int8 site")
        self.kernel_size, self.stride = conv.kernel_size, conv.stride
        self.padding, self.dilation = conv.padding, conv.dilation
        # x * (1 / sx): a multiply by the f32 rounding of the double
        # 1 / sx, as JAX's weak-typed Python float gives it
        self.inv_scale = 1.0 / act_scale
        device = conv.weight.device
        # on the CPU, as XLA computes JAX's jitted sw = max|W_c| / 127: a
        # multiply by f32(1/127) (XLA turns a division by a constant into
        # that); w / sw stays a true division
        w = conv.weight.detach().to("cpu", torch.float32)
        sw = torch.clamp_min(w.abs().amax(dim=(1, 2, 3)) * _INV_127, 1e-12)
        wq = torch.clamp(torch.round(w / sw[:, None, None, None]), -127, 127).to(torch.int8)
        if not self.depthwise:  # (O, I, kh, kw) -> (O', kh*kw*I)
            wq = wq.permute(0, 2, 3, 1).reshape(wq.shape[0], -1)
            wq = F.pad(wq, (0, 0, 0, -wq.shape[0] % _OUT_ALIGN))
        scale = sw * torch.tensor(act_scale, dtype=torch.float32)
        bias = None if conv.bias is None else conv.bias.detach().to("cpu", torch.float32)
        self.register_buffer("weight_q", wq.to(device), persistent=False)
        self.register_buffer("scale", scale.to(device), persistent=False)
        self.register_buffer("bias", None if bias is None else bias.to(device),
                             persistent=False)

    def _apply(self, fn, recurse=True):
        # follow `.to(device)`, but not `.to(dtype)`: the f32 scale and bias
        # are part of the arithmetic, as JAX's f32 params are
        for name, buf in self._buffers.items():
            if buf is not None:
                self._buffers[name] = buf.to(fn(buf).device)
        return self

    def quantize_input(self, x: torch.Tensor) -> torch.Tensor:
        """clip(round(x * (1/sx)), -127, 127) as int8, computed in f32;
        round half to even, as jnp.round."""
        return torch.round(x.float() * self.inv_scale).clamp_(-127, 127).to(torch.int8)

    def sums(self, xq: torch.Tensor) -> torch.Tensor:
        """The sums of the int8 input xq (B,C,H,W): int32 (B,Ho,Wo,O) at a
        dense site, exact integers in f32 (B,C,Ho,Wo) at a depthwise one."""
        if self.depthwise:
            return F.conv2d(xq.float(), self.weight_q.float(), None, self.stride,
                            self.padding, self.dilation, groups=xq.shape[1])
        cols, (B, Ho, Wo) = im2col_int8(xq.permute(0, 2, 3, 1), self.kernel_size,
                                        self.stride, self.padding, self.dilation)
        rows = cols.shape[0]
        if Ho * Wo <= _MIN_ROWS:  # decided by the map, never by the batch
            cols = F.pad(cols, (0, 0, 0, _MIN_ROWS))
        sums = torch._int_mm(cols, self.weight_q.t())
        return sums[:rows, :self.scale.shape[0]].view(B, Ho, Wo, -1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.sums(self.quantize_input(x)).float()
        if self.depthwise:
            return y.mul_(self.scale[:, None, None]).to(x.dtype)
        y.mul_(self.scale)
        if self.bias is not None:
            y.add_(self.bias)
        return y.to(x.dtype).permute(0, 3, 1, 2)


def _int8_forward(self: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """The forward of a conv made an int8 site: its `int8` child runs."""
    return self.int8(x)


def quantized_conv(conv: nn.Conv2d, x: torch.Tensor, act_scale: float) -> torch.Tensor:
    """JAX's `_quantized_conv` on one conv (NCHW in and out), its int8
    weights made now from `conv`'s weights."""
    return Int8Site(conv, act_scale)(x)


def quantized_dw(conv: DepthwiseConv2D, x: torch.Tensor, act_scale: float) -> torch.Tensor:
    """JAX's `_quantized_dw` on one depthwise conv."""
    if not isinstance(conv, DepthwiseConv2D):
        raise TypeError(f"quantized_dw takes a DepthwiseConv2D, got {type(conv).__name__}")
    return Int8Site(conv, act_scale)(x)


def make_quantized_apply(model: nn.Module, act_scales: Mapping[str, float]) -> nn.Module:
    """A copy of `model` whose forward runs int8 at every conv named in
    `act_scales` (module names, as `collect_act_scales` gives them) and
    runs the rest as `model` does; `model` is left as it is.

    Call it on the f32 weights: each site's int8 weights are made from them
    now. Empty scales give a copy of the float model; partial scales
    quantize only the sites they name. A name that is not a conv of the
    model raises."""
    quantized = copy.deepcopy(model)
    modules = dict(quantized.named_modules())
    for name, act_scale in act_scales.items():
        conv = modules.get(name)
        if not isinstance(conv, nn.Conv2d):
            raise ValueError(f"{name!r} is not a conv of the model")
        conv.int8 = Int8Site(conv, float(act_scale))
        conv.forward = types.MethodType(_int8_forward, conv)
    return quantized


def quantization_report(model: nn.Module, act_scales: Mapping[str, float],
                        x: torch.Tensor) -> Dict[str, float]:
    """int8 against the float model on the probe batch x (the model's
    input): the share of pixels with the same argmax, and the mean and max
    |delta| of the final logits."""
    quantized = make_quantized_apply(model, act_scales)
    with _eval_mode(model), _eval_mode(quantized):
        ref = model(x)[0].float()
        quant = quantized(x)[0].float()
    delta = (ref - quant).abs()
    return {
        "argmax_agreement": float((ref.argmax(1) == quant.argmax(1)).float().mean()),
        "mean_abs_logit_delta": float(delta.mean()),
        "max_abs_logit_delta": float(delta.max()),
        "n_quantized_convs": len(act_scales),
    }
