"""Serving export for the port: one `torch.export` program that maps uint8
pixels to class IDs (counterpart of `cabinet_tpu.export`).

Artifact layout (a directory)::

    <out>/serving.pt2     -- `torch.export.save` of the ExportedProgram
    <out>/metadata.json   -- dataset, classes, palette, resolution, dtype,
                             and the device type the program was exported for

The serving function is ``uint8 (B,H,W,3) RGB -> int32 (B,H,W) class IDs``:
normalisation (the dataset's mean/std, in f32), the dtype cast, the forward
and the argmax all live inside the one program, so the host-side contract
is "feed pixels, read masks", as in the JAX package.

Batch handling: an int exports a fixed-shape program; a string (e.g. "b")
exports the batch as a `torch.export.Dim` of that name, so one artifact
serves any batch.

The hand-written kernels stay out of the artifact, as the JAX package
leaves its Pallas kernels out: a ctypes launch cannot be traced. The
artifact is the model's own path (`CABiNet(attention="einsum")`,
`Segmenter`'s route "model"), on cuDNN and cuBLAS on the card.

A program holds its weights on the device it was exported on.
`load_artifact` raises when asked to run a program on another device type
than it was exported for, and moves nothing.
"""

from __future__ import annotations

import copy
import json
from pathlib import Path
from typing import Callable, Sequence, Tuple, Union

import torch
from torch import nn

from cabinet_tpu_torch.core.device import resolve_device
from cabinet_tpu_torch.models.cab import GlobalContextAttention

ARTIFACT_NAME = "serving.pt2"
METADATA_NAME = "metadata.json"


class ServingModule(nn.Module):
    """uint8 (B,H,W,3) RGB -> int32 (B,H,W) class IDs through `model`."""

    def __init__(self, model: nn.Module, mean: Sequence[float],
                 std: Sequence[float], dtype: torch.dtype):
        super().__init__()
        self.model = model
        self.dtype = dtype
        self.register_buffer("mean", torch.tensor(list(mean), dtype=torch.float32))
        self.register_buffer("std", torch.tensor(list(std), dtype=torch.float32))

    def forward(self, images_u8: torch.Tensor) -> torch.Tensor:
        x = (images_u8.float() / 255.0 - self.mean) / self.std
        logits, _ = self.model(x.to(self.dtype).permute(0, 3, 1, 2))
        return torch.argmax(logits, dim=1).to(torch.int32)


def make_serving_fn(model: nn.Module, mean: Sequence[float],
                    std: Sequence[float], dtype: torch.dtype = torch.float32
                    ) -> ServingModule:
    """uint8 RGB batch -> int32 class-ID masks, all in one module.

    Mirrors `cli/infer.py:Segmenter` on its "model" route (normalise in
    f32, cast, forward, argmax), so an artifact and the live module agree
    bit for bit at the same dtype on the same device. It holds a copy of
    `model` in `dtype` and eval mode; `model` itself is left as it is."""
    return ServingModule(copy.deepcopy(model).to(dtype), mean, std, dtype).eval()


def export_serving(model: nn.Module, *, mean: Sequence[float],
                   std: Sequence[float], imgsz: int = 1024,
                   batch: Union[int, str] = 1,
                   dtype: torch.dtype = torch.float32,
                   device: Union[str, torch.device] = "cuda"
                   ) -> torch.export.ExportedProgram:
    """Build the serving module on `device` and export it for uint8
    (batch, imgsz, imgsz, 3) input; a string `batch` names a symbolic
    batch dimension."""
    device = resolve_device(device)
    kernels = [m for m in model.modules()
               if isinstance(m, GlobalContextAttention) and m.attention == "kernel"]
    if kernels:
        raise ValueError("the serving artifact holds no kernel: build the model "
                         "with attention='einsum' (or 'plain')")
    serve = make_serving_fn(model, mean, std, dtype).to(device)
    symbolic = isinstance(batch, str)
    example = torch.zeros((2 if symbolic else int(batch), imgsz, imgsz, 3),
                          dtype=torch.uint8, device=device)
    dynamic = ({0: torch.export.Dim(batch, min=1)},) if symbolic else None
    return torch.export.export(serve, (example,), dynamic_shapes=dynamic)


def _device_type(program: torch.export.ExportedProgram) -> str:
    return next(iter(program.state_dict.values())).device.type


def save_artifact(program: torch.export.ExportedProgram,
                  out_dir: Union[str, Path], metadata: dict) -> Path:
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    torch.export.save(program, out / ARTIFACT_NAME)
    meta = dict(metadata)
    meta.setdefault("device", _device_type(program))
    (out / METADATA_NAME).write_text(json.dumps(meta, indent=2) + "\n")
    return out


def load_artifact(path: Union[str, Path],
                  device: Union[str, torch.device] = "cuda"
                  ) -> Tuple[Callable[[torch.Tensor], torch.Tensor], dict]:
    """(callable, metadata) of an artifact directory, or of a bare
    `serving.pt2`, which picks up the `metadata.json` beside it.

    The callable takes a uint8 (B,H,W,3) tensor on `device` and returns
    int32 (B,H,W) class IDs. Raises ValueError when the program was
    exported for another device type than `device`'s."""
    device = resolve_device(device)
    p = Path(path)
    blob, meta_file = ((p / ARTIFACT_NAME, p / METADATA_NAME) if p.is_dir()
                       else (p, p.parent / METADATA_NAME))
    # a bare artifact file usually still sits next to its metadata.json (the
    # cli.export layout): losing it would make consumers fall back to
    # unrelated defaults (imgsz, batch, palette)
    metadata = json.loads(meta_file.read_text()) if meta_file.exists() else {}
    exported_for = metadata.get("device")
    if exported_for is not None and exported_for != device.type:
        raise ValueError(f"{p}: the program was exported for {exported_for}, "
                         f"not {device.type}; export it again with --device "
                         f"{device.type}")
    program = torch.export.load(blob)
    if _device_type(program) != device.type:
        raise ValueError(f"{p}: the program's weights are on "
                         f"{_device_type(program)}, not {device.type}")
    return program.module(), metadata
