"""Where a tensor-parallel rank's peak memory comes from: CABiNet-Large's
train forward and backward at batch 4, 1024^2, f32, TF32 off, whole (R=1)
and cut to one model rank's slices of a 1 x 2 mesh with its collectives
left out (a group of one rank: the shapes a rank runs, not its sums), the
transient memory each conv takes in its forward and backward.

    python3 tp_memory.py     # on a CUDA card; prints one line a run, then OK

`--variants` runs a 1 x 2 rank's step (and R=1's) once a child process
for each setting of `models/tensor_parallel.py:SHARDED_CUDNN`, the
cuDNN flags its sharded convs run under in both directions (`unbounded`:
none, cuDNN's heuristic as it is; `deterministic`: cuDNN's deterministic
algorithms; `no_cudnn`: the port's), one JSON line each: the step's peak, its ms (CUDA events,
the median of 2 after two warm-ups) and the head conv's transients.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from cabinet_tpu_torch.core import mesh  # noqa: E402
from cabinet_tpu_torch.models.cabinet import CABiNet  # noqa: E402
from cabinet_tpu_torch.models.tensor_parallel import tensor_parallel  # noqa: E402
from cabinet_tpu_torch.train.trainer import einsum_attention  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
dev = torch.device("cuda")
G = 2 ** 30


def hooks(model, out):
    hs = []
    for name, m in model.named_modules():
        if isinstance(m, torch.nn.Conv2d):
            def pre(mod, inp, name=name):
                torch.cuda.synchronize()
                out.setdefault("_base", {})[name] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()

            def post(mod, inp, res, name=name):
                torch.cuda.synchronize()
                out.setdefault("fwd", {})[name] = (torch.cuda.max_memory_allocated()
                                                   - out["_base"][name]) / G

            def bpre(mod, gout, name=name):
                torch.cuda.synchronize()
                out.setdefault("_bbase", {})[name] = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()

            def bpost(mod, gin, gout, name=name):
                torch.cuda.synchronize()
                out.setdefault("bwd", {})[name] = (torch.cuda.max_memory_allocated()
                                                   - out["_bbase"][name]) / G
            hs += [m.register_forward_pre_hook(pre), m.register_forward_hook(post),
                   m.register_full_backward_pre_hook(bpre), m.register_full_backward_hook(bpost)]
    return hs


def run(tp: bool, benchmark: bool):
    torch.backends.cudnn.benchmark = benchmark
    torch.manual_seed(0)
    model = CABiNet(19, mode="large")
    if tp:
        tensor_parallel(model, mesh.Mesh(1, 2, 0, mesh.SELF, mesh.SELF), 256)
    model.to(dev).train()
    x = torch.randn(4, 3, 1024, 1024, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with einsum_attention(model):
        final, aux = model(x)
    torch.cuda.synchronize()
    fwd_peak = torch.cuda.max_memory_allocated() / G
    (final.float().square().mean() + aux.float().square().mean()).backward()
    torch.cuda.synchronize()
    whole_peak = torch.cuda.max_memory_allocated() / G
    per = {}
    hs = hooks(model, per)
    model.zero_grad(set_to_none=True)
    with einsum_attention(model):
        final, aux = model(x)
    (final.float().square().mean() + aux.float().square().mean()).backward()
    for h in hs:
        h.remove()
    top = {k: sorted(per[k].items(), key=lambda kv: -kv[1])[:5] for k in ("fwd", "bwd")}
    print(f"tp={tp} benchmark={benchmark}: forward peak {fwd_peak:.3f} GiB, step peak "
          f"{whole_peak:.3f} GiB; largest transients {top}", flush=True)
    del model, x, final, aux
    torch.cuda.empty_cache()


def variant_step(variant: str) -> dict:
    """One step's peak and ms under `variant` (see the module docstring)."""
    import statistics

    from cabinet_tpu_torch.models import tensor_parallel as tp

    tp.SHARDED_CUDNN = VARIANTS[variant]
    torch.manual_seed(0)
    model = CABiNet(19, mode="large")
    if variant != "r1":
        tensor_parallel(model, mesh.Mesh(1, 2, 0, mesh.SELF, mesh.SELF), 256)
    model.to(dev).train()
    x = torch.randn(4, 3, 1024, 1024, device=dev)
    per: dict = {}
    times = []
    for i in range(4):
        hs = hooks(model, per) if i == 1 else []
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        if i == 0:
            torch.cuda.reset_peak_memory_stats()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        with einsum_attention(model):
            final, aux = model(x)
        (final.float().square().mean() + aux.float().square().mean()).backward()
        b.record()
        torch.cuda.synchronize()
        if i == 0:
            peak = torch.cuda.max_memory_allocated() / G
        elif i > 1:
            times.append(a.elapsed_time(b))
        for h in hs:
            h.remove()
    head = "conv_out.conv.conv"
    return {"variant": variant, "step_peak_gib": peak, "ms": statistics.median(times),
            "head_fwd_gib": per["fwd"][head], "head_bwd_gib": per["bwd"][head],
            "largest_fwd": sorted(per["fwd"].items(), key=lambda kv: -kv[1])[:3],
            "largest_bwd": sorted(per["bwd"].items(), key=lambda kv: -kv[1])[:3]}


VARIANTS = {"r1": {}, "unbounded": {}, "deterministic": {"enabled": True, "deterministic": True},
            "no_cudnn": {"enabled": False}}


if __name__ == "__main__" and sys.argv[1:2] == ["--variant"]:
    print(json.dumps(variant_step(sys.argv[2])), flush=True)
elif __name__ == "__main__" and sys.argv[1:2] == ["--variants"]:
    print(torch.cuda.get_device_name(0), torch.__version__, torch.backends.cudnn.version(),
          flush=True)
    for name in VARIANTS:
        out = subprocess.run([sys.executable, __file__, "--variant", name],
                             capture_output=True, text=True)
        print(out.stdout.strip() or f"{name}: exit {out.returncode} {out.stderr[-800:]}",
              flush=True)
    print("OK")
elif __name__ == "__main__":
    print(torch.cuda.get_device_name(0), torch.__version__, torch.backends.cudnn.version(),
          flush=True)
    for tp in (False, True):
        run(tp, False)
    run(True, True)
    print("OK")
