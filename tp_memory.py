"""Where a tensor-parallel rank's peak memory comes from: CABiNet-Large's
train forward and backward at batch 4, 1024^2, f32, TF32 off, whole (R=1)
and cut to one model rank's slices of a 1 x 2 mesh with its collectives
left out (a group of one rank: the shapes a rank runs, not its sums), the
transient memory each conv takes in its forward and backward.

    python3 tp_memory.py     # on a CUDA card; prints one line a run, then OK
"""
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


if __name__ == "__main__":
    print(torch.cuda.get_device_name(0), torch.__version__, torch.backends.cudnn.version(),
          flush=True)
    for tp in (False, True):
        run(tp, False)
    run(True, True)
    print("OK")
