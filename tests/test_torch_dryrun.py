"""The port's analogue of the JAX package's `__graft_entry__.py:
dryrun_multichip` (`cabinet_tpu_torch/cli/dryrun_multichip.py`), run as a
user runs it, `python -m cabinet_tpu_torch.cli.dryrun_multichip --device
cpu --ranks N`, in a subprocess under a time limit: it starts its own N
gloo ranks and takes one finite step of every strategy (DP with accum 2,
device augmentation with the exact and the shared warp, tile-sharded eval
whose matrix sums to the 80x72 frame, TP on an (N/2, 2) mesh with its
model-sharded eval's matrix bit-equal to the replicated one, SP at batch
1, the 2-stage pipeline plain and with device augmentation, PP x TP and
YOLO-sem's 3 stages); and without a CUDA device, `--device cuda`
refuses with exit code 2."""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
STRATEGIES = ("dp_accum2", "device_aug_exact", "device_aug_shared", "tile_sharded_eval",
              "tensor_parallel", "spatial_parallel", "pipeline_2_stages",
              "pipeline_device_aug", "pipeline_x_tensor_parallel", "yolosem_3_stages")


@pytest.mark.parametrize("ranks", [2, 4])
def test_dryrun_runs_every_strategy_on_cpu_ranks(ranks):
    proc = subprocess.run([sys.executable, "-m", "cabinet_tpu_torch.cli.dryrun_multichip",
                           "--device", "cpu", "--ranks", str(ranks)], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    got = [ln.split(":")[0].split()[1] for ln in lines[:-1]]
    assert tuple(got) == STRATEGIES, lines
    assert all(": ok " in ln for ln in lines[:-1]), lines
    assert lines[-1].startswith(f"dryrun_multichip OK: ranks={ranks} device=cpu backend=gloo "
                                f"strategies={len(STRATEGIES)}")
    assert '"hist_sum": 5760' in lines[3] and '"rows": ' in lines[5]


def test_dryrun_without_cuda_refuses(monkeypatch, capsys):
    from cabinet_tpu_torch.cli import dryrun_multichip

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun_multichip.main(["--ranks", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
