"""Nothing the benchmark runs loads JAX or the JAX package; the check
compares whole top-level names, so the port (`cabinet_tpu_torch`) passes."""

import subprocess
import sys

from port_bench import harness


def test_forbidden_names_are_whole_top_level_names():
    assert harness.forbidden_modules({"jax": 0, "os": 0}) == ["jax"]
    assert harness.forbidden_modules({"jaxlib.xla_client": 0}) == ["jaxlib"]
    assert harness.forbidden_modules({"flax.linen": 0}) == ["flax"]
    assert harness.forbidden_modules({"cabinet_tpu.models": 0}) == ["cabinet_tpu"]
    assert harness.forbidden_modules({"cabinet_tpu_torch.models": 0,
                                      "cabinet_tpu_torchvision": 0, "jaxtyping": 0}) == []


def test_the_harness_and_the_port_load_no_jax():
    code = ("import sys, port_bench.run, port_bench.control, port_bench.harness as h\n"
            "import port_bench.loops.serve_closed, port_bench.loops.train_pool\n"
            "import port_bench.loops.eval_msc\n"
            "import cabinet_tpu_torch.cli.infer, cabinet_tpu_torch.cli.train\n"
            "import cabinet_tpu_torch.cli.evaluate, cabinet_tpu_torch.eval.evaluator\n"
            "print(h.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.BENCH_DIR.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_a_directory_without_the_port_gives_no_result(tmp_path):
    import shutil

    shutil.copy(harness.BENCH_DIR.parent / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                          "large-uavid-b16-1080p", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=tmp_path,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
