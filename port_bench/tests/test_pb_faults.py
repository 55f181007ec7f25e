"""A run with its timed path broken underneath comes out not correct:
the harness's look for a card is skipped and the rest of a run is driven
on the CPU at a tiny size, the program in float32 so that a sound run
reads only round-off, against the cells' real limits. One cell a chip
has no exchange between chips to leave out."""

import pytest

from port_bench.faults import FAULTS
from port_bench.tests import tiny

SERVE, TRAIN, EVAL = ("large-uavid-b16-1080p", "large-cityscapes-train-b32",
                      "large-cityscapes-eval-msc")


@pytest.mark.parametrize("workload", [SERVE, TRAIN, EVAL])
def test_a_sound_run_is_correct(tmp_path, workload):
    assert tiny.run(tmp_path, workload, f32=True)["correct"] is True


@pytest.mark.parametrize("workload,fault", [
    (SERVE, "altered_classes"), (SERVE, "half_the_batch_served"),
    (TRAIN, "state_unchanged"), (TRAIN, "half_the_batch_trained"), (TRAIN, "altered_loss"),
    (EVAL, "altered_probs"), (EVAL, "half_the_batch_scored"),
])
def test_a_broken_run_is_not_correct(tmp_path, monkeypatch, workload, fault):
    FAULTS[fault](monkeypatch.setattr)
    out = tiny.run(tmp_path, workload, f32=True)
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", [SERVE, TRAIN, EVAL])
def test_the_control_reads_above_a_sound_run(tmp_path, workload):
    """At the tiny size the float8 control reads well above the float32
    program; at the cells' own size it fails their limits (the card test
    below, PERF.md's readings)."""
    from port_bench.control import control_readings

    sound = tiny.run(tmp_path, workload, f32=True)["checks"]
    bd = tiny.make(tmp_path, f32=True)
    ctl = control_readings(workload, 7, tmp_path, "cpu", bd)
    assert any(ctl[k]["value"] > 3 * sound[k]["value"] for k in ctl)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [SERVE, TRAIN, EVAL])
def test_the_control_fails_at_the_cells_size(cuda, workload):
    from port_bench import harness
    from port_bench.control import control_readings

    ctl = control_readings(workload, 20260001, harness.BENCH_DIR.parent)
    assert any(c["value"] > c["limit"] for c in ctl.values()), ctl
