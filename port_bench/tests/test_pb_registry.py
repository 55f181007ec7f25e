"""Cells, configurations, traffic mixes and per-layer metrics are found by
name, and a new one is added by files and entries alone."""

import json

import pytest

from port_bench import harness


def test_every_cell_finds_its_files():
    bench = harness.benchmark(harness.BENCH_DIR.parent)
    for w in bench["workloads"]:
        cfg = harness.config_of(w["config"])
        traffic = harness.traffic_of(w["traffic"])
        assert cfg["name"] == w["config"]
        assert hasattr(harness.loop_of(traffic), "Loop")
        assert (harness.BENCH_DIR / "limits" / f"{w['name']}.json").is_file()
    for m in bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_metrics_of_cell_follow_their_workloads():
    bench = harness.benchmark(harness.BENCH_DIR.parent)
    serve = {m["name"] for m in harness.metrics_of_cell(bench, "end_to_end",
                                                        "large-uavid-b16-1080p")}
    assert serve == {"frames_per_s", "peak_mem_gib", "setup_s"}
    layer = {m["name"] for m in harness.metrics_of_cell(bench, "per_layer",
                                                        "large-cityscapes-train-b32")}
    assert layer == {"device_idle.train", "mfu.train", "device_aug_ms.train"}


def test_a_metric_added_as_a_file_is_found(tmp_path):
    (tmp_path / "metrics").mkdir()
    (tmp_path / "metrics" / "queue_depth.py").write_text(
        "def read(ctx):\n    return 2.0 * ctx\n")
    assert harness.metric_reader("queue_depth.serve", tmp_path)(3) == 6.0
    assert harness.metric_reader("queue_depth", tmp_path)(1) == 2.0
    with pytest.raises(KeyError):
        harness.metric_reader("absent.serve", tmp_path)


def test_a_cell_added_as_files_and_an_entry_is_found(tmp_path):
    bench = harness.benchmark(harness.BENCH_DIR.parent)
    for sub in ("configs", "traffic"):
        (tmp_path / sub).mkdir()
    cfg = dict(harness.config_of("cabinet-large-uavid"), name="cabinet-large-uavid-4k")
    (tmp_path / "configs" / "cabinet-large-uavid-4k.json").write_text(json.dumps(cfg))
    tr = dict(harness.traffic_of("serve-b16-1080p"), frame_hw=[2160, 3840])
    (tmp_path / "traffic" / "serve-b16-4k.json").write_text(json.dumps(tr))
    bench["workloads"].append({"name": "large-uavid-b16-4k", "config": "cabinet-large-uavid-4k",
                               "traffic": "serve-b16-4k", "chips": 1, "why": "4K frames"})
    cell = harness.cell_of(bench, "large-uavid-b16-4k")
    assert harness.config_of(cell["config"], tmp_path)["name"] == "cabinet-large-uavid-4k"
    assert harness.traffic_of(cell["traffic"], tmp_path)["frame_hw"] == [2160, 3840]
    assert harness.loop_of(tr).__name__.endswith("serve_closed")
