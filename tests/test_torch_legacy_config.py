"""The port's legacy JSON migration (cabinet_tpu_torch.core.legacy_config)
against the JAX package's: both shipped JSONs (legacy/train_*.json) compose
to the tree JAX's `load_legacy_config` gives (the same `to_yaml`, read
back), with the reference schema's quirks; the overrides are the same
strings; unknown keys, missing sections, bad JSON and a missing file are
rejected as JAX rejects them; `--legacy-config` runs through `parse_cli`
and train main."""

import json

import pytest
import yaml

from cabinet_tpu.cli import common as jcommon
from cabinet_tpu.core.config import to_yaml as jto_yaml
from cabinet_tpu.core.exceptions import ConfigurationError as JConfigurationError
from cabinet_tpu.core.legacy_config import legacy_to_overrides as jlegacy_to_overrides
from cabinet_tpu.core.legacy_config import load_legacy_config as jload
from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.core.config import to_yaml
from cabinet_tpu_torch.core.exceptions import ConfigurationError
from cabinet_tpu_torch.core.legacy_config import legacy_to_overrides, load_legacy_config

LEGACY = common.REPO_ROOT / "legacy"
SHIPPED = ["train_uavid.json", "train_citys.json"]


def _tree(text):
    return yaml.safe_load(text)


@pytest.mark.parametrize("name", SHIPPED)
@pytest.mark.parametrize("extra", [[], ["training_config.batch_size=2", "dataset=vdd"]],
                         ids=["plain", "extra_overrides"])
def test_shipped_json_composes_to_jax_tree(name, extra):
    ours = load_legacy_config(LEGACY / name, extra_overrides=extra)
    ref = jload(LEGACY / name, extra_overrides=extra)
    assert _tree(to_yaml(ours)) == _tree(jto_yaml(ref))
    assert ours.to_dict(resolve=False) == ref.to_dict(resolve=False)


@pytest.mark.parametrize("name", SHIPPED)
def test_overrides_are_jaxs(name):
    data = json.loads((LEGACY / name).read_text())
    assert legacy_to_overrides(data) == jlegacy_to_overrides(data)


def test_quirks_kept():
    """warmup_stemps and msg_iterations map, gpu_id and shuffle are
    ignored, an empty dataset_path keeps the env resolver, and the small
    floats come back floats."""
    cfg = load_legacy_config(LEGACY / "train_uavid.json")
    assert cfg.training_config.warmup_steps == 3000
    assert cfg.training_config.log_iter == 200
    assert "oc.env" in cfg.dataset._data["dataset_path"]
    assert isinstance(cfg.training_config.warmup_start_lr, float)
    ovs = legacy_to_overrides(json.loads((LEGACY / "train_uavid.json").read_text()))
    assert not any(o.split("=")[0].endswith(("gpu_id", "shuffle")) for o in ovs)
    assert "training_config.warmup_start_lr=0.00001" in ovs
    cfg = load_legacy_config(LEGACY / "train_citys.json")
    assert cfg.model.mode == "large" and cfg.training_config.warmup_steps == 4000


def _bad_files(tmp_path):
    data = json.loads((LEGACY / "train_uavid.json").read_text())
    data["training_config"]["definitely_not_a_key"] = 1
    (tmp_path / "unknown.json").write_text(json.dumps(data))
    (tmp_path / "nosection.json").write_text(json.dumps({"dataset_config": {"name": "uavid"}}))
    (tmp_path / "bad.json").write_text("{not json")
    data = json.loads((LEGACY / "train_uavid.json").read_text())
    data["dataset_config"]["name"] = ""
    (tmp_path / "noname.json").write_text(json.dumps(data))


@pytest.mark.parametrize("case,match", [("unknown.json", "unknown legacy key"),
                                        ("nosection.json", "missing required section"),
                                        ("bad.json", "not valid JSON"),
                                        ("noname.json", "name is required"),
                                        ("absent.json", "not found")])
def test_rejected_as_jax_rejects(tmp_path, case, match):
    _bad_files(tmp_path)
    with pytest.raises(JConfigurationError, match=match) as ref:
        jload(tmp_path / case)
    with pytest.raises(ConfigurationError, match=match) as got:
        load_legacy_config(tmp_path / case)
    assert str(got.value).split(":")[0] == str(ref.value).split(":")[0]


def test_cli_flag_routes_through_legacy_loader():
    argv = ["--legacy-config", str(LEGACY / "train_citys.json"),
            "training_config.num_workers=0", "--device", "cpu"]
    cfg, args = common.parse_cli(argv, "train", "test")
    jcfg, _ = jcommon.parse_cli(argv[:-2], "train", "test")
    assert args.legacy_config and args.device == "cpu"
    assert cfg.training_config.num_workers == 0
    assert _tree(to_yaml(cfg)) == _tree(jto_yaml(jcfg))
