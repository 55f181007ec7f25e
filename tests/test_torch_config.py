"""The port's config composition (cabinet_tpu_torch.core.config, and the YAML
subset reader under it) against the JAX package's (PyYAML): every file under
configs/, `compose` over a table of override sets, the two number rules
(YAML 1.2 floats in the files, YAML 1.1 on the command line), and the
errors."""

import math
from pathlib import Path

import pytest
import yaml

from cabinet_tpu.cli.common import CONFIG_DIR
from cabinet_tpu.core import config as jconfig
from cabinet_tpu.core.exceptions import ConfigurationError as JConfigurationError
from cabinet_tpu_torch.cli import common
from cabinet_tpu_torch.core import config, yaml_subset
from cabinet_tpu_torch.core.exceptions import ConfigurationError

CONFIG_FILES = sorted(Path(CONFIG_DIR).rglob("*.yaml"))


def test_config_dir_is_the_repos():
    assert common.CONFIG_DIR == Path(CONFIG_DIR)
    assert len(CONFIG_FILES) >= 30


@pytest.mark.parametrize("path", CONFIG_FILES,
                         ids=[str(p.relative_to(CONFIG_DIR)) for p in CONFIG_FILES])
def test_every_config_file_reads_as_jax_reads_it(path):
    ours = config.load_yaml(path)
    ref = jconfig._load_yaml(path)
    assert ours == ref
    assert _types(ours) == _types(ref)


def _types(tree):
    """The tree with every leaf replaced by its type (1 == 1.0 == True)."""
    if isinstance(tree, dict):
        return {k: _types(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_types(v) for v in tree]
    return type(tree)


# value text -> what an override's value must be, as yaml.safe_load reads it
OVERRIDE_VALUES = [
    "5e-3", "1e-4", "1.0e5", "1.5", "-1", "+1", "0x1F", "017", "0b101", "1_000",
    "1:30", ".5", ".inf", "-.inf", "~", "null", "", "true", "True", "yes", "Off",
    "[0.75,1.25]", "[[3,1,16,1,0,2],[3,4.5,24,0,0,2]]", "[]", "[a, 'b', \"c\"]",
    "'x'", '"a\\tb"', "/tmp/a/b.pth", "a: b", "- a", "foo # c", "foo#c",
    "[1, 2,]", "  5", "a:b", "http://x:8080/y", "'it''s'", "${oc.env:X,''}",
    "a b c", "--", "-foo", "0", "00", "08", "1.", "._5", "+.5", "[1, [2, [3]]]",
    "bfloat16", "float32",
    # not YAML: the JAX package keeps the text
    "[1, 2", "'open", "a: b: c",
]


@pytest.mark.parametrize("text", OVERRIDE_VALUES)
def test_override_values_read_as_yaml_safe_load(text):
    ref = jconfig._parse_override_value(text)
    got = config.parse_override_value(text)
    assert type(got) is type(ref)
    assert got == ref or (isinstance(ref, float) and math.isnan(ref) and math.isnan(got))


@pytest.mark.parametrize("text", ["5e-3", "1e4", "-2E+2", "1.0e5", "._5", ".nan"])
def test_file_floats_are_yaml_12(text):
    ref = yaml.load(f"k: {text}\n", Loader=jconfig._Loader)["k"]
    got = yaml_subset.load(f"k: {text}\n", yaml12_floats=True)["k"]
    assert isinstance(got, float) and type(got) is type(ref)
    assert got == ref or (math.isnan(ref) and math.isnan(got))


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n", "a: !!str 5\n", "a: {b: 1}\n", "a: |\n  text\n",
    "a: >\n  text\n", "a: 2020-01-01\n", "a: plain\n  continued\n",
    "%YAML 1.1\n---\na: 1\n", "a: 1\n---\nb: 2\n", "a:\n\t- 1\n", "? a\n: 1\n",
    "a: [b: 1]\n", "a: [1,\n  2]\n", "a: \"multi\n  line\"\n",
])
def test_constructs_outside_the_subset_raise(text):
    with pytest.raises(ConfigurationError):
        yaml_subset.load(text, yaml12_floats=True)


def test_block_structure_matches_pyyaml():
    text = """
# comment
top:
  - a
  - key: v   # comment
    other: [1, [2, 3]]
  -
    - nested
  - 'quoted # not a comment'
indentless:
- 1
- two
empty:
"quoted key": 3
0: zero
nested:
  deeper:
    deepest: ~
"""
    assert yaml_subset.load(text, yaml12_floats=True) == yaml.load(text, Loader=jconfig._Loader)


def _env(monkeypatch, set_env):
    for var in ("UAVID_YOLO_ROOT", "CITYSCAPES_ROOT", "AEROSCAPES_YOLO_ROOT",
                "VDD_YOLO_ROOT"):
        if set_env:
            monkeypatch.setenv(var, f"/data/{var.lower()}")
        else:
            monkeypatch.delenv(var, raising=False)


COMPOSE_CASES = [
    ("evaluate", ["checkpoint_path=/x/ck.pth"]),
    ("evaluate", ["checkpoint_path=/x/ck.pth", "dataset=uavid", "model=mobilenetv3_small"]),
    ("evaluate", ["checkpoint_path=a.npz", "dataset=aeroscapes",
                  "+runtime.tile_parallel_eval=false",
                  "validation_config.eval_scales=[0.75,1.25]",
                  "validation_config.eval_pad_to=[2160,4096]", "split=test",
                  "runtime.compute_dtype=bfloat16", "runtime.use_pallas=true",
                  "validation_config.flip=false"]),
    ("evaluate", ["checkpoint_path=a", "model.cfgs=[[3,1,16,1,0,2],[3,4.5,24,0,0,2]]",
                  "validation_config.eval_pad_to=~", "+runtime.quantize=int8",
                  "dataset.dataset_path=/somewhere"]),
    ("train", []),
    ("train", ["training_config.optimizer_lr_start=5e-3",
               "training_config.warmup_start_lr=1e-4", "dataset=vdd",
               "dataset.cropsize=[512,512]", "+new.nested.key=3"]),
    ("train", ["dataset=cityscapes", "training_config.max_iterations=100",
               "runtime.remat=2", "validation_config.eval_scales=[1.0]"]),
    ("train_yolo", []),
    ("train_yolo", ["yolo/model@model=yolo26s-sem", "dataset=vdd"]),
    ("train_yolo_aeroscapes", ["training_config.epochs=3"]),
    ("train_yolo_vdd", ["dataset=uavid"]),
]


@pytest.mark.parametrize("set_env", [False, True], ids=["env_unset", "env_set"])
@pytest.mark.parametrize("name,overrides", COMPOSE_CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(COMPOSE_CASES)])
def test_compose_matches_jax(monkeypatch, set_env, name, overrides):
    _env(monkeypatch, set_env)
    ref = jconfig.compose(CONFIG_DIR, name, overrides)
    got = config.compose(CONFIG_DIR, name, overrides)
    assert got.to_dict(resolve=False) == ref.to_dict(resolve=False)
    assert got.to_dict(resolve=True) == ref.to_dict(resolve=True)
    assert _types(got.to_dict(resolve=True)) == _types(ref.to_dict(resolve=True))
    # the access paths a CLI uses
    assert got.dataset.name == ref.dataset.name
    assert got.select("dataset.dataset_path") == ref.select("dataset.dataset_path")
    assert got.select("runtime.nope", "d") == ref.select("runtime.nope", "d") == "d"
    assert got.get("nope", 7) == ref.get("nope", 7) == 7
    assert list(got.dataset.cropsize) == list(ref.dataset.cropsize)
    assert got["dataset"]["ignore_idx"] == ref["dataset"]["ignore_idx"]


def test_command_line_numbers_stay_yaml_11(monkeypatch):
    cfg = config.compose(CONFIG_DIR, "train", ["training_config.optimizer_lr_start=5e-3"])
    assert cfg.training_config.optimizer_lr_start == "5e-3"
    assert config.compose(CONFIG_DIR, "train").training_config.optimizer_lr_start == 0.005


ERROR_CASES = [
    ("evaluate", [], "resolve"),                        # checkpoint_path: ???
    ("evaluate", ["checkpoint_path=a", "validation_config.nope=1"], "compose"),
    ("evaluate", ["checkpoint_path=a", "nope.deeper=1"], "compose"),
    ("evaluate", ["checkpoint_path=a", "dataset=nonexistent"], "compose"),
    ("evaluate", ["noequals"], "compose"),
    ("nonexistent", [], "compose"),
    ("evaluate", ["checkpoint_path=${nope.key}"], "resolve"),
    ("evaluate", ["checkpoint_path=${oc.env:CABINET_UNSET_VAR}"], "resolve"),
]


@pytest.mark.parametrize("name,overrides,when", ERROR_CASES,
                         ids=[f"{i}-{w}" for i, (_, _, w) in enumerate(ERROR_CASES)])
def test_errors_match_jax(monkeypatch, name, overrides, when):
    monkeypatch.delenv("CABINET_UNSET_VAR", raising=False)
    with pytest.raises(JConfigurationError):
        jconfig.compose(CONFIG_DIR, name, overrides).to_dict(resolve=True)
    with pytest.raises(ConfigurationError):
        cfg = config.compose(CONFIG_DIR, name, overrides)
        assert when == "resolve"
        cfg.to_dict(resolve=True)


def test_missing_value_raises_on_access():
    cfg = config.compose(CONFIG_DIR, "evaluate")
    with pytest.raises(ConfigurationError, match="checkpoint_path"):
        cfg.checkpoint_path
    with pytest.raises(AttributeError):
        cfg.nope
