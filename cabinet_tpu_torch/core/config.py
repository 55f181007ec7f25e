"""Hydra/OmegaConf-style configuration (counterpart of
`cabinet_tpu.core.config`), reading the repo's `configs/` as data.

The same subset of Hydra as the JAX package:
- YAML config trees with a ``defaults:`` composition list (including ``_self_``
  ordering and ``group@key: name`` entries, and root-config inheritance),
- config-group selection from the CLI (``dataset=uavid``),
- dotted-path overrides (``optimizer.lr_start=0.01``), with ``+key=v`` to add
  new keys; an unknown key raises `ConfigurationError`,
- mandatory values (``???``) that raise `ConfigurationError` on access,
- ``${a.b}`` interpolation and ``${oc.env:VAR,default}`` env resolvers.

YAML is read by `core.yaml_subset`, not PyYAML, with the JAX package's two
number rules: a config file reads `5e-3` as a float (YAML 1.2 floats, as
`cabinet_tpu.core.config._Loader` adds them), while an override value is read
as `yaml.safe_load` reads it (YAML 1.1), so `training_config.lr=5e-3` on the
command line stays the string "5e-3". An override value that is not YAML at
all (an unclosed `[`) stays the text it was, as in the JAX package.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

from cabinet_tpu_torch.core import yaml_subset
from cabinet_tpu_torch.core.exceptions import ConfigurationError

MISSING = "???"

_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


class Config:
    """Attribute/keyed access over a nested dict, with interpolation on read."""

    def __init__(self, data: Optional[Dict[str, Any]] = None, _root: Optional["Config"] = None):
        object.__setattr__(self, "_data", data if data is not None else {})
        object.__setattr__(self, "_root", _root)

    # -- plumbing ---------------------------------------------------------
    def _root_cfg(self) -> "Config":
        return self._root if self._root is not None else self

    def _wrap(self, value: Any) -> Any:
        if isinstance(value, dict):
            return Config(value, _root=self._root_cfg())
        return value

    def _resolve_value(self, value: Any, key_path: str = "") -> Any:
        if isinstance(value, str):
            if value == MISSING:
                raise ConfigurationError(
                    f"Missing mandatory value for key '{key_path}' (set it via an override)"
                )
            return _interpolate(value, self._root_cfg())
        return value

    # -- mapping protocol --------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            return self[name]
        except KeyError:
            raise AttributeError(f"Config has no key '{name}'") from None

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = _unwrap(value)

    def __getitem__(self, key: str) -> Any:
        value = self._data[key]
        if isinstance(value, dict):
            return self._wrap(value)
        if isinstance(value, list):
            return [self._wrap(self._resolve_value(v, key)) for v in value]
        return self._resolve_value(value, key)

    def __setitem__(self, key: str, value: Any) -> None:
        self._data[key] = _unwrap(value)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __eq__(self, other: object) -> bool:
        if isinstance(other, Config):
            return self._data == other._data
        if isinstance(other, dict):
            return self._data == other
        return NotImplemented

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def keys(self):
        return self._data.keys()

    def items(self):
        return [(k, self[k]) for k in self._data]

    def values(self):
        return [self[k] for k in self._data]

    def get(self, key: str, default: Any = None) -> Any:
        if key not in self._data:
            return default
        return self[key]

    def select(self, dotted: str, default: Any = None) -> Any:
        """Fetch a dotted path; returns default when any segment is absent."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Config) or part not in node:
                return default
            node = node[part]
        return node

    def to_dict(self, resolve: bool = True) -> Dict[str, Any]:
        """Plain-dict copy; with resolve=True interpolations are expanded."""
        if not resolve:
            return copy.deepcopy(self._data)
        return _resolve_tree(self._data, self._root_cfg(), "")


def _unwrap(value: Any) -> Any:
    if isinstance(value, Config):
        return value._data
    return value


def _resolve_tree(node: Any, root: Config, path: str) -> Any:
    if isinstance(node, dict):
        return {k: _resolve_tree(v, root, f"{path}.{k}" if path else k) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_tree(v, root, path) for v in node]
    if isinstance(node, str):
        if node == MISSING:
            raise ConfigurationError(f"Missing mandatory value for key '{path}'")
        return _interpolate(node, root)
    return node


_INDEX_RE = re.compile(r"^([^\[\]]+)((?:\[\d+\])*)$")


def _lookup(root: Config, dotted: str) -> Any:
    node: Any = root
    for part in dotted.split("."):
        m = _INDEX_RE.match(part)
        if not m:
            raise ConfigurationError(f"Interpolation key not found: '{dotted}'")
        key, idx_part = m.group(1), m.group(2)
        if not isinstance(node, Config) or key not in node:
            raise ConfigurationError(f"Interpolation key not found: '{dotted}'")
        node = node[key]
        for idx in re.findall(r"\[(\d+)\]", idx_part):
            try:
                node = node[int(idx)]
            except (IndexError, TypeError) as e:
                raise ConfigurationError(
                    f"Interpolation key not found: '{dotted}'") from e
    return node


def _interpolate(value: str, root: Config, depth: int = 0) -> Any:
    if depth > 10:
        raise ConfigurationError(f"Interpolation loop while resolving: {value!r}")
    full = _INTERP_RE.fullmatch(value)
    if full:
        return _resolve_ref(full.group(1), root, depth)
    return _INTERP_RE.sub(lambda m: str(_resolve_ref(m.group(1), root, depth)), value)


def _resolve_ref(ref: str, root: Config, depth: int) -> Any:
    ref = ref.strip()
    if ref.startswith("oc.env:") or ref.startswith("env:"):
        payload = ref.split(":", 1)[1]
        if "," in payload:
            var, default = payload.split(",", 1)
            default = default.strip()
            if (len(default) >= 2 and default[0] == default[-1]
                    and default[0] in "'\""):
                default = default[1:-1]
            return os.environ.get(var.strip(), default)
        return _require_env(payload.strip())
    value = _lookup(root, ref)
    if isinstance(value, str):
        return _interpolate(value, root, depth + 1)
    return value


def _require_env(var: str) -> str:
    if var not in os.environ:
        raise ConfigurationError(f"Environment variable '{var}' is not set")
    return os.environ[var]


# ---------------------------------------------------------------------------
# Composition
# ---------------------------------------------------------------------------


def load_yaml(path: Path) -> Dict[str, Any]:
    """A config file's tree (YAML 1.2 floats, as the JAX package loads it)."""
    if not path.is_file():
        raise ConfigurationError(f"Config file not found: {path}")
    data = yaml_subset.load(path.read_text(), yaml12_floats=True)
    if data is None:
        return {}
    if not isinstance(data, dict):
        raise ConfigurationError(f"Config root must be a mapping: {path}")
    return data


def _deep_merge(base: Dict[str, Any], over: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(base)
    for k, v in over.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _set_dotted(tree: Dict[str, Any], dotted: str, value: Any, allow_new: bool) -> None:
    parts = dotted.split(".")
    node = tree
    for part in parts[:-1]:
        if part not in node or not isinstance(node[part], dict):
            if not allow_new and part not in node:
                raise ConfigurationError(
                    f"Override key '{dotted}' not found (use +{dotted}=... to add new keys)"
                )
            node[part] = {}
        node = node[part]
    leaf = parts[-1]
    if not allow_new and leaf not in node:
        raise ConfigurationError(
            f"Override key '{dotted}' not found (use +{dotted}=... to add new keys)"
        )
    node[leaf] = value


def parse_override_value(text: str) -> Any:
    """An override's value as `yaml.safe_load` reads it (YAML 1.1); text
    that is not YAML stays as it is."""
    try:
        return yaml_subset.load(text)
    except yaml_subset.YamlSyntaxError:
        return text


def _parse_defaults_entry(entry: Any) -> Optional[Tuple[str, str, Optional[str]]]:
    """Returns (group, name, target_key) or None for `_self_`.
    group == "" means a sibling ROOT config (inheritance)."""
    if entry == "_self_":
        return None
    if isinstance(entry, str):
        # "group/name" shorthand
        if "/" in entry:
            group, name = entry.rsplit("/", 1)
            return (group, name, group)
        # bare name: inherit another root config from the same directory
        return ("", entry, None)
    if isinstance(entry, dict) and len(entry) == 1:
        (key, name), = entry.items()
        if name is None:
            raise ConfigurationError(f"Defaults entry has no value: {entry!r}")
        if "@" in key:
            group, target = key.split("@", 1)
        else:
            group, target = key, key.split("/")[-1]
        return (group, str(name), target)
    raise ConfigurationError(f"Unsupported defaults entry: {entry!r}")


def compose(
    config_dir: Union[str, Path],
    config_name: str,
    overrides: Optional[Sequence[str]] = None,
) -> Config:
    """Compose a config the way `@hydra.main` would (subset semantics).

    Group selections in `overrides` (e.g. ``dataset=uavid``) replace the defaults
    entry for that group; everything else is applied as a dotted-path override
    after composition, in order.
    """
    config_dir = Path(config_dir)
    overrides = list(overrides or [])

    root_raw = load_yaml(config_dir / f"{config_name}.yaml")
    defaults = root_raw.pop("defaults", [])

    # Split CLI overrides into group selections vs value overrides.
    group_dirs = {e[0] for e in map(_parse_defaults_entry, defaults) if e is not None}
    group_sel: Dict[str, str] = {}
    value_overrides: List[Tuple[str, Any, bool]] = []
    for ov in overrides:
        if "=" not in ov:
            raise ConfigurationError(f"Malformed override (expected key=value): {ov!r}")
        key, _, raw_val = ov.partition("=")
        allow_new = key.startswith("+")
        key = key.lstrip("+")
        group_key = key.split("@", 1)[0]  # "yolo/model@model" selects group "yolo/model"
        is_group = (
            "." not in key
            and not allow_new
            and (group_key in group_dirs or (config_dir / group_key).is_dir())
        )
        if is_group:
            group_sel[group_key] = raw_val
        else:
            value_overrides.append((key, parse_override_value(raw_val), allow_new))

    merged: Dict[str, Any] = {}
    self_seen = False
    for entry in defaults:
        parsed = _parse_defaults_entry(entry)
        if parsed is None:
            merged = _deep_merge(merged, root_raw)
            self_seen = True
            continue
        group, name, target = parsed
        if group == "":
            # Root-config inheritance: recursively compose the parent
            # (propagating the remaining group selections into it).
            parent = compose(config_dir, name,
                             [f"{g}={n}" for g, n in group_sel.items()])
            merged = _deep_merge(merged, parent.to_dict(resolve=False))
            continue
        if group in group_sel:
            name = group_sel.pop(group)
        group_cfg = load_yaml(config_dir / group / f"{name}.yaml")
        group_cfg.pop("defaults", None)
        placed: Dict[str, Any] = group_cfg
        if target:
            for part in reversed(target.split("/")):
                placed = {part: placed}
        merged = _deep_merge(merged, placed)
    if not self_seen:
        merged = _deep_merge(merged, root_raw)
    for group, name in group_sel.items():
        group_cfg = load_yaml(config_dir / group / f"{name}.yaml")
        group_cfg.pop("defaults", None)
        merged = _deep_merge(merged, {group: group_cfg})

    for key, value, allow_new in value_overrides:
        _set_dotted(merged, key, value, allow_new)

    return Config(merged)


def to_yaml(cfg: Config, resolve: bool = False) -> str:
    """The config as YAML text (`core.yaml_subset.dump`), interpolations
    expanded with `resolve=True`: `yaml.safe_load` of it gives the tree of
    `cabinet_tpu.core.config.to_yaml`, and `load_yaml`/`compose` read it back."""
    return yaml_subset.dump(cfg.to_dict(resolve=resolve))


def save_config(cfg: Config, path: Union[str, Path], resolve: bool = True) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(to_yaml(cfg, resolve=resolve))
