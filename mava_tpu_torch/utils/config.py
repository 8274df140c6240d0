"""YAML config composition with group swaps and strict CLI overrides.

Port of `mava_tpu/utils/config.py` without JAX: the same composition rules over
the port's own copy of the JAX package's YAML tree, `mava_tpu_torch/configs/`
(file for file the same), read as data by path.

  * `configs/default_<system>.yaml` declares `defaults:` (group -> option); each
    option loads `configs/<group>/<option>.yaml` into `cfg.<group>`, and an env
    group file may pull in `configs/env/scenario/<name>.yaml`.
  * `group=option` recomposes a group; `env/scenario=name` (or
    `env.scenario=name`) swaps the scenario; `a.b.c=value` sets an EXISTING leaf
    (value parsed as YAML) and `+a.b.c=value` adds a new key.

The reference's persistent XLA compilation cache has no counterpart here. The
TPU-only keys `arch.donate_buffers`, `system.rollout_unroll` and
`system.gae_impl` are accepted like any other key and never read by the port.
"""

from __future__ import annotations

import copy
import os
import re
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import yaml

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


class Config(dict):
    """A dict with recursive attribute access. New keys may be added freely."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __deepcopy__(self, memo: dict) -> "Config":
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        out = Config()
        for k, v in d.items():
            out[k] = Config.from_dict(v) if isinstance(v, dict) else v
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {
            k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()
        }


_NUMERIC_RE = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)[eE][+-]?\d+$")


def _coerce_numbers(obj: Any) -> Any:
    """YAML 1.1 reads `1e5` as a string; coerce scientific notation to float."""
    if isinstance(obj, dict):
        return {k: _coerce_numbers(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_coerce_numbers(v) for v in obj]
    if isinstance(obj, str) and _NUMERIC_RE.match(obj):
        return float(obj)
    return obj


def _load_yaml(path: Path) -> Dict[str, Any]:
    if not path.exists():
        raise FileNotFoundError(f"Config file not found: {path}")
    with open(path) as f:
        return _coerce_numbers(yaml.safe_load(f) or {})


def _load_group(group: str, option: str, config_dir: Path) -> Dict[str, Any]:
    data = _load_yaml(config_dir / group / f"{option}.yaml")
    inner_defaults = data.pop("defaults", None)
    if inner_defaults:
        for sub_group, sub_option in inner_defaults.items():
            data[sub_group] = _load_yaml(
                config_dir / group / sub_group / f"{sub_option}.yaml"
            )
    return data


def _deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    for key, value in override.items():
        if key in base and isinstance(base[key], dict) and isinstance(value, dict):
            _deep_merge(base[key], value)
        else:
            base[key] = value
    return base


def _set_dotted(
    cfg: Dict[str, Any], path: str, value: Any, allow_new: bool = False
) -> None:
    keys = path.split(".")
    node = cfg
    for i, key in enumerate(keys[:-1]):
        if key not in node or not isinstance(node[key], dict):
            if not allow_new:
                raise KeyError(
                    f"Override '{path}' refers to unknown config path "
                    f"'{'.'.join(keys[: i + 1])}'. Use '+{path}=...' to add new keys."
                )
            node[key] = Config()
        node = node[key]
    if not allow_new and keys[-1] not in node:
        raise KeyError(
            f"Override '{path}' refers to unknown config key '{keys[-1]}'. "
            f"Use '+{path}=...' to add new keys."
        )
    node[keys[-1]] = value


def _print_help(defaults: Dict[str, str], default_name: str, config_dir: Path) -> None:
    lines = [
        "Usage: python -m mava_tpu_torch.systems.<family>.<system> [group=option ...]"
        " [a.b.c=value ...]",
        "",
        f"Defaults ({default_name}.yaml):",
    ]
    for group, option in defaults.items():
        choices = sorted(
            str(p.relative_to(config_dir / group)).removesuffix(".yaml")
            for p in (config_dir / group).glob("**/*.yaml")
            if p.parent.name != "scenario"
        )
        lines.append(f"  {group}={option}    (choices: {', '.join(choices)})")
    scen_dir = config_dir / "env" / "scenario"
    if scen_dir.is_dir():
        lines.append(
            "  env/scenario=<name>    (choices: "
            + ", ".join(sorted(p.stem for p in scen_dir.glob("*.yaml")))
            + ")"
        )
    lines += [
        "",
        "Leaf overrides set EXISTING keys (strict): system.seed=7, arch.num_envs=256",
        "Add new keys with a leading '+': +arch.device=cpu",
    ]
    print("\n".join(lines))


def load_config(
    default_name: str,
    overrides: Optional[Sequence[str]] = None,
    config_dir: Optional[os.PathLike] = None,
) -> Config:
    """Compose `configs/<default_name>.yaml` plus CLI-style overrides."""
    config_dir = Path(config_dir) if config_dir is not None else CONFIG_DIR
    top = _load_yaml(config_dir / f"{default_name}.yaml")
    defaults: Dict[str, str] = top.pop("defaults", {})

    overrides = list(overrides or [])
    if any(ov in ("--help", "-h", "help") for ov in overrides):
        _print_help(defaults, default_name, config_dir)
        raise SystemExit(0)
    remaining: List[str] = []
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"Override must be key=value, got: {ov}")
        key, value = ov.split("=", 1)
        if key in defaults and "." not in key:
            defaults[key] = value
        else:
            remaining.append(ov)

    cfg: Dict[str, Any] = {}
    for group, option in defaults.items():
        cfg[group] = _load_group(group, str(option), config_dir)
    _deep_merge(cfg, top)

    leaf_overrides: List[str] = []
    for ov in remaining:
        key, value = ov.split("=", 1)
        if key == "env.scenario":
            key = "env/scenario"
        if "/" in key:
            group, sub = key.split("/", 1)
            if not (config_dir / group / sub).is_dir():
                raise KeyError(
                    f"Override '{ov}' looks like a group swap but "
                    f"'{config_dir / group / sub}' is not a config group directory."
                )
            if group not in cfg:
                raise KeyError(
                    f"Override '{ov}' targets group '{group}' which is not part "
                    f"of this config's defaults."
                )
            cfg[group][sub] = _load_yaml(config_dir / group / sub / f"{value}.yaml")
            continue
        leaf_overrides.append(ov)

    for ov in leaf_overrides:
        key, value = ov.split("=", 1)
        allow_new = key.startswith("+")
        _set_dotted(cfg, key.lstrip("+"), yaml.safe_load(value), allow_new=allow_new)

    return Config.from_dict(cfg)
