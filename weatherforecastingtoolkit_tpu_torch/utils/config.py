"""Config system: YAML files + CLI dotlist overrides + strict validation
(a copy of weatherforecastingtoolkit_tpu/utils/config.py, which imports no
JAX; the port keeps its own copy).

``yaml`` (PyYAML) is imported where a file is read or written and where a
dotlist value is parsed, not when this module is imported.

Usage::

    cfg = Config.load("config.yaml")
    cfg = cfg.merged_dotlist(["optim.lr=3e-4", "dataset.batch_size=16"])  # validated
    cfg.optim.lr  # 0.0003
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List, Mapping, Optional


class ConfigError(KeyError):
    """Raised for invalid override keys (the `check_yaml` behavior)."""


class Config(dict):
    """A dict with attribute access, recursive wrapping, and dotlist overrides."""

    def __init__(self, data: Optional[Mapping[str, Any]] = None):
        super().__init__()
        if data:
            for k, v in data.items():
                self[k] = _wrap(v)

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = _wrap(value)

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    # -- construction -------------------------------------------------------
    @classmethod
    def load(cls, path: str) -> "Config":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}
        return cls(data)

    @classmethod
    def from_dotlist(cls, dotlist: List[str]) -> "Config":
        cfg = cls()
        for item in dotlist:
            if "=" not in item:
                raise ConfigError(f"Invalid dotlist item (expected key=value): {item!r}")
            key, value = item.split("=", 1)
            cfg.set_dotted(key.strip(), _parse_value(value.strip()))
        return cfg

    # -- mutation -----------------------------------------------------------
    def set_dotted(self, dotted_key: str, value: Any) -> None:
        parts = dotted_key.split(".")
        node = self
        for p in parts[:-1]:
            if p not in node or not isinstance(node[p], Config):
                node[p] = Config()
            node = node[p]
        node[parts[-1]] = _wrap(value)

    def get_dotted(self, dotted_key: str, default: Any = None) -> Any:
        node: Any = self
        for p in dotted_key.split("."):
            if not isinstance(node, Mapping) or p not in node:
                return default
            node = node[p]
        return node

    def validate_override(self, other: Mapping[str, Any], path: str = "") -> None:
        """Every key in `other` must already exist here (check_yaml semantics,
        reference pipeline/helpers.py:260-266)."""
        for k, v in other.items():
            full = f"{path}.{k}" if path else k
            if k not in self:
                raise ConfigError(f"Invalid override key: '{full}' not found in base config")
            if isinstance(v, Mapping) and isinstance(self[k], Mapping):
                Config(self[k]).validate_override(v, full)

    def merge(self, other: Mapping[str, Any]) -> "Config":
        out = copy.deepcopy(self)
        _merge_into(out, other)
        return out

    def merged_dotlist(self, dotlist: List[str], validate: bool = True) -> "Config":
        override = Config.from_dotlist(dotlist)
        if validate:
            self.validate_override(override)
        return self.merge(override)

    def to_dict(self) -> Dict[str, Any]:
        return {k: (v.to_dict() if isinstance(v, Config) else v) for k, v in self.items()}

    def save(self, path: str) -> None:
        import yaml

        with open(path, "w") as f:
            yaml.safe_dump(self.to_dict(), f, sort_keys=False)


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, Mapping):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _merge_into(dst: Config, src: Mapping[str, Any]) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], Config) and isinstance(v, Mapping):
            _merge_into(dst[k], v)
        else:
            dst[k] = _wrap(v)


def _parse_value(text: str) -> Any:
    """Parse a CLI value string: YAML-style scalars (true/null/1e-3/[1,2])."""
    import yaml

    if text == "":
        return ""
    try:
        val = yaml.safe_load(text)
    except yaml.YAMLError:
        try:
            val = ast.literal_eval(text)
        except (ValueError, SyntaxError):
            val = text
    # YAML 1.1 parses '3e-4' (no dot) as a string; recover numeric intent.
    if isinstance(val, str):
        try:
            return int(val)
        except ValueError:
            pass
        try:
            return float(val)
        except ValueError:
            pass
    return val
