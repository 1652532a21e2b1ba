"""A minimal typed configuration tree.

Provides the same behavioural surface as the yacs ``CfgNode`` the reference
uses (merge from YAML file, merge from a flat KEY VALUE override list,
attribute access, clone) without the external dependency.

Reference surface: reference config/defaults.py (key set) and
reference train_ctl_model.py:196-198 (merge calls).
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Iterator, List

import yaml


class ConfigNode(dict):
    """Nested dict with attribute access and type-checked merging."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: dict | None = None):
        super().__init__()
        self.__dict__[ConfigNode.IMMUTABLE] = False
        if init_dict:
            for k, v in init_dict.items():
                self[k] = ConfigNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config key not found: {name}")

    def __setattr__(self, name: str, value: Any) -> None:
        if self.__dict__.get(ConfigNode.IMMUTABLE, False):
            raise AttributeError(f"Config is frozen; cannot set {name}")
        self[name] = value

    # -- merging ----------------------------------------------------------
    def merge_from_file(self, path: str) -> None:
        with open(path, "r") as f:
            loaded = yaml.safe_load(f) or {}
        self._merge_dict(loaded, [])

    def merge_from_other_cfg(self, other: "ConfigNode") -> None:
        self._merge_dict(other, [])

    def merge_from_list(self, opts: List[str] | None) -> None:
        """Merge a flat ``[KEY, VALUE, KEY, VALUE, ...]`` override list."""
        if not opts:
            return
        if len(opts) % 2 != 0:
            raise ValueError(f"Override list must have even length, got {opts}")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Unknown config section: {p} (in {key})")
                node = node[p]
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            node[leaf] = _coerce(value, node[leaf], key)

    def _merge_dict(self, d: dict, trail: List[str]) -> None:
        for k, v in d.items():
            full = ".".join(trail + [str(k)])
            if k not in self:
                raise KeyError(f"Unknown config key: {full}")
            if isinstance(self[k], ConfigNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot overwrite section {full} with a leaf")
                self[k]._merge_dict(v, trail + [str(k)])
            else:
                self[k] = _coerce(v, self[k], full)

    # -- misc -------------------------------------------------------------
    def clone(self) -> "ConfigNode":
        return copy.deepcopy(self)

    def freeze(self) -> None:
        self.__dict__[ConfigNode.IMMUTABLE] = True
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.freeze()

    def defrost(self) -> None:
        self.__dict__[ConfigNode.IMMUTABLE] = False
        for v in self.values():
            if isinstance(v, ConfigNode):
                v.defrost()

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, ConfigNode) else v
            for k, v in self.items()
        }

    def flat_items(self, prefix: str = "") -> Iterator[tuple]:
        for k, v in self.items():
            full = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, ConfigNode):
                yield from v.flat_items(full)
            else:
                yield full, v

    def dump(self) -> str:
        return yaml.safe_dump(self.to_dict(), sort_keys=False)


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce ``value`` to the type of the existing default ``old``.

    CLI overrides arrive as strings; YAML values arrive typed. Mirrors the
    yacs coercion rules (literal_eval of strings, int->float widening,
    list<->tuple interchange).
    """
    if isinstance(value, str) and not isinstance(old, str):
        try:
            value = ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass  # keep the string; the type check below will complain
    if old is None or value is None:
        return value
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            if value.lower() in ("true", "yes", "1"):
                return True
            if value.lower() in ("false", "no", "0"):
                return False
        raise TypeError(f"Cannot coerce {value!r} to bool for {key}")
    if isinstance(old, float) and isinstance(value, int):
        return float(value)
    if isinstance(old, (list, tuple)) and isinstance(value, (list, tuple)):
        return type(old)(value)
    if type(value) is not type(old):
        raise TypeError(
            f"Type mismatch for {key}: got {type(value).__name__} "
            f"({value!r}), expected {type(old).__name__}"
        )
    return value
