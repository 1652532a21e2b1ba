"""The configuration tree: a copy of the JAX package's ``config`` (same
keys and defaults, so the same YAML files and ``KEY VALUE`` opts merge)."""

from .defaults import cfg, get_default_cfg
from .node import ConfigNode

__all__ = ["cfg", "get_default_cfg", "ConfigNode"]
