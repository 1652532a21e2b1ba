"""The configuration tree: the JAX package's ``config`` is framework-free
(it imports neither jax nor flax), so the port shares it."""

from centroids_reid_tpu.config import ConfigNode, cfg, get_default_cfg

__all__ = ["cfg", "get_default_cfg", "ConfigNode"]
