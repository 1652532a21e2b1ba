"""Weight conversion into the port's state-dict naming.

* Reference ``.pth`` / ``.ckpt`` files are torch-native: the key surgery of
  the reference ``load_param`` (strip ``backbone.base.`` / ``backbone.`` /
  ``base.``; skip ``fc.``, ``bottleneck``, ``classifier`` and
  ``transformer`` keys) is all they need, as in
  ``centroids_reid_tpu/models/convert.py``.
* ``from_jax_params`` is the inverse of that file's key map: it turns the
  JAX package's (params, batch_stats) trees into a state dict of
  ``ReidModel``, so both packages can run on one set of weights.
"""

from __future__ import annotations

import re
from typing import Any, Dict

import numpy as np
import torch

_SKIP_PATTERNS = ("fc.", "bottleneck", "classifier", "transformer")
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _strip_prefix(name: str) -> str:
    for prefix in ("backbone.base.", "backbone.", "base."):
        if name.startswith(prefix):
            return name[len(prefix):]
    return name


def _tensor(v) -> torch.Tensor:
    return v.detach().cpu() if torch.is_tensor(v) else torch.from_numpy(
        np.array(v))


def backbone_state_dict(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A torchvision / reference backbone state dict -> keys of
    ``ResNet`` (no prefix); fc head and ``num_batches_tracked`` dropped."""
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    out = {}
    for raw, v in state_dict.items():
        name = _strip_prefix(raw)
        if name.endswith("num_batches_tracked"):
            continue
        if any(p in name for p in _SKIP_PATTERNS):
            continue
        out[name] = _tensor(v)
    return out


def full_state_dict(state_dict: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A full reference re-id checkpoint -> keys of ``ReidModel``:
    ``backbone.*``, ``bn.*`` (BNNeck) and ``fc_query.weight``. Other keys
    (``center_loss.centers``, unprefixed ones) are dropped."""
    if "state_dict" in state_dict:
        state_dict = state_dict["state_dict"]
    backbone = {k: v for k, v in state_dict.items()
                if k.startswith("backbone.")}
    out = {"backbone." + k: v for k, v in backbone_state_dict(backbone).items()}
    for leaf in _BN_LEAVES:
        if "bn." + leaf in state_dict:
            out["bn." + leaf] = _tensor(state_dict["bn." + leaf])
    if "fc_query.weight" in state_dict:
        out["fc_query.weight"] = _tensor(state_dict["fc_query.weight"])
    return out


def load_torch_file(path: str) -> Dict[str, Any]:
    return torch.load(path, map_location="cpu", weights_only=False)


def _torch_name(path) -> str:
    parts = []
    for p in path:
        m = re.fullmatch(r"layer(\d+)_(\d+)", p)
        if m:
            parts.append(f"layer{m.group(1)}.{m.group(2)}")
        elif p == "downsample_conv":
            parts.append("downsample.0")
        elif p == "downsample_bn":
            parts.append("downsample.1")
        elif p == "bnneck":
            parts.append("bn")
        else:
            parts.append(p)
    return ".".join(parts)


def from_jax_params(params, batch_stats) -> Dict[str, torch.Tensor]:
    """JAX ``ReidModel`` (params, batch_stats) trees -> ``ReidModel`` state
    dict: HWIO convs -> OIHW, dense IO -> OI, ``scale``/``bias``/``mean``/
    ``var`` -> ``weight``/``bias``/``running_mean``/``running_var``,
    ``layerX_Y`` -> ``layerX.Y``, ``downsample_conv``/``downsample_bn`` ->
    ``downsample.0``/``.1``, ``bnneck`` -> ``bn``; the IBN ``IN``/``BN``
    halves keep their names."""
    sd: Dict[str, torch.Tensor] = {}
    leaf_names = {"scale": "weight", "bias": "bias", "mean": "running_mean",
                  "var": "running_var"}

    def walk(node, path):
        for key, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (key,))
                continue
            a = np.asarray(v, np.float32)
            if key == "kernel":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
                leaf = "weight"
            else:
                leaf = leaf_names[key]
            sd[_torch_name(path) + "." + leaf] = torch.from_numpy(
                np.ascontiguousarray(a))

    walk(params, ())
    walk(batch_stats, ())
    return sd
