"""Weight conversion into the port's state-dict naming.

* Reference ``.pth`` / ``.ckpt`` files are torch-native: the key surgery of
  the reference ``load_param`` (strip ``backbone.base.`` / ``backbone.`` /
  ``base.``; skip ``fc.``, ``bottleneck``, ``classifier`` and
  ``transformer`` keys) is all they need, as in
  ``centroids_reid_tpu/models/convert.py``.
* ``from_jax_params`` is the inverse of that file's key map: it turns the
  JAX package's (params, batch_stats) trees into a state dict of
  ``ReidModel``, so both packages can run on one set of weights;
  ``from_jax_train_state`` adds the center-loss centers of a train state.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Tuple

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


def from_jax_train_state(params, batch_stats):
    """A JAX ``TrainState``'s ``params`` ({'model': ..., 'centers': ...})
    and ``batch_stats`` -> (``ReidModel`` state dict, centers [C, D]).
    Gradient trees of the same layout convert the same way (pass ``{}`` as
    ``batch_stats``)."""
    sd = from_jax_params(params["model"], batch_stats)
    centers = torch.from_numpy(np.array(params["centers"], np.float32))
    return sd, centers


def load_converted(model: torch.nn.Module, sd: Dict[str, torch.Tensor]
                   ) -> None:
    """Load a state dict converted from the JAX package into ``model``:
    every key of the model but BN's ``num_batches_tracked`` (JAX keeps no
    such count) must be there, and nothing else; shapes must match."""
    missing, unexpected = model.load_state_dict(sd, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"the checkpoint does not fit the model: missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}")


def _drop_none(tree):
    """A params-shaped tree without the ``None`` leaves optax's masks leave
    (the frozen BNNeck bias, the centers of the model's branch)."""
    return {k: _drop_none(v) if isinstance(v, dict) else v
            for k, v in tree.items() if v is not None}


def _no_arrays(tree, path: str) -> None:
    """Raise if ``tree`` holds an array: a state the mapping does not know."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _no_arrays(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _no_arrays(v, f"{path}.{i}")
    elif tree is not None:
        raise ValueError(f"{path}: optimizer state the port's optimizers do "
                         f"not hold (the centers' SGD and the frozen BNNeck "
                         f"bias have none)")


def _at(tree, path: Tuple):
    node = tree
    for i, key in enumerate(path):
        try:
            node = node[key]
        except (KeyError, IndexError, TypeError):
            raise ValueError(
                "opt_state." + ".".join(map(str, path[:i + 1]))
                + ": not in this optimizer state; the mapping knows the "
                "JAX package's multi_transform of inject_hyperparams(add_"
                "decayed_weights, scale_by_adam, scale_by_learning_rate) "
                "for the model, scale + sgd for the centers") from None
    return node


_ADAM = ("inner_states", "model", "inner_state", "inner_state", 1)


def from_jax_opt_state(opt_state, params: Iterable[Tuple[str, torch.Tensor]]
                       ) -> Dict[int, Dict[str, torch.Tensor]]:
    """The JAX package's optax state (``TrainState.opt_state`` as nested
    dicts and lists, ``engine/orbax_read``) -> ``torch.optim.Adam``'s
    per-parameter state, keyed by position in ``params``: the (name,
    parameter) pairs Adam holds, in its order (``model.named_parameters()``
    that require a gradient). The model branch's ``scale_by_adam`` ``mu`` /
    ``nu`` become ``exp_avg`` / ``exp_avg_sq`` (HWIO -> OIHW, IO -> OI, as
    ``from_jax_params``), its ``count`` the ``step``; moments are matched by
    parameter name. The centers' SGD and the frozen BNNeck bias carry no
    state. A tree the mapping does not know raises, naming the path."""
    adam = _at(opt_state, _ADAM)
    count, mu, nu = (_at(opt_state, _ADAM + (k,)) for k in ("count", "mu",
                                                          "nu"))
    _no_arrays(_at(opt_state, ("inner_states", "centers")),
               "opt_state.inner_states.centers")
    _no_arrays(_at(opt_state, ("inner_states", "frozen")),
               "opt_state.inner_states.frozen")
    for name in ("mu", "nu"):
        _no_arrays(_at(adam, (name,)).get("centers"),
                   f"opt_state.{'.'.join(map(str, _ADAM))}.{name}.centers")
    moments = {k: from_jax_params(_drop_none(_at(tree, ("model",))), {})
               for k, tree in (("exp_avg", mu), ("exp_avg_sq", nu))}
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    out: Dict[int, Dict[str, torch.Tensor]] = {}
    names = set()
    for i, (name, p) in enumerate(params):
        names.add(name)
        entry = {"step": step.clone()}
        for k, sd in moments.items():
            if name not in sd or sd[name].shape != p.shape:
                raise ValueError(
                    f"opt_state.{'.'.join(map(str, _ADAM))}: no {k} of shape "
                    f"{tuple(p.shape)} for parameter {name}")
            entry[k] = sd[name]
        out[i] = entry
    extra = sorted(set(moments["exp_avg"]) - names)
    if extra:
        raise ValueError(f"opt_state: Adam moments of {extra[:5]}, which "
                         f"the model does not train")
    return out
