"""Training, evaluation and run orchestration. The submodules
(``engine.fit``, ``engine.steps``, ``engine.checkpoint``,
``engine.evaluate``, ``engine.runner``, ...) can be imported directly;
the names below, the JAX package's ``engine`` exports, load their
submodule at first use, so importing the package loads nothing. ``fit`` is
the one export left out: ``engine.fit`` names the submodule, whose ``fit``
is the function."""

import importlib

_EXPORTS = {
    "CheckpointManager": "checkpoint",
    "epoch_of_checkpoint": "checkpoint",
    "restore_state": "checkpoint",
    "compute_reid_metrics": "evaluate",
    "evaluate_on_train": "evaluate",
    "extract_embeddings": "evaluate",
    "make_embed_fn": "evaluate",
    "run_validation": "evaluate",
    "build_model_and_state": "fit",
    "num_groups": "fit",
    "MetricsLogger": "logging",
    "next_version_dir": "logging",
    "load_model_for_test": "runner",
    "run_main": "runner",
    "run_single": "runner",
    "TrainState": "state",
    "create_train_state": "state",
    "make_train_step": "steps",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{module}", __name__), name)
