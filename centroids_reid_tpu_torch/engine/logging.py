"""Metric logging: JSONL always, MLflow when importable (a copy of
``centroids_reid_tpu/engine/logging.py`` without its TensorBoard writer:
torch's ``SummaryWriter`` imports TensorFlow where that is installed, and
TensorFlow can pull in JAX, which the port never loads).

The durable record is a machine-readable ``metrics.jsonl`` (one line per
logged step); MLflow params / metrics are logged when ``mlflow`` is
importable. ``enabled=False`` turns the logger into a no-op.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


def _try_import_mlflow():
    try:
        import mlflow  # type: ignore

        return mlflow
    except Exception:
        return None


class MetricsLogger:
    def __init__(self, log_dir: str, name: str = "run", enabled: bool = True):
        self.enabled = enabled
        self.log_dir = os.path.join(log_dir, name)
        self._jsonl = None
        self._mlflow = None
        if not enabled:
            return
        os.makedirs(self.log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(self.log_dir, "metrics.jsonl"), "a")
        mlflow = _try_import_mlflow()
        if mlflow is not None:
            try:
                # local file store next to the jsonl (MLFlowLogger's default
                # is ./mlruns; keeping it under log_dir keeps runs tidy)
                mlflow.set_tracking_uri("file:" + os.path.join(
                    self.log_dir, "mlruns"))
                mlflow.set_experiment(name)
                self._mlflow_run = mlflow.start_run()
                self._mlflow = mlflow
            except Exception:
                self._mlflow = None

    def log_params(self, params: Dict[str, object]):
        """Hyperparameter snapshot (MLFlowLogger.log_hyperparams analogue)."""
        if not self.enabled:
            return
        rec = {"params": {k: str(v) for k, v in params.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._mlflow is not None:
            try:
                self._mlflow.log_params(
                    {k: str(v)[:250] for k, v in params.items()}
                )
            except Exception:
                pass

    def log_metrics(self, metrics: Dict[str, float], step: int):
        if not self.enabled:
            return
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._mlflow is not None:
            try:
                self._mlflow.log_metrics(
                    {k.replace("@", "_"): float(v) for k, v in metrics.items()},
                    step=step,
                )
            except Exception:
                pass

    def close(self):
        if not self.enabled:
            return
        self._jsonl.close()
        if self._mlflow is not None:
            try:
                self._mlflow.end_run()
            except Exception:
                pass


def next_version_dir(base: str, name: str) -> str:
    """logs/<name>/version_N directory allocation (Lightning-style)."""
    root = os.path.join(base, name)
    os.makedirs(root, exist_ok=True)
    versions = [
        int(d.split("_")[1])
        for d in os.listdir(root)
        if d.startswith("version_") and d.split("_")[1].isdigit()
    ]
    v = max(versions) + 1 if versions else 0
    path = os.path.join(root, f"version_{v}")
    os.makedirs(path, exist_ok=True)
    return path


def latest_version_dir(base: str, name: str) -> str:
    """The newest existing version dir."""
    root = os.path.join(base, name)
    versions = [
        int(d.split("_")[1])
        for d in os.listdir(root)
        if d.startswith("version_") and d.split("_")[1].isdigit()
    ]
    if not versions:
        raise FileNotFoundError(f"no version_N dir under {root}")
    return os.path.join(root, f"version_{max(versions)}")
