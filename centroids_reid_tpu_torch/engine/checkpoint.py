"""Checkpoints: best metric, periodic ring, resume (counterpart of
``centroids_reid_tpu/engine/checkpoint.py``).

A checkpoint is a directory holding ``state.pt`` (``torch.save`` of the
model's state dict, the centers, both optimizers' state, the step and the
epoch) and ``config.yml``:

* ``<root>/checkpoints/epoch=N/``: the best validation metric so far; the
  previous best is deleted once the new one is written;
* ``<root>/auto_checkpoints/checkpoint_epochN/``: the periodic ring, the
  newest ``n_saved`` kept.

Saves are synchronous. A save writes into ``<dir>.tmp`` and renames it, so
a crash never leaves a half-written checkpoint under a checkpoint's name.
``inference/api.py::load_inference_model`` reads such a directory.
"""

from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

STATE_FILE = "state.pt"


def state_dict(state, epoch: int) -> dict:
    return {"model": state.model.state_dict(),
            "centers": state.centers.detach(),
            "optimizers": state.optimizers.state_dict(),
            "step": state.step, "epoch": epoch}


def load_state_file(path: str, device="cpu") -> dict:
    """The dict ``state_dict`` saved in checkpoint directory ``path``."""
    return torch.load(os.path.join(path, STATE_FILE), map_location=device,
                      weights_only=True)


class CheckpointManager:
    def __init__(self, root_dir: str, n_saved: int = 1, mode: str = "max"):
        self.root = os.path.abspath(root_dir)
        self.auto_dir = os.path.join(self.root, "auto_checkpoints")
        self.best_dir = os.path.join(self.root, "checkpoints")
        os.makedirs(self.auto_dir, exist_ok=True)
        os.makedirs(self.best_dir, exist_ok=True)
        self.n_saved = n_saved
        self.mode = mode
        self.best_metric: Optional[float] = None

    # -- periodic ring ----------------------------------------------------
    def save_periodic(self, epoch: int, state, cfg=None) -> str:
        path = os.path.join(self.auto_dir, f"checkpoint_epoch{epoch}")
        self._save(path, state, epoch, cfg)
        self._prune_ring()
        return path

    def _ring_entries(self):
        # a numeric suffix only: "checkpoint_epochN.tmp" is no checkpoint
        entries = []
        for d in os.listdir(self.auto_dir):
            suffix = d[len("checkpoint_epoch"):]
            if (d.startswith("checkpoint_epoch") and suffix.isdigit()
                    and os.path.isdir(os.path.join(self.auto_dir, d))):
                entries.append(d)
        return sorted(entries, key=lambda d: int(d[len("checkpoint_epoch"):]))

    def _prune_ring(self) -> None:
        entries = self._ring_entries()
        while len(entries) > self.n_saved:
            shutil.rmtree(os.path.join(self.auto_dir, entries.pop(0)),
                          ignore_errors=True)

    # -- best metric ------------------------------------------------------
    def save_if_best(self, epoch: int, state, metric: float, cfg=None) -> bool:
        better = (self.best_metric is None
                  or (self.mode == "max" and metric > self.best_metric)
                  or (self.mode == "min" and metric < self.best_metric))
        if not better:
            return False
        self.best_metric = metric
        previous = os.listdir(self.best_dir)
        path = os.path.join(self.best_dir, f"epoch={epoch}")
        self._save(path, state, epoch, cfg)
        for d in previous:   # only after the new best is written
            full = os.path.join(self.best_dir, d)
            if os.path.abspath(full) == path:
                continue
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            else:
                os.remove(full)
        print(f"Saved best checkpoint (metric={metric:.4f}) at {path}")
        return True

    # -- io ---------------------------------------------------------------
    def _save(self, path: str, state, epoch: int, cfg) -> None:
        tmp = path + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state_dict(state, epoch), os.path.join(tmp, STATE_FILE))
        if cfg is not None:
            with open(os.path.join(tmp, "config.yml"), "w") as f:
                f.write(cfg.dump())
        shutil.rmtree(path, ignore_errors=True)
        os.replace(tmp, path)


def restore_state(path: str, state):
    """Load checkpoint directory ``path`` into ``state`` (its model,
    centers, optimizers and step), on the devices ``state`` lives on.
    Returns ``state``."""
    sd = load_state_file(path)
    state.model.load_state_dict(sd["model"])
    with torch.no_grad():
        state.centers.copy_(sd["centers"])
    state.optimizers.load_state_dict(sd["optimizers"])
    state.step = int(sd["step"])
    return state


def epoch_of_checkpoint(path: str) -> Optional[int]:
    base = os.path.basename(os.path.normpath(path))
    for marker in ("checkpoint_epoch", "epoch="):
        if marker in base:
            try:
                return int(base.split(marker)[-1])
            except ValueError:
                return None
    return None
