"""Checkpoints: best metric, periodic ring, resume (counterpart of
``centroids_reid_tpu/engine/checkpoint.py``).

A checkpoint is a directory holding ``state.pt`` (``torch.save`` of the
model's state dict, the centers, both optimizers' state, the step and the
epoch) and ``config.yml``:

* ``<root>/checkpoints/epoch=N/``: the best validation metric so far; the
  previous best is deleted once the new one is written;
* ``<root>/auto_checkpoints/checkpoint_epochN/``: the periodic ring, the
  newest ``n_saved`` kept.

A save writes into ``<dir>.tmp`` and renames it on commit, so a crash never
leaves a half-written checkpoint under a checkpoint's name.
``inference/api.py::load_inference_model`` reads such a directory.

``use_async`` (the default, as in the JAX package): in one process a save
blocks only while it copies the state to host memory, which it must do
before the next step updates the parameters and moments in place; a
background thread then serialises and writes it while training goes on.
The destructive follow-ups (deleting the previous best, pruning the ring)
are deferred until that write has committed, and run at the next save,
``wait()`` or ``close()``; a write that failed raises there and runs none
of them. ``latest_periodic()`` waits first. One write is in flight at a
time.

In a process group (``parallel``) every process calls the manager at the
same points; rank 0 alone writes, deletes the previous best and prunes
the ring, between barriers before and after each save, as the JAX
package's multi-process saves. The state is the same on every process, and
so is the metric (every process ranks the same gathered embeddings), so
the best-checkpoint decision is too. Every process restores the same file.

``restore_state`` also reads the orbax checkpoints of the JAX package
(``engine/orbax_read``): its params, batch statistics, centers, Adam state
and step, so ``fit`` resumes a run that the JAX package trained.
"""

from __future__ import annotations

import os
import shutil
import threading
from typing import Optional

import torch

from ..models.convert import (
    from_jax_opt_state,
    from_jax_train_state,
    load_converted,
)
from ..parallel.mesh import barrier, process_count, process_index
from .orbax_read import is_orbax_checkpoint, read_checkpoint

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


def _to_host(tree):
    """A copy of ``tree`` (nested dicts, lists and tuples) with every tensor
    copied to host memory."""
    if torch.is_tensor(tree):
        return tree.detach().to("cpu", copy=True)
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    return tree


def _write(path: str, sd: dict, cfg_text: Optional[str]) -> None:
    """``sd`` and the config into ``<path>.tmp``, renamed to ``path``."""
    tmp = path + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(sd, os.path.join(tmp, STATE_FILE))
    if cfg_text is not None:
        with open(os.path.join(tmp, "config.yml"), "w") as f:
            f.write(cfg_text)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


class CheckpointManager:
    def __init__(self, root_dir: str, n_saved: int = 1, mode: str = "max",
                 use_async: bool = True):
        self.root = os.path.abspath(root_dir)
        self.auto_dir = os.path.join(self.root, "auto_checkpoints")
        self.best_dir = os.path.join(self.root, "checkpoints")
        os.makedirs(self.auto_dir, exist_ok=True)
        os.makedirs(self.best_dir, exist_ok=True)
        self.n_saved = n_saved
        self.mode = mode
        self.best_metric: Optional[float] = None
        # multi-process saves stay synchronous, between barriers
        self._async = bool(use_async) and process_count() == 1
        self._writer: Optional[threading.Thread] = None
        self._failure: Optional[BaseException] = None
        self._deferred = []   # destructive follow-ups gated on the commit

    def wait(self) -> None:
        """Block until the write in flight has committed, then run the
        deferred follow-ups in order. A write that failed raises here, and
        its follow-ups are dropped."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        failure, self._failure = self._failure, None
        deferred, self._deferred = self._deferred, []
        if failure is not None:
            raise RuntimeError("an asynchronous checkpoint write failed"
                               ) from failure
        for fn in deferred:
            fn()

    def close(self) -> None:
        self.wait()

    def _after_commit(self, fn) -> None:
        if self._async:
            self._deferred.append(fn)
        else:
            fn()

    # -- periodic ring ----------------------------------------------------
    def save_periodic(self, epoch: int, state, cfg=None) -> str:
        path = os.path.join(self.auto_dir, f"checkpoint_epoch{epoch}")
        self._save(path, state, epoch, cfg)
        # prune only once the new entry is durable
        self._after_commit(self._prune_ring)
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
        if process_index():
            return
        entries = self._ring_entries()
        while len(entries) > self.n_saved:
            shutil.rmtree(os.path.join(self.auto_dir, entries.pop(0)),
                          ignore_errors=True)

    def latest_periodic(self) -> Optional[str]:
        """The newest ring checkpoint, once any write in flight is
        durable."""
        self.wait()
        entries = self._ring_entries()
        return os.path.join(self.auto_dir, entries[-1]) if entries else None

    # -- best metric ------------------------------------------------------
    def save_if_best(self, epoch: int, state, metric: float, cfg=None) -> bool:
        better = (self.best_metric is None
                  or (self.mode == "max" and metric > self.best_metric)
                  or (self.mode == "min" and metric < self.best_metric))
        if not better:
            return False
        self.best_metric = metric
        # settle first, so that a best still in flight is listed under its
        # committed name
        self.wait()
        previous = os.listdir(self.best_dir)
        path = os.path.join(self.best_dir, f"epoch={epoch}")
        self._save(path, state, epoch, cfg)
        if process_index():
            return True

        def drop_previous():   # only after the new best has committed
            for d in previous:
                full = os.path.join(self.best_dir, d)
                if os.path.abspath(full) in (path, path + ".tmp"):
                    continue
                if os.path.isdir(full):
                    shutil.rmtree(full, ignore_errors=True)
                elif os.path.exists(full):
                    os.remove(full)

        self._after_commit(drop_previous)
        print(f"Saved best checkpoint (metric={metric:.4f}) at {path}")
        return True

    # -- io ---------------------------------------------------------------
    def _save(self, path: str, state, epoch: int, cfg) -> None:
        """In one process with ``use_async``: settle the previous write,
        snapshot the state to host memory and write it from a thread.
        Otherwise rank 0 writes, and every process leaves once the file is
        there."""
        cfg_text = cfg.dump() if cfg is not None else None
        if self._async:
            self.wait()   # one write in flight at a time
            sd = _to_host(state_dict(state, epoch))

            def run():
                try:
                    _write(path, sd, cfg_text)
                except Exception as e:   # raised again by wait()
                    self._failure = e

            self._writer = threading.Thread(target=run,
                                            name="checkpoint-writer")
            self._writer.start()
            return
        barrier()
        if not process_index():
            _write(path, state_dict(state, epoch), cfg_text)
        barrier()


def restore_state(path: str, state):
    """Load checkpoint directory ``path`` into ``state`` (its model,
    centers, optimizers and step), on the devices ``state`` lives on: a
    directory of the port's ``fit`` (``state.pt``) or an orbax checkpoint of
    the JAX package. Returns ``state``."""
    if is_orbax_checkpoint(path):
        return _restore_orbax(path, state)
    sd = load_state_file(path)
    state.model.load_state_dict(sd["model"])
    with torch.no_grad():
        state.centers.copy_(sd["centers"])
    state.optimizers.load_state_dict(sd["optimizers"])
    state.step = int(sd["step"])
    return state


def _restore_orbax(path: str, state):
    """The JAX package's ``TrainState`` at ``path`` into ``state``: params
    and batch statistics (``from_jax_params``), centers, the Adam moments
    and count (``from_jax_opt_state``; the LR and weight decay stay the
    config's, as ``fit`` sets the LR each epoch), and the step."""
    tree = read_checkpoint(path)
    sd, centers = from_jax_train_state(tree["params"], tree["batch_stats"])
    load_converted(state.model, sd)
    with torch.no_grad():
        state.centers.copy_(centers)
    trainable = [(n, p) for n, p in state.model.named_parameters()
                 if p.requires_grad]
    opt = state.optimizers.state_dict()
    opt["model"]["state"] = from_jax_opt_state(tree["opt_state"], trainable)
    state.optimizers.load_state_dict(opt)
    state.step = int(tree["step"])
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
