"""``engine.checkpoint.CheckpointManager(use_async=True)``, the counterpart
of the JAX package's asynchronous orbax saves: in one process a save
copies the state to host memory and returns, a thread writes it, and the
destructive follow-ups (dropping the previous best, pruning the ring) wait
until the write has committed. The writer is slowed here by a gate that
the test opens, so the order of events is fixed, not timed. In a group of
two processes (gloo) saves stay synchronous."""

import os
import threading

import numpy as np
import pytest
import torch

from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.engine import checkpoint as CK
from centroids_reid_tpu_torch.engine.state import TrainState
from centroids_reid_tpu_torch.solver import build_optimizers


class _Tiny(torch.nn.Module):
    """A stand-in model: the manager saves whatever state dicts the state
    holds, and a small one keeps the checkpoints small."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(8, 4)
        self.bn = torch.nn.BatchNorm1d(4)


def _state(seed=0):
    torch.manual_seed(seed)
    model = _Tiny().train()
    centers = torch.nn.Parameter(torch.randn(3, 4))
    cfg = get_default_cfg()
    return cfg, TrainState(model, centers,
                           build_optimizers(model, centers, cfg))


def _step(cfg, state, seed):
    """One optimizer step: parameters, Adam moments and the BN running
    statistics change in place."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(6, 8).astype(
        np.float32))
    state.optimizers.zero_grad()
    out = state.model.bn(state.model.fc(x))
    ((out ** 2).mean() + (state.centers ** 2).sum()).backward()
    state.optimizers.step()
    state.step += 1                     # as fit counts steps


@pytest.fixture
def gate(monkeypatch):
    """Writes wait until ``gate.set()``; ``gate.started`` counts writes
    that began."""
    ev = threading.Event()
    ev.started = []
    write = CK._write

    def slowed(path, sd, cfg_text):
        ev.started.append(path)
        assert ev.wait(30), "the test never opened the gate"
        write(path, sd, cfg_text)

    monkeypatch.setattr(CK, "_write", slowed)
    yield ev
    ev.set()


def test_save_returns_before_the_write_commits(tmp_path, gate):
    cfg, state = _state()
    mgr = CK.CheckpointManager(str(tmp_path), use_async=True)
    path = mgr.save_periodic(0, state, cfg)
    assert path == os.path.join(mgr.auto_dir, "checkpoint_epoch0")
    assert not os.path.exists(path)          # the writer waits at the gate
    gate.set()
    mgr.wait()
    assert sorted(os.listdir(path)) == ["config.yml", "state.pt"]
    assert mgr._writer is None


def test_latest_periodic_waits(tmp_path, gate):
    cfg, state = _state()
    mgr = CK.CheckpointManager(str(tmp_path), use_async=True)
    mgr.save_periodic(3, state, cfg)
    threading.Timer(0.2, gate.set).start()
    latest = mgr.latest_periodic()
    assert latest == os.path.join(mgr.auto_dir, "checkpoint_epoch3")
    assert os.path.isfile(os.path.join(latest, "state.pt"))


def test_previous_best_and_ring_survive_until_the_commit(tmp_path, gate):
    cfg, state = _state()
    mgr = CK.CheckpointManager(str(tmp_path), n_saved=1, use_async=True)
    gate.set()
    assert mgr.save_if_best(0, state, 0.5, cfg)
    mgr.save_periodic(0, state, cfg)
    mgr.wait()
    gate.clear()
    assert mgr.save_if_best(1, state, 0.7, cfg)
    # the new best is in flight: the previous one stays
    assert os.listdir(mgr.best_dir) == ["epoch=0"]
    assert not mgr.save_if_best(2, state, 0.6, cfg)   # not better: no wait
    gate.set()
    mgr.save_periodic(1, state, cfg)    # settles the best, then writes
    assert sorted(os.listdir(mgr.best_dir)) == ["epoch=1"]
    mgr.close()
    assert os.listdir(mgr.auto_dir) == ["checkpoint_epoch1"]
    assert mgr._writer is None and mgr._deferred == []


def test_close_settles(tmp_path, gate):
    cfg, state = _state()
    mgr = CK.CheckpointManager(str(tmp_path), use_async=True)
    mgr.save_if_best(0, state, 1.0, cfg)
    assert os.listdir(mgr.best_dir) == []    # at the gate
    threading.Timer(0.2, gate.set).start()
    mgr.close()
    assert os.listdir(mgr.best_dir) == ["epoch=0"]
    assert sorted(os.listdir(os.path.join(mgr.best_dir, "epoch=0"))) == [
        "config.yml", "state.pt"]
    assert mgr._writer is None and mgr._deferred == []
    mgr.close()                         # idempotent


def test_restored_state_is_the_saved_one(tmp_path, gate):
    """The state as it was when save returned, though the next step
    changed every tensor in place before the write ran."""
    cfg, state = _state()
    _step(cfg, state, 0)                # Adam holds moments now
    saved = {k: v.clone() for k, v in
             CK._to_host(CK.state_dict(state, 5))["model"].items()}
    centers = state.centers.detach().clone()
    mgr = CK.CheckpointManager(str(tmp_path), use_async=True)
    path = mgr.save_periodic(5, state, cfg)
    opt_saved = CK._to_host(state.optimizers.state_dict())
    _step(cfg, state, 1)                # the next step, before the write
    assert not torch.equal(state.centers.detach(), centers)
    gate.set()
    mgr.close()

    _, fresh = _state(seed=7)
    CK.restore_state(path, fresh)
    got = fresh.model.state_dict()
    assert got.keys() == saved.keys()
    for k, v in saved.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(fresh.centers.detach(), centers)
    assert fresh.step == 1
    opt = fresh.optimizers.state_dict()["model"]["state"]
    assert opt.keys() == opt_saved["model"]["state"].keys()
    for i, per in opt_saved["model"]["state"].items():
        for name, v in per.items():
            assert torch.equal(opt[i][name], v), (i, name)
    assert CK.epoch_of_checkpoint(path) == 5


def test_a_failed_write_raises_and_keeps_the_previous_best(tmp_path,
                                                           monkeypatch):
    cfg, state = _state()
    mgr = CK.CheckpointManager(str(tmp_path), use_async=True)
    mgr.save_if_best(0, state, 0.5, cfg)
    mgr.wait()

    def broken(path, sd, cfg_text):
        raise OSError("disk full")

    monkeypatch.setattr(CK, "_write", broken)
    mgr.save_if_best(1, state, 0.9, cfg)
    with pytest.raises(RuntimeError, match="asynchronous checkpoint"):
        mgr.wait()
    assert os.listdir(mgr.best_dir) == ["epoch=0"]
    mgr.close()                         # nothing left to raise


def test_synchronous_manager_commits_on_return(tmp_path):
    cfg, state = _state()
    mgr = CK.CheckpointManager(str(tmp_path), n_saved=1, use_async=False)
    mgr.save_if_best(0, state, 0.5, cfg)
    mgr.save_if_best(1, state, 0.6, cfg)
    assert os.listdir(mgr.best_dir) == ["epoch=1"]
    for e in range(3):
        mgr.save_periodic(e, state, cfg)
        assert os.listdir(mgr.auto_dir) == [f"checkpoint_epoch{e}"]


def test_two_processes_stay_synchronous(tmp_path):
    """In a gloo group of two the manager writes synchronously on rank 0
    between barriers: each save has committed when it returns on either
    rank, and on rank 0 (which deletes after the barrier) the previous
    entry is gone too. One process alone writes from a thread."""
    from conftest import cpu_subprocess_env
    from fixtures.torch_dist_worker import launch

    opts = []
    log_dir = str(tmp_path / "two")
    ranks = launch(tmp_path, {"task": "checkpoint", "log_dir": log_dir,
                              "opts": opts, "block_jax": True}, 2,
                   cpu_subprocess_env())
    assert ranks[0]["pruned"].all(), ranks[0]["pruned"]
    assert list(ranks[0]["best"]) == ["epoch=1"]
    assert list(ranks[0]["ring"]) == ["checkpoint_epoch1"]
    for out in ranks:
        assert not bool(out["async"])
        assert out["committed"].all(), out["committed"]
        assert int(out["jax_modules"]) == 0
    one = launch(tmp_path, {"task": "checkpoint",
                            "log_dir": str(tmp_path / "one"), "opts": opts},
                 1, cpu_subprocess_env(), group=False)[0]
    assert bool(one["async"])
    assert list(one["best"]) == ["epoch=1"]
    assert list(one["ring"]) == ["checkpoint_epoch1"]
