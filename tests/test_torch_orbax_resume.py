"""Resuming a run of the JAX package in the port: ``restore_state`` on an
orbax checkpoint that the JAX package's ``CheckpointManager`` wrote after 2
train steps (resnet18 at 32x16, P = 4, K = 4 with one mock, fp32, on the
CPU), then one more step in each package.

* On load: the model's parameters and BN statistics, the centers, Adam's
  moments and step equal the JAX state's, bit for bit, and the train
  state's step is 2.
* The further step, to the tolerances of ``tests/test_torch_train_step.py``:
  every loss term and metric rtol 1e-4; every gradient (centers included)
  a relative L2 error of at most 1e-4; the BNNeck running statistics 1e-6.
  Adam's moments after it, which carry the restored ones on: a relative L2
  error of at most 1e-4 per tensor, and both steps 3.
* ``fit`` with ``MODEL.RESUME_TRAINING`` on a JAX checkpoint of epoch 0
  restores it and trains from epoch 1.
"""

import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from centroids_reid_tpu.engine.checkpoint import CheckpointManager
from centroids_reid_tpu_torch.engine import checkpoint as CK
from centroids_reid_tpu_torch.engine import fit as FIT
from centroids_reid_tpu_torch.engine import steps as TSTEPS
from centroids_reid_tpu_torch.engine.state import TrainState
from centroids_reid_tpu_torch.models import from_jax_params
from centroids_reid_tpu_torch.solver import build_optimizers
from test_torch_orbax import write_jax_checkpoint
from test_torch_train_fit import _cfg, _fit, data_root  # noqa: F401
from test_torch_train_step import (
    C,
    _batch,
    _cfgs,
    _initial_jax_state,
    _jax_step,
    _port_model_and_centers,
    _rel_l2,
)


def _jbatch(batch):
    imgs, labels, is_real = batch
    return {"images": jnp.asarray(imgs[None]),
            "labels": jnp.asarray(labels[None].astype(np.int32)),
            "is_real": jnp.asarray(is_real[None])}


def test_resume_from_a_jax_checkpoint_steps_as_jax(tmp_path):
    _, cfg = _cfgs("ctl")
    jstep, _, _ = _jax_step("ctl")
    jstate = _initial_jax_state("ctl")
    for t in range(2):
        jstate, _ = jstep(jstate, _jbatch(_batch(20 + t)))
    # the step's transform also carries the last gradients; the checkpoint
    # holds the optax state the JAX package's fit saves
    ckpt = CheckpointManager(str(tmp_path), use_async=False)
    ckpt.save_periodic(0, jstate.replace(opt_state=jstate.opt_state[0]))
    ckpt.close()
    path = os.path.join(str(tmp_path), "auto_checkpoints",
                        "checkpoint_epoch0")

    model = copy.deepcopy(_port_model_and_centers()[0])
    centers = torch.nn.Parameter(torch.zeros(C, 512))
    state = TrainState(model, centers, build_optimizers(model, centers, cfg))
    CK.restore_state(path, state)

    host = jax.tree.map(np.asarray, jstate)
    sd = from_jax_params(host.params["model"], host.batch_stats)
    got = model.state_dict()
    for name, ref in sd.items():
        assert torch.equal(got[name], ref), name
    assert torch.equal(centers.detach(),
                       torch.from_numpy(host.params["centers"]))
    assert state.step == 2
    adam = host.opt_state[0].inner_states["model"].inner_state.inner_state[1]
    mu = from_jax_params(adam.mu["model"], {})
    nu = from_jax_params(adam.nu["model"], {})
    opt = state.optimizers.model
    for name, p in model.named_parameters():
        if not p.requires_grad:
            assert name == "bn.bias" and p not in opt.state
            continue
        st = opt.state[p]
        assert torch.equal(st["exp_avg"], mu[name]), name
        assert torch.equal(st["exp_avg_sq"], nu[name]), name
        assert st["step"].item() == int(adam.count) == 2
    assert not state.optimizers.centers.state     # plain SGD: no state

    # one more step in each package from the restored state
    imgs, labels, is_real = _batch(22)
    new_jstate, jmetrics = jstep(jstate, _jbatch((imgs, labels, is_real)))
    jgrads = jax.tree.map(np.asarray, new_jstate.opt_state[1])
    step = TSTEPS.make_train_step(state, cfg, C, "ctl")
    metrics = step(torch.from_numpy(imgs)[None],
                   torch.from_numpy(labels)[None],
                   torch.from_numpy(is_real)[None])
    assert set(metrics) == set(jmetrics)
    for name, ref in jmetrics.items():
        np.testing.assert_allclose(metrics[name].item(), float(ref),
                                   rtol=1e-4, atol=1e-7, err_msg=name)
    gsd = from_jax_params(jgrads["model"], {})
    for name, p in model.named_parameters():
        if p.requires_grad:
            assert _rel_l2(p.grad.numpy(), gsd[name].numpy()) <= 1e-4, name
    scale = np.float32(1.0 / cfg.SOLVER.CENTER_LOSS_WEIGHT)
    assert _rel_l2(centers.grad.numpy(), jgrads["centers"] * scale) <= 1e-4
    new_stats = from_jax_params({}, jax.tree.map(np.asarray,
                                                 new_jstate.batch_stats))
    for key in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(model.state_dict()[key].numpy(),
                                   new_stats[key].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=key)
    adam = jax.tree.map(np.asarray, new_jstate.opt_state[0]).inner_states[
        "model"].inner_state.inner_state[1]
    mu = from_jax_params(adam.mu["model"], {})
    nu = from_jax_params(adam.nu["model"], {})
    for name, p in model.named_parameters():
        if p.requires_grad:
            st = opt.state[p]
            assert _rel_l2(st["exp_avg"].numpy(), mu[name].numpy()) <= 1e-4
            assert _rel_l2(st["exp_avg_sq"].numpy(),
                           nu[name].numpy()) <= 1e-4, name
            assert st["step"].item() == int(adam.count) == 3


def test_fit_resumes_a_jax_checkpoint_at_the_next_epoch(
        data_root, tmp_path, monkeypatch):  # noqa: F811
    path, jstate = write_jax_checkpoint(tmp_path / "jax", 8, seed=5,
                                        epoch=0)
    restored = []
    real = FIT.restore_state

    def spy(p, state):
        out = real(p, state)
        restored.append((out.step, out.centers.detach().clone(),
                         copy.deepcopy(out.model.state_dict())))
        return out

    monkeypatch.setattr(FIT, "restore_state", spy)
    cfg = _cfg(data_root, tmp_path / "port", SOLVER__MAX_EPOCHS=2,
               MODEL__RESUME_TRAINING=True, MODEL__PRETRAIN_PATH=path)
    out, log_dir = _fit(cfg, data_root)
    assert "test_centroids_mAP" in out
    (step, centers, sd), = restored
    host = jax.tree.map(np.asarray, jstate)
    assert step == 1
    assert torch.equal(centers, torch.from_numpy(host.params["centers"]))
    for name, ref in from_jax_params(host.params["model"],
                                     host.batch_stats).items():
        assert torch.equal(sd[name], ref), name
    epochs = [json.loads(line).get("step") for line in open(
        os.path.join(log_dir, "train", "metrics.jsonl")) if '"lr"' in line]
    assert epochs == [1]
