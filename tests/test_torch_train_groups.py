"""``TPU.NUM_GROUPS`` > 1 in the port: the train step over G groups against
the JAX package's step (its ``vmap`` over the group axis) on one set of
weights, resnet18 at 32x16, P = 4, K = 4 with one mock a group, fp32, on
the CPU; and the group-major ``TrainLoader``.

Held at G = 2 and G = 4, as ``tests/test_torch_train_step.py`` holds one
group:

* every loss term and metric (means over the groups): rtol 1e-4;
* every gradient (the mean over groups), the centers' included: a relative
  L2 error of at most 1e-4 per tensor;
* the BNNeck running statistics (the mean of the groups' updates): 1e-6;
* the trunk's running statistics: the mean to rtol 1e-4, the variance
  after the one deliberate difference (``nn.BatchNorm2d``'s unbiased batch
  variance against Flax's biased one, n / (n - 1) with n the rows x H x W
  of one group's layer input).

At G = 1 the step is the one-group step unchanged: its parameters, buffers,
gradients and metrics equal, bit for bit, those of the loss, backward and
optimizer step composed from ``make_loss_fn``. ``TrainLoader`` batches at
G = 2 equal the JAX package's, and so do the plan arrays.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu_torch.engine import steps as TSTEPS
from centroids_reid_tpu_torch.models import from_jax_params
from test_torch_train_step import (
    C,
    _batch,
    _bn_input_sizes,
    _cfgs,
    _initial_jax_state,
    _jax_step,
    _port_state,
    _rel_l2,
)


def _groups(g, seed):
    batches = [_batch(seed + i) for i in range(g)]
    return tuple(np.stack(a) for a in zip(*batches))


@pytest.mark.parametrize("groups", [2, 4])
def test_group_step_matches_jax(groups):
    _, cfg = _cfgs("ctl")
    cfg.TPU.NUM_GROUPS = groups
    jstep, _, _ = _jax_step("ctl")
    jstate = _initial_jax_state("ctl")
    imgs, labels, is_real = _groups(groups, 30)
    new_jstate, jmetrics = jstep(jstate, {
        "images": jnp.asarray(imgs), "is_real": jnp.asarray(is_real),
        "labels": jnp.asarray(labels.astype(np.int32))})

    state = _port_state(jstate.params, jstate.batch_stats, cfg)
    model = state.model
    sizes = _bn_input_sizes(model, torch.from_numpy(imgs[0]).permute(
        0, 3, 1, 2))
    old = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    step = TSTEPS.make_train_step(state, cfg, C, "ctl")
    metrics = step(torch.from_numpy(imgs), torch.from_numpy(labels),
                   torch.from_numpy(is_real))
    grads = {n: p.grad.numpy() for n, p in model.named_parameters()
             if p.requires_grad}
    grads["centers"] = state.centers.grad.numpy()
    assert_step_matches_jax(
        cfg, new_jstate, jmetrics, {k: v.item() for k, v in metrics.items()},
        grads, {k: v.numpy() for k, v in model.state_dict().items()}, old,
        sizes)


def assert_step_matches_jax(cfg, new_jstate, jmetrics, metrics, grads, sd,
                            old, sizes):
    """A port step's results (numpy / float dicts: its metrics, the
    trainable parameters' gradients and ``"centers"``, the state dict after
    and before the step) against the JAX step's, at this file's
    tolerances. ``sizes``: rows x H x W of each trunk BN's input."""
    assert set(metrics) == set(jmetrics)
    for name, ref in jmetrics.items():
        np.testing.assert_allclose(metrics[name], float(ref),
                                   rtol=1e-4, atol=1e-7, err_msg=name)

    jgrads = jax.tree.map(np.asarray, new_jstate.opt_state[1])
    gsd = from_jax_params(jgrads["model"], {})
    for name, g in grads.items():
        if name != "centers":
            assert _rel_l2(g, gsd[name].numpy()) <= 1e-4, name
    scale = np.float32(1.0 / cfg.SOLVER.CENTER_LOSS_WEIGHT)
    assert _rel_l2(grads["centers"], jgrads["centers"] * scale) <= 1e-4

    new_stats = from_jax_params({}, jax.tree.map(np.asarray,
                                                 new_jstate.batch_stats))
    for key in ("bn.running_mean", "bn.running_var"):
        np.testing.assert_allclose(sd[key], new_stats[key].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=key)
    for prefix, n in sizes.items():
        jmean = new_stats[prefix + ".running_mean"].numpy()
        np.testing.assert_allclose(sd[prefix + ".running_mean"], jmean,
                                   rtol=1e-4, atol=1e-4 * np.abs(jmean).max())
        old_var = old[prefix + ".running_var"]
        biased = (new_stats[prefix + ".running_var"].numpy()
                  - 0.9 * old_var) / 0.1
        want = 0.9 * old_var + 0.1 * biased * n / (n - 1)
        np.testing.assert_allclose(sd[prefix + ".running_var"], want,
                                   rtol=1e-4, err_msg=prefix)
        assert np.array_equal(sd[prefix + ".num_batches_tracked"],
                              old[prefix + ".num_batches_tracked"] + 1)


@pytest.mark.parametrize("mode", ["ctl", "base"])
def test_one_group_is_the_one_group_step(mode):
    """G = 1, bit for bit: the step against loss, backward, the optimizers'
    step and the BNNeck statistics composed by hand."""
    _, cfg = _cfgs(mode)
    jstate = _initial_jax_state(mode)
    imgs, labels, is_real = (torch.from_numpy(a) for a in _batch(40))
    out = []
    for by_hand in (False, True):
        state = _port_state(jstate.params, jstate.batch_stats, cfg)
        model = state.model
        if by_hand:
            loss_fn = TSTEPS.make_loss_fn(model, state.centers, cfg, C, mode)
            model.train()
            state.optimizers.zero_grad()
            total, metrics, (mean, var) = loss_fn(imgs, labels, is_real)
            total.backward()
            state.optimizers.step()
            with torch.no_grad():
                model.bn.running_mean.copy_(mean)
                model.bn.running_var.copy_(var)
            metrics = {k: v.detach() for k, v in metrics.items()}
        else:
            metrics = TSTEPS.make_train_step(state, cfg, C, mode)(
                imgs[None], labels[None], is_real[None])
        grads = {n: p.grad.clone() for n, p in model.named_parameters()
                 if p.grad is not None}
        grads["centers"] = state.centers.grad.clone()
        out.append((metrics, grads, copy.deepcopy(model.state_dict()),
                    state.centers.detach().clone()))
    (m0, g0, s0, c0), (m1, g1, s1, c1) = out
    assert m0.keys() == m1.keys() and g0.keys() == g1.keys()
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
    assert all(torch.equal(g0[k], g1[k]) for k in g0)
    assert all(torch.equal(s0[k], s1[k]) for k in s0)
    assert torch.equal(c0, c1)


def test_train_loader_groups_equal_jax(tmp_path):
    from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
    from centroids_reid_tpu.data import init_dataset as jinit
    from centroids_reid_tpu.data import loader as JLD
    from centroids_reid_tpu.data.device_data import plan_to_arrays as jplan
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.data import TrainLoader, init_dataset
    from centroids_reid_tpu_torch.data.device_data import plan_to_arrays
    from test_torch_train_data import COUNTS, _write_market

    root = _write_market(tmp_path, COUNTS)
    cfgs = []
    for make in (jax_default_cfg, get_default_cfg):
        cfg = make()
        cfg.DATASETS.ROOT_DIR = root
        cfg.INPUT.SIZE_TRAIN = [32, 16]
        cfg.SOLVER.IMS_PER_BATCH = 3
        cfg.DATALOADER.NUM_INSTANCE = 4
        cfg.DATALOADER.USE_RESAMPLING = False
        cfgs.append(cfg)
    jds, tds = (jinit("market1501", cfgs[0]),
                init_dataset("market1501", cfgs[1]))
    jl = JLD.TrainLoader(jds, cfgs[0], num_groups=2)
    tl = TrainLoader(tds, cfgs[1], num_groups=2)
    for epoch in (0, 2):
        got, ref = list(tl.epoch(epoch)), list(jl.epoch(epoch))
        assert any(not g["is_real"].all() for g in got)   # mock slots
        assert len(got) == len(ref) == tl.plan_for_epoch(epoch).num_steps > 0
        for g, r in zip(got, ref):
            assert g["images"].shape[:2] == (2, 12)
            for name in ("images", "labels", "camids", "is_real"):
                assert np.array_equal(g[name], r[name]), name
        for a, b in zip(plan_to_arrays(tl.plan_for_epoch(epoch), tds.train),
                        jplan(jl.plan_for_epoch(epoch), jds.train)):
            assert a.shape[1] == 2 and np.array_equal(a, b)
