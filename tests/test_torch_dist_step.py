"""The port's train step over processes (``torch.distributed``, gloo, on the
CPU; resnet18 at 32x16, P = 4, K = 4 with one mock a group, fp32): each
rank steps its groups of the global batch and one ``all_reduce`` sums the
gradients and averages the running statistics and metrics.

* 2 ranks x 1 group against the JAX package's step at G = 2 (its ``vmap``
  over the group axis), from one state and one batch, at
  ``tests/test_torch_train_groups.py``'s tolerances: every loss term and
  metric rtol 1e-4; every gradient, the centers' included, within 1e-4
  relative L2; the BNNeck's running statistics 1e-6; the trunk's mean rtol
  1e-4 and its variance after the n / (n - 1) correction.
* 2 ranks x 1 group against the port's one-process step at G = 2, bit for
  bit: metrics, gradients, every state tensor after the Adam and center
  steps. Each rank's backward is the one-process step's for its group
  (the loss scaled by 1 / 2), the sum of two terms is the same in either
  order, and halving is exact.

The ranks end with equal states, bit for bit. Every worker (and the
one-process reference) runs with one CPU thread, in a process that imports
only the port (``tests/fixtures/torch_dist_worker.py``).
``tests/test_torch_dist_groups.py`` holds ranks of two groups each.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import cpu_subprocess_env
from fixtures.torch_dist_worker import start, wait
from test_torch_train_groups import _groups, assert_step_matches_jax
from test_torch_train_step import (
    C,
    HW,
    K,
    P,
    _bn_input_sizes,
    _cfgs,
    _initial_jax_state,
    _jax_step,
    _port_state,
)

OPTS = ["MODEL.NAME", "resnet18", "USE_MIXED_PRECISION", "False",
        "INPUT.SIZE_TRAIN", str(list(HW)), "SOLVER.IMS_PER_BATCH", str(P),
        "DATALOADER.NUM_INSTANCE", str(K)]


def step_input(tmp_path, groups: int, seed: int):
    """The JAX initial state as a port state, and a batch of ``groups``
    groups, saved for the workers."""
    _, cfg = _cfgs("ctl")
    jstate = _initial_jax_state("ctl")
    state = _port_state(jstate.params, jstate.batch_stats, cfg)
    imgs, labels, is_real = _groups(groups, seed)
    path = tmp_path / f"step_input_{groups}.pt"
    torch.save({"model": state.model.state_dict(),
                "centers": state.centers.detach(), "num_classes": C,
                "images": torch.from_numpy(imgs),
                "labels": torch.from_numpy(labels),
                "is_real": torch.from_numpy(is_real)}, path)
    return jstate, state, (imgs, labels, is_real), str(path)


def start_step(path, tmp_path, world, group=True, **spec):
    """The step on ``world`` ranks (``group`` False: one process, no
    process group), started; ``wait`` for it."""
    return start(tmp_path, {"task": "step", "mode": "ctl", "opts": OPTS,
                            "input": path, **spec}, world,
                 cpu_subprocess_env(), group=group)


def part(out, prefix):
    return {k[len(prefix):]: v for k, v in out.items()
            if k.startswith(prefix)}


def assert_ranks_equal(outs):
    for out in outs[1:]:
        for k, v in outs[0].items():
            if k.startswith(("state.", "grad.", "metric.")):
                assert np.array_equal(out[k], v), k


@pytest.fixture(scope="module")
def two_by_one(tmp_path_factory):
    tmp_path = tmp_path_factory.mktemp("dist_step")
    jstate, state, batch, path = step_input(tmp_path, 2, 30)
    ranks = start_step(path, tmp_path, 2)
    one = start_step(path, tmp_path, 1, group=False)
    return jstate, state, batch, wait(ranks), wait(one)[0]


def test_two_ranks_match_the_jax_step(two_by_one):
    jstate, state, (imgs, labels, is_real), ranks, _ = two_by_one
    assert_ranks_equal(ranks)
    jstep, _, _ = _jax_step("ctl")
    new_jstate, jmetrics = jstep(jstate, {
        "images": jnp.asarray(imgs), "is_real": jnp.asarray(is_real),
        "labels": jnp.asarray(labels.astype(np.int32))})
    _, cfg = _cfgs("ctl")
    cfg.TPU.NUM_GROUPS = 2
    out = ranks[0]
    sizes = _bn_input_sizes(state.model, torch.from_numpy(imgs[0]).permute(
        0, 3, 1, 2))
    assert_step_matches_jax(
        cfg, new_jstate, jmetrics,
        {k: float(v) for k, v in part(out, "metric.").items()},
        part(out, "grad."), part(out, "state."),
        {k: v.numpy() for k, v in state.model.state_dict().items()}, sizes)


def test_two_ranks_equal_the_one_process_step_bit_for_bit(two_by_one):
    *_, ranks, one = two_by_one
    keys = {k for k in one if k.startswith(("state.", "grad.", "metric."))}
    assert keys and keys == {k for k in ranks[0]
                             if k.startswith(("state.", "grad.", "metric."))}
    for k in sorted(keys):
        assert ranks[0][k].dtype == one[k].dtype, k
        assert np.array_equal(ranks[0][k], one[k]), k
