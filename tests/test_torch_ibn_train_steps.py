"""Three train steps of the ResNet50-IBN-a cut against the JAX package's,
in float64 (the JAX trunk as ``ReidModel(dtype=float64)`` under
``jax.enable_x64``; why float64: ``test_torch_ibn_train_step.py``), ctl
and base: each port step starts from the JAX state of that step and is
held as there (loss terms and metrics rtol 1e-4, gradients <= 1e-4
relative L2 per tensor, running statistics). Parameters are not compared
after an Adam step (``test_torch_train_step.py`` says why)."""

import pytest

from test_torch_ibn_train_step import (  # noqa: F401  (the fixture)
    _batch,
    _check_step,
    _initial_jax_state,
    ibn_cut,
)


@pytest.mark.parametrize("mode", ["ctl", "base"])
def test_three_ibn_steps_match_jax(mode):
    state = _initial_jax_state(mode, "float64")
    for t in range(3):
        state = _check_step(mode, state, _batch(10 + t), "float64")
    assert int(state.step) == 3
