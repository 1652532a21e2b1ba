"""The harness's arithmetic: seeds of any size, and the import guard's
names."""

import pytest

import dry  # noqa: F401  (puts the harness on the path)
from harness import common


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**40 + 3, -7])
def test_subseed_takes_any_whole_number(seed):
    a = common.subseed(seed, "w")
    assert 0 <= a < 2**63
    assert a == common.subseed(seed, "w")
    assert a != common.subseed(seed, "bank")


def test_blocked_modules_compares_whole_top_level_names():
    mods = {"centroids_reid_tpu_torch": 1, "centroids_reid_tpu_torch.ops": 1,
            "jaxtyping": 1, "numpy": 1}
    assert common.blocked_modules(mods) == []
    mods.update({"jax.numpy": 1, "centroids_reid_tpu.models": 1})
    assert common.blocked_modules(mods) == ["centroids_reid_tpu.models",
                                            "jax.numpy"]
