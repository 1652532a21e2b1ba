"""The port's train step over processes (gloo, CPU; resnet18 at 32x16, P
= 4, K = 4 with one mock a group, fp32) with more than one group a rank:
2 ranks x 2 groups against G = 4 in one process, from one state and one
batch. The sums associate differently, so metrics and running statistics
are held to rtol 1e-6 and the gradients to 1e-6 relative L2; parameters
are not compared after the Adam step, whose first update is about lr *
sign(g) (``tests/test_torch_train_step.py``). The ranks end equal, bit for
bit. A group count that does not split over the ranks (G = 3 over 2)
raises ``ValueError`` on every rank."""

import numpy as np

from fixtures.torch_dist_worker import wait
from test_torch_dist_step import (
    assert_ranks_equal,
    part,
    start_step,
    step_input,
)
from test_torch_train_step import _rel_l2


def test_two_ranks_of_two_groups_match_four_groups(tmp_path):
    """Ranks of two groups each: the sums associate differently ((g0 + g1)
    + (g2 + g3) against ((g0 + g1) + g2) + g3), hence the tolerances."""
    *_, path = step_input(tmp_path, 4, 50)
    ranks = start_step(path, tmp_path, 2, refused_groups=[3])
    one = wait(start_step(path, tmp_path, 1, group=False))[0]
    ranks = wait(ranks)
    assert_ranks_equal(ranks)
    for out in ranks:
        assert "do not split evenly over 2 processes" in str(out["refused_3"])
    got = ranks[0]
    for k, ref in part(one, "metric.").items():
        np.testing.assert_allclose(got["metric." + k], ref, rtol=1e-6,
                                   err_msg=k)
    for k, ref in part(one, "grad.").items():
        assert _rel_l2(got["grad." + k], ref) <= 1e-6, k
    for k, ref in part(one, "state.").items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state." + k], ref, rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert np.array_equal(got["state." + k], ref), k
