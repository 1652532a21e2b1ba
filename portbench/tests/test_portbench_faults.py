"""Dry runs on the CPU: a sound run comes out correct; with the timed
path broken underneath (each fault the cell can have) ``correct`` comes
out false. One chip, so there is no exchange between chips to leave
out."""

from unittest import mock

import pytest

import dry
from harness import evalstream


def _streaming():
    from centroids_reid_tpu_torch.metrics import r1_map

    # at the cell's size R1mAP streams by itself; at the dry size it would
    # materialise, so the switch is lowered
    return mock.patch.object(r1_map, "_STREAMING_CELLS", 0)


def test_eval_sound(tmp_path):
    with _streaming():
        line, _ = dry.measure("market-r50-eval500k", str(tmp_path))
    assert line["correct"] is True


@pytest.mark.parametrize("kind", ["half", "altered"])
def test_eval_faults(kind, tmp_path):
    from centroids_reid_tpu_torch.metrics import streaming_eval as se

    with _streaming(), mock.patch.object(se, "compute_stream_ranks",
                                         evalstream._plant(kind)):
        line, _ = dry.measure("market-r50-eval500k", str(tmp_path))
    assert line["correct"] is False
