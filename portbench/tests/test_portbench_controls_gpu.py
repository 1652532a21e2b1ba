"""On the card, at each cell's own size: the control (the configuration's
next lower precision in the program's place) comes out not correct under the cell's limits on
three seeds, and the sound program comes out correct. Skips without a
card; run on a card machine with

    python -m pytest --noconftest -p no:cacheprovider \
        portbench/tests/test_portbench_controls_gpu.py
"""

import importlib
import tempfile
import time

import pytest

import dry  # noqa: F401
import run as bench_run

pytestmark = pytest.mark.gpu


@pytest.fixture()
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run only on the card")


def _fails(reading: dict, limits: dict) -> bool:
    return any(reading[k] > v for k, v in limits.items() if k in reading)


@pytest.mark.parametrize("workload", ["market-r50-eval500k"])
def test_control_fails_sound_program_passes(card, workload):
    bench = bench_run.benchmark()
    with tempfile.TemporaryDirectory() as scratch:
        cells = [bench_run.make_cell(bench, workload, 3_100_000_000 + i, 0,
                                     False, time.perf_counter(),
                                     scratch=scratch) for i in range(3)]
        driver = importlib.import_module(
            f"harness.{cells[0].traffic['driver']}")
        rows = driver.calibrate(cells, 3, 0)
    limits = cells[0].limits
    for r in rows:
        assert not _fails(r["program"], limits), r
        assert _fails(r["control"], limits), r
