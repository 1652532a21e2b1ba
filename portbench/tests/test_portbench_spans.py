"""The readers of the program's spans and counters, on a dry traced run:
``positives_ms.eval`` reads the positives table's span, ``count_useful.eval``
the count pass's counters as worked out by hand, the three readers that
charge device time to spans read None on the CPU (no device events, not
0), and the run edits no file of the benchmark."""

import math
import os
import shutil
from unittest import mock

import dry
import numpy as np
from test_portbench_data_driven import _digests

from centroids_reid_tpu_torch.metrics import r1_map
from centroids_reid_tpu_torch.metrics import streaming_eval as S
from centroids_reid_tpu_torch.utils import profiling
from harness import evalstream

DEVICE_READERS = ("host_idle_ms.eval", "extract_ms.eval", "count_ms.eval")


def _useful_share(cell) -> float:
    """100 x pairs_useful / pairs_compared from the cell's pids and
    cameras: hits against real rows over 128 query rows a chunk x H
    padded to whole compare tiles x the gallery padded to whole tiles."""
    _, pids, cams = evalstream.features(cell)
    nq = cell.config["gallery"]["query"]
    q_pid, g_pid, q_cam, g_cam = pids[:nq], pids[nq:], cams[:nq], cams[nq:]
    hits = ((g_pid[None, :] == q_pid[:, None])
            & (g_cam[None, :] != q_cam[:, None])).sum(axis=1)
    h = math.ceil(hits.max() / S._H_CHUNK) * S._H_CHUNK
    g = g_pid.size
    compared = (math.ceil(nq / S._Q_CHUNK) * S._Q_CHUNK * h
                * math.ceil(g / S._G_CHUNK) * S._G_CHUNK)
    return 100.0 * int(hits.sum()) * g / compared


def test_dry_traced_run_reads_the_spans(tmp_path):
    base = tmp_path / "portbench"
    shutil.copytree(dry.BENCH, base,
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(dry.ROOT, "BENCHMARK.json"), tmp_path)
    before = _digests(base)
    profiling.reset()
    # stream at the dry size, as the cell does at its own
    with mock.patch.object(r1_map, "_STREAMING_CELLS", 0):
        line, out = dry.measure("market-r50-eval500k", str(tmp_path),
                                trace=True, base=str(base),
                                root=str(tmp_path))
    assert line["correct"] is True
    got = {k: v["value"] for k, v in line["metrics"].items()}
    assert got["positives_ms.eval"] > 0
    _, cell = dry.cell("market-r50-eval500k", trace=True)
    share = _useful_share(cell)
    assert 0 < got["count_useful.eval"] <= 100
    np.testing.assert_allclose(got["count_useful.eval"], share, rtol=1e-12)
    for name in DEVICE_READERS:
        assert name not in got
        assert dry.bench_run.reader(name, str(base)).read(
            out.observed) is None
    assert "eval_mfu" in got and "device_idle.eval" in got
    assert _digests(base) == before
