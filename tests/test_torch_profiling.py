"""The port's profiling hooks (``centroids_reid_tpu_torch/utils/profiling.py``)
and the spans and counters of the streaming evaluator, on the CPU.

A span costs a flag check with no profiler running and records nothing;
under a profiler it is a ``user_annotation`` of the exported trace, kept
in memory on the trace's clock with the span that holds it. Counters
count only under a profiler. An evaluation records its layer spans and
its two passes once each, and the count pass's counters, counted from
host values, agree with the positives table and with a count by hand.
Tracing leaves the metrics bit for bit as they are."""

import json
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from centroids_reid_tpu_torch.metrics import R1mAP
from centroids_reid_tpu_torch.metrics import streaming_eval as S
from centroids_reid_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def _fresh_record():
    profiling.reset()
    yield
    profiling.reset()


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_no_profiler_enters_no_range_and_records_nothing():
    with mock.patch.object(torch.profiler, "record_function") as rf:
        first, second = profiling.annotate("a"), profiling.annotate("b")
        with first:
            with second:
                pass
    rf.assert_not_called()
    assert first is second                      # one shared null context
    assert profiling.spans() == []


@pytest.mark.parametrize("profiled", [False, True])
def test_counters_count_only_under_a_profiler(profiled):
    if profiled:
        with _cpu_profile():
            profiling.count("x", 3)
            profiling.count("x", 4)
            profiling.count("y", 1)
        profiling.count("x", 100)               # the profiler has stopped
        assert profiling.counts() == {"x": 7, "y": 1}
    else:
        profiling.count("x", 3)
        assert profiling.counts() == {}


def test_spans_nest_and_match_the_trace(tmp_path):
    # the process's first range pays torch's one-time set-up inside
    # record_function, after its own time stamp: take it here
    with _cpu_profile():
        with profiling.annotate("warm"):
            pass
    profiling.reset()
    with _cpu_profile() as prof:
        with profiling.annotate("root"):
            with profiling.annotate("child.a"):
                torch.ones(64).sum()
                with profiling.annotate("grandchild"):
                    torch.ones(64).sum()
            with profiling.annotate("child.b"):
                torch.ones(64).sum()
    got = {s.name: s for s in profiling.spans()}
    assert set(got) == {"root", "child.a", "grandchild", "child.b"}
    assert got["root"].parent == -1
    assert got["child.a"].parent == got["root"].index
    assert got["child.b"].parent == got["root"].index
    assert got["grandchild"].parent == got["child.a"].index
    for s in got.values():
        assert s.start <= s.end

    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = {e["name"]: e for e in events
              if e.get("cat") == "user_annotation" and e["name"] in got}
    assert set(ranges) == set(got)
    for name, s in got.items():
        e = ranges[name]
        assert abs(e["ts"] - s.start) < 100, name
        assert abs(e["ts"] + e["dur"] - s.end) < 100, name


def _reid_set(q=300, g=500, d=16, pids=30, cams=6, seed=0):
    rng = np.random.RandomState(seed)
    feats = rng.randn(q + g, d).astype(np.float32)
    pid = rng.randint(0, pids, q + g)
    cam = rng.randint(0, cams, q + g)
    return feats, pid, cam


def _small_tiles(g_chunk):
    real = S.compute_stream_ranks

    def run(*a, **kw):
        kw["g_chunk"] = g_chunk
        return real(*a, **kw)

    return mock.patch.object(S, "compute_stream_ranks", run)


def test_streaming_evaluation_spans_and_counters():
    q, g, g_chunk = 300, 500, 64
    feats, pid, cam = _reid_set(q, g)
    r1 = R1mAP(q, streaming=True, feat_norm=False, device="cpu")
    with _small_tiles(g_chunk), _cpu_profile():
        r1.compute(feats, pid, cam)
    names = Counter(s.name for s in profiling.spans())
    assert names == {"eval": 1, "eval.positives": 1, "eval.place": 1,
                     "eval.extract": 1, "eval.count": 1,
                     "eval.to_host": 1, "eval.metrics": 1}
    root = next(s for s in profiling.spans() if s.name == "eval")
    assert all(s.parent == root.index for s in profiling.spans()
               if s.name != "eval")

    # by hand: each query's hits (same pid, another camera) against every
    # gallery row; the rows searched are the farthest hits' ranks
    q_pid, g_pid, q_cam, g_cam = pid[:q], pid[q:], cam[:q], cam[q:]
    hits = ((g_pid[None, :] == q_pid[:, None])
            & (g_cam[None, :] != q_cam[:, None])).sum(axis=1)
    sr = S.compute_stream_ranks(feats[:q], feats[q:], q_pid, g_pid, q_cam,
                                g_cam, g_chunk=g_chunk, device="cpu")
    assert profiling.counts() == {
        "eval.pairs_compared": int(hits.sum()) * g,
        "eval.pairs_useful": int(hits.sum()) * g,
        "eval.entries_searched": int(np.where(sr.pos >= 0, sr.ranks, 0)
                                     .max(axis=1).sum()),
        "eval.entries_scanned": q * g}


# A line of rows (the first coordinate; squared distances are exact
# integers) with ties: q0 at 0 (pid 1, camera 0) has hits 0 (d 9, tied
# with rows 2 and 4 after it) and 5 (d 36), row 3 its junk; q1 at 10
# (pid 2, camera 1) has hit 7 (d 4, tied with row 9 after it), row 6 its
# junk; q2 (pid 9) has none.
_LINE_Q = ([0, 10, 5], [1, 2, 9], [0, 1, 0])
_LINE_G = ([3, 1, -3, 2, 3, 6, 10, 12, 9, 8], [1, 5, 5, 1, 6, 1, 2, 2, 7, 7],
           [1, 0, 0, 0, 2, 2, 1, 0, 1, 1])


@pytest.mark.parametrize("shards", [0, 2])
@pytest.mark.parametrize("respect_camids", [False, True])
def test_streaming_counters_by_hand(respect_camids, shards):
    """q0's kept rows in order: 1 (d 1), 0, 2, 4 (d 9, by index), 5 (d 36),
    ...: ranks 1 and 4, and 4 rows lie under its farthest hit; q1's: 8
    (d 1), 7, 9 (d 4): rank 1, 1 row searched; q2 searches none. Cameras
    as bitmasks under ``respect_camids``; two CPU shards of 8 and 2 rows."""
    from centroids_reid_tpu_torch.parallel import make_retrieval_mesh

    def rows(values):
        f = np.zeros((len(values), 4), np.float32)
        f[:, 0] = values
        return f

    (qv, qp, qc), (gv, gp, gc) = _LINE_Q, _LINE_G
    g_cams = (1 << np.array(gc)) if respect_camids else np.array(gc)
    mesh = make_retrieval_mesh(devices=["cpu"] * shards) if shards else None
    with _cpu_profile():
        sr = S.compute_stream_ranks(rows(qv), rows(gv), np.array(qp),
                                    np.array(gp), np.array(qc), g_cams,
                                    respect_camids=respect_camids, mesh=mesh,
                                    g_chunk=4, device="cpu")
    np.testing.assert_array_equal(sr.num_rel, [2, 1, 0])
    np.testing.assert_array_equal(sr.pos[:, :2], [[0, 5], [7, -1],
                                                  [-1, -1]])
    np.testing.assert_array_equal(sr.ranks[:, :2], [[1, 4], [1, 0], [0, 0]])
    np.testing.assert_array_equal(sr.dpos[:, :2], [[9, 36], [4, 0], [0, 0]])
    assert profiling.counts() == {
        "eval.pairs_compared": 3 * 10, "eval.pairs_useful": 3 * 10,
        "eval.entries_searched": 4 + 1 + 0, "eval.entries_scanned": 3 * 10}


@pytest.mark.parametrize("rerank_window", [0, 40])
def test_metrics_are_the_same_with_the_profiler_on(rerank_window):
    q = 150
    feats, pid, cam = _reid_set(q, 400)
    r1 = R1mAP(q, streaming=True, rerank=bool(rerank_window),
               rerank_window=rerank_window, device="cpu")
    with _small_tiles(128):
        off = r1.compute(feats, pid, cam)
        with _cpu_profile():
            on = r1.compute(feats, pid, cam)
    assert Counter(s.name for s in profiling.spans())["eval.metrics"] == 1
    assert on.mAP == off.mAP
    np.testing.assert_array_equal(on.cmc, off.cmc)
    np.testing.assert_array_equal(on.all_topk, off.all_topk)
    np.testing.assert_array_equal(on.single_performance,
                                  off.single_performance)
