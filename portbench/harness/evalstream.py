"""Driver "eval": ``R1mAP.compute`` back to back on Market-1501's test
split with its 500,000 distractors, which takes the streaming evaluator
by itself (``metrics/r1_map.py``, ``metrics/streaming_eval.py``).

Set-up draws the features (queries, gallery, distractors: unit rows
around identity centres), their pids and cameras on the card from the
seed, and runs one evaluation (the kernels' first use). The window runs
whole evaluations until ``seconds`` have passed, each ending in the
metrics on the host. Then every evaluation's metrics are held against the
plain reference's on the same features."""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from .common import Cell, Check, Outcome, log, port_cfg, subseed

AP_ROUNDING = 1e-6   # an AP of a few hundred hits summed in fp32


def features(cell: Cell):
    """(feats [Q + G, D] card fp32, pids, cameras) of the cell; the queries
    first, the distractors last (pid ``pids``: no query's)."""
    import torch

    from .weights import embeddings

    spec = cell.config["gallery"]
    gen = torch.Generator(device=cell.device).manual_seed(
        subseed(cell.seed, "features"))
    own = spec["query"] + spec["gallery"]
    f, pid = embeddings(spec, own, gen)
    pids = torch.cat([pid, torch.full((spec["distractors"],), spec["pids"],
                                      device=pid.device, dtype=pid.dtype)])
    cams = torch.randint(0, spec["cams"], (f.shape[0],), generator=gen,
                         device=gen.device)
    return f, pids.cpu().numpy(), cams.cpu().numpy()


def evaluator(cell: Cell):
    from centroids_reid_tpu_torch.metrics import R1mAP

    cfg = port_cfg(cell.config, "eval")
    return R1mAP(cell.config["gallery"]["query"], max_rank=50,
                 feat_norm=bool(cfg.TEST.FEAT_NORM),
                 dist_name=str(cfg.SOLVER.DISTANCE_FUNC), device=cell.device)


def compare(results: List, ref: dict) -> Dict[str, float]:
    """The widest readings over every evaluation. Against the band (every
    order within the traffic's ``band`` of the reference's fp32
    distances): ``ap_outside``, how far any query's AP lies outside its
    range; ``queries_outside``, how many lie outside it by more than
    AP_ROUNDING (an AP summed in fp32); ``map_outside`` and
    ``cmc_outside`` the same for the mAP and any rank of the CMC curve.
    Against the exact order: ``ap_gap``, ``ap_mean_gap``, ``map_gap``. A
    query kept on one side and dropped on the other reads infinite."""
    valid = np.nonzero(~np.isnan(ref["ap"]))[0]
    keys = ("ap_outside", "queries_outside", "map_outside", "cmc_outside",
            "ap_gap", "ap_mean_gap", "map_gap")
    out = dict.fromkeys(keys, 0.0)
    for m in results:
        sp = m.single_performance
        got = dict.fromkeys(keys, float("inf"))
        if sp.shape[0] == valid.size and np.array_equal(
                sp[:, 0].astype(np.int64), valid):
            ap = sp[:, 2]
            outside = np.maximum(0.0, np.maximum(ref["ap_lo"][valid] - ap,
                                                 ap - ref["ap_hi"][valid]))
            d = np.abs(ap - ref["ap"][valid])
            cmc = np.asarray(m.cmc, np.float64)
            got = {"ap_outside": float(outside.max()),
                   "queries_outside": float((outside > AP_ROUNDING).sum()),
                   "map_outside": max(0.0, ref["map_lo"] - m.mAP,
                                      m.mAP - ref["map_hi"]),
                   "cmc_outside": float(np.maximum(
                       0.0, np.maximum(ref["cmc_lo"] - cmc,
                                       cmc - ref["cmc_hi"])).max()),
                   "ap_gap": float(d.max()), "ap_mean_gap": float(d.mean()),
                   "map_gap": abs(m.mAP - ref["mAP"])}
        out = {k: max(out[k], got[k]) for k in keys}
    return out


def reference(cell: Cell, feats, pids, cams, tf32: bool = False) -> dict:
    """The plain evaluation of the same features, with the order band of
    the traffic's ``band``."""
    import torch

    from reference.rmap import evaluate

    nq = cell.config["gallery"]["query"]
    f = feats / feats.norm(dim=1, keepdim=True).clamp_min(1e-12)
    p = torch.from_numpy(pids).to(feats.device)
    c = torch.from_numpy(cams).to(feats.device)
    return evaluate(f[:nq], f[nq:], p[:nq], p[nq:], c[:nq], c[nq:],
                    tf32=tf32, band=float(cell.traffic["band"]))


def _sync(cell: Cell) -> None:
    import torch

    if cell.device == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell) -> Outcome:
    import torch

    from .trace import traced

    feats, pids, cams = features(cell)
    r1 = evaluator(cell)
    first = r1.compute(feats, pids, cams)   # the kernels' first use
    _sync(cell)
    setup_s = time.perf_counter() - cell.t0
    results = [first]
    observed: dict = {}
    if cell.trace:
        n = int(cell.traffic["trace_evals"])
        with traced(cell.scratch, cell.device, host=False) as dev_only:
            for _ in range(n):
                results.append(r1.compute(feats, pids, cams))
        with traced(cell.scratch, cell.device) as both:
            results.append(r1.compute(feats, pids, cams))
        t = dev_only.trace
        spec = cell.config["gallery"]
        observed = {"window_s": t.window_s, "busy_s": t.busy_s(),
                    "evals": n, "trace": t, "queries": spec["query"],
                    "gallery_rows": spec["gallery"] + spec["distractors"],
                    "dim": feats.shape[1],
                    "passes": int(cell.traffic["distance_passes"]),
                    "breakdown": both.trace.breakdown()}
        evals = n
    else:
        t0 = time.perf_counter()
        evals = 0
        while True:
            results.append(r1.compute(feats, pids, cams))
            evals += 1
            if time.perf_counter() - t0 >= cell.seconds:
                break
        _sync(cell)
        wall = time.perf_counter() - t0
        log(cell, f"window: {evals} evaluations in {wall:.3f} s")
    peak = torch.cuda.max_memory_allocated() if cell.device == "cuda" else 0
    del r1
    ref = reference(cell, feats, pids, cams)
    gaps = compare(results, ref)
    checks = [Check(k, gaps[k], float(v)) for k, v in cell.limits.items()]
    e2e = {} if cell.trace else {"setup_s": setup_s, "eval_s": wall / evals}
    out = Outcome(e2e, observed, checks, attempted=evals, failed=0,
                  memory_peak_bytes=peak)
    if cell.trace:
        out.busy_s, out.window_s = observed["busy_s"], observed["window_s"]
        out.breakdown = observed["breakdown"]
    return out


# ------------------------------------------------------------ calibration

def _plant(kind: str):
    """A fault in the streaming evaluator's ranks: "half" drops the second
    half of the gallery rows; "altered" moves query 0's first kept hit
    one rank down."""
    from centroids_reid_tpu_torch.metrics import streaming_eval as se

    real = se.compute_stream_ranks

    def faulty(qf, gf, q_pids, g_pids, q_camids, g_camids, **kw):
        if kind == "half":
            n = gf.shape[0] // 2
            return real(qf, gf[:n], q_pids, g_pids[:n], q_camids,
                        g_camids[:n], **kw)
        sr = real(qf, gf, q_pids, g_pids, q_camids, g_camids, **kw)
        sr.ranks[0] += 1
        return sr

    return faulty


FAULTS = ("half", "altered")


def calibrate(cells, controls: int, faults: int) -> list:
    """Per seed the sound program's gaps over one evaluation, for the first
    ``controls`` seeds the control's (the reference with TF32 on, in the
    program's place) and for the first ``faults`` each planted fault's."""
    from unittest import mock

    from centroids_reid_tpu_torch.metrics import streaming_eval as se

    rows = []
    for i, cell in enumerate(cells):
        feats, pids, cams = features(cell)
        ref = reference(cell, feats, pids, cams)
        row = {"seed": cell.seed,
               "program": compare([evaluator(cell).compute(feats, pids,
                                                          cams)], ref)}
        if i < controls:
            ctl = reference(cell, feats, pids, cams, tf32=True)
            row["control"] = compare([_as_metrics(ctl)], ref)
        for kind in FAULTS if i < faults else ():
            with mock.patch.object(se, "compute_stream_ranks",
                                   _plant(kind)):
                got = evaluator(cell).compute(feats, pids, cams)
            row[f"fault_{kind}"] = compare([got], ref)
        rows.append(row)
        log(cell, f"calibration {i}: {row}")
    return rows


def _as_metrics(ref: dict):
    """A reference result in the program's ``ReidMetrics`` shape."""
    from types import SimpleNamespace

    valid = np.nonzero(~np.isnan(ref["ap"]))[0]
    sp = np.stack([valid, np.zeros_like(valid), ref["ap"][valid]], axis=1)
    return SimpleNamespace(mAP=ref["mAP"], cmc=ref["cmc"],
                           single_performance=sp)
