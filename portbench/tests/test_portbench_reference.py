"""The plain reference against hand-checked cases, and against the port on
the CPU where both compute the same function in fp32 (a frozen copy must
still be the function the cell's program computes)."""

import numpy as np
import pytest
import torch

import dry  # noqa: F401
from harness import weights as W
from reference import rmap


def test_map_and_cmc_hand_case():
    # one query (pid 0, camera 0); gallery ranked by distance: a junk entry
    # (pid 0, camera 0), a miss, a hit, a miss, a hit
    qf = torch.tensor([[1.0, 0.0]])
    gf = torch.tensor([[1.0, 0.0], [0.99, 0.14], [0.9, 0.43], [0.8, 0.6],
                       [0.5, 0.86]])
    gf = gf / gf.norm(dim=1, keepdim=True)
    out = rmap.evaluate(qf, gf, torch.tensor([0]),
                        torch.tensor([0, 1, 0, 2, 0]), torch.tensor([0]),
                        torch.tensor([0, 1, 1, 1, 2]), max_rank=4)
    # kept order: miss, hit (rank 2), miss, hit (rank 4): AP = (1/2 + 2/4)/2
    assert out["mAP"] == pytest.approx(0.5)
    assert out["cmc"].tolist() == [0.0, 1.0, 1.0, 1.0]


def test_band_zero_gives_the_exact_order():
    g = torch.Generator().manual_seed(5)
    f = torch.randn(30, 8, generator=g)
    f = f / f.norm(dim=1, keepdim=True)
    pids = torch.randint(0, 4, (30,), generator=g)
    cams = torch.randint(0, 3, (30,), generator=g)
    out = rmap.evaluate(f[:6], f[6:], pids[:6], pids[6:], cams[:6],
                        cams[6:], max_rank=5, block=4)
    ok = ~np.isnan(out["ap"])
    assert ok.any()
    assert np.array_equal(out["ap_lo"][ok], out["ap"][ok])
    assert np.array_equal(out["ap_hi"][ok], out["ap"][ok])
    assert np.array_equal(out["cmc_lo"], out["cmc"])


def test_band_holds_the_port_streaming_evaluator():
    """The port's streaming evaluation of the same rows lies inside the
    reference's band on every query, and its mAP and CMC inside theirs."""
    from unittest import mock

    from centroids_reid_tpu_torch.metrics import R1mAP, r1_map

    g = torch.Generator().manual_seed(6)
    spec = {"query": 20, "gallery": 120, "distractors": 600, "pids": 10,
            "cams": 6, "own_noise": 0.8, "distractor_noise": 1.0}
    f, pid = W.embeddings(spec, 140, g, dim=64)
    pids = torch.cat([pid, torch.full((600,), 10)])
    cams = torch.randint(0, 6, (740,), generator=g)
    ref = rmap.evaluate(f[:20], f[20:], pids[:20], pids[20:], cams[:20],
                        cams[20:], band=1e-5)
    with mock.patch.object(r1_map, "_STREAMING_CELLS", 0):
        got = R1mAP(20, max_rank=50, feat_norm=True, device="cpu").compute(
            f, pids.numpy(), cams.numpy())
    sp = got.single_performance
    q = sp[:, 0].astype(np.int64)
    assert np.array_equal(q, np.nonzero(~np.isnan(ref["ap"]))[0])
    assert np.all(sp[:, 2] >= ref["ap_lo"][q] - 1e-6)
    assert np.all(sp[:, 2] <= ref["ap_hi"][q] + 1e-6)
    assert ref["map_lo"] - 1e-6 <= got.mAP <= ref["map_hi"] + 1e-6
    cmc = np.asarray(got.cmc, np.float64)
    assert np.all(cmc >= ref["cmc_lo"] - 1e-9)
    assert np.all(cmc <= ref["cmc_hi"] + 1e-9)
