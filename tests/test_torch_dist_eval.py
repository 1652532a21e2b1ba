"""Evaluation over processes (``torch.distributed``, gloo, on the CPU;
resnet18 at 32x16, fp32, 35 val records: 7 pids, 2 queries and 3 gallery
images each, a count that neither 2 nor 4 divides):

* ``extract_embeddings_sharded`` at 2 and at 4 ranks equals
  ``extract_embeddings`` on every rank, in record order: embeddings within
  1e-5, pids and camids equal; each rank decoded only its slice (at most
  ceil(35 / ranks) images) before the full extraction;
* ``balanced_slice`` equals the JAX package's over a grid of (n, p);
* ONLY_TEST through ``runner.run_single`` under 2 ranks gives the
  one-process metrics (Top-k equal, mAP within 1e-6) on both ranks.

Every process runs with one CPU thread and imports only the port
(``tests/fixtures/torch_dist_worker.py``)."""

import numpy as np
import pytest
import torch

from centroids_reid_tpu.engine.evaluate import balanced_slice as jax_slice
from centroids_reid_tpu_torch.engine.evaluate import balanced_slice
from conftest import cpu_subprocess_env
from fixtures.torch_dist_worker import launch, start, wait
from test_integration import _make_separable_market
from test_torch_dist_fit import assert_same_metrics

PIDS, RECORDS = 7, 35
OPTS = ["MODEL.NAME", "resnet18", "USE_MIXED_PRECISION", "False",
        "INPUT.SIZE_TEST", "[32,16]", "TEST.IMS_PER_BATCH", "8"]


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    return _make_separable_market(tmp_path_factory.mktemp("dist_eval"),
                                  n_pids=PIDS, per_pid=2)


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_extraction_equals_the_full_one(data_root, tmp_path, world):
    ranks = launch(tmp_path, {"task": "extract", "opts": [
        *OPTS, "DATASETS.ROOT_DIR", data_root]}, world,
        cpu_subprocess_env())
    per = -(-RECORDS // world)
    for out in ranks:
        assert int(out["records"]) == RECORDS
        assert out["emb"].shape == out["ref_emb"].shape == (RECORDS, 512)
        np.testing.assert_array_equal(out["pids"], out["ref_pids"])
        np.testing.assert_array_equal(out["camids"], out["ref_camids"])
        np.testing.assert_allclose(out["emb"], out["ref_emb"], rtol=0,
                                   atol=1e-5)
        assert 0 < int(out["decoded"]) <= per
        np.testing.assert_array_equal(out["emb"], ranks[0]["emb"])


def test_balanced_slice_equals_jax():
    for n in range(0, 40):
        for p in range(1, 9):
            cuts = [balanced_slice(n, p, r) for r in range(p)]
            assert cuts == [jax_slice(n, p, r) for r in range(p)]
            assert cuts[0][0] == 0 and cuts[-1][1] == n
            if n >= p:
                assert all(hi > lo for lo, hi in cuts)


def test_only_test_over_two_ranks_gives_the_one_process_metrics(
        data_root, tmp_path):
    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.models import create_model

    cfg = get_default_cfg()
    cfg.merge_from_list(OPTS)
    pth = str(tmp_path / "reid.pth")
    model = create_model(cfg, generator=torch.Generator().manual_seed(3))
    torch.save({"state_dict": model.state_dict()}, pth)
    opts = [*OPTS, "DATASETS.ROOT_DIR", data_root, "TEST.ONLY_TEST", "True",
            "MODEL.PRETRAIN_PATH", pth]
    env = cpu_subprocess_env()
    ranks = start(tmp_path, {"task": "only_test", "opts": opts,
                             "log_dir": str(tmp_path / "dist")}, 2, env)
    one = start(tmp_path, {"task": "only_test", "opts": opts,
                           "log_dir": str(tmp_path / "one")}, 1, env,
                group=False)
    ranks, one = wait(ranks), wait(one)[0]

    def metrics(out):
        return {k[len("metric."):]: float(v) for k, v in out.items()
                if k.startswith("metric.")}

    assert_same_metrics([metrics(r) for r in ranks], metrics(one))
    assert (tmp_path / "dist" / "test" / "version_0").is_dir()
    assert not (tmp_path / "dist" / "test" / "version_1").exists()
