"""``fit`` over 2 processes (``torch.distributed``, gloo, on the CPU;
resnet18 at 32x16, P = 4, K = 4, fp32, 2 epochs, validation every epoch)
with ``TPU.NUM_GROUPS 0`` (G = the process count, 2) against the
one-process ``fit`` at ``TPU.NUM_GROUPS 2``, on the device-resident and on
the host-streamed batches:

* the final state (``state.pt`` of the ring checkpoint) and every epoch's
  logged losses are equal bit for bit: each rank trains its group of the
  same global plan with the same augmentation draws, and the step's
  all-reduce adds the two groups' gradients as the one-process step does;
* one best checkpoint, one ring entry and one metrics stream (rank 0's,
  each epoch logged once);
* the final double test gives the same metrics on both ranks, those of
  the one-process run (Top-k equal, mAP within 1e-6: the sharded
  extraction embeds each half of the val set in a batch of its own), and
  mAP > 0.9 on the colour-separable data.

Every process runs with one CPU thread and imports only the port
(``tests/fixtures/torch_dist_worker.py``). ``tests/test_torch_dist_runner.py``
launches the same through ``torchrun`` and the runner.
"""

import json
import os

import numpy as np
import pytest
import torch

from conftest import cpu_subprocess_env
from fixtures.torch_dist_worker import start, wait
from test_torch_train_fit import _assert_same_state, data_root  # noqa: F401


def fit_opts(data_root, groups: int, *extra) -> list:  # noqa: F811
    return ["DATASETS.ROOT_DIR", data_root, "MODEL.NAME", "resnet18",
            "MODEL.PRETRAINED", "False", "USE_MIXED_PRECISION", "False",
            "INPUT.SIZE_TRAIN", "[32,16]", "INPUT.SIZE_TEST", "[32,16]",
            "SOLVER.IMS_PER_BATCH", "4", "SOLVER.USE_WARMUP_LR", "False",
            "SOLVER.MAX_EPOCHS", "2", "SOLVER.EVAL_PERIOD", "1",
            "DATALOADER.USE_RESAMPLING", "False",
            "DATALOADER.NUM_WORKERS", "1", "REPRODUCIBLE_NUM_RUNS", "1",
            "MODEL.USE_CENTROIDS", "True", "TPU.NUM_GROUPS", str(groups),
            *extra]


def epoch_records(log_dir) -> list:
    with open(os.path.join(log_dir, "train", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [{k: v for k, v in r.items() if k not in ("time", "epoch_time_s")}
            for r in recs if "epoch_train_loss" in r]


def assert_same_run(dist_dir, one_dir) -> None:
    """One ring entry and one best checkpoint each; the ring states and
    the epochs' logged losses equal bit for bit."""
    for d in (dist_dir, one_dir):
        assert os.listdir(os.path.join(d, "auto_checkpoints")) == [
            "checkpoint_epoch1"]
        best = os.listdir(os.path.join(d, "checkpoints"))
        assert len(best) == 1 and best[0].startswith("epoch="), best
    states = [torch.load(os.path.join(d, "auto_checkpoints",
                                      "checkpoint_epoch1", "state.pt"),
                         weights_only=True) for d in (dist_dir, one_dir)]
    _assert_same_state(*states)
    recs = epoch_records(dist_dir)
    assert [r["step"] for r in recs] == [0, 1]
    assert recs == epoch_records(one_dir)


def assert_same_metrics(ranks_metrics, one_metrics) -> None:
    assert all(m == ranks_metrics[0] for m in ranks_metrics[1:])
    got = ranks_metrics[0]
    assert got.keys() == one_metrics.keys() and "test_centroids_mAP" in got
    for k, ref in one_metrics.items():
        tol = 1e-6 if k.endswith("mAP") else 0.0
        assert abs(got[k] - ref) <= tol, (k, got[k], ref)
    assert got["test_centroids_mAP"] > 0.9, got


def _metrics(out) -> dict:
    return {k[len("metric."):]: float(v) for k, v in out.items()
            if k.startswith("metric.")}


@pytest.mark.parametrize("batches", ["resident", "streaming"])
def test_two_process_fit_equals_one_process(data_root, tmp_path,  # noqa: F811
                                            batches):
    resident = ["TPU.DEVICE_RESIDENT_DATA", str(batches == "resident")]
    env = cpu_subprocess_env()
    dirs = {n: str(tmp_path / n) for n in ("dist", "one")}
    ranks = start(tmp_path, {"task": "fit", "log_dir": dirs["dist"],
                             "opts": fit_opts(data_root, 0, *resident)}, 2,
                  env)
    one = start(tmp_path, {"task": "fit", "log_dir": dirs["one"],
                           "opts": fit_opts(data_root, 2, *resident)}, 1,
                env, group=False)
    ranks, one = wait(ranks), wait(one)[0]
    assert_same_run(dirs["dist"], dirs["one"])
    assert_same_metrics([_metrics(r) for r in ranks], _metrics(one))
    assert all(int(r["jax_modules"]) == 0 for r in ranks + [one])
