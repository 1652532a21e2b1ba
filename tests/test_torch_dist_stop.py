"""The collective stop over 2 processes (gloo, CPU; resnet18 at 32x16,
G = 2, up to 30 epochs, validation every 3): SIGTERM to rank 0 alone at
the start of epoch 2 (the injection of ``tests/test_multihost.py``) stops
both ranks at epoch 2's end, where ``guard.should_stop`` takes the maximum
of the flags before the periodic validation. Both return ``preempted =
1.0`` and no double test; the ring holds exactly ``checkpoint_epoch2``
(rank 0's one save); no validation metric was logged. Had rank 1 gone on
alone, it would wait in epoch 3's first all-reduce until the group's
timeout and fail."""

import json
import os

from conftest import cpu_subprocess_env
from fixtures.torch_dist_worker import launch
from test_torch_dist_fit import fit_opts
from test_torch_train_fit import data_root  # noqa: F401


def test_sigterm_to_one_rank_stops_both(data_root, tmp_path):  # noqa: F811
    log_dir = str(tmp_path / "run")
    opts = fit_opts(data_root, 0, "SOLVER.MAX_EPOCHS", "30",
                    "SOLVER.EVAL_PERIOD", "3",
                    "TPU.PERIODIC_CHECKPOINT_INTERVAL", "100")
    ranks = launch(tmp_path, {"task": "fit", "log_dir": log_dir,
                              "opts": opts, "sigterm_epoch": 2,
                              "timeout": 60}, 2, cpu_subprocess_env())
    for out in ranks:
        metrics = {k for k in out if k.startswith("metric.")}
        assert metrics == {"metric.preempted"}, metrics
        assert float(out["metric.preempted"]) == 1.0
    assert os.listdir(os.path.join(log_dir, "auto_checkpoints")) == [
        "checkpoint_epoch2"]
    assert os.listdir(os.path.join(log_dir, "checkpoints")) == []
    with open(os.path.join(log_dir, "train", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    assert [r["step"] for r in recs if "epoch_train_loss" in r] == [0, 1, 2]
    assert not any("mAP" in r for r in recs), recs
