"""``fit`` with ``TPU.NUM_GROUPS`` 2 on the CPU (resnet18 at 32x16, P = 4,
K = 4, fp32): the device-resident epoch (the bank gathered [G, P*K]) and
the host-streamed one (the ``TrainLoader``'s group-major batches) train
the same state, tensor for tensor, with finite losses; an epoch takes the
plan's steps of G groups."""

import json
import os

import numpy as np

from centroids_reid_tpu_torch.data import TrainLoader, init_dataset
from centroids_reid_tpu_torch.engine import checkpoint as CK
from test_torch_train_fit import (  # noqa: F401
    _assert_same_state,
    _cfg,
    _fit,
    _ring,
    data_root,
)


def test_two_groups_train_alike_on_both_batch_sources(data_root,  # noqa: F811
                                                      tmp_path):
    states, steps = [], []
    for resident in (True, False):
        cfg = _cfg(data_root, tmp_path / str(resident), SOLVER__MAX_EPOCHS=1,
                   TPU__NUM_GROUPS=2, TPU__DEVICE_RESIDENT_DATA=resident)
        out, log_dir = _fit(cfg, data_root)
        assert "test_centroids_mAP" in out
        states.append(CK.load_state_file(_ring(log_dir, 0)))
        rec = [json.loads(line) for line in open(
            os.path.join(log_dir, "train", "metrics.jsonl"))
            if '"lr"' in line]
        assert len(rec) == 1 and np.isfinite(rec[0]["epoch_train_loss"])
        steps.append(rec[0]["steps"])
    _assert_same_state(*states)
    plan = TrainLoader(init_dataset("market1501", cfg), cfg,
                       num_groups=2).plan_for_epoch(0)
    assert plan.sample_idx.shape[1] == 2
    assert steps == [plan.num_steps] * 2 and states[0]["step"] == steps[0]
