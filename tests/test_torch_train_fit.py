"""The port's training loop on the CPU (resnet18, 32x16, P = 4, K = 4,
fp32, a tiny synthetic Market-1501 layout): checkpoints and resume, the
device-resident and streamed epochs, the preemption stop, the runner's
training route and the evaluation of a trained checkpoint.

On the CPU every run is deterministic, so a resumed run must equal an
uninterrupted one exactly, and the resident and streamed epochs (the same
batches, the same augmentation draws) must give the same parameters."""

import json
import os
import signal

import numpy as np
import pytest
import torch
from PIL import Image

from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.data import init_dataset
from centroids_reid_tpu_torch.engine import checkpoint as CK
from centroids_reid_tpu_torch.engine import fit as FIT
from centroids_reid_tpu_torch.engine import runner

COUNTS = (2, 3, 5, 4, 6, 2, 7, 3)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    """Each pid a solid colour plus noise; train counts from 2 to 7."""
    root = tmp_path_factory.mktemp("fit_data")
    base = root / "market1501"
    rng = np.random.RandomState(0)
    colors = rng.randint(30, 225, (len(COUNTS), 3))
    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        (base / sub).mkdir(parents=True)

    def write(sub, pid, cam, i):
        arr = np.clip(colors[pid] + rng.randint(-20, 20, (32, 16, 3)), 0, 255)
        Image.fromarray(arr.astype(np.uint8)).save(
            base / sub / f"{pid + 1:04d}_c{cam}s1_{i:06d}_00.jpg")

    for pid, n in enumerate(COUNTS):
        for i in range(n):
            write("bounding_box_train", pid, i % 6 + 1, i)
        write("query", pid, 1, 100)
        for i in range(2):
            write("bounding_box_test", pid, i + 2, 200 + i)
    return str(root)


def _cfg(data_root, out, **opts):
    cfg = get_default_cfg()
    cfg.merge_from_list([
        "DATASETS.ROOT_DIR", data_root, "MODEL.NAME", "resnet18",
        "MODEL.PRETRAINED", "False", "USE_MIXED_PRECISION", "False",
        "INPUT.SIZE_TRAIN", "[32,16]", "INPUT.SIZE_TEST", "[32,16]",
        "SOLVER.IMS_PER_BATCH", "4", "SOLVER.USE_WARMUP_LR", "False",
        "SOLVER.EVAL_PERIOD", "100", "DATALOADER.USE_RESAMPLING", "False",
        "DATALOADER.NUM_WORKERS", "2", "REPRODUCIBLE_NUM_RUNS", "1",
        "MODEL.USE_CENTROIDS", "True", "OUTPUT_DIR", str(out)])
    for key, value in opts.items():
        section, name = key.split("__")
        setattr(getattr(cfg, section), name, value)
    cfg.LOG_DIR = str(out)
    return cfg


def _fit(cfg, data_root, mode="ctl"):
    log_dir = os.path.join(cfg.LOG_DIR, "run")
    os.makedirs(log_dir, exist_ok=True)
    ds = init_dataset("market1501", cfg)
    return FIT.fit(cfg, mode, log_dir, dataset=ds, device="cpu"), log_dir


def _ring(log_dir, epoch):
    return os.path.join(log_dir, "auto_checkpoints", f"checkpoint_epoch{epoch}")


def _assert_same_state(a, b):
    """Two state.pt dicts equal tensor for tensor."""
    assert a.keys() == b.keys()
    flat_a, flat_b = _flatten(a), _flatten(b)
    assert flat_a.keys() == flat_b.keys()
    for k in flat_a:
        x, y = flat_a[k], flat_b[k]
        if torch.is_tensor(x):
            assert torch.equal(x, y), k
        else:
            assert x == y, k


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}."))
    else:
        out[prefix] = tree
    return out


def test_resume_equals_an_uninterrupted_run(data_root, tmp_path):
    """One epoch, resume from checkpoint_epoch0 to two, against two epochs
    in one run: the same state, tensor for tensor."""
    _, first = _fit(_cfg(data_root, tmp_path / "a",
                         SOLVER__MAX_EPOCHS=1), data_root)
    out, resumed = _fit(_cfg(data_root, tmp_path / "b", SOLVER__MAX_EPOCHS=2,
                             MODEL__RESUME_TRAINING=True,
                             MODEL__PRETRAIN_PATH=_ring(first, 0)), data_root)
    assert {"test_centroids_mAP", "test_plain_mAP"} <= set(out)
    _, whole = _fit(_cfg(data_root, tmp_path / "c", SOLVER__MAX_EPOCHS=2),
                    data_root)
    a = CK.load_state_file(_ring(resumed, 1))
    b = CK.load_state_file(_ring(whole, 1))
    assert a["epoch"] == b["epoch"] == 1 and a["step"] == b["step"] > 0
    _assert_same_state(a, b)
    # the ring keeps one entry; the resumed run logged only epoch 1
    assert not os.path.exists(_ring(whole, 0))
    epochs = [json.loads(line).get("step") for line in open(
        os.path.join(resumed, "train", "metrics.jsonl")) if '"lr"' in line]
    assert epochs == [1]


def test_resident_and_streamed_epochs_give_equal_params(data_root, tmp_path):
    states = []
    for resident in (True, False):
        _, log_dir = _fit(_cfg(data_root, tmp_path / str(resident),
                               SOLVER__MAX_EPOCHS=1,
                               TPU__DEVICE_RESIDENT_DATA=resident), data_root)
        states.append(CK.load_state_file(_ring(log_dir, 0)))
    _assert_same_state(*states)


def test_sigterm_saves_and_stops(data_root, tmp_path, monkeypatch):
    """A SIGTERM during epoch 0 saves checkpoint_epoch0 at the epoch's end,
    skips the rest and the final double test, and restores the handler."""
    before = signal.getsignal(signal.SIGTERM)
    run_epoch = FIT.run_epoch

    def run_then_signal(*args):
        out = run_epoch(*args)
        os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(FIT, "run_epoch", run_then_signal)
    cfg = _cfg(data_root, tmp_path, SOLVER__MAX_EPOCHS=5,
               SOLVER__EVAL_PERIOD=1, TPU__PERIODIC_CHECKPOINT_INTERVAL=100)
    out, log_dir = _fit(cfg, data_root)
    assert out == {"preempted": 1.0}
    assert os.listdir(os.path.join(log_dir, "auto_checkpoints")) == [
        "checkpoint_epoch0"]
    assert os.listdir(os.path.join(log_dir, "checkpoints")) == []
    keys = set()
    for line in open(os.path.join(log_dir, "train", "metrics.jsonl")):
        rec = json.loads(line)
        if "step" in rec:
            keys |= set(rec)
    assert "epoch_train_loss" in keys
    assert not any(k.startswith("test_") or k == "mAP" for k in keys), keys
    assert signal.getsignal(signal.SIGTERM) == before


def test_runner_trains_base_and_a_trained_checkpoint_evaluates(data_root,
                                                              tmp_path):
    """``--mode base`` through ``main``, periodic validation with the
    best-metric checkpoint, then ONLY_TEST on that checkpoint: the loaded
    model embeds as the trained one."""
    common = ["--device", "cpu", "DATASETS.ROOT_DIR", data_root,
              "MODEL.NAME", "resnet18", "MODEL.PRETRAINED", "False",
              "USE_MIXED_PRECISION", "False", "INPUT.SIZE_TRAIN", "[32,16]",
              "INPUT.SIZE_TEST", "[32,16]", "SOLVER.IMS_PER_BATCH", "4",
              "REPRODUCIBLE_NUM_RUNS", "1", "OUTPUT_DIR", str(tmp_path)]
    out = runner.main(["--mode", "base", *common, "SOLVER.MAX_EPOCHS", "2",
                       "SOLVER.EVAL_PERIOD", "1"])
    assert {"mAP", "Top-1", "test_centroids_mAP", "test_plain_Top-1"} <= set(
        out)
    version = tmp_path / "train_base_model" / "version_0"
    best = os.listdir(version / "checkpoints")
    assert len(best) == 1 and best[0].startswith("epoch=")
    ckpt = str(version / "checkpoints" / best[0])
    assert CK.epoch_of_checkpoint(ckpt) == int(best[0][len("epoch="):])
    test = runner.main([*common, "TEST.ONLY_TEST", "True",
                        "MODEL.PRETRAIN_PATH", ckpt])
    assert set(test) == {k for k in out if k.startswith("test_")}

    cfg = _cfg(data_root, tmp_path, MODEL__PRETRAIN_PATH=ckpt)
    loaded = runner.load_model_for_test(cfg, device="cpu")
    trained = FIT.build_model_and_state(cfg, init_dataset("market1501", cfg),
                                        device="cpu")
    CK.restore_state(ckpt, trained)
    x = torch.rand(3, 3, 32, 16)
    with torch.no_grad():
        assert torch.equal(loaded.embed(x), trained.model.eval().embed(x))


def test_checkpoint_manager_ring_best_and_restore(data_root, tmp_path):
    cfg = _cfg(data_root, tmp_path)
    ds = init_dataset("market1501", cfg)
    state = FIT.build_model_and_state(cfg, ds, device="cpu")
    state.step = 7
    mgr = CK.CheckpointManager(str(tmp_path / "ck"), n_saved=2)
    os.makedirs(os.path.join(mgr.auto_dir, "checkpoint_epoch9.tmp"))
    for epoch in range(4):
        mgr.save_periodic(epoch, state, cfg)
    assert sorted(os.listdir(mgr.auto_dir)) == [
        "checkpoint_epoch2", "checkpoint_epoch3", "checkpoint_epoch9.tmp"]
    assert mgr.save_if_best(0, state, 0.5, cfg)
    assert not mgr.save_if_best(1, state, 0.4, cfg)
    assert mgr.save_if_best(2, state, 0.6, cfg)
    assert os.listdir(mgr.best_dir) == ["epoch=2"]
    assert sorted(os.listdir(os.path.join(mgr.best_dir, "epoch=2"))) == [
        "config.yml", "state.pt"]

    fresh = FIT.build_model_and_state(cfg, ds, seed=5, device="cpu")
    assert not torch.equal(fresh.centers, state.centers)
    CK.restore_state(os.path.join(mgr.best_dir, "epoch=2"), fresh)
    assert fresh.step == 7
    _assert_same_state(CK.state_dict(fresh, 2), CK.state_dict(state, 2))
    assert CK.epoch_of_checkpoint("x/checkpoint_epoch12") == 12
    assert CK.epoch_of_checkpoint("x/last") is None


def test_groups_are_refused(data_root, tmp_path):
    with pytest.raises(NotImplementedError, match="NUM_GROUPS"):
        _fit(_cfg(data_root, tmp_path, TPU__NUM_GROUPS=2), data_root)
