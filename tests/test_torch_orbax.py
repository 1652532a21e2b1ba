"""The orbax checkpoints of the JAX package through the port's reader
(``engine/orbax_read.py``, no orbax and no tensorstore) on the CPU.

* The committed fixture (``tests/fixtures/orbax_small``, written by
  ``tests/fixtures/make_orbax_fixture.py``) reads as its ``arrays.npz``,
  bit for bit, and its Adam state maps through ``from_jax_opt_state``.
* resnet18 ``TrainState``s written by the JAX package's
  ``CheckpointManager``, sync and async: every leaf equals the JAX
  package's ``restore_state``, bit for bit (dtype, shape and value); the
  read spans the root store's node and the process store's data files.
  orbax's node limit (100 MB) keeps such a tree in one B-tree leaf, so
  trees of many nodes (heights 1-3, version trees, values in data files,
  per-process stores merged as orbax merges them) are written by
  tensorstore with small node limits and held against tensorstore's reads.
* zarr arrays of many chunks (partial edge chunks, unwritten chunks at the
  fill value, C and F order, raw and zstd) read as tensorstore reads them.
* ``*.orbax-checkpoint-tmp-*`` directories are no checkpoints; a directory
  with only the per-process stores reads as the merged one.
* ``load_inference_model`` on an orbax directory embeds as the JAX
  package's ``load_inference_model`` does (rtol 1e-4 and 1e-4 of the
  embedding scale, as ``tests/test_torch_convert.py``), and decodes no
  array of the optimizer state.
* ONLY_TEST through the port's ``runner.main`` on a JAX-written checkpoint
  equals the JAX runner's metrics: Top-k equal, mAP within 1e-6.
"""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from centroids_reid_tpu.config import get_default_cfg as jax_default_cfg
from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.engine import orbax_read as R
from test_torch_model import _close, _jax_embed
from torch_oracle import randomize_params, randomize_stats

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "orbax_small")


def flat(tree, prefix=()):
    """{dotted path: leaf} of nested dicts / lists (the reader's tree);
    empty containers and ``None`` kept as leaves."""
    if isinstance(tree, (dict, list)) and tree:
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flat(v, prefix + (str(k),)))
        return out
    return {".".join(prefix): tree}


def flat_jax(tree, prefix=()):
    """{dotted path: numpy array} of a JAX pytree's array leaves, named as
    ``_METADATA`` names them."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = [str(getattr(k, a)) for k in path
                 for a in ("key", "idx", "name") if hasattr(k, a)]
        out[".".join(prefix + tuple(names))] = np.asarray(leaf)
    return out


def _arrays(tree) -> dict:
    return {k: v for k, v in flat(tree).items() if isinstance(v, np.ndarray)}


def _equal(got: dict, ref: dict) -> None:
    assert got.keys() == ref.keys(), sorted(set(got) ^ set(ref))
    for k in ref:
        a, b = got[k], np.asarray(ref[k])
        assert a.dtype == b.dtype and a.shape == b.shape, (k, a.dtype,
                                                           b.dtype)
        assert np.array_equal(a, b), k


def write_jax_checkpoint(root, num_classes, seed=0, use_async=False,
                         epoch=3):
    """A resnet18 ``TrainState`` of the JAX package (randomised weights and
    BN statistics, one Adam update from random gradients, step 1) saved by
    its ``CheckpointManager``. Returns (checkpoint directory, state)."""
    import optax

    from centroids_reid_tpu.engine.checkpoint import CheckpointManager
    from centroids_reid_tpu.engine.state import create_train_state
    from centroids_reid_tpu.models import create_model

    cfg = jax_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.INPUT.SIZE_TRAIN = [32, 16]
    model = create_model(cfg, num_classes=num_classes)
    state, tx = create_train_state(cfg, model, num_classes, seed=seed)
    host = jax.tree.map(np.asarray, state.params)
    params = {"model": randomize_params(host["model"], seed),
              "centers": host["centers"]}
    stats = randomize_stats(jax.tree.map(np.asarray, state.batch_stats),
                            seed + 1)
    rng = np.random.RandomState(seed)
    grads = jax.tree.map(
        lambda v: (rng.randn(*v.shape) * 1e-2).astype(np.float32), params)
    updates, opt_state = tx.update(grads, tx.init(params), params)
    state = state.replace(params=optax.apply_updates(params, updates),
                          batch_stats=stats, opt_state=opt_state,
                          step=jnp.asarray(1, jnp.int32))
    ckpt = CheckpointManager(str(root), use_async=use_async)
    ckpt.save_periodic(epoch, state)
    ckpt.close()
    return os.path.join(str(root), "auto_checkpoints",
                        f"checkpoint_epoch{epoch}"), state


@pytest.fixture(scope="module")
def jax_ckpt(tmp_path_factory):
    """A sync-saved resnet18 checkpoint of 6 classes, and its state."""
    return write_jax_checkpoint(tmp_path_factory.mktemp("jax_ckpt"), 6)


def test_fixture_reads_as_its_npz():
    path = os.path.join(FIXTURE, "checkpoint_epoch1")
    assert R.is_orbax_checkpoint(path)
    tree = R.read_checkpoint(path)
    with np.load(os.path.join(FIXTURE, "arrays.npz")) as z:
        ref = {k: z[k] for k in z.files}
    _equal(_arrays(tree), ref)
    leaves = flat(tree)
    # the states that hold no data: the model chain's EmptyStates, the
    # masked centers in the model's moments, the SGD and frozen branches
    assert leaves["opt_state.inner_states.frozen.inner_state"] is None
    assert leaves["opt_state.inner_states.model.inner_state."
                  "inner_state.1.mu.centers"] is None
    assert leaves["opt_state.inner_states.model.inner_state."
                  "hyperparams_states"] == {}
    # the conv kernel's chunk sits in a process data file, not in the node
    store = R.open_store(path)
    held = store._values[b"params.model.backbone.conv1.kernel/0.0.0.0"]
    assert isinstance(held, tuple) and held[0].startswith("ocdbt.process_0/")


def test_fixture_adam_state_maps_by_name():
    from centroids_reid_tpu_torch.models import (
        from_jax_opt_state,
        from_jax_params,
    )

    tree = R.read_checkpoint(os.path.join(FIXTURE, "checkpoint_epoch1"))
    sd = from_jax_params(tree["params"]["model"], {})
    # the trainable parameters in an order unlike the tree's
    names = sorted((n for n in sd if n != "bn.bias"), reverse=True)
    state = from_jax_opt_state(tree["opt_state"],
                               [(n, sd[n]) for n in names])
    with np.load(os.path.join(FIXTURE, "arrays.npz")) as z:
        adam = "opt_state.inner_states.model.inner_state.inner_state.1."
        for i, name in enumerate(names):
            jname = {"backbone.conv1.weight": "backbone.conv1.kernel",
                     "backbone.bn1.weight": "backbone.bn1.scale",
                     "backbone.bn1.bias": "backbone.bn1.bias",
                     "bn.weight": "bnneck.scale",
                     "fc_query.weight": "fc_query.kernel"}[name]
            for k, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
                ref = z[f"{adam}{m}.model.{jname}"]
                ref = (ref.transpose(3, 2, 0, 1) if ref.ndim == 4
                       else ref.T if ref.ndim == 2 else ref)
                assert np.array_equal(state[i][k].numpy(), ref), (name, k)
                assert np.abs(ref).max() > 0
            assert state[i]["step"].item() == int(z[f"{adam}count"]) == 2
    with pytest.raises(ValueError, match="no exp_avg of shape"):
        from_jax_opt_state(tree["opt_state"],
                           [("backbone.conv1.weight", torch.zeros(3))])
    with pytest.raises(ValueError, match="does not train"):
        from_jax_opt_state(tree["opt_state"], [("bn.weight", sd["bn.weight"])])
    broken = dict(tree["opt_state"])
    broken["inner_states"] = {**broken["inner_states"], "model": {}}
    with pytest.raises(ValueError, match="opt_state.inner_states.model."
                                         "inner_state: not in"):
        from_jax_opt_state(broken, [])
    sgd = dict(tree["opt_state"]["inner_states"])
    sgd["centers"] = {"inner_state": [np.zeros(3)]}
    with pytest.raises(ValueError, match="opt_state.inner_states.centers"):
        from_jax_opt_state({**tree["opt_state"], "inner_states": sgd}, [])


@pytest.mark.parametrize("use_async", [False, True], ids=["sync", "async"])
def test_reader_equals_restore_state(tmp_path, use_async):
    from centroids_reid_tpu.engine.checkpoint import restore_state

    path, state = write_jax_checkpoint(tmp_path, 8, seed=2,
                                       use_async=use_async)
    assert R.is_orbax_checkpoint(path)
    restored = restore_state(path, state)
    ref = {}
    for field in ("params", "batch_stats", "opt_state", "step"):
        ref.update(flat_jax(getattr(restored, field), (field,)))
    got = _arrays(R.read_checkpoint(path))
    _equal(got, ref)
    assert len(got) > 150
    assert np.abs(got["opt_state.inner_states.model.inner_state.inner_state."
                      "1.nu.model.backbone.conv1.kernel"]).max() > 0
    # the root store's node, its values in the process store's data files
    store = R.open_store(path)
    assert store.nodes_read >= 1 and len(store.files) >= 2
    assert any(f.startswith("ocdbt.process_0/d/") for f in store.files)


def _tensorstore_stores(root):
    """Stores with many B-tree nodes, written by tensorstore: one with 40
    commits (a version tree with interior nodes) of values inline and in
    data files, and two per-process stores merged into the root as orbax
    merges a multi-process checkpoint."""
    import tensorstore as ts

    cfg = {"max_decoded_node_bytes": 300, "max_inline_value_bytes": 16}
    ctx = ts.Context({"cache_pool#ocdbt": {"total_bytes_limit": 10**8}})

    def store(path):
        return ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}",
                                "config": cfg, "cache_pool":
                                "cache_pool#ocdbt"}, context=ctx).result()

    versions = store(root / "versions")
    for i in range(40):
        versions.write(f"key{i:03d}", b"v%d" % i * (1 + i % 9)).result()
    kids = []
    for p in range(2):
        kid = store(root / "merged" / f"ocdbt.process_{p}")
        with ts.Transaction() as txn:
            for i in range(60):
                kid.with_transaction(txn).write(
                    f"p{p}.k{i:03d}/.zarray", b"%d-%d;" % (p, i) * (i % 7)
                ).result()
        kids.append(kid)
    parent = store(root / "merged")
    txn = ts.Transaction(atomic=True)
    for kid in kids:
        kid.experimental_copy_range_to(parent.with_transaction(txn)).result()
    txn.commit_sync()
    return [root / "versions", root / "merged",
            root / "merged" / "ocdbt.process_0"]


def test_multi_node_btrees_read_as_tensorstore_reads_them(tmp_path):
    import tensorstore as ts

    for path in _tensorstore_stores(tmp_path):
        store = R.OcdbtStore(str(path))
        ref = ts.KvStore.open({"driver": "ocdbt",
                               "base": f"file://{path}"}).result()
        keys = ref.list().result()
        assert store.keys() == sorted(keys) and len(keys) >= 40
        for k in keys:
            assert store.get(k.decode()) == ref.read(k).result().value, k
        assert store.nodes_read > 5, (path, store.nodes_read)
    assert R.OcdbtStore(str(tmp_path / "versions")).get("key999") is None


def test_zarr_arrays_of_many_chunks(tmp_path):
    """Arrays that tensorstore's zarr driver writes over OCDBT in several
    chunks, edge chunks partial, unwritten chunks left to the fill value,
    C and F order, raw and zstd chunks: each reads as tensorstore reads
    it."""
    import tensorstore as ts

    base = {"driver": "ocdbt", "base": f"file://{tmp_path}"}
    rng = np.random.RandomState(3)
    specs = {
        "a": ({"shape": [5, 7], "chunks": [2, 3], "dtype": "<f4",
               "order": "C", "fill_value": 1.5,
               "compressor": {"id": "zstd", "level": 1}}, np.s_[:4, 1:]),
        "b.c": ({"shape": [4, 6, 3], "chunks": [3, 2, 3], "dtype": "<i8",
                 "order": "F", "fill_value": None, "compressor": None},
                np.s_[:, :5]),
        "n": ({"shape": [3], "chunks": [2], "dtype": "<f8",
               "order": "C", "fill_value": "NaN",
               "compressor": {"id": "zstd", "level": 3}}, np.s_[:2]),
    }
    for name, (meta, region) in specs.items():
        arr = ts.open({"driver": "zarr", "kvstore": {**base, "path":
                                                     name + "/"},
                       "metadata": meta}, create=True).result()
        arr[region] = rng.randn(*arr[region].shape).astype(meta["dtype"])
    store = R.OcdbtStore(str(tmp_path))
    for name in specs:
        ref = ts.open({"driver": "zarr", "kvstore": {**base, "path":
                                                     name + "/"}}
                      ).result().read().result()
        got = R.read_array(store, name)
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert np.array_equal(got, ref, equal_nan=True), name
    assert np.isnan(R.read_array(store, "n")[2])
    assert R.read_array(store, "a")[4, 0] == 1.5


def test_unfinished_saves_and_process_stores(jax_ckpt, tmp_path):
    from centroids_reid_tpu_torch.inference import load_inference_model

    path, _ = jax_ckpt
    tmp_dir = tmp_path / "checkpoint_epoch4.orbax-checkpoint-tmp-1760000000"
    shutil.copytree(path, tmp_dir)
    assert not R.is_orbax_checkpoint(str(tmp_dir))
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.MODEL.PRETRAIN_PATH = str(tmp_dir)
    with pytest.raises(FileNotFoundError, match="orbax-checkpoint-tmp"):
        load_inference_model(cfg, "cpu")
    # without the merged root store: the union of the process stores
    procs = tmp_path / "checkpoint_epoch4"
    shutil.copytree(path, procs)
    os.remove(procs / "manifest.ocdbt")
    shutil.rmtree(procs / "d")
    assert R.is_orbax_checkpoint(str(procs))
    _equal(_arrays(R.read_checkpoint(str(procs))),
           _arrays(R.read_checkpoint(path)))
    assert not R.is_orbax_checkpoint(str(tmp_path / "absent"))


def _port_cfg(path):
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.MODEL.BACKBONE_EMB_SIZE = 512
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = [32, 16]
    cfg.MODEL.PRETRAIN_PATH = path
    return cfg


def test_load_inference_model_embeds_as_jax(jax_ckpt, monkeypatch):
    from centroids_reid_tpu.inference import api as japi
    from centroids_reid_tpu_torch.inference import load_inference_model

    path, _ = jax_ckpt
    read = []
    real = R.read_array
    monkeypatch.setattr(R, "read_array",
                        lambda store, name: read.append(name) or real(
                            store, name))
    model = load_inference_model(_port_cfg(path), "cpu")
    assert read and all(n.startswith(("params.model.", "batch_stats."))
                        for n in read), read
    x = np.random.RandomState(7).randn(4, 32, 16, 3).astype(np.float32)
    with torch.no_grad():
        got = model.embed(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    jcfg = jax_default_cfg()
    jcfg.MODEL.NAME = "resnet18"
    jcfg.USE_MIXED_PRECISION = False
    jcfg.INPUT.SIZE_TEST = [32, 16]
    jcfg.MODEL.PRETRAIN_PATH = path
    ref = _jax_embed(*japi.load_inference_model(jcfg), x)
    _close(got, ref)


def test_only_test_on_a_jax_checkpoint_equals_jax(jax_ckpt, tmp_path):
    """ONLY_TEST through ``runner.main`` (both centroid modes) on the JAX
    package's checkpoint against the JAX runner on it."""
    from centroids_reid_tpu.engine import runner as jrunner
    from centroids_reid_tpu_torch.engine import runner
    from test_torch_eval import small_cfg, write_market

    path, _ = jax_ckpt
    data = write_market(tmp_path / "data")        # 6 train pids
    ref = jrunner.run_single(
        small_cfg(jax_default_cfg, path, data, str(tmp_path / "jax_logs")),
        "ctl", "test")
    got = runner.main([
        "--device", "cpu", "DATASETS.NAMES", "market1501",
        "DATASETS.ROOT_DIR", data, "MODEL.NAME", "resnet18",
        "MODEL.BACKBONE_EMB_SIZE", "512", "USE_MIXED_PRECISION", "False",
        "INPUT.SIZE_TEST", "[32,16]", "TEST.IMS_PER_BATCH", "16",
        "TEST.ONLY_TEST", "True", "MODEL.PRETRAIN_PATH", path,
        "MODEL.USE_CENTROIDS", "True", "OUTPUT_DIR",
        str(tmp_path / "port_logs")])
    assert sorted(got) == sorted(ref)
    for key in ref:
        if "mAP" in key:
            assert abs(got[key] - ref[key]) <= 1e-6, key
        else:
            assert got[key] == ref[key], key
    assert 0.0 < ref["test_plain_mAP"] < 1.0
