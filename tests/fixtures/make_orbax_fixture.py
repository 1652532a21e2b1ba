"""Write ``tests/fixtures/orbax_small/``: a small orbax checkpoint of a
train state, saved by the JAX package's ``CheckpointManager``, and
``arrays.npz`` with the same leaves under their dotted tree paths.

The tree has a ``TrainState``'s node kinds at a few KB: ``params`` with
``model`` (a conv kernel, BN scale and bias, the BNNeck's, ``fc_query``'s
dense kernel; named as in the JAX ``ReidModel``) and ``centers``;
``batch_stats``; the ``opt_state`` of the JAX package's ``build_optimizer``
(``multi_transform`` of masked states, ``inject_hyperparams`` around the
model's Adam) after two updates, so ``mu`` and ``nu`` are nonzero; the
``step`` as int32. The conv kernel compresses to more than OCDBT's 1 KB
inline limit, so its value sits in a data file; the rest are inline.

Run from the repository root, where jax, flax, optax and orbax import:

    python tests/fixtures/make_orbax_fixture.py
"""

import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "orbax_small")
CKPT = "checkpoint_epoch1"
SEED = 0


def build_state():
    import jax
    import jax.numpy as jnp
    import optax

    from centroids_reid_tpu.config import get_default_cfg
    from centroids_reid_tpu.engine.state import TrainState
    from centroids_reid_tpu.solver import build_optimizer

    rng = np.random.RandomState(SEED)
    f32 = np.float32
    params = {
        "model": {
            "backbone": {
                "conv1": {"kernel": rng.randn(3, 3, 4, 16).astype(f32)},
                "bn1": {"scale": rng.uniform(0.5, 1.5, 16).astype(f32),
                        "bias": rng.randn(16).astype(f32) * 0.1},
            },
            "bnneck": {"scale": np.ones(16, f32), "bias": np.zeros(16, f32)},
            "fc_query": {"kernel": rng.randn(16, 6).astype(f32) * 0.05},
        },
        "centers": rng.randn(6, 16).astype(f32),
    }
    batch_stats = {
        "backbone": {"bn1": {"mean": rng.randn(16).astype(f32),
                             "var": rng.uniform(0.5, 2, 16).astype(f32)}},
        "bnneck": {"mean": rng.randn(16).astype(f32) * 0.1,
                   "var": rng.uniform(0.5, 2, 16).astype(f32)},
    }
    tx, _ = build_optimizer(params, get_default_cfg())
    opt_state = tx.init(params)
    for _ in range(2):
        grads = jax.tree.map(
            lambda v: rng.randn(*np.shape(v)).astype(f32), params)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
    return TrainState(params=params, batch_stats=batch_stats,
                      opt_state=opt_state,
                      step=jnp.asarray(2, jnp.int32))


def flat_leaves(tree, prefix=()):
    """{dotted path: numpy array} of every array leaf, as the tree's
    ``_METADATA`` names them (dict keys, sequence indices, namedtuple
    fields)."""
    import jax

    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        names = []
        for k in path:
            for attr in ("key", "idx", "name"):
                if hasattr(k, attr):
                    names.append(str(getattr(k, attr)))
                    break
        out[".".join(prefix + tuple(names))] = np.asarray(leaf)
    return out


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from centroids_reid_tpu.engine.checkpoint import CheckpointManager

    state = build_state()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(tmp, use_async=False)
        ckpt.save_periodic(1, state)
        ckpt.close()
        shutil.rmtree(OUT, ignore_errors=True)
        os.makedirs(OUT)
        shutil.copytree(os.path.join(tmp, "auto_checkpoints", CKPT),
                        os.path.join(OUT, CKPT))
    leaves = {}
    for field in ("params", "batch_stats", "opt_state", "step"):
        leaves.update(flat_leaves(getattr(state, field), (field,)))
    np.savez(os.path.join(OUT, "arrays.npz"), **leaves)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(OUT) for f in files)
    print(f"{OUT}: {len(leaves)} array leaves, {size} bytes")
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))
    sys.exit(main())
