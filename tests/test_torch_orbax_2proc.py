"""An orbax checkpoint that the JAX package wrote from two processes
(``tests/fixtures/orbax_2proc``, written by
``tests/fixtures/make_orbax_fixture_2proc.py`` under ``jax.distributed``
with 2 CPU processes through ``CheckpointManager``'s multi-process save)
through the port's reader (``engine/orbax_read.py``): every leaf equals
``arrays.npz`` bit for bit (dtype, shape and value), read through the
merged root store and, with the root store taken away, through the union
of the ``ocdbt.process_<i>/`` stores alone."""

import os
import shutil

import numpy as np
import pytest

from centroids_reid_tpu_torch.engine import orbax_read as R
from test_torch_orbax import _arrays, _equal, flat

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "fixtures", "orbax_2proc")
CKPT = os.path.join(FIXTURE, "checkpoint_epoch1")


def _reference() -> dict:
    with np.load(os.path.join(FIXTURE, "arrays.npz")) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("stores", ["merged root", "process stores only"])
def test_two_process_checkpoint_reads_as_its_npz(tmp_path, stores):
    path = CKPT
    if stores == "process stores only":
        path = str(tmp_path / "checkpoint_epoch1")
        shutil.copytree(CKPT, path)
        os.remove(os.path.join(path, "manifest.ocdbt"))
        shutil.rmtree(os.path.join(path, "d"))
        assert any(d.startswith("ocdbt.process_") for d in os.listdir(path))
    assert R.is_orbax_checkpoint(path)
    tree = R.read_checkpoint(path)
    ref = _reference()
    _equal(_arrays(tree), ref)
    assert flat(tree)["step"] == 2 and len(ref) > 20


def test_values_sit_in_the_process_stores():
    """The multi-process save keeps each array's chunk in a process data
    file, which the root store's nodes point at."""
    store = R.open_store(CKPT)
    held = store._values[b"params.model.backbone.conv1.kernel/0.0.0.0"]
    assert isinstance(held, tuple) and held[0].startswith("ocdbt.process_")
