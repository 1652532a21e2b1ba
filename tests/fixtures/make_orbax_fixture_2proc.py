"""Write ``tests/fixtures/orbax_2proc/``: the train state of
``make_orbax_fixture.py`` saved by the JAX package's ``CheckpointManager``
from two processes (``jax.distributed`` on the CPU, its multi-process save:
every process calls orbax's save, the state materialised to host arrays,
barriers around it), and ``arrays.npz`` with the same leaves under their
dotted tree paths.

Run from the repository root, where jax, flax, optax and orbax import:

    python tests/fixtures/make_orbax_fixture_2proc.py

It starts its two processes itself (a coordinator on a free localhost
port) and waits for both.
"""

import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(HERE))
OUT = os.path.join(HERE, "orbax_2proc")
CKPT = "checkpoint_epoch1"
PROCESSES = 2


def worker(process_id: int, port: int, root: str) -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                               num_processes=PROCESSES,
                               process_id=process_id)
    from jax.experimental import multihost_utils

    from centroids_reid_tpu.engine.checkpoint import CheckpointManager
    from make_orbax_fixture import build_state, flat_leaves

    assert jax.process_count() == PROCESSES
    multihost_utils.sync_global_devices("warmup")
    state = build_state()
    ckpt = CheckpointManager(root, use_async=False)
    ckpt.save_periodic(1, state)
    ckpt.close()
    if process_id == 0:
        leaves = {}
        for field in ("params", "batch_stats", "opt_state", "step"):
            leaves.update(flat_leaves(getattr(state, field), (field,)))
        np.savez(os.path.join(root, "arrays.npz"), **leaves)
    multihost_utils.sync_global_devices("written")
    return 0


def main() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, HERE] + [p for p in [env.get("PYTHONPATH")] if p])
    with tempfile.TemporaryDirectory() as tmp:
        procs = [subprocess.Popen([sys.executable, __file__, "--worker",
                                   str(i), str(port), tmp], env=env)
                 for i in range(PROCESSES)]
        codes = [p.wait(timeout=600) for p in procs]
        if any(codes):
            print(f"workers exited with {codes}", file=sys.stderr)
            return 1
        shutil.rmtree(OUT, ignore_errors=True)
        os.makedirs(OUT)
        shutil.copytree(os.path.join(tmp, "auto_checkpoints", CKPT),
                        os.path.join(OUT, CKPT))
        shutil.copy(os.path.join(tmp, "arrays.npz"), OUT)
    files = [os.path.join(d, f) for d, _, names in os.walk(OUT)
             for f in names]
    print(f"{OUT}: {len(files)} files, "
          f"{sum(map(os.path.getsize, files))} bytes")
    for f in sorted(files):
        print(" ", os.path.relpath(f, OUT), os.path.getsize(f))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--worker"]:
        sys.exit(worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    sys.exit(main())
