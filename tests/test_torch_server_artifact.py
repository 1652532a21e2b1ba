"""The HTTP front over a retriever artifact (``--artifact``) on the CPU,
bound to port 0: /search answers equal ``LoadedRetriever.query_arrays`` on
the same decoded images (distances through JSON, within 1e-6), the
artifact needs neither checkpoint nor index, ``--int8_gallery`` is refused
with it, and ``warmup_buckets`` reads the artifact's input size (the yuv420
ingest included), as the JAX server's tests/test_server.py holds."""

import base64
import os
import shutil
import signal
import socket
import subprocess
import sys

import numpy as np
import pytest

from centroids_reid_tpu_torch.inference.export import (
    export_retriever,
    export_retriever_from_config,
    load_retriever,
    save_artifact,
)
from centroids_reid_tpu_torch.inference.server import (
    RetrievalHTTPServer,
    build_from_args,
)
from centroids_reid_tpu_torch.models import create_model
from conftest import cpu_subprocess_env
from test_torch_server import (
    health,
    indexed_service,
    post,
    server_cfg,
    write_images,
)
from test_torch_server_batching import _wait

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """8 gallery JPEGs indexed by ``build_embeddings``, the retriever
    artifact of that index (k = 3, batch 4) and the live service."""
    root = tmp_path_factory.mktemp("server_artifact")
    write_images(root / "gallery", [f"{p}_{i}.jpg" for p in "ab"
                                    for i in range(4)],
                 np.random.RandomState(3))
    svc, cfg = indexed_service(root, root / "gallery", k=3)
    path = str(root / "retriever.crt")
    export_retriever_from_config(cfg, cfg.OUTPUT_DIR, path, k=3,
                                 batch_size=4, platforms=("cpu",),
                                 device="cpu")
    return root, path, svc


def _blob(path):
    with open(path, "rb") as f:
        return f.read()


def test_artifact_server_answers_as_the_retriever(artifact):
    root, path, svc = artifact
    server = build_from_args(["--artifact", path, "--port", "0", "--device",
                              "cpu", "--warmup_buckets", "2"])
    server.start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"
        h = health(base)
        assert (h["gallery_size"], h["k"], h["ingest"], h["model"]) == (
            8, 3, "rgb", "resnet18")
        ret = server.service
        # the warm-up's buckets 1 and 2 pad to the artifact's batch of 4
        assert ret.num_compiles == 1
        blobs = [_blob(root / "gallery" / n) for n in ("a_1.jpg", "b_2.jpg",
                                                       "b_0.jpg")]
        status, out = post(base + "/search", {
            "images_b64": [base64.b64encode(b).decode() for b in blobs]})
        assert status == 200
        ref = load_retriever(path, "cpu").query_bytes(blobs)
        # the front pads 3 rows to its bucket of 4, the retriever's batch
        for r, (d, i, p) in enumerate(zip(*ref)):
            got = out["results"][r]
            assert got["indices"] == [int(j) for j in i]
            assert got["paths"] == [str(x) for x in p]
            np.testing.assert_allclose(got["distances"], d, rtol=0,
                                       atol=1e-6)
        assert [os.path.basename(r["paths"][0]) for r in out["results"]] == [
            "a_1.jpg", "b_2.jpg", "b_0.jpg"]
        _, si, _ = svc.query_bytes(blobs)
        np.testing.assert_array_equal(ref[1], si)
        assert ret.num_compiles == 1
    finally:
        server.shutdown()


def test_artifact_with_int8_gallery_is_refused(artifact):
    _, path, _ = artifact
    with pytest.raises(SystemExit, match="re-export"):
        build_from_args(["--artifact", path, "--int8_gallery", "--port", "0",
                         "--device", "cpu"])


def test_warmup_buckets_on_artifact_server_yuv420(tmp_path):
    """The artifact has no ``cfg``: the bucket shapes come from its
    ``input_size_hw`` and its yuv420 ingest."""
    cfg = server_cfg(tmp_path)
    cfg.TPU.FAST_DECODE = True
    rng = np.random.RandomState(9)
    gallery = rng.randn(16, 512).astype(np.float32)
    paths = np.array([f"g{i}" for i in range(16)])
    blobs, meta, aux = export_retriever(create_model(cfg), cfg, gallery,
                                        paths, k=3, batch_size=2,
                                        platforms=("cpu",))
    assert meta["ingest"] == "yuv420"
    path = str(tmp_path / "yuv.crt")
    save_artifact(path, blobs, meta, aux=aux)
    ret = load_retriever(path, "cpu")
    server = RetrievalHTTPServer(ret, port=0).start_background()
    try:
        server.warmup_buckets(2)             # shapes 1, 2: must not raise
        n0 = ret.num_compiles
        assert n0 == 1                       # both pad to the batch of 2
        img = write_images(tmp_path / "q", ["q.jpg"], rng)
        assert img["q.jpg"].shape == (32, 16, 3)
        status, out = post(f"http://127.0.0.1:{server.port}/search", {
            "images_b64": [base64.b64encode(
                _blob(tmp_path / "q" / "q.jpg")).decode()]})
        assert status == 200 and len(out["results"][0]["indices"]) == 3
        assert ret.num_compiles == n0
        assert health(f"http://127.0.0.1:{server.port}")["ingest"] == "yuv420"
    finally:
        server.shutdown()


def test_artifact_serves_without_checkpoint_or_index(artifact, tmp_path):
    """The deployment criterion: with the checkpoint and the index gone,
    ``python -m centroids_reid_tpu_torch.inference.server --artifact``
    serves from the file alone and stops cleanly on SIGTERM."""
    root, path, _ = artifact
    alone = tmp_path / "deploy"
    alone.mkdir()
    shutil.copy(path, alone / "retriever.crt")
    img = _blob(root / "gallery" / "b_1.jpg")
    expected = load_retriever(path, "cpu").query_bytes([img])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = tmp_path / "serve.log"
    with open(log, "wb") as lf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "centroids_reid_tpu_torch.inference.server",
             "--artifact", str(alone / "retriever.crt"), "--port", str(port),
             "--device", "cpu"],
            stdout=lf, stderr=subprocess.STDOUT, cwd=str(alone),
            env=cpu_subprocess_env(PYTHONPATH=os.pathsep.join(
                [_REPO, os.environ.get("PYTHONPATH", "")])))
        try:
            assert _wait(lambda: proc.poll() is not None or
                         "RetrievalHTTPServer on" in log.read_text(
                             errors="replace"), 120), log.read_text()
            assert proc.poll() is None, log.read_text()[-2000:]
            status, out = post(f"http://127.0.0.1:{port}/search", {
                "images_b64": [base64.b64encode(img).decode()]})
            assert status == 200
            got = out["results"][0]
            assert got["indices"] == [int(j) for j in expected[1][0]]
            assert os.path.basename(got["paths"][0]) == "b_1.jpg"
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
    assert rc == 0, log.read_text()[-2000:]
