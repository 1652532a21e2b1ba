"""The port's HTTP front, continued (test_torch_server.py has the request
contract): the dynamic batcher's bounds (never above ``max_batch``,
oversize requests sliced on both paths, a 0-row batch), the liveness path
(503 + ``Retry-After: 5`` and "degraded" behind a wedged dispatch, then
recovery; 429 behind healthy dispatches; a standalone batcher's own
clock), the CLI (``build_from_args`` with ``TPU.INT8_EVAL`` and its
artifact reuse, the refusals, and ``python -m
centroids_reid_tpu_torch.inference.server`` stopped by SIGTERM), and
re-ranked serving, which answers as ``get_similar`` with
``TPU.RERANK_WINDOW`` on the same inputs. On the CPU, bound to port 0.

Tolerance of the re-ranked comparison: the served re-rank scores are
``get_similar``'s floats through JSON, within 1e-5 (a coalesced dispatch
embeds another batch shape)."""

import base64
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
from PIL import Image

from centroids_reid_tpu_torch.inference.server import (
    DispatchStuck,
    RetrievalHTTPServer,
    _dispatch_sliced,
    _DynamicBatcher,
    build_from_args,
)
from conftest import cpu_subprocess_env
from test_torch_server import (
    WINDOW_MS,
    b64,
    health,
    indexed_service,
    post,
    post_err,
    query_files,
    server_cfg,
    write_images,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _TagService:
    """Duck-typed service: each row's answer is its tag (byte 0 of the
    payload), and its dispatch can be held (a wedged device call)."""

    k = 3
    model_name = "fake"
    ingest_format = "rgb"

    def __init__(self):
        self.paths = np.array(["a", "b", "c"])
        self.release = threading.Event()
        self.wedge = False
        self.calls = []

    def ingest_bytes(self, blobs):
        out = np.zeros((len(blobs), 4, 4, 3), np.uint8)
        for i, b in enumerate(blobs):
            out[i, 0, 0, 0] = b[0]
        return out

    def query_arrays(self, imgs):
        self.calls.append(imgs.shape[0])
        if self.wedge:
            assert self.release.wait(30), "the test never released the wedge"
        v = imgs[:, 0, 0, 0].astype(np.int64)
        d = np.tile(v[:, None].astype(np.float64), (1, self.k))
        idx = np.tile(v[:, None], (1, self.k))
        return d, idx, self.paths[idx % len(self.paths)]


def _wait(cond, seconds=10):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.01)
    return cond()


def test_batcher_never_dispatches_above_max_batch():
    """3 + 3 rows queued behind a held dispatch at max_batch 4 dispatch as
    two batches; a 10-row request dispatches in 4, 4 and a 2-row bucket."""
    svc = _TagService()
    b = _DynamicBatcher(window_ms=200.0, max_batch=4, max_queue=64)
    results = {}

    def submit(tag, rows):
        results[tag] = b.submit(np.full((rows, 4, 4, 3), tag, np.uint8), svc)

    try:
        svc.wedge = True
        t0 = threading.Thread(target=submit, args=(9, 1))
        t0.start()
        assert _wait(lambda: svc.calls)
        t1 = threading.Thread(target=submit, args=(1, 3))
        t1.start()
        assert _wait(lambda: b._q.qsize() >= 1)
        t2 = threading.Thread(target=submit, args=(2, 3))
        t2.start()
        assert _wait(lambda: b._q.qsize() >= 2)
        svc.wedge = False
        svc.release.set()
        for t in (t0, t1, t2):
            t.join(30)
        assert all(c <= 4 for c in svc.calls), svc.calls
        for tag, rows in ((9, 1), (1, 3), (2, 3)):
            d, idx, _ = results[tag]
            assert d.shape[0] == rows and set(np.unique(idx)) == {tag}
        svc.calls.clear()
        submit(7, 10)
        assert svc.calls == [4, 4, 2], svc.calls
        d, idx, paths = results[7]
        assert d.shape == (10, 3) and paths.shape == (10, 3)
        assert set(np.unique(idx)) == {7}
    finally:
        svc.release.set()
        b.stop()


def test_direct_path_oversize_request_slices_at_max_batch():
    svc = _TagService()
    server = RetrievalHTTPServer(svc, port=0, max_batch=4).start_background()
    try:
        blobs = [bytes([10 + i]) + b"x" for i in range(10)]
        status, out = post(f"http://127.0.0.1:{server.port}/search", {
            "images_b64": [base64.b64encode(b).decode() for b in blobs]})
        assert status == 200 and svc.calls == [4, 4, 2], svc.calls
        assert [r["distances"][0] for r in out["results"]] == [
            float(10 + i) for i in range(10)]
    finally:
        server.shutdown()


@pytest.mark.parametrize("batched", [False, True],
                         ids=["direct", "batched"])
def test_zero_row_batch_dispatches_nothing(batched):
    """A 0-row batch gets empty results of the service's width without a
    dispatch (the reference's ``_dispatch_sliced`` raises on it)."""
    svc = _TagService()
    empty = np.zeros((0, 4, 4, 3), np.uint8)
    if batched:
        b = _DynamicBatcher(window_ms=1.0, max_batch=8)
        try:
            d, idx, paths = b.submit(empty, svc, timeout=10)
        finally:
            b.stop()
    else:
        d, idx, paths = _dispatch_sliced(svc, empty, 8)
    assert d.shape == idx.shape == paths.shape == (0, 3)
    assert svc.calls == []


@pytest.mark.parametrize("window_ms", [0.0, WINDOW_MS],
                         ids=["direct", "batched"])
def test_dispatch_timeout_503_degraded_and_recovery(window_ms):
    """Behind a wedged dispatch a request answers 503 + ``Retry-After: 5``
    within the deadline, /healthz reports "degraded" with the stall's age
    and the stuck count, and serving recovers once the dispatch ends."""
    svc = _TagService()
    server = RetrievalHTTPServer(svc, port=0, batch_window_ms=window_ms,
                                 dispatch_timeout_s=0.4).start_background()
    base = f"http://127.0.0.1:{server.port}"
    body = json.dumps(
        {"images_b64": [base64.b64encode(b"\x07hello").decode()]}).encode()
    first = None
    try:
        svc.wedge = True
        first = threading.Thread(target=post_err,
                                 args=(base + "/search", body))
        first.start()
        assert _wait(lambda: svc.calls), "the first request never dispatched"
        t0 = time.time()
        req = urllib.request.Request(base + "/search", data=body)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 503 and time.time() - t0 < 5.0
        assert e.value.headers.get("Retry-After") == "5"
        assert "stalled" in json.loads(e.value.read())["error"]
        time.sleep(0.5)
        h = health(base)
        assert h["status"] == "degraded" and h["in_dispatch_s"] > 0.4
        assert h["stuck"] >= 1
        svc.wedge = False
        svc.release.set()
        first.join(30)
        code, out = post_err(base + "/search", body)
        assert code == 200 and out["results"][0]["distances"][0] == 7.0
        h = health(base)
        assert h["status"] == "ok" and h["in_dispatch_s"] == 0.0
    finally:
        svc.release.set()
        if first is not None:
            first.join(30)
        server.shutdown()


class _YoungClock:
    """Every dispatch in flight reads younger than the bound."""

    def begin(self):
        return 0

    def end(self, tok):
        pass

    def oldest_age_s(self):
        return 0.05


@pytest.mark.parametrize("window_ms", [0.0, WINDOW_MS],
                         ids=["direct", "batched"])
def test_timeout_behind_healthy_dispatches_is_429(window_ms):
    """A deadline passed behind dispatches younger than the bound is
    backlog: 429, and the stuck counter stays 0."""
    svc = _TagService()
    server = RetrievalHTTPServer(svc, port=0, batch_window_ms=window_ms,
                                 dispatch_timeout_s=0.4).start_background()
    server._clock = _YoungClock()
    if server._batcher is not None:
        server._batcher._clock = server._clock
    base = f"http://127.0.0.1:{server.port}"
    body = json.dumps(
        {"images_b64": [base64.b64encode(b"\x07hello").decode()]}).encode()
    first = None
    try:
        svc.wedge = True
        first = threading.Thread(target=post_err,
                                 args=(base + "/search", body))
        first.start()
        assert _wait(lambda: svc.calls)
        code, err = post_err(base + "/search", body)
        assert code == 429 and "overloaded" in err["error"]
        assert health(base)["stuck"] == 0
    finally:
        svc.release.set()
        if first is not None:
            first.join(30)
        server.shutdown()


def test_standalone_batcher_default_clock_classifies_wedge():
    """A batcher built without a server's clock owns one, so a wedged
    dispatch still reads as DispatchStuck, not backlog."""
    svc = _TagService()
    svc.wedge = True
    b = _DynamicBatcher(window_ms=1.0, max_batch=8)
    img = np.zeros((1, 4, 4, 3), np.uint8)
    t = threading.Thread(target=lambda: b.submit(img, svc, timeout=10))
    t.start()
    try:
        assert _wait(lambda: svc.calls)
        time.sleep(0.3)
        with pytest.raises(DispatchStuck):
            b.submit(img, svc, timeout=0.2)
    finally:
        svc.release.set()
        t.join(30)
        b.stop()


# ------------------------------------------------------------------ CLI ---

@pytest.fixture(scope="module")
def cli_index(tmp_path_factory):
    """8 gallery JPEGs indexed by the create_embeddings flow, and the CLI
    options of the model that indexed them."""
    root = tmp_path_factory.mktemp("server_cli")
    write_images(root / "gallery", [f"{p}_{i}.jpg" for p in "ab"
                                    for i in range(4)],
                 np.random.RandomState(1))
    _, cfg = indexed_service(root, root / "gallery")
    opts = ["MODEL.NAME", "resnet18", "MODEL.BACKBONE_EMB_SIZE", "512",
            "USE_MIXED_PRECISION", "False", "INPUT.SIZE_TEST", "[32,16]",
            "TEST.IMS_PER_BATCH", "8", "MODEL.PRETRAIN_PATH",
            cfg.MODEL.PRETRAIN_PATH]
    return root, cfg.OUTPUT_DIR, opts


def test_cli_build_serves_the_index_with_an_int8_embed(cli_index):
    """``build_from_args`` loads the index, honours --topk,
    --normalize_features, --warmup_buckets and the opts, and with
    ``TPU.INT8_EVAL`` calibrates the int8 embed on the indexed images,
    saves it at ``TPU.INT8_CACHE_PATH`` and loads it on a rebuild."""
    root, index, opts = cli_index
    cache = str(root / "int8_artifact")
    argv = ["--gallery_data", index, "--port", "0", "--topk", "4",
            "--normalize_features", "--fp32_exact", "--device", "cpu",
            "--int8_gallery", "--warmup_buckets", "2", *opts,
            "TPU.INT8_EVAL", "True", "TPU.INT8_CALIB_BATCHES", "1",
            "TPU.INT8_CACHE_PATH", cache]
    server = build_from_args(argv).start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"
        h = health(base)
        assert (h["gallery_size"], h["k"], h["ingest"]) == (8, 4, "rgb")
        assert server.service.use_int8_gallery
        img = b64(root / "gallery" / "a_2.jpg")
        status, out = post(base + "/search", {"images_b64": [img]})
        assert status == 200
        assert os.path.basename(out["results"][0]["paths"][0]) == "a_2.jpg"
    finally:
        server.shutdown()
    npz = cache + ".npz"
    stamp = os.path.getmtime(npz)
    build_from_args(argv).shutdown()
    assert os.path.getmtime(npz) == stamp


@pytest.mark.parametrize("extra,exc,match", [
    # --artifact is served (test_torch_server_artifact.py); with
    # --int8_gallery it is refused, as in the JAX server
    (["--artifact", "model.crtpu", "--int8_gallery"], SystemExit,
     "artifacts"),
])
def test_cli_refuses_unported_options(cli_index, extra, exc, match):
    _, index, opts = cli_index
    argv = ["--gallery_data", index, "--port", "0", "--device", "cpu"]
    if extra[0].startswith("--"):
        argv += extra + opts
    else:
        argv += opts + extra
    with pytest.raises(exc, match=match):
        build_from_args(argv)


def test_cli_sharded_retrieval_follows_the_device_count(cli_index,
                                                       monkeypatch):
    """``TPU.SHARDED_RETRIEVAL`` builds no mesh with fewer than two devices
    of ``--device``'s type (the CPU here), as the reference's front does;
    with eight visible (patched) the service shards the index eight ways
    and answers as the unsharded one: indices equal, exact fp32 distances
    within 1e-6."""
    import torch

    from centroids_reid_tpu_torch.parallel import mesh as pmesh

    root, index, opts = cli_index
    argv = ["--gallery_data", index, "--port", "0", "--topk", "3",
            "--normalize_features", "--fp32_exact", "--device", "cpu",
            *opts, "TPU.SHARDED_RETRIEVAL", "True"]
    one = build_from_args(argv)
    monkeypatch.setattr(pmesh, "local_devices",
                        lambda device: [torch.device(device)] * 8)
    eight = build_from_args(argv)
    try:
        assert one.service.mesh is None
        assert eight.service.mesh.shape == {"gallery": 8}
        files = [str(root / "gallery" / f"{p}_1.jpg") for p in "ab"]
        d1, i1, p1 = one.service.query_files(files)
        d8, i8, p8 = eight.service.query_files(files)
        np.testing.assert_array_equal(i8, i1)
        np.testing.assert_array_equal(p8, p1)
        np.testing.assert_allclose(d8, d1, rtol=1e-6, atol=1e-6)
        assert [os.path.basename(p) for p in p8[:, 0]] == ["a_1.jpg",
                                                           "b_1.jpg"]
    finally:
        one.shutdown()
        eight.shutdown()


def test_server_module_serves_and_stops_cleanly_on_sigterm(cli_index):
    """``python -m centroids_reid_tpu_torch.inference.server`` serves in
    the foreground; SIGTERM drains and exits 0."""
    root, index, opts = cli_index
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    log = root / "serve.log"
    with open(log, "wb") as lf:
        proc = subprocess.Popen(
            [sys.executable, "-m", "centroids_reid_tpu_torch.inference.server",
             "--gallery_data", index, "--port", str(port), "--topk", "3",
             "--device", "cpu", *opts],
            stdout=lf, stderr=subprocess.STDOUT, env=cpu_subprocess_env(),
            cwd=_REPO)
        try:
            assert _wait(lambda: proc.poll() is not None or
                         "RetrievalHTTPServer on" in log.read_text(
                             errors="replace"), 120), log.read_text()
            assert proc.poll() is None, log.read_text()[-2000:]
            h = health(f"http://127.0.0.1:{port}")
            assert (h["gallery_size"], h["k"]) == (8, 3)
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
    text = log.read_text(errors="replace")
    assert rc == 0, text[-2000:]
    assert "stopped cleanly" in text


# ----------------------------------------------------------- re-ranking ---

@pytest.fixture(scope="module")
def rerank_setup(tmp_path_factory):
    """12 gallery JPEGs and 3 perturbed copies as queries (exact duplicates
    would tie inside the window), a service re-ranking each top-8 window,
    and the cfg of the index."""
    root = tmp_path_factory.mktemp("server_rerank")
    rng = np.random.RandomState(0)
    arrays = write_images(root / "gallery", [f"prod{p}_{i:02d}.jpg"
                                             for p in "ABC"
                                             for i in range(4)], rng)
    (root / "query").mkdir()
    for name in ("prodA_01.jpg", "prodB_02.jpg", "prodC_00.jpg"):
        noisy = np.clip(arrays[name].astype(np.int64)
                        + rng.randint(-6, 7, arrays[name].shape), 0, 255)
        Image.fromarray(noisy.astype(np.uint8)).save(
            root / "query" / f"q_{name}")
    svc, cfg = indexed_service(root, root / "gallery", rerank_window=8,
                               rerank_k1=4, rerank_k2=2, rerank_lambda=0.3)
    return root, svc, cfg


@pytest.mark.parametrize("window_ms", [0.0, WINDOW_MS],
                         ids=["direct", "batched"])
def test_rerank_serving_matches_get_similar(rerank_setup, window_ms):
    """Served re-ranked responses equal ``find_similar`` with
    ``TPU.RERANK_WINDOW`` on the same queries and index; /healthz reports
    the window."""
    from centroids_reid_tpu_torch.inference import find_similar

    root, svc, cfg = rerank_setup
    query = str(root / "query")
    c = server_cfg(root)
    c.MODEL.PRETRAIN_PATH = cfg.MODEL.PRETRAIN_PATH
    c.DATASETS.ROOT_DIR = query
    c.OUTPUT_DIR = str(root / f"similar_{window_ms}")
    c.TPU.RERANK = True
    c.TPU.RERANK_WINDOW = 8
    c.TPU.RERANK_K1 = 4
    c.TPU.RERANK_K2 = 2
    c.TPU.RERANK_LAMBDA = 0.3
    cli = find_similar(c, cfg.OUTPUT_DIR, False, True, 5, device="cpu")
    server = RetrievalHTTPServer(svc, port=0,
                                 batch_window_ms=window_ms).start_background()
    try:
        base = f"http://127.0.0.1:{server.port}"
        assert health(base)["rerank_window"] == 8
        qfiles = query_files(query)
        status, out = post(base + "/search",
                           {"images_b64": [b64(p) for p in qfiles]})
    finally:
        server.shutdown()
    assert status == 200
    for qp, res in zip(qfiles, out["results"]):
        ref = cli[qp]
        assert res["indices"] == [int(j) for j in ref["indices"]]
        assert res["paths"] == [str(p) for p in ref["paths"]]
        np.testing.assert_allclose(res["distances"], ref["distances"],
                                   rtol=0, atol=1e-5)
        assert (os.path.basename(res["paths"][0])
                == os.path.basename(qp)[2:])
