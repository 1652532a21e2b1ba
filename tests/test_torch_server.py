"""The port's HTTP front (``inference/server.py``) over its
``RetrievalService`` on the CPU, bound to port 0: the JAX package's server
contract (tests/test_server.py) on the port. JSON /search equals the
library path; the error codes; keep-alive across errors; chunked transfer
refused; dynamic batching coalesces and pads to power-of-two buckets;
concurrent answers equal serial ones; 429 with ``Retry-After``;
``swap_service``; ``warmup_buckets``. The batcher's bounds, the 503 /
"degraded" liveness path, oversize slicing, the CLI and re-ranked serving
are in test_torch_server_batching.py.

Tolerances: served distances are the library path's floats through JSON
(within 1e-6); under batching a coalesced dispatch embeds another batch
shape, so distances within 1e-5 and rankings equal."""

import base64
import http.client
import json
import os
import socket
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from centroids_reid_tpu_torch.config import get_default_cfg
from centroids_reid_tpu_torch.inference import (
    RetrievalService,
    build_embeddings,
    load_inference_model,
)
from centroids_reid_tpu_torch.inference.server import (
    Overloaded,
    RetrievalHTTPServer,
    _bucket_rows,
)
from centroids_reid_tpu_torch.models import create_model

WINDOW_MS = 40.0   # the batched variant's coalescing window


def server_cfg(root, size=(32, 16)):
    cfg = get_default_cfg()
    cfg.MODEL.NAME = "resnet18"
    cfg.MODEL.BACKBONE_EMB_SIZE = 512
    cfg.USE_MIXED_PRECISION = False
    cfg.INPUT.SIZE_TEST = list(size)
    cfg.TEST.IMS_PER_BATCH = 8
    cfg.OUTPUT_DIR = str(root / "index")
    return cfg


def write_images(folder, names, rng, size=(32, 16)):
    folder.mkdir(parents=True, exist_ok=True)
    arrays = {}
    for name in names:
        arr = rng.randint(0, 255, (*size, 3), np.uint8)
        Image.fromarray(arr).save(folder / name)
        arrays[name] = arr
    return arrays


def indexed_service(root, gallery, k=5, size=(32, 16), **kw):
    """A random resnet18 saved as a reference ``.pth``, ``build_embeddings``
    over ``gallery`` (the create_embeddings flow), and a service on that
    index; returns (service, cfg)."""
    cfg = server_cfg(root, size)
    pth = root / "reid.pth"
    if not pth.exists():
        torch.save({"state_dict": create_model(cfg).state_dict()}, pth)
    cfg.MODEL.PRETRAIN_PATH = str(pth)
    cfg.DATASETS.ROOT_DIR = str(gallery)
    emb, paths = build_embeddings(cfg, False, device="cpu")
    svc = RetrievalService(cfg, emb, paths, k=k, normalize=True,
                           use_bf16_kernel=False, device="cpu",
                           model=load_inference_model(cfg, "cpu"), **kw)
    return svc, cfg


@pytest.fixture(scope="module")
def gallery_setup(tmp_path_factory):
    """12 gallery JPEGs (3 products x 4) and 3 byte-identical query copies,
    indexed once."""
    root = tmp_path_factory.mktemp("server")
    rng = np.random.RandomState(0)
    names = [f"prod{p}_{i:02d}.jpg" for p in "ABC" for i in range(4)]
    arrays = write_images(root / "gallery", names, rng)
    (root / "query").mkdir()
    for name in ("prodA_01.jpg", "prodB_02.jpg", "prodC_00.jpg"):
        Image.fromarray(arrays[name]).save(root / "query" / f"q_{name}")
    svc, cfg = indexed_service(root, root / "gallery")
    return svc, cfg, str(root / "query")


@pytest.fixture(params=[0.0, WINDOW_MS], ids=["direct", "batched"])
def served(gallery_setup, request):
    """A running server over the indexed gallery, without and with
    dynamic batching: every contract holds in both."""
    svc, _, query = gallery_setup
    server = RetrievalHTTPServer(svc, port=0,
                                 batch_window_ms=request.param)
    server.start_background()
    try:
        yield server, svc, query, f"http://127.0.0.1:{server.port}"
    finally:
        server.shutdown()


def post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def post_err(url, data: bytes):
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def health(base):
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        return json.loads(r.read())


def b64(path):
    with open(path, "rb") as f:
        return base64.b64encode(f.read()).decode()


def query_files(query):
    return sorted(os.path.join(query, f) for f in os.listdir(query))


def test_healthz_and_search_match_library_path(served):
    server, svc, query, base = served
    h = health(base)
    assert {k: h[k] for k in ("status", "gallery_size", "k", "ingest",
                              "model", "rerank_window")} == {
        "status": "ok", "gallery_size": 12, "k": 5, "ingest": "rgb",
        "model": "resnet18", "rerank_window": 0}
    assert h["batching"] == (server._batcher is not None)
    requests0 = h["requests"]

    qfiles = query_files(query)
    status, out = post(base + "/search",
                       {"images_b64": [b64(p) for p in qfiles]})
    assert status == 200 and len(out["results"]) == 3
    d_lib, idx_lib, paths_lib = svc.query_files(qfiles)
    for i, res in enumerate(out["results"]):
        assert res["indices"] == [int(j) for j in idx_lib[i]]
        assert res["paths"] == [str(p) for p in paths_lib[i]]
        np.testing.assert_allclose(res["distances"], d_lib[i], rtol=0,
                                   atol=1e-6)
        # a byte-identical gallery copy finds its gallery image first
        assert (os.path.basename(res["paths"][0])
                == os.path.basename(qfiles[i])[2:])
    # k narrows the response without a rebuild
    status, out2 = post(base + "/search",
                        {"images_b64": [b64(qfiles[0])], "k": 2})
    assert status == 200
    assert out2["results"][0]["indices"] == out["results"][0]["indices"][:2]
    h = health(base)
    assert h["requests"] - requests0 == 2 and h["errors"] == 0


def test_error_contract(served):
    server, svc, query, base = served
    errors0 = health(base)["errors"]
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(base + "/nope", timeout=60)
    assert e.value.code == 404
    assert post_err(base + "/nope", b"{}")[0] == 404
    code, body = post_err(base + "/search", b"{not json")
    assert code == 400 and "invalid JSON" in body["error"]
    assert post_err(base + "/search", b"[1,2]")[0] == 400
    code, body = post_err(base + "/search", b"{}")
    assert code == 400 and "images_b64" in body["error"]
    assert post_err(base + "/search", b'{"images_b64": []}')[0] == 400
    code, body = post_err(base + "/search", b'{"images_b64": ["!!notb64!!"]}')
    assert code == 400 and "base64" in body["error"]
    junk = base64.b64encode(b"not an image").decode()
    code, body = post_err(base + "/search",
                          json.dumps({"images_b64": [junk]}).encode())
    assert code == 400 and "undecodable" in body["error"]
    img = b64(query_files(query)[0])
    for bad_k in (6, 0, True):   # service k = 5; JSON true is no k
        code, body = post_err(base + "/search", json.dumps(
            {"images_b64": [img], "k": bad_k}).encode())
        assert code == 400 and "'k'" in body["error"], bad_k
    h = health(base)
    assert h["errors"] - errors0 >= 8 and h["images"] == 0


def test_keepalive_connection_survives_errors(served):
    """HTTP/1.1 keep-alive: a 404 (its body drained) and a 400 on one
    connection, then a valid /search on the same connection."""
    server, svc, query, base = served
    good = json.dumps({"images_b64": [b64(query_files(query)[0])]}).encode()
    conn = http.client.HTTPConnection("127.0.0.1", server.port, timeout=60)
    try:
        for path, body, code in (("/nope", good, 404),
                                 ("/search", b"{not json", 400),
                                 ("/search", good, 200)):
            conn.request("POST", path, body=body)
            r = conn.getresponse()
            assert r.status == code
            data = r.read()
        assert len(json.loads(data)["results"][0]["paths"]) == 5
    finally:
        conn.close()


def test_chunked_transfer_encoding_is_rejected(served):
    """No Content-Length to drain by: 411 and the connection closes."""
    server, _, _, _ = served
    payload = b'{"images_b64": []}'
    req = (b"POST /search HTTP/1.1\r\nHost: t\r\n"
           b"Transfer-Encoding: chunked\r\n\r\n"
           + hex(len(payload))[2:].encode() + b"\r\n" + payload + b"\r\n"
           + b"0\r\n\r\n")
    with socket.create_connection(("127.0.0.1", server.port),
                                  timeout=60) as s:
        s.sendall(req)
        resp = b""
        while True:
            chunk = s.recv(65536)
            if not chunk:
                break   # the server closed the connection
            resp += chunk
    assert b"411" in resp.split(b"\r\n", 1)[0], resp[:200]
    assert b"Content-Length required" in resp


def test_concurrent_requests_match_serial(served):
    """9 concurrent single-image requests answer as the same requests sent
    one after another."""
    server, svc, query, base = served
    payloads = [{"images_b64": [b64(p)]} for p in query_files(query)] * 3
    serial = [post(base + "/search", p)[1] for p in payloads]
    results = [None] * len(payloads)

    def worker(i):
        results[i] = post(base + "/search", payloads[i])

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(len(payloads))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    for (status, out), expect in zip(results, serial):
        assert status == 200
        for got, exp in zip(out["results"], expect["results"]):
            assert got["indices"] == exp["indices"]
            assert got["paths"] == exp["paths"]
            np.testing.assert_allclose(got["distances"], exp["distances"],
                                       rtol=0, atol=1e-5)


def test_dynamic_batching_coalesces_dispatches(gallery_setup):
    """Requests queued behind a held dispatch coalesce into few dispatches,
    each padded to a power-of-two bucket, and each request still gets its
    own answer."""
    svc, _, query = gallery_setup
    server = RetrievalHTTPServer(svc, port=0, batch_window_ms=WINDOW_MS)
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"
    calls = []
    held = threading.Event()
    release = threading.Event()
    orig = svc.query_arrays

    def counting(imgs):
        calls.append(imgs.shape[0])
        if not held.is_set():
            held.set()
            release.wait(30)
        return orig(imgs)

    qfiles = query_files(query) * 2
    results = [None] * len(qfiles)
    try:
        svc.query_arrays = counting
        blocker = threading.Thread(
            target=post, args=(base + "/search", {"images_b64": [b64(
                qfiles[0])]}))
        blocker.start()
        assert held.wait(10)

        def worker(i):
            results[i] = post(base + "/search", {"images_b64": [b64(
                qfiles[i])]})

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(qfiles))]
        for t in threads:
            t.start()
        deadline = time.time() + 10
        while server._batcher._q.qsize() < len(qfiles) and (
                time.time() < deadline):
            time.sleep(0.01)
        release.set()
        for t in threads:
            t.join(60)
        blocker.join(60)
    finally:
        release.set()
        svc.query_arrays = orig
        server.shutdown()
    assert calls[0] == 1                       # the held dispatch
    rest = calls[1:]
    assert len(rest) < len(qfiles) and max(rest) > 1, calls
    assert all(c == _bucket_rows(c) for c in rest), calls
    assert len(qfiles) <= sum(rest) < 2 * len(qfiles), calls
    for (status, out), qp in zip(results, qfiles):
        assert status == 200
        assert (os.path.basename(out["results"][0]["paths"][0])
                == os.path.basename(qp)[2:])


def test_overload_sheds_with_429_and_retry_after(served):
    """Past max_pending requests in flight the server sheds at once with
    429 and ``Retry-After: 1``; the shed counter shows in /healthz and
    traffic resumes after."""
    server, svc, query, base = served
    payload = {"images_b64": [b64(query_files(query)[0])]}
    shed0 = health(base)["shed"]
    server.max_pending = 1
    release = threading.Event()
    orig = svc.query_arrays

    def blocking(imgs):
        release.wait(30)
        return orig(imgs)

    svc.query_arrays = blocking
    holder = threading.Thread(target=post, args=(base + "/search", payload))
    try:
        holder.start()
        deadline = time.time() + 10
        while server._pending < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert server._pending == 1
        for _ in range(3):
            status, out = post_err(base + "/search",
                                   json.dumps(payload).encode())
            assert status == 429 and "overloaded" in out["error"]
        req = urllib.request.Request(base + "/search",
                                     data=json.dumps(payload).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=60)
        assert e.value.code == 429
        assert e.value.headers.get("Retry-After") == "1"
    finally:
        release.set()
        svc.query_arrays = orig
        holder.join(60)
        server.max_pending = 32
    assert post(base + "/search", payload)[0] == 200
    h = health(base)
    assert h["shed"] - shed0 >= 4 and h["pending"] == 0


def test_batcher_queue_full_sheds(gallery_setup):
    """A full batcher queue raises Overloaded (429) instead of growing."""
    import queue

    svc, _, _ = gallery_setup
    server = RetrievalHTTPServer(svc, port=0, batch_window_ms=WINDOW_MS)
    old_q = server._batcher._q
    tiny = queue.Queue(maxsize=1)
    tiny.put_nowait("occupied")
    server._batcher._q = tiny
    try:
        with pytest.raises(Overloaded):
            server._batcher.submit(np.zeros((1, 32, 16, 3), np.uint8), svc)
    finally:
        server._batcher._q = old_q
        server.shutdown()


def test_warmup_buckets_runs_every_dispatch_shape(served):
    """warmup_buckets runs each power-of-two row count up to its bound, in
    the service's ingest shape, and nothing else; requests then dispatch
    only warmed shapes."""
    server, svc, query, base = served
    shapes = []
    orig = svc.query_arrays

    def recording(imgs):
        shapes.append(imgs.shape)
        return orig(imgs)

    svc.query_arrays = recording
    try:
        server.warmup_buckets(4)
        assert shapes == [(b, 32, 16, 3) for b in (1, 2, 4)]
        qfiles = query_files(query)
        post(base + "/search", {"images_b64": [b64(p) for p in qfiles]})
        assert shapes[3][0] == 4   # 3 images, padded to the 4-row bucket
        shapes.clear()
        server.warmup_buckets()    # default: max_batch, or 1 direct
        assert shapes[-1][0] == (server.max_batch if server._batcher else 1)
    finally:
        svc.query_arrays = orig


def test_swap_service_zero_downtime(tmp_path, gallery_setup):
    """swap_service replaces the gallery: later requests rank against the
    new index; counters persist."""
    svc1, _, query = gallery_setup
    rng = np.random.RandomState(3)
    write_images(tmp_path / "g2", [f"two_{i}.jpg" for i in range(6)], rng)
    svc2, _ = indexed_service(tmp_path, tmp_path / "g2", k=3)
    server = RetrievalHTTPServer(svc1, port=0).start_background()
    base = f"http://127.0.0.1:{server.port}"
    try:
        payload = {"images_b64": [b64(query_files(query)[0])]}
        _, out1 = post(base + "/search", payload)
        assert os.path.basename(out1["results"][0]["paths"][0]) == \
            "prodA_01.jpg"
        server.swap_service(svc2)
        _, out2 = post(base + "/search", payload)
        assert all(os.path.basename(p).startswith("two_")
                   for p in out2["results"][0]["paths"])
        assert len(out2["results"][0]["paths"]) == 3
        assert health(base)["requests"] == 2
    finally:
        server.shutdown()


def test_swap_during_held_batch_keeps_each_request_on_its_service(
        tmp_path, gallery_setup):
    """Requests validated and decoded against the old service (k 5, 32x16)
    wait in the batcher queue when a swap to a service with k 2 and 48x24
    inputs lands: they dispatch on the old one, whole; later requests
    validate against the new one."""
    svc1, _, query = gallery_setup
    rng = np.random.RandomState(7)
    write_images(tmp_path / "g2", [f"two_{i}.jpg" for i in range(6)], rng,
                 size=(48, 24))
    svc2, _ = indexed_service(tmp_path, tmp_path / "g2", k=2, size=(48, 24))
    server = RetrievalHTTPServer(svc1, port=0, batch_window_ms=WINDOW_MS)
    server.start_background()
    base = f"http://127.0.0.1:{server.port}"
    payload = {"images_b64": [b64(query_files(query)[0])], "k": 4}
    release = threading.Event()
    dispatched = threading.Event()
    orig = svc1.query_arrays

    def blocking(imgs):
        dispatched.set()
        release.wait(30)
        return orig(imgs)

    held = [None, None]
    try:
        svc1.query_arrays = blocking
        blocker = threading.Thread(target=post,
                                   args=(base + "/search", payload))
        blocker.start()
        assert dispatched.wait(10)

        def worker(i):
            held[i] = post(base + "/search", payload)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        deadline = time.time() + 10
        while server._batcher._q.qsize() < 2 and time.time() < deadline:
            time.sleep(0.01)
        assert server._batcher._q.qsize() >= 2
        server.swap_service(svc2)
        release.set()
        for t in threads:
            t.join(60)
        blocker.join(60)
        svc1.query_arrays = orig
        for status, out in held:
            assert status == 200
            paths = out["results"][0]["paths"]
            assert len(paths) == 4
            assert all(os.path.basename(p).startswith("prod") for p in paths)
        img2 = base64.b64encode(
            (tmp_path / "g2" / "two_3.jpg").read_bytes()).decode()
        assert post_err(base + "/search", json.dumps(
            {"images_b64": [img2], "k": 4}).encode())[0] == 400
        status, out = post(base + "/search", {"images_b64": [img2], "k": 2})
        assert status == 200
        assert all(os.path.basename(p).startswith("two_")
                   for p in out["results"][0]["paths"])
    finally:
        release.set()
        svc1.query_arrays = orig
        server.shutdown()
