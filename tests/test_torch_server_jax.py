"""The port's HTTP front against the JAX package's on the same requests.

Both servers run on port 0 over services built on the same weights (the
JAX model bundle and its ``from_jax_params`` copy in the port), gallery
and PNG queries: test_torch_service.py's slice (resnet18, 64x32, fp32
embed), the JAX service selecting on its Pallas kernels in interpret mode.
Every request goes to both servers, so their counters stay equal. The wire
contract must match: the ``/healthz`` fields and values, the ``/search``
body, and the status, JSON body, ``Retry-After`` header and keep-alive of
each rejected request (bad bodies, a chunked body, a bad or oversize
``Content-Length``, a shed request, a wedged dispatch).

Tolerances: indices and paths equal, error bodies equal (an object
address quoted in an error is masked); distances within
1e-4, because the two embeddings differ by the fp32 conv / reduction
order (test_torch_service.py)."""

import base64
import functools
import http.client
import io
import json
import re
import threading
import time

import numpy as np
import pytest
from PIL import Image

from centroids_reid_tpu.inference import service as jservice
from centroids_reid_tpu.inference import server as jserver
from centroids_reid_tpu.ops.retrieval import topk_select as jax_topk_select
from centroids_reid_tpu_torch.inference import RetrievalService
from centroids_reid_tpu_torch.inference import server as pserver
from test_server import _WedgeableService
from test_torch_service import slice_setup  # noqa: F401


def _b64png(img) -> str:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def fronts(slice_setup):
    """(JAX server, port server), both serving k=5 over the slice."""
    cfg, bundle, port, emb, paths, _ = slice_setup
    kw = dict(k=5, normalize=True, use_bf16_kernel=False)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jservice, "topk_select",
                   functools.partial(jax_topk_select, interpret=True))
        ref = jservice.RetrievalService(cfg, emb, paths, model_bundle=bundle,
                                        **kw)
        svc = RetrievalService(cfg, emb, paths, device="cpu", model=port,
                               **kw)
        servers = (jserver.RetrievalHTTPServer(ref, port=0),
                   pserver.RetrievalHTTPServer(svc, port=0))
        for s in servers:
            s.start_background()
        try:
            yield servers
        finally:
            for s in servers:
                s.shutdown()


def _send(port: int, method: str, path: str, body: bytes = None,
          headers: dict = None):
    """One request on its own connection, the body written as given (with
    its ``Content-Length`` unless ``headers`` frame it): (status,
    Retry-After, JSON body, whether the connection still answers a
    /healthz after it)."""
    headers = dict(headers or {})
    if body is not None and not ({"Content-Length", "Transfer-Encoding"}
                                 & headers.keys()):
        headers["Content-Length"] = str(len(body))
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.putrequest(method, path)
        for k, v in headers.items():
            conn.putheader(k, v)
        conn.endheaders()
        if body:
            conn.send(body)
        r = conn.getresponse()
        # an error text may quote a Python object's address
        text = re.sub(r" at 0x[0-9a-f]+", " at 0x?", r.read().decode())
        out = (r.status, r.getheader("Retry-After"), json.loads(text))
        try:
            conn.request("GET", "/healthz")
            conn.getresponse().read()
            kept = True
        except (http.client.HTTPException, ConnectionError):
            kept = False
        return (*out, kept)
    finally:
        conn.close()


def _both(fronts, *args, **kw):
    return [_send(s.port, *args, **kw) for s in fronts]


def _health(fronts):
    return [_send(s.port, "GET", "/healthz")[2] for s in fronts]


def test_healthz_matches_jax(fronts):
    ref, got = _health(fronts)
    assert got == ref
    assert got["model"] == "resnet18" and got["k"] == 5


@pytest.mark.parametrize("k", [None, 3])
def test_search_body_matches_jax(fronts, slice_setup, k):
    queries = slice_setup[-1]
    payload = {"images_b64": [_b64png(q) for q in queries]}
    if k is not None:
        payload["k"] = k
    (rs, rra, ref, _), (st, ra, got, kept) = _both(
        fronts, "POST", "/search", json.dumps(payload).encode())
    assert (st, ra, kept) == (rs, rra, True) == (200, None, True)
    assert got.keys() == ref.keys() == {"results"}
    assert len(got["results"]) == len(queries)
    for g, r in zip(got["results"], ref["results"]):
        assert g.keys() == r.keys()
        assert g["indices"] == r["indices"] and g["paths"] == r["paths"]
        assert len(g["indices"]) == (k or 5)
        np.testing.assert_allclose(g["distances"], r["distances"], rtol=1e-4,
                                   atol=1e-4)
    ref_h, got_h = _health(fronts)
    assert got_h == ref_h


_JUNK = base64.b64encode(b"not an image").decode()
_IMG = base64.b64encode(b"\x89PNG").decode()
BAD = {
    "unknown GET": ("GET", "/nope", None, None),
    "unknown POST": ("POST", "/nope", b"{}", None),
    "empty body": ("POST", "/search", b"", None),
    "invalid JSON": ("POST", "/search", b"{not json", None),
    "not an object": ("POST", "/search", b"[1,2]", None),
    "no images": ("POST", "/search", b"{}", None),
    "empty images": ("POST", "/search", b'{"images_b64": []}', None),
    "bad base64": ("POST", "/search", b'{"images_b64": ["!!notb64!!"]}',
                   None),
    "undecodable": ("POST", "/search",
                    json.dumps({"images_b64": [_JUNK]}).encode(), None),
    "k too large": ("POST", "/search",
                    json.dumps({"images_b64": [_IMG], "k": 6}).encode(),
                    None),
    "k zero": ("POST", "/search",
               json.dumps({"images_b64": [_IMG], "k": 0}).encode(), None),
    "k true": ("POST", "/search",
               json.dumps({"images_b64": [_IMG], "k": True}).encode(),
               None),
    "chunked": ("POST", "/search", b"5\r\nhello\r\n0\r\n\r\n",
                {"Transfer-Encoding": "chunked"}),
    "bad length": ("POST", "/search", b"", {"Content-Length": "abc"}),
    "oversize": ("POST", "/search", b"",
                 {"Content-Length": str(pserver.MAX_BODY_BYTES + 1)}),
}


@pytest.mark.parametrize("case", list(BAD))
def test_rejection_matches_jax(fronts, case):
    """Status, JSON error body, Retry-After and keep-alive equal the JAX
    server's (411 and 413 close the connection, the rest keep it)."""
    ref, got = _both(fronts, *BAD[case])
    assert got == ref
    assert got[0] in (400, 404, 411, 413) and got[1] is None
    assert "error" in got[2] and got[3] == (got[0] < 411)
    ref_h, got_h = _health(fronts)
    assert got_h == ref_h


def test_shed_429_matches_jax(fronts, slice_setup):
    """Past ``max_pending``: 429, ``Retry-After: 1`` and the same body."""
    payload = json.dumps({"images_b64": [_b64png(slice_setup[-1][0])]})
    for s in fronts:
        s.max_pending = 0
    try:
        ref, got = _both(fronts, "POST", "/search", payload.encode())
    finally:
        for s in fronts:
            s.max_pending = 32
    assert got == ref
    assert got[:2] == (429, "1") and got[3]
    ref_h, got_h = _health(fronts)
    assert got_h == ref_h and got_h["shed"] == 1


@pytest.mark.parametrize("window_ms", [0.0, 50.0], ids=["direct", "batched"])
def test_wedged_dispatch_503_matches_jax(window_ms):
    """A wedged dispatch: the next request answers 503 with
    ``Retry-After: 5`` and the same body, /healthz turns "degraded" with
    the same fields, and both recover once the dispatch returns."""
    svcs = [_WedgeableService(), _WedgeableService()]
    fronts = [mod.RetrievalHTTPServer(svc, port=0, batch_window_ms=window_ms,
                                      dispatch_timeout_s=0.6)
              for mod, svc in zip((jserver, pserver), svcs)]
    body = json.dumps({"images_b64": [base64.b64encode(
        b"\x07hello").decode()]}).encode()
    threads = []
    try:
        for s, svc in zip(fronts, svcs):
            s.start_background()
            svc.wedge = True
            t = threading.Thread(target=_send,
                                 args=(s.port, "POST", "/search", body))
            t.start()
            threads.append(t)
        deadline = time.time() + 10
        while not all(svc.calls for svc in svcs) and time.time() < deadline:
            time.sleep(0.01)
        assert all(svc.calls for svc in svcs)
        ref, got = _both(fronts, "POST", "/search", body)
        assert got == ref
        assert got[:2] == (503, "5") and got[3]
        time.sleep(0.7)
        ref_h, got_h = _health(fronts)
        assert got_h["status"] == ref_h["status"] == "degraded"
        assert got_h["in_dispatch_s"] > 0.6 and ref_h["in_dispatch_s"] > 0.6
        drop = ("in_dispatch_s",)
        assert ({k: v for k, v in got_h.items() if k not in drop}
                == {k: v for k, v in ref_h.items() if k not in drop})
        for svc in svcs:
            svc.wedge = False
            svc.release.set()
        for t in threads:
            t.join(30)
        ref, got = _both(fronts, "POST", "/search", body)
        assert got == ref and got[0] == 200
        ref_h, got_h = _health(fronts)
        assert got_h == ref_h and got_h["status"] == "ok"
    finally:
        for svc in svcs:
            svc.release.set()
        for s in fronts:
            s.shutdown()
