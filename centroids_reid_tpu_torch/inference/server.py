"""JSON-over-HTTP serving front for ``RetrievalService`` (counterpart of
``centroids_reid_tpu/inference/server.py``), on one device:

    python -m centroids_reid_tpu_torch.inference.server \\
        --gallery_data /index --port 8000 --topk 100 --normalize_features \\
        --batch_window_ms 2 --max_batch 64 --warmup_buckets 64 \\
        MODEL.PRETRAIN_PATH model.ckpt

The flags of ``inference/serve.py`` plus ``--device`` (default: the card).

Endpoints (all JSON):

  GET  /healthz
      -> {"status": "ok|degraded", "gallery_size": N, "k": K,
          "ingest": "rgb|yuv420", "model": cfg.MODEL.NAME,
          "rerank_window": r (0 = off), "batching": bool, "pending": n,
          "max_pending": m, "in_dispatch_s": age of the oldest dispatch in
          flight, "dispatch_timeout_s": T, "requests", "images", "errors",
          "shed", "stuck"}
      "degraded": a dispatch has been in flight longer than the timeout.
  POST /search   body {"images_b64": ["<base64 jpeg/png>", ...],
                       "k": optional int (<= service k)}
      -> {"results": [{"paths": [...], "indices": [...],
                       "distances": [...]}, ...]}  # one entry per image

Errors: 400 (bad body, base64, image or k), 404, 411 (no Content-Length,
or chunked transfer: the connection closes), 413 (body over
``MAX_BODY_BYTES``), 429 + ``Retry-After: 1`` (shed: ``max_pending``
requests in flight, a full batcher queue, or a dispatch deadline passed
behind healthy dispatches), 503 + ``Retry-After: 5`` (a dispatch in flight
longer than ``dispatch_timeout_s``), 500. Keep-alive holds across errors
(every body is drained before the reply).

Concurrency: ``ThreadingHTTPServer`` decodes each request in its own
thread; dispatches to the device are serialised (a lock, or the dynamic
batcher's one worker thread). With ``batch_window_ms > 0`` concurrent
requests coalesce into one dispatch of at most ``max_batch`` rows. Every
dispatch is padded to a power-of-two row count, so ``warmup_buckets`` can
run each shape once before serving: on the card the first launch of a
shape pays cuDNN's algorithm choice and the kernels' first use. A wedged
CUDA call cannot be interrupted; the 503 path bounds only the requests
waiting behind it, and /healthz reports it.

``--artifact`` serves a retriever artifact (``inference/export.py``):
program, weights, gallery and paths come from the file, no checkpoint or
index. ``TPU.SHARDED_RETRIEVAL`` shards the gallery over the visible cards
(``RetrievalService(mesh=)``) when there are at least two.
Divergence from the JAX server: a 0-row batch dispatches nothing and gets
an empty result (the reference's ``_dispatch_sliced`` raises on it).
"""

from __future__ import annotations

import base64
import binascii
import json
import queue
import threading
import time
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeout
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

MAX_BODY_BYTES = 256 << 20  # one POST; ~256 queries of phone-camera JPEGs


class Overloaded(RuntimeError):
    """Load shed: HTTP 429 with ``Retry-After: 1``."""


class DispatchStuck(RuntimeError):
    """A dispatch did not complete (or could not start) within
    ``dispatch_timeout_s`` while one has been in flight longer than that:
    HTTP 503 with ``Retry-After: 5``."""


class BadRequest(ValueError):
    pass


def _bucket_rows(n: int) -> int:
    """Next power of two >= n: the row count a dispatch is padded to."""
    b = 1
    while b < n:
        b <<= 1
    return b


class _DispatchClock:
    """Start times of the dispatches in flight (thread safe):
    ``oldest_age_s()`` is the age of the oldest, 0.0 when idle."""

    def __init__(self):
        self._lock = threading.Lock()
        self._active: dict = {}
        self._next = 0

    def begin(self) -> int:
        with self._lock:
            self._next += 1
            tok = self._next
            self._active[tok] = time.monotonic()
        return tok

    def end(self, tok: int) -> None:
        with self._lock:
            self._active.pop(tok, None)

    def oldest_age_s(self) -> float:
        with self._lock:
            if not self._active:
                return 0.0
            return time.monotonic() - min(self._active.values())


def _dispatch_sliced(svc, rows_arr: np.ndarray, max_batch: int,
                     clock: _DispatchClock = None):
    """``svc.query_arrays`` over ``rows_arr`` in slices of at most
    ``max_batch`` rows, each zero-padded to its power-of-two bucket (pad
    rows trimmed from the results). 0 rows dispatch nothing and give empty
    ``(distances, indices, paths)``."""
    n_rows = rows_arr.shape[0]
    if n_rows == 0:
        k = int(svc.k)
        return (np.zeros((0, k), np.float32), np.zeros((0, k), np.int64),
                np.asarray(svc.paths)[np.zeros((0, k), np.int64)])
    out = []
    for s in range(0, n_rows, max_batch):
        part = rows_arr[s:s + max_batch]
        n = part.shape[0]
        pad = _bucket_rows(n) - n
        if pad:
            part = np.concatenate(
                [part, np.zeros((pad, *part.shape[1:]), part.dtype)])
        tok = clock.begin() if clock is not None else None
        try:
            d, idx, paths = svc.query_arrays(part)
        finally:
            if clock is not None:
                clock.end(tok)
        out.append((d[:n], idx[:n], paths[:n]))
    if len(out) == 1:
        return out[0]
    return tuple(np.concatenate([p[i] for p in out]) for i in range(3))


class _DynamicBatcher:
    """Coalesces concurrent query batches into single dispatches.

    A worker thread takes the first queued entry (imgs, service, Future),
    then keeps collecting for ``window_ms`` while the staged rows stay
    within ``max_batch``, runs one ``_dispatch_sliced`` over the
    concatenated rows and hands each entry its slice of the results. An
    entry that would push the rows past ``max_batch``, or that carries
    another service (a ``swap_service`` between its enqueue and this
    batch), closes the batch and opens the next one; a single request
    larger than ``max_batch`` dispatches alone in slices. So no dispatch
    exceeds ``max_batch`` rows, and each is padded to a power of two.

    ``max_queue`` bounds the queue (``submit`` raises ``Overloaded`` past
    it). In the HTTP server every queued entry also holds a
    ``max_pending`` slot, so this bound binds only below ``max_pending``.
    """

    def __init__(self, window_ms: float = 2.0, max_batch: int = 256,
                 max_queue: int = 64, clock: _DispatchClock = None):
        self.window_s = float(window_ms) / 1e3
        self.max_batch = int(max_batch)
        # a batcher without a server owns its clock, so a timeout still
        # tells a wedged dispatch (503) from backlog (429)
        self._clock = clock if clock is not None else _DispatchClock()
        self._q: queue.Queue = queue.Queue(maxsize=int(max_queue))
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def submit(self, imgs: np.ndarray, service, timeout: float = None):
        """Queue ``imgs`` for ``service`` and wait for its results, at most
        ``timeout`` seconds (None: no bound). On expiry the entry is
        cancelled (skipped if still queued, its result dropped if in
        flight) and the wait raises ``DispatchStuck`` when a dispatch has
        been in flight longer than ``timeout``, else ``Overloaded``."""
        fut: Future = Future()
        try:
            self._q.put_nowait((imgs, service, fut))
        except queue.Full:
            raise Overloaded(
                f"batch queue full ({self._q.maxsize} requests waiting)")
        try:
            return fut.result(timeout)
        except FuturesTimeout:
            fut.cancel()
            if self._clock.oldest_age_s() < timeout:
                raise Overloaded(
                    f"queue wait exceeded {timeout:g}s behind healthy "
                    "dispatches") from None
            raise DispatchStuck(
                f"coalesced dispatch did not complete within {timeout:g}s"
            ) from None

    def stop(self):
        """End the worker; entries queued before the sentinel complete."""
        self._q.put(None)
        self._thread.join(10)

    def _worker(self):
        pending = None  # the entry that closed the previous batch
        while True:
            first = pending if pending is not None else self._q.get()
            pending = None
            if first is None:
                return
            imgs, svc, fut = first
            staged = [(imgs, fut)]
            rows = imgs.shape[0]
            deadline = time.monotonic() + self.window_s
            while rows < self.max_batch:
                budget = deadline - time.monotonic()
                if budget <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=budget)
                except queue.Empty:
                    break
                if nxt is None:  # shutdown: finish this batch first
                    self._q.put(None)
                    break
                if (nxt[1] is not svc
                        or rows + nxt[0].shape[0] > self.max_batch):
                    pending = nxt
                    break
                staged.append((nxt[0], nxt[2]))
                rows += nxt[0].shape[0]
            # drop entries whose submitter timed out; the rest are marked
            # running, so a late cancel cannot race set_result
            staged = [(s_imgs, s_fut) for s_imgs, s_fut in staged
                      if s_fut.set_running_or_notify_cancel()]
            if not staged:
                continue
            try:
                batch = (staged[0][0] if len(staged) == 1
                         else np.concatenate([s[0] for s in staged]))
                d, idx, paths = _dispatch_sliced(svc, batch, self.max_batch,
                                                 self._clock)
                off = 0
                for s_imgs, s_fut in staged:
                    n = s_imgs.shape[0]
                    s_fut.set_result((d[off:off + n], idx[off:off + n],
                                      paths[off:off + n]))
                    off += n
            except Exception as e:  # the waiters answer 500
                for _, s_fut in staged:
                    if not s_fut.done():
                        s_fut.set_exception(e)


class RetrievalHTTPServer:
    """A ``RetrievalService`` or ``export.LoadedRetriever`` (any object
    with their ``paths``, ``k``, ``ingest_format``, ``model_name``,
    ``input_size_hw``, ``ingest_bytes`` and ``query_arrays``) behind a
    threaded HTTP server.

    ``port=0`` binds an ephemeral port (``server.port`` reports it).
    ``start_background()`` serves from a daemon thread, ``serve_forever()``
    in the foreground until SIGTERM / SIGINT; ``shutdown()`` stops either.
    ``max_pending`` bounds the /search requests holding decoded batches,
    ``max_queue`` the batcher's queue, ``dispatch_timeout_s`` (0: no bound)
    any request's wait for the device."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 8000,
                 batch_window_ms: float = 0.0, max_batch: int = 256,
                 max_pending: int = 32, max_queue: int = 64,
                 dispatch_timeout_s: float = 30.0):
        self.service = service
        self._dispatch_lock = threading.Lock()
        self.max_pending = int(max_pending)
        self.max_batch = int(max_batch)
        self.dispatch_timeout_s = float(dispatch_timeout_s)
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._clock = _DispatchClock()
        self._batcher = (
            _DynamicBatcher(batch_window_ms, max_batch, max_queue,
                            clock=self._clock)
            if batch_window_ms > 0 else None)
        self._thread = None
        self._serving = False
        self._stats_lock = threading.Lock()
        self._stats = {"requests": 0, "images": 0, "errors": 0, "shed": 0,
                       "stuck": 0}
        self.httpd = ThreadingHTTPServer((host, port), _make_handler(self))
        self.httpd.daemon_threads = True
        self.host, self.port = self.httpd.server_address[:2]

    def _acquire_slot(self):
        with self._pending_lock:
            if self._pending >= self.max_pending:
                raise Overloaded(f"{self._pending} requests in flight "
                                 f"(max_pending={self.max_pending})")
            self._pending += 1

    def _release_slot(self):
        with self._pending_lock:
            self._pending -= 1

    def count(self, images: int = 0, error: bool = False,
              shed: bool = False, stuck: bool = False):
        with self._stats_lock:
            self._stats["requests"] += 1
            self._stats["images"] += images
            self._stats["errors"] += int(error)
            self._stats["shed"] += int(shed)
            self._stats["stuck"] += int(stuck)

    def health(self) -> dict:
        svc = self.service
        with self._stats_lock:
            stats = dict(self._stats)
        with self._pending_lock:
            pending = self._pending
        age = self._clock.oldest_age_s()
        degraded = 0 < self.dispatch_timeout_s < age
        return {
            "status": "degraded" if degraded else "ok",
            "gallery_size": int(len(svc.paths)),
            "k": int(svc.k),
            "ingest": svc.ingest_format,
            "model": svc.model_name,
            "rerank_window": int(getattr(svc, "rerank_window", 0)),
            "batching": self._batcher is not None,
            "pending": pending,
            "max_pending": self.max_pending,
            "in_dispatch_s": round(age, 3),
            "dispatch_timeout_s": self.dispatch_timeout_s,
            **stats,
        }

    def search(self, payload: dict) -> dict:
        # one request validates, decodes and dispatches against one
        # service: a swap_service in between must not mix generations
        svc = self.service
        imgs_b64 = payload.get("images_b64")
        if not isinstance(imgs_b64, list) or not imgs_b64:
            raise BadRequest("'images_b64' must be a non-empty list")
        k = payload.get("k", svc.k)
        # bool is an int subclass: "k": true must not mean k=1
        if (not isinstance(k, int) or isinstance(k, bool)
                or not 1 <= k <= svc.k):
            raise BadRequest(
                f"'k' must be an int in [1, {svc.k}] (the service was built "
                f"with k={svc.k}; rebuild it for deeper results)")
        try:
            blobs = [base64.b64decode(s, validate=True) for s in imgs_b64]
        except (binascii.Error, TypeError) as e:
            raise BadRequest(f"invalid base64 image payload: {e}")
        # the slot covers decode and dispatch: decoded batches are what a
        # burst costs in host memory
        self._acquire_slot()
        try:
            try:
                imgs = svc.ingest_bytes(blobs)
            except Exception as e:
                raise BadRequest(f"undecodable image: {e}")
            timeout = self.dispatch_timeout_s or None
            if self._batcher is not None:
                d, idx, paths = self._batcher.submit(imgs, svc,
                                                     timeout=timeout)
            else:
                if not self._dispatch_lock.acquire(
                        timeout=-1 if timeout is None else timeout):
                    if self._clock.oldest_age_s() < timeout:
                        raise Overloaded(
                            f"dispatch-lock wait exceeded {timeout:g}s "
                            "behind healthy dispatches")
                    raise DispatchStuck(
                        f"device dispatch held > {timeout:g}s by an "
                        "earlier request")
                try:
                    d, idx, paths = _dispatch_sliced(svc, imgs,
                                                     self.max_batch,
                                                     self._clock)
                finally:
                    self._dispatch_lock.release()
        finally:
            self._release_slot()
        return {"results": [
            {"paths": [str(p) for p in paths[i, :k]],
             "indices": [int(j) for j in idx[i, :k]],
             "distances": [float(x) for x in d[i, :k]]}
            for i in range(len(blobs))]}

    def serve_forever(self):
        """Serve in the foreground; SIGTERM / SIGINT stop the accept loop and
        return after the handlers in flight."""
        import signal

        def _stop(signum, frame):
            # httpd.shutdown() waits for serve_forever: not on this thread
            threading.Thread(target=self.httpd.shutdown).start()

        previous = {s: signal.signal(s, _stop)
                    for s in (signal.SIGTERM, signal.SIGINT)}
        print(f"RetrievalHTTPServer on http://{self.host}:{self.port} "
              f"(gallery={len(self.service.paths)}, k={self.service.k})",
              flush=True)
        self._serving = True
        try:
            self.httpd.serve_forever()
        finally:
            self._serving = False
            for s, old in previous.items():
                signal.signal(s, old)
            self.httpd.server_close()
            with self._stats_lock:
                stats = dict(self._stats)
            print(f"RetrievalHTTPServer stopped cleanly ({stats})",
                  flush=True)

    def start_background(self):
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)
        self._serving = True
        self._thread.start()
        return self

    def warmup_buckets(self, max_rows: int = 0) -> None:
        """Run one zero batch of each power-of-two row count up to
        ``max_rows`` (default: the batcher's ``max_batch``, or 1 without
        batching), the shapes traffic can dispatch, before serving."""
        from ..data.transforms import ingest_item_shape

        svc = self.service
        if not max_rows:
            max_rows = self._batcher.max_batch if self._batcher else 1
        shape = ingest_item_shape(svc.ingest_format, svc.input_size_hw)
        b = 1
        while True:
            svc.query_arrays(np.zeros((b, *shape), np.uint8))
            if b >= max_rows:
                break
            b <<= 1

    def swap_service(self, new_service) -> None:
        """Replace the service (a rebuilt gallery) without a restart:
        requests that already took the old one, queued ones included,
        finish on it; later requests rank against the new one. Counters
        persist."""
        with self._dispatch_lock:
            self.service = new_service

    def shutdown(self):
        # BaseServer.shutdown() waits for a serve_forever that may never
        # have started
        if self._serving:
            self.httpd.shutdown()
            self._serving = False
        self.httpd.server_close()
        if self._batcher is not None:
            self._batcher.stop()
        if self._thread is not None:
            self._thread.join(10)


def _make_handler(server: RetrievalHTTPServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        # a client that stalls mid-request must not hold a thread forever
        timeout = 120

        def log_message(self, fmt, *args):
            pass

        def _reply(self, code: int, obj: dict, retry_after: int = 0):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after:
                self.send_header("Retry-After", str(retry_after))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                return self._reply(200, server.health())
            return self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            # a body that cannot (chunked) or will not (bad Content-Length)
            # be drained would desync a kept-alive connection: 411, close
            chunked = "chunked" in (self.headers.get("Transfer-Encoding")
                                    or "").lower()
            try:
                n = int(self.headers.get("Content-Length", 0))
            except (ValueError, TypeError):
                n = -1
            if chunked or n < 0:
                self.close_connection = True
                return self._reply(411, {"error": "Content-Length required"})
            if n > MAX_BODY_BYTES:
                self.close_connection = True
                return self._reply(
                    413, {"error": f"body exceeds {MAX_BODY_BYTES} bytes"})
            body = self.rfile.read(n) if n > 0 else b""
            if self.path != "/search":
                return self._reply(404, {"error": f"unknown path {self.path}"})
            if n == 0:
                return self._reply(400, {"error": "missing request body"})
            try:
                payload = json.loads(body)
                if not isinstance(payload, dict):
                    raise BadRequest("body must be a JSON object")
                out = server.search(payload)
                server.count(images=len(out["results"]))
                return self._reply(200, out)
            except Overloaded as e:
                server.count(error=True, shed=True)
                return self._reply(429, {"error": f"overloaded: {e}"},
                                   retry_after=1)
            except DispatchStuck as e:
                server.count(error=True, stuck=True)
                return self._reply(503, {"error": f"dispatch stalled: {e}"},
                                   retry_after=5)
            except BadRequest as e:
                server.count(error=True)
                return self._reply(400, {"error": str(e)})
            except json.JSONDecodeError as e:
                server.count(error=True)
                return self._reply(400, {"error": f"invalid JSON: {e}"})
            except Exception as e:
                server.count(error=True)
                return self._reply(500,
                                   {"error": f"{type(e).__name__}: {e}"})

    return Handler


def build_from_args(argv=None) -> RetrievalHTTPServer:
    """The CLI: load a gallery index (``embeddings.npy`` + ``paths.npy`` of
    ``create_embeddings``) and the model, or a retriever artifact
    (``--artifact``), into a bound, not yet serving
    ``RetrievalHTTPServer``."""
    import argparse
    from pathlib import Path

    from ..config import get_default_cfg
    from ..models.transreid import family, is_transformer, refuse
    from .api import load_inference_model
    from .service import SEARCH_WHY, RetrievalService

    parser = argparse.ArgumentParser(
        description="HTTP retrieval serving over a device-resident gallery")
    parser.add_argument("--config_file", default="", type=str)
    parser.add_argument(
        "--gallery_data", type=str, default="",
        help="dir with embeddings.npy/paths.npy from create_embeddings")
    parser.add_argument(
        "--artifact", type=str, default="",
        help="serve a retriever artifact (inference.export_model "
             "--retriever): program, weights, gallery and paths from the "
             "file; no checkpoint or index")
    parser.add_argument("--host", default="127.0.0.1", type=str)
    parser.add_argument("--port", default=8000, type=int)
    parser.add_argument(
        "--topk", type=int, default=100,
        help="max results per query (the gallery depth the service ranks)")
    parser.add_argument("--normalize_features", action="store_true")
    parser.add_argument(
        "--fp32_exact", action="store_true",
        help="fp32 selection (default: bf16 select + exact re-score)")
    parser.add_argument(
        "--batch_window_ms", type=float, default=0.0,
        help="dynamic batching: coalesce concurrent requests arriving "
             "within this window into one dispatch (0 = off)")
    parser.add_argument(
        "--max_batch", type=int, default=256,
        help="max rows per dispatch")
    parser.add_argument(
        "--max_pending", type=int, default=32,
        help="max concurrent /search requests holding decoded batches; "
             "beyond it requests are shed with HTTP 429")
    parser.add_argument(
        "--max_queue", type=int, default=64,
        help="dynamic batching: max queued requests before shedding "
             "(queued requests also hold --max_pending slots, so this "
             "only binds below --max_pending)")
    parser.add_argument(
        "--warmup_buckets", type=int, default=0,
        help="before serving, run every power-of-two dispatch shape up to "
             "N rows once (cuDNN's algorithm choice, the kernels' first "
             "use); 0 = off")
    parser.add_argument(
        "--dispatch_timeout", type=float, default=30.0,
        help="bound (seconds) on any request's wait for the device; past "
             "it the request answers 503 (or 429 behind healthy "
             "dispatches) and /healthz reports degraded (0 = unbounded)")
    parser.add_argument(
        "--rerank_window", type=int, default=0,
        help="re-rank each query's top-N window with k-reciprocal encoding "
             "(responses then equal get_similar's with TPU.RERANK_WINDOW); "
             "0 = off, or TPU.RERANK + TPU.RERANK_WINDOW in the opts")
    parser.add_argument(
        "--int8_gallery", action="store_true",
        help="select on a per-row int8 gallery index (K4), distances stay "
             "exact fp32 re-scores")
    parser.add_argument("--rerank_k1", type=int, default=None,
                        help="k-reciprocal neighbourhood (TPU.RERANK_K1)")
    parser.add_argument("--rerank_k2", type=int, default=None,
                        help="local query expansion (TPU.RERANK_K2)")
    parser.add_argument("--rerank_lambda", type=float, default=None,
                        help="original-distance weight (TPU.RERANK_LAMBDA)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default: the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.artifact and args.int8_gallery:
        raise SystemExit(
            "--int8_gallery applies to --gallery_data serving (the service "
            "quantizes at build); artifacts carry their gallery in the file: "
            "re-export instead")
    if args.artifact:
        # everything rides in the file; re-ranking is a load-time choice,
        # with the TPU.RERANK_* defaults unless the flags say otherwise
        from .export import load_retriever

        dtpu = get_default_cfg().TPU
        retriever = load_retriever(
            args.artifact, args.device,
            use_bf16_kernel=False if args.fp32_exact else None,
            rerank_window=args.rerank_window,
            rerank_k1=(dtpu.RERANK_K1 if args.rerank_k1 is None
                       else args.rerank_k1),
            rerank_k2=(dtpu.RERANK_K2 if args.rerank_k2 is None
                       else args.rerank_k2),
            rerank_lambda=(dtpu.RERANK_LAMBDA if args.rerank_lambda is None
                           else args.rerank_lambda))
        retriever.warmup()   # the first request must not pay a first use
        server = RetrievalHTTPServer(
            retriever, args.host, args.port,
            batch_window_ms=args.batch_window_ms, max_batch=args.max_batch,
            max_pending=args.max_pending, max_queue=args.max_queue,
            dispatch_timeout_s=args.dispatch_timeout)
        if args.warmup_buckets:
            server.warmup_buckets(args.warmup_buckets)
        return server
    if not args.gallery_data:
        raise SystemExit("one of --gallery_data or --artifact is required")
    cfg = get_default_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    cfg.merge_from_list(args.opts)
    if is_transformer(cfg):
        refuse("the HTTP server", SEARCH_WHY, family(cfg))
    mesh = None
    if cfg.TPU.SHARDED_RETRIEVAL:
        # a mesh over the cards when at least two are visible, as the
        # reference's front does
        from ..parallel import mesh as pmesh

        devices = pmesh.local_devices(args.device)
        if len(devices) >= 2:
            mesh = pmesh.make_retrieval_mesh(devices=devices)

    load_path = Path(args.gallery_data)
    emb = np.load(load_path / "embeddings.npy", allow_pickle=True)
    paths = np.load(load_path / "paths.npy", allow_pickle=True)
    model = load_inference_model(cfg, args.device)
    qfn = None
    if cfg.TPU.INT8_EVAL:
        # the shared flow: TPU.INT8_CACHE_PATH's artifact, else calibration
        # on the leading TPU.INT8_CALIB_BATCHES of the gallery's own images
        from ..data.datasets import Record
        from ..models.quantized import quantize_for_serving

        records = [Record(str(p), 0, 0, i) for i, p in enumerate(paths)]
        try:
            qfn = quantize_for_serving(cfg, model, records)
        except OSError as e:
            raise SystemExit(
                f"TPU.INT8_EVAL needs the gallery images on this host to "
                f"calibrate (failed on {e}); serve without the flag, set "
                f"TPU.INT8_CACHE_PATH to a saved artifact, or run where the "
                f"indexed files are")
    # --rerank_window wins; else the config enables it as get_similar's
    rr = args.rerank_window
    if not rr and cfg.TPU.RERANK and cfg.TPU.RERANK_WINDOW > 0:
        rr = int(cfg.TPU.RERANK_WINDOW)
    service = RetrievalService(
        cfg, emb, paths, k=args.topk, normalize=args.normalize_features,
        use_bf16_kernel=not args.fp32_exact, device=args.device, model=model,
        int8_qfn=qfn, use_int8_gallery=args.int8_gallery, rerank_window=rr,
        mesh=mesh,
        rerank_k1=(cfg.TPU.RERANK_K1 if args.rerank_k1 is None
                   else args.rerank_k1),
        rerank_k2=(cfg.TPU.RERANK_K2 if args.rerank_k2 is None
                   else args.rerank_k2),
        rerank_lambda=(cfg.TPU.RERANK_LAMBDA if args.rerank_lambda is None
                       else args.rerank_lambda))
    server = RetrievalHTTPServer(
        service, args.host, args.port, batch_window_ms=args.batch_window_ms,
        max_batch=args.max_batch, max_pending=args.max_pending,
        max_queue=args.max_queue, dispatch_timeout_s=args.dispatch_timeout)
    if args.warmup_buckets:
        server.warmup_buckets(args.warmup_buckets)
    return server


def main(argv=None):
    build_from_args(argv).serve_forever()


if __name__ == "__main__":
    main()
