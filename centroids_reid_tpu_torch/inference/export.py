"""Portable serving artifacts: the embed program serialised with
``torch.export`` into one self-contained file (counterpart of
``centroids_reid_tpu/inference/export.py``, whose programs are StableHLO).

Artifact contract
-----------------
One file::

    MAGIC (10 bytes) | meta_len (8-byte LE) | meta JSON | aux | programs

``programs`` holds one ``torch.export.save`` blob per device type, in the
order of ``meta["platforms"]``, their lengths in ``meta["blob_bytes"]``. A
torch program bakes in the device it was traced on (bf16 autocast for that
device type, device asserts), so one trace per device type is exported,
where JAX lowers one trace for every platform; a loader takes the program
of its own device type and raises where the file has none.

The exported function is the serving embed program: uint8 RGB ``[B, H,
W, 3]`` (or, in a retriever with the ``yuv420`` ingest, packed YUV420
``[B, 1.5 H W]``) in, normalisation, backbone + BNNeck (or the int8 PTQ
program, its weights and the fused convs' packed copies baked in), optional
L2 normalisation: the embed stage of ``RetrievalService``
(``service.embed_query``). The batch is symbolic by default or fixed with
``batch_size``; the int8 program and the retriever take a fixed batch and
the loaders pad a partial one.

The retriever artifact adds the aux section, the normalised fp32 gallery
and its paths as ``np.savez``. Its loader ranks through the live
``service.ranked_query`` / ``reranked_query`` on that gallery, on the
loading device's kernels: ranking has no weights, so a backend's choice
belongs to load time.

The port's magic differs from the JAX package's, whose reader checks only
magic and version before it hands the rest to ``jax.export``; this reader
names a JAX artifact and refuses it.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import logging
import struct
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .. import ops  # noqa: F401  (registers the crt:: operators for load)
from ..models.transreid import refuse_model

log = logging.getLogger(__name__)

MAGIC = b"CRTORCH-A\n"
JAX_MAGIC = b"CRTPU-ART\n"   # the JAX package's StableHLO artifacts
FORMAT_VERSION = 1      # artifacts without an aux section (embedder)
FORMAT_VERSION_AUX = 2  # artifacts carrying an aux section (retriever)
SUPPORTED_VERSIONS = (FORMAT_VERSION, FORMAT_VERSION_AUX)
# serve on the card, smoke-test and load on the CPU: one trace each
DEFAULT_PLATFORMS = ("cuda", "cpu")
_MAX_BATCH = 1 << 16     # the symbolic batch's upper bound


# ---------------------------------------------------------------------
# export
# ---------------------------------------------------------------------

class _ServingEmbed(torch.nn.Module):
    """The serving embed program (the JAX package's ``_serving_embed_fn``):
    ``service.embed_query`` on ``model`` (uint8 RGB ``[B, H, W, 3]``, or
    packed YUV420 ``[B, 1.5 H W]``), or the int8 program of ``int8_qfn``
    (``QuantizedEmbedModule``, RGB), then the optional L2 normalisation."""

    def __init__(self, model, cfg, *, normalize: bool, int8_qfn):
        super().__init__()
        from ..models.quantized import QuantizedEmbedModule

        self.qview = (None if int8_qfn is None
                      else QuantizedEmbedModule(int8_qfn))
        self.model = model if int8_qfn is None else None
        self.normalize = bool(normalize)
        self.size_hw = tuple(int(v) for v in cfg.INPUT.SIZE_TEST)
        self.mean = tuple(float(v) for v in cfg.INPUT.PIXEL_MEAN)
        self.std = tuple(float(v) for v in cfg.INPUT.PIXEL_STD)
        self.dtype = (torch.bfloat16 if cfg.USE_MIXED_PRECISION
                      else torch.float32)

    def forward(self, imgs_u8):
        from .service import embed_query

        if self.qview is None:
            return embed_query(self.model, imgs_u8, self.mean, self.std,
                               self.dtype, self.normalize, self.size_hw)
        e = self.qview(imgs_u8)
        if self.normalize:
            e = e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
        return e


def _model_on(model, device: torch.device):
    """``model`` on ``device``: itself where it lies there, else a copy (the
    caller's model stays where it is)."""
    if model is None:
        return None
    p = next(model.parameters())
    if p.device.type == device.type:
        return model
    return copy.deepcopy(model).to(device)


def _export_programs(model, cfg, item_shape, batch_size, platforms, *,
                     normalize: bool, int8_qfn):
    """One ``torch.export`` program per device type in ``platforms``.
    Returns ``({type: blob}, {type: export seconds}, (emb_dim, dtype))``."""
    refuse_model(model, "export", "a serving program takes images alone, "
                 "and TransReID's SIE needs each image's camera id; no "
                 "transformer's serving program is ported")
    blobs, seconds, out = {}, {}, None
    for platform in platforms:
        device = torch.device(platform)
        qfn = None
        if int8_qfn is not None:
            qfn = (int8_qfn if int8_qfn.device.type == device.type
                   else int8_qfn.to(device))
        module = _ServingEmbed(_model_on(model, device), cfg,
                               normalize=normalize, int8_qfn=qfn).eval()
        example = torch.zeros((batch_size or 2, *item_shape),
                              dtype=torch.uint8, device=device)
        dynamic = None
        if batch_size is None:
            dynamic = ({0: torch.export.Dim("batch", min=1,
                                            max=_MAX_BATCH)},)
        t0 = time.perf_counter()
        program = torch.export.export(module, (example,),
                                      dynamic_shapes=dynamic, strict=False)
        buf = io.BytesIO()
        torch.export.save(program, buf)
        seconds[platform] = time.perf_counter() - t0
        blobs[platform] = buf.getvalue()
        val = [n for n in program.graph.nodes
               if n.op == "output"][0].args[0][0].meta["val"]
        out = (int(val.shape[-1]), str(val.dtype).removeprefix("torch."))
    return blobs, seconds, out


def _check_platforms(platforms) -> tuple:
    platforms = tuple(str(p) for p in platforms)
    bad = [p for p in platforms if p not in ("cuda", "cpu")]
    if not platforms or bad or len(set(platforms)) != len(platforms):
        raise ValueError(f"platforms are distinct device types, 'cuda' or "
                         f"'cpu'; got {platforms}")
    return platforms


def _common_meta(cfg, int8_qfn, normalize, platforms, seconds, out):
    return {
        "model_name": str(cfg.MODEL.NAME),
        "quantized": int8_qfn is not None,
        "input_size_hw": [int(v) for v in cfg.INPUT.SIZE_TEST],
        "emb_dim": out[0],
        "emb_dtype": out[1],
        "normalized": bool(normalize),
        "pixel_mean": [float(v) for v in cfg.INPUT.PIXEL_MEAN],
        "pixel_std": [float(v) for v in cfg.INPUT.PIXEL_STD],
        "platforms": list(platforms),
        "export_seconds": seconds,
        "torch_version": torch.__version__,
    }


def export_embedder(model, cfg, *, normalize: bool = True,
                    batch_size: Optional[int] = None,
                    platforms: Sequence[str] = DEFAULT_PLATFORMS,
                    int8_qfn=None):
    """Serialise the serving embed program of ``model`` (a ``ReidModel``
    in eval mode). Returns ``(blobs, meta)`` for ``save_artifact``:
    ``blobs`` maps each device type of ``platforms`` to its program.

    ``batch_size=None`` exports a symbolic batch (any B). ``int8_qfn``: a
    ``QuantizedEmbed``, whose int8 program is exported instead of the
    float one; it needs ``batch_size``."""
    platforms = _check_platforms(platforms)
    if int8_qfn is not None and batch_size is None:
        raise ValueError(
            "int8 export needs a fixed batch_size (the quantized program is "
            "deployed at one static serving shape)")
    h, w = (int(v) for v in cfg.INPUT.SIZE_TEST)
    blobs, seconds, out = _export_programs(
        model, cfg, (h, w, 3), batch_size, platforms, normalize=normalize,
        int8_qfn=int8_qfn)
    meta = {
        "format_version": FORMAT_VERSION,
        "kind": "embedder",
        "batch_size": batch_size,  # None => symbolic
        **_common_meta(cfg, int8_qfn, normalize, platforms, seconds, out),
    }
    return blobs, meta


def save_artifact(path: str, blobs: Dict[str, bytes], meta: dict,
                  aux: bytes = b"") -> None:
    """Write one artifact: ``blobs`` maps device types to programs (their
    order and lengths go into ``meta["platforms"]`` and
    ``meta["blob_bytes"]``); ``aux`` is the optional section between the
    meta JSON and the programs, its length in ``meta["aux_bytes"]``.
    Aux-bearing files are format v2, as in the JAX package."""
    meta = dict(meta)
    meta["platforms"] = list(blobs)
    meta["blob_bytes"] = [len(b) for b in blobs.values()]
    if aux:
        meta["aux_bytes"] = len(aux)
        meta["format_version"] = FORMAT_VERSION_AUX
    meta_bytes = json.dumps(meta, sort_keys=True).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", len(meta_bytes)))
        f.write(meta_bytes)
        if aux:
            f.write(aux)
        for blob in blobs.values():
            f.write(blob)


def _read_artifact_sections(path: str):
    """Returns ``(blobs, meta, aux)`` after validating magic + version."""
    with open(path, "rb") as f:
        head = f.read(len(MAGIC))
        if head == JAX_MAGIC:
            raise ValueError(
                f"{path}: a StableHLO artifact of the JAX package "
                "(centroids_reid_tpu.inference.export); re-export it with "
                "the port: python -m "
                "centroids_reid_tpu_torch.inference.export_model")
        if head != MAGIC:
            raise ValueError(
                f"{path}: not a centroids-reid torch artifact "
                f"(bad magic {head!r})")
        (meta_len,) = struct.unpack("<Q", f.read(8))
        meta = json.loads(f.read(meta_len).decode("utf-8"))
        ver = meta.get("format_version")
        if ver not in SUPPORTED_VERSIONS:
            raise ValueError(
                f"{path}: artifact format v{ver}, this loader reads "
                f"v{'/v'.join(str(v) for v in SUPPORTED_VERSIONS)}")
        aux = f.read(int(meta.get("aux_bytes", 0)))
        blobs = {p: f.read(int(n)) for p, n in
                 zip(meta.get("platforms", []), meta.get("blob_bytes", []))}
    if any(len(b) != int(n) for b, n in zip(blobs.values(),
                                           meta.get("blob_bytes", []))):
        raise ValueError(f"{path}: truncated artifact")
    return blobs, meta, aux


def read_artifact(path: str):
    """Returns ``(blobs, meta)`` after validating magic + format version."""
    blobs, meta, _ = _read_artifact_sections(path)
    return blobs, meta


def _load_program(path: str, blobs: Dict[str, bytes], device):
    """The program of ``device``'s type as a callable module; raises where
    the file has none (no program of another device type stands in)."""
    device = torch.device(device)
    blob = blobs.get(device.type)
    if blob is None:
        raise ValueError(
            f"{path}: no program for device type {device.type!r} (the file "
            f"holds {sorted(blobs)}); re-export with --platforms naming "
            f"{device.type!r}")
    return torch.export.load(io.BytesIO(blob)).module()


# ---------------------------------------------------------------------
# export: retriever (artifact v2: embed program + gallery)
# ---------------------------------------------------------------------

def export_retriever(model, cfg, gallery_embeddings, gallery_paths, *,
                     k: int = 100, batch_size: int,
                     normalize: bool = True,
                     platforms: Sequence[str] = DEFAULT_PLATFORMS,
                     int8_qfn=None):
    """Serialise the retriever artifact: the serving embed program at a
    fixed batch plus the gallery rows and paths in the aux section.
    Returns ``(blobs, meta, aux)`` for ``save_artifact``. ``load_retriever``
    ranks through the live ``service.ranked_query`` on the card's kernels
    (K2 at k <= 32, K1 + K3 above), so a serving host needs the file and
    this package: no model code path, checkpoint or index directory."""
    from ..data.transforms import ingest_item_shape
    from .utils import serving_ingest_format

    platforms = _check_platforms(platforms)
    if batch_size is None:
        raise ValueError("retriever export needs a fixed batch_size")
    h, w = (int(v) for v in cfg.INPUT.SIZE_TEST)
    b = int(batch_size)
    ingest = "rgb" if int8_qfn is not None else serving_ingest_format(cfg)
    blobs, seconds, out = _export_programs(
        model, cfg, ingest_item_shape(ingest, (h, w)), b, platforms,
        normalize=normalize, int8_qfn=int8_qfn)

    # aux: the NORMALISED fp32 gallery + paths (the live service's host
    # math); the loader pads it with service._pad_gallery as the service
    # does, so both rank the same arrays
    gf32 = np.asarray(gallery_embeddings, np.float32)
    if normalize:
        gf32 = gf32 / np.maximum(
            np.linalg.norm(gf32, axis=1, keepdims=True), 1e-12)
    paths = np.asarray(gallery_paths)
    buf = io.BytesIO()
    np.savez(buf, gallery=gf32, paths=paths)
    aux = buf.getvalue()
    meta = {
        "format_version": FORMAT_VERSION_AUX,
        "kind": "retriever",
        "rank_stage": "live",
        "batch_size": b,
        "k": int(min(k, len(paths))),
        "gallery_size": int(len(paths)),
        # SOLVER.DISTANCE_FUNC at export: the re-rank's local distance
        "distance": str(cfg.SOLVER.DISTANCE_FUNC),
        "ingest": ingest,
        **_common_meta(cfg, int8_qfn, normalize, platforms, seconds, out),
    }
    meta["emb_dim"] = int(gf32.shape[1])
    return blobs, meta, aux


# ---------------------------------------------------------------------
# load
# ---------------------------------------------------------------------

class _Loaded:
    """What both loaded kinds share: the program of one device type, the
    meta, the shapes dispatched so far, and the device context."""

    def __init__(self, program, meta: dict, device):
        self.program = program
        self.meta = meta
        self.device = torch.device(device)
        self._shapes: set = set()

    @property
    def input_size_hw(self):
        return tuple(self.meta["input_size_hw"])

    @property
    def model_name(self) -> str:
        return str(self.meta["model_name"])

    @property
    def num_compiles(self) -> int:
        """Distinct dispatched input shapes so far (the warm-up contract:
        on the card the first call of a shape pays cuDNN's algorithm
        choice and the kernels' first use)."""
        return len(self._shapes)

    def _device_context(self):
        """The card's launches go to this artifact's device from any thread
        (threads start with cuda:0 current)."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    @torch.inference_mode()
    def _embed_chunk(self, chunk: np.ndarray) -> torch.Tensor:
        """One dispatch of the program; the result stays on the device."""
        x = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
        e = self.program(x)
        self._shapes.add(chunk.shape)   # count only what dispatched
        return e


def _pad_to(chunk: np.ndarray, bs: int) -> np.ndarray:
    pad = bs - chunk.shape[0]
    if not pad:
        return chunk
    return np.concatenate([chunk, np.zeros((pad, *chunk.shape[1:]),
                                           chunk.dtype)])


class LoadedEmbedder(_Loaded):
    """A loaded embedder artifact: ``embed(uint8 [B, H, W, 3]) -> [B, D]``
    on ``device``. Fixed-batch artifacts pad the last partial batch (the
    pad rows are dropped); symbolic-batch ones call straight through, so
    ``warmup`` the serving batch sizes at startup."""

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None) -> None:
        """Run each serving shape once ahead of traffic: the fixed batch
        (``batch_sizes`` ignored), or each size given to a symbolic one."""
        h, w = self.input_size_hw
        fixed = self.meta.get("batch_size")
        if fixed is not None:
            sizes = [int(fixed)]
        elif batch_sizes:
            sizes = [int(s) for s in batch_sizes]
        else:
            raise ValueError(
                "symbolic-batch artifact: pass warmup(batch_sizes=[...])")
        for s in sizes:
            self.embed(np.zeros((s, h, w, 3), np.uint8))

    def embed(self, imgs_u8: np.ndarray) -> np.ndarray:
        imgs_u8 = np.ascontiguousarray(imgs_u8, dtype=np.uint8)
        h, w = self.input_size_hw
        if imgs_u8.ndim != 4 or imgs_u8.shape[1:] != (h, w, 3):
            raise ValueError(
                f"expected uint8 [B,{h},{w},3], got {imgs_u8.shape}")
        n = imgs_u8.shape[0]
        fixed = self.meta.get("batch_size")
        bs = n if fixed is None else int(fixed)
        out = []
        with self._device_context():
            for i in range(0, n, max(bs, 1)):
                chunk = imgs_u8[i: i + bs]
                e = self._embed_chunk(_pad_to(chunk, bs))
                out.append(e[: chunk.shape[0]].cpu().numpy())
        if not out:
            return np.zeros((0, self.meta["emb_dim"]),
                            np.dtype(self.meta["emb_dtype"]))
        return np.concatenate(out)

    __call__ = embed


def load_embedder(path: str, device="cuda") -> LoadedEmbedder:
    """Load an embedder artifact's program for ``device`` (the card unless
    the caller asks for the CPU)."""
    blobs, meta = read_artifact(path)
    if meta.get("kind") != "embedder":
        raise ValueError(f"{path}: artifact kind {meta.get('kind')!r}, "
                         "expected 'embedder'")
    return LoadedEmbedder(_load_program(path, blobs, device), meta, device)


class LoadedRetriever(_Loaded):
    """A loaded retriever artifact: the HTTP front's service surface
    (``k``, ``paths``, ``model_name``, ``ingest_format``,
    ``input_size_hw``, ``rerank_window``, ``ingest_bytes``,
    ``query_arrays``, ``query_bytes``). The aux gallery goes to ``device``
    once, padded with ``service._pad_gallery``; each batch of queries,
    padded to the artifact's fixed batch, runs the embed program, and its
    embeddings go on the device to the live ``service.ranked_query`` (or,
    with ``rerank_window``, ``service.reranked_query``), the rank stage of
    ``RetrievalService``.

    ``use_bf16_kernel``: ``None`` selects on a bf16 gallery on the card
    (K1 / K2 / K3) and on the exact fp32 gallery on the CPU; ``False``
    forces fp32 selection (``--fp32_exact``). ``rerank_window=r`` (r > 0)
    re-ranks each query's top-r window with k-reciprocal encoding (a load
    time choice: ranking has no weights), with the export-time
    ``SOLVER.DISTANCE_FUNC`` as its local distance."""

    def __init__(self, program, meta: dict, aux: bytes, device="cuda", *,
                 use_bf16_kernel: Optional[bool] = None,
                 rerank_window: int = 0, rerank_k1: int = 20,
                 rerank_k2: int = 6, rerank_lambda: float = 0.3):
        from ..ops.retrieval import _G_TILE
        from .service import _pad_gallery

        if meta.get("rank_stage") != "live":
            raise ValueError(
                "this retriever artifact carries no live rank stage; "
                "re-export it with export_retriever")
        super().__init__(program, meta, device)
        self._bs = int(meta["batch_size"])
        self.k = int(meta["k"])
        with np.load(io.BytesIO(aux), allow_pickle=True) as z:
            gallery = np.asarray(z["gallery"], np.float32)
            self.paths = z["paths"]
        if use_bf16_kernel is None:
            use_bf16_kernel = self.device.type == "cuda"
        kernel_dtype = torch.bfloat16 if use_bf16_kernel else torch.float32
        g = int(len(self.paths))
        gf, gn = _pad_gallery(gallery, _G_TILE)
        gf_t = torch.from_numpy(gf).to(self.device)
        self._gf = gf_t.to(kernel_dtype)
        self._gf32 = gf_t[:g].contiguous()
        self._gn = torch.from_numpy(gn).to(self.device)[None, :]
        self.rerank_window = (min(max(int(rerank_window), self.k), g)
                              if rerank_window and g else 0)
        self._rerank = (int(rerank_k1), int(rerank_k2), float(rerank_lambda))
        if "distance" not in meta:
            if self.rerank_window:
                raise ValueError(
                    "rerank_window on an artifact whose meta lacks "
                    "'distance': the re-rank's local distance is unknown; "
                    "re-export it (every artifact the port writes states it)")
            log.warning("artifact meta lacks 'distance'; assuming "
                        "euclidean (it is read only by re-ranking)")
        self._dist = str(meta.get("distance", "euclidean"))
        if (self.rerank_window and self._dist == "cosine"
                and not meta.get("normalized", True)):
            raise ValueError(
                "rerank_window on a cosine-config artifact exported with "
                "normalize=False: euclidean candidate selection is not "
                "rank-equivalent there; re-export with normalize=True")

    @property
    def ingest_format(self) -> str:
        return str(self.meta["ingest"])

    def _item_shape(self):
        from ..data.transforms import ingest_item_shape

        return ingest_item_shape(self.ingest_format, self.input_size_hw)

    def warmup(self) -> None:
        """Run the one program shape once ahead of traffic."""
        self.query_arrays(np.zeros((self._bs, *self._item_shape()),
                                   np.uint8))

    @torch.inference_mode()
    def _rank(self, e):
        from .service import ranked_query, reranked_query

        if self.rerank_window:
            return reranked_query(e, self._gf, self._gf32, self._gn, self.k,
                                  self.rerank_window, *self._rerank,
                                  dist=self._dist)
        return ranked_query(e, self._gf, self._gf32, self._gn, self.k)

    def query_arrays(self, imgs_u8: np.ndarray):
        """uint8 queries in the artifact's ingest format -> (distances
        [B, k], indices [B, k], paths)."""
        imgs_u8 = np.ascontiguousarray(imgs_u8, dtype=np.uint8)
        want = self._item_shape()
        if imgs_u8.shape[1:] != want:
            raise ValueError(
                f"expected uint8 [B,{','.join(map(str, want))}], got "
                f"{imgs_u8.shape}")
        ds, idxs = [], []
        with self._device_context():
            for i in range(0, imgs_u8.shape[0], self._bs):
                chunk = imgs_u8[i: i + self._bs]
                rows = chunk.shape[0]
                d, idx = self._rank(self._embed_chunk(_pad_to(chunk,
                                                              self._bs)))
                ds.append(d[:rows].cpu().numpy())
                idxs.append(idx[:rows].cpu().numpy())
        d = (np.concatenate(ds) if ds
             else np.zeros((0, self.k), np.float32))
        idx = (np.concatenate(idxs) if idxs
               else np.zeros((0, self.k), np.int64))
        return d, idx, self.paths[idx]

    def ingest_bytes(self, blobs: Sequence[bytes]) -> np.ndarray:
        """Encoded image bytes -> the uint8 batch ``query_arrays`` takes
        (the service's host decode, ``data.transforms.ingest_blobs``)."""
        from ..data.transforms import ingest_blobs

        return ingest_blobs(self.ingest_format, self.input_size_hw, blobs)

    def query_bytes(self, blobs: Sequence[bytes]):
        return self.query_arrays(self.ingest_bytes(blobs))


def load_retriever(path: str, device="cuda", *,
                   use_bf16_kernel: Optional[bool] = None,
                   rerank_window: int = 0, rerank_k1: int = 20,
                   rerank_k2: int = 6,
                   rerank_lambda: float = 0.3) -> LoadedRetriever:
    """Load a retriever artifact's program and gallery onto ``device``
    (the card unless the caller asks for the CPU)."""
    blobs, meta, aux = _read_artifact_sections(path)
    if meta.get("kind") != "retriever":
        raise ValueError(f"{path}: artifact kind {meta.get('kind')!r}, "
                         "expected 'retriever'")
    if not aux:
        raise ValueError(f"{path}: retriever artifact has no gallery aux "
                         "section (truncated file?)")
    return LoadedRetriever(
        _load_program(path, blobs, device), meta, aux, device,
        use_bf16_kernel=use_bf16_kernel, rerank_window=rerank_window,
        rerank_k1=rerank_k1, rerank_k2=rerank_k2,
        rerank_lambda=rerank_lambda)


# ---------------------------------------------------------------------
# CLI flow (inference/export_model.py)
# ---------------------------------------------------------------------

def _check_int8_cache(cfg) -> str:
    """Check the calibrated int8 cache BEFORE the (slow) checkpoint load;
    returns the .npz path."""
    import os

    from ..models.quantized import QuantizedEmbed

    cache = cfg.TPU.INT8_CACHE_PATH
    cache = QuantizedEmbed.npz_path(cache) if cache else ""
    if not (cache and os.path.exists(cache)):
        raise ValueError(
            "int8 export needs a calibrated artifact: set "
            "TPU.INT8_CACHE_PATH to the .npz written by a previous "
            "serving/eval run (self-calibration at export time would "
            "bake in whatever ad-hoc data happened to be around)")
    return cache


def _load_validated_qfn(cfg, model, cache: str, device="cuda"):
    """Load the int8 cache onto ``device`` and REFUSE a stale identity:
    there is no data at export time to recalibrate on, and a stale program
    frozen into an artifact outlives every cache."""
    from ..models.quantized import QuantizedEmbed, serving_identity

    qfn = QuantizedEmbed.load(cache, device)
    identity = serving_identity(cfg, model)
    if qfn.extra_meta != identity:
        raise ValueError(
            f"int8 cache {cache} was calibrated for {qfn.extra_meta}, "
            f"current config is {identity}; rebuild the cache before "
            "exporting")
    return qfn


def export_from_config(cfg, output: str, *, batch_size: Optional[int] = None,
                       platforms: Sequence[str] = DEFAULT_PLATFORMS,
                       normalize: bool = True, device="cuda") -> dict:
    """Checkpoint -> embedder artifact: loads ``MODEL.PRETRAIN_PATH`` onto
    ``device``, with ``TPU.INT8_EVAL`` the int8 program of the calibrated
    ``TPU.INT8_CACHE_PATH`` (fixed batch, ``TEST.IMS_PER_BATCH`` by
    default), exports it for ``platforms`` and writes ``output``. Returns
    the meta."""
    from .api import load_inference_model

    cache = _check_int8_cache(cfg) if cfg.TPU.INT8_EVAL else ""
    model = load_inference_model(cfg, device)
    qfn = None
    if cfg.TPU.INT8_EVAL:
        qfn = _load_validated_qfn(cfg, model, cache, device)
        if batch_size is None:
            batch_size = int(cfg.TEST.IMS_PER_BATCH)
    blobs, meta = export_embedder(
        model, cfg, normalize=normalize, batch_size=batch_size,
        platforms=platforms, int8_qfn=qfn)
    save_artifact(output, blobs, meta)
    log.info("wrote %s (%d program bytes, platforms=%s, batch=%s)", output,
             sum(map(len, blobs.values())), meta["platforms"],
             meta["batch_size"] or "symbolic")
    return meta


def export_retriever_from_config(
        cfg, gallery_data: str, output: str, *, k: int = 100,
        batch_size: Optional[int] = None,
        platforms: Sequence[str] = DEFAULT_PLATFORMS,
        normalize: bool = True, device="cuda") -> dict:
    """Checkpoint + ``create_embeddings`` index -> one serving artifact.
    ``gallery_data``: a directory with ``embeddings.npy`` / ``paths.npy``.
    The file holds program, weights, gallery and paths;
    ``inference.server --artifact`` serves it with no checkpoint on
    disk."""
    from pathlib import Path

    from .api import load_inference_model

    cache = _check_int8_cache(cfg) if cfg.TPU.INT8_EVAL else ""
    load_path = Path(gallery_data)
    emb = np.load(load_path / "embeddings.npy", allow_pickle=True)
    paths = np.load(load_path / "paths.npy", allow_pickle=True)
    model = load_inference_model(cfg, device)
    qfn = None
    if cfg.TPU.INT8_EVAL:
        qfn = _load_validated_qfn(cfg, model, cache, device)
    if batch_size is None:
        batch_size = int(cfg.TEST.IMS_PER_BATCH)
    blobs, meta, aux = export_retriever(
        model, cfg, emb, paths, k=k, batch_size=batch_size,
        normalize=normalize, platforms=platforms, int8_qfn=qfn)
    save_artifact(output, blobs, meta, aux=aux)
    log.info(
        "wrote %s (programs %d + gallery %d bytes, platforms=%s, "
        "gallery_size=%d, k=%d)", output, sum(map(len, blobs.values())),
        len(aux), meta["platforms"], meta["gallery_size"], meta["k"])
    return meta
