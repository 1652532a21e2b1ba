#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``centroids_reid_tpu_torch/ops/csrc``, holds
each against its plain PyTorch version at the main paths' shapes, then
drives the port's paths with ResNet-50 (BNNeck, last stride 1, 256x128,
bf16 autocast) and seeded random weights:

* serving through ``RetrievalService``: the bf16 embed against a 100,000 x
  2048 bf16 gallery at k=10 and k=100 (K1, K2, K3), and the int8 PTQ embed
  (K5, K6) against the int8 index of the same gallery (K4, K3) at k=10,
  k=100 and in capacity mode at k=10;
* K2u through its own entry point, ``stream_topk(packed=False)``, in its
  comparison phase;
* evaluation: ONLY_TEST through ``engine.runner.main`` on a synthetic
  Market-1501-layout dataset, in bf16, with ``TPU.INT8_EVAL`` (the
  reference's serving engine: unfused int8 convs, bf16 accumulator) and
  with ``TPU.RERANK`` (k-reciprocal re-ranking), both centroid modes, each
  metric held against the same metric computed on the CPU from the same
  embeddings;
* the offline CLIs: ``inference.create_embeddings`` (with and without
  centroids) and ``inference.get_similar`` at ``--topk`` 10 and 100 (K3),
  and re-ranked (dense, and windowed at r=100), the gallery images as
  queries;
* training (phase 8): CTL training through ``engine.runner.main --mode
  ctl`` on a synthetic train split of Market-1501's size (751 pids, 12,936
  JPEGs), 64 x 4 images a step from the image bank on the card, 2 epochs
  with validation and checkpoints from a torchvision-layout backbone file,
  a resume from ``checkpoint_epoch1``, ONLY_TEST of the best checkpoint,
  one ``--mode base`` epoch (on the split's first 128 pids) with the
  double test; the step's time, rate, memory, idle share, profiler split
  and share of the bf16 peak; one full-width step on the card against the
  CPU. Then ``TPU.NUM_GROUPS 2`` (two groups of 64 x 4 a step): one epoch
  through the runner, the step's time, rate, memory, idle share and
  profiler split, and one step of two groups on the card against the CPU.
  No hand-written kernel runs there;
* online serving (phase 9): the HTTP front built by
  ``inference.server.build_from_args`` over phase 4's gallery written as
  an index (k=100, dynamic batching, warm-up of the buckets 1-64), plain,
  re-ranked (``--rerank_window 100``) and on the int8 gallery re-ranked;
  8-image JPEG ``/search`` requests serially and from 8 client threads,
  each response held against ``query_arrays`` (and the re-ranked ones
  against ``ops.rerank``), ``/healthz``, a 400 and a 429; the fast ingest
  (``TPU.FAST_DECODE``, packed YUV420 unpacked on the card: services at
  k=10 and k=100 and the HTTP front, timed beside RGB); and
  ``rerank_distmat`` at Market-1501's test size (3,368 + 15,913 rows), a
  cut of it held against the CPU;
* evaluation at any gallery scale (phase 10): ``R1mAP`` on Market-1501's
  test split plus 500,000 distractors (1.74e9 cells) switches to the
  streaming evaluator (one launch of each of K7's two modes), held
  against the materialising path, the CPU and, re-ranked in windows of
  100, the stitched-order oracle; K7's two wrappers against their plain
  versions on the cell's features (within rounding) and on them scaled
  to integers (bit for bit), timed beside their bound and cuBLAS's fp32
  GEMM, and the host's positives table at the cell's labels. ONLY_TEST
  (phase 5) also runs windowed re-ranking and ``TEST.VISUALIZE``;
* TransReID's LayerNorm sites (phase 3c): K8 (the residual add,
  LayerNorm and cast in one pass) against its plain version at the two
  site shapes of a 256-image batch, timed beside its bound, its plain
  version and autocast's eager ops; ``extract_embeddings`` over three
  card-resident batches of 256 with the benchmark cell's TransReID
  (``create_model``), K8's launches and fused rows counted, and with its
  Swin-B (384x128), K8's and K9's launches and fused rows and tokens;
* Swin's window attention (phase 3d): K9 against its plain version at
  the four stage shapes of a 256-image batch (shifted blocks), timed
  beside its byte bound, its plain version and the memory-efficient SDPA
  over the gathered windows; ptxas's report for K9 (no spill);
* serving artifacts (phase 11, ``inference/export.py``): the bf16 embedder
  (symbolic batch, programs for the card and the CPU), retrievers of phase
  4's gallery at k=100 (also re-ranked at load, r=100) and k=10, and the
  int8 embedder of the fused engine (K5 and K6 as the operators
  ``torch.ops.crt.*``), each held against the live path it came from, with
  the same kernel launches per call; the HTTP front over ``--artifact``;
* orbax checkpoints of the JAX package (phase 12): the committed fixture
  ``tests/fixtures/orbax_small`` read without jax, orbax, tensorstore or
  zstandard (the system's libzstd through ctypes), every leaf held bit for
  bit against its ``arrays.npz``, its Adam state mapped through
  ``from_jax_opt_state``; the zstd decode and encode rates on 100 MB of
  fp32 at level 1;
* the gallery mesh (phases 13 and 13b, ``parallel/``): phase 4's gallery
  sharded 4 ways (on one card all four shards on cuda:0): ``sharded_topk``
  against ``topk_retrieval``; ``RetrievalService(mesh=)`` at k=10 and
  k=100, fp32 and bf16 (K1 and K3 on every shard), re-ranked at r=100
  (the cross-shard row gather), and with phase 4b's int8 embed (K5, K6);
  ``get_similar`` and the HTTP front with ``TPU.SHARDED_RETRIEVAL`` (one
  card: the reference's fewer-than-two-devices rule); ``R1mAP(mesh=)`` on
  phase 10's cell, plain and re-ranked, against the unsharded evaluator;
* processes over ``torch.distributed`` (phase 14, NCCL at world size 1, the
  one card): ``torchrun --standalone --nproc_per_node 1 -m
  centroids_reid_tpu_torch.engine.runner`` trains ResNet-50 (64 x 4
  images, bf16, ``TPU.NUM_GROUPS 0``) for one epoch on a cut of phase 8's
  split (its first 128 pids; phase 5's first 25 for validation) with
  checkpoints and the double test; in an NCCL group of one, one
  full-width distributed step (its gradients, running statistics and
  metrics all-reduced in one flat buffer) against the plain step from one
  state, bit for bit with cuDNN deterministic, both timed in turns, with
  the flat all-reduce's device time; ``extract_embeddings_sharded``
  against ``extract_embeddings`` bit for bit; the stop collective. No
  hand-written kernel runs there;
* the fashion recipe (phase 15): ``configs/320_resnet50_ibn_a.yml`` with
  the df1 script's overrides (ResNet50-IBN-a, 320x320, 12 x 4 images a
  step, bf16) over a synthetic COCO-layout split it writes (100 train pair
  ids, 50 query / gallery pair ids of 320x320 JPEGs): one CTL epoch through
  ``engine.runner.main`` from a seeded backbone file in the reference
  IBN-a layout, with validation, asynchronous checkpoints and the double
  test; the step's time, rate, memory, profiler split and the IBN layers'
  share with their layout copies; one full-width step of 4 x 4 images on
  the card against the CPU (one mock slot);
  ONLY_TEST with ``MODEL.KEEP_CAMID_CENTROIDS`` True and False against the
  CPU's metrics; bf16 serving over a ``create_embeddings`` index of the
  gallery at k=10 and k=100 (K1, K2, K3) against ``torch.topk`` over the
  exact distances of the same embeddings; and the int8 IBN embed
  (``TPU.INT8_EVAL``'s fold and calibration, then the fused engine: 23 K5
  and 14 K6 launches a call at 80x80, 40x40 and 20x20), held against the
  unfused engine (layer by layer and end to end) and printed beside the
  bf16 embed, each K5 / K6 launch of a call against its plain version,
  timed at 8 and 256 images with K5, K6, the fp64 convs and the
  int8-domain InstanceNorm as device time.

Times the embeds, the requests and the kernels (with each kernel's bound
and, where one PyTorch call computes the same function, that call) with
CUDA events, K3 from CUDA graph replays at every shape the paths launch it
beside ``torch.topk``, K2 beside the k=10 route through K1 + the
hierarchical top-k, and with ``torch.profiler`` a request's device busy
time, the device time of each kernel that K1, K2 and K2u launch, K3's and
K4's per launch in one serve-k100 and one int8-k100 request, and K5's and
K6's device time and launches in one int8 embed call (batch 8 and 256), per
shape with its bound, its tile plan and, beside each K5 shape, the device
time of ``torch._int_mm`` (a GEMM without the epilogue; a yardstick only).
Phase 3b holds K5 and K6 against their plain versions at every shape of an
8-image int8 embed call. Phase 9 times /search (p50 serial, requests/s, p50
and p99 at concurrency 8), the device busy time of a re-ranked request
split into selection and re-rank, the kernels' launches per request, and
the dense re-ranker at Market-1501's size with its peak memory. Phase 11
prints export and load seconds and file bytes, the artifacts' embed rate
(CUDA events) and request and ``/search`` p50 beside the live path's, in
turns, and K5's and K6's host cost a launch through their operators and
through the operators' bodies. Phase 13 prints the sharded request's p50
and device busy time beside the one-device service's and K1's and K3's
launches per sharded request; 13b the sharded evaluation's seconds and
peak memory beside the unsharded run's and phase 10's. Each phase prints
its seconds.
Exits non-zero on any failure; the last line is ``{"ok": true, "device":
{...}}``. Imports no JAX.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

GALLERY_ROWS = 100_000
DIM = 2048
N_IMAGES = 64           # synthetic images embedded into known gallery rows
REQUEST = 8             # images per served request
SEED = 0
SELF_DIST_TOL = 1e-2    # squared distance of an image to its own row
HBM_PEAK_GBS = 3350     # H100 SXM data sheet: 3.35 TB/s
# H100 SXM data sheet, dense: operations per second by type
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12, "fp32": 67e12}
CSRC = "centroids_reid_tpu_torch/ops/csrc/"
# kernel -> (source, the TPU kernel it replaces)
KERNELS = {
    "scores": ("retrieval.cu", "centroids_reid_tpu/ops/retrieval.py:141"),
    "stream_topk": ("retrieval.cu",
                    "centroids_reid_tpu/ops/retrieval.py:360"),
    "stream_topk_unpacked": ("retrieval.cu",
                             "centroids_reid_tpu/ops/retrieval.py:360"),
    "kpass_topk": ("retrieval.cu", "centroids_reid_tpu/ops/retrieval.py:192"),
    "scores_i8": ("retrieval_int8.cu",
                  "centroids_reid_tpu/ops/retrieval_int8.py:106"),
    "matmul_requant": ("int8_conv.cu",
                       "centroids_reid_tpu/ops/int8_conv.py:108"),
    "conv3x3_requant": ("int8_conv.cu",
                        "centroids_reid_tpu/ops/int8_conv.py:182"),
    # K7's two modes: the JAX package's streaming evaluator is plain jnp
    "stream_extract": ("stream_rank.cu", "none"),
    "stream_count": ("stream_rank.cu", "none"),
    # K8: the JAX package has no ViT
    "add_norm": ("add_norm.cu", "none"),
    # K9: the JAX package has no Swin
    "window_attn": ("window_attn.cu", "none"),
}
K7_KERNELS = ("stream_extract", "stream_count")
BF16_KERNELS = ("scores", "stream_topk", "kpass_topk")
# (W, k) of each K3 launch on the paths against the 100,352-row gallery:
# the group minima (100352 / 8 columns) and the gathered 8k columns, at
# k=100 (serve-k100), k=26 (int8 k=10: the margin k + 16) and k=125 (int8
# k=100: k + k / 4)
K3_SHAPES = ((12544, 100), (800, 100), (12544, 26), (208, 26), (12544, 125),
             (1000, 125))
# (rows, W) of each K3 launch of the re-rankers, all at k = k1 + 1 = 21:
# the windowed ranks of 8 and of 32 windows of 101 (a /search request, a
# get_similar chunk), the dense ranks of get_similar (N = 3,600), of
# ONLY_TEST (N = 2,000, and 300 with centroids) and 2,048 of the 19,281
# rows at Market-1501's test size
RERANK_K3_SHAPES = ((808, 101), (3232, 101), (3600, 3600), (2000, 2000),
                    (300, 300), (2048, 19281))
RERANK_K = 21
INT8_KERNELS = ("kpass_topk", "scores_i8", "matmul_requant",
                "conv3x3_requant")


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` with the seconds since the script started."""
    print(f"[{time.perf_counter() - _T0:7.1f} s] {msg}", flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, CUDA events around ``iters``
    back-to-back calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """Mean device time of ``fn()`` in ms with no host in the loop: ``iters``
    calls captured once in a CUDA graph, CUDA events around ``reps`` replays
    (for kernels whose back-to-back calls run at the host's enqueue rate)."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def request_ms(svc, imgs, n: int) -> list:
    """Host-clock ms of ``n`` requests (each ends in a device-to-host
    copy)."""
    lat = []
    for _ in range(n):
        t0 = time.perf_counter()
        svc.query_arrays(imgs)
        lat.append((time.perf_counter() - t0) * 1e3)
    return lat


def device_busy_ms(fn, n: int):
    """Device time per call of ``fn`` in ms (a request, say): torch.
    profiler's kernel and copy time over ``n`` calls (one stream, so
    nothing overlaps). None when the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CUDA
             and not getattr(e, "is_user_annotation", False))
    return us / n / 1e3 if us > 0 else None


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ------------------------------------------------------------------ inputs

def unit_rows(n: int, gen, dtype):
    import torch

    x = torch.randn((n, DIM), generator=gen, device="cuda")
    return (x / x.norm(dim=1, keepdim=True)).to(dtype)


def int_rows(n: int, gen):
    """Small integers in bf16: every dot product is an exact fp32 integer,
    so kernel and plain version must agree bit for bit whatever the
    summation order, and bf16-rounded scores tie often."""
    import torch

    return torch.randint(-2, 3, (n, DIM), generator=gen,
                         device="cuda").to(torch.bfloat16)


def gn_row(g, real: int):
    import torch

    gn = (g.float() * g.float()).sum(dim=1)
    gn[real:] = float("inf")
    return gn[None, :].contiguous()


# ------------------------------------------------------------------ phases

def phase_env() -> None:
    import torch

    from centroids_reid_tpu_torch.data import available_decoder

    log("== phase 1: environment")
    log(f"gpu: {gpu_line()}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(f"image decoder: {available_decoder()}")
    require(torch.cuda.device_count() >= 1, "no CUDA device")


def _kernel_name(mangled: str) -> str:
    """``name<args>`` of a kernel from its mangled symbol (each identifier
    follows its length; integer template arguments read ``L<type><n>E``)."""
    for m in re.finditer(r"(?=(\d+))", mangled):
        end = m.start() + len(m.group(1))
        name = mangled[end:end + int(m.group(1))]
        if name.endswith("_kernel") and name[:1].isalpha():
            tail = mangled[end + len(name):]
            t = re.match(r"I((?:L[a-z]\d+E)+)E", tail)
            args = re.findall(r"L[a-z](\d+)E", t.group(1)) if t else []
            return name + (f"<{', '.join(args)}>" if args else "")
    return mangled


def phase_build() -> None:
    from centroids_reid_tpu_torch.ops import _build

    log("== phase 2: build kernels")
    t0 = time.perf_counter()
    _build.load()
    log(f"kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s)")
    kernel = "?"
    for line in _build.build_log.splitlines():
        named = re.search(r"entry function '(\w+)'", line)
        if named:
            kernel = _kernel_name(named.group(1))
        elif "Used" in line and "registers" in line:
            log(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}")
        elif "spill stores" in line and not line.strip().startswith("0 "):
            log(f"  ptxas {kernel}: {line.strip()}")
        elif "Performance Loss" in line or "serialized" in line:
            log(f"  ptxas {kernel}: {line.strip()}")
    lib = _build.load()
    log("  requant_gemm_kernel<TAPS, BN, BK, STAGES, MINB> (K5 TAPS 1, K6 "
        "TAPS 9): 256 threads, dynamic shared memory at two blocks per SM "
        + ", ".join(f"{lib.crt_requant_smem_bytes(bn, bk)} B at BN = {bn}, "
                    f"BK = {bk}" for bn in (64, 128) for bk in (64, 128)))


def phase_compare() -> dict:
    """Each kernel against its plain version at the main path's shapes.
    Returns the largest error per kernel (random inputs)."""
    import torch

    from centroids_reid_tpu_torch.ops import retrieval as R

    log("== phase 3: kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    gp = -(-GALLERY_ROWS // R._G_TILE) * R._G_TILE   # 100352
    errs = {}

    # K1: exact on integer inputs, fp32 summation-order error on unit rows
    qi, gi = int_rows(128, gen), int_rows(gp, gen)
    gni = gn_row(gi, GALLERY_ROWS)
    got, ref = R.scores(qi, gi, gni), R.scores_plain(qi, gi, gni)
    require(torch.equal(got, ref), "K1 differs on integer inputs")
    q, g = unit_rows(128, gen, torch.bfloat16), unit_rows(gp, gen,
                                                          torch.bfloat16)
    gn = gn_row(g, GALLERY_ROWS)
    got, ref = R.scores(q, g, gn), R.scores_plain(q, g, gn)
    fin = torch.isfinite(ref)
    require(torch.equal(fin, torch.isfinite(got)), "K1 +inf pattern differs")
    errs["scores"] = (got[fin] - ref[fin]).abs().max().item()
    log(f"K1 scores [128, {DIM}] x [{gp}, {DIM}]: integer inputs exact; "
        f"unit rows max |err| {errs['scores']:.3e} (tol 1e-4)")
    require(errs["scores"] <= 1e-4, "K1 error above tolerance")

    # K2: integer inputs exact (heavy bf16 ties); unit rows: share of equal
    # indices, values within one bf16 step
    errs["stream_topk"] = 0.0
    for k in (10, 32):
        v, i = R.stream_topk(qi, gi, gni, k)
        rv, ri = R.stream_topk_plain(qi, gi, gni, k)
        require(torch.equal(i, ri) and torch.equal(v, rv),
                f"K2 k={k} differs on integer inputs")
        v, i = R.stream_topk(q, g, gn, k)
        rv, ri = R.stream_topk_plain(q, g, gn, k)
        share = (i == ri).float().mean().item()
        err = (v - rv).abs().max().item()
        step = (rv.abs().max() * 2.0 ** -7).item()
        errs["stream_topk"] = max(errs["stream_topk"], err)
        log(f"K2 stream_topk k={k}: integer inputs exact; unit rows "
            f"indices equal {share:.4f} (need >= 0.99), max |err| "
            f"{err:.3e} (tol one bf16 step {step:.3e})")
        require(share >= 0.99 and err <= step, f"K2 k={k} disagrees")

    # K3: exact on the group-min shape, and with ties and +inf columns
    w8 = gp // 8
    x = torch.randn((128, w8), generator=gen, device="cuda")
    v, i = R.kpass_topk(x, 100)
    rv, ri = R.kpass_topk_plain(x, 100)
    share = (i == ri).float().mean().item()
    errs["kpass_topk"] = (v - rv).abs().max().item()
    log(f"K3 kpass_topk [128, {w8}] k=100: indices equal {share:.4f}, max "
        f"|err| {errs['kpass_topk']:.3e} (need exact)")
    require(torch.equal(v, rv) and torch.equal(i, ri), "K3 differs")
    t = torch.round(x * 2) / 2                 # ~20 levels: many ties
    t[:, -500:] = float("inf")
    t[0, 50:] = float("inf")                   # fewer than k finite values
    t[1, :] = 3.0                              # a row of one value
    v, i = R.kpass_topk(t, 100)
    rv, ri = R.kpass_topk_plain(t, 100)
    require(torch.equal(v, rv) and torch.equal(i, ri),
            "K3 differs with ties and +inf")
    log("K3 with ties, +inf columns and a row of fewer than k finite "
        "values: values and indices exact")
    t = x.clone()
    t[0, :] = float("nan")                     # all NaN
    t[1, 60:] = float("nan")                   # fewer than k numbers
    t[2, ::3] = float("nan")
    t[3, :] = float("inf")
    t[3, 1::2] = float("nan")
    require(kpass_equal(t, 100), "K3 differs on NaN rows")
    for w, k in K3_SHAPES:
        require(kpass_equal(torch.randn((128, w), generator=gen,
                                        device="cuda"), k),
                f"K3 differs at [128,{w}] k={k}")
    log("K3 with NaN rows (NaNs after +inf, own columns, as torch.sort) "
        "and at every path shape "
        + ", ".join(f"[128,{w}] k={k}" for w, k in K3_SHAPES)
        + ": values and indices exact")
    for rows, w in RERANK_K3_SHAPES:
        for kind, x in (("random", torch.randn((rows, w), generator=gen,
                                               device="cuda")),
                        ("distances", rerank_rows(rows, w, gen))):
            require(kpass_equal(x, RERANK_K),
                    f"K3 differs at [{rows},{w}] k={RERANK_K} ({kind})")
    log("K3 at the re-rankers' shapes "
        + ", ".join(f"[{r},{w}]" for r, w in RERANK_K3_SHAPES)
        + f", k={RERANK_K}, on random rows and on squared distances with "
        "zero self distances and duplicated columns (exact ties): values "
        "and indices exact")
    torch.cuda.synchronize()
    return errs


def rerank_rows(rows: int, w: int, gen):
    """Rows like a re-ranker's: squared euclidean distances of unit rows
    to ``w`` unit rows, every second one a copy of its neighbour (exact
    ties), with each row's own column at 0 (row i's own column is i mod w,
    as in the stacked [C, w, w] windows)."""
    import torch

    cols = unit_rows(w, gen, torch.float32)
    cols[1::2] = cols[0::2][:w // 2]
    own = torch.arange(rows, device="cuda") % w
    q = cols[own] + 0.01 * torch.randn((rows, DIM), generator=gen,
                                       device="cuda")
    q = q / q.norm(dim=1, keepdim=True)
    d = ((q * q).sum(1)[:, None] + (cols * cols).sum(1)[None, :]
         - 2.0 * q @ cols.T).clamp_min(0.0)
    d[torch.arange(rows, device="cuda"), own] = 0.0
    return d


def kpass_equal(x, k: int) -> bool:
    """K3 against its plain version: indices equal, values bit-equal, NaN
    equal to NaN."""
    import torch

    from centroids_reid_tpu_torch.ops import retrieval as R

    v, i = R.kpass_topk(x, k)
    rv, ri = R.kpass_topk_plain(x, k)
    nan = torch.isnan(rv)
    return (torch.equal(i, ri) and torch.equal(torch.isnan(v), nan)
            and torch.equal(v[~nan], rv[~nan]))


def phase_compare_k2u():
    """K2u against its plain version at the serving shape: exact on integer
    inputs at k=10 and k=32; on unit rows near-ties may swap under another
    summation order, so a share of equal indices and a value tolerance.
    K2u has no caller in the system (the reference's dispatch sends every
    k <= 32 request to the packed K2), so its path is its own entry point:
    the first unit-row call, with the counts set to 0 just before it.
    Returns the largest error and the launch counts of that call."""
    import torch

    from centroids_reid_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
        retrieval as R,
    )

    log("== phase 3a: K2u (streaming top-k on exact fp32 scores)")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    gp = -(-GALLERY_ROWS // R._G_TILE) * R._G_TILE   # 100352
    qi, gi = int_rows(128, gen), int_rows(gp, gen)
    gni = gn_row(gi, GALLERY_ROWS)
    q = unit_rows(128, gen, torch.bfloat16)
    g = unit_rows(gp, gen, torch.bfloat16)
    gn = gn_row(g, GALLERY_ROWS)
    err = 0.0
    launches = None
    for k in (10, 32):
        v, i = R.stream_topk(qi, gi, gni, k, packed=False)
        rv, ri = R.stream_topk_plain(qi, gi, gni, k, packed=False)
        require(torch.equal(i, ri) and torch.equal(v, rv),
                f"K2u k={k} differs on integer inputs")
        torch.cuda.synchronize()
        if launches is None:
            reset_launch_counts()
        v, i = R.stream_topk(q, g, gn, k, packed=False)
        if launches is None:
            torch.cuda.synchronize()
            launches = launch_counts()
            log(f"kernel launches through stream_topk(packed=False): "
                f"{launches}")
            require(launches["stream_topk_unpacked"] > 0,
                    "K2u was not launched through its entry point")
        rv, ri = R.stream_topk_plain(q, g, gn, k, packed=False)
        share = (i == ri).float().mean().item()
        e = (v - rv).abs().max().item()
        err = max(err, e)
        log(f"K2u stream_topk(packed=False) k={k} [128, {DIM}] x [{gp}, "
            f"{DIM}]: integer inputs exact; unit rows indices equal "
            f"{share:.4f} (need >= 0.99), max |err| {e:.3e} (tol 1e-4)")
        require(share >= 0.99 and e <= 1e-4, f"K2u k={k} disagrees")
    torch.cuda.synchronize()
    return {"stream_topk_unpacked": err}, launches


def requant_inputs(gen, m: int, k: int, n: int, res_shape=None):
    """int8 operands and an epilogue whose outputs span the int8 range:
    a random int8 dot product of depth k has std ~ 73^2 sqrt(k)."""
    import torch

    x = torch.randint(-127, 128, (m, k), generator=gen, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (k, n), generator=gen, device="cuda",
                      dtype=torch.int8)
    scale = (torch.rand(n, generator=gen, device="cuda") + 0.5) \
        * (40.0 / (73.0 ** 2 * k ** 0.5))
    bias = torch.randn(n, generator=gen, device="cuda") * 10.0
    res = None
    if res_shape is not None:
        res = torch.randint(-127, 128, res_shape, generator=gen,
                            device="cuda", dtype=torch.int8)
    return x, w, scale, bias, res, torch.tensor(0.4, device="cuda")


def embed_requant_shapes(batch: int, name: str = "resnet50",
                         hw: tuple = (64, 32)) -> dict:
    """The K5 / K6 launches of one int8 embed call of ``batch`` images
    through trunk ``name`` (last stride 1), whose layer 1 runs at ``hw``
    (after the stem and the max pool: 64x32 for 256x128 images), from the
    trunk's block plan, in launch order: {(kernel, dims, residual, ReLU):
    launches}; dims (M, K, N) for K5 and (B, H, W, K, N) for K6. The IBN
    conv1s of IBN-a's layers 1-3 run unfused (their InstanceNorm half
    needs its own requantization point)."""
    from centroids_reid_tpu_torch.models.quantized import _block_plan

    out: dict = {}

    def add(*key):
        out[key] = out.get(key, 0) + 1

    (h, w), c = hw, 64
    for _, _, planes, stride, has_ds, use_ibn in _block_plan(name, 1):
        if not use_ibn:
            add("matmul_requant", (batch * h * w, c, planes), False, True)
        if stride == 1:   # stride-2 3x3 convs run unfused
            add("conv3x3_requant", (batch, h, w, planes, planes), False, True)
        h, w = -(-h // stride), -(-w // stride)
        if has_ds:        # a stride-2 downsample after a row slice
            add("matmul_requant", (batch * h * w, c, 4 * planes), False,
                False)
        add("matmul_requant", (batch * h * w, planes, 4 * planes), True, True)
        c = 4 * planes
    return out


def phase_compare_int8() -> dict:
    """K4, K5 and K6 against their plain versions at the int8 path's
    shapes (ResNet-50, 256x128, 8 images per request). Returns the largest
    error per kernel."""
    import torch

    from centroids_reid_tpu_torch.ops import int8_conv as C
    from centroids_reid_tpu_torch.ops import retrieval as R
    from centroids_reid_tpu_torch.ops import retrieval_int8 as R8

    log("== phase 3b: int8 kernels (K4, and K5 and K6 through their "
        "operators torch.ops.crt.*) against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    gp = -(-GALLERY_ROWS // R._G_TILE) * R._G_TILE   # 100352
    errs = {}

    # K4: exact on integer queries (any scale), fp32 order on unit rows
    codes = torch.randint(-127, 128, (gp, DIM), generator=gen, device="cuda",
                          dtype=torch.int8)
    s_row = (torch.rand((1, gp), generator=gen, device="cuda") + 0.5) / 127
    gni = gn_row(codes.float() * s_row[0, :, None], GALLERY_ROWS)
    qi = int_rows(128, gen)
    got = R8.scores_i8(qi, codes, s_row, gni)
    ref = R8.scores_i8_plain(qi, codes, s_row, gni)
    require(torch.equal(got, ref), "K4 differs on integer queries")
    gal = R8.quantize_gallery(unit_rows(gp, gen, torch.float32))
    gn = gal.gn.clone()
    gn[GALLERY_ROWS:] = float("inf")
    q = unit_rows(128, gen, torch.bfloat16)
    got = R8.scores_i8(q, gal.codes, gal.scale[None, :], gn[None, :])
    ref = R8.scores_i8_plain(q, gal.codes, gal.scale[None, :], gn[None, :])
    fin = torch.isfinite(ref)
    require(torch.equal(fin, torch.isfinite(got)), "K4 +inf pattern differs")
    errs["scores_i8"] = (got[fin] - ref[fin]).abs().max().item()
    log(f"K4 scores_i8 [128, {DIM}] x [{gp}, {DIM}] int8: integer queries "
        f"exact; unit rows max |err| {errs['scores_i8']:.3e} (tol 1e-4); "
        f"+inf pad columns equal")
    require(errs["scores_i8"] <= 1e-4, "K4 error above tolerance")

    # K5 and K6 at every shape of one 8-image embed call
    from centroids_reid_tpu_torch.ops import _build

    sms = _build.sm_count(torch.cuda.current_device())
    shapes = embed_requant_shapes(REQUEST)
    counts = {n: sum(c for (name, *_), c in shapes.items() if name == n)
              for n in ("matmul_requant", "conv3x3_requant")}
    require(counts == {"matmul_requant": 36, "conv3x3_requant": 14},
            f"unexpected K5/K6 launches per embed call: {counts}")

    def int_err(got, ref):
        return (got.int() - ref.int()).abs().max().item()

    errs["matmul_requant"] = errs["conv3x3_requant"] = 0
    for (name, dims, with_res, relu), launches in shapes.items():
        if name == "matmul_requant":
            m, k, n = dims
            x, w, scale, bias, res, rs = requant_inputs(
                gen, m, k, n, (m, n) if with_res else None)
            got = C.matmul_requant(x, w, scale, bias, res=res, res_scale=rs,
                                   relu=relu)
            ref = C.matmul_requant_plain(x, w, scale, bias, res=res,
                                         res_scale=rs, relu=relu)
            label, taps = f"K5 matmul_requant [{m},{k}]x[{k},{n}]", 1
        else:
            b, h, wd, k, n = dims
            m = b * h * wd
            x, w, scale, bias, res, rs = requant_inputs(
                gen, m, 9 * k, n, (b, h, wd, n) if with_res else None)
            x = x[:, :k].reshape(b, h, wd, k).contiguous()
            w = w.reshape(3, 3, k, n)
            got = C.conv3x3_requant(x, w, scale, bias, res_nhwc=res,
                                    res_scale=rs, relu=relu)
            ref = C.conv3x3_requant_plain(x, w, scale, bias, res_nhwc=res,
                                          res_scale=rs, relu=relu)
            label, taps = f"K6 conv3x3_requant [{b},{h},{wd},{k}]->{n}", 9
        errs[name] = max(errs[name], int_err(got, ref))
        require(torch.equal(got, ref), f"{label} differs")
        bn, splits = C._requant_plan(m, n, C._stages(k, taps), sms)
        log(f"{label} {'residual' if with_res else 'no residual'}, "
            f"{'ReLU' if relu else 'no ReLU'} ({launches} per embed call; "
            f"{bn}-wide tiles, {splits} K splits): equal "
            f"({(ref != 0).float().mean().item():.3f} nonzero)")
    # stride 2: the layer2 downsample reads every other row and column
    z = torch.randint(-127, 128, (8, 64, 32, 256), generator=gen,
                      device="cuda", dtype=torch.int8)
    zs = z[:, ::2, ::2, :].contiguous().reshape(-1, 256)
    _, w, scale, bias, _, _ = requant_inputs(gen, 1, 256, 512)
    got = C.matmul_requant(zs, w, scale, bias, relu=False)
    ref = C.matmul_requant_plain(zs, w, scale, bias, relu=False)
    errs["matmul_requant"] = max(errs["matmul_requant"], int_err(got, ref))
    require(torch.equal(got, ref), "K5 stride-2 slice differs")
    log("K5 matmul_requant stride-2 slice [8,64,32,256][:, ::2, ::2] -> "
        "[4096,256]x[256,512] no ReLU (layer2 downsample): equal")
    torch.cuda.synchronize()
    return errs


# K8's site shapes at a batch of 256: (rows, width, a bf16 branch added or
# none, y in bf16 or fp32, what they are); TransReID's first (the kernels
# line reads the first), then Swin-B's at 384x128
K8_SHAPES = ((256 * 211, 768, True, True, "[256, 211] tokens"),
             (1024 * 53, 768, True, True, "b2's [1024, 53] groups"),
             (256 * 3072, 128, False, False, "Swin patch norm"),
             (256 * 3072, 128, True, True, "Swin stage-1 blocks"),
             (256 * 768, 256, True, True, "Swin stage-2 blocks"),
             (256 * 768, 512, False, True, "Swin merge 1 (4C)"),
             (256 * 192, 512, True, True, "Swin stage-3 blocks"),
             (256 * 192, 1024, False, True, "Swin merge 2 (4C)"),
             (256 * 48, 1024, True, True, "Swin stage-4 blocks"),
             (256 * 48, 1024, True, False, "Swin norm3"),
             (256 * 48, 2048, False, True, "Swin merge 3 (4C)"))
K8_EMBED_BATCHES = 3   # of TEST.IMS_PER_BATCH (256) images
# the benchmark cells market-transreid-eval's and market-swin-eval's
# configurations: (file, LayerNorm sites a batch, rows of those sites an
# image)
K8_CONFIGS = (("portbench/configs/market-vit-transreid.json", 28,
               25 * 211 + 3 * 4 * 53),   # 25 over the tokens, b2's 3
              ("portbench/configs/market-swin-solider.json", 53,
               # the patch norm, two a block, three merges, norm3
               3072 + 2 * (2 * 3072 + 2 * 768 + 18 * 192 + 2 * 48)
               + 768 + 192 + 48 + 48))


def phase_k8(gpu: str) -> dict:
    """K8 at TransReID's two site shapes ([54,016, 768] and [54,272, 768],
    a bf16 branch, a bf16 output) and Swin-B's nine (widths 128 to 2,048,
    with or without a branch, y bf16 or fp32): held against its plain
    version (the sum bit for bit, y within one bf16 ulp, or 2e-6 in fp32),
    then timed (CUDA events) beside its bound, its plain version and
    autocast's eager add, LayerNorm and cast (``library_ms``). Then the
    main path: each benchmark cell's transformer (TransReID's ViT-B/16 at
    256x128, SIE, JPM; Swin-B at 384x128; bf16 autocast) built by
    ``create_model`` from the cell's configuration, ``extract_embeddings``
    over K8_EMBED_BATCHES card-resident batches: its sites' launches a
    batch, every site's rows fused (``vit.norms_fused`` counted at the
    launch, against ``vit.norms`` at the sites); Swin's 24 K9 launches a
    batch, every real token's window attention fused (``swin.wmsa_fused``
    against ``swin.tokens``). Returns {"errs", "times", "launches"} for
    the kernels line (TransReID's K8 launches, Swin's K9)."""
    import torch
    import torch.nn.functional as F

    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.engine.evaluate import extract_embeddings
    from centroids_reid_tpu_torch.models import create_model
    from centroids_reid_tpu_torch.ops import add_norm as K8
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts
    from centroids_reid_tpu_torch.utils import profiling

    log("== phase 3c: K8 (residual add + LayerNorm + cast)")
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    errs, times = {"add_norm": 0.0}, {}
    for rows, d, branch, y_bf16, what in K8_SHAPES:
        x = 2.0 * randn(rows, d) + randn(rows, 1)
        delta = randn(rows, d).to(bf16) if branch else None
        w, b = 1.0 + 0.1 * randn(d), 0.1 * randn(d)
        ty = bf16 if y_bf16 else torch.float32
        s, y = K8.add_norm(x, delta, w, b, 1e-6, ty)
        ps, py = K8.add_norm_plain(x, delta, w, b, 1e-6, ty)
        require(torch.equal(s, ps), f"K8's sum differs from x + delta at "
                f"{what}")
        # one bf16 ulp at |y|, or 2e-6 near 0, where fp32 rounding of the
        # statistics outweighs the spacing of bf16 values; an fp32 y
        # within 2e-6
        err = (y.float() - py.float()).abs()
        ulp = torch.ldexp(torch.ones_like(err),
                          torch.frexp(py.float().abs())[1] - 8)
        if not y_bf16:
            ulp = torch.zeros_like(ulp)
        ulps = float((err / ulp.clamp_min(2e-6)).max())
        differ = int((err > 0).sum())
        require(ulps <= 1.0, f"K8's y {ulps} bf16 ulps (or 2e-6) from the "
                f"plain version's at {what}")
        errs["add_norm"] = max(errs["add_norm"], float(err.max()))
        log(f"K8 against its plain version at [{rows}, {d}] ({what}): sum "
            f"bit for bit; y max |diff| {float(err.max()):.3e}, at most "
            f"one bf16 ulp (or 2e-6), {differ} of {y.numel()} values "
            f"differ")

        def autocast_chain():
            with torch.autocast("cuda", dtype=bf16):
                s = x if delta is None else x + delta
                return F.layer_norm(s, (d,), w, b, 1e-6).to(ty)

        k_ms, p_ms, lib_ms = time_pair(
            "add_norm", lambda: K8.add_norm(x, delta, w, b, 1e-6, ty),
            lambda: K8.add_norm_plain(x, delta, w, b, 1e-6, ty),
            f"[{rows}, {d}] ({what})", library=autocast_chain)
        # x and delta read, the sum (with a branch) and y written; about 9
        # fp32 operations an element (add, mean, variance, normalise,
        # scale, shift)
        moved = [x, w, b, y] + ([delta, s] if branch else [])
        b_ms, b_by = bound(f"add_norm [{rows}, {d}]", nbytes(*moved),
                           9.0 * x.numel(), "fp32")
        log(f"add_norm [{rows}, {d}] ({what}): {k_ms:.4f} ms, "
            f"{nbytes(*moved) / k_ms / 1e6:.0f} GB/s, "
            f"{b_ms / k_ms:.3f} of its bound {b_ms:.4f} ms; plain "
            f"{p_ms:.4f} ms, autocast's add + LayerNorm + cast {lib_ms:.4f} "
            f"ms [{gpu}]")
        if "add_norm" not in times:
            host = host_us_per_launch(
                lambda: K8.add_norm(x, delta, w, b, 1e-6, ty))
            log(f"add_norm: {host:.1f} us of host time a launch (enqueue, "
                f"50 launches)")
            times["add_norm"] = {"ms": k_ms, "plain_ms": p_ms,
                                 "library_ms": lib_ms, "bound_ms": b_ms,
                                 "bound_by": b_by, "host_us": host}
        del x, delta, s, y, ps, py, err, ulp

    per_batch, k9_launches = [], 0
    for path, sites, rows in K8_CONFIGS:
        with open(path) as f:
            config = json.load(f)
        cfg = get_default_cfg()
        cfg.merge_from_list([str(v) for v in config["opts"]["eval"]])
        cfg.freeze()
        model = create_model(cfg, num_classes=0,
                             generator=torch.Generator().manual_seed(SEED),
                             cameras=int(config["gallery"]["cams"]))
        model = model.cuda().to(memory_format=torch.channels_last).eval()
        size, (h, w) = (int(cfg.TEST.IMS_PER_BATCH),
                        tuple(cfg.INPUT.SIZE_TEST))
        rng = np.random.RandomState(SEED + 20)
        loader = [{"images": torch.randint(0, 256, (size, h, w, 3),
                                           dtype=torch.uint8, device="cuda"),
                   "pids": np.arange(size),
                   "camids": rng.randint(0, 6, size),
                   "valid": np.ones(size, bool)}
                  for _ in range(K8_EMBED_BATCHES)]
        extract_embeddings(model, cfg, loader[:1])   # warm
        reset_launch_counts()
        profiling.reset()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU]):
            emb = extract_embeddings(model, cfg, loader)[0]
        counts = profiling.counts()
        profiling.reset()
        launches = launch_counts()["add_norm"]
        want = K8_EMBED_BATCHES * size * rows
        name = config["name"]
        require(launches == sites * K8_EMBED_BATCHES
                and counts.get("vit.norms") == want
                and counts.get("vit.norms_fused") == want
                and emb.shape == (K8_EMBED_BATCHES * size, model.emb_size)
                and bool(np.isfinite(emb).all()),
                f"extract_embeddings over {K8_EMBED_BATCHES} {name} "
                f"batches: {launches} K8 launches, {counts}, embeddings "
                f"{emb.shape}")
        log(f"extract_embeddings, the {name} cell's model (create_model, "
            f"{h}x{w}, bf16 autocast), {K8_EMBED_BATCHES} batches of "
            f"{size}: {launches} K8 launches "
            f"({launches // K8_EMBED_BATCHES} a batch), vit.norms_fused / "
            f"vit.norms {counts['vit.norms_fused']} / {counts['vit.norms']}")
        per_batch.append(launches // K8_EMBED_BATCHES)
        if "swin.tokens" in counts:
            # every Swin block's window attention on K9, every real token
            k9 = launch_counts()["window_attn"]
            require(k9 == K9_BLOCKS * K8_EMBED_BATCHES
                    and counts.get("swin.wmsa_fused") == counts[
                        "swin.tokens"],
                    f"extract_embeddings over {K8_EMBED_BATCHES} {name} "
                    f"batches: {k9} K9 launches, {counts}")
            share = 100.0 * counts["swin.wmsa_fused"] / counts["swin.tokens"]
            log(f"  {k9} K9 launches ({k9 // K8_EMBED_BATCHES} a batch), "
                f"swin.wmsa_fused / swin.tokens "
                f"{counts['swin.wmsa_fused']} / {counts['swin.tokens']} "
                f"({share:.1f} %)")
            k9_launches = k9 // K8_EMBED_BATCHES
        del model, loader
        torch.cuda.empty_cache()
    # the kernels line: TransReID's K8 launches a batch, Swin's K9
    return {"errs": errs, "times": times,
            "launches": {"add_norm": per_batch[0],
                         "window_attn": k9_launches}}


# K9's shapes at a batch of 256: Swin-B's four stage maps at 384x128 and
# their heads (width 32); its blocks a batch
K9_STAGES = (((96, 32), 4), ((48, 16), 8), ((24, 8), 16), ((12, 4), 32))
K9_BLOCKS = 24
K9_TOL = 2.0 ** -8   # of the largest |v|: P and o rounded to bf16


def _k9_spills() -> None:
    """Log ptxas's report for K9 and require that it spills nothing."""
    from centroids_reid_tpu_torch.ops import _build

    if not _build.build_log:
        log("  K9: the library was built by an earlier process, no ptxas "
            "report here")
        return
    ours, report = False, []
    for line in _build.build_log.splitlines():
        named = re.search(r"entry function '(\w+)'", line)
        if named:
            ours = "window_attn_kernel" in named.group(1)
        elif ours and ("spill" in line or "Used" in line):
            report.append(line.split(":", 1)[-1].strip())
    log(f"  ptxas window_attn_kernel: {'; '.join(report)}")
    require(report and all("0 bytes spill stores, 0 bytes spill loads" in r
                           for r in report if "spill" in r),
            f"K9 spills: {report}")


def phase_k9(gpu: str) -> dict:
    """K9 at Swin-B's four stage shapes at a batch of 256, shifted blocks
    (a bias + shift-mask table per window): held against its plain version
    in fp32 on the same bf16 qkv (within K9_TOL of the largest |v|), then
    timed (CUDA events) beside its byte bound ((3C + C) x 2 bytes a real
    token), its plain version in bf16 and the memory-efficient SDPA over
    the gathered windows with the mask materialised per image, as the path
    before K9 ran it (``library_ms``: the port never calls it). ptxas must
    report no spill in K9. Returns {"errs", "times"} for the kernels line
    (stage 3's times)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from centroids_reid_tpu_torch.models import swin as S
    from centroids_reid_tpu_torch.ops import window_attn as WA

    log("== phase 3d: K9 (Swin window attention)")
    _k9_spills()
    bf16, b = torch.bfloat16, 256
    gen = torch.Generator(device="cuda").manual_seed(SEED + 30)
    errs, times = {"window_attn": 0.0}, {}
    for (h, w), heads in K9_STAGES:
        c = 32 * heads
        qkv = torch.randn(b, h * w, 3 * c, generator=gen,
                          device="cuda").to(bf16)
        bias = (0.5 * torch.randn(3 * c, generator=gen,
                                  device="cuda")).to(bf16)
        msa = S.WindowMSA(c, heads, 7).cuda()
        with torch.no_grad():
            msa.relative_position_bias_table.normal_(0.0, 1.0, generator=gen)
            rel = msa.position_bias()
        g = S.window_geometry(h, w, 7, 3, torch.device("cuda"))
        table = S.window_mask(rel, g.region, 1, torch.float32)
        shape = f"[{b}, {h}x{w}, {heads} heads]"
        o = WA.window_attention(qkv, bias, table, g, heads)
        want = WA.window_attention_plain(qkv.float(), bias.float(), table, g,
                                         heads)
        v = qkv.view(b, h * w, 3, c)[:, :, 2]
        vmax = max(float(v.abs().max()), float(bias[2 * c:].abs().max()))
        err = float((o.float() - want).abs().max())
        require(err <= K9_TOL * vmax and bool(torch.isfinite(o).all()),
                f"K9 at {shape}: max |diff| {err} against the plain "
                f"version, over 2^-8 of max |v| {vmax}")
        errs["window_attn"] = max(errs["window_attn"], err)
        log(f"K9 against its plain version (fp32) at {shape}: max |diff| "
            f"{err:.3e} ({err / vmax:.2e} of max |v|)")
        del want

        # the path before K9: the gathered windows and the per-image mask
        # (made once, not timed), the memory-efficient SDPA alone
        windows = g.order.numel() // 49
        q, k, vv = WA.window_tokens(qkv, bias, g).view(
            b * windows, 49, 3, heads, 32).permute(2, 0, 3, 1, 4)
        mask = S.window_mask(rel, g.region, b, bf16)

        def library():
            with sdpa_kernel([SDPBackend.EFFICIENT_ATTENTION]):
                return F.scaled_dot_product_attention(q, k, vv,
                                                      attn_mask=mask)

        k_ms, p_ms, lib_ms = time_pair(
            "window_attn", lambda: WA.window_attention(qkv, bias, table, g,
                                                       heads),
            lambda: WA.window_attention_plain(qkv, bias, table, g, heads),
            shape, library=library)
        moved = nbytes(qkv, o)
        flops = 4.0 * b * windows * heads * 49 * 49 * 32
        b_ms, b_by = bound(f"window_attn {shape}", moved, flops, "bf16")
        log(f"window_attn {shape}: {k_ms:.4f} ms, "
            f"{moved / k_ms / 1e6:.0f} GB/s, {b_ms / k_ms:.3f} of its bound "
            f"{b_ms:.4f} ms; plain {p_ms:.4f} ms, memory-efficient SDPA "
            f"over the gathered windows {lib_ms:.4f} ms [{gpu}]")
        if heads == 16:
            host = host_us_per_launch(
                lambda: WA.window_attention(qkv, bias, table, g, heads))
            log(f"window_attn: {host:.1f} us of host time a launch "
                f"(enqueue, 50 launches)")
            times["window_attn"] = {"ms": k_ms, "plain_ms": p_ms,
                                    "library_ms": lib_ms, "bound_ms": b_ms,
                                    "bound_by": b_by, "host_us": host}
        del qkv, o, q, k, vv, mask
        torch.cuda.empty_cache()
    return {"errs": errs, "times": times}


RESIDUAL_GAIN = 0.1     # scale of each bottleneck's last BN


def _random_reid_model(cfg, imgs: np.ndarray):
    """Seeded ReidModel whose BN running statistics are calibrated on
    ``imgs`` (one train-mode pass, cumulative averages), as a trained
    model's would be: without it a random deep trunk maps every image to
    nearly the same direction. Each residual branch's last BN scale is
    RESIDUAL_GAIN, as zero-init-residual training starts: with unit gains
    the random 16-block trunk amplifies rounding, so that the bf16 and fp32
    embeddings of one image agree only to cosine ~0.7 and the int8 one is
    unrelated (measured on the CPU at 64x32); at 0.1 they agree to 0.9995
    and 0.98."""
    import torch

    from centroids_reid_tpu_torch.models import create_model

    model = create_model(cfg, generator=torch.Generator().manual_seed(SEED))
    model = model.cuda().to(memory_format=torch.channels_last).train()
    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.reset_running_stats()
            m.momentum = None
        if name.endswith(".bn3"):
            torch.nn.init.constant_(m.weight, RESIDUAL_GAIN)
    x = torch.from_numpy(imgs).cuda().float() / 255.0
    mean = torch.tensor(cfg.INPUT.PIXEL_MEAN, device="cuda")
    std = torch.tensor(cfg.INPUT.PIXEL_STD, device="cuda")
    with torch.no_grad():
        model.bn(model.features(((x - mean) / std).permute(0, 3, 1, 2)))
    return model.eval().cpu()


def _images(n: int, seed: int) -> np.ndarray:
    """Synthetic 256x128 person-crop-sized images: coloured blocks + noise."""
    rng = np.random.RandomState(seed)
    blocks = rng.randint(0, 256, (n, 8, 4, 3)).astype(np.float32)
    img = np.kron(blocks, np.ones((1, 32, 32, 1), np.float32))
    img += rng.normal(0, 12, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def phase_serve(tmp: str) -> dict:
    """The main path: load weights through MODEL.PRETRAIN_PATH, build a
    100k gallery, serve requests at k=10 and k=100. Returns the launch
    counts of the serving run and what the timing phase needs."""
    import torch

    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.data import available_decoder
    from centroids_reid_tpu_torch.inference import (
        RetrievalService,
        load_inference_model,
    )
    from centroids_reid_tpu_torch.inference.service import embed_query
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    log("== phase 4: serve (bf16 path)")
    cfg = get_default_cfg()   # resnet50, last stride 1, 256x128, bf16
    require(cfg.MODEL.NAME == "resnet50" and cfg.USE_MIXED_PRECISION,
            "unexpected default config")
    imgs = _images(N_IMAGES, SEED)
    ckpt = f"{tmp}/reid_resnet50.pth"
    torch.save({"state_dict": _random_reid_model(cfg, imgs).state_dict()},
               ckpt)
    cfg.MODEL.PRETRAIN_PATH = ckpt
    model = load_inference_model(cfg, "cuda")

    with torch.inference_mode():
        emb = np.concatenate([
            embed_query(model, torch.from_numpy(imgs[s:s + REQUEST]).cuda(),
                        cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                        torch.bfloat16, normalize=True).cpu().numpy()
            for s in range(0, N_IMAGES, REQUEST)
        ])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    gallery = unit_rows(GALLERY_ROWS, gen, torch.float32).cpu().numpy()
    rows = np.random.RandomState(SEED).choice(GALLERY_ROWS, N_IMAGES,
                                              replace=False)
    gallery[rows] = emb
    paths = np.array([f"row{i}" for i in range(GALLERY_ROWS)])
    off = emb @ emb.T
    np.fill_diagonal(off, -1)
    log(f"model loaded from {ckpt}; {N_IMAGES} image embeddings, largest "
        f"cosine between two different images {off.max():.4f}")

    decoder = available_decoder()
    blobs = None
    if decoder is not None:
        from PIL import Image

        blobs = []
        for im in imgs:
            buf = io.BytesIO()
            Image.fromarray(im).save(buf, "PNG")
            blobs.append(buf.getvalue())

    services = {k: RetrievalService(cfg, gallery, paths, k=k, device="cuda",
                                    model=model) for k in (10, 100)}
    torch.cuda.synchronize()
    reset_launch_counts()
    for k, svc in services.items():
        worst = 0.0
        n_requests = N_IMAGES // REQUEST // 2
        for r in range(n_requests):
            sl = slice(r * REQUEST, (r + 1) * REQUEST)
            outs = [("query_arrays", svc.query_arrays(imgs[sl]))]
            if blobs is not None:
                outs.append(("query_bytes", svc.query_bytes(blobs[sl])))
            for how, (d, idx, _) in outs:
                require(d.shape == (REQUEST, svc.k) and np.isfinite(d).all(),
                        f"k={k} {how}: bad distances")
                require((idx[:, 0] == rows[sl]).all(),
                        f"k={k} {how}: top-1 is not the image's own row")
                require((np.diff(d, axis=1) >= -1e-6).all(),
                        f"k={k} {how}: distances not sorted")
                worst = max(worst, float(np.abs(d[:, 0]).max()))
        require(worst <= SELF_DIST_TOL, f"k={k}: self distance {worst}")
        log(f"k={k}: {n_requests} requests x {REQUEST} images via query_arrays"
            + (f" and query_bytes (PNG bytes; decoders: {decoder})" if blobs
               else " (no decoder: query_bytes skipped)")
            + f": top-1 is the own row, self distance <= {worst:.2e} "
            f"(tol {SELF_DIST_TOL})")
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"kernel launches while serving the bf16 path: {launches}")
    for name in BF16_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the bf16 path")
    return {"launches": launches, "model": model, "services": services,
            "imgs": imgs, "cfg": cfg, "emb": emb, "gallery": gallery,
            "rows": rows, "paths": paths, "blobs": blobs}


def phase_serve_int8(state: dict) -> dict:
    """The int8 path: fold and calibrate the same model on its 64 images,
    build the int8 embed on the fused kernels, and serve it against the
    int8 index of the same gallery (whose 64 image rows hold the bf16
    path's embeddings) at k=10, k=100 and in capacity mode at k=10."""
    import torch

    from centroids_reid_tpu_torch.inference import RetrievalService
    from centroids_reid_tpu_torch.models.quantized import quantize_reid_model
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    log("== phase 4b: serve (int8 path)")
    cfg, model, imgs = state["cfg"], state["model"], state["imgs"]
    t0 = time.perf_counter()
    qfn = quantize_reid_model(model, [imgs], cfg.INPUT.PIXEL_MEAN,
                              cfg.INPUT.PIXEL_STD, use_pallas=True,
                              acc_dtype=torch.int32)
    torch.cuda.synchronize()
    log(f"folded, calibrated on {len(imgs)} images and quantized in "
        f"{time.perf_counter() - t0:.2f} s: "
        f"{len(qfn.qtree['act_scales'])} activation scales")
    with torch.inference_mode():
        e8 = torch.cat([qfn(imgs[s:s + REQUEST])
                        for s in range(0, N_IMAGES, REQUEST)])
        e8 = (e8 / e8.norm(dim=1, keepdim=True)).cpu().numpy()
    cos = (e8 * state["emb"]).sum(axis=1)
    log(f"int8 vs bf16 embedding cosine over the {N_IMAGES} images: min "
        f"{cos.min():.6f}, mean {cos.mean():.6f}")
    require(np.isfinite(e8).all(), "int8 embeddings not finite")

    cells = {"int8-k10": (10, True), "int8-k100": (100, True),
             "int8-capacity-k10": (10, False)}
    services = {
        name: RetrievalService(cfg, state["gallery"], state["paths"], k=k,
                               device="cuda", model=model, int8_qfn=qfn,
                               use_int8_gallery=True, exact_rescore=exact)
        for name, (k, exact) in cells.items()}
    rows, blobs = state["rows"], state["blobs"]
    torch.cuda.synchronize()
    reset_launch_counts()
    for name, svc in services.items():
        k = svc.k
        worst = 0.0
        n_requests = N_IMAGES // REQUEST // 2
        for r in range(n_requests):
            sl = slice(r * REQUEST, (r + 1) * REQUEST)
            outs = [("query_arrays", svc.query_arrays(imgs[sl]))]
            if blobs is not None:
                outs.append(("query_bytes", svc.query_bytes(blobs[sl])))
            for how, (d, idx, _) in outs:
                require(d.shape == (REQUEST, svc.k) and np.isfinite(d).all(),
                        f"{name} {how}: bad distances")
                require((idx[:, 0] == rows[sl]).all(),
                        f"{name} {how}: top-1 is not the image's own row")
                require((np.diff(d, axis=1) >= -1e-6).all(),
                        f"{name} {how}: distances not sorted")
                worst = max(worst, float(np.abs(d[:, 0]).max()))
        log(f"{name}: {n_requests} requests x {REQUEST} images via "
            f"query_arrays" + (" and query_bytes" if blobs else "")
            + f": top-1 is the own row, self distance <= {worst:.3e}")
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"kernel launches while serving the int8 path: {launches}")
    for name in INT8_KERNELS:
        require(launches[name] > 0,
                f"kernel {name} was not launched on the int8 path")
    return {"launches": launches, "qfn": qfn, "services": services}


EVAL_PIDS = 100          # synthetic Market-1501 cut: 100 identities,
EVAL_QUERIES = 2         # 2 queries and 18 gallery images each, 6 cameras,
EVAL_GALLERY = 18        # 128x64 JPEGs (the dataset's native crop size)
EVAL_CAMS = 6


def _write_market(root: str) -> None:
    """A Market-1501 layout: each identity a seeded pattern of coloured
    blocks; each image that pattern under its own brightness shift and
    pixel noise. Queries sit on two cameras per identity, the gallery on
    all six, the train folder holds one image per identity."""
    import os

    from PIL import Image

    rng = np.random.RandomState(SEED + 7)
    patterns = rng.randint(0, 256, (EVAL_PIDS, 8, 4, 3)).astype(np.float32)
    base = os.path.join(root, "market1501")
    for sub in ("bounding_box_train", "query", "bounding_box_test"):
        os.makedirs(os.path.join(base, sub))

    def write(sub, pid, cam, i):
        img = np.kron(patterns[pid], np.ones((16, 16, 1), np.float32))
        img = img + rng.randint(-30, 31, (1, 1, 3)) + rng.normal(0, 10,
                                                                 img.shape)
        Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
            os.path.join(base, sub,
                         f"{pid + 1:04d}_c{cam + 1}s1_{i:06d}_00.jpg"))

    for pid in range(EVAL_PIDS):
        write("bounding_box_train", pid, pid % EVAL_CAMS, 0)
        for j in range(EVAL_QUERIES):
            write("query", pid, (pid + 3 * j) % EVAL_CAMS, 100 + j)
        for j in range(EVAL_GALLERY):
            write("bounding_box_test", pid, j % EVAL_CAMS, 200 + j)


def _eval_opts(ckpt: str, root: str, logs: str, *extra) -> list:
    return ["DATASETS.NAMES", "market1501", "DATASETS.ROOT_DIR", root,
            "MODEL.PRETRAIN_PATH", ckpt, "TEST.ONLY_TEST", "True",
            "MODEL.USE_CENTROIDS", "True", "REPRODUCIBLE_NUM_RUNS", "1",
            "OUTPUT_DIR", logs, *extra]


VIS_MAX = 10             # TEST.VISUALIZE_MAX_NUMBER: queries 0..10 drawn


def _vis_check(real, compute, captured, runs_dir: str):
    """Wraps ``metrics.visrank.visualize_ranked_results``: after the card's
    strips are written, draws the same strips from the CPU's distance
    matrix (the evaluation just captured, recomputed on the CPU) and holds
    the card's against them: the same files, one per query up to
    ``VIS_MAX``, and the same colour in every top-1 slot's border. Counts
    the strips that are equal pixel for pixel."""
    import os

    from PIL import Image

    def vis(distmat, query, gallery, save_dir, **kw):
        real(distmat, query, gallery, save_dir, **kw)
        cfg, emb, pids, camids, nq, cent, _ = captured[-1]
        _, ev = compute(cfg, emb, pids, camids, nq, cent,
                        return_evaluator=True, streaming=False, device="cpu")
        cpu_dir = os.path.join(runs_dir,
                               "centroids" if cent else "plain")
        real(ev.last_distmat, query, gallery, cpu_dir, **kw)
        names = sorted(os.listdir(save_dir))
        require(names == sorted(os.listdir(cpu_dir))
                and len(names) == min(len(query), VIS_MAX + 1),
                f"visrank: {len(names)} strips for {len(query)} queries")
        w = kw["width"]
        x1 = w + 2 + 8          # the top-1 slot: GRID_SPACING, QUERY_EXTRA
        equal = 0
        for n in names:
            a, b = (np.asarray(Image.open(os.path.join(d, n)))
                    for d in (save_dir, cpu_dir))
            require(a.shape == b.shape and np.array_equal(a[0, x1], b[0, x1])
                    and tuple(a[0, x1]) in ((0, 255, 0), (255, 0, 0)),
                    f"visrank {n}: top-1 border {a[0, x1]} against the "
                    f"CPU's {b[0, x1]}")
            equal += int(np.array_equal(a, b))
        log(f"visrank ({'centroids' if cent else 'plain'}): {len(names)} "
            f"strips of {kw['topk']} in {save_dir}, every top-1 border "
            f"colour equal to the CPU ranking's, {equal} of {len(names)} "
            f"strips equal pixel for pixel")

    return vis


def phase_eval(tmp: str, ckpt: str) -> dict:
    """ONLY_TEST through ``engine.runner.main`` (the configs default:
    ResNet-50, 256x128, bf16), then again with ``TPU.INT8_EVAL True``
    (the reference's serving engine: unfused int8 convs with a bf16
    accumulator, no hand-written kernel), with ``TPU.RERANK True`` (the
    fully re-ranked distances; K3 ranks the rows), with ``TPU.RERANK_WINDOW
    100`` as well (windowed re-ranking on the streaming evaluator; K3 selects
    each window and ranks it) and with ``TEST.VISUALIZE yes`` (the rank
    strips, each top-1 border held against the CPU's ranking). Every metric
    the runner computed on the card is held against the same metric
    computed on the CPU from the same embeddings (captured at
    ``compute_reid_metrics``). Returns the launch counts and timings of the
    runs."""
    import os

    import torch

    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.data import EvalLoader, ImageStore
    from centroids_reid_tpu_torch.data import init_dataset
    from centroids_reid_tpu_torch.engine import evaluate, runner
    from centroids_reid_tpu_torch.metrics import visrank
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    log("== phase 5: evaluation (ONLY_TEST through the runner)")
    root = os.path.join(tmp, "eval_data")
    t0 = time.perf_counter()
    _write_market(root)
    log(f"synthetic Market-1501 layout: {EVAL_PIDS} pids, {EVAL_CAMS} "
        f"cameras, {EVAL_PIDS * EVAL_QUERIES} queries, "
        f"{EVAL_PIDS * EVAL_GALLERY} gallery images, 128x64 JPEGs resized "
        f"to 256x128 (cut from Market-1501's 19,281 test images: 3,368 "
        f"queries and 15,913 gallery images of 750 pids), written in "
        f"{time.perf_counter() - t0:.1f} s")

    captured = []
    compute = evaluate.compute_reid_metrics

    def capture(cfg, emb, pids, camids, nq, use_centroids, **kw):
        out = compute(cfg, emb, pids, camids, nq, use_centroids, **kw)
        m = out[0] if kw.get("return_evaluator") else out
        captured.append((cfg, emb, pids, camids, nq, use_centroids, m))
        return out

    evaluate.compute_reid_metrics = capture
    draw = visrank.visualize_ranked_results
    visrank.visualize_ranked_results = _vis_check(
        draw, compute, captured, os.path.join(tmp, "vis_cpu"))
    runs = {}
    try:
        for name, extra in (("bf16", ()),
                            ("int8", ("TPU.INT8_EVAL", "True")),
                            ("rerank", ("TPU.RERANK", "True")),
                            ("rerank-window", ("TPU.RERANK", "True",
                                               "TPU.RERANK_WINDOW", "100")),
                            ("visualize", ("TEST.VISUALIZE", "yes",
                                           "TEST.VISUALIZE_MAX_NUMBER",
                                           str(VIS_MAX)))):
            captured.clear()
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            out = runner.main(_eval_opts(
                ckpt, root, os.path.join(tmp, f"logs_{name}"), *extra))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches = launch_counts()
            require(len(captured) == 2, f"{name}: expected two evaluations")
            for cfg, emb, pids, camids, nq, cent, m in captured:
                require(emb.shape == (EVAL_PIDS * (EVAL_QUERIES
                                                   + EVAL_GALLERY), DIM)
                        and np.isfinite(emb).all(),
                        f"{name}: bad embeddings {emb.shape}")
                ref = compute(cfg, emb, pids, camids, nq, cent, device="cpu")
                tag = "centroids" if cent else "plain"
                require(np.array_equal(m.all_topk, ref.all_topk)
                        and np.array_equal(m.cmc, ref.cmc)
                        and abs(m.mAP - ref.mAP) <= 1e-6,
                        f"{name} {tag}: card metrics differ from the CPU's")
                require(out[f"test_{tag}_mAP"] == m.mAP,
                        f"{name} {tag}: runner output is not the metric")
                log(f"{name} eval, {tag}: mAP {m.mAP:.6f}, R1 "
                    f"{m.all_topk[0]:.6f}, R5 {m.all_topk[1]:.6f} (CPU "
                    f"recompute from the same embeddings: mAP "
                    f"{ref.mAP:.6f}, CMC and top-k equal)")
            log(f"{name} ONLY_TEST: {secs:.2f} s for both centroid modes "
                f"(host clock: decode, model load"
                + (", calibration" if name == "int8" else "")
                + (", re-ranking" if name.startswith("rerank") else "")
                + (", the card's and the CPU's strips" if name == "visualize"
                   else "") + f", two evaluations); kernel launches: "
                f"{launches}")
            runs[name] = {"launches": launches, "seconds": secs,
                          "metrics": out}
    finally:
        evaluate.compute_reid_metrics = compute
        visrank.visualize_ranked_results = draw
    require(runs["rerank-window"]["launches"]["kpass_topk"] > 0,
            "windowed re-ranked evaluation launched no K3")

    # extraction rate of the eval loader + bf16 embed, warm image cache
    cfg = get_default_cfg()
    cfg.merge_from_list(_eval_opts(ckpt, root, os.path.join(tmp, "x")))
    dataset = init_dataset("market1501", cfg)
    model = runner.load_model_for_test(cfg)
    store = ImageStore(tuple(cfg.INPUT.SIZE_TEST), True)
    rates = []
    for _ in range(3):   # cold (decode), then two warm passes
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        emb, _, _ = evaluate.extract_embeddings(
            model, cfg, EvalLoader(dataset.val, cfg, store=store))
        rates.append(len(emb) / (time.perf_counter() - t0))
    log(f"extraction, {len(emb)} images, batch {cfg.TEST.IMS_PER_BATCH}, "
        f"bf16 (host clock, loader + embed + copy to host): "
        f"{rates[0]:.1f} embeddings/s with decode, {rates[1]:.1f} / "
        f"{rates[2]:.1f} from the warm image cache")
    return {"runs": runs, "rates": rates, "root": root}


def phase_cli(tmp: str, ckpt: str, root: str) -> dict:
    """``create_embeddings`` over a subfolder copy of the gallery (one
    folder per pid) with and without centroids, then ``get_similar`` with
    the gallery images as queries against the non-centroid index at
    ``--topk`` 10 and 100, and at 100 re-ranked (``TPU.RERANK``, dense and
    with ``TPU.RERANK_WINDOW 100``): each query's top-1 is its own row.
    Returns the launch counts of the ``get_similar`` runs."""
    import os
    import shutil

    import torch

    from centroids_reid_tpu_torch.inference import (
        create_embeddings,
        get_similar,
    )
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    log("== phase 6: offline CLIs")
    gallery = os.path.join(root, "market1501", "bounding_box_test")
    sub = os.path.join(tmp, "gallery_by_pid")
    names = sorted(os.listdir(gallery))
    for name in names:
        os.makedirs(os.path.join(sub, name[:4]), exist_ok=True)
        shutil.copy(os.path.join(gallery, name), os.path.join(sub, name[:4]))
    common = ["MODEL.PRETRAIN_PATH", ckpt, "DATASETS.ROOT_DIR"]
    index = {}
    for cent in (False, True):
        out = os.path.join(tmp, f"index_{'centroids' if cent else 'flat'}")
        t0 = time.perf_counter()
        emb, paths = create_embeddings.main([
            "--images-in-subfolders", *common, sub,
            "MODEL.USE_CENTROIDS", str(cent), "OUTPUT_DIR", out])
        n = EVAL_PIDS if cent else len(names)
        require(emb.shape == (n, DIM) and np.isfinite(emb).all()
                and len(paths) == n, f"create_embeddings {cent}: bad index")
        log(f"create_embeddings, centroids {cent}: {emb.shape[0]} x "
            f"{emb.shape[1]} in {time.perf_counter() - t0:.2f} s")
        index[cent] = out
    torch.cuda.synchronize()
    reset_launch_counts()
    for topk in (10, 100):
        t0 = time.perf_counter()
        res = get_similar.main([
            "--gallery_data", index[False], "--topk", str(topk),
            "--normalize_features", *common, gallery,
            "OUTPUT_DIR", os.path.join(tmp, f"similar_{topk}")])
        secs = time.perf_counter() - t0
        worst = 0.0
        require(len(res) == len(names), "get_similar: one result per query")
        for qp, r in res.items():
            require(len(r["indices"]) == min(topk, len(names))
                    and np.isfinite(r["distances"]).all()
                    and (np.diff(r["distances"]) >= -1e-6).all(),
                    f"get_similar topk={topk}: bad result for {qp}")
            require(os.path.basename(r["paths"][0]) == os.path.basename(qp),
                    f"get_similar topk={topk}: top-1 of {qp} is "
                    f"{r['paths'][0]}")
            worst = max(worst, float(abs(r["distances"][0])))
        require(worst <= SELF_DIST_TOL,
                f"get_similar topk={topk}: self distance {worst}")
        log(f"get_similar --topk {topk}, {len(res)} queries: every top-1 "
            f"is its own row, self distance <= {worst:.2e} (tol "
            f"{SELF_DIST_TOL}); {secs:.2f} s")
    for tag, opts in (("dense", ("TPU.RERANK", "True")),
                      ("windowed", ("TPU.RERANK", "True",
                                    "TPU.RERANK_WINDOW", "100"))):
        t0 = time.perf_counter()
        res = get_similar.main([
            "--gallery_data", index[False], "--topk", "100",
            "--normalize_features", *common, gallery, *opts,
            "OUTPUT_DIR", os.path.join(tmp, f"similar_rerank_{tag}")])
        secs = time.perf_counter() - t0
        worst = 0.0
        require(len(res) == len(names), "get_similar: one result per query")
        for qp, r in res.items():
            require(len(r["indices"]) == 100
                    and np.isfinite(r["distances"]).all()
                    and (np.diff(r["distances"]) >= 0).all(),
                    f"get_similar re-ranked {tag}: bad result for {qp}")
            require(os.path.basename(r["paths"][0]) == os.path.basename(qp),
                    f"get_similar re-ranked {tag}: top-1 of {qp} is "
                    f"{r['paths'][0]}")
            worst = max(worst, float(r["distances"][0]))
        log(f"get_similar --topk 100 TPU.RERANK True"
            + (" TPU.RERANK_WINDOW 100" if tag == "windowed" else
               f" (dense, N = {2 * len(names)})")
            + f", {len(res)} queries: every top-1 is its own row (re-rank "
            f"score <= {worst:.3e}); {secs:.2f} s")
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"kernel launches while running get_similar: {launches}")
    require(launches["kpass_topk"] > 0,
            "kernel kpass_topk was not launched by get_similar")
    return launches


def time_requests(name: str, svc, imgs) -> None:
    """Request p50 (host clock) and device busy time per request, as
    described in the log line."""
    request_ms(svc, imgs, 5)
    # unprofiled, profiled, unprofiled: the busy time and the latency it
    # is divided by come from the same run
    before = request_ms(svc, imgs, 30)
    busy = device_busy_ms(lambda: svc.query_arrays(imgs), 10)
    after = request_ms(svc, imgs, 30)
    p50 = np.percentile(before + after, 50)
    log(f"request of {REQUEST} images, {name} (host clock, 2 x 30 runs): "
        f"p50 {p50:.4f} ms (windows {np.percentile(before, 50):.4f} / "
        f"{np.percentile(after, 50):.4f}), p90 "
        f"{np.percentile(before + after, 90):.4f} ms")
    log(f"  device busy per request (torch.profiler, 10 requests "
        f"between the windows): "
        + (f"{busy:.4f} ms; idle share 1 - busy / p50 = "
           f"{1 - busy / p50:.4f}" if busy is not None
           else "not measured (the profiler saw no device time)"))


def time_pair(name: str, kern, plain, shape: str, library=None,
              timer=cuda_ms):
    """(kernel ms, plain ms, library ms or None), kernel and plain each the
    mean of two runs of ``timer`` taken plain, kernel, kernel, plain (one
    card, one call, in turns); the library call timed twice after them."""
    p1, k1, k2, p2 = timer(plain), timer(kern), timer(kern), timer(plain)
    lib = None
    if library is not None:
        lib = (timer(library) + timer(library)) / 2
    how = "CUDA graph replay, " if timer is graph_ms else ""
    log(f"{name} {shape}: {how}kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.4f}/{p2:.4f} ms"
        + (f", library call {lib:.4f} ms" if lib is not None else ""))
    return (k1 + k2) / 2, (p1 + p2) / 2, lib


def host_us_per_launch(fn, n: int = 50) -> float:
    """Host-clock microseconds to enqueue one call of ``fn`` (no
    synchronize inside the window): the wrapper's own cost per launch."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


# kernel -> the prefix of the names its launches carry in a torch.profiler
# trace (one instantiation per tile width: requant_gemm_kernel<TAPS, BN>);
# each wrapper call launches one kernel
PROFILED = {"matmul_requant": "requant_gemm_kernel<1,",
            "conv3x3_requant": "requant_gemm_kernel<9,"}


def kernel_device_us(fn, calls: int = 1, complete=None) -> tuple:
    """``calls`` calls of ``fn``, after a warm-up call, under
    torch.profiler: ({kernel name: (device us, launches)} over everything
    they ran on the device, the launch counters of those calls). The
    profiler can drop kernel events: a trace for which ``complete(per,
    counts)`` is false is taken again, up to three in all."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if (e.device_type != DeviceType.CUDA
                    or e.self_device_time_total <= 0
                    or getattr(e, "is_user_annotation", False)):
                continue
            m = re.search(r"(\w+_kernel)(<[^>(]*>)?", e.key)
            name = m.group(1) + (m.group(2) or "") if m else e.key[:40]
            us, n = out.get(name, (0.0, 0))
            out[name] = (us + e.self_device_time_total, n + e.count)
        counts = launch_counts()
        if complete is None or complete(out, counts) or attempt == 2:
            break
        log("  a trace lost kernel events; tracing again")
    return out, counts


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(name: str, moved: int, ops: float, kind: str):
    """(bound ms, "bytes" or "operations"): the larger of the bytes moved
    (each input read once, each output written once) over 3.35 TB/s and
    the operations over the H100 SXM's dense peak for their type."""
    by_bytes = moved / (HBM_PEAK_GBS * 1e9) * 1e3
    by_ops = ops / PEAK_OPS[kind] * 1e3
    b = (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
    log(f"{name} bound: {moved} bytes -> {by_bytes:.5f} ms, {ops:.4g} {kind} "
        f"operations -> {by_ops:.5f} ms; bound by {b[1]}")
    return b


def phase_timing(state: dict, int8_state: dict) -> dict:
    """Embeddings/s, request p50 per cell, and per kernel (kernel ms, plain
    ms, library ms, bound ms, bound by), returned for the kernels line."""
    import torch

    from centroids_reid_tpu_torch.inference.service import embed_query
    from centroids_reid_tpu_torch.ops import int8_conv as C
    from centroids_reid_tpu_torch.ops import retrieval as R
    from centroids_reid_tpu_torch.ops import retrieval_int8 as R8

    log("== phase 7: timings (CUDA events unless stated)")
    cfg, model = state["cfg"], state["model"]
    x = torch.from_numpy(_images(256, SEED + 2)).cuda()

    def embed():
        with torch.inference_mode():
            embed_query(model, x, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                        torch.bfloat16, normalize=True)

    ms = cuda_ms(embed, iters=10)
    log(f"embed ResNet-50 256x128 bf16, batch 256: {ms:.3f} ms/batch = "
        f"{256 / ms * 1e3:.1f} embeddings/s")
    qfn = int8_state["qfn"]
    ms8 = cuda_ms(lambda: qfn(x), iters=10)
    log(f"embed ResNet-50 256x128 int8 (K5/K6 + fp64 stem and stride-2 3x3 "
        f"convs), batch 256: {ms8:.3f} ms/batch = {256 / ms8 * 1e3:.1f} "
        f"embeddings/s (bf16: {256 / ms * 1e3:.1f})")
    for batch in (REQUEST, 256):
        def complete(per, counts):
            return all(sum(n for k, (_, n) in per.items() if k.startswith(tag))
                       == counts[name] for name, tag in PROFILED.items())

        with torch.inference_mode():
            per, counts = kernel_device_us(lambda: qfn(x[:batch]),
                                           complete=complete)
        parts = []
        for name, tag in PROFILED.items():
            mine = [v for k, v in per.items() if k.startswith(tag)]
            us, traced = sum(u for u, _ in mine), sum(n for _, n in mine)
            require(traced == counts[name] > 0,
                    f"{name}: {traced} launches traced, {counts[name]} "
                    f"counted in one int8 embed call")
            parts.append(f"{name} {us:.1f} us in {traced} launches "
                         f"({us / traced:.2f} us each)")
        log(f"int8 embed call, batch {batch}, device time (torch.profiler): "
            f"{sum(us for us, _ in per.values()):.1f} us in all; "
            + "; ".join(parts))

    imgs = state["imgs"][:REQUEST]
    for k, svc in state["services"].items():
        time_requests(f"k={k}", svc, imgs)
    for name, svc in int8_state["services"].items():
        time_requests(name, svc, imgs)

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    gp = -(-GALLERY_ROWS // R._G_TILE) * R._G_TILE
    q, g = unit_rows(128, gen, torch.bfloat16), unit_rows(gp, gen,
                                                          torch.bfloat16)
    gn = gn_row(g, GALLERY_ROWS)
    q32, g32 = q.float(), g.float()
    x3 = torch.randn((128, gp // 8), generator=gen, device="cuda")
    gal = R8.quantize_gallery(g.float())
    s8, gn8 = gal.scale[None, :], gn
    x5, w5, sc5, b5, r5, rs5 = requant_inputs(gen, 16384, 64, 256,
                                              (16384, 256))
    x6, w6, sc6, b6, _, _ = requant_inputs(gen, 8 * 64 * 32, 9 * 64, 64)
    x6 = x6[:, :64].reshape(8, 64, 32, 64).contiguous()
    w6 = w6.reshape(3, 3, 64, 64)
    # packed once, as the embed packs each weight once
    p5, p6 = C.pack_weight(w5), C.pack_weight(w6)
    full = "[128,2048]x[100352,2048]"
    # name -> (kernel, plain, shape, library call or None, bytes moved,
    #          operations, operation type)
    score_out = torch.empty((128, gp), device="cuda")
    topk_out = (torch.empty((128, 10), device="cuda"),
                torch.empty((128, 10), dtype=torch.int64, device="cuda"))
    mm_ops = 2.0 * 128 * gp * DIM

    # K1's function in one PyTorch call: bf16 operands, fp32 accumulation
    # and output; where this torch refuses it, one fp32 addmm on fp32
    # copies (TF32 off)
    def addmm_bf16():
        return torch.addmm(gn, q, g.T, alpha=-2.0, out_dtype=torch.float32)

    try:
        diff = (addmm_bf16() - R.scores_plain(q, g, gn))[:, :GALLERY_ROWS]
        log(f"K1 library call torch.addmm(gn, q, g.T, alpha=-2.0, "
            f"out_dtype=torch.float32) on bf16 operands: max |diff| to the "
            f"plain version {diff.abs().max().item():.3e}")
        k1_library = addmm_bf16
    except (RuntimeError, TypeError) as e:
        log(f"K1 library call: addmm(out_dtype=float32) refused ({e}); "
            f"timing one fp32 addmm on fp32 copies instead")

        def k1_library():
            return torch.addmm(gn, q32, g32.T, alpha=-2.0)

    cases = {
        "scores": (lambda: R.scores(q, g, gn),
                   lambda: R.scores_plain(q, g, gn), full, k1_library,
                   nbytes(q, g, gn, score_out), mm_ops, "bf16"),
        "stream_topk": (lambda: R.stream_topk(q, g, gn, 10),
                        lambda: R.stream_topk_plain(q, g, gn, 10),
                        "k=10 over " + full, None,
                        nbytes(q, g, gn, *topk_out), mm_ops, "bf16"),
        "stream_topk_unpacked": (
            lambda: R.stream_topk(q, g, gn, 10, packed=False),
            lambda: R.stream_topk_plain(q, g, gn, 10, packed=False),
            "k=10 over " + full, None, nbytes(q, g, gn, *topk_out), mm_ops,
            "bf16"),
        "kpass_topk": (lambda: R.kpass_topk(x3, 100),
                       lambda: R.kpass_topk_plain(x3, 100),
                       "[128,12544] k=100",
                       lambda: torch.topk(x3, 100, dim=1, largest=False),
                       nbytes(x3) + 128 * 100 * (4 + 8), 128.0 * (gp // 8),
                       "fp32"),
        "scores_i8": (lambda: R8.scores_i8(q, gal.codes, s8, gn8),
                      lambda: R8.scores_i8_plain(q, gal.codes, s8, gn8),
                      full + " int8", None,
                      nbytes(q, gal.codes, s8, gn8, score_out), mm_ops,
                      "bf16"),
        "matmul_requant": (
            lambda: C.matmul_requant(x5, w5, sc5, b5, res=r5, res_scale=rs5,
                                     w_packed=p5),
            lambda: C.matmul_requant_plain(x5, w5, sc5, b5, res=r5,
                                           res_scale=rs5),
            "[16384,64]x[64,256] residual+ReLU", None,
            # r5 twice: the residual read and the int8 output written
            nbytes(x5, w5, sc5, b5, r5, rs5, r5), 2.0 * 16384 * 64 * 256,
            "int8"),
        "conv3x3_requant": (
            lambda: C.conv3x3_requant(x6, w6, sc6, b6, w_packed=p6),
            lambda: C.conv3x3_requant_plain(x6, w6, sc6, b6),
            "[8,64,32,64] -> 64 channels, ReLU", None,
            # x6 twice: the input read and the same-shape output written
            nbytes(x6, w6, sc6, b6, x6), 2.0 * 16384 * 9 * 64 * 64, "int8"),
    }
    times = {}
    for name, (kern, plain, shape, lib, moved, ops, kind) in cases.items():
        # K3's back-to-back calls run at the wrapper's enqueue rate: time it
        # (and its plain version and library call) from CUDA graph replays
        k_ms, p_ms, lib_ms = time_pair(
            name, kern, plain, shape, lib,
            graph_ms if name == "kpass_topk" else cuda_ms)
        b_ms, b_by = bound(name, moved, ops, kind)
        times[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        log(f"{name}: {moved / k_ms / 1e6:.1f} GB/s moved, "
            f"{b_ms / k_ms:.3f} of its bound"
            + (f"; {k_ms / lib_ms:.3f} of its library call's time"
               if lib_ms else ""))

    # K2's yardstick: the k=10 selection through K1 + the hierarchical
    # top-k (two K3 launches), in turns with K2 on the same inputs
    def route():
        return R._hier_topk_build(R.scores(q, g, gn), 10)

    k2_a, r_a, r_b, k2_b = (cuda_ms(cases["stream_topk"][0]), cuda_ms(route),
                            cuda_ms(route), cuda_ms(cases["stream_topk"][0]))
    k2_ms, route_ms = (k2_a + k2_b) / 2, (r_a + r_b) / 2
    log(f"k=10 over {full}: K2 {k2_a:.4f}/{k2_b:.4f} ms, K1 + hierarchical "
        f"top-k {r_a:.4f}/{r_b:.4f} ms; K2 takes {k2_ms / route_ms:.3f} of "
        f"the route's time")
    for name in ("scores", "stream_topk", "stream_topk_unpacked"):
        per, _ = kernel_device_us(cases[name][0])
        log(f"{name}, one call under torch.profiler: "
            + ", ".join(f"{kname} {us:.1f} us"
                        for kname, (us, _) in per.items()))
    phase_timing_k3(gen)
    phase_timing_requests(state, int8_state)
    for batch in (REQUEST, 256):
        phase_timing_requant(int8_state["qfn"], x[:batch])
    # the wrappers' host cost per launch at the timed K5/K6 shapes
    for name, fn in (("matmul_requant", cases["matmul_requant"][0]),
                     ("conv3x3_requant", cases["conv3x3_requant"][0])):
        log(f"{name}: host {host_us_per_launch(fn):.2f} us per launch "
            f"(enqueue, host clock, 50 calls) against "
            f"{times[name]['ms'] * 1e3:.2f} us of CUDA-event time")
    return times


def device_us_per_call(fn, calls: int = 20) -> float:
    """torch.profiler's device time of ``fn`` per call, in us: the kernels
    alone, without the host's enqueue gaps between calls. A trace that
    holds no device time is taken again, up to three times in all; after
    three empty traces (the profiler on the card sometimes loses every
    event of a session) the time comes from CUDA events around back-to-back
    calls instead, which counts the enqueue gaps too, and a line says so."""
    for _ in range(3):
        per, _ = kernel_device_us(fn, calls)
        us = sum(us for us, _ in per.values())
        if us > 0:
            return us / calls
    us = cuda_ms(fn, calls) * 1e3
    log(f"  (torch.profiler saw no device time in three traces: "
        f"{us:.2f} us a call from CUDA events instead)")
    return us


def phase_timing_k3(gen) -> None:
    """K3 at every (W, k) the paths launch, beside torch.topk(largest=
    False) on the same rows: CUDA graph replays (device time with launch
    gaps, no host), torch.profiler's device time per call, CUDA events over
    20 back-to-back calls (at these shapes the host's enqueue rate) and the
    host's enqueue time per call, with the bound at each shape."""
    import torch

    from centroids_reid_tpu_torch.ops import retrieval as R

    for w, k in K3_SHAPES:
        xs = torch.randn((128, w), generator=gen, device="cuda")

        def kern(xs=xs, k=k):
            return R.kpass_topk(xs, k)

        def plain(xs=xs, k=k):
            return R.kpass_topk_plain(xs, k)

        def lib(xs=xs, k=k):
            return torch.topk(xs, k, dim=1, largest=False)

        shape = f"[128,{w}] k={k}"
        k_ms, _, l_ms = time_pair("kpass_topk", kern, plain, shape, lib,
                                  graph_ms)
        k_paced, l_paced = cuda_ms(kern), cuda_ms(lib)
        kd, ld = device_us_per_call(kern), device_us_per_call(lib)
        b_ms, _ = bound(f"kpass_topk {shape}", nbytes(xs) + 128 * k * 12,
                        128.0 * w, "fp32")
        log(f"kpass_topk {shape}: K3 takes {k_ms / l_ms:.3f} of torch.topk's "
            f"time (graph replay), {b_ms / k_ms:.3f} of its bound; device "
            f"time per call (torch.profiler, 20 calls) {kd:.2f} us, "
            f"torch.topk {ld:.2f} us ({kd / ld:.3f}); back-to-back calls "
            f"(CUDA events, host-paced) {k_paced:.4f} ms, torch.topk "
            f"{l_paced:.4f} ms; host {host_us_per_launch(kern):.2f} us per "
            f"K3 launch, {host_us_per_launch(lib):.2f} per torch.topk")
    for rows, w in RERANK_K3_SHAPES:
        xs = rerank_rows(rows, w, gen)
        shape = f"[{rows},{w}] k={RERANK_K}"
        k_ms, p_ms, l_ms = time_pair(
            "kpass_topk", lambda xs=xs: R.kpass_topk(xs, RERANK_K),
            lambda xs=xs: R.kpass_topk_plain(xs, RERANK_K), shape,
            lambda xs=xs: torch.topk(xs, RERANK_K, dim=1, largest=False),
            graph_ms)
        b_ms, _ = bound(f"kpass_topk {shape}",
                        nbytes(xs) + rows * RERANK_K * 12, float(rows * w),
                        "fp32")
        log(f"kpass_topk {shape} (re-ranker): K3 {k_ms:.4f} ms, plain "
            f"(stable sort) {p_ms:.4f} ms, torch.topk {l_ms:.4f} ms (graph "
            f"replay); {b_ms / k_ms:.3f} of its bound")


# kernel name in a trace -> its wrapper's launch counter (one each a call)
REQUEST_KERNELS = (("scores_kernel", "scores"),
                   ("scores_i8_kernel", "scores_i8"),
                   ("kpass_topk_kernel", "kpass_topk"))


def phase_timing_requests(state: dict, int8_state: dict) -> None:
    """The device time of each hand-written kernel of one serve-k100 and
    one int8-k100 request (torch.profiler), per launch."""
    imgs = state["imgs"][:REQUEST]
    for name, svc in (("serve-k100", state["services"][100]),
                      ("int8-k100", int8_state["services"]["int8-k100"])):
        per, counts = kernel_device_us(
            lambda svc=svc: svc.query_arrays(imgs),
            complete=lambda per, counts: all(
                per.get(k, (0.0, 0))[1] == counts[c]
                for k, c in REQUEST_KERNELS))
        total = sum(us for us, _ in per.values())
        parts = []
        for kname, counter in REQUEST_KERNELS:
            us, n = per.get(kname, (0.0, 0))
            require(n == counts[counter],
                    f"{name}: {n} {kname} launches traced, "
                    f"{counts[counter]} counted")
            if n:
                parts.append(f"{kname} {us:.1f} us in {n} launches "
                             f"({us / n:.2f} us each)")
        log(f"{name}, one request under torch.profiler: {total:.1f} us of "
            f"device time; " + "; ".join(parts))


def phase_timing_requant(qfn, x) -> None:
    """K5's and K6's device time and bound per shape over one int8 embed
    call of ``len(x)`` images: the wrappers are wrapped to record each
    launch's shapes, and the profiler's kernel events, in launch order,
    give each launch its device time. Beside each K5 shape, the device
    time of ``torch._int_mm`` on int8 operands of that shape: a GEMM with
    an int32 output and no epilogue, so not the same function, and called
    nowhere in the port; a yardstick for K5's product only."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from centroids_reid_tpu_torch.ops import _build
    from centroids_reid_tpu_torch.ops import int8_conv as C

    mm, conv = C.matmul_requant, C.conv3x3_requant
    sms = _build.sm_count(torch.cuda.current_device())
    shapes = []

    def rec_mm(x, w, scale, bias, res=None, res_scale=None, relu=True,
               w_packed=None):
        m, k = x.shape
        n = w.shape[1]
        bn, splits = C._requant_plan(m, n, C._stages(k, 1), sms)
        shapes.append(("matmul_requant",
                       f"[{m},{k}]x[{k},{n}]" + (" +res" if res is not None
                                                  else ""),
                       nbytes(x, w, scale, bias)
                       + m * n * (2 if res is not None else 1),
                       2.0 * m * k * n, (bn, splits), (m, k, n)))
        return mm(x, w, scale, bias, res=res, res_scale=res_scale, relu=relu,
                  w_packed=w_packed)

    def rec_conv(x, w, scale, bias, res_nhwc=None, res_scale=None,
                 relu=True, w_packed=None):
        b, h, wd, k = x.shape
        n = w.shape[3]
        bn, splits = C._requant_plan(b * h * wd, n, C._stages(k, 9), sms)
        shapes.append(("conv3x3_requant",
                       f"[{b},{h},{wd},{k}]->{n}"
                       + (" +res" if res_nhwc is not None else ""),
                       nbytes(x, w, scale, bias)
                       + b * h * wd * n * (2 if res_nhwc is not None else 1),
                       2.0 * b * h * wd * 9 * k * n, (bn, splits), None))
        return conv(x, w, scale, bias, res_nhwc=res_nhwc,
                    res_scale=res_scale, relu=relu, w_packed=w_packed)

    with torch.inference_mode():
        qfn(x)
        torch.cuda.synchronize()
    # a trace that lost kernel events is taken again, up to three in all
    for attempt in range(3):
        shapes.clear()
        C.matmul_requant, C.conv3x3_requant = rec_mm, rec_conv
        try:
            with torch.inference_mode(), profile(
                    activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
                qfn(x)
                torch.cuda.synchronize()
        finally:
            C.matmul_requant, C.conv3x3_requant = mm, conv
        events = sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA
                         and "requant_gemm_kernel" in e.name),
                        key=lambda e: e.time_range.start)
        if len(events) == len(shapes) or attempt == 2:
            break
        log(f"  K5/K6 trace: {len(events)} kernels traced, {len(shapes)} "
            f"launches recorded; tracing again")
    require(len(events) == len(shapes),
            f"{len(events)} K5/K6 kernels traced, {len(shapes)} launches "
            f"recorded in one int8 embed call")
    rows = {}
    for (name, shape, moved, ops, plan, mkn), e in zip(shapes, events):
        by_bytes = moved / (HBM_PEAK_GBS * 1e9) * 1e6
        by_ops = ops / PEAK_OPS["int8"] * 1e6
        r = rows.setdefault((name, shape), [0, 0.0, max(by_bytes, by_ops),
                                            "bytes" if by_bytes >= by_ops
                                            else "operations", plan, mkn])
        r[0] += 1
        r[1] += e.self_device_time_total
    for name in ("matmul_requant", "conv3x3_requant"):
        mine = [(s, r) for (n, s), r in rows.items() if n == name]
        dev = sum(r[1] for _, r in mine)
        bnd = sum(r[0] * r[2] for _, r in mine)
        log(f"{name}, one int8 embed call of {len(x)} images "
            f"(torch.profiler): {sum(r[0] for _, r in mine)} launches, "
            f"{dev:.1f} us of device time against a summed bound of "
            f"{bnd:.2f} us ({bnd / dev:.3f} of it); per shape:")
        for shape, (n, us, b_us, b_by, (bn, splits), mkn) in mine:
            line = (f"  {name} {shape}: {n} launches, {us / n:.2f} us each, "
                    f"bound {b_us:.3f} us by {b_by} ({b_us * n / us:.3f} of "
                    f"it); {bn}-wide tiles, {splits} K splits")
            if mkn is not None:
                m, k, nn = mkn
                gen = torch.Generator(device="cuda").manual_seed(m + k + nn)
                a = torch.randint(-127, 128, (m, k), generator=gen,
                                  device="cuda", dtype=torch.int8)
                b = torch.randint(-127, 128, (k, nn), generator=gen,
                                  device="cuda", dtype=torch.int8)
                mm_us = device_us_per_call(lambda: torch._int_mm(a, b), 10)
                line += (f"; torch._int_mm (GEMM only, int32 out, no "
                         f"epilogue) {mm_us:.2f} us")
            log(line)


TRAIN_PIDS = 751         # Market-1501's train split: 751 identities,
TRAIN_IMAGES = 12_936    # 12,936 images; here 2 to 30 per identity
TRAIN_COUNT_RANGE = (2, 30)
TRAIN_P, TRAIN_K = 64, 4  # SOLVER.IMS_PER_BATCH x DATALOADER.NUM_INSTANCE
PARITY_P = 8             # the card-vs-CPU step: 8 pids x 4 at 256x128, fp32
PROFILED_STEPS = 5
TRAIN_GROUPS = 2         # TPU.NUM_GROUPS of the multi-group run
TRAIN_PHASES = ("gather", "augment", "forward", "backward", "optimizer")


def _train_counts() -> np.ndarray:
    """Uneven images per identity within TRAIN_COUNT_RANGE, summing to
    TRAIN_IMAGES."""
    rng = np.random.RandomState(SEED + 11)
    lo, hi = TRAIN_COUNT_RANGE
    counts = rng.randint(lo, hi + 1, TRAIN_PIDS)
    while counts.sum() != TRAIN_IMAGES:
        i = rng.randint(TRAIN_PIDS)
        if counts.sum() < TRAIN_IMAGES and counts[i] < hi:
            counts[i] += 1
        elif counts.sum() > TRAIN_IMAGES and counts[i] > lo:
            counts[i] -= 1
    return counts


def _write_market_train(root: str, eval_root: str) -> np.ndarray:
    """A Market-1501 train split of the dataset's size, in the style of
    ``_write_market`` (a seeded block pattern per identity, a brightness
    shift and pixel noise per image, 128x64 JPEGs on six cameras), beside
    the evaluation phase's query and gallery folders. Returns the counts."""
    import concurrent.futures
    import os

    from PIL import Image

    counts = _train_counts()
    rng = np.random.RandomState(SEED + 12)
    patterns = rng.randint(0, 256, (TRAIN_PIDS, 8, 4, 3)).astype(np.float32)
    base = os.path.join(root, "market1501")
    train = os.path.join(base, "bounding_box_train")
    os.makedirs(train)
    for sub in ("query", "bounding_box_test"):
        os.symlink(os.path.join(eval_root, "market1501", sub),
                   os.path.join(base, sub))

    def save(img, path):
        Image.fromarray(img).save(path)

    # the pixels are drawn in order here; the encoding runs in threads
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        jobs = []
        for pid, n in enumerate(counts):
            block = np.kron(patterns[pid], np.ones((16, 16, 1), np.float32))
            imgs = (block + rng.randint(-30, 31, (n, 1, 1, 3))
                    + rng.normal(0, 10, (n,) + block.shape))
            imgs = np.clip(imgs, 0, 255).astype(np.uint8)
            jobs += [pool.submit(save, imgs[i], os.path.join(
                train, f"{pid + 1:04d}_c{i % EVAL_CAMS + 1}s1_{i:06d}_00.jpg"))
                for i in range(n)]
        for job in jobs:
            job.result()
    return counts


def _train_opts(root: str, logs: str, *extra) -> list:
    import os

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "256_resnet50.yml")
    return ["--config_file", config, "DATASETS.NAMES", "market1501",
            "DATASETS.ROOT_DIR", root, "MODEL.USE_CENTROIDS", "True",
            "DATALOADER.USE_RESAMPLING", "False",
            "SOLVER.IMS_PER_BATCH", str(TRAIN_P),
            "DATALOADER.NUM_INSTANCE", str(TRAIN_K),
            "USE_MIXED_PRECISION", "True", "REPRODUCIBLE_NUM_RUNS", "1",
            "OUTPUT_DIR", logs, *extra]


def _flat_state(tree, prefix="") -> dict:
    """A state.pt-style dict -> {dotted key: tensor or value}, on the CPU."""
    import torch

    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_state(v, f"{prefix}{k}."))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_state(v, f"{prefix}{i}."))
    else:
        out[prefix] = tree.detach().cpu().clone() if torch.is_tensor(
            tree) else tree
    return out


def _same_state(a: dict, b: dict) -> bool:
    import torch

    return a.keys() == b.keys() and all(
        torch.equal(a[k], b[k]) if torch.is_tensor(a[k]) else a[k] == b[k]
        for k in a)


def _epoch_records(log_dir: str) -> list:
    import json
    import os

    with open(os.path.join(log_dir, "train", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    return [r for r in recs if "epoch_train_loss" in r]


def step_flops(model, x) -> tuple:
    """(FLOPs of one train step, FLOPs of its forward), from the shapes of
    one forward of ``x``: 2 x MACs of every conv and of the classifier;
    backward = 2 x forward, less the stem conv's input gradient (the images
    need none). BN, ReLU, pooling and the losses are not counted."""
    import torch

    macs, hooks = [], []

    def conv_hook(m, inp, out):
        macs.append((m, out.numel() * (m.in_channels // m.groups)
                     * m.kernel_size[0] * m.kernel_size[1]))

    for m in model.modules():
        if isinstance(m, torch.nn.Conv2d):
            hooks.append(m.register_forward_hook(conv_hook))
    model.eval()   # the same shapes; no running statistic moves
    try:
        with torch.no_grad(), torch.autocast(x.device.type, dtype=torch.bfloat16):
            model.features(x)
    finally:
        model.train()
        for h in hooks:
            h.remove()
    n = x.shape[0]
    fc = n * model.fc_query.in_features * model.fc_query.out_features
    fwd = 2.0 * (sum(v for _, v in macs) + fc)
    stem = 2.0 * dict(macs)[model.backbone.conv1]
    return 3.0 * fwd - stem, fwd


def _phase_device_us(trace_path: str, phases=TRAIN_PHASES) -> dict:
    """Device time (kernels, copies, sets) per annotated phase of a
    torch.profiler Chrome trace: each device event goes to the phase whose
    host range holds the call that launched it (by correlation id; the
    backward's launches come from autograd's thread while the main thread
    waits inside its "backward" range)."""
    import json

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
              if e.get("cat") == "user_annotation"
              and e.get("name") in phases]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat", "").startswith("cuda_")
                 and "correlation" in e.get("args", {})}
    out = {name: 0.0 for name in tuple(phases) + ("other",)}
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        name = next((r[2] for r in ranges if ts is not None
                     and r[0] <= ts <= r[1]), "other")
        out[name] += e["dur"]
    return out


def phase_train(tmp: str, ckpt: str, eval_root: str) -> dict:
    """Phase 8, training: a Market-1501-sized synthetic train split, CTL
    training of ResNet-50 (256x128, 64 x 4 images a step, bf16) through
    ``engine.runner.main --mode ctl`` from a torchvision-layout backbone
    file, 2 epochs with validation and checkpoints, a resume from
    ``checkpoint_epoch1`` to epoch 3, ONLY_TEST of the best checkpoint, one
    ``--mode base`` epoch on the split's first DIST_TRAIN_PIDS pids and one
    epoch at ``TPU.NUM_GROUPS 2``, each with the double test; then the
    step's time, rate, memory, idle share, profiler split and share of the
    bf16 peak, and one full-width step on the card against the CPU, at one
    group and at two."""
    import os

    import torch

    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.data import init_dataset
    from centroids_reid_tpu_torch.engine import checkpoint as CK
    from centroids_reid_tpu_torch.engine import fit as FIT
    from centroids_reid_tpu_torch.engine import runner
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    log("== phase 8: training (CTL, ResNet-50, through the runner)")
    root = os.path.join(tmp, "train_data")
    t0 = time.perf_counter()
    counts = _write_market_train(root, eval_root)
    log(f"synthetic Market-1501 train split: {TRAIN_PIDS} pids, "
        f"{counts.sum()} 128x64 JPEGs ({counts.min()} to {counts.max()} per "
        f"pid), written in {time.perf_counter() - t0:.1f} s; validation on "
        f"phase 5's {EVAL_PIDS * EVAL_QUERIES} queries and "
        f"{EVAL_PIDS * EVAL_GALLERY} gallery images")

    # the pretrained backbone: the seeded random model's trunk, in the
    # torchvision ResNet-50 file layout (with its ImageNet fc head)
    sd = torch.load(ckpt, map_location="cpu", weights_only=True)["state_dict"]
    backbone = {k[len("backbone."):]: v for k, v in sd.items()
                if k.startswith("backbone.")}
    gen = torch.Generator().manual_seed(SEED + 13)
    backbone["fc.weight"] = torch.randn((1000, DIM), generator=gen) * 0.01
    backbone["fc.bias"] = torch.zeros(1000)
    pth = os.path.join(tmp, "resnet50_torchvision_layout.pth")
    torch.save(backbone, pth)

    logs = os.path.join(tmp, "logs_train")
    version0 = os.path.join(logs, "train_ctl_model", "version_0")
    snapshots, banks = {}, []
    save_periodic, build_bank = CK.CheckpointManager.save_periodic, \
        FIT.build_image_bank

    def snapshot(self, epoch, state, cfg=None):
        path = save_periodic(self, epoch, state, cfg)
        snapshots[path] = _flat_state(CK.state_dict(state, epoch))
        return path

    def keep_bank(*args, **kw):
        banks[:] = [build_bank(*args, **kw)]    # the latest run's bank
        return banks[0]

    CK.CheckpointManager.save_periodic = snapshot
    FIT.build_image_bank = keep_bank
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = runner.main(["--mode", "ctl", *_train_opts(
            root, logs, "MODEL.PRETRAINED", "True", "MODEL.PRETRAIN_PATH",
            pth, "SOLVER.MAX_EPOCHS", "2", "SOLVER.EVAL_PERIOD", "2")])
        train_s = time.perf_counter() - t0
        ring = os.path.join(version0, "auto_checkpoints", "checkpoint_epoch1")
        t0 = time.perf_counter()
        resumed = runner.main(["--mode", "ctl", *_train_opts(
            root, logs, "MODEL.RESUME_TRAINING", "True",
            "MODEL.PRETRAIN_PATH", ring, "SOLVER.MAX_EPOCHS", "3",
            "SOLVER.EVAL_PERIOD", "2")])
        resume_s = time.perf_counter() - t0
        best_dir = os.path.join(version0, "checkpoints")
        best = sorted(os.listdir(best_dir))
        require(best == ["epoch=1"], f"best checkpoints: {best}")
        best = os.path.join(best_dir, best[0])
        t0 = time.perf_counter()
        tested = runner.main(_train_opts(
            root, logs, "TEST.ONLY_TEST", "True", "MODEL.PRETRAIN_PATH",
            best))
        test_s = time.perf_counter() - t0
        cut = _dist_cut(tmp, root, eval_root)
        t0 = time.perf_counter()
        base_out = runner.main(["--mode", "base", *_train_opts(
            cut, logs, "MODEL.PRETRAINED", "True", "MODEL.PRETRAIN_PATH",
            pth, "DATALOADER.USE_RESAMPLING", "True", "SOLVER.MAX_EPOCHS",
            "1", "SOLVER.EVAL_PERIOD", "100")])
        base_s = time.perf_counter() - t0
        logs_g2 = os.path.join(tmp, "logs_train_g2")
        t0 = time.perf_counter()
        g2_out = runner.main(["--mode", "ctl", *_train_opts(
            root, logs_g2, "MODEL.PRETRAINED", "True", "MODEL.PRETRAIN_PATH",
            pth, "TPU.NUM_GROUPS", str(TRAIN_GROUPS), "SOLVER.MAX_EPOCHS",
            "1", "SOLVER.EVAL_PERIOD", "100")])
        g2_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        CK.CheckpointManager.save_periodic = save_periodic
        FIT.build_image_bank = build_bank

    records = (_epoch_records(version0)
               + _epoch_records(os.path.join(logs, "train_ctl_model",
                                             "version_1")))
    base_records = _epoch_records(os.path.join(logs, "train_base_model",
                                               "version_0"))
    g2_records = _epoch_records(os.path.join(logs_g2, "train_ctl_model",
                                             "version_0"))
    loss_keys = ("epoch_train_loss", "query_triplet", "query_xent",
                 "query_center", "epoch_dist_ap", "epoch_dist_an")
    ctl_keys = ("centroid_triplet", "l2_mean_centroid")
    for mode, recs, keys in (("ctl", records, loss_keys + ctl_keys),
                             ("base", base_records, loss_keys),
                             (f"ctl G={TRAIN_GROUPS}", g2_records,
                              loss_keys + ctl_keys)):
        for r in recs:
            require(all(np.isfinite(r[k]) for k in keys),
                    f"{mode} epoch {r['step']}: a loss is not finite: {r}")
            log(f"{mode} epoch {r['step']}: " + ", ".join(
                f"{k} {r[k]:.5f}" for k in keys)
                + f", {r['steps']} steps, {r['epoch_time_s']:.2f} s")
    require([r["step"] for r in records] == [0, 1, 2],
            f"epochs trained: {[r['step'] for r in records]} (the resumed "
            f"run must start at epoch 2)")
    require([r["step"] for r in base_records] == [0],
            f"base epochs trained: {[r['step'] for r in base_records]}")
    require([r["step"] for r in g2_records] == [0],
            f"G={TRAIN_GROUPS} epochs trained: "
            f"{[r['step'] for r in g2_records]}")
    require(os.path.isdir(ring) and sorted(os.listdir(ring)) == [
        "config.yml", "state.pt"], f"ring checkpoint {ring} missing")
    require(ring in snapshots, "checkpoint_epoch1 was not saved")
    require(_same_state(_flat_state(CK.load_state_file(ring)),
                        snapshots[ring]),
            "state.pt differs from the state it saved")
    names = [f"test_{tag}_{m}" for tag in ("centroids", "plain")
             for m in ("mAP", "Top-1", "Top-5", "Top-10", "Top-20",
                       "Top-50")]
    for what, res in (("train", out), ("resume", resumed),
                      ("ONLY_TEST", tested), ("base", base_out),
                      (f"train G={TRAIN_GROUPS}", g2_out)):
        require(all(n in res and np.isfinite(res[n]) for n in names),
                f"{what}: metrics missing from {sorted(res)}")
        log(f"{what} double test: " + ", ".join(
            f"{n[5:]} {res[n]:.4f}" for n in names))
    require(not any(launches.values()),
            f"hand-written kernels launched while training: {launches}")
    log(f"runner: ctl 2 epochs + validation + double test {train_s:.1f} s, "
        f"resume at epoch 2 {resume_s:.1f} s, ONLY_TEST of {best} "
        f"{test_s:.1f} s, base 1 epoch on the first {DIST_TRAIN_PIDS} pids "
        f"({base_records[0]['steps']} steps) + double test on the first "
        f"{DIST_EVAL_PIDS} {base_s:.1f} s, TPU.NUM_GROUPS {TRAIN_GROUPS} 1 epoch ({g2_records[0]['steps']} "
        f"steps of {TRAIN_GROUPS} x {TRAIN_P} x {TRAIN_K}) + double test "
        f"{g2_s:.1f} s (host clock, image bank decode included); state.pt "
        f"of checkpoint_epoch1 "
        f"equals the saved state tensor for tensor; kernel launches while "
        f"training: {launches} (none: the slice has no hand-written kernel)")

    opts = _train_opts(root, logs, "MODEL.PRETRAINED", "True",
                       "MODEL.PRETRAIN_PATH", pth)
    cfg = get_default_cfg()
    cfg.merge_from_file(opts[1])
    cfg.merge_from_list(opts[2:])
    dataset = init_dataset("market1501", cfg)
    restored = FIT.build_model_and_state(cfg, dataset, seed=1,
                                         device="cuda")
    CK.restore_state(ring, restored)
    require(_same_state(_flat_state(CK.state_dict(restored, 1)),
                        snapshots[ring]),
            "a state restored from checkpoint_epoch1 differs from the saved")
    log("restore_state(checkpoint_epoch1) into a fresh state: equal to the "
        "saved state tensor for tensor")
    timing = time_train_step(cfg, dataset, restored, banks[0])
    timing.update(train_parity(cfg, dataset, banks[0]))
    cfg_g2 = cfg.clone()
    cfg_g2.TPU.NUM_GROUPS = TRAIN_GROUPS
    state_g2 = FIT.build_model_and_state(cfg_g2, dataset, seed=1,
                                         device="cuda")
    CK.restore_state(ring, state_g2)
    del restored
    torch.cuda.empty_cache()
    timing["groups"] = time_train_step(cfg_g2, dataset, state_g2, banks[0])
    del state_g2
    timing["groups"].update(train_parity(cfg_g2, dataset, banks[0]))
    timing.update(best=best, root=root, pth=pth, cut=cut)
    return timing


def time_train_step(cfg, dataset, state, bank_np,
                    label: str = "ResNet-50 256x128 bf16") -> dict:
    """The bf16 train step of ``TPU.NUM_GROUPS`` groups (G) of P x K
    images (64 x 4 in phase 8) over one epoch of the resident path:
    per-step CUDA-event times, the epoch's wall time, peak memory, its
    device busy time, the profiler's split of 5 steps, and the step's
    share of the bf16 dense peak."""
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from centroids_reid_tpu_torch.data import TrainLoader
    from centroids_reid_tpu_torch.data.device_data import plan_to_arrays
    from centroids_reid_tpu_torch.engine.epoch_runner import make_augment
    from centroids_reid_tpu_torch.engine.fit import num_groups
    from centroids_reid_tpu_torch.engine.steps import make_train_step

    model = state.model
    step = make_train_step(state, cfg, dataset.num_classes, "ctl")
    augment = make_augment(cfg)
    bank = torch.from_numpy(bank_np).to("cuda")
    groups = num_groups(cfg)
    plan = TrainLoader(dataset, cfg, num_groups=groups).plan_for_epoch(5)
    idx, labels, is_real = (torch.from_numpy(a).to(
        "cuda", torch.int64 if a.dtype != bool else torch.bool)
        for a in plan_to_arrays(plan, dataset.train))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n_steps, _, pk = idx.shape
    images = groups * pk

    def batch(t):
        with torch.profiler.record_function("gather"):
            imgs = bank.index_select(0, idx[t].flatten())
        with torch.profiler.record_function("augment"):
            x = augment(imgs, is_real[t].flatten(), gen)
        return x.unflatten(0, (groups, pk)), labels[t], is_real[t]

    def one(t):
        return step(*batch(t))

    for t in range(2):   # warm-up: cuDNN's algorithm choice, allocator
        one(t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n_steps)]
    t0 = time.perf_counter()
    for t in range(n_steps):
        events[t][0].record()
        m = one(t)
        events[t][1].record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    step_ms = [s.elapsed_time(e) for s, e in events]
    med = float(np.median(step_ms[1:]))
    require(np.isfinite(m["loss"].item()), "timed epoch: loss not finite")
    gpu = gpu_line()
    log(f"train step, {label}, {images} images ({groups} "
        f"group{'s' if groups > 1 else ''} of {cfg.SOLVER.IMS_PER_BATCH} x "
        f"{cfg.DATALOADER.NUM_INSTANCE}), "
        f"resident epoch of {n_steps} steps, {gpu}: median {med:.2f} ms a "
        f"step (CUDA events, first step excluded; min "
        f"{min(step_ms[1:]):.2f}, max {max(step_ms[1:]):.2f}) = "
        f"{images / med * 1e3:.1f} images/s; epoch wall {wall:.3f} s = "
        f"{n_steps * images / wall:.1f} images/s (host clock); peak memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated, the "
        f"{bank.numel() / 2**30:.2f} GiB image bank included)")
    out = {"step_ms": med, "images_per_s": images / med * 1e3,
           "epoch_wall_s": wall, "peak_bytes": peak, "steps": n_steps}

    # the device's busy time over one epoch from a trace of device activity
    # alone, which the host reads in a fraction of the time a trace of the
    # host operators too would take
    t_parse = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for t in range(n_steps):
            one(t)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t1
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    t_parse = time.perf_counter() - t_parse - wall_prof
    require(busy_us > 0, "torch.profiler saw no device time in the epoch")
    busy = busy_us / 1e6

    with tempfile.TemporaryDirectory() as d:
        trace = f"{d}/trace.json"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof5:
            for t in range(PROFILED_STEPS):
                one(t)
            torch.cuda.synchronize()
        prof5.export_chrome_trace(trace)
        split = _phase_device_us(trace)

    flops, fwd = step_flops(model, torch.zeros(
        (images, 3) + tuple(cfg.INPUT.SIZE_TRAIN), device="cuda").to(
        memory_format=torch.channels_last))
    share = flops / (med / 1e3) / PEAK_OPS["bf16"]
    log(f"train epoch under torch.profiler, {gpu}: wall {wall_prof:.3f} s, "
        f"device busy {busy:.3f} s (kernels, copies and sets), idle share "
        f"{1 - busy / wall_prof:.4f}; against the unprofiled epoch's wall "
        f"{wall:.3f} s: {1 - busy / wall:.4f} (device activity traced; "
        f"the trace read in {t_parse:.1f} s of host time)")
    total = sum(split.values()) or 1.0
    log(f"device time of {PROFILED_STEPS} steps by phase (torch.profiler, "
        f"{gpu}, {total / 1e3:.1f} ms in all): " + ", ".join(
            f"{k} {v / 1e3:.1f} ms ({v / total:.3f})"
            for k, v in split.items()))
    log(f"step FLOPs from the layer shapes: forward {fwd / 1e12:.3f} TFLOP "
        f"(convs and classifier), step {flops / 1e12:.3f} TFLOP; at "
        f"{med:.2f} ms: {flops / (med / 1e3) / 1e12:.1f} TFLOP/s, {share:.4f}"
        f" of the bf16 dense peak (989 TFLOP/s; {gpu})")
    out.update(device_busy_s=busy, idle_share=1 - busy / wall, split_us=split,
               step_flops=flops, peak_share=share)
    return out


def train_parity(cfg, dataset, bank_np, pids_n: int = PARITY_P,
                 label: str = "256x128") -> dict:
    """One ctl step of the model at full width (``pids_n`` pids x K = 4,
    P = 8 at 256x128 in phase 8, one mock a group, already augmented; with
    ``TPU.NUM_GROUPS`` G the pids split into G groups) from one state, on
    the card and on the CPU, in fp32 with TF32 off and in float64.

    * fp32: every loss term, card against CPU, to rtol 1e-4.
    * float64: every parameter's gradient, card against CPU, to a relative
      L2 error of 1e-3. The CPU's fp32 gradients of this random trunk are a
      few 1e-3 from float64 per tensor (printed), so card and CPU cannot
      meet 1e-3 per tensor in fp32; in float64 the same comparison tests
      the implementations, not the rounding. A gradient that is zero in
      exact arithmetic (norm under 1e-9 of the largest in float64 on the
      CPU: the stem BN's bias) must be so on the card too.
    * fp32 gradients, whole (every tensor in one vector): the card's
      relative L2 error against the float64 gradient at most 1e-3.
    Then the same batch in bf16 on the card: its total loss within 2e-2 of
    the CPU's fp32 loss (bf16 autocast rounds every conv's operands)."""
    import copy
    import os

    import torch

    from centroids_reid_tpu_torch.data.transforms import (
        apply_augment,
        draw_augment_params,
    )
    from centroids_reid_tpu_torch.engine import fit as FIT
    from centroids_reid_tpu_torch.engine.state import create_train_state
    from centroids_reid_tpu_torch.engine.steps import make_train_step

    cfg = cfg.clone()
    groups = FIT.num_groups(cfg)
    cfg.USE_MIXED_PRECISION = False
    cfg.SOLVER.IMS_PER_BATCH = pids_n // groups
    pids = [pid for pid, recs in sorted(dataset.train_dict.items())
            if len(recs) >= TRAIN_K][:pids_n]
    rows = [r.idx for pid in pids for r in dataset.train_dict[pid][:TRAIN_K]]
    labels = torch.tensor([dataset.train[i].pid for i in rows]).view(
        groups, -1)
    is_real = torch.ones(labels.shape, dtype=torch.bool)
    is_real[:, 2 * TRAIN_K - 1] = False
    params = draw_augment_params(len(rows), torch.Generator().manual_seed(4),
                                 tuple(cfg.INPUT.SIZE_TRAIN),
                                 cfg.INPUT.PADDING, cfg.INPUT.PROB,
                                 cfg.INPUT.RE_PROB)
    x = apply_augment(torch.from_numpy(bank_np[rows]), is_real.flatten(),
                      params, cfg.INPUT.PADDING, cfg.INPUT.PIXEL_MEAN,
                      cfg.INPUT.PIXEL_STD).unflatten(0, labels.shape)
    base = FIT.build_model_and_state(cfg, dataset, seed=2, device="cpu")
    torch.set_num_threads(os.cpu_count() or 1)
    results = {}
    for name, dev, dtype, bf16 in (
            ("card", "cuda", torch.float32, False),
            ("cpu", "cpu", torch.float32, False),
            ("card-fp64", "cuda", torch.float64, False),
            ("cpu-fp64", "cpu", torch.float64, False),
            ("card-bf16", "cuda", torch.float32, True)):
        model = copy.deepcopy(base.model).to(
            dev, dtype, memory_format=torch.channels_last)
        model.mixed_precision = bf16
        state = create_train_state(cfg, model, dataset.num_classes,
                                   torch.Generator())
        with torch.no_grad():
            state.centers.copy_(base.centers)
        step = make_train_step(state, cfg, dataset.num_classes, "ctl")
        t0 = time.perf_counter()
        metrics = step(x.to(dev, dtype), labels.to(dev), is_real.to(dev))
        metrics = {k: v.item() for k, v in metrics.items()}
        grads = {n: p.grad.detach().double().cpu()
                 for n, p in model.named_parameters() if p.grad is not None}
        grads["centers"] = state.centers.grad.double().cpu()
        require(all(p.grad.dtype == dtype for p in model.parameters()
                    if p.grad is not None), f"{name}: a gradient left {dtype}")
        results[name] = (metrics, grads, time.perf_counter() - t0)
    (mc, gc, tc), (mp, gp, tp), (_, gc64, tc64), (_, g64, t64), (mb, _, _) = (
        results[k] for k in ("card", "cpu", "card-fp64", "cpu-fp64",
                             "card-bf16"))
    worst_loss = max(abs(mc[k] - mp[k]) / max(abs(mp[k]), 1e-12) for k in mp)
    require(all(abs(mc[k] - mp[k]) <= 1e-4 * abs(mp[k]) + 1e-7 for k in mp),
            f"card vs CPU losses: {mc} vs {mp}")
    require(gc.keys() == gp.keys() == gc64.keys() == g64.keys(),
            "card and CPU train different tensors")

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    top = max(float(g.norm()) for g in g64.values())
    zero = [n for n in g64 if float(g64[n].norm()) <= 1e-9 * top]
    names = [n for n in g64 if n not in zero]
    err64 = {n: rel(gc64[n], g64[n]) for n in names}     # card vs CPU, fp64
    worst64 = max(names, key=err64.get)
    require(err64[worst64] <= 1e-3, "float64 gradients, card vs CPU: "
            + ", ".join(f"{n} {err64[n]:.3e}" for n in names
                        if err64[n] > 1e-3))
    require(all(float(gc64[n].norm()) <= 1e-9 * top for n in zero),
            "zero in exact arithmetic on the CPU, not on the card: "
            + ", ".join(f"{n} {float(gc64[n].norm()) / top:.2e}"
                        for n in zero))

    def whole(g):
        return torch.cat([g[n].flatten() for n in sorted(g)])

    card_whole, cpu_whole = (rel(whole(g), whole(g64)) for g in (gc, gp))
    require(card_whole <= 1e-3,
            f"fp32 gradient against float64: card {card_whole:.3e}, CPU "
            f"{cpu_whole:.3e}")
    errs = {n: rel(gc[n], gp[n]) for n in names}         # card vs CPU, fp32
    card = {n: rel(gc[n], g64[n]) for n in names}        # card fp32 vs fp64
    cpu = {n: rel(gp[n], g64[n]) for n in names}         # CPU fp32 vs fp64

    def count(err):
        return sum(v <= 1e-3 for v in err.values())

    def spread(err):
        worst = max(err, key=err.get)
        return (f"median {float(np.median(list(err.values()))):.2e}, worst "
                f"{err[worst]:.2e} ({worst})")

    bf16_rel = abs(mb["loss"] - mp["loss"]) / abs(mp["loss"])
    require(bf16_rel <= 2e-2, f"bf16 loss {mb['loss']} vs the CPU's fp32 "
            f"{mp['loss']}")
    bf16_terms = ", ".join(f"{k} {mb[k]:.6f} vs {mp[k]:.6f}" for k in mp
                           if k != "loss")
    log(f"full-width step parity ({groups} group{'s' if groups > 1 else ''}"
        f" of {pids_n // groups} x {TRAIN_K} at {label}, one mock a group, "
        f"TF32 off, {gpu_line()}): fp32 loss terms within "
        f"{worst_loss:.2e} relative of the CPU's (loss {mc['loss']:.6f} vs "
        f"{mp['loss']:.6f}; tol 1e-4); float64 gradients, card vs CPU, "
        f"relative L2: worst {err64[worst64]:.2e} ({worst64}), median "
        f"{float(np.median(list(err64.values()))):.2e} over {len(names)} "
        f"tensors (tol 1e-3); zero in exact arithmetic: " + ", ".join(
            f"{n} (norm / largest: {float(g64[n].norm()) / top:.1e} CPU "
            f"fp64, {float(gc64[n].norm()) / top:.1e} card fp64, "
            f"{float(gp[n].norm()) / top:.1e} CPU fp32, "
            f"{float(gc[n].norm()) / top:.1e} card fp32)" for n in zero)
        + ("none" if not zero else "")
        + f"; fp32 gradients: the whole gradient {card_whole:.2e} from "
        f"float64 on the card (tol 1e-3), {cpu_whole:.2e} on the CPU; per "
        f"tensor against float64: the card {count(card)} of {len(names)} "
        f"within 1e-3, {spread(card)}; the CPU {count(cpu)}, {spread(cpu)}; "
        f"card vs CPU {count(errs)}, {spread(errs)}; bf16 on the "
        f"card: loss {mb['loss']:.6f}, {bf16_rel:.2e} from the CPU's fp32 "
        f"(tol 2e-2; terms, bf16 card vs fp32 CPU: {bf16_terms}); "
        f"step {tc:.2f} s on the card (first call), {tp:.2f} s on the CPU, "
        f"float64 {tc64:.2f} s on the card, {t64:.2f} s on the CPU")
    return {"parity_loss_rel": worst_loss, "parity_grad64_rel": err64[worst64],
            "parity_grad32_whole": card_whole, "bf16_loss_rel": bf16_rel}


# -------------------------------------------------------- phase 14 ------

DIST_TRAIN_PIDS = 128    # the torchrun run and phase 8's base epoch: phase
                         # 8's first 128 identities
DIST_EVAL_PIDS = 25      # and phase 5's first 25 (50 queries, 450 gallery)
DIST_STEPS = 8           # steps timed per variant (first excluded)
DIST_PROFILED = 3        # distributed steps under torch.profiler
DIST_TIMEOUT_S = 300     # the torchrun launch's limit


def _dist_cut(tmp: str, train_root: str, eval_root: str) -> str:
    """Phase 8's train split cut to its first DIST_TRAIN_PIDS identities
    and phase 5's query and gallery to their first DIST_EVAL_PIDS, as
    symlinks in a Market-1501 layout."""
    import os

    base = os.path.join(tmp, "dist_data", "market1501")
    for sub, src_root, pids in (
            ("bounding_box_train", train_root, DIST_TRAIN_PIDS),
            ("query", eval_root, DIST_EVAL_PIDS),
            ("bounding_box_test", eval_root, DIST_EVAL_PIDS)):
        src = os.path.realpath(os.path.join(src_root, "market1501", sub))
        os.makedirs(os.path.join(base, sub))
        for name in sorted(os.listdir(src)):
            if name.endswith(".jpg") and int(name[:4]) <= pids:
                os.symlink(os.path.join(src, name),
                           os.path.join(base, sub, name))
    return os.path.dirname(base)


def _torchrun(args: list, timeout: float) -> tuple:
    """``python -m torch.distributed.run <args>`` from the repository root
    in a session of its own (killed whole past ``timeout``); returns (exit
    code, output, seconds)."""
    import os
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate()[0] + f"\n(killed after {timeout} s)"
    return proc.returncode, out, time.perf_counter() - t0


def phase_dist(tmp: str, train: dict) -> dict:
    """Phase 14, processes over ``torch.distributed`` at world size 1 on the
    card (NCCL): ``torchrun --standalone --nproc_per_node 1 -m
    centroids_reid_tpu_torch.engine.runner`` trains ResNet-50 (256x128,
    64 x 4 images a group, bf16, ``TPU.NUM_GROUPS 0``: one group per
    process) for 1 epoch on a cut of phase 8's split with validation,
    checkpoints and the double test; then, in this process, in an NCCL
    group of one: one full-width distributed step (the flat all-reduce)
    against the plain step from one state (cuDNN deterministic), both
    timed, with the all-reduce's device time; ``extract_embeddings_sharded``
    against ``extract_embeddings``; the stop collective."""
    import copy
    import datetime
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.data import EvalLoader, TrainLoader
    from centroids_reid_tpu_torch.data import init_dataset
    from centroids_reid_tpu_torch.engine import fit as FIT
    from centroids_reid_tpu_torch.engine.epoch_runner import make_augment
    from centroids_reid_tpu_torch.engine.evaluate import (
        _shared_store,
        extract_embeddings,
        extract_embeddings_sharded,
    )
    from centroids_reid_tpu_torch.engine.state import create_train_state
    from centroids_reid_tpu_torch.engine.steps import make_train_step
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts
    from centroids_reid_tpu_torch.parallel import any_process, process_count

    log("== phase 14: processes over torch.distributed (NCCL, world size 1)")
    gpu = gpu_line()
    root = train["cut"]
    logs = os.path.join(tmp, "logs_dist")
    code, out, run_s = _torchrun(
        ["--standalone", "--nproc_per_node", "1", "-m",
         "centroids_reid_tpu_torch.engine.runner", "--mode", "ctl",
         *_train_opts(root, logs, "MODEL.PRETRAINED", "True",
                      "MODEL.PRETRAIN_PATH", train["pth"], "TPU.NUM_GROUPS",
                      "0", "SOLVER.MAX_EPOCHS", "1", "SOLVER.EVAL_PERIOD",
                      "1")], DIST_TIMEOUT_S)
    require(code == 0, f"torchrun exited {code}:\n{out[-6000:]}")
    require("torch.distributed initialised: 1 processes (nccl)" in out,
            f"the runner did not join an NCCL group:\n{out[-3000:]}")
    runs = os.path.join(logs, "train_ctl_model")
    require(os.listdir(runs) == ["version_0"], f"runs: {os.listdir(runs)}")
    version = os.path.join(runs, "version_0")
    best = os.listdir(os.path.join(version, "checkpoints"))
    ring = os.listdir(os.path.join(version, "auto_checkpoints"))
    require(best == ["epoch=0"] and ring == ["checkpoint_epoch0"],
            f"checkpoints {best}, ring {ring}")
    with open(os.path.join(version, "train", "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    epochs = [r for r in recs if "epoch_train_loss" in r]
    tests = {k: v for r in recs for k, v in r.items()
             if k.startswith("test_")}
    require(len(epochs) == 1 and np.isfinite(epochs[0]["epoch_train_loss"]),
            f"epoch records: {epochs}")
    require(np.isfinite(tests.get("test_centroids_mAP", np.nan))
            and np.isfinite(tests.get("test_plain_mAP", np.nan)),
            f"double test: {tests}")
    log(f"torchrun --standalone --nproc_per_node 1 -m "
        f"centroids_reid_tpu_torch.engine.runner (TPU.NUM_GROUPS 0, NCCL): "
        f"{DIST_TRAIN_PIDS} of phase 8's pids, 1 epoch of "
        f"{int(epochs[0]['steps'])} steps of {TRAIN_P} x {TRAIN_K}, loss "
        f"{epochs[0]['epoch_train_loss']:.5f}, validation on "
        f"{DIST_EVAL_PIDS * (EVAL_QUERIES + EVAL_GALLERY)} images, best "
        f"{best[0]}, ring {ring[0]}, double test mAP centroids "
        f"{tests['test_centroids_mAP']:.4f} plain "
        f"{tests['test_plain_mAP']:.4f}; {run_s:.1f} s (host clock, process "
        f"start, image bank and checkpoints included)")

    # in this process: one state and one full-width batch of phase 8's split
    marks = [("set-up", time.perf_counter())]
    opts = _train_opts(train["root"], logs, "MODEL.PRETRAINED", "True",
                       "MODEL.PRETRAIN_PATH", train["pth"])
    cfg = get_default_cfg()
    cfg.merge_from_file(opts[1])
    cfg.merge_from_list(opts[2:])
    dataset = init_dataset("market1501", cfg)
    loader = TrainLoader(dataset, cfg, num_groups=1)
    batch = loader._assemble(loader.plan_for_epoch(0), 0)
    imgs, labels, is_real = (torch.from_numpy(batch[k]).cuda()
                             for k in ("images", "labels", "is_real"))
    x = make_augment(cfg)(imgs.flatten(0, 1), is_real.flatten(),
                          torch.Generator(device="cuda").manual_seed(SEED)
                          ).unflatten(0, imgs.shape[:2])
    base = FIT.build_model_and_state(cfg, dataset, seed=3, device="cuda")

    def fresh():
        model = copy.deepcopy(base.model)
        state = create_train_state(cfg, model, dataset.num_classes,
                                   torch.Generator())
        with torch.no_grad():
            state.centers.copy_(base.centers)
        return state, make_train_step(state, cfg, dataset.num_classes, "ctl")

    def stepped():
        state, step = fresh()
        step(x, labels, is_real)
        torch.cuda.synchronize()
        return _flat_state({"model": state.model.state_dict(),
                            "centers": state.centers})

    def step_ms():
        _, step = fresh()
        events = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True))
                  for _ in range(DIST_STEPS + 1)]
        step(x, labels, is_real)
        for start, end in events:
            start.record()
            step(x, labels, is_real)
            end.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in events[1:]]))

    def max_diff(a, b):
        return max(float((a[k].double() - b[k].double()).abs().max())
                   if a[k].is_floating_point() else float(
                       (a[k] != b[k]).any()) for k in a)

    cudnn = torch.backends.cudnn
    flags = (cudnn.deterministic, cudnn.benchmark)
    torch.cuda.synchronize()
    reset_launch_counts()
    marks.append(("plain steps", time.perf_counter()))
    cudnn.deterministic, cudnn.benchmark = True, False
    try:
        plain = [stepped(), stepped()]
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    plain_ms = [step_ms()]
    marks.append(("NCCL init", time.perf_counter()))
    dist.init_process_group(
        "nccl", init_method="file://" + os.path.join(tmp, "pg14"), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=120))
    try:
        require(process_count() == 1, "the group is not of one process")
        marks.append(("distributed steps", time.perf_counter()))
        cudnn.deterministic, cudnn.benchmark = True, False
        try:
            reduced = stepped()
        finally:
            cudnn.deterministic, cudnn.benchmark = flags
        dist_ms = [step_ms(), step_ms()]
        marks.append(("profile", time.perf_counter()))
        state, step = fresh()
        step(x, labels, is_real)
        for _ in range(3):   # a trace that lost its device events again
            with tempfile.TemporaryDirectory() as d:
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(DIST_PROFILED):
                        step(x, labels, is_real)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(f"{d}/trace.json")
                split = _phase_device_us(f"{d}/trace.json", (
                    "forward", "backward", "all_reduce", "optimizer"))
            if split["all_reduce"] > 0:
                break
        nccl_us = sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and "nccl" in e.key.lower()) / DIST_PROFILED
        values = (sum(p.numel() for p in state.model.parameters()
                      if p.grad is not None) + state.centers.numel()
                  + sum(b.numel() for m in state.model.backbone.modules()
                        if isinstance(m, torch.nn.BatchNorm2d)
                        for b in (m.running_mean, m.running_var))
                  + 2 * state.model.bn.num_features)
        del state, step

        marks.append(("extraction", time.perf_counter()))
        eval_cfg = cfg.clone()
        eval_cfg.DATASETS.ROOT_DIR = root
        eval_set = init_dataset("market1501", eval_cfg)
        model = base.model.eval()
        store = _shared_store(eval_set, eval_cfg)
        sharded = extract_embeddings_sharded(model, eval_cfg, eval_set.val,
                                             store)
        full = extract_embeddings(model, eval_cfg, EvalLoader(
            eval_set.val, eval_cfg, store=store))
        require(all(np.array_equal(a, b) for a, b in zip(sharded, full)),
                "extract_embeddings_sharded differs from extract_embeddings "
                "at world size 1")
        t0 = time.perf_counter()
        stops = (any_process(False), any_process(True))
        stop_ms = (time.perf_counter() - t0) * 1e3 / 2
        require(stops == (False, True), f"stop collective: {stops}")
    finally:
        dist.destroy_process_group()
    marks.append(("plain steps", time.perf_counter()))
    plain_ms.append(step_ms())
    torch.cuda.synchronize()
    marks.append(("end", time.perf_counter()))
    launches = launch_counts()
    require(not any(launches.values()),
            f"hand-written kernels launched in phase 14: {launches}")
    noise = max_diff(plain[1], plain[0])
    diff = max_diff(reduced, plain[0])
    require(diff <= 2 * noise, f"the distributed step differs from the "
            f"plain one by {diff:.3e} (two plain steps: {noise:.3e})")
    log(f"distributed step against the plain step from one state "
        f"(ResNet-50 256x128 bf16, {TRAIN_P} x {TRAIN_K}, cuDNN "
        f"deterministic): state after the step "
        + ("equal bit for bit" if diff == 0 else
           f"within {diff:.3e} (max abs; two plain steps differ by "
           f"{noise:.3e}, the tolerance is twice that)")
        + f" over {len(plain[0])} tensors; extract_embeddings_sharded at "
        f"world size 1 equals extract_embeddings bit for bit on "
        f"{len(eval_set.val)} records; the stop collective (all_reduce MAX "
        f"of an int32 on the card) {stop_ms:.3f} ms a call (host clock); "
        f"in-process seconds: " + ", ".join(
            f"{name} {b - a:.1f}" for (name, a), (_, b)
            in zip(marks, marks[1:])))
    per = {k: v / DIST_PROFILED / 1e3 for k, v in split.items()}
    log(f"train step in an NCCL group of one, {gpu}: medians "
        f"{', '.join(f'{t:.2f}' for t in dist_ms)} ms (CUDA events, "
        f"{DIST_STEPS} steps a run) against the plain step's "
        f"{', '.join(f'{t:.2f}' for t in plain_ms)} ms (runs in turns: "
        f"plain, distributed, distributed, plain) in this phase "
        f"and {train['step_ms']:.2f} ms in phase 8; the flat all-reduce of "
        f"{values:,} values ({values * 4 / 1e6:.1f} MB fp32): device time "
        f"of its range {per['all_reduce']:.3f} ms a step (pack, NCCL, unpack;"
        f" torch.profiler over {DIST_PROFILED} steps), of it NCCL kernels "
        f"{nccl_us / 1e3:.3f} ms; forward {per['forward']:.2f}, backward "
        f"{per['backward']:.2f}, optimizer {per['optimizer']:.2f} ms; "
        f"kernel launches: {launches} (none: no hand-written kernel)")
    return {"run_s": run_s, "dist_ms": dist_ms, "plain_ms": plain_ms,
            "all_reduce_ms": per["all_reduce"], "nccl_ms": nccl_us / 1e3,
            "values": values, "max_diff": diff}


# --------------------------------------------------------- phase 9 ------

HTTP_CLIENTS = 8         # concurrent /search clients
HTTP_PER_CLIENT = 24     # requests each client sends
RERANK_R = 100           # --rerank_window
# Market-1501's test split: 3,368 queries and 15,913 gallery images of 750
# pids (the dense re-ranker at its size); the cut held against the CPU
MARKET = (3368, 15913, 750)
MARKET_CUT = (300, 1500)


# a closed-loop load generator in its own process: CLIENTS threads send
# the JSON bodies of a payload file round robin; prints the wall seconds
# and each request's (status, seconds)
LOAD_CLIENT = r"""
import json, sys, threading, time, urllib.error, urllib.request
port, clients, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
with open(path) as f:
    bodies = [json.dumps(p).encode() for p in json.load(f)]
out = [None] * len(bodies)
url = f"http://127.0.0.1:{port}/search"
def run(c):
    for r in range(c, len(bodies), clients):
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    url, data=bodies[r]), timeout=120) as resp:
                resp.read()
                status = resp.status
        except urllib.error.HTTPError as e:
            status = e.code
        out[r] = (status, time.perf_counter() - t0)
threads = [threading.Thread(target=run, args=(c,)) for c in range(clients)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
print(json.dumps({"wall": time.perf_counter() - t0, "lat": out}))
"""


def _jpeg(img: np.ndarray) -> str:
    import base64

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", quality=95)
    return base64.b64encode(buf.getvalue()).decode()


def _request_rows(r: int) -> list:
    """The image rows of request ``r``: 8 rows from ``r % N_IMAGES`` with an
    odd stride, so no two of the phase's requests carry the same batch."""
    step = 1 + 2 * (r // N_IMAGES)
    return [(r % N_IMAGES + j * step) % N_IMAGES for j in range(REQUEST)]


def _http(port: int, method: str, path: str, obj=None):
    """(status, JSON body, Retry-After) of one request on its own
    connection."""
    import urllib.error
    import urllib.request

    data = None if obj is None else json.dumps(obj).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read()), r.headers.get(
                "Retry-After")
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), e.headers.get("Retry-After")


def _serve_cli(index: str, ckpt: str, *extra):
    """``build_from_args`` as a user starts the server (``python -m
    centroids_reid_tpu_torch.inference.server ...``), on port 0."""
    from centroids_reid_tpu_torch.inference.server import build_from_args

    t0 = time.perf_counter()
    server = build_from_args([
        "--gallery_data", index, "--port", "0", "--topk", "100",
        "--normalize_features", "--batch_window_ms", "2", "--max_batch",
        "64", "--warmup_buckets", "64", *extra, "MODEL.PRETRAIN_PATH", ckpt])
    log(f"server {' '.join(extra) or '(bf16)'}: built in "
        f"{time.perf_counter() - t0:.1f} s (index load, model, gallery on "
        f"the card, warm-up of the 7 buckets 1-64)")
    return server.start_background()


def _clients(port: int, payloads: list, clients: int) -> list:
    """``clients`` threads sending ``payloads`` round robin; returns
    [(status, body, retry_after)] in payload order."""
    import threading

    out = [None] * len(payloads)

    def run(c):
        for r in range(c, len(payloads), clients):
            out[r] = _http(port, "POST", "/search", payloads[r])

    threads = [threading.Thread(target=run, args=(c,))
               for c in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    return out


def _hold(name: str, svc, blobs: list, rows: list, body: dict) -> None:
    """A /search response against ``svc.query_arrays`` on the same decoded
    images (one dispatch of the same bucket): indices equal, distances
    within 1e-5 relative (1e-6 absolute near 0)."""
    d, idx, paths = svc.query_arrays(svc.ingest_bytes(blobs))
    got = body["results"]
    require(len(got) == len(rows), f"{name}: {len(got)} results")
    for i, res in enumerate(got):
        require(res["indices"] == [int(j) for j in idx[i]]
                and res["paths"] == [str(p) for p in paths[i]],
                f"{name}: indices differ from query_arrays")
        require(np.allclose(res["distances"], d[i], rtol=1e-5, atol=1e-6),
                f"{name}: distances differ from query_arrays")


def _same_ranking(vals, idx, ref_idx, tol: float) -> bool:
    """Indices equal wherever neighbouring ascending values differ by more
    than ``tol``; the same set within a run of closer values."""
    for v, i, ri in zip(np.asarray(vals), np.asarray(idx),
                        np.asarray(ref_idx)):
        cuts = np.nonzero(np.diff(v) > tol)[0] + 1
        for a, b in zip(np.split(i, cuts), np.split(ri, cuts)):
            if sorted(a) != sorted(b):
                return False
    return True


def _hold_rerank(name: str, tail: tuple, served_d, served_i,
                 strict_window: bool) -> dict:
    """The served re-ranked top-k of one request against (a) ``_windowed``
    on the window that request's dispatch selected, on the card and on the
    CPU, and (b) ``rerank_topk`` on the card over the same embeddings,
    whose window is the exact fp32 top-r: values within 1e-5 and rankings
    equal wherever the windows hold the same rows (all of them with
    ``strict_window``; bf16 selection can swap a boundary row). ``tail`` is
    the dispatch's recorded ``service._rerank_tail`` call: its embeddings,
    fp32 gallery and windows, and the result it returned."""
    import torch

    from centroids_reid_tpu_torch.ops import rerank_topk
    from centroids_reid_tpu_torch.ops.rerank import _windowed

    (e, gf32, win, k, r, k1, k2, lam, dist), _, (got_d, got_i) = tail
    require(np.allclose(got_d.cpu().numpy(), served_d, rtol=1e-5, atol=1e-6)
            and np.array_equal(got_i.cpu().numpy(), served_i),
            f"{name}: the response is not what its dispatch re-ranked")
    k1 = min(k1, r)
    args = (lam, k1 + 1, k1 // 2 + 1, min(k2, k1 + 1), 32, dist)
    with torch.inference_mode():
        own = _windowed(e, gf32, win, *args)
        rows, local = torch.unique(win, return_inverse=True)
        own_cpu = _windowed(e.float().cpu(), gf32[rows].float().cpu(),
                            local.cpu(), *args)
        ref_d, ref_i = rerank_topk(e, gf32, r=r, k1=k1, k2=k2,
                                   lambda_value=lam, dist=dist)
    win, own, own_cpu = win.cpu().numpy(), own.cpu().numpy(), own_cpu.numpy()
    err_cpu = float(np.abs(own - own_cpu).max())
    require(err_cpu <= 1e-5, f"{name}: _windowed card vs CPU {err_cpu:.3e}")
    ov, oi = (np.sort(own, 1, kind="stable")[:, :k],
              np.argsort(own, 1, kind="stable")[:, :k])
    oi_cpu = np.argsort(own_cpu, 1, kind="stable")[:, :k]
    require(_same_ranking(ov, np.take_along_axis(win, oi, 1),
                          np.take_along_axis(win, oi_cpu, 1), 1e-5),
            f"{name}: _windowed ranks differ, card vs CPU")
    require(np.abs(ov - served_d).max() <= 1e-5
            and _same_ranking(served_d, served_i,
                              np.take_along_axis(win, oi, 1), 1e-5),
            f"{name}: served top-{k} is not the re-rank of its window")
    ref_d, ref_i = ref_d.cpu().numpy(), ref_i.cpu().numpy()
    same = [set(a) == set(b) for a, b in zip(win, ref_i)]
    ref_d, ref_i = ref_d[:, :k], ref_i[:, :k]
    if strict_window:
        require(all(same), f"{name}: a window differs from rerank_topk's")
    require(any(same), f"{name}: no window equals rerank_topk's")
    for q in np.nonzero(same)[0]:
        require(np.abs(served_d[q] - ref_d[q]).max() <= 1e-5
                and _same_ranking(served_d[q:q + 1], served_i[q:q + 1],
                                  ref_i[q:q + 1], 1e-5),
                f"{name}: served top-{k} differs from rerank_topk")
    return {"windows_equal": int(sum(same)), "queries": len(same),
            "cpu_err": err_cpu}


@contextlib.contextmanager
def _recording(owner, name: str):
    """``owner.name`` wrapped for the block: yields the list of ``(args,
    kwargs, result)`` of every call made through it, in order."""
    orig = getattr(owner, name)
    own = name in vars(owner)
    calls = []

    def rec(*args, **kw):
        res = orig(*args, **kw)
        calls.append((args, kw, res))
        return res

    setattr(owner, name, rec)
    try:
        yield calls
    finally:
        if own:
            setattr(owner, name, orig)
        else:
            delattr(owner, name)


def _served(port: int, payloads: list) -> list:
    """The bodies of ``payloads`` sent one after another, with every kernel
    launch count set to 0 just before (read them just after)."""
    import torch

    from centroids_reid_tpu_torch.ops import reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    bodies = []
    for r, payload in enumerate(payloads):
        status, body, _ = _http(port, "POST", "/search", payload)
        require(status == 200, f"/search {r}: {status} {body}")
        bodies.append(body)
    torch.cuda.synchronize()
    return bodies


def _serial(port: int, payloads: list, n: int) -> list:
    lat = []
    for r in range(n):
        t0 = time.perf_counter()
        status, _, _ = _http(port, "POST", "/search",
                             payloads[r % len(payloads)])
        lat.append((time.perf_counter() - t0) * 1e3)
        require(status == 200, f"serial request {r}: {status}")
    return lat


FAST_COSINE = 0.995       # the reference's fast-ingest smoke check
FAST_CPU_TOL = 1e-6       # card against CPU, float64 embeddings (rel. L2)
FAST_CPU_IMAGES = 4


@contextlib.contextmanager
def _pack_without_native_decoder():
    """``TPU.FAST_DECODE`` takes packed YUV420 only where the native decoder
    is built (``inference.utils.serving_ingest_format``, as the reference);
    elsewhere it serves RGB. Where the decoder is missing, this lets the
    packed route run: PIL's decode and the host packing
    (``data.transforms.decode_and_pack_yuv420_bytes``, the decoder's own
    fallback for images it declines) stand in for the native decode."""
    from centroids_reid_tpu_torch import native

    real = native.fast_available
    if not native.available():
        native.fast_available = lambda hw: hw[0] % 2 == 0 and hw[1] % 2 == 0
    try:
        yield
    finally:
        native.fast_available = real


def phase_serve_fast(state: dict, tmp: str, trained: str, eval_root: str,
                     payloads: list, blobs: list, rows: list,
                     gpu: str) -> dict:
    """The fast ingest (``TPU.FAST_DECODE``: packed planar YUV420 on the
    wire, unpacked on the card), cell serve-fast-decode.

    Held: the card's unpack against the CPU's, and the embeddings of
    packed images on the card against the CPU's, in float64 (the CPU tests
    hold both against the JAX package). The reference's smoke quantity,
    the cosine of ``run_inference`` with the flag off and on over one JPEG
    folder, is printed for phase 8's trained checkpoint and for the seeded
    random model (FAST_COSINE is the reference's bar for a trained model
    on photos; the synthetic images' per-pixel chroma noise is what 4:2:0
    removes). The flag selects the packed ingest only where the native
    decoder is built, as the reference; where it is missing, PIL's decode
    and the host pack stand in for it from here on. An index embedded with
    the flag on (``run_inference``, as ``create_embeddings``) over phase
    4's gallery: services at k=10 (K2) and k=100 (K1 + K3), every
    ``query_arrays`` top-1 the image's own row; the share of packed
    queries whose top-1 is their own row of phase 4's RGB index is
    printed. An HTTP front over the flag-on index, each /search held
    against ``query_arrays`` on the same decoded images. Times the packed
    service beside the RGB one (request p50, device busy, bytes to the
    card per request) and /search p50."""
    import base64
    import copy
    import os

    import torch

    from centroids_reid_tpu_torch import native
    from centroids_reid_tpu_torch.data.transforms import (
        ingest_blobs,
        yuv420_to_rgb,
    )
    from centroids_reid_tpu_torch.inference import (
        RetrievalService,
        load_inference_model,
    )
    from centroids_reid_tpu_torch.inference.service import embed_query
    from centroids_reid_tpu_torch.inference.utils import (
        list_images_flat,
        run_inference,
        serving_ingest_format,
    )
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    log("== phase 9b: the fast ingest (TPU.FAST_DECODE, packed YUV420)")
    cfg, model = state["cfg"], state["model"]
    fast = cfg.clone()
    fast.TPU.FAST_DECODE = True
    h, w = cfg.INPUT.SIZE_TEST
    fmt = serving_ingest_format(fast)
    require(fmt == ("yuv420" if native.available() else "rgb"),
            f"TPU.FAST_DECODE selected {fmt}")
    log(f"TPU.FAST_DECODE with the native decoder "
        f"{'built' if native.available() else 'missing'}: the {fmt} ingest, "
        f"as the reference selects"
        + ("" if native.available() else "; below, PIL's decode and the "
           "host pack stand in for the native decoder to drive the packed "
           "route (run_inference, the services, the HTTP front)"))
    folder = os.path.join(tmp, "fast_jpegs")
    os.makedirs(folder)
    jpegs = [base64.b64decode(_jpeg(im)) for im in state["imgs"]]
    for i, data in enumerate(jpegs):
        with open(os.path.join(folder, f"img{i:03d}.jpg"), "wb") as f:
            f.write(data)
    packed = ingest_blobs("yuv420", (h, w), jpegs)
    decoded = ingest_blobs("rgb", (h, w), jpegs)
    x = torch.from_numpy(packed)
    card = yuv420_to_rgb(x.cuda(), (h, w)).cpu()
    cpu = yuv420_to_rgb(x, (h, w))
    err = float((card - cpu).abs().max())
    loss = np.abs(cpu.numpy() - decoded)
    log(f"yuv420_to_rgb of the {len(jpegs)} packed JPEGs: card against CPU "
        f"max |err| {err:.3e} (tol 1e-4); the packing's loss against the "
        f"RGB decode: mean {loss.mean():.3f}, max {loss.max():.1f} levels")
    require(err <= 1e-4, "yuv420_to_rgb on the card differs from the CPU")

    # float64: the random trunk grows fp32 rounding to 1e-2 between cuDNN
    # and the CPU's convs; in float64 that growth stays near 1e-12
    models = {dev: copy.deepcopy(model).to(dev, torch.float64)
              for dev in ("cuda", "cpu")}
    for m in models.values():
        m.mixed_precision = False
    mean, std = cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD
    for name, batch in (("yuv420", packed[:FAST_CPU_IMAGES]),
                        ("rgb", decoded[:FAST_CPU_IMAGES])):
        with torch.inference_mode():
            e = [embed_query(m, torch.from_numpy(batch).to(dev), mean, std,
                             torch.float64, False, (h, w)).cpu()
                 for dev, m in models.items()]
        rel = float(((e[0] - e[1]).norm(dim=1) / e[1].norm(dim=1)).max())
        log(f"float64 embed of {FAST_CPU_IMAGES} {name} images (the unpack "
            f"in fp32), card against CPU: max relative L2 {rel:.3e} (tol "
            f"{FAST_CPU_TOL})")
        require(rel <= FAST_CPU_TOL, f"{name} embed: card differs from CPU")
    del models

    with _pack_without_native_decoder():
        for name, ckpt in (("trained (phase 8)", trained),
                           ("seeded random", cfg.MODEL.PRETRAIN_PATH)):
            c_rgb, c_fast = cfg.clone(), fast.clone()
            c_rgb.MODEL.PRETRAIN_PATH = c_fast.MODEL.PRETRAIN_PATH = ckpt
            m = load_inference_model(c_rgb, "cuda")
            paths = list_images_flat(os.path.join(eval_root, "market1501",
                                                  "bounding_box_test"))
            e_rgb, _ = run_inference(m, c_rgb, paths)
            e_yuv, _ = run_inference(m, c_fast, paths)
            require(e_yuv.dtype == np.float32 and e_yuv.shape == e_rgb.shape
                    and np.isfinite(e_yuv).all(),
                    f"fast ingest: {e_yuv.dtype} {e_yuv.shape}")
            cos = (e_rgb * e_yuv).sum(1) / (
                np.linalg.norm(e_rgb, axis=1) * np.linalg.norm(e_yuv, axis=1))
            log(f"run_inference over {len(paths)} eval JPEGs, {name} model, "
                f"TPU.FAST_DECODE off / on: embedding cosine min "
                f"{cos.min():.6f}, mean {cos.mean():.6f}, share above "
                f"{FAST_COSINE}: {(cos > FAST_COSINE).mean():.4f}")
            del m

        # the index embedded with the flag on, as create_embeddings does
        e_fast, _ = run_inference(model, fast, list_images_flat(folder))
        gallery = state["gallery"].copy()
        gallery[state["rows"]] = e_fast / np.linalg.norm(e_fast, axis=1,
                                                         keepdims=True)
        svcs = {k: RetrievalService(fast, gallery, state["paths"], k=k,
                                    device="cuda", model=model)
                for k in (10, 100)}
        rgb_svc = RetrievalService(cfg, state["gallery"], state["paths"],
                                   k=100, device="cuda", model=model)
        require(svcs[100].ingest_format == "yuv420"
                and np.array_equal(svcs[100].ingest_bytes(jpegs), packed)
                and packed.shape == (len(jpegs), h * w * 3 // 2),
                f"fast ingest: {svcs[100].ingest_format} {packed.shape}")
        torch.cuda.synchronize()
        reset_launch_counts()
        for k, svc in svcs.items():
            for r in range(0, len(jpegs), REQUEST):
                d, idx, _ = svc.query_arrays(packed[r:r + REQUEST])
                require(d.shape == (REQUEST, svc.k) and np.isfinite(d).all()
                        and (idx[:, 0] == state["rows"][r:r + REQUEST]).all(),
                        f"fast ingest k={k}: top-1 is not the image's own row")
        torch.cuda.synchronize()
        launches = launch_counts()
        for name in BF16_KERNELS:
            require(launches[name] > 0, f"fast ingest did not launch {name}")
        log(f"serve-fast-decode, k=10 and k=100: {len(jpegs) // REQUEST} "
            f"requests of {REQUEST} packed images each against the index "
            f"embedded with the flag on, every top-1 the image's own row; "
            f"kernel launches: {launches}")
        share = {}
        for name, batch in (("yuv420", packed), ("rgb", decoded)):
            share[name] = float(np.mean([
                rgb_svc.query_arrays(batch[r:r + REQUEST])[1][:, 0]
                == state["rows"][r:r + REQUEST]
                for r in range(0, len(jpegs), REQUEST)]))
        log(f"against phase 4's index (rows embedded from the images before "
            f"JPEG, RGB): top-1 the image's own row for {share['yuv420']:.4f}"
            f" of the packed JPEG queries, {share['rgb']:.4f} of the "
            f"RGB-decoded ones (printed, not held: the seeded random trunk "
            f"moves with JPEG noise alone)")

        out = {}
        cells = {"rgb": (rgb_svc, decoded[:REQUEST]),
                 "yuv420": (svcs[100], packed[:REQUEST])}
        lat = {name: [] for name in cells}
        for name in ("rgb", "yuv420", "yuv420", "rgb"):
            svc, x = cells[name]
            request_ms(svc, x, 3)
            lat[name] += request_ms(svc, x, 30)
        for name, (svc, x) in cells.items():
            busy = device_busy_ms(lambda: svc.query_arrays(x), 10)
            out[name] = (float(np.percentile(lat[name], 50)), busy, x.nbytes)
        for name, (p50, busy, nb) in out.items():
            log(f"serve-k100, {name} ingest: query_arrays p50 {p50:.4f} ms "
                f"(host clock, 60 requests), device busy "
                + ("not measured" if busy is None else f"{busy:.4f} ms")
                + f" per request (torch.profiler, 10 requests), {nb} bytes to "
                f"the card per {REQUEST}-image request [{gpu}]")
        t = {}
        for name in ("rgb", "yuv420"):
            t0 = time.perf_counter()
            for _ in range(5):
                ingest_blobs(name, (h, w), jpegs)
            t[name] = (time.perf_counter() - t0) / (5 * len(jpegs)) * 1e3
        log(f"host decode of one {h}x{w} JPEG (q95): {t['rgb']:.4f} ms to "
            f"RGB, {t['yuv420']:.4f} ms to packed YUV420 (decoder: "
            f"{'native' if native.available() else 'PIL'}) [{gpu}]")
        del svcs, rgb_svc, cells

        index = os.path.join(tmp, "http_index_fast")
        os.makedirs(index)
        np.save(os.path.join(index, "embeddings.npy"), gallery)
        np.save(os.path.join(index, "paths.npy"), state["paths"])
        server = _serve_cli(index, cfg.MODEL.PRETRAIN_PATH,
                            "TPU.FAST_DECODE", "True")
        svc, port = server.service, server.port
        try:
            status, hz, _ = _http(port, "GET", "/healthz")
            require(status == 200 and hz["ingest"] == "yuv420",
                    f"/healthz: {hz}")
            n = N_IMAGES // REQUEST
            bodies = _served(port, payloads[:n])
            launches = launch_counts()
            for r, body in enumerate(bodies):
                _hold("serve-http-fast", svc, blobs[r], rows[r], body)
                require([res["indices"][0] for res in body["results"]]
                        == [int(state["rows"][i]) for i in rows[r]],
                        "serve-http-fast: top-1 is not the image's own row")
            require(launches["scores"] > 0 and launches["kpass_topk"] > 0,
                    f"serve-http-fast did not launch K1 and K3: {launches}")
            _serial(port, payloads, 5)
            lat = _serial(port, payloads, 60)
            out["http_p50"] = float(np.percentile(lat, 50))
            log(f"serve-http-fast: {n} serial /search requests held against "
                f"query_arrays on the same packed images (/healthz ingest "
                f"yuv420), every top-1 the image's own row; /search p50 "
                f"{out['http_p50']:.4f} ms, p90 "
                f"{np.percentile(lat, 90):.4f} ms "
                f"(60 serial requests; decode: "
                f"{'native' if native.available() else 'PIL, standing in'}"
                f") [{gpu}]")
            _request_parts("serve-http-fast", svc, payloads, out["http_p50"],
                           gpu)
        finally:
            server.shutdown()
        return out


def _request_parts(name: str, svc, payloads: list, p50: float,
                   gpu: str) -> None:
    """The host's share of a serial request, piece by piece: base64 and
    decode (``ingest_bytes``), ``query_arrays``, the response's JSON."""
    import base64

    parts = {"base64 + JPEG decode": [], "query_arrays": [],
             "JSON of the response": []}
    for r in range(20):
        t0 = time.perf_counter()
        dec = svc.ingest_bytes([base64.b64decode(x) for x in
                                payloads[r % len(payloads)]["images_b64"]])
        t1 = time.perf_counter()
        d, idx, paths = svc.query_arrays(dec)
        t2 = time.perf_counter()
        json.dumps({"results": [
            {"paths": [str(p) for p in paths[i]],
             "indices": [int(j) for j in idx[i]],
             "distances": [float(x) for x in d[i]]}
            for i in range(len(dec))]})
        t3 = time.perf_counter()
        for key, dt in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(dt * 1e3)
    log(f"{name}, one {REQUEST}-image request in parts (host clock, p50 of "
        f"20, outside the server): "
        + ", ".join(f"{k} {np.percentile(v, 50):.4f} ms"
                    for k, v in parts.items())
        + f"; the rest of the {p50:.4f} ms p50 is HTTP, the client's JSON "
        f"and the handler [{gpu}]")


def phase_serve_http(state: dict, tmp: str, trained: str,
                     eval_root: str) -> dict:
    """Phase 9, online serving: phase 4's 100,000 x 2048 gallery written as
    a create_embeddings index, served by ``build_from_args`` (ResNet-50
    bf16, k=100, dynamic batching, warm-up of the buckets 1-64), plain,
    with ``--rerank_window 100`` and with ``--int8_gallery --rerank_window
    100``; 8-image JPEG requests over HTTP, serially and from 8 client
    threads; the dense re-ranker at Market-1501's test size. Returns the
    launch counts of the serial requests per server."""
    import base64
    import os

    import torch

    from centroids_reid_tpu_torch.inference import service
    from centroids_reid_tpu_torch.inference.server import RetrievalHTTPServer
    from centroids_reid_tpu_torch.ops import launch_counts

    log("== phase 9: online serving (HTTP /search) and re-ranking")
    gpu = gpu_line()
    ckpt = state["cfg"].MODEL.PRETRAIN_PATH
    index = os.path.join(tmp, "http_index")
    os.makedirs(index)
    t0 = time.perf_counter()
    np.save(os.path.join(index, "embeddings.npy"), state["gallery"])
    np.save(os.path.join(index, "paths.npy"), state["paths"])
    log(f"index {GALLERY_ROWS} x {DIM} written in "
        f"{time.perf_counter() - t0:.1f} s")
    imgs = state["imgs"]
    b64 = [_jpeg(im) for im in imgs]
    rows = [_request_rows(r) for r in range(HTTP_CLIENTS * HTTP_PER_CLIENT)]
    payloads = [{"images_b64": [b64[i] for i in rr]} for rr in rows]
    blobs = [[base64.b64decode(b64[i]) for i in rr] for rr in rows]
    out = {"launches": {}}

    # ---- the plain server: contract, correctness, serial and concurrent
    server = _serve_cli(index, ckpt)
    svc, port = server.service, server.port
    try:
        status, h, _ = _http(port, "GET", "/healthz")
        require(status == 200 and h["status"] == "ok"
                and h["gallery_size"] == GALLERY_ROWS and h["k"] == 100
                and h["model"] == state["cfg"].MODEL.NAME and h["batching"]
                and h["rerank_window"] == 0, f"/healthz: {h}")
        status, body, _ = _http(port, "POST", "/search",
                                {"images_b64": ["!!not base64!!"]})
        require(status == 400 and "base64" in body["error"],
                f"bad base64: {status} {body}")
        n = N_IMAGES // REQUEST
        bodies = _served(port, payloads[:n])
        launches = launch_counts()
        for r, body in enumerate(bodies):
            _hold("serve-http", svc, blobs[r], rows[r], body)
            require([res["indices"][0] for res in body["results"]]
                    == [int(state["rows"][i]) for i in rows[r]],
                    "serve-http: top-1 is not the image's own row")
        out["launches"]["serve-http"] = launches
        require(launches["scores"] > 0 and launches["kpass_topk"] > 0,
                f"serve-http did not launch K1 and K3: {launches}")
        log(f"serve-http: {n} serial /search requests of {REQUEST} JPEGs, "
            f"each held against query_arrays on the same decoded images "
            f"(indices equal, distances within 1e-5 relative); /healthz ok, "
            f"one 400; kernel launches per request: "
            + ", ".join(f"{k} {v / n:g}" for k, v in launches.items())
            + f" [{gpu}]")

        # concurrency 8: the recorded dispatches, each replayed and held
        # against the responses that rode it
        with _recording(svc, "query_arrays") as calls:
            res = _clients(port, payloads, HTTP_CLIENTS)
        seen = [(args[0], d, idx) for args, _, (d, idx, _) in calls]
        for x, d, idx in seen:
            d2, idx2, _ = svc.query_arrays(x)
            require(np.array_equal(idx, idx2) and np.allclose(
                d, d2, rtol=1e-5, atol=1e-6), "a dispatch does not replay")
        keys = [[hash(row.tobytes()) for row in x] for x, _, _ in seen]
        for r, (status, body, _) in enumerate(res):
            require(status == 200, f"concurrent /search {r}: {status}")
            want = [hash(row.tobytes()) for row in svc.ingest_bytes(blobs[r])]
            hit = next(((d[o:o + REQUEST], idx[o:o + REQUEST])
                        for (_, d, idx), key in zip(seen, keys)
                        for o in range(len(key) - REQUEST + 1)
                        if key[o:o + REQUEST] == want), None)
            require(hit is not None, f"request {r} rode no dispatch")
            for i, one in enumerate(body["results"]):
                require(one["indices"] == [int(j) for j in hit[1][i]]
                        and np.allclose(one["distances"], hit[0][i],
                                        rtol=1e-5, atol=1e-6),
                        f"concurrent request {r} differs from its dispatch")
        sizes = [len(x) for x, _, _ in seen]
        log(f"serve-http-c8: {len(res)} requests from {HTTP_CLIENTS} client "
            f"threads coalesced into {len(seen)} dispatches (rows "
            f"{min(sizes)}-{max(sizes)}, all powers of two: "
            f"{all(s & (s - 1) == 0 for s in sizes)}); every dispatch "
            f"replays, every response equals its rows")
        require(all(s & (s - 1) == 0 and s <= 64 for s in sizes),
                "a dispatch is not a power-of-two bucket <= 64")

        # timing: serial p50, then concurrency 8 from a client process of
        # its own (client threads here would share the server's
        # interpreter lock)
        _serial(port, payloads, 5)
        lat = _serial(port, payloads, 60)
        out["serial_p50"] = float(np.percentile(lat, 50))
        log(f"/search p50, serial {REQUEST}-image requests, bf16 k=100 "
            f"(host clock around the HTTP POST, 60 requests): "
            f"{out['serial_p50']:.4f} ms, p90 "
            f"{np.percentile(lat, 90):.4f} ms [{gpu}]")
        load = os.path.join(tmp, "http_payloads.json")
        with open(load, "w") as f:
            json.dump(payloads, f)
        proc = subprocess.run(
            [sys.executable, "-c", LOAD_CLIENT, str(port), str(HTTP_CLIENTS),
             load], capture_output=True, text=True, timeout=600, check=True)
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        require(all(s == 200 for s, _ in got["lat"]), "client process 200s")
        ms, secs = np.array([t for _, t in got["lat"]]) * 1e3, got["wall"]
        log(f"serve-http-c8 (a client process): {len(ms) / secs:.2f} "
            f"requests/s ({len(ms) * REQUEST / secs:.1f} images/s), p50 "
            f"{np.percentile(ms, 50):.4f} ms, p99 "
            f"{np.percentile(ms, 99):.4f} ms at concurrency {HTTP_CLIENTS}, "
            f"closed loop, batching (2 ms window, max 64 rows; {len(ms)} "
            f"requests) [{gpu}]")

        _request_parts("serve-http", svc, payloads, out["serial_p50"], gpu)

        # 429: a second server on the same service with max_pending 1
        shed = RetrievalHTTPServer(svc, port=0, batch_window_ms=2,
                                   max_batch=64, max_pending=1)
        shed.start_background()
        try:
            res = _clients(shed.port, payloads[:32], HTTP_CLIENTS)
        finally:
            shed.shutdown()
        codes = [s for s, _, _ in res]
        retry = {ra for s, _, ra in res if s == 429}
        require(429 in codes and set(codes) <= {200, 429}
                and retry == {"1"}, f"max_pending 1: codes {codes}")
        log(f"max_pending 1 under {HTTP_CLIENTS} clients: "
            f"{codes.count(429)} of {len(codes)} requests shed with 429 "
            f"and Retry-After: 1, the rest 200")
    finally:
        server.shutdown()
    del server, svc
    fast = phase_serve_fast(state, tmp, trained, eval_root, payloads, blobs,
                            rows, gpu)
    log(f"/search p50, serial, bf16 k=100: {out['serial_p50']:.4f} ms RGB "
        f"ingest, {fast['http_p50']:.4f} ms YUV420 ingest [{gpu}]")

    # ---- re-ranking: bf16 and int8 windows of 100, re-ranked on the card
    for name, extra, strict in (
            ("serve-rerank-r100", ("--rerank_window", str(RERANK_R)), False),
            ("int8-rerank-r100", ("--int8_gallery", "--rerank_window",
                                  str(RERANK_R)), True)):
        server = _serve_cli(index, ckpt, *extra)
        svc, port = server.service, server.port
        try:
            status, h, _ = _http(port, "GET", "/healthz")
            require(h["rerank_window"] == RERANK_R, f"/healthz: {h}")
            n = N_IMAGES // REQUEST
            # the served dispatches' own selection and re-rank calls
            sel_name = ("ranked_query_int8" if "int8" in name
                        else "ranked_query")
            with _recording(service, sel_name) as sels, \
                    _recording(service, "_rerank_tail") as tails:
                bodies = _served(port, payloads[:n])
            launches = launch_counts()
            require(len(sels) == n and len(tails) == n,
                    f"{name}: {len(sels)} selections and {len(tails)} "
                    f"re-ranks recorded for {n} requests")
            held = {"windows_equal": 0, "queries": 0, "cpu_err": 0.0}
            for r, body in enumerate(bodies):
                _hold(name, svc, blobs[r], rows[r], body)
                d = np.array([x["distances"] for x in body["results"]],
                             np.float32)
                i = np.array([x["indices"] for x in body["results"]])
                one = _hold_rerank(name, tails[r], d, i, strict)
                held = {k: (max if k == "cpu_err" else sum)(
                    (held[k], one[k])) for k in held}
            out["launches"][name] = launches
            sel = "scores_i8" if "int8" in name else "scores"
            require(launches[sel] > 0 and launches["kpass_topk"] > 0,
                    f"{name} did not launch {sel} and K3: {launches}")
            log(f"{name}: {n} serial requests held against query_arrays, "
                f"against _windowed on their own windows (card vs CPU max "
                f"|err| {held['cpu_err']:.3e}, tol 1e-5) and against "
                f"rerank_topk on the card over the same embeddings where "
                f"the window equals its exact fp32 top-{RERANK_R} "
                f"({held['windows_equal']} of {held['queries']} queries"
                + ("; all required" if strict else "; bf16 selection may "
                   "swap a boundary row") + ")")
            log(f"{name}: kernel launches per request (the {n} serial "
                f"requests alone): "
                + ", ".join(f"{k} {v / n:g}" for k, v in launches.items())
                + f" [{gpu}]")
            if name == "serve-rerank-r100":
                _serial(port, payloads, 5)
                lat = _serial(port, payloads, 60)
                out["rerank_p50"] = float(np.percentile(lat, 50))
                log(f"/search p50, serial {REQUEST}-image requests, bf16 "
                    f"k=100 re-ranked (r=100; host clock, 60 requests): "
                    f"{out['rerank_p50']:.4f} ms, p90 "
                    f"{np.percentile(lat, 90):.4f} ms (not re-ranked: "
                    f"{out['serial_p50']:.4f} ms) [{gpu}]")
            # device busy per request and its split: the first request's
            # recorded selection and re-rank, called again as it called them
            dec = svc.ingest_bytes(blobs[0])
            select, rerank = getattr(service, sel_name), service._rerank_tail
            (s_args, s_kw, _), (t_args, _, _) = sels[0], tails[0]
            with torch.inference_mode():
                total = device_busy_ms(lambda: svc.query_arrays(dec), 10)
                t_sel = device_busy_ms(lambda: select(*s_args, **s_kw), 10)
                t_rr = device_busy_ms(lambda: rerank(*t_args), 10)
            if None in (total, t_sel, t_rr):
                log(f"{name}: device busy not measured (the profiler saw no "
                    f"device time)")
            else:
                log(f"{name}: device busy per request (torch.profiler, 10 "
                    f"requests) {total:.4f} ms: selection + exact re-score "
                    f"{t_sel:.4f} ms, re-rank {t_rr:.4f} ms, embed and "
                    f"copies {total - t_sel - t_rr:.4f} ms [{gpu}]")
                out[f"{name}_busy"] = (total, t_sel, t_rr)
        finally:
            server.shutdown()
        del server, svc
    torch.cuda.empty_cache()
    phase_rerank_market(gpu)
    return out


def op_device_ms(fn) -> tuple:
    """One call of ``fn`` under torch.profiler: (device busy ms, the kernel
    and copy time on the card; [(ATen operator, device ms of the kernels
    it launched itself)], largest first)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / 1e3
    rows = [(e.key, e.self_device_time_total / 1e3) for e in events
            if e.device_type == DeviceType.CPU and e.key.startswith("aten::")
            and e.self_device_time_total > 0]
    return busy, sorted(rows, key=lambda r: -r[1])


def phase_rerank_market(gpu: str) -> None:
    """The dense re-ranker at Market-1501's test size: 3,368 + 15,913
    clustered random unit rows (750 pids), 2048-d, on the card (time, peak
    memory); a 300 + 1,500 cut held against the CPU."""
    import torch

    from centroids_reid_tpu_torch.ops import (
        launch_counts,
        rerank_distmat,
        reset_launch_counts,
    )

    nq, ng, pids = MARKET
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    centers = torch.randn((pids, DIM), generator=gen, device="cuda")
    pid = torch.randint(0, pids, (nq + ng,), generator=gen, device="cuda")
    f = centers[pid] + 0.8 * torch.randn((nq + ng, DIM), generator=gen,
                                         device="cuda")
    f = f / f.norm(dim=1, keepdim=True)
    qf, gf = f[:nq], f[nq:]
    rerank_distmat(qf[:64], gf[:256])   # first use of each kernel shape
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_launch_counts()
    secs = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rerank_distmat(qf, gf)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    require(out.shape == (nq, ng) and bool(torch.isfinite(out).all()),
            "rerank_distmat at Market size: bad output")
    log(f"rerank-dense-market: rerank_distmat [{nq}, {DIM}] x [{ng}, {DIM}] "
        f"(N = {nq + ng}, k1 20, k2 6, lambda 0.3): "
        f"{secs[0]:.3f} / {secs[1]:.3f} s (host clock, synchronized), peak "
        f"{peak:.2f} GiB above the inputs; K3 launches "
        f"{launch_counts()['kpass_topk'] // 2} per call [{gpu}]")
    del out
    busy, ops = op_device_ms(lambda: rerank_distmat(qf, gf))
    log("rerank-dense-market under torch.profiler: " + (
        f"device busy {busy / 1e3:.3f} s (idle share of the unprofiled call "
        f"{1 - busy / 1e3 / secs[1]:.4f}); by operator: "
        + ", ".join(f"{name} {ms:.1f} ms" for name, ms in ops[:8])
        if busy else "device time not measured (the profiler saw none)"))
    cq, cg = MARKET_CUT
    card = rerank_distmat(qf[:cq], gf[:cg]).cpu().numpy()
    cpu = rerank_distmat(qf[:cq].cpu(), gf[:cg].cpu()).numpy()
    err = float(np.abs(card - cpu).max())
    oc, op = (np.argsort(x, 1, kind="stable") for x in (card, cpu))
    same = _same_ranking(np.take_along_axis(card, oc, 1), oc, op, 1e-5)
    log(f"rerank-dense-market cut {cq} + {cg}: card vs CPU max |err| "
        f"{err:.3e} (tol 1e-5), stable ranks equal: {same}")
    require(err <= 1e-5 and same, "rerank_distmat card vs CPU")


# -------------------------------------------------------- phase 11 ------

ARTIFACT_BATCH = 8       # the retriever and int8 artifacts' fixed batch


def _rel_err(a: np.ndarray, b: np.ndarray) -> float:
    """max |a - b| over max |b|."""
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _interleaved_p50(a, b, imgs) -> tuple:
    """Host-clock p50 of ``a.query_arrays`` and ``b.query_arrays`` over
    2 x 30 requests each, in turns a, b, b, a (after 5 of each)."""
    request_ms(a, imgs, 5)
    request_ms(b, imgs, 5)
    a1, b1, b2, a2 = (request_ms(a, imgs, 30), request_ms(b, imgs, 30),
                      request_ms(b, imgs, 30), request_ms(a, imgs, 30))
    return float(np.percentile(a1 + a2, 50)), float(np.percentile(b1 + b2,
                                                                  50))


def _request_launches(svc, imgs, n: int) -> dict:
    """Kernel launches per request of ``n`` requests of ``imgs``."""
    import torch

    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    torch.cuda.synchronize()
    reset_launch_counts()
    for _ in range(n):
        svc.query_arrays(imgs)
    torch.cuda.synchronize()
    return {k: v / n for k, v in launch_counts().items() if v}


def _traced_kernels(svc, imgs) -> dict:
    """{kernel: launches} of K1, K2 and K3 that torch.profiler sees in one
    request (a trace that lost launches is taken again)."""
    tags = (("scores_kernel", "scores"),
            ("stream_topk_partial_kernel", "stream_topk"),
            ("kpass_topk_kernel", "kpass_topk"))

    def complete(per, counts):
        return all(sum(n for k, (_, n) in per.items() if k.startswith(tag))
                   == counts[c] for tag, c in tags)

    per, _ = kernel_device_us(lambda: svc.query_arrays(imgs),
                              complete=complete)
    return {k: n for k, (_, n) in per.items()
            if k.startswith(("scores", "stream_topk", "kpass_topk"))}


def phase_artifacts(state: dict, int8_state: dict, tmp: str) -> None:
    """Phase 11, serving artifacts (``inference/export.py``) of phase 4's
    model: the bf16 embedder (symbolic batch; programs for the card and
    the CPU), bf16 retrievers of the 100,000 x 2048 gallery at k = 100 and
    k = 10 (batch 8), the int8 embedder of phase 4b's fused engine, each
    held against the live path it was exported from, and the HTTP front
    over ``--artifact`` beside phase 9's over ``--gallery_data``."""
    import copy
    import os

    import torch

    from centroids_reid_tpu_torch.inference import RetrievalService
    from centroids_reid_tpu_torch.inference import export as X
    from centroids_reid_tpu_torch.inference.server import build_from_args
    from centroids_reid_tpu_torch.inference.service import embed_query
    from centroids_reid_tpu_torch.ops import int8_conv as C
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    log("== phase 11: serving artifacts (torch.export)")
    gpu = gpu_line()
    cfg, model, imgs = state["cfg"], state["model"], state["imgs"]
    mean, std = cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD

    def save(name, blobs, meta, aux=b""):
        path = os.path.join(tmp, name)
        X.save_artifact(path, blobs, meta, aux=aux)
        log(f"{name}: export seconds by device type "
            + ", ".join(f"{p} {s:.2f}" for p, s in
                        meta["export_seconds"].items())
            + f"; file {os.path.getsize(path)} bytes (programs "
            + ", ".join(f"{p} {len(b)}" for p, b in blobs.items())
            + f", aux {len(aux)}) [{gpu}]")
        return path

    def load(what, *args, **kw):
        t0 = time.perf_counter()
        out = what(*args, **kw)
        torch.cuda.synchronize()
        log(f"  loaded onto {args[1]} in {time.perf_counter() - t0:.2f} s")
        return out

    # ---- the bf16 embedder: the card's program, then the CPU's
    blobs, meta = X.export_embedder(model, cfg)
    require(meta["platforms"] == ["cuda", "cpu"], f"platforms {meta}")
    path = save("embedder.crt", blobs, meta)
    emb = load(X.load_embedder, path, "cuda")
    got = emb.embed(imgs)
    with torch.inference_mode():
        live = embed_query(model, torch.from_numpy(imgs).cuda(), mean, std,
                           torch.bfloat16, normalize=True).cpu().numpy()
    err = _rel_err(got, live)
    log(f"embedder on the card, {N_IMAGES} images: max |diff| / max |live| "
        f"{err:.3e} against embed_query (tol 1e-5), bit-identical "
        f"{np.array_equal(got, live)}")
    require(err <= 1e-5, "the card's artifact embed differs from the live")
    cpu_model = copy.deepcopy(model).cpu()
    emb_cpu = load(X.load_embedder, path, "cpu")
    got = emb_cpu.embed(imgs[:REQUEST])
    with torch.inference_mode():
        live = embed_query(cpu_model, torch.from_numpy(imgs[:REQUEST]), mean,
                           std, torch.bfloat16, normalize=True).numpy()
    err = _rel_err(got, live)
    log(f"embedder on the CPU, {REQUEST} images: max |diff| / max |live| "
        f"{err:.3e} against embed_query on the CPU (tol 1e-5)")
    require(np.isfinite(got).all() and err <= 1e-5,
            "the CPU's artifact embed differs from the live")
    del cpu_model, emb_cpu
    x = torch.from_numpy(_images(256, SEED + 2)).cuda()
    with torch.inference_mode():
        def art():
            emb.program(x)

        def lv():
            embed_query(model, x, mean, std, torch.bfloat16, normalize=True)

        l1, a1, a2, l2 = cuda_ms(lv, 10), cuda_ms(art, 10), cuda_ms(art, 10), \
            cuda_ms(lv, 10)
    log(f"embed ResNet-50 256x128 bf16, batch 256 (CUDA events, in turns): "
        f"artifact {a1:.3f}/{a2:.3f} ms = {512e3 / (a1 + a2):.1f} images/s, "
        f"live embed_query {l1:.3f}/{l2:.3f} ms = {512e3 / (l1 + l2):.1f} "
        f"images/s [{gpu}]")
    del emb, x

    # ---- bf16 retrievers: k = 100 (card and CPU programs), k = 10
    gallery, paths, rows = state["gallery"], state["paths"], state["rows"]
    blobs, meta, aux = X.export_retriever(model, cfg, gallery, paths, k=100,
                                          batch_size=ARTIFACT_BATCH)
    ret_path = save("retriever_k100.crt", blobs, meta, aux)
    blobs, meta, aux = X.export_retriever(model, cfg, gallery, paths, k=10,
                                          batch_size=ARTIFACT_BATCH,
                                          platforms=("cuda",))
    k10_path = save("retriever_k10.crt", blobs, meta, aux)
    del blobs, aux
    live_rr = RetrievalService(cfg, gallery, paths, k=100, device="cuda",
                               model=model, rerank_window=100)
    cells = {
        "artifact-k100": (load(X.load_retriever, ret_path, "cuda"),
                          state["services"][100]),
        "artifact-k10": (load(X.load_retriever, k10_path, "cuda"),
                         state["services"][10]),
        "artifact-k100-rerank-r100": (
            load(X.load_retriever, ret_path, "cuda", rerank_window=100),
            live_rr),
    }
    for name, (ret, svc) in cells.items():
        require(ret._gf.dtype == torch.bfloat16, f"{name}: not bf16")
        worst = 0.0
        for r in range(N_IMAGES // REQUEST):
            q = imgs[r * REQUEST:(r + 1) * REQUEST]
            d, i, p = ret.query_arrays(q)
            sd, si, sp = svc.query_arrays(q)
            require(np.array_equal(i, si) and np.array_equal(p, sp),
                    f"{name}: indices differ from the live service")
            require(np.allclose(d, sd, rtol=1e-5, atol=1e-6),
                    f"{name}: distances differ from the live service")
            worst = max(worst, float(np.abs(d - sd).max()))
            if "rerank" not in name:
                require((i[:, 0] == rows[r * REQUEST:(r + 1) * REQUEST]
                         ).all(), f"{name}: top-1 is not the own row")
        q = imgs[:REQUEST]
        mine, theirs = (_request_launches(ret, q, 4),
                        _request_launches(svc, q, 4))
        require(mine == theirs and mine, f"{name}: launches per request "
                f"{mine}, live {theirs}")
        traced = (_traced_kernels(ret, q), _traced_kernels(svc, q))
        require(traced[0] == traced[1], f"{name}: traced {traced}")
        log(f"{name}: {N_IMAGES // REQUEST} requests x {REQUEST} images "
            f"equal the live service (indices; distances max |diff| "
            f"{worst:.3e}, tol 1e-5 relative)"
            + ("" if "rerank" in name else ", top-1 the own row")
            + f"; kernel launches per request {mine} (live {theirs}); "
            f"torch.profiler per request {traced[0]} (live {traced[1]})")
    for name in ("artifact-k10", "artifact-k100"):
        ret, svc = cells[name]
        a, b = _interleaved_p50(ret, svc, imgs[:REQUEST])
        log(f"{name}: query_arrays p50 {a:.4f} ms, live service {b:.4f} ms "
            f"({REQUEST} images, host clock, 2 x 30 requests each, in "
            f"turns) [{gpu}]")
    ret100 = cells["artifact-k100"][0]
    del cells, live_rr

    # ---- the int8 embedder of the fused engine (K5 / K6 as operators)
    qfn = int8_state["qfn"]
    blobs, meta = X.export_embedder(model, cfg, batch_size=ARTIFACT_BATCH,
                                    platforms=("cuda",), int8_qfn=qfn)
    path = save("int8.crt", blobs, meta)
    emb8 = load(X.load_embedder, path, "cuda")
    got = emb8.embed(imgs)
    with torch.inference_mode():
        # normalised a batch at a time, as the artifact does: the norm's
        # reduction rounds by the number of rows
        live = torch.cat([e / e.norm(dim=1, keepdim=True).clamp_min(1e-12)
                          for e in (qfn(imgs[s:s + ARTIFACT_BATCH])
                                    for s in range(0, N_IMAGES,
                                                   ARTIFACT_BATCH))])
        live = live.cpu().numpy()
    err = _rel_err(got, live)
    log(f"int8 embedder, {N_IMAGES} images: max |diff| / max |live| "
        f"{err:.3e} against the live QuantizedEmbed (tol 1e-6), "
        f"bit-identical {np.array_equal(got, live)}")
    require(err <= 1e-6, "the int8 artifact differs from the live qfn")
    q = imgs[:ARTIFACT_BATCH]
    torch.cuda.synchronize()
    reset_launch_counts()
    emb8.embed(q)
    torch.cuda.synchronize()
    mine = launch_counts()
    reset_launch_counts()
    with torch.inference_mode():
        qfn(q)
    torch.cuda.synchronize()
    theirs = launch_counts()
    pair = ("matmul_requant", "conv3x3_requant")
    require([mine[k] for k in pair] == [theirs[k] for k in pair] == [36, 14],
            f"int8 artifact K5/K6 launches {mine}, live {theirs}")
    log(f"int8 embedder, one call of {ARTIFACT_BATCH} images: K5 "
        f"{mine['matmul_requant']} and K6 {mine['conv3x3_requant']} "
        f"launches, as the live engine's ({theirs['matmul_requant']}, "
        f"{theirs['conv3x3_requant']}); phase 3b held both operators "
        f"against their plain versions")
    # the host cost of one launch through the operator, and of the
    # operator's body called directly (the route before the operator), at
    # a layer-1 K5 shape and layer 4's K6 shape of a batch-8 call
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x5, w5, s5, b5, _, _ = requant_inputs(gen, 16384, 256, 64)
    x6, w6, s6, b6, _, _ = requant_inputs(gen, 8 * 16 * 8, 9 * 512, 512)
    x6 = x6[:, :512].reshape(8, 16, 8, 512).contiguous()
    w6 = w6.reshape(3, 3, 512, 512)
    p5, p6 = C.pack_weight(w5), C.pack_weight(w6)
    routes = {
        "matmul_requant": (
            lambda: C.matmul_requant(x5, w5, s5, b5, w_packed=p5),
            lambda: C._matmul_requant_impl(x5, w5, s5, b5, None, None, True,
                                           p5)),
        "conv3x3_requant": (
            lambda: C.conv3x3_requant(x6, w6, s6, b6, w_packed=p6),
            lambda: C._conv3x3_requant_impl(x6, w6, s6, b6, None, None,
                                            True, p6)),
    }
    for name, (op, body) in routes.items():
        with torch.inference_mode():
            b1, o1, o2, b2 = (host_us_per_launch(body),
                              host_us_per_launch(op), host_us_per_launch(op),
                              host_us_per_launch(body))
        log(f"{name}: host {(o1 + o2) / 2:.2f} us per launch through "
            f"torch.ops.crt ({o1:.2f}/{o2:.2f}), {(b1 + b2) / 2:.2f} us "
            f"calling the operator's body directly ({b1:.2f}/{b2:.2f}; the "
            f"route before the operator), inference mode, 50 calls each "
            f"[{gpu}]")
    del emb8

    # ---- the HTTP front over --artifact
    import base64

    b64 = [_jpeg(im) for im in imgs]
    n = N_IMAGES // REQUEST
    reqs = [_request_rows(r) for r in range(n)]
    payloads = [{"images_b64": [b64[i] for i in rr]} for rr in reqs]
    blobs = [[base64.b64decode(b64[i]) for i in rr] for rr in reqs]
    t0 = time.perf_counter()
    server = build_from_args([
        "--artifact", ret_path, "--port", "0", "--batch_window_ms", "2",
        "--max_batch", "64", "--warmup_buckets", "64"]).start_background()
    log(f"server --artifact: built in {time.perf_counter() - t0:.1f} s "
        f"(artifact load, gallery on the card, warm-up of the buckets "
        f"1-64)")
    try:
        svc, port = server.service, server.port
        status, h, _ = _http(port, "GET", "/healthz")
        require(status == 200 and h["gallery_size"] == GALLERY_ROWS
                and h["k"] == 100 and h["model"] == cfg.MODEL.NAME,
                f"/healthz: {h}")
        bodies = _served(port, payloads)
        launches = launch_counts()
        for r, body in enumerate(bodies):
            _hold("artifact-http", svc, blobs[r], reqs[r], body)
        require(launches["scores"] > 0 and launches["kpass_topk"] > 0,
                f"artifact-http did not launch K1 and K3: {launches}")
        log(f"artifact-http: {n} serial /search requests of {REQUEST} JPEGs, "
            f"each equal to query_arrays on the same decoded images; kernel "
            f"launches per request "
            + ", ".join(f"{k} {v / n:g}" for k, v in launches.items() if v))
        # serial p50 beside the --gallery_data server of the same model and
        # gallery (phase 9's index), in turns
        indexed = _serve_cli(os.path.join(tmp, "http_index"),
                             cfg.MODEL.PRETRAIN_PATH)
        try:
            ports = {"--artifact": port, "--gallery_data": indexed.port}
            lat = {name: [] for name in ports}
            for name in ports:
                _serial(ports[name], payloads, 5)
            for name in ("--gallery_data", "--artifact", "--artifact",
                         "--gallery_data"):
                lat[name] += _serial(ports[name], payloads, 30)
        finally:
            indexed.shutdown()
        log(f"/search p50, serial {REQUEST}-image requests, bf16 k=100 "
            f"(host clock, 2 x 30 requests each, in turns): "
            + ", ".join(f"{name} {np.percentile(v, 50):.4f} ms (p90 "
                        f"{np.percentile(v, 90):.4f})"
                        for name, v in lat.items()) + f" [{gpu}]")
    finally:
        server.shutdown()
    del server, ret100
    torch.cuda.empty_cache()


# -------------------------------------------------------- phase 10 ------

# eval-stream-market500k: Market-1501's test split (3,368 queries, 15,913
# gallery rows of 750 pids, 6 cameras) plus its published 500,000
# distractors, one pid that no query holds: 1.74e9 query x gallery cells
DISTRACTORS = 500_000
STREAM_CAMS = 6
STREAM_HELD_Q = 256            # queries held against the materialising path
STREAM_CUT = (300, 20_000)     # queries x gallery rows held against the CPU
STREAM_R = 100                 # windowed re-ranking: r, k1 20, k2 6, 0.3


def _metrics_equal(a, b, tol: float = 1e-6) -> bool:
    """The reference's ``_assert_same``: mAP, CMC, top-k and each query's
    AP within ``tol``, the same query ids."""
    return (abs(a.mAP - b.mAP) <= tol
            and np.allclose(a.cmc, b.cmc, rtol=0, atol=tol)
            and np.allclose(a.all_topk, b.all_topk, rtol=0, atol=tol)
            and np.array_equal(a.single_performance[:, 0],
                               b.single_performance[:, 0])
            and np.allclose(a.single_performance[:, 2],
                            b.single_performance[:, 2], rtol=0, atol=tol))


def _materialised_ranks(qf, gf, sr, q_pids, g_pids, q_cams, g_cams):
    """Each hit of ``sr.pos`` ranked among the kept entries of the stable
    argsort of the materialising path's distance matrix, on the card."""
    import torch

    from centroids_reid_tpu_torch.metrics.r1_map import compute_distmat_device

    order = torch.argsort(compute_distmat_device(qf, gf), dim=1, stable=True)
    gp = torch.as_tensor(g_pids, device=qf.device)[order]
    gc = torch.as_tensor(g_cams, device=qf.device)[order]
    qp = torch.as_tensor(q_pids, device=qf.device)[:, None]
    qc = torch.as_tensor(q_cams, device=qf.device)[:, None]
    kept = torch.cumsum(~((gp == qp) & (gc == qc)), dim=1) - 1
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(order.shape[1], device=qf.device).expand_as(
            order).contiguous())
    pos = torch.as_tensor(sr.pos.astype(np.int64), device=qf.device)
    at = torch.gather(inv, 1, pos.clamp_min(0))
    return torch.gather(kept, 1, at).cpu().numpy()


def _stream_cell():
    """eval-stream-market500k's features on the card (unit rows; pids and
    cameras on the host): (f, pids, cams, the generator), queries first."""
    import torch

    nq, ng, pids = MARKET
    n_all = nq + ng + DISTRACTORS
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    centers = torch.randn((pids, DIM), generator=gen, device="cuda")
    pid = torch.randint(0, pids, (nq + ng,), generator=gen, device="cuda")
    near = torch.randint(0, pids, (DISTRACTORS,), generator=gen,
                         device="cuda")
    # distractors lie around the identities' centres, further out than
    # their own images (noise 1.0 against 0.8): hard negatives
    f = torch.cat([centers[pid] + 0.8 * torch.randn(
        (nq + ng, DIM), generator=gen, device="cuda"),
        centers[near] + 1.0 * torch.randn((DISTRACTORS, DIM), generator=gen,
                                           device="cuda")])
    f /= f.norm(dim=1, keepdim=True)
    pids_all = np.concatenate([pid.cpu().numpy(),
                               np.full(DISTRACTORS, pids, np.int64)])
    cams = torch.randint(0, STREAM_CAMS, (n_all,), generator=gen,
                         device="cuda").cpu().numpy()
    return f, pids_all, cams, gen


def _measured(name: str, fn, gpu: str):
    """``fn()`` timed on the host clock up to a synchronize, with its peak
    device memory above what was allocated before: (result, s, GiB)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    log(f"{name}: {secs:.3f} s (host clock, synchronized), peak "
        f"{peak:.2f} GiB above the inputs [{gpu}]")
    return res, secs, peak


def _k7_ranks(extract, count, qf, gf, q_pids, g_pids, q_cams, g_cams):
    """(dpos, ranks) of the whole cell, plain euclidean evaluation, through
    ``extract`` and ``count``: K7's two wrappers or their plain versions,
    the steps between them as ``compute_stream_ranks`` takes them."""
    import torch

    from centroids_reid_tpu_torch.metrics import streaming_eval as S
    from centroids_reid_tpu_torch.ops.stream_rank import (
        order_key,
        prepare_rows,
    )

    dev = qf.device
    pos = S._positives_table(q_pids, g_pids, q_cams, g_cams, False)
    rel = torch.as_tensor((pos >= 0).sum(axis=1).astype(np.int32),
                          device=dev)
    pos = torch.as_tensor(pos.astype(np.int64), device=dev)
    ints = [torch.as_tensor(np.asarray(x, np.int64), device=dev)
            for x in (q_pids, g_pids, q_cams, g_cams)]
    rows = (qf, prepare_rows(qf, "euclidean"), gf,
            prepare_rows(gf, "euclidean"), *ints)
    tail = (0, "euclidean", False, S._G_CHUNK)
    dpos = extract(*rows, pos, rel, *tail)
    real = pos >= 0
    keys, order = torch.where(real, order_key(dpos, pos),
                              S._NEVER).sort(dim=1)
    hist = count(*rows, keys, rel, *tail)
    ranks = torch.zeros_like(hist).scatter_(
        1, order, hist.cumsum(dim=1, dtype=torch.int32))
    return dpos, torch.where(real, ranks, 0), (rows, pos, keys, rel, tail)


def phase_k7(f, pids_all, cams, gpu: str) -> dict:
    """K7's two wrappers against their plain versions at the cell's shape
    ([3368,2048] x [515913,2048] fp32, H 64): on the cell's features the
    plain versions' cuBLAS tiles sum in another order, so the distances
    differ by rounding and the APs are held within 1e-6; on the features
    scaled by 64 and rounded to integers every fp32 value is an exact
    integer, so the distances are held bit for bit and the ranks exactly.
    Then each wrapper timed (CUDA events) beside its plain version, its
    bound and cuBLAS's fp32 GEMM of the same operands, and the host's
    positives table at the cell's labels (host clock). Returns {"errs",
    "times"} for the kernels line."""
    import torch

    from centroids_reid_tpu_torch.metrics.streaming_eval import (
        StreamRanks,
        _hrank_lexsort,
        _metrics_from_ranks,
        _positives_table,
    )
    from centroids_reid_tpu_torch.ops import stream_rank as K7

    nq = MARKET[0]
    args = (pids_all[:nq], pids_all[nq:], cams[:nq], cams[nq:])
    kern = (K7.stream_extract, K7.stream_count)
    plain = (K7.stream_extract_plain, K7.stream_count_plain)

    def metrics(dpos, ranks, pos):
        sr = StreamRanks(pos.cpu().numpy(), dpos.cpu().numpy(),
                         ranks.cpu().numpy(),
                         (pos >= 0).sum(dim=1).cpu().numpy())
        return _metrics_from_ranks(sr.pos, sr.ranks,
                                   _hrank_lexsort(sr.pos, sr.dpos),
                                   sr.num_rel, args[0], 50)

    errs = {}
    for kind, x in (("the cell's features", f),
                    ("the cell's features x 64, rounded", torch.round(
                        f * 64))):
        qf, gf = x[:nq], x[nq:]
        dk, rk, (_, pos, _, _, _) = _k7_ranks(*kern, qf, gf, *args)
        dp, rp, _ = _k7_ranks(*plain, qf, gf, *args)
        valid = pos >= 0
        d_err = (dk - dp).abs().max().item()
        r_err = (rk - rp).abs().max().item()
        differ = int((rk != rp)[valid].sum())
        if kind.endswith("rounded"):
            require(torch.equal(dk.view(torch.int32), dp.view(torch.int32))
                    and torch.equal(rk, rp),
                    f"K7 on integer features: |dpos diff| {d_err}, "
                    f"{differ} ranks differ")
        else:
            errs = {"stream_extract": d_err, "stream_count": float(r_err)}
            mk, mp = metrics(dk, rk, pos), metrics(dp, rp, pos)
            require(_metrics_equal(mk, mp),
                    f"K7's APs differ from the plain versions' ({kind})")
        log(f"K7 against its plain versions on {kind} ({nq} x "
            f"{gf.shape[0]}, H {pos.shape[1]}): max |dpos diff| "
            f"{d_err:.3e}, {differ} of {int(valid.sum())} hit ranks differ "
            f"(max by {r_err})")
    del x, dk, dp, rk, rp

    qf, gf = f[:nq], f[nq:]
    _, _, (rows, pos, keys, rel, tail) = _k7_ranks(*kern, qf, gf, *args)
    ops = 2.0 * qf.shape[0] * gf.shape[0] * DIM
    ints = nbytes(*rows) + nbytes(rel)
    lib_ms = cuda_ms(lambda: torch.mm(qf, gf.T), iters=3, warmup=1)
    times = {}
    for name, k, p, hits in (("stream_extract", kern[0], plain[0], pos),
                             ("stream_count", kern[1], plain[1], keys)):
        k_ms = cuda_ms(lambda: k(*rows, hits, rel, *tail), iters=5,
                       warmup=1)
        p_ms = cuda_ms(lambda: p(*rows, hits, rel, *tail), iters=1,
                       warmup=0)
        # the [Q, H] output, 4 bytes a slot, written once
        b_ms, b_by = bound(name, ints + nbytes(hits) + 4 * hits.numel(),
                           ops, "fp32")
        times[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        log(f"{name} [{qf.shape[0]},{DIM}] x [{gf.shape[0]},{DIM}] fp32: "
            f"{k_ms:.2f} ms ({ops / k_ms / 1e9:.1f} TFLOP/s, {b_ms / k_ms:.3f}"
            f" of its bound {b_ms:.1f} ms), plain version {p_ms:.1f} ms, "
            f"cuBLAS fp32 GEMM (torch.mm, TF32 off) {lib_ms:.2f} ms [{gpu}]")
    table_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        _positives_table(*args, False)
        table_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"_positives_table at the cell's labels ({nq} x {len(args[1])}) "
        "on the host clock: " + ", ".join(f"{ms:.2f}" for ms in table_ms)
        + f" ms in 5 calls, beside extract "
        f"{times['stream_extract']['ms']:.2f} ms and count "
        f"{times['stream_count']['ms']:.2f} ms (CUDA events) [{gpu}]")
    return {"errs": errs, "times": times}


def phase_eval_stream(gpu: str) -> dict:
    """Phase 10, cell eval-stream-market500k: ``R1mAP`` on Market-1501's test
    split with 500,000 distractors switches to the streaming evaluator by
    itself. Held: the first STREAM_HELD_Q queries against the card's
    materialising path (AP and first ranks; the hit ranks that differ are
    counted), ``streaming=True`` against ``False`` on the rows without the
    distractors, the card against the CPU on a cut, and windowed re-ranked
    evaluation (r = 100) on the whole cell, on a cut against ``eval_func``
    on the explicitly stitched order (its windows selected by K3's plain
    version). K3 runs the windows' selection and their ranks; at each of
    its shapes it is held exactly against its plain version and timed by
    graph replay. Returns the whole cell's (seconds, peak GiB), plain and
    re-ranked."""
    import torch

    from centroids_reid_tpu_torch.metrics import (
        R1mAP,
        compute_stream_ranks,
        eval_func,
        eval_func_streaming,
        eval_func_streaming_reranked,
        r1_map,
    )
    from centroids_reid_tpu_torch.metrics.r1_map import compute_distmat_device
    from centroids_reid_tpu_torch.ops import (
        kpass_topk,
        launch_counts,
        rerank_topk,
        reset_launch_counts,
        retrieval,
    )

    log("== phase 10: evaluation at any gallery scale (eval-stream-"
        "market500k)")
    nq, ng, _ = MARKET
    n_all = nq + ng + DISTRACTORS
    f, pids_all, cams, gen = _stream_cell()
    qf, gf = f[:nq], f[nq:]
    q_pids, g_pids, q_cams, g_cams = (pids_all[:nq], pids_all[nq:],
                                      cams[:nq], cams[nq:])
    torch.cuda.synchronize()
    log(f"{nq} queries, {ng} + {DISTRACTORS} gallery rows x {DIM} on the "
        f"card: {nq * (n_all - nq):.3e} cells (the streaming switch: "
        f"{r1_map._STREAMING_CELLS:.3e})")

    measured = {}

    def run(name, fn):
        res, secs, peak = _measured(name, fn, gpu)
        measured[name] = (secs, peak)
        return res

    # the whole cell through the user's entry point: R1mAP streams
    calls = []
    real = r1_map.eval_func_streaming
    r1_map.eval_func_streaming = lambda *a, **k: calls.append(1) or real(
        *a, **k)
    try:
        ev = R1mAP(nq)
        torch.cuda.synchronize()
        reset_launch_counts()
        m = run("R1mAP.compute, the whole cell (streaming by itself)",
                lambda: ev.compute(f, pids_all, cams))
        k7_launches = {n: launch_counts()[n] for n in K7_KERNELS}
    finally:
        r1_map.eval_func_streaming = real
    require(calls == [1], "R1mAP did not switch to the streaming evaluator")
    require(k7_launches == {"stream_extract": 1, "stream_count": 1},
            f"K7 launches in the whole cell's evaluation: {k7_launches}")
    log(f"K7 launches in the whole cell's evaluation: {k7_launches}")
    require(np.isfinite(m.mAP) and 0 < m.mAP <= 1
            and len(m.single_performance) == nq, f"whole cell: {m.mAP}")
    log(f"eval-stream-market500k: mAP {m.mAP:.6f}, R1 {m.all_topk[0]:.6f}, "
        f"R5 {m.all_topk[1]:.6f}, R10 {m.all_topk[2]:.6f}")

    # the two passes alone: wall, then the card's busy time by operator
    args = (q_pids, g_pids, q_cams, g_cams)
    run("compute_stream_ranks, the whole cell",
        lambda: compute_stream_ranks(qf, gf, *args))
    t0 = time.perf_counter()
    compute_stream_ranks(qf, gf, *args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    busy, ops = op_device_ms(lambda: compute_stream_ranks(qf, gf, *args))
    log("compute_stream_ranks under torch.profiler: " + (
        f"device busy {busy:.1f} ms of the unprofiled call's {wall * 1e3:.1f}"
        f" ms (idle share {1 - busy / (wall * 1e3):.4f}); by operator: "
        + ", ".join(f"{name} {ms:.1f} ms" for name, ms in ops[:8])
        if busy else "device time not measured (the profiler saw none)")
        + f" [{gpu}]")

    # the first queries against the card's materialising path (1.3e8 cells)
    hq = STREAM_HELD_Q
    args = (q_pids[:hq], g_pids, q_cams[:hq], g_cams)
    m_s = run(f"eval_func_streaming, {hq} queries",
              lambda: eval_func_streaming(qf[:hq], gf, *args))
    m_m = run(f"R1mAP(streaming=False), {hq} queries",
              lambda: R1mAP(hq, feat_norm=False, streaming=False).compute(
                  torch.cat([qf[:hq], gf]),
                  np.concatenate([q_pids[:hq], g_pids]),
                  np.concatenate([q_cams[:hq], g_cams])))
    sr = compute_stream_ranks(qf[:hq], gf, *args)
    mat = _materialised_ranks(qf[:hq], gf, sr, *args)
    valid = sr.pos >= 0
    differ = int((sr.ranks != mat)[valid].sum())
    first_s = np.where(valid, sr.ranks, 1 << 30).min(1)
    first_m = np.where(valid, mat, 1 << 30).min(1)
    ap_diff = np.abs(m_s.single_performance[:, 2]
                     - m_m.single_performance[:, 2]).max()
    log(f"{hq} queries x {len(g_pids)} rows ({hq * len(g_pids):.3e} cells): "
        f"streaming against materialising: mAP {m_s.mAP:.6f} / "
        f"{m_m.mAP:.6f}, max |AP diff| {ap_diff:.3e}"
        f" (tol 1e-6), first ranks equal {np.array_equal(first_s, first_m)}"
        f", {differ} of {int(valid.sum())} hit ranks differ")
    require(_metrics_equal(m_s, m_m) and np.array_equal(first_s, first_m),
            "streaming differs from the materialising path")

    # streaming=True against False without the distractors
    fm = f[:nq + ng]
    m_t = run("R1mAP(streaming=True), Market size",
              lambda: R1mAP(nq, streaming=True).compute(
                  fm, pids_all[:nq + ng], cams[:nq + ng]))
    m_f = run("R1mAP(streaming=False), Market size",
              lambda: R1mAP(nq, streaming=False).compute(
                  fm, pids_all[:nq + ng], cams[:nq + ng]))
    log(f"Market size ({nq} x {ng}): streaming=True mAP {m_t.mAP:.6f}, "
        f"False {m_f.mAP:.6f}, equal within 1e-6: "
        f"{_metrics_equal(m_t, m_f)}")
    require(_metrics_equal(m_t, m_f), "streaming=True differs from False")

    # the card against the CPU on a cut
    cq, cg = STREAM_CUT
    cut = (q_pids[:cq], g_pids[:cg], q_cams[:cq], g_cams[:cg])
    m_card = eval_func_streaming(qf[:cq], gf[:cg], *cut)
    m_cpu = run(f"eval_func_streaming on the CPU, {cq} x {cg}",
                lambda: eval_func_streaming(qf[:cq].cpu(), gf[:cg].cpu(),
                                            *cut, device="cpu"))
    r_card = compute_stream_ranks(qf[:cq], gf[:cg], *cut)
    r_cpu = compute_stream_ranks(qf[:cq].cpu(), gf[:cg].cpu(), *cut,
                                 device="cpu")
    differ = int((r_card.ranks != r_cpu.ranks)[r_card.pos >= 0].sum())
    log(f"cut {cq} x {cg}: card mAP {m_card.mAP:.6f}, CPU {m_cpu.mAP:.6f}, "
        f"equal within 1e-6: {_metrics_equal(m_card, m_cpu)}; {differ} hit "
        f"ranks differ")
    require(_metrics_equal(m_card, m_cpu), "card streaming differs from CPU")

    # windowed re-ranking on the whole cell, K3 shapes recorded with the
    # first input K3 took at each
    shapes, inputs = {}, {}
    real_k3 = retrieval.kpass_topk

    def k3(x, k):
        key = (x.shape[0], x.shape[1], k)
        shapes[key] = shapes.get(key, 0) + 1
        if key not in inputs:
            inputs[key] = x.clone()
        return real_k3(x, k)

    retrieval.kpass_topk = k3
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        m_r = run(f"R1mAP(rerank=True, rerank_window={STREAM_R}), the whole "
                  f"cell", lambda: R1mAP(nq, rerank=True,
                                         rerank_window=STREAM_R).compute(
                      f, pids_all, cams))
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        retrieval.kpass_topk = real_k3
    require(np.isfinite(m_r.mAP) and launches["kpass_topk"] > 0,
            f"windowed re-ranked evaluation: {m_r.mAP}, {launches}")
    log(f"eval-stream-market500k re-ranked (r={STREAM_R}, k1 20, k2 6, "
        f"lambda 0.3): mAP {m_r.mAP:.6f} (not re-ranked {m.mAP:.6f}), R1 "
        f"{m_r.all_topk[0]:.6f}; kernel launches {launches}; K3 launches "
        f"by shape (rows, W, k): {shapes}")

    # K3 exact at each of the cell's shapes: on the input it took there, on
    # random rows (the tensors timed below) and on distance rows with ties
    timed = {}
    for (rows, w, k) in sorted(shapes):
        timed[rows, w, k] = torch.rand((rows, w), generator=gen,
                                       device="cuda")
        for kind, x in (("the cell's input", inputs[rows, w, k]),
                        ("random", timed[rows, w, k]),
                        ("distances", rerank_rows(rows, w, gen))):
            require(kpass_equal(x, k),
                    f"K3 differs at [{rows},{w}] k={k} ({kind})")
    log("K3 at the cell's shapes "
        + ", ".join(f"[{r},{w}] k={k}" for r, w, k in sorted(shapes))
        + ", on the first input the cell's run gave it at each, on random "
        "rows and on squared distances with exact ties: values and indices "
        "exact")
    del inputs

    # on a cut, against eval_func on the explicitly stitched order, whose
    # windows are selected with K3's plain version
    kw = dict(r=STREAM_R, k1=20, k2=6, lambda_value=0.3)
    m_w = eval_func_streaming_reranked(qf[:cq], gf[:cg], *cut, **kw)
    retrieval.kpass_topk = retrieval.kpass_topk_plain
    try:
        _, ridx = rerank_topk(qf[:cq], gf[:cg], **kw)
    finally:
        retrieval.kpass_topk = real_k3
    order = torch.argsort(compute_distmat_device(qf[:cq], gf[:cg]), dim=1,
                          stable=True).cpu().numpy()
    ridx = ridx.cpu().numpy()
    stitched = np.stack([np.concatenate(
        [ridx[i], order[i][~np.isin(order[i], ridx[i])]])
        for i in range(cq)])
    m_o = eval_func(torch.from_numpy(stitched).cuda(), *cut)
    log(f"cut {cq} x {cg} re-ranked: streaming mAP {m_w.mAP:.6f}, stitched "
        f"oracle {m_o.mAP:.6f}, equal within 1e-6: {_metrics_equal(m_w, m_o)}")
    require(_metrics_equal(m_w, m_o), "windowed evaluation against the oracle")

    # K3 at the cell's shapes, graph replay, beside torch.topk and the bound
    for (rows, w, k), n in sorted(shapes.items()):
        x = timed[rows, w, k]
        ms = graph_ms(lambda: kpass_topk(x, k))
        lib = graph_ms(lambda: torch.topk(x, k, dim=1, largest=False))
        b = rows * w * 4 + rows * k * (4 + 8)
        log(f"K3 [{rows},{w}] k={k} ({n} launches in the cell's run): "
            f"{ms * 1e3:.1f} us (graph replay), torch.topk {lib * 1e3:.1f} "
            f"us, bound {b / HBM_PEAK_GBS / 1e6 * 1e3:.1f} us by bytes "
            f"[{gpu}]")
    k7 = phase_k7(f, pids_all, cams, gpu)
    return {"plain": measured["R1mAP.compute, the whole cell (streaming by "
                              "itself)"],
            "rerank": measured[f"R1mAP(rerank=True, rerank_window="
                               f"{STREAM_R}), the whole cell"],
            "k7_launches": k7_launches, **k7}


# -------------------------------------------------------- phase 12 ------

ZSTD_BENCH_FLOATS = 25_000_000     # 100 MB of fp32 for the zstd rates
BLOCKED_MODULES = ("jax", "jaxlib", "flax", "optax", "orbax", "tensorstore",
                   "zstandard", "centroids_reid_tpu")


def _dotted(tree, prefix=()) -> dict:
    """{dotted tree path: array} of the reader's nested dicts and lists."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_dotted(v, prefix + (str(k),)))
        return out
    return {".".join(prefix): tree} if isinstance(tree, np.ndarray) else {}


def _nested(flat: dict, prefix: str) -> dict:
    """The arrays of ``flat`` under ``prefix`` as a nested dict."""
    out: dict = {}
    for key, v in flat.items():
        if key.startswith(prefix):
            node = out
            *parents, leaf = key[len(prefix):].split(".")
            for part in parents:
                node = node.setdefault(part, {})
            node[leaf] = v
    return out


def phase_orbax(gpu: str) -> dict:
    """Phase 12: the committed orbax checkpoint of the JAX package
    (``tests/fixtures/orbax_small``, a train state's node kinds) read by
    ``engine/orbax_read`` without jax, orbax, tensorstore or zstandard;
    every leaf held bit for bit against ``arrays.npz``; the Adam state
    mapped by ``from_jax_opt_state`` held against the npz's ``mu`` / ``nu``
    / ``count``; then the zstd route's decode and encode rates on 100 MB of
    fp32 (level 1, as orbax writes zarr chunks) and the decode time of a
    full-width ResNet-50 train state reckoned from them."""
    import os

    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.engine import orbax_read
    from centroids_reid_tpu_torch.models import (
        create_model,
        from_jax_opt_state,
        from_jax_params,
    )
    from centroids_reid_tpu_torch.utils import zstd

    log("== phase 12: orbax checkpoints of the JAX package")
    fixture = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "tests", "fixtures", "orbax_small")
    path = os.path.join(fixture, "checkpoint_epoch1")
    require(orbax_read.is_orbax_checkpoint(path), f"{path}: no checkpoint")
    t0 = time.perf_counter()
    tree = orbax_read.read_checkpoint(path)
    read_ms = (time.perf_counter() - t0) * 1e3
    with np.load(os.path.join(fixture, "arrays.npz")) as z:
        ref = {k: z[k] for k in z.files}
    got = _dotted(tree)
    require(got.keys() == ref.keys(), "fixture leaves: "
            f"{sorted(set(got) ^ set(ref))}")
    differ = [k for k in ref if got[k].dtype != ref[k].dtype
              or got[k].shape != ref[k].shape
              or not np.array_equal(got[k], ref[k])]
    require(not differ, f"fixture leaves differ from arrays.npz: {differ}")

    sd = from_jax_params(tree["params"]["model"], {})
    named = [(n, t) for n, t in sd.items() if n != "bn.bias"]
    adam = from_jax_opt_state(tree["opt_state"], named)
    pre = "opt_state.inner_states.model.inner_state.inner_state.1."
    moments = {k: from_jax_params(_nested(ref, f"{pre}{m}.model."), {})
               for k, m in (("exp_avg", "mu"), ("exp_avg_sq", "nu"))}
    for i, (name, _) in enumerate(named):
        for k, want in moments.items():
            require(np.array_equal(adam[i][k].numpy(), want[name].numpy()),
                    f"{name} {k} differs from arrays.npz")
        require(adam[i]["step"].item() == int(ref[f"{pre}count"]),
                f"{name}: Adam step")
    bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED_MODULES)
    require(not bad, f"modules imported by the orbax path: {bad}")
    log(f"fixture {os.path.relpath(path)}: {len(ref)} array leaves read in "
        f"{read_ms:.1f} ms (host clock), each equal to arrays.npz bit for "
        f"bit; Adam state of {len(named)} parameters mapped by name "
        f"(exp_avg, exp_avg_sq, step {int(ref[pre + 'count'])}) equal to "
        f"the npz's mu, nu and count; none of {', '.join(BLOCKED_MODULES)} "
        f"imported")

    data = np.random.default_rng(SEED + 14).standard_normal(
        ZSTD_BENCH_FLOATS, dtype=np.float32)
    mb = data.nbytes / 1e6
    t0 = time.perf_counter()
    frame = zstd.compress(data, level=1)
    enc_s = time.perf_counter() - t0
    dec = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = zstd.decompress(frame)
        dec.append(time.perf_counter() - t0)
    require(bytes(out) == data.tobytes(), "zstd round trip differs")
    dec_s = float(np.median(dec))
    cfg = get_default_cfg()
    model = create_model(cfg, num_classes=751)
    trained = sum(p.numel() for p in model.parameters() if p.requires_grad)
    total = sum(t.numel() for t in model.state_dict().values())
    state_mb = 4 * (total + 2 * trained + 751 * model.bn.num_features) / 1e6
    log(f"zstd route: the system's libzstd {zstd.version()} through ctypes "
        f"(centroids_reid_tpu_torch/utils/zstd.py); {mb:.0f} MB of random "
        f"fp32 at level 1: ratio {len(frame) / data.nbytes:.4f}, encode "
        f"{mb / enc_s:.1f} MB/s, decode {mb / dec_s:.1f} MB/s (median of 3; "
        f"{', '.join(f'{mb / d:.1f}' for d in dec)}; host clock, one "
        f"thread) [{gpu}]")
    log(f"a full-width ResNet-50 train state of the JAX package (751 "
        f"classes: params and BN statistics, Adam mu and nu, centers) holds "
        f"{state_mb:.1f} MB of fp32: about {state_mb / (mb / dec_s):.2f} s "
        f"of zstd decode at that rate (not measured: no such checkpoint is "
        f"in the repository)")
    return {"decode_mb_s": mb / dec_s, "encode_mb_s": mb / enc_s,
            "read_ms": read_ms}


# -------------------------------------------------------- phase 13 ------

MESH_SHARDS = 4           # gallery shards; on one card all on cuda:0
MESH_TIE = 1e-6           # fp32 rounding of two matmul blockings, unit rows
MESH_TOL = 1e-5 * 2       # 1e-5 of the squared norms' scale (2, unit rows)


def _mesh():
    """The phase's mesh: MESH_SHARDS shards dealt over the visible cards."""
    import torch

    from centroids_reid_tpu_torch.parallel import make_retrieval_mesh

    n = torch.cuda.device_count()
    return make_retrieval_mesh(devices=[torch.device("cuda", s % n)
                                        for s in range(MESH_SHARDS)])


def device_ops_per_call(fn, n: int = 10):
    """Kernels, copies and sets that ``fn`` puts on the card per call
    (torch.profiler over ``n`` calls); None when it traced none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ops = sum(e.count for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False))
    return ops / n if ops else None


def _tie_equal(vals, idx, ref_idx) -> tuple:
    """(rows whose indices are equal outright, whether every row is equal
    up to runs of values within MESH_TIE)."""
    same = int((np.asarray(idx) == np.asarray(ref_idx)).all(axis=1).sum())
    return same, _same_ranking(vals, idx, ref_idx, MESH_TIE)


def phase_mesh(state: dict, int8_state: dict, tmp: str, eval_root: str,
               gpu: str) -> dict:
    """Phase 13, the gallery mesh: phase 4's 100,000 x 2048 gallery sharded
    MESH_SHARDS ways (on one card every shard on cuda:0). ``sharded_topk``
    against ``topk_retrieval`` (fp32, TF32 off); ``RetrievalService(mesh=)``
    on phase 4's 64 images at k=10 and k=100 against the one-device
    services, fp32 and bf16; re-ranked at r=100 (the cross-shard gather
    against the gallery rows, each response against ``_windowed``); phase
    4b's int8 embed feeding the sharded bf16 gallery; ``get_similar
    --topk 100`` and the HTTP front with ``TPU.SHARDED_RETRIEVAL``, which
    follow the reference's fewer-than-two-devices rule on one card.
    Returns the launch counts of the sharded bf16 requests."""
    import base64
    import functools
    import logging
    import os

    import torch

    from centroids_reid_tpu_torch.inference import (
        RetrievalService,
        get_similar,
    )
    from centroids_reid_tpu_torch.inference import service as service_mod
    from centroids_reid_tpu_torch.ops import (
        launch_counts,
        reset_launch_counts,
        topk_retrieval,
    )
    from centroids_reid_tpu_torch.ops.rerank import _windowed
    from centroids_reid_tpu_torch.parallel import sharded_topk

    log("== phase 13: gallery mesh")
    mesh = _mesh()
    log(f"mesh of {MESH_SHARDS} shards on "
        f"{', '.join(map(str, mesh.devices))} ({torch.cuda.device_count()} "
        f"card(s) visible; shards that share a card run one after another "
        f"on its stream, so this measures the program, not multi-card "
        f"speed) [{gpu}]")
    cfg, model, imgs = state["cfg"], state["model"], state["imgs"]
    gallery, paths, rows = state["gallery"], state["paths"], state["rows"]
    out = {}

    # ---- 1. sharded_topk against topk_retrieval on one device, fp32
    qf = torch.from_numpy(state["emb"]).cuda()
    gf = torch.from_numpy(gallery).cuda()
    for dist in ("euclidean", "cosine"):
        for k in (10, 100):
            torch.cuda.synchronize()
            reset_launch_counts()
            v, i = sharded_topk(qf, gf, k, mesh, dist=dist)
            torch.cuda.synchronize()
            launches = launch_counts()
            rv, ri = topk_retrieval(qf, gf, k, dist=dist)
            same, ok = _tie_equal(rv, i, ri)
            err = float(np.abs(v - rv).max() / np.abs(rv).max())
            log(f"sharded_topk {dist} k={k}, {len(qf)} queries: indices "
                f"equal in {same} of {len(qf)} rows (the rest within runs of "
                f"values closer than {MESH_TIE}: {ok}), max relative value "
                f"difference {err:.2e} (tol 1e-4); K3 launches "
                f"{launches['kpass_topk']}")
            require(ok and err <= 1e-4, f"sharded_topk {dist} k={k} differs "
                    f"from topk_retrieval")
            require(launches["kpass_topk"] > 0, "sharded_topk launched no K3")
    del gf

    # ---- 2. the sharded service against the one-device ones
    def serve_all(svc, check_rows=True):
        """Phase 4's 64 images as 8-image requests; each request's answer
        and the embeddings the service computed for it."""
        res = []
        with _recording(service_mod, "embed_query") as emb_calls:
            for r in range(N_IMAGES // REQUEST):
                sl = slice(r * REQUEST, (r + 1) * REQUEST)
                d, idx, _ = svc.query_arrays(imgs[sl])
                require(np.isfinite(d).all() and d.shape == (REQUEST, svc.k),
                        "sharded service: bad distances")
                if check_rows:
                    require((idx[:, 0] == rows[sl]).all(),
                            "sharded service: top-1 is not the own row")
                res.append((d, idx))
        return res, [c[2] for c in emb_calls]

    one32 = {}
    for k in (10, 100):
        sharded32 = RetrievalService(cfg, gallery, paths, k=k, model=model,
                                     mesh=mesh, use_bf16_kernel=False)
        one32[k] = RetrievalService(cfg, gallery, paths, k=k, device="cuda",
                                    model=model, use_bf16_kernel=False)
        got, _ = serve_all(sharded32)
        ref, _ = serve_all(one32[k])
        same, ok = 0, True
        for (d, i), (rd, ri) in zip(got, ref):
            n_same, n_ok = _tie_equal(rd, i, ri)
            same, ok = same + n_same, ok and n_ok
            ok = ok and np.allclose(d, rd, rtol=0, atol=MESH_TIE)
        log(f"fp32 route k={k}: indices equal to the one-device service in "
            f"{same} of {N_IMAGES} rows (the rest within runs of distances "
            f"closer than {MESH_TIE}: {ok})")
        require(ok, f"fp32 sharded service k={k} differs from one device")
        del sharded32

    out["launches"] = {}
    sharded = {k: RetrievalService(cfg, gallery, paths, k=k, model=model,
                                   mesh=mesh) for k in (10, 100)}
    for k, svc in sharded.items():
        full = torch.cat(svc._gf32).double()
        torch.cuda.synchronize()
        reset_launch_counts()
        got, embs = serve_all(svc)
        torch.cuda.synchronize()
        launches = launch_counts()
        ref, _ = serve_all(state["services"][k])
        worst_exact, worst_dom = 0.0, 0.0
        for (d, i), e, (rd, _) in zip(got, embs, ref):
            g = full[torch.from_numpy(i).cuda()]
            e = e.double()
            exact = ((e * e).sum(1)[:, None] + (g * g).sum(2)
                     - 2 * torch.einsum("qd,qkd->qk", e, g)).cpu().numpy()
            worst_exact = max(worst_exact, float(np.abs(d - exact).max()))
            worst_dom = max(worst_dom, float((d - rd).max()))
        per = {n: launches[n] / (N_IMAGES // REQUEST) for n in launches
               if launches[n]}
        out["launches"][k] = launches
        log(f"bf16 route k={k}: every top-1 is the own row; each distance "
            f"is its row's exact distance within {worst_exact:.2e} (float64 "
            f"reference, tol {MESH_TOL}); at every rank the sharded distance "
            f"exceeds the one-device service's by at most {worst_dom:.2e} "
            f"(tol {MESH_TOL}; it picks from a superset of candidates); "
            f"launches per request {per}")
        require(worst_exact <= MESH_TOL, f"bf16 k={k}: distances not exact")
        require(worst_dom <= MESH_TOL, f"bf16 k={k}: a sharded distance "
                "exceeds the one-device service's")
        require(launches["scores"] > 0 and launches["kpass_topk"] > 0,
                f"bf16 k={k}: the sharded path did not launch K1 and K3")
        del full
    for k, svc in sharded.items():
        pair = {"sharded": svc, "one device": state["services"][k]}
        lat = {name: [] for name in pair}
        for name in ("sharded", "one device", "one device", "sharded"):
            lat[name] += request_ms(pair[name], imgs[:REQUEST], 15)
        for name, s in pair.items():
            call = functools.partial(s.query_arrays, imgs[:REQUEST])
            out[f"{name}-k{k}"] = (float(np.median(lat[name])),
                                   device_busy_ms(call, 10),
                                   device_ops_per_call(call, 10))
        (sp, sb, so), (op, ob, oo) = (out[f"sharded-k{k}"],
                                      out[f"one device-k{k}"])
        log(f"k={k}, {REQUEST}-image requests: p50 {sp:.2f} ms sharded, "
            f"{op:.2f} ms on one device (host clock, 2 x 15 requests each, "
            f"in turns); device busy " + (
                f"{sb:.3f} ms sharded, {ob:.3f} ms one device; device "
                f"operations (kernels, copies, sets) per request {so:.1f} "
                f"sharded, {oo:.1f} one device" if sb and ob and so and oo
                else "not measured (no device time traced)")
            + f" (torch.profiler, 10 requests) [{gpu}]")

    # ---- 3. re-ranked on the sharded gallery
    rr = RetrievalService(cfg, gallery, paths, k=100, model=model, mesh=mesh,
                          rerank_window=RERANK_R)
    full32 = torch.cat(rr._gf32)
    with _recording(rr, "_gather_rows") as gathers, \
            _recording(service_mod, "_windowed_feats") as cores:
        got, _ = serve_all(rr)
    require(len(gathers) == len(cores) == len(got),
            "re-ranked: one gather and one core a request")
    worst = 0.0
    for (d, i), (g_args, _, cand), (c_args, _, vals) in zip(got, gathers,
                                                            cores):
        idx0 = g_args[0]
        require(torch.equal(cand, full32[idx0]),
                "re-ranked: the gathered rows are not gf32[idx0]")
        own = _windowed(c_args[0], full32, idx0, *c_args[2:])
        worst = max(worst, float((own - vals).abs().max()))
        ov, order = torch.sort(own, dim=1, stable=True)
        oi = torch.gather(idx0, 1, order)[:, :100].cpu().numpy()
        require(np.abs(ov[:, :100].cpu().numpy() - d).max() <= 1e-6
                and _same_ranking(d, i, oi, 1e-6),
                "re-ranked: a response is not the re-rank of its window")
    log(f"re-ranked (rerank_window {RERANK_R}, k=100): the gathered window "
        f"rows equal gf32[window] bit for bit; _windowed on each window "
        f"gives the core's values within {worst:.1e} and each response")
    require(worst <= 1e-6, "re-ranked: _windowed_feats differs from "
            "_windowed")
    del rr, full32

    # ---- 4. phase 4b's int8 embed feeding the sharded bf16 gallery
    i8 = RetrievalService(cfg, gallery, paths, k=10, model=model, mesh=mesh,
                          int8_qfn=int8_state["qfn"])
    torch.cuda.synchronize()
    reset_launch_counts()
    serve_all(i8)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"int8 embed on the sharded bf16 gallery, k=10: every top-1 is the "
        f"own row; launches {launches}")
    for name in ("scores", "kpass_topk", "matmul_requant", "conv3x3_requant"):
        require(launches[name] > 0, f"int8 on the mesh: {name} not launched")
    del i8, sharded, one32

    # ---- 6. TPU.SHARDED_RETRIEVAL in get_similar and the HTTP front
    ckpt = cfg.MODEL.PRETRAIN_PATH
    warnings = []

    class Catch(logging.Handler):
        def emit(self, record):
            warnings.append(record.getMessage())

    api_log = logging.getLogger("centroids_reid_tpu_torch.inference.api")
    handler = Catch(logging.WARNING)
    api_log.addHandler(handler)
    try:
        queries = os.path.join(eval_root, "market1501", "bounding_box_test")
        t0 = time.perf_counter()
        res = get_similar.main([
            "--gallery_data", os.path.join(tmp, "index_flat"), "--topk",
            "100", "--normalize_features", "MODEL.PRETRAIN_PATH", ckpt,
            "DATASETS.ROOT_DIR", queries, "TPU.SHARDED_RETRIEVAL", "True",
            "OUTPUT_DIR", os.path.join(tmp, "similar_sharded")])
        secs = time.perf_counter() - t0
    finally:
        api_log.removeHandler(handler)
    ref = np.load(os.path.join(tmp, "similar_100", "results.npy"),
                  allow_pickle=True).item()
    require(list(res) == list(ref), "get_similar sharded: other queries")
    same, ok = 0, True
    for qp, r in ref.items():
        d, i = res[qp]["distances"][None], res[qp]["indices"][None]
        n_same, n_ok = _tie_equal(r["distances"][None], i,
                                  r["indices"][None])
        same, ok = same + n_same, ok and n_ok and np.allclose(
            d, r["distances"][None], rtol=0, atol=MESH_TIE)
    n_cards = torch.cuda.device_count()
    log(f"get_similar --topk 100 TPU.SHARDED_RETRIEVAL True ({secs:.2f} s): "
        f"{n_cards} card(s) visible, so " + (
            "the reference's rule gives a one-device mesh, warning "
            f"{warnings!r}" if n_cards < 2 else f"a mesh of {n_cards}")
        + f"; results equal to the unsharded run's (phase 6) in {same} of "
        f"{len(ref)} queries outright, the rest within runs of values closer "
        f"than {MESH_TIE}: {ok}")
    require(ok, "get_similar sharded differs from the unsharded run")
    require((n_cards >= 2) or any("needs >= 2 devices" in w
                                  for w in warnings),
            "get_similar: the fewer-than-two-devices warning is missing")

    server = _serve_cli(os.path.join(tmp, "http_index"), ckpt,
                        "TPU.SHARDED_RETRIEVAL", "True")
    try:
        svc = server.service
        require((svc.mesh is None) == (n_cards < 2),
                f"HTTP front: mesh {svc.mesh} with {n_cards} card(s)")
        for r in range(2):
            rr_rows = _request_rows(r)
            payload = {"images_b64": [_jpeg(imgs[j]) for j in rr_rows]}
            blobs = [base64.b64decode(b) for b in payload["images_b64"]]
            status, body, _ = _http(server.port, "POST", "/search", payload)
            require(status == 200, f"HTTP front sharded: {status}")
            _hold("mesh-http", svc, blobs, rr_rows, body)
    finally:
        server.shutdown()
    log("HTTP front built with TPU.SHARDED_RETRIEVAL True: " + (
        "one card, so no mesh, as the reference's front (the unsharded "
        "service)" if n_cards < 2 else f"a mesh of {n_cards} cards")
        + "; 2 /search requests held against its query_arrays")
    return out


def phase_mesh_eval(gpu: str, stream: dict) -> None:
    """Phase 13b: ``R1mAP(mesh=)`` on eval-stream-market500k (phase 10's
    data), plain and re-ranked at r = STREAM_R, against the unsharded
    streaming evaluation run beside it: mAP, CMC and each AP within 1e-6,
    every hit's rank equal; seconds and peak memory beside phase 10's."""
    import torch

    from centroids_reid_tpu_torch.metrics import R1mAP, compute_stream_ranks
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    log("== phase 13b: gallery mesh, streaming evaluation "
        "(eval-stream-market500k)")
    mesh = _mesh()
    nq = MARKET[0]
    f, pids_all, cams, _ = _stream_cell()
    qf, gf = f[:nq], f[nq:]
    args = (pids_all[:nq], pids_all[nq:], cams[:nq], cams[nq:])
    runs = {}
    for name, kw in (("plain", {}),
                     ("re-ranked", dict(rerank=True,
                                        rerank_window=STREAM_R))):
        m1, s1, p1 = _measured(f"R1mAP {name}, unsharded",
                               lambda: R1mAP(nq, **kw).compute(
                                   f, pids_all, cams), gpu)
        torch.cuda.synchronize()
        reset_launch_counts()
        m4, s4, p4 = _measured(f"R1mAP(mesh=) {name}, {MESH_SHARDS} shards",
                               lambda: R1mAP(nq, mesh=mesh, **kw).compute(
                                   f, pids_all, cams), gpu)
        torch.cuda.synchronize()
        launches = launch_counts()
        ap = float(np.abs(m1.single_performance[:, 2]
                          - m4.single_performance[:, 2]).max())
        log(f"{name}: mAP {m4.mAP:.6f} sharded, {m1.mAP:.6f} unsharded, max "
            f"|AP diff| {ap:.2e} (tol 1e-6), equal: {_metrics_equal(m1, m4)};"
            f" launches {launches}")
        require(_metrics_equal(m1, m4), f"R1mAP(mesh=) {name} differs")
        runs[name] = (s1, p1, s4, p4)
    require(launches["kpass_topk"] > 0, "re-ranked R1mAP(mesh=): no K3")
    ref = compute_stream_ranks(qf, gf, *args)
    got = compute_stream_ranks(qf, gf, *args, mesh=mesh)
    valid = ref.pos >= 0
    first = [np.where(valid, x.ranks, 1 << 30).min(1) for x in (ref, got)]
    require(np.array_equal(ref.ranks, got.ranks)
            and np.array_equal(ref.dpos, got.dpos)
            and np.array_equal(*first),
            "sharded streaming ranks differ from the unsharded ones")
    log(f"compute_stream_ranks(mesh=): every hit's rank and distance equal "
        f"to the unsharded passes ({int(valid.sum())} hits), first ranks "
        f"equal")
    for name, key in (("plain", "plain"), ("re-ranked", "rerank")):
        s1, p1, s4, p4 = runs[name]
        s10, p10 = stream[key]
        log(f"{name}, the whole cell: {s4:.3f} s / {p4:.2f} GiB sharded "
            f"{MESH_SHARDS} ways, {s1:.3f} s / {p1:.2f} GiB unsharded here, "
            f"{s10:.3f} s / {p10:.2f} GiB in phase 10 [{gpu}]")


# -------------------------------------------------------- phase 15 ------

FASHION_CONFIG = "configs/320_resnet50_ibn_a.yml"
FASHION_HW = (320, 320)
FASHION_TRAIN_PIDS = 100     # train pair ids of 4 to 12 images; the real
FASHION_TRAIN_RANGE = (4, 12)  # DeepFashion and Street2Shop splits hold
FASHION_EVAL_PIDS = 50       # tens of thousands: cut for the phase's time
FASHION_QUERIES = 2          # query and gallery images per eval pair id
FASHION_GALLERY = 4
FASHION_P = 12               # the df1 script's SOLVER.IMS_PER_BATCH
FASHION_PARITY_P = 4         # the card-vs-CPU step: 4 x 4 at 320x320
FASHION_REQUESTS = 8         # 8-image requests against the gallery index
IBN_LAYOUT_ITERS = 20
# the fused engine's embeddings against the unfused engine's on the same
# quantized tree, relative L2 per embedding: a quantum that the two
# epilogues round apart (about 1 activation in 2e6) moved this seeded
# trunk's embeddings by up to 0.0955 on an NVIDIA H100 80GB HBM3 at 700 W;
# the trained checkpoint differs from run to run (cuDNN's backward is not
# deterministic), and with it where the flips land
INT8_FUSED_TOL = 0.15


def _fashion_opts(root: str, json_train: str, logs: str, *extra) -> list:
    """``configs/320_resnet50_ibn_a.yml`` with the overrides of
    ``train_scripts/df1/train_ctl_model_l_r50ibn_df1.sh`` (one run)."""
    import os

    config = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          FASHION_CONFIG)
    return ["--config_file", config, "DATASETS.NAMES", "df1",
            "DATASETS.JSON_TRAIN_PATH", json_train, "DATASETS.ROOT_DIR",
            root, "SOLVER.IMS_PER_BATCH", str(FASHION_P),
            "TEST.IMS_PER_BATCH", "256", "SOLVER.BASE_LR", "1e-4",
            "OUTPUT_DIR", logs, "DATALOADER.USE_RESAMPLING", "False",
            "MODEL.KEEP_CAMID_CENTROIDS", "False",
            "MODEL.USE_CENTROIDS", "True", "REPRODUCIBLE_NUM_RUNS", "1",
            *extra]


def _fashion_cfg(opts: list):
    from centroids_reid_tpu_torch.config import get_default_cfg

    cfg = get_default_cfg()
    cfg.merge_from_file(opts[1])
    cfg.merge_from_list(opts[2:])
    return cfg


def _write_coco(root: str) -> str:
    """A COCO-layout fashion split as the preparation tools lay it out:
    ``train/``, ``query/`` and ``gallery/`` folders of 320x320 JPEGs and
    ``train_320_320.json`` (``query_`` and ``gallery_`` beside it), pair ids
    from 1000 up; each pair a seeded 8x8 block pattern, a brightness shift
    and pixel noise per image. The query and gallery pairs are not train
    pairs, as in the real splits. Returns the train JSON's path."""
    import concurrent.futures
    import json
    import os

    from PIL import Image

    rng = np.random.RandomState(SEED + 21)
    lo, hi = FASHION_TRAIN_RANGE
    counts = {"train": {1000 + p: int(rng.randint(lo, hi + 1))
                        for p in range(FASHION_TRAIN_PIDS)}}
    held = range(1000 + FASHION_TRAIN_PIDS,
                 1000 + FASHION_TRAIN_PIDS + FASHION_EVAL_PIDS)
    counts["query"] = {p: FASHION_QUERIES for p in held}
    counts["gallery"] = {p: FASHION_GALLERY for p in held}
    patterns = rng.randint(0, 256, (FASHION_TRAIN_PIDS + FASHION_EVAL_PIDS,
                                    8, 8, 3)).astype(np.float32)
    h, w = FASHION_HW
    image_id = 1

    def save(img, path):
        Image.fromarray(img).save(path, quality=90)

    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 1) as pool:
        jobs = []
        for split in ("train", "query", "gallery"):
            os.makedirs(os.path.join(root, split))
            images, anns = [], []
            for pair, n in counts[split].items():
                block = np.kron(patterns[pair - 1000],
                                np.ones((h // 8, w // 8, 1), np.float32))
                imgs = (block + rng.randint(-30, 31, (n, 1, 1, 3))
                        + rng.randint(-17, 18, (n,) + block.shape))
                imgs = np.clip(imgs, 0, 255).astype(np.uint8)
                for i in range(n):
                    name = f"{pair}_{i:02d}.jpg"
                    jobs.append(pool.submit(save, imgs[i], os.path.join(
                        root, split, name)))
                    images.append({"id": image_id, "file_name": name,
                                   "width": w, "height": h})
                    anns.append({"id": image_id, "image_id": image_id,
                                 "pair_id": pair, "source": "shop"
                                 if split == "gallery" else "user",
                                 "bbox": [0, 0, w, h], "category_id": 1})
                    image_id += 1
            with open(os.path.join(root, f"{split}_{h}_{w}.json"), "w") as f:
                json.dump({"images": images, "annotations": anns}, f)
        for job in jobs:
            job.result()
    return os.path.join(root, f"train_{h}_{w}.json")


def _ibn_layout(model, shapes: list) -> dict:
    """The 13 IBN layers of IBN-a's layers 1-3 in train mode under bf16
    autocast, at the step's input shapes (channels_last bf16, as the trunk
    gives them): forward + backward device time of all 13 a step (CUDA
    events), and of their layout copies alone (the two halves made
    contiguous, the concatenation, and the channels_last copy the next
    conv makes of it, forward and backward); the dtype and memory format
    of the IN and IBN outputs; and whether bf16 IN computes its statistics
    in fp32 (its output against the fp32 IN of the same bf16 input)."""
    import torch

    from centroids_reid_tpu_torch.models.resnet import IBN

    layers = [m for m in model.modules() if isinstance(m, IBN)]
    require(len(layers) == len(shapes) == 13,
            f"{len(layers)} IBN layers, {len(shapes)} input shapes")
    cl = torch.channels_last
    gen = torch.Generator(device="cuda").manual_seed(SEED + 22)
    xs = [torch.randn(s, generator=gen, device="cuda").to(
        torch.bfloat16).contiguous(memory_format=cl).requires_grad_(True)
        for s in shapes]

    def run(fn):
        for m, x in zip(layers, xs):
            with torch.autocast("cuda", dtype=torch.bfloat16):
                y = fn(m, x)
            y.backward(torch.ones_like(y))

    def copies(m, x):
        a, b = torch.split(x, [m.half, x.shape[1] - m.half], dim=1)
        return torch.cat([a.contiguous(), b.contiguous()], 1).contiguous(
            memory_format=cl)

    def ibn(m, x):   # the module, and the next conv's channels_last copy
        return m(x).contiguous(memory_format=cl)

    model.train()
    ms = {name: cuda_ms(lambda fn=fn: run(fn), iters=IBN_LAYOUT_ITERS)
          for name, fn in (("ibn", ibn), ("copies", copies))}
    m, x = layers[0], xs[0].detach()
    with torch.no_grad():
        with torch.autocast("cuda", dtype=torch.bfloat16):
            a = x[:, :m.half]
            y_in = m.IN(a.contiguous())
            y = m(x)
        ref = m.IN(a.float().contiguous()).to(torch.bfloat16)
    ulp = (y_in.float() - ref.float()).abs() / ref.float().abs().clamp_min(
        2.0 ** -126) * 2.0 ** 7
    out = {"in_dtype": y_in.dtype, "ibn_dtype": y.dtype,
           "ibn_channels_last": y.is_contiguous(memory_format=cl),
           "in_vs_fp32_ulp": float(ulp.max()), **ms}
    return out


def _fashion_capture_shapes(model, x) -> list:
    """The input shapes of every IBN layer in one forward of ``x``."""
    import torch

    from centroids_reid_tpu_torch.models.resnet import IBN

    shapes, hooks = [], []
    for m in model.modules():
        if isinstance(m, IBN):
            hooks.append(m.register_forward_pre_hook(
                lambda mod, inp: shapes.append(tuple(inp[0].shape))))
    try:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            model.features(x)
    finally:
        for h in hooks:
            h.remove()
    return shapes


class _PairedInt8:
    """Wraps an unfused ``_Int8Engine``: at every conv the fused kernels
    could run, runs the fused path too on the same input and records how
    many int8 activations differ and by how many quanta; returns the
    unfused result, so the forward is the unfused engine's."""

    def __init__(self, unfused, fused):
        self.u, self.f = unfused, fused
        self.diffs = []

    def __getattr__(self, name):
        return getattr(self.u, name)

    def _compare(self, a, b, kind):
        d = (a[0].int() - b[0].int()).abs()
        self.diffs.append((kind, int((d > 0).sum()), d.numel(),
                           int(d.max())))

    def conv_act(self, rep, entry, stride, pad, qname, relu=True):
        out = self.u.conv_act(rep, entry, stride, pad, qname, relu)
        kind = self.f._kernel_eligible(entry, stride,
                                       rep[0].shape[1] * rep[0].shape[2])
        if kind is not None:
            self._compare(self.f.conv_act(rep, entry, stride, pad, qname,
                                          relu), out, kind)
        return out

    def conv_add_act(self, rep, entry, stride, pad, res_rep, qname):
        out = self.u.conv_add_act(rep, entry, stride, pad, res_rep, qname)
        kind = self.f._kernel_eligible(entry, stride,
                                       rep[0].shape[1] * rep[0].shape[2])
        if kind is not None:
            self._compare(self.f.conv_add_act(rep, entry, stride, pad,
                                              res_rep, qname), out, kind)
        return out


def _int8_device_split(qfn, x) -> dict:
    """Device ms of one int8 embed call of ``x`` by part: K5 and K6 (by
    kernel name), the exact fp64 convs (``_conv_int8``) and the int8-domain
    InstanceNorm (each a ``record_function`` range; their kernels by
    correlation to the range that launched them), the rest. Each part is
    None (not measured) when three traces in a row lost kernel events."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from centroids_reid_tpu_torch.models import quantized as Q

    conv, inorm = Q._conv_int8, Q._instance_norm_int8_domain

    def ranged(name, fn):
        def run(*a, **kw):
            with torch.profiler.record_function(name):
                return fn(*a, **kw)
        return run

    qfn(x)
    torch.cuda.synchronize()
    Q._conv_int8 = ranged("fp64_conv", conv)
    Q._instance_norm_int8_domain = ranged("int8_in", inorm)
    try:
        with tempfile.TemporaryDirectory() as d:
            trace = os.path.join(d, "trace.json")
            for attempt in range(3):
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    qfn(x)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(trace)
                with open(trace) as f:
                    events = json.load(f)["traceEvents"]
                kernels = [e for e in events if e.get("cat") == "kernel"]
                n_req = sum("requant_gemm_kernel" in e["name"]
                            for e in kernels)
                if n_req == 37 or attempt == 2:   # 23 K5 + 14 K6
                    break
                log("  int8 trace lost kernel events; tracing again")
            split = _phase_device_us(trace, ("fp64_conv", "int8_in"))
    finally:
        Q._conv_int8, Q._instance_norm_int8_domain = conv, inorm
    if n_req != 37:
        return {"K5": None, "K6": None, "fp64 convs": None,
                "int8-domain IN": None, "other": None, "traced": n_req}
    k5 = sum(e["dur"] for e in kernels
             if PROFILED["matmul_requant"] in e["name"])
    k6 = sum(e["dur"] for e in kernels
             if PROFILED["conv3x3_requant"] in e["name"])
    return {"K5": k5 / 1e3, "K6": k6 / 1e3,
            "fp64 convs": split["fp64_conv"] / 1e3,
            "int8-domain IN": split["int8_in"] / 1e3,
            "other": (split["other"] - k5 - k6) / 1e3, "traced": n_req}


def phase_fashion(tmp: str) -> dict:
    """Phase 15, the fashion recipe: ``configs/320_resnet50_ibn_a.yml``
    with the df1 script's overrides over a synthetic COCO-layout split
    (ResNet50-IBN-a, 320x320, P = 12 x K = 4, bf16): one CTL epoch through
    ``engine.runner.main`` from a reference IBN-a backbone file, with
    validation, checkpoints and the double test; the step's time, rate,
    memory, profiler split and the IBN layers' share; one full-width step
    on the card against the CPU; ONLY_TEST with ``KEEP_CAMID_CENTROIDS``
    both ways against the CPU's metrics; bf16 serving over a
    ``create_embeddings`` index of the gallery (K1, K2, K3); and the int8
    IBN embed (``TPU.INT8_EVAL`` fold and calibration, then the fused
    engine: K5 and K6 at 80x80, 40x40 and 20x20) against the unfused
    engine and the bf16 embed, each K5 / K6 launch of a call against its
    plain version, timed at 8 and 256 images. Returns the int8 serving
    run's launch counts and the kernels' largest errors."""
    import os

    import torch

    from centroids_reid_tpu_torch.data import EvalLoader, ImageStore
    from centroids_reid_tpu_torch.data import init_dataset
    from centroids_reid_tpu_torch.data.transforms import load_and_resize
    from centroids_reid_tpu_torch.engine import checkpoint as CK
    from centroids_reid_tpu_torch.engine import evaluate
    from centroids_reid_tpu_torch.engine import fit as FIT
    from centroids_reid_tpu_torch.engine import runner
    from centroids_reid_tpu_torch.inference import (
        RetrievalService,
        create_embeddings,
        load_inference_model,
    )
    from centroids_reid_tpu_torch.inference import service as service_mod
    from centroids_reid_tpu_torch.inference.service import embed_query
    from centroids_reid_tpu_torch.models import quantized as Q
    from centroids_reid_tpu_torch.ops import int8_conv as C
    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    gpu = gpu_line()
    log(f"== phase 15: the fashion recipe (ResNet50-IBN-a 320x320 over a "
        f"COCO-layout split; {gpu})")
    base = os.path.join(tmp, "fashion")
    root = os.path.join(base, "images_320_320")
    require("train" not in root, f"{root}: the query and gallery JSONs are "
            f"named by replacing 'train' in the train JSON's path")
    t0 = time.perf_counter()
    json_train = _write_coco(root)
    n_train = len(os.listdir(os.path.join(root, "train")))
    log(f"synthetic COCO-layout split: {FASHION_TRAIN_PIDS} train pair ids "
        f"({n_train} JPEGs, {FASHION_TRAIN_RANGE[0]} to "
        f"{FASHION_TRAIN_RANGE[1]} a pair), {FASHION_EVAL_PIDS} query / "
        f"gallery pair ids ({FASHION_QUERIES} and {FASHION_GALLERY} "
        f"images each), 320x320, written in "
        f"{time.perf_counter() - t0:.1f} s")

    # the pretrained backbone: a seeded random ResNet50-IBN-a (BN
    # statistics calibrated, residual gains 0.1, IN affine parameters drawn
    # around their init, as trained ones are) in the reference IBN-a layout
    # (bn1.IN.* / bn1.BN.* keys) with an ImageNet fc head. At the init's IN
    # bias of exactly 0, a mock slot's constant maps leave IN as 0 plus
    # rounding, and the ReLU after it masks by the rounding's sign: the IN
    # bias gradient is then decided by rounding, on any device
    logs = os.path.join(base, "logs")
    opts = _fashion_opts(root, json_train, logs)
    cfg = _fashion_cfg(opts)
    require(cfg.MODEL.NAME == "resnet50_ibn_a"
            and tuple(cfg.INPUT.SIZE_TRAIN) == FASHION_HW
            and cfg.USE_MIXED_PRECISION and cfg.DATALOADER.NUM_INSTANCE == 4,
            "unexpected fashion config")
    dataset = init_dataset("df1", cfg)
    calib = np.stack([load_and_resize(r.path, FASHION_HW)
                      for r in dataset.train[:64]])
    model0 = _random_reid_model(cfg, calib)
    backbone = {k[len("backbone."):]: v for k, v in
                model0.state_dict().items() if k.startswith("backbone.")}
    gen = torch.Generator().manual_seed(SEED + 23)
    for k in [k for k in backbone if ".IN." in k]:
        draw = (torch.rand if k.endswith("weight") else torch.randn)(
            backbone[k].shape, generator=gen)
        backbone[k] = draw + 0.5 if k.endswith("weight") else draw * 0.1
    require("layer1.0.bn1.IN.weight" in backbone
            and "layer3.5.bn1.BN.running_var" in backbone,
            "the backbone is not in the IBN-a layout")
    backbone["fc.weight"] = torch.randn((1000, DIM), generator=gen) * 0.01
    backbone["fc.bias"] = torch.zeros(1000)
    pth = os.path.join(base, "r50_ibn_a_layout.pth")
    torch.save(backbone, pth)
    cfg.MODEL.PRETRAIN_PATH = pth
    del model0

    # ---- training through the runner
    banks = []
    build_bank = FIT.build_image_bank

    def keep_bank(*args, **kw):
        banks[:] = [build_bank(*args, **kw)]
        return banks[0]

    FIT.build_image_bank = keep_bank
    try:
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        out = runner.main(["--mode", "ctl", *opts, "MODEL.PRETRAIN_PATH",
                           pth, "SOLVER.MAX_EPOCHS", "1",
                           "SOLVER.EVAL_PERIOD", "1"])
        train_s = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = launch_counts()
    finally:
        FIT.build_image_bank = build_bank
    version0 = os.path.join(logs, "train_ctl_model", "version_0")
    records = _epoch_records(version0)
    keys = ("epoch_train_loss", "query_triplet", "query_xent",
            "query_center", "centroid_triplet", "epoch_dist_ap",
            "epoch_dist_an", "l2_mean_centroid")
    require([r["step"] for r in records] == [0], "fashion: epochs trained")
    r = records[0]
    require(all(np.isfinite(r[k]) for k in keys),
            f"fashion epoch 0: a loss is not finite: {r}")
    best_dir = os.path.join(version0, "checkpoints")
    require(os.listdir(best_dir) == ["epoch=0"],
            f"fashion best checkpoints: {os.listdir(best_dir)}")
    best = os.path.join(best_dir, "epoch=0")
    ring = os.path.join(version0, "auto_checkpoints", "checkpoint_epoch0")
    require(sorted(os.listdir(ring)) == ["config.yml", "state.pt"],
            f"fashion ring checkpoint {ring}")
    names = [f"test_{tag}_{m}" for tag in ("centroids", "plain")
             for m in ("mAP", "Top-1", "Top-5", "Top-10")]
    require(all(n in out and np.isfinite(out[n]) for n in names),
            f"fashion: metrics missing from {sorted(out)}")
    require(not any(launches.values()),
            f"hand-written kernels launched while training: {launches}")
    log(f"fashion epoch 0 ({int(r['steps'])} steps of {FASHION_P} x 4, "
        f"{r['epoch_time_s']:.2f} s): " + ", ".join(
            f"{k} {r[k]:.5f}" for k in keys))
    log(f"runner (ctl, 1 epoch + validation + checkpoints + double test): "
        f"{train_s:.1f} s (host clock, image bank decode included); double "
        f"test: " + ", ".join(f"{n[5:]} {out[n]:.4f}" for n in names)
        + f"; the asynchronous checkpoints committed (best {best}, ring "
        f"{os.path.basename(ring)}); kernel launches while training: "
        f"{launches}")

    # ---- the step: time, memory, split, IBN share; parity with the CPU
    state = FIT.build_model_and_state(cfg, dataset, seed=1, device="cuda")
    CK.restore_state(ring, state)
    timing = time_train_step(cfg, dataset, state, banks[0],
                             label="ResNet50-IBN-a 320x320 bf16")
    shapes = _fashion_capture_shapes(state.model, torch.zeros(
        (FASHION_P * 4, 3) + FASHION_HW, device="cuda").to(
        memory_format=torch.channels_last))
    lay = _ibn_layout(state.model, shapes)
    log(f"IBN layers (13, layers 1-3) in train mode at the step's shapes "
        f"({shapes[0]} ... {shapes[-1]}), forward + backward, {gpu}: "
        f"{lay['ibn']:.3f} ms a step = {lay['ibn'] / timing['step_ms']:.4f} "
        f"of the median step; of it their layout copies (halves made "
        f"contiguous, concatenation, the next conv's channels_last copy) "
        f"{lay['copies']:.3f} ms = {lay['copies'] / timing['step_ms']:.4f} "
        f"of the step; under bf16 autocast IN gives {lay['in_dtype']} and "
        f"IBN {lay['ibn_dtype']} (channels_last out: "
        f"{lay['ibn_channels_last']}); bf16 IN against fp32 IN of the same "
        f"bf16 input: {lay['in_vs_fp32_ulp']:.2f} bf16 ulp at most")
    del state
    torch.cuda.empty_cache()
    parity = train_parity(cfg, dataset, banks[0], pids_n=FASHION_PARITY_P,
                          label="320x320")
    timing.update(parity, ibn_ms=lay["ibn"], ibn_copies_ms=lay["copies"])

    # ---- ONLY_TEST with KEEP_CAMID_CENTROIDS both ways, against the CPU
    captured = []
    compute = evaluate.compute_reid_metrics

    def capture(cfg_, emb, pids, camids, nq, use_centroids, **kw):
        res = compute(cfg_, emb, pids, camids, nq, use_centroids, **kw)
        m = res[0] if kw.get("return_evaluator") else res
        captured.append((cfg_, emb, pids, camids, nq, use_centroids, m))
        return res

    n_val = FASHION_EVAL_PIDS * (FASHION_QUERIES + FASHION_GALLERY)
    evaluate.compute_reid_metrics = capture
    try:
        for keep in (True, False):
            captured.clear()
            t0 = time.perf_counter()
            res = runner.main(_fashion_opts(
                root, json_train, os.path.join(base, f"logs_test_{keep}"),
                "TEST.ONLY_TEST", "True", "MODEL.PRETRAIN_PATH", best,
                "MODEL.KEEP_CAMID_CENTROIDS", str(keep)))
            secs = time.perf_counter() - t0
            require(len(captured) == 2, "fashion ONLY_TEST: two evaluations")
            for cfg_, emb, pids, camids, nq, cent, m in captured:
                require(emb.shape == (n_val, DIM) and np.isfinite(emb).all(),
                        f"fashion ONLY_TEST: bad embeddings {emb.shape}")
                ref = compute(cfg_, emb, pids, camids, nq, cent,
                              device="cpu")
                tag = "centroids" if cent else "plain"
                require(np.array_equal(m.all_topk, ref.all_topk)
                        and np.array_equal(m.cmc, ref.cmc)
                        and abs(m.mAP - ref.mAP) <= 1e-6,
                        f"fashion ONLY_TEST keep={keep} {tag}: card metrics "
                        f"differ from the CPU's")
                require(res[f"test_{tag}_mAP"] == m.mAP,
                        f"fashion ONLY_TEST {tag}: runner output")
                log(f"fashion ONLY_TEST, KEEP_CAMID_CENTROIDS {keep}, {tag}: "
                    f"mAP {m.mAP:.6f}, R1 {m.all_topk[0]:.6f} (CPU from the "
                    f"same embeddings: mAP {ref.mAP:.6f}, CMC and top-k "
                    f"equal), {secs:.2f} s for both modes")
    finally:
        evaluate.compute_reid_metrics = compute

    # ---- bf16 serving over a create_embeddings index of the gallery
    gallery_dir = os.path.join(root, "gallery")
    t0 = time.perf_counter()
    emb, paths = create_embeddings.main([
        "--config_file", opts[1], "MODEL.PRETRAIN_PATH", best,
        "DATASETS.ROOT_DIR", gallery_dir,
        "OUTPUT_DIR", os.path.join(base, "index")])
    n_gal = FASHION_EVAL_PIDS * FASHION_GALLERY
    require(emb.shape == (n_gal, DIM) and np.isfinite(emb).all(),
            f"fashion index: {emb.shape}")
    log(f"create_embeddings of the gallery: {emb.shape[0]} x {emb.shape[1]} "
        f"in {time.perf_counter() - t0:.2f} s")
    scfg = _fashion_cfg(opts + ["MODEL.PRETRAIN_PATH", best])
    model = load_inference_model(scfg, "cuda")
    n_req = FASHION_REQUESTS * REQUEST
    imgs = np.stack([load_and_resize(str(p), FASHION_HW)
                     for p in paths[:n_req]])
    services = {k: RetrievalService(scfg, emb, paths, k=k, device="cuda",
                                    model=model) for k in (10, 100)}
    torch.cuda.synchronize()
    reset_launch_counts()
    answers = {}
    with _recording(service_mod, "embed_query") as emb_calls:
        for k, svc in services.items():
            for s in range(0, n_req, REQUEST):
                d, idx, _ = svc.query_arrays(imgs[s:s + REQUEST])
                require(d.shape == (REQUEST, svc.k) and np.isfinite(d).all()
                        and (idx[:, 0] == np.arange(s, s + REQUEST)).all(),
                        f"fashion serving k={k}: top-1 is not the own row")
                answers[(k, s)] = (d, idx)
        torch.cuda.synchronize()
        served = launch_counts()
    for name in BF16_KERNELS:
        require(served[name] > 0, f"fashion serving launched no {name}")
    # every answer against torch.topk over the exact distances of the
    # embeddings the service computed for that request to the rows it
    # holds: its distances are those rows' exact distances, its rows are
    # distinct, and at each rank its distance is the exact k-th smallest's
    # up to what selection on bf16 can swap: a score q.g of bf16 inputs
    # summed in fp32 is off by at most d = (2^-7 + 2^-12) |q| |g|, its bf16
    # key (k=10) by 2^-8 of its size, so two rows trade places only within
    # twice the score's error, 2 x (2^-8 (|score| + 2d) + 2d), per query
    require(len(emb_calls) == len(answers),
            f"fashion serving: {len(emb_calls)} embeds for {len(answers)} "
            f"requests")
    g64 = services[10]._gf32[:n_gal].double()
    gn64 = (g64 * g64).sum(1)
    worst = {"exact": 0.0, "excess": 0.0, "margin": np.inf}
    same = {10: 0, 100: 0}
    for ((k, s), (d, idx)), (_, _, e) in zip(answers.items(), emb_calls):
        e64 = e.double()
        score = gn64[None] - 2 * e64 @ g64.T
        full = (e64 * e64).sum(1)[:, None] + score
        ref_d, ref_i = torch.topk(full, k, dim=1, largest=False)
        err = 2 * (2.0 ** -7 + 2.0 ** -12) * e64.norm(dim=1) \
            * gn64.sqrt().max()
        bound = 2 * (2.0 ** -8 * (score.abs().max(1).values + err) + err)
        ti = torch.from_numpy(idx).cuda()
        td = torch.from_numpy(d).cuda().double()
        exact = (td - torch.gather(full, 1, ti)).abs().max().item()
        excess = (td - ref_d).max().item()
        below = (ref_d - td).max().item()
        require(all(len(set(r)) == k for r in idx.tolist()),
                f"fashion serving k={k}: a row returned twice")
        require(exact <= MESH_TOL and below <= MESH_TOL,
                f"fashion serving k={k}: distances {exact:.2e} from the "
                f"exact ones, {below:.2e} below the exact top-k")
        require(((td - ref_d) <= bound[:, None]).all(),
                f"fashion serving k={k}: a distance exceeds the exact top-k "
                f"beyond the bf16 selection bound")
        worst["exact"] = max(worst["exact"], exact)
        worst["excess"] = max(worst["excess"], excess)
        worst["margin"] = min(worst["margin"], bound.min().item())
        same[k] += int((ti == ref_i).all(dim=1).sum())
    log(f"fashion serving against torch.topk over the exact (float64) "
        f"distances of the same embeddings, {FASHION_REQUESTS} requests at "
        f"each k: distances exact within {worst['exact']:.2e} (tol "
        f"{MESH_TOL}), rows distinct, at each rank at most "
        f"{worst['excess']:.2e} above the exact k-th smallest (bf16 "
        f"selection bound at least {worst['margin']:.2e}, per query); "
        f"indices equal outright in {same[10]} of {n_req} rows at k=10, "
        f"{same[100]} of {n_req} at k=100")
    for k, svc in services.items():
        lat = request_ms(svc, imgs[:REQUEST], 20)
        busy = device_busy_ms(lambda svc=svc: svc.query_arrays(
            imgs[:REQUEST]), 10)
        log(f"fashion serving, bf16, k={k}, {REQUEST}-image requests of "
            f"320x320 against the {n_gal}-row index, {gpu}: p50 "
            f"{np.median(lat):.3f} ms (host clock, 20 requests), device "
            f"busy " + (f"{busy:.4f} ms" if busy else "not measured")
            + " a request")
    log(f"fashion serving: every top-1 of {2 * FASHION_REQUESTS} requests "
        f"is the image's own row; kernel launches (k=10 and k=100, "
        f"{FASHION_REQUESTS} requests each): {served}")

    # ---- the int8 IBN embed: TPU.INT8_EVAL's fold and calibration, then
    # the fused engine against the unfused one on the same quantized tree
    qcfg = scfg.clone()
    qcfg.TPU.INT8_EVAL = True
    store = ImageStore(FASHION_HW, True)
    t0 = time.perf_counter()
    q = Q.quantize_for_serving(qcfg, model, dataset.val, store)
    torch.cuda.synchronize()
    require(any(k.endswith(".pre") for k in q.qtree["act_scales"]),
            "the IBN layers have no .pre requantization point")
    log(f"int8 fold + calibration on the trained checkpoint "
        f"({len(q.qtree['act_scales'])} activation scales, 13 of them the "
        f"IBN layers' .pre): {time.perf_counter() - t0:.2f} s")
    plan, stem_relu = q._static["plan"], q._static["stem_relu"]
    fused = Q.QuantizedEmbed(q.qtree, plan, stem_relu, use_pallas=True,
                             acc_dtype=torch.int32)
    unfused = Q.QuantizedEmbed(q.qtree, plan, stem_relu, use_pallas=False,
                               acc_dtype=torch.int32)
    x_all = torch.from_numpy(imgs).cuda()
    dtype = torch.bfloat16 if scfg.USE_MIXED_PRECISION else torch.float32
    with torch.inference_mode():
        torch.cuda.synchronize()
        reset_launch_counts()
        e_f = torch.cat([fused(x_all[s:s + REQUEST])
                         for s in range(0, n_req, REQUEST)])
        torch.cuda.synchronize()
        int8_launches = launch_counts()
        e_u = torch.cat([unfused(x_all[s:s + REQUEST])
                         for s in range(0, n_req, REQUEST)])
        e_b = torch.cat([embed_query(model, x_all[s:s + REQUEST],
                                     scfg.INPUT.PIXEL_MEAN,
                                     scfg.INPUT.PIXEL_STD, dtype,
                                     normalize=True)
                         for s in range(0, n_req, REQUEST)])
    calls = n_req // REQUEST
    expect = embed_requant_shapes(REQUEST, "resnet50_ibn_a", (80, 80))
    per_call = {n: sum(c for (name, *_), c in expect.items() if name == n)
                for n in ("matmul_requant", "conv3x3_requant")}
    require(per_call == {"matmul_requant": 23, "conv3x3_requant": 14},
            f"IBN-a plan: {per_call}")
    require(all(int8_launches[n] == c * calls for n, c in per_call.items()),
            f"int8 IBN embed launches over {calls} calls: {int8_launches}")
    require(torch.isfinite(e_f).all() and torch.isfinite(e_u).all(),
            "int8 IBN embeddings not finite")
    rel = ((e_f - e_u).norm(dim=1) / e_u.norm(dim=1)).max().item()
    cos_fu = torch.nn.functional.cosine_similarity(e_f, e_u).min().item()
    ef_n = e_f / e_f.norm(dim=1, keepdim=True)
    cos_b = (ef_n * e_b).sum(dim=1)

    # the same rounding question layer by layer: at every fused conv of
    # the unfused forward, the fused path on the same int8 input
    f = dict(q.qtree)
    f.update(q._static)
    paired = _PairedInt8(Q._Int8Engine(f, False, torch.int32),
                         Q._Int8Engine(f, True, torch.int32))
    with torch.inference_mode():
        Q._backbone_forward(paired, f, x_all[:REQUEST])
    changed = sum(d[1] for d in paired.diffs)
    total = sum(d[2] for d in paired.diffs)
    worst_q = max(d[3] for d in paired.diffs)
    require(len(paired.diffs) == 37, f"{len(paired.diffs)} fused convs")
    require(worst_q <= 1, f"a fused conv differs from the unfused engine "
            f"by {worst_q} quanta")
    require(changed <= 1e-2 * total, f"{changed} of {total} activations "
            f"differ between the fused and unfused convs")
    require(rel <= INT8_FUSED_TOL, f"int8 IBN embed, fused vs unfused: "
            f"relative L2 {rel:.3e} (tol {INT8_FUSED_TOL})")
    log(f"int8 IBN embed, fused engine (K5, K6) against the unfused engine "
        f"(exact fp64 convs, then a separate requantization) on the same "
        f"quantized tree, {n_req} images, {gpu}: relative L2 at most "
        f"{rel:.3e} (tol {INT8_FUSED_TOL}), cosine at least {cos_fu:.6f}; "
        f"layer by layer, on the same int8 input: {changed} of {total} "
        f"activations ({changed / total:.2e}) differ, by at most {worst_q} "
        f"quantum (the epilogue rounds scale x acc + bias once where the "
        f"unfused engine rounds acc x s_in x w_scale + b, then divides by "
        f"s_out)")
    log(f"int8 vs bf16 IBN embedding cosine over the {n_req} images: min "
        f"{cos_b.min().item():.6f}, mean {cos_b.mean().item():.6f} (printed, "
        f"not held: after one epoch these seeded weights sit near the JAX "
        f"package's gate, min > 0.99 against fp32 in tests/test_quantized.py, "
        f"on either side of it from run to run)")

    # each K5 / K6 launch of one call against its plain version
    mm, conv = C.matmul_requant, C.conv3x3_requant
    errs = {"matmul_requant": 0, "conv3x3_requant": 0}
    seen = {}

    def checked(name, kern, plain, key):
        def run(*args, **kw):
            got = kern(*args, **kw)
            kw.pop("w_packed", None)
            ref = plain(*args, **kw)
            require(torch.equal(got, ref), f"{name} {key(*args)} differs "
                    f"from its plain version in the IBN embed")
            errs[name] = max(errs[name], int((got.int() - ref.int()).abs()
                                             .max()))
            seen[(name, key(*args))] = seen.get((name, key(*args)), 0) + 1
            return got
        return run

    C.matmul_requant = checked(
        "matmul_requant", mm, C.matmul_requant_plain,
        lambda x, w, *a, **k: (x.shape[0], x.shape[1], w.shape[1]))
    C.conv3x3_requant = checked(
        "conv3x3_requant", conv, C.conv3x3_requant_plain,
        lambda x, w, *a, **k: tuple(x.shape) + (w.shape[3],))
    try:
        with torch.inference_mode():
            fused(x_all[:REQUEST])
    finally:
        C.matmul_requant, C.conv3x3_requant = mm, conv
    want = {}
    for (n, dims, _, _), c in expect.items():
        want[(n, dims)] = want.get((n, dims), 0) + c
    require(seen == want, f"K5/K6 shapes of the IBN embed: "
            f"{sorted(seen.items())} against the plan's "
            f"{sorted(want.items())}")
    log("int8 IBN embed, one call of 8 images: every K5 / K6 launch equals "
        "its plain version bit for bit on its own inputs: " + "; ".join(
            f"{'K5' if n == 'matmul_requant' else 'K6'} {dims} x{c}"
            for (n, dims), c in sorted(seen.items())))

    # timings: the call at 8 and 256 images, split by part; per shape
    x256 = torch.cat([x_all] * (256 // n_req))
    for batch in (REQUEST, 256):
        xb = x256[:batch]
        with torch.inference_mode():
            ms8 = cuda_ms(lambda: fused(xb), iters=5, warmup=2)
            msb = cuda_ms(lambda: embed_query(
                model, xb, scfg.INPUT.PIXEL_MEAN, scfg.INPUT.PIXEL_STD,
                dtype, normalize=True), iters=5, warmup=2)
            split = _int8_device_split(fused, xb)
        log(f"int8 IBN embed, {batch} images of 320x320, {gpu}: {ms8:.3f} "
            f"ms a call (CUDA events; bf16 embed {msb:.3f} ms); device time "
            f"of one call (torch.profiler, {split['traced']} K5/K6 launches "
            f"traced): " + ", ".join(
                f"{k} " + ("not measured" if v is None else f"{v:.3f} ms")
                for k, v in split.items() if k != "traced"))
    with torch.inference_mode():   # per shape, beside torch._int_mm
        phase_timing_requant(fused, x256[:REQUEST])
    return {"launches": int8_launches, "errs": errs, "timing": timing}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    import centroids_reid_tpu_torch  # noqa: F401  (fails outside the repo)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    seconds = {}

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[phase] = time.perf_counter() - t0
        log(f"-- phase {phase}: {seconds[phase]:.1f} s")
        return out

    timed("1", phase_env)
    timed("2", phase_build)
    errs = timed("3", phase_compare)
    k2u_err, k2u_launches = timed("3a", phase_compare_k2u)
    errs.update(k2u_err)
    errs.update(timed("3b", phase_compare_int8))
    k8 = timed("3c", phase_k8, gpu_line())
    errs.update(k8["errs"])
    k9 = timed("3d", phase_k9, gpu_line())
    errs.update(k9["errs"])
    with tempfile.TemporaryDirectory() as tmp:
        state = timed("4", phase_serve, tmp)
        int8_state = timed("4b", phase_serve_int8, state)
        ckpt = state["cfg"].MODEL.PRETRAIN_PATH
        eval_state = timed("5", phase_eval, tmp, ckpt)
        cli_launches = timed("6", phase_cli, tmp, ckpt, eval_state["root"])
        times = timed("7", phase_timing, state, int8_state)
        train = timed("8", phase_train, tmp, ckpt, eval_state["root"])
        trained = train["best"]
        timed("9", phase_serve_http, state, tmp, trained, eval_state["root"])
        timed("11", phase_artifacts, state, int8_state, tmp)
        timed("13", phase_mesh, state, int8_state, tmp, eval_state["root"],
              gpu_line())
        timed("14", phase_dist, tmp, train)
        fashion = timed("15", phase_fashion, tmp)
    torch.cuda.empty_cache()
    stream = timed("10", phase_eval_stream, gpu_line())
    timed("12", phase_orbax, gpu_line())
    timed("13b", phase_mesh_eval, gpu_line(), stream)
    # each kernel's launches from the path it was read on: K1 and K2 the
    # bf16 serving path, K2u its entry point, K3 get_similar, K4 the int8
    # serving path, K5 and K6 the int8 serving path and phase 15's int8
    # IBN embed (80x80, 40x40 and 20x20 feature maps), K7 phase 10's
    # whole-cell evaluation, K8 and K9 phase 3c's extract_embeddings (a
    # batch)
    for name, err in fashion["errs"].items():
        errs[name] = max(errs[name], err)
    errs.update(stream["errs"])
    times.update(stream["times"])
    times.update(k8["times"])
    times.update(k9["times"])
    launches = {
        "scores": state["launches"]["scores"],
        "stream_topk": state["launches"]["stream_topk"],
        "stream_topk_unpacked": k2u_launches["stream_topk_unpacked"],
        "kpass_topk": cli_launches["kpass_topk"],
        "scores_i8": int8_state["launches"]["scores_i8"],
        "matmul_requant": int8_state["launches"]["matmul_requant"]
        + fashion["launches"]["matmul_requant"],
        "conv3x3_requant": int8_state["launches"]["conv3x3_requant"]
        + fashion["launches"]["conv3x3_requant"],
        **stream["k7_launches"],
        **k8["launches"],
    }
    for name, embed in (("bf16", "cuDNN"), ("int8", "unfused int8 convs")):
        log(f"{name} evaluation kernel launches (no hand-written kernel: "
            f"{embed} embed, matmul distances, argsort): "
            f"{eval_state['runs'][name]['launches']}")
    log(f"re-ranked evaluation kernel launches (K3 ranks each row of the "
        f"re-ranker's distance matrix): "
        f"{eval_state['runs']['rerank']['launches']}")
    log("seconds by phase: " + ", ".join(f"{k} {v:.1f}"
                                         for k, v in seconds.items()))
    log(f"all checks passed in {time.perf_counter() - t_start:.1f} s")
    kernels = [
        {"name": name, "route": "cuda", "source": CSRC + source,
         "replaces": replaces, "launches": launches[name],
         "max_abs_err": errs[name], **times[name]}
        for name, (source, replaces) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
