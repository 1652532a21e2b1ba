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
  Market-1501-layout dataset, in bf16 and with ``TPU.INT8_EVAL`` (the
  reference's serving engine: unfused int8 convs, bf16 accumulator), both
  centroid modes, each metric held against the same metric computed on the
  CPU from the same embeddings;
* the offline CLIs: ``inference.create_embeddings`` (with and without
  centroids) and ``inference.get_similar`` at ``--topk`` 10 and 100 (K3),
  the gallery images as queries;
* training (phase 8): CTL training through ``engine.runner.main --mode
  ctl`` on a synthetic train split of Market-1501's size (751 pids, 12,936
  JPEGs), 64 x 4 images a step from the image bank on the card, 2 epochs
  with validation and checkpoints from a torchvision-layout backbone file,
  a resume from ``checkpoint_epoch1``, ONLY_TEST of the best checkpoint;
  the step's time, rate, memory, idle share, profiler split and share of
  the bf16 peak; one full-width step on the card against the CPU. No
  hand-written kernel runs there.

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
8-image int8 embed call.
Exits non-zero on any failure; the last line is ``{"ok": true, "device":
{...}}``. Imports no JAX.
"""

from __future__ import annotations

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
}
BF16_KERNELS = ("scores", "stream_topk", "kpass_topk")
# (W, k) of each K3 launch on the paths against the 100,352-row gallery:
# the group minima (100352 / 8 columns) and the gathered 8k columns, at
# k=100 (serve-k100), k=26 (int8 k=10: the margin k + 16) and k=125 (int8
# k=100: k + k / 4)
K3_SHAPES = ((12544, 100), (800, 100), (12544, 26), (208, 26), (12544, 125),
             (1000, 125))
INT8_KERNELS = ("kpass_topk", "scores_i8", "matmul_requant",
                "conv3x3_requant")


def log(msg: str) -> None:
    print(msg, flush=True)


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


def device_busy_ms(svc, imgs, n: int):
    """Device time per request in ms: torch.profiler's kernel and copy
    time over ``n`` requests (one stream, so nothing overlaps). None when
    the profiler saw no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            svc.query_arrays(imgs)
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
    torch.cuda.synchronize()
    return errs


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


def embed_requant_shapes(batch: int) -> dict:
    """The K5 / K6 launches of one ResNet-50 (last stride 1) int8 embed
    call of ``batch`` 256x128 images, from the trunk's block plan, in
    launch order: {(kernel, dims, residual, ReLU): launches}; dims (M, K,
    N) for K5 and (B, H, W, K, N) for K6."""
    from centroids_reid_tpu_torch.models.quantized import _block_plan

    out: dict = {}

    def add(*key):
        out[key] = out.get(key, 0) + 1

    h, w, c = 64, 32, 64   # after the stem and the max pool
    for _, _, planes, stride, has_ds, _ in _block_plan("resnet50", 1):
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

    log("== phase 3b: int8 kernels against their plain versions")
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

    sms = _build.load().crt_sm_count()
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
                require(d.shape == (REQUEST, k) and np.isfinite(d).all(),
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
                require(d.shape == (REQUEST, k) and np.isfinite(d).all(),
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


def phase_eval(tmp: str, ckpt: str) -> dict:
    """ONLY_TEST through ``engine.runner.main`` (the configs default:
    ResNet-50, 256x128, bf16), then again with ``TPU.INT8_EVAL True``
    (the reference's serving engine: unfused int8 convs with a bf16
    accumulator, no hand-written kernel). Every metric the runner computed
    on the card is held against the same metric computed on the CPU from
    the same embeddings (captured at ``compute_reid_metrics``). Returns the
    launch counts and timings of both runs."""
    import os

    import torch

    from centroids_reid_tpu_torch.config import get_default_cfg
    from centroids_reid_tpu_torch.data import EvalLoader, ImageStore
    from centroids_reid_tpu_torch.data import init_dataset
    from centroids_reid_tpu_torch.engine import evaluate, runner
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
        m = compute(cfg, emb, pids, camids, nq, use_centroids, **kw)
        captured.append((cfg, emb, pids, camids, nq, use_centroids, m))
        return m

    evaluate.compute_reid_metrics = capture
    runs = {}
    try:
        for name, extra in (("bf16", ()),
                            ("int8", ("TPU.INT8_EVAL", "True"))):
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
                + f", two evaluations); kernel launches: {launches}")
            runs[name] = {"launches": launches, "seconds": secs,
                          "metrics": out}
    finally:
        evaluate.compute_reid_metrics = compute

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
    ``--topk`` 10 and 100: each query's top-1 is its own row. Returns the
    launch counts of the ``get_similar`` runs."""
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
    busy = device_busy_ms(svc, imgs, 10)
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


def kernel_device_us(fn, calls: int = 1) -> tuple:
    """``calls`` calls of ``fn``, after a warm-up call, under
    torch.profiler: ({kernel name: (device us, launches)} over everything
    they ran on the device, the launch counters of those calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from centroids_reid_tpu_torch.ops import launch_counts, reset_launch_counts

    fn()
    torch.cuda.synchronize()
    reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if (e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0
                or getattr(e, "is_user_annotation", False)):
            continue
        m = re.search(r"(\w+_kernel)(<[^>(]*>)?", e.key)
        name = m.group(1) + (m.group(2) or "") if m else e.key[:40]
        us, n = out.get(name, (0.0, 0))
        out[name] = (us + e.self_device_time_total, n + e.count)
    return out, launch_counts()


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
        with torch.inference_mode():
            per, counts = kernel_device_us(lambda: qfn(x[:batch]))
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
    holds no device time is taken again, up to three times in all."""
    for _ in range(3):
        per, _ = kernel_device_us(fn, calls)
        us = sum(us for us, _ in per.values())
        if us > 0:
            return us / calls
    raise AssertionError("the profiler saw no device time in three traces")


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


def phase_timing_requests(state: dict, int8_state: dict) -> None:
    """The device time of each hand-written kernel of one serve-k100 and
    one int8-k100 request (torch.profiler), per launch."""
    imgs = state["imgs"][:REQUEST]
    for name, svc in (("serve-k100", state["services"][100]),
                      ("int8-k100", int8_state["services"]["int8-k100"])):
        per, counts = kernel_device_us(lambda svc=svc: svc.query_arrays(imgs))
        total = sum(us for us, _ in per.values())
        parts = []
        for kname, counter in (("scores_kernel", "scores"),
                               ("scores_i8_kernel", "scores_i8"),
                               ("kpass_topk_kernel", "kpass_topk")):
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
    sms = _build.load().crt_sm_count()
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
        C.matmul_requant, C.conv3x3_requant = rec_mm, rec_conv
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                qfn(x)
                torch.cuda.synchronize()
        finally:
            C.matmul_requant, C.conv3x3_requant = mm, conv
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA
                     and "requant_gemm_kernel" in e.name),
                    key=lambda e: e.time_range.start)
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


def _phase_device_us(trace_path: str) -> dict:
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
              and e.get("name") in TRAIN_PHASES]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat", "").startswith("cuda_")
                 and "correlation" in e.get("args", {})}
    out = {name: 0.0 for name in TRAIN_PHASES + ("other",)}
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
    ``checkpoint_epoch1`` to epoch 3, ONLY_TEST of the best checkpoint; then
    the step's time, rate, memory, idle share, profiler split and share of
    the bf16 peak, and one full-width step on the card against the CPU."""
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
        t0 = time.perf_counter()
        base_out = runner.main(["--mode", "base", *_train_opts(
            root, logs, "MODEL.PRETRAINED", "True", "MODEL.PRETRAIN_PATH",
            pth, "DATALOADER.USE_RESAMPLING", "True", "SOLVER.MAX_EPOCHS",
            "1", "SOLVER.EVAL_PERIOD", "100")])
        base_s = time.perf_counter() - t0
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
    loss_keys = ("epoch_train_loss", "query_triplet", "query_xent",
                 "query_center", "epoch_dist_ap", "epoch_dist_an")
    ctl_keys = ("centroid_triplet", "l2_mean_centroid")
    for mode, recs, keys in (("ctl", records, loss_keys + ctl_keys),
                             ("base", base_records, loss_keys)):
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
                      ("ONLY_TEST", tested), ("base", base_out)):
        require(all(n in res and np.isfinite(res[n]) for n in names),
                f"{what}: metrics missing from {sorted(res)}")
        log(f"{what} double test: " + ", ".join(
            f"{n[5:]} {res[n]:.4f}" for n in names))
    require(not any(launches.values()),
            f"hand-written kernels launched while training: {launches}")
    log(f"runner: ctl 2 epochs + validation + double test {train_s:.1f} s, "
        f"resume at epoch 2 {resume_s:.1f} s, ONLY_TEST of {best} "
        f"{test_s:.1f} s, base 1 epoch + double test {base_s:.1f} s (host "
        f"clock, image bank decode included); state.pt of checkpoint_epoch1 "
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
    return timing


def time_train_step(cfg, dataset, state, bank_np) -> dict:
    """The bf16 train step at 64 x 4 images over one epoch of the resident
    path: per-step CUDA-event times, the epoch's wall time and its device
    busy time, peak memory, the profiler's split of 5 steps, and the step's
    share of the bf16 dense peak."""
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from centroids_reid_tpu_torch.data import TrainLoader
    from centroids_reid_tpu_torch.data.device_data import plan_to_arrays
    from centroids_reid_tpu_torch.engine.epoch_runner import make_augment
    from centroids_reid_tpu_torch.engine.steps import make_train_step

    model = state.model
    step = make_train_step(state, cfg, dataset.num_classes, "ctl")
    augment = make_augment(cfg)
    bank = torch.from_numpy(bank_np).to("cuda")
    plan = TrainLoader(dataset, cfg).plan_for_epoch(5)
    idx, labels, is_real = (torch.from_numpy(a[:, 0]).to(
        "cuda", torch.int64 if a.dtype != bool else torch.bool)
        for a in plan_to_arrays(plan, dataset.train))
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n_steps, pk = idx.shape

    def one(t):
        imgs = bank.index_select(0, idx[t])
        with torch.profiler.record_function("augment"):
            x = augment(imgs, is_real[t], gen)
        return step(x, labels[t], is_real[t])

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

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        for t in range(n_steps):
            one(t)
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t1
    busy_us = sum(e.self_device_time_total for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    busy = busy_us / 1e6

    with tempfile.TemporaryDirectory() as d:
        trace = f"{d}/trace.json"
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof5:
            for t in range(PROFILED_STEPS):
                with torch.profiler.record_function("gather"):
                    imgs = bank.index_select(0, idx[t])
                with torch.profiler.record_function("augment"):
                    x = augment(imgs, is_real[t], gen)
                step(x, labels[t], is_real[t])
            torch.cuda.synchronize()
        prof5.export_chrome_trace(trace)
        split = _phase_device_us(trace)

    flops, fwd = step_flops(model, torch.zeros(
        (pk, 3) + tuple(cfg.INPUT.SIZE_TRAIN), device="cuda").to(
        memory_format=torch.channels_last))
    share = flops / (med / 1e3) / PEAK_OPS["bf16"]
    gpu = gpu_line()
    log(f"train step, ResNet-50 256x128 bf16, {pk} images ({TRAIN_P} x "
        f"{TRAIN_K}), resident epoch of {n_steps} steps, {gpu}: median "
        f"{med:.2f} ms a step (CUDA events, first step excluded; min "
        f"{min(step_ms[1:]):.2f}, max {max(step_ms[1:]):.2f}) = "
        f"{pk / med * 1e3:.1f} images/s; epoch wall {wall:.3f} s = "
        f"{n_steps * pk / wall:.1f} images/s (host clock)")
    log(f"train epoch under torch.profiler, {gpu}: wall {wall_prof:.3f} s, "
        f"device busy {busy:.3f} s (kernels, copies and sets), idle share "
        f"{1 - busy / wall_prof:.4f}; against the unprofiled epoch's wall "
        f"{wall:.3f} s: {1 - busy / wall:.4f}; peak memory "
        f"{peak / 2**30:.2f} GiB (torch.cuda.max_memory_allocated, the "
        f"{bank.numel() / 2**30:.2f} GiB image bank included)")
    total = sum(split.values()) or 1.0
    log(f"device time of {PROFILED_STEPS} steps by phase (torch.profiler, "
        f"{gpu}, {total / 1e3:.1f} ms in all): " + ", ".join(
            f"{k} {v / 1e3:.1f} ms ({v / total:.3f})"
            for k, v in split.items()))
    log(f"step FLOPs from the layer shapes: forward {fwd / 1e12:.3f} TFLOP "
        f"(convs and classifier), step {flops / 1e12:.3f} TFLOP; at "
        f"{med:.2f} ms: {flops / (med / 1e3) / 1e12:.1f} TFLOP/s, {share:.4f}"
        f" of the bf16 dense peak (989 TFLOP/s; {gpu})")
    return {"step_ms": med, "images_per_s": pk / med * 1e3,
            "epoch_wall_s": wall, "device_busy_s": busy,
            "idle_share": 1 - busy / wall, "peak_bytes": peak,
            "split_us": split, "step_flops": flops, "peak_share": share}


def train_parity(cfg, dataset, bank_np) -> dict:
    """One ctl step of ResNet-50 at full width (P=8 x K=4 at 256x128, one
    mock, already augmented) from one state, on the card and on the CPU,
    in fp32 with TF32 off and in float64.

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
    fp32's."""
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
    cfg.USE_MIXED_PRECISION = False
    cfg.SOLVER.IMS_PER_BATCH = PARITY_P
    pids = [pid for pid, recs in sorted(dataset.train_dict.items())
            if len(recs) >= TRAIN_K][:PARITY_P]
    rows = [r.idx for pid in pids for r in dataset.train_dict[pid][:TRAIN_K]]
    labels = torch.tensor([dataset.train[i].pid for i in rows])
    is_real = torch.ones(len(rows), dtype=torch.bool)
    is_real[2 * TRAIN_K - 1] = False
    params = draw_augment_params(len(rows), torch.Generator().manual_seed(4),
                                 tuple(cfg.INPUT.SIZE_TRAIN),
                                 cfg.INPUT.PADDING, cfg.INPUT.PROB,
                                 cfg.INPUT.RE_PROB)
    x = apply_augment(torch.from_numpy(bank_np[rows]), is_real, params,
                      cfg.INPUT.PADDING, cfg.INPUT.PIXEL_MEAN,
                      cfg.INPUT.PIXEL_STD)
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

    bf16_rel = abs(mb["loss"] - mc["loss"]) / abs(mc["loss"])
    require(bf16_rel <= 2e-2, f"bf16 loss {mb['loss']} vs fp32 {mc['loss']}")
    log(f"full-width step parity ({PARITY_P} x {TRAIN_K} at 256x128, one "
        f"mock, TF32 off, {gpu_line()}): fp32 loss terms within "
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
        f"card: loss {mb['loss']:.6f}, {bf16_rel:.2e} from fp32 (tol 2e-2); "
        f"step {tc:.2f} s on the card (first call), {tp:.2f} s on the CPU, "
        f"float64 {tc64:.2f} s on the card, {t64:.2f} s on the CPU")
    return {"parity_loss_rel": worst_loss, "parity_grad64_rel": err64[worst64],
            "parity_grad32_whole": card_whole, "bf16_loss_rel": bf16_rel}


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
    phase_env()
    phase_build()
    errs = phase_compare()
    k2u_err, k2u_launches = phase_compare_k2u()
    errs.update(k2u_err)
    errs.update(phase_compare_int8())
    with tempfile.TemporaryDirectory() as tmp:
        state = phase_serve(tmp)
        int8_state = phase_serve_int8(state)
        ckpt = state["cfg"].MODEL.PRETRAIN_PATH
        eval_state = phase_eval(tmp, ckpt)
        cli_launches = phase_cli(tmp, ckpt, eval_state["root"])
        times = phase_timing(state, int8_state)
        phase_train(tmp, ckpt, eval_state["root"])
    # each kernel's launches from the path it was read on: K1 and K2 the
    # bf16 serving path, K2u its entry point, K3 get_similar, K4, K5 and K6
    # the int8 serving path
    launches = {
        "scores": state["launches"]["scores"],
        "stream_topk": state["launches"]["stream_topk"],
        "stream_topk_unpacked": k2u_launches["stream_topk_unpacked"],
        "kpass_topk": cli_launches["kpass_topk"],
        "scores_i8": int8_state["launches"]["scores_i8"],
        "matmul_requant": int8_state["launches"]["matmul_requant"],
        "conv3x3_requant": int8_state["launches"]["conv3x3_requant"],
    }
    for name, embed in (("bf16", "cuDNN"), ("int8", "unfused int8 convs")):
        log(f"{name} evaluation kernel launches (no hand-written kernel: "
            f"{embed} embed, matmul distances, argsort): "
            f"{eval_state['runs'][name]['launches']}")
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
