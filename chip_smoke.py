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
  the gallery images as queries.

Times the embeds, the requests and the kernels (with each kernel's bound
and, where one PyTorch call computes the same function, that call) with
CUDA events, and a request's device busy time with ``torch.profiler``.
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


def phase_build() -> None:
    from centroids_reid_tpu_torch.ops import _build

    log("== phase 2: build kernels")
    t0 = time.perf_counter()
    _build.load()
    log(f"kernels ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds:.1f} s)")
    kernel = "?"
    for line in _build.build_log.splitlines():
        named = re.search(r"entry function '\w*?\d+([a-z0-9_]+_kernel)"
                          r"(ILi(\d+)E)?", line)
        if named:
            kernel = named.group(1) + (f"<{named.group(3)}>"
                                       if named.group(3) else "")
        elif "Used" in line and "registers" in line:
            log(f"  ptxas {kernel}: {line.split(':', 1)[1].strip()}")


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
    torch.cuda.synchronize()
    return errs


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

    # K5: the 1x1 convs of the embed at 8 images per request
    cases = [
        ("[16384,64]x[64,256] residual+ReLU (layer1 conv3)", 16384, 64, 256,
         True, True),
        ("[16384,256]x[256,64] ReLU (layer1 conv1)", 16384, 256, 64, False,
         True),
        ("[1024,1024]x[1024,2048] no ReLU (layer4 downsample)", 1024, 1024,
         2048, False, False),
    ]

    def int_err(got, ref):
        return (got.int() - ref.int()).abs().max().item()

    errs["matmul_requant"] = errs["conv3x3_requant"] = 0
    for label, m, k, n, with_res, relu in cases:
        x, w, scale, bias, res, rs = requant_inputs(
            gen, m, k, n, (m, n) if with_res else None)
        got = C.matmul_requant(x, w, scale, bias, res=res, res_scale=rs,
                               relu=relu)
        ref = C.matmul_requant_plain(x, w, scale, bias, res=res,
                                     res_scale=rs, relu=relu)
        errs["matmul_requant"] = max(errs["matmul_requant"], int_err(got, ref))
        require(torch.equal(got, ref), f"K5 {label} differs")
        log(f"K5 matmul_requant {label}: equal "
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

    # K6: the stride-1 3x3 convs of layer1 and layer4
    for b, h, wd, k in ((8, 64, 32, 64), (8, 16, 8, 512)):
        for with_res in (False, True):
            x, w, scale, bias, res, rs = requant_inputs(
                gen, b * h * wd, 9 * k, k, (b, h, wd, k) if with_res else None)
            x = x[:, :k].reshape(b, h, wd, k).contiguous()
            w = w.reshape(3, 3, k, k)
            got = C.conv3x3_requant(x, w, scale, bias, res_nhwc=res,
                                    res_scale=rs)
            ref = C.conv3x3_requant_plain(x, w, scale, bias, res_nhwc=res,
                                          res_scale=rs)
            errs["conv3x3_requant"] = max(errs["conv3x3_requant"],
                                          int_err(got, ref))
            require(torch.equal(got, ref),
                    f"K6 [{b},{h},{wd},{k}] res={with_res} differs")
            log(f"K6 conv3x3_requant [{b},{h},{wd},{k}] -> {k} channels, "
                f"{'residual' if with_res else 'no residual'}, ReLU: equal")
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


def time_pair(name: str, kern, plain, shape: str, library=None):
    """(kernel ms, plain ms, library ms or None), kernel and plain each the
    mean of two CUDA-event runs taken plain, kernel, kernel, plain (one
    card, one call, in turns); the library call timed twice after them."""
    p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                      cuda_ms(plain))
    lib = None
    if library is not None:
        lib = (cuda_ms(library) + cuda_ms(library)) / 2
    log(f"{name} {shape}: kernel {k1:.4f}/{k2:.4f} ms, plain "
        f"{p1:.4f}/{p2:.4f} ms"
        + (f", library call {lib:.4f} ms" if lib is not None else ""))
    return (k1 + k2) / 2, (p1 + p2) / 2, lib


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
    full = "[128,2048]x[100352,2048]"
    # name -> (kernel, plain, shape, library call or None, bytes moved,
    #          operations, operation type)
    score_out = torch.empty((128, gp), device="cuda")
    topk_out = (torch.empty((128, 10), device="cuda"),
                torch.empty((128, 10), dtype=torch.int64, device="cuda"))
    mm_ops = 2.0 * 128 * gp * DIM
    cases = {
        "scores": (lambda: R.scores(q, g, gn),
                   lambda: R.scores_plain(q, g, gn), full,
                   # TF32 is off: one fp32 addmm on fp32 copies
                   lambda: torch.addmm(gn, q32, g32.T, alpha=-2.0),
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
            lambda: C.matmul_requant(x5, w5, sc5, b5, res=r5, res_scale=rs5),
            lambda: C.matmul_requant_plain(x5, w5, sc5, b5, res=r5,
                                           res_scale=rs5),
            "[16384,64]x[64,256] residual+ReLU", None,
            # r5 twice: the residual read and the int8 output written
            nbytes(x5, w5, sc5, b5, r5, rs5, r5), 2.0 * 16384 * 64 * 256,
            "int8"),
        "conv3x3_requant": (
            lambda: C.conv3x3_requant(x6, w6, sc6, b6),
            lambda: C.conv3x3_requant_plain(x6, w6, sc6, b6),
            "[8,64,32,64] -> 64 channels, ReLU", None,
            # x6 twice: the input read and the same-shape output written
            nbytes(x6, w6, sc6, b6, x6), 2.0 * 16384 * 9 * 64 * 64, "int8"),
    }
    times = {}
    for name, (kern, plain, shape, lib, moved, ops, kind) in cases.items():
        k_ms, p_ms, lib_ms = time_pair(name, kern, plain, shape, lib)
        b_ms, b_by = bound(name, moved, ops, kind)
        times[name] = {"ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                       "bound_ms": b_ms, "bound_by": b_by}
        log(f"{name}: {moved / k_ms / 1e6:.1f} GB/s moved, "
            f"{b_ms / k_ms:.3f} of its bound")
    return times


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
