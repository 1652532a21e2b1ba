#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the retrieval kernels from ``centroids_reid_tpu_torch/ops/csrc``,
holds each against its plain PyTorch version at the serving path's shapes,
then serves ResNet-50 (BNNeck, last stride 1, 256x128, bf16 embed) with
seeded random weights against a 100,000 x 2048 bf16 gallery through
``RetrievalService`` at k=10 and k=100, and times the embed, the requests
and the kernels with CUDA events, and a request's device busy time with
``torch.profiler``. Exits non-zero on any failure; the last
line is ``{"ok": true, "device": {...}}``. Imports no JAX.
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
SOURCE = "centroids_reid_tpu_torch/ops/csrc/retrieval.cu"
REPLACES = {
    "scores": "centroids_reid_tpu/ops/retrieval.py:141",
    "stream_topk": "centroids_reid_tpu/ops/retrieval.py:360",
    "kpass_topk": "centroids_reid_tpu/ops/retrieval.py:192",
}


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
        named = re.search(r"entry function '\w*?\d+([a-z_]+_kernel)E", line)
        if named:
            kernel = named.group(1)
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


def _random_reid_model(cfg, imgs: np.ndarray):
    """Seeded ReidModel whose BN running statistics are calibrated on
    ``imgs`` (one train-mode pass, cumulative averages), as a trained
    model's would be: without it a random deep trunk maps every image to
    nearly the same direction."""
    import torch

    from centroids_reid_tpu_torch.models import create_model

    model = create_model(cfg, generator=torch.Generator().manual_seed(SEED))
    model = model.cuda().to(memory_format=torch.channels_last).train()
    for m in model.modules():
        if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
            m.reset_running_stats()
            m.momentum = None
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
    from centroids_reid_tpu_torch.ops import LAUNCHES, reset_launch_counts

    log("== phase 4: serve")
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
    launches = dict(LAUNCHES)
    log(f"kernel launches while serving: {launches}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} was not launched on the main path")
    return {"launches": launches, "model": model, "services": services,
            "imgs": imgs, "cfg": cfg}


def phase_timing(state: dict) -> dict:
    """Embeddings/s, request p50 per k, and (kernel ms, plain ms) per
    kernel, returned for the kernels line."""
    import torch

    from centroids_reid_tpu_torch.inference.service import embed_query
    from centroids_reid_tpu_torch.ops import retrieval as R

    log("== phase 5: timings (CUDA events unless stated)")
    cfg, model = state["cfg"], state["model"]
    x = torch.from_numpy(_images(256, SEED + 2)).cuda()

    def embed():
        with torch.inference_mode():
            embed_query(model, x, cfg.INPUT.PIXEL_MEAN, cfg.INPUT.PIXEL_STD,
                        torch.bfloat16, normalize=True)

    ms = cuda_ms(embed, iters=10)
    log(f"embed ResNet-50 256x128 bf16, batch 256: {ms:.3f} ms/batch = "
        f"{256 / ms * 1e3:.1f} embeddings/s")

    imgs = state["imgs"][:REQUEST]
    for k, svc in state["services"].items():
        request_ms(svc, imgs, 5)
        # unprofiled, profiled, unprofiled: the busy time and the latency
        # it is divided by come from the same run
        before = request_ms(svc, imgs, 30)
        busy = device_busy_ms(svc, imgs, 10)
        after = request_ms(svc, imgs, 30)
        p50 = np.percentile(before + after, 50)
        log(f"request of {REQUEST} images, k={k} (host clock, 2 x 30 runs): "
            f"p50 {p50:.4f} ms (windows {np.percentile(before, 50):.4f} / "
            f"{np.percentile(after, 50):.4f}), p90 "
            f"{np.percentile(before + after, 90):.4f} ms")
        log(f"  device busy per request (torch.profiler, 10 requests "
            f"between the windows): "
            + (f"{busy:.4f} ms; idle share 1 - busy / p50 = "
               f"{1 - busy / p50:.4f}" if busy is not None
               else "not measured (the profiler saw no device time)"))

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    gp = -(-GALLERY_ROWS // R._G_TILE) * R._G_TILE
    q, g = unit_rows(128, gen, torch.bfloat16), unit_rows(gp, gen,
                                                          torch.bfloat16)
    gn = gn_row(g, GALLERY_ROWS)
    x3 = torch.randn((128, gp // 8), generator=gen, device="cuda")
    pairs = {
        "scores": (lambda: R.scores(q, g, gn),
                   lambda: R.scores_plain(q, g, gn), "[128,2048]x[100352,2048]"),
        "stream_topk": (lambda: R.stream_topk(q, g, gn, 10),
                        lambda: R.stream_topk_plain(q, g, gn, 10),
                        "k=10 over [128,2048]x[100352,2048]"),
        "kpass_topk": (lambda: R.kpass_topk(x3, 100),
                       lambda: R.kpass_topk_plain(x3, 100),
                       "[128,12544] k=100"),
    }
    times = {}
    for name, (kern, plain, shape) in pairs.items():
        # plain, kernel, kernel, plain: one card, one call, in turns
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"{name} {shape}: kernel {k1:.4f}/{k2:.4f} ms, plain "
            f"{p1:.4f}/{p2:.4f} ms")
    # every byte K1 moves: q, g and gn read, the fp32 scores written
    k1_bytes = sum(t.numel() * t.element_size() for t in (q, g, gn)) \
        + q.shape[0] * gp * 4
    log(f"scores moves {k1_bytes} bytes: "
        f"{k1_bytes / times['scores'][0] / 1e6:.1f} GB/s")
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
    phase_env()
    phase_build()
    errs = phase_compare()
    with tempfile.TemporaryDirectory() as tmp:
        state = phase_serve(tmp)
    times = phase_timing(state)
    kernels = [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": state["launches"][name],
         "max_abs_err": errs[name], "ms": times[name][0],
         "plain_ms": times[name][1]}
        for name in REPLACES
    ]
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
