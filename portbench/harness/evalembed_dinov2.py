"""Driver "evalembed_dinov2": DINOv2 ViT-g/14 (with registers) evaluation
of Market-1501's test split, whole evaluations back to back:
``extract_embeddings`` (the trunk over every image, ``engine/evaluate.py``,
``models/dinov2.py``) then ``compute_reid_metrics`` without centroids.

The same shape as ``evalembed`` (TransReID's driver), whose images,
batches, evaluation, check rows and gaps it imports, as
``evalembed_swin`` does: set-up builds the model first (a port without the
DINOv2 backbone fails there, at once), draws the images (uint8 [N, H, W,
3] at the configuration's ``input_hw``, on the card), their identities
and cameras from the seed, lays them out as ``EvalLoader``'s batches and
runs one evaluation; the window runs whole evaluations until ``seconds``
have passed. ``correct`` holds ``check_rows`` rows of the last
evaluation's embeddings (the last partial batch's among them) against the
plain fp32 reference (``reference/dinov2.py``) on the same images and
weights, and its metrics against ``reference/rmap.py`` on the program's
own embeddings. The FLOPs an image are ``dinov2_flops.py``'s."""

from __future__ import annotations

import dataclasses
import time

from .common import Cell, Check, Outcome, log, port_cfg, subseed
from .evalembed import (
    batches,
    bf16_trunk,
    check_rows,
    embedding_gaps,
    evaluation,
    metric_gaps,
)
from .evalembed import images as _images


def spec(cell: Cell) -> dict:
    """The reference's ``spec`` from the configuration's widths."""
    w = cell.config["published"]
    return {k: w[k] for k in ("depth", "num_heads", "patch_size",
                              "num_register_tokens", "interpolate_antialias",
                              "ln_eps", "neck_feat", "pixel_mean",
                              "pixel_std")}


def images(cell: Cell):
    """``evalembed.images`` at the configuration's ``input_hw`` (the input
    size is assumed, not published)."""
    published = dict(cell.config["published"],
                     input_hw=cell.config["input_hw"])
    return _images(dataclasses.replace(
        cell, config=dict(cell.config, published=published)))


def build(cell: Cell):
    """(the port's config, the seeded DINOv2 model, made and drawn on the
    device)."""
    import torch

    try:
        from centroids_reid_tpu_torch.models import dinov2  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            f"portbench: the port has no DINOv2 backbone "
            f"(centroids_reid_tpu_torch.models.dinov2): {e}")
    from centroids_reid_tpu_torch.models import create_model

    cfg = port_cfg(cell.config, "eval")
    gen = torch.Generator(device=cell.device).manual_seed(
        subseed(cell.seed, "weights"))
    with torch.device(cell.device):   # parameters made and drawn there
        model = create_model(cfg, num_classes=0, generator=gen)
    return cfg, model.to(memory_format=torch.channels_last).eval()


def reference_embeddings(cell: Cell, model, imgs, rows, linear=None):
    """The plain reference's embeddings of ``rows`` on the same images and
    weights, fp32 [len(rows), D] on the device."""
    import torch

    from reference.dinov2 import embed

    idx = torch.from_numpy(rows).to(imgs.device)
    return embed(model.state_dict(), imgs[idx], spec(cell), block=32,
                 linear=linear)


def _sync(cell: Cell) -> None:
    import torch

    if cell.device == "cuda":
        torch.cuda.synchronize()


def run(cell: Cell) -> Outcome:
    import torch

    from .dinov2_flops import flops_per_image
    from .spans import counts
    from .trace import traced

    marks = [("start", time.perf_counter())]
    cfg, model = build(cell)
    _sync(cell)
    marks.append(("build", time.perf_counter()))
    imgs, pids, cams = images(cell)
    loader = batches(imgs, pids, cams, int(cfg.TEST.IMS_PER_BATCH))
    _sync(cell)
    marks.append(("images", time.perf_counter()))
    emb, m = evaluation(cell, cfg, model, loader)   # first use of each shape
    _sync(cell)
    marks.append(("first evaluation", time.perf_counter()))
    setup_s = marks[-1][1] - cell.t0
    log(cell, "set-up: " + ", ".join(
        f"{name} {t - (marks[i - 1][1] if i else cell.t0):.3f} s"
        for i, (name, t) in enumerate(marks)))
    observed: dict = {}
    if cell.trace:
        from centroids_reid_tpu_torch.utils import profiling

        n = int(cell.traffic["trace_evals"])
        profiling.reset()
        with traced(cell.scratch, cell.device, host=False) as dev_only:
            for _ in range(n):
                emb, m = evaluation(cell, cfg, model, loader)
        got = counts()
        with traced(cell.scratch, cell.device) as both:
            emb, m = evaluation(cell, cfg, model, loader)
        t = dev_only.trace
        published = cell.config["published"]
        observed = {"window_s": t.window_s, "busy_s": t.busy_s(),
                    "evals": n, "trace": t, "counts": got,
                    "widths": published,
                    "flops_per_image": flops_per_image(
                        published, cell.config["input_hw"]),
                    "breakdown": both.trace.breakdown()}
        log(cell, f"traced: {got}")
        evals = n
    else:
        t0 = time.perf_counter()
        evals = 0
        while True:
            emb, m = evaluation(cell, cfg, model, loader)
            evals += 1
            if time.perf_counter() - t0 >= cell.seconds:
                break
        _sync(cell)
        wall = time.perf_counter() - t0
        log(cell, f"window: {evals} evaluations in {wall:.3f} s")
    peak = torch.cuda.max_memory_allocated() if cell.device == "cuda" else 0
    rows = check_rows(cell, emb.shape[0], int(cfg.TEST.IMS_PER_BATCH))
    gaps = embedding_gaps(emb[rows], reference_embeddings(
        cell, model, imgs, rows), model.emb_size)
    gaps.update(metric_gaps(cell, emb, pids, cams, m))
    checks = [Check(k, gaps[k], float(v)) for k, v in cell.limits.items()]
    e2e = {} if cell.trace else {"setup_s": setup_s, "eval_s": wall / evals}
    out = Outcome(e2e, observed, checks, attempted=evals, failed=0,
                  memory_peak_bytes=peak)
    if cell.trace:
        out.busy_s, out.window_s = observed["busy_s"], observed["window_s"]
        out.breakdown = observed["breakdown"]
    return out


# ------------------------------------------------------------ calibration

def _plant(kind: str):
    """A fault in the trunk, as a patch to enter: "ls" drops LayerScale
    (each branch added unscaled), "reg" leaves the register tokens out,
    "aa" resizes the position grid without antialias, "gate" puts SiLU
    on the wrong half of ``w12``'s output."""
    from unittest import mock

    import torch.nn.functional as F

    from centroids_reid_tpu_torch.models import dinov2 as D

    if kind == "ls":
        return mock.patch.object(D.LayerScale, "factor", lambda self: None)
    if kind == "reg":
        return mock.patch.object(D.DinoVisionTransformer, "registers",
                                 lambda self: None)
    if kind == "aa":
        real = D.interpolate_grid
        return mock.patch.object(D, "interpolate_grid",
                                 lambda grid, size: real(grid, size, False))

    def wrong_half(x12):
        x1, x2 = x12.chunk(2, dim=-1)
        return x1 * F.silu(x2)

    return mock.patch.object(D.SwiGLUFFN, "gate", staticmethod(wrong_half))


FAULTS = ("ls", "reg", "aa", "gate")


def calibrate(cells, controls: int, faults: int) -> list:
    """Per seed the sound program's readings over one evaluation; for the
    first ``controls`` seeds the control's (the reference with its linears'
    inputs and weights rounded through fp8 in the program's place for the
    embeddings, the reference evaluator with TF32 on for the metrics) and
    the program's with its trunk wholly in bf16 (``control_bf16``); for
    the first ``faults`` each planted fault's."""
    from reference.transreid import fp8_cast

    rows_out = []
    for i, cell in enumerate(cells):
        cfg, model = build(cell)
        imgs, pids, cams = images(cell)
        loader = batches(imgs, pids, cams, int(cfg.TEST.IMS_PER_BATCH))
        rows = check_rows(cell, imgs.shape[0], int(cfg.TEST.IMS_PER_BATCH))
        ref = reference_embeddings(cell, model, imgs, rows)

        def reading(emb, m):
            out = embedding_gaps(emb[rows], ref, model.emb_size)
            out.update(metric_gaps(cell, emb, pids, cams, m))
            return out

        emb, m = evaluation(cell, cfg, model, loader)
        row = {"seed": cell.seed, "program": reading(emb, m)}
        if i < controls:
            ctl = embedding_gaps(reference_embeddings(
                cell, model, imgs, rows, linear=fp8_cast), ref,
                model.emb_size)
            ctl.update(metric_gaps(cell, emb, pids, cams, m, tf32=True))
            row["control"] = ctl
            low_cfg, low = bf16_trunk(cfg, model)
            row["control_bf16"] = reading(*evaluation(cell, low_cfg, low,
                                                      loader))
            del low
        for kind in FAULTS if i < faults else ():
            with _plant(kind):
                row[f"fault_{kind}"] = reading(
                    *evaluation(cell, cfg, model, loader))
        rows_out.append(row)
        log(cell, f"calibration {i}: {row}")
        del model, imgs, loader
    return rows_out
