"""The residual add, LayerNorm and cast of a transformer block's pre-norm
site (Hopper), K8.

It replaces no TPU kernel: the JAX package has no transformer. TransReID's
blocks (``models/transreid.py``), Swin's (``models/swin.py``) and
DINOv2's (``models/dinov2.py``) under bf16 autocast keep the residual
stream and the LayerNorms in fp32 and cast each LayerNorm's output to
bf16 for the next linear: an add, a LayerNorm and a cast, three
memory-bound passes of 24 bytes an element. One
hand-written CUDA kernel (``csrc/add_norm.cu``) makes one pass of 12 (x
and a bf16 delta read, x_new and a bf16 y written): 498 MB, 0.149 ms at
3.35 TB/s, at TransReID's [54,016, 768].

``add_norm(x, delta, weight, bias, eps, dtype, scale)`` returns ``(x_new,
y)``: ``x_new = x + delta`` in the residual stream's type (``x`` itself
when ``delta`` is None), or ``x + delta * scale`` with a per-channel
``scale`` [D] in the stream's type (DINOv2's LayerScale, its product
rounded to the stream's type before the add, as the eager ops round it),
and ``y = F.layer_norm(x_new)`` with fp32 statistics,
written in ``dtype`` (None: what ``F.layer_norm`` returns, fp32 under
autocast, else the stream's type). The stream is fp32, as autocast keeps
it, or bf16, as in a model cast wholly to bf16 (x, delta, weight and bias
bf16; the sum rounded to bf16 as PyTorch's bf16 add rounds it).
``add_norm_plain`` is exactly today's ops (``x + delta`` or ``x + delta
* scale``, ``F.layer_norm``, ``.to(dtype)``); the wrapper takes it for CPU
tensors, so the CPU sees the same bits as before, and for CUDA tensors
launches the kernel or raises. The kernel writes ``x_new`` bit for
bit as PyTorch's add; its statistics are summed in another order than
PyTorch's LayerNorm, so ``y`` can differ by fp32 rounding. The wrapper
launches through ``_build.launch`` (no Triton: it would add a JIT to a
process's set-up), does not synchronise, and adds, under a running
profiler, the launch's rows to the counter ``vit.norms_fused`` (the
transformers' sites are K8's only callers). The kernel has no backward:
it refuses tensors that need a gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.profiling import count
from ._build import aligned, launch, on_cpu

# the row widths the kernel is built for: ViT-B's 768; Swin-B's 128-1024
# (blocks, norm3) and 512-2048 (patch merging); DINOv2 ViT-g's 1536
DIMS = (128, 256, 512, 768, 1024, 1536, 2048)
_DELTA_KIND = {None: 0, torch.float32: 1, torch.bfloat16: 2}
_Y_TYPES = (torch.float32, torch.bfloat16)
_STREAMS = {torch.float32: (None, torch.float32, torch.bfloat16),
            torch.bfloat16: (None, torch.bfloat16)}   # stream -> its deltas


def add_norm_plain(x: torch.Tensor, delta: Optional[torch.Tensor],
                   weight: torch.Tensor, bias: torch.Tensor, eps: float,
                   dtype: Optional[torch.dtype] = None,
                   scale: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(x + delta, F.layer_norm(x + delta).to(dtype))``, op by op; with
    ``scale``, ``x + delta * scale`` for the sum."""
    if delta is not None:
        x = x + (delta if scale is None else delta * scale)
    y = F.layer_norm(x, (x.shape[-1],), weight, bias, eps)
    return x, (y if dtype is None else y.to(dtype))


def _launch(x, delta, weight, bias, eps: float, dtype, scale=None):
    """Check the operands, then launch K8."""
    d = x.shape[-1]
    if x.dtype not in _STREAMS:
        raise TypeError(f"K8 needs an fp32 or bf16 residual stream, got "
                        f"{x.dtype}")
    if d not in DIMS:
        raise ValueError(f"K8 is built for rows of {DIMS}, got {d}")
    deltas = _STREAMS[x.dtype]
    if delta is not None and (delta.dtype not in deltas
                              or delta.shape != x.shape):
        raise ValueError(f"delta must be {deltas[1:]} {tuple(x.shape)} with "
                         f"a {x.dtype} stream, got {delta.dtype} "
                         f"{tuple(delta.shape)}")
    if dtype not in _Y_TYPES:
        raise TypeError(f"K8 writes y in fp32 or bf16, not {dtype}")
    if (x.dtype == torch.bfloat16 and dtype == torch.float32
            and not torch.is_autocast_enabled(x.device.type)):
        # F.layer_norm of a bf16 stream is bf16 outside autocast: an fp32 y
        # would skip the rounding that the eager ops' bf16 output has
        raise TypeError("a bf16 stream's LayerNorm is bf16 outside "
                        "autocast: K8 writes its y in bf16 there")
    if scale is not None and delta is None:
        raise ValueError("a scale multiplies a delta: none was given")
    for what, t in (("weight", weight), ("bias", bias), ("scale", scale)):
        if t is None:
            continue
        if t.dtype != x.dtype or tuple(t.shape) != (d,):
            raise ValueError(f"{what} must be {x.dtype} [{d}], as the "
                             f"stream, got {t.dtype} {tuple(t.shape)}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, delta, weight, bias, scale)):
        raise RuntimeError("K8 has no backward: call it under no_grad or "
                           "inference_mode")
    x = aligned(x)
    y = torch.empty_like(x, dtype=dtype)
    x_new = x
    if delta is not None:
        delta = aligned(delta)
        x_new = torch.empty_like(x)
    if x.numel() == 0:
        return x_new, y
    rows = x.numel() // d
    weight, bias = aligned(weight), aligned(bias)
    if scale is not None:
        scale = aligned(scale)
    launch("add_norm", x.data_ptr(), int(x.dtype == torch.bfloat16),
           0 if delta is None else delta.data_ptr(),
           _DELTA_KIND[None if delta is None else delta.dtype],
           0 if scale is None else scale.data_ptr(),
           weight.data_ptr(), bias.data_ptr(), x_new.data_ptr(),
           y.data_ptr(), int(dtype == torch.bfloat16), rows, d, float(eps))
    count("vit.norms_fused", rows)
    return x_new, y


def add_norm(x: torch.Tensor, delta: Optional[torch.Tensor],
             weight: torch.Tensor, bias: torch.Tensor, eps: float,
             dtype: Optional[torch.dtype] = None,
             scale: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K8: ``(x + delta, LayerNorm(x + delta))`` in one pass over ``x``
    [..., D] (the stream: fp32, or bf16) and ``delta`` (its shape, fp32 or
    bf16 with an fp32 stream, bf16 with a bf16 one, or None), the
    LayerNorm's ``weight`` and ``bias`` [D] in the stream's type; ``y`` in
    ``dtype`` (fp32 or bf16; None is ``F.layer_norm``'s own: fp32 under
    autocast, else the stream's); ``scale`` [D] in the stream's type, or
    None, multiplies ``delta`` before the add. The plain version for CPU
    tensors."""
    if on_cpu(x, delta, weight, bias, scale):
        return add_norm_plain(x, delta, weight, bias, eps, dtype, scale)
    if dtype is None:
        dtype = (torch.float32 if torch.is_autocast_enabled(x.device.type)
                 else x.dtype)
    return _launch(x, delta, weight, bias, eps, dtype, scale)
