"""Swin's window attention over a block's real tokens (Hopper), K9.

It replaces no TPU kernel: the JAX package has no Swin. SOLIDER-REID's
Swin-B (``models/swin.py``) attends within 7x7 windows of a map padded to a
multiple of the window, rolled by half a window in odd blocks, with a
relative-position bias and, in rolled blocks, a mask between the roll's
regions. Op by op that was a pad, qkv on the padded map, one row gather,
the bias + mask materialised per image, SDPA on 49-token windows, one
gather back and proj on the padded map: memory-bound data movement around
24 FLOP a byte of attention. One hand-written CUDA kernel
(``csrc/window_attn.cu``) reads the qkv of the real tokens, takes a padded
token's q, k and v from the qkv bias (a zero row through qkv is its bias),
adds the block's table in fp32 and writes each real token's attention
output in its own row, so qkv and proj run on the real rows alone.

``window_attention(qkv, qkv_bias, table, g, heads)``: ``qkv`` [B, h * w, 3C]
(laid out ``[3, heads, C / heads]`` along the last dimension), ``qkv_bias``
[3C] in qkv's type (as autocast casts it), ``table`` the block's
``window_mask`` in fp32 ([windows or 1, heads, N, N]: bias + shift mask, or
the bias alone for every window), ``g`` the block's ``Windows`` (``h``,
``w``, ``hp``, ``wp``, ``order``, ``inverse``) -> o [B, h * w, C] in qkv's
type, SDPA's scale (head width^-0.5). ``window_attention_plain`` is the op
by op path on that interface (bias rows padded in, one gather, SDPA with
the table broadcast over the images, one gather back); the wrapper takes
it for CPU tensors and for CUDA tensors launches the kernel or raises. The
kernel is built for window 7, head width 32 (Swin-T, -S and -B), bf16
qkv and output; it refuses any other, and tensors that need a gradient (it
has no backward). It launches through ``_build.launch``, does not
synchronise, and adds, under a running profiler, the real tokens it writes
to the counter ``swin.wmsa_fused``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

from ..utils.profiling import count
from ._build import check_aligned, launch, on_cpu

WINDOW = 7
HEAD_DIM = 32
# SDPA with an additive mask over 49-token windows, head width 32: the
# memory-efficient kernel took 0.46 ms where cuDNN's, the default, took
# 0.84 (stage 3 at batch 256, H100); the CPU takes the math path
_BACKENDS = [SDPBackend.EFFICIENT_ATTENTION, SDPBackend.MATH]


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[:, index]`` for x [B, M, C]: each row moved as 8-byte words
    where it is a whole number of them (``index_select`` moves one element
    a thread; bf16 rows as int64 took 0.18 ms where bf16 took 0.27, stage
    3 at batch 256, H100)."""
    if x.is_contiguous() and x.shape[-1] * x.element_size() % 8 == 0:
        return x.view(torch.int64).index_select(1, index).view(x.dtype)
    return x.index_select(1, index)


def window_tokens(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                  g) -> torch.Tensor:
    """The padded map's qkv [B, hp * wp, 3C] (the bias in the padding),
    rolled and partitioned by one gather by ``g.order``: [B, windows * N,
    3C], window by window."""
    b, _, c3 = qkv.shape
    padded = qkv.new_empty((b, g.hp, g.wp, c3))
    padded.copy_(qkv_bias)
    padded[:, :g.h, :g.w] = qkv.view(b, g.h, g.w, c3)
    return gather_rows(padded.view(b, g.hp * g.wp, c3), g.order)


def window_attention_plain(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                           table: torch.Tensor, g, heads: int
                           ) -> torch.Tensor:
    """The window attention op by op: ``window_tokens``, SDPA with
    ``table`` (rounded to qkv's type) as the additive mask of every
    image's windows, reverse, roll back and crop as one gather by
    ``g.inverse``."""
    b, _, c3 = qkv.shape
    c, n = c3 // 3, table.shape[-1]
    windows = g.order.numel() // n
    win = window_tokens(qkv, qkv_bias, g)
    q, k, v = win.view(b, windows, n, 3, heads, c // heads).permute(
        3, 0, 1, 4, 2, 5).reshape(3, b, windows * heads, n, c // heads)
    mask = table.to(qkv.dtype).expand(windows, -1, -1, -1).reshape(
        1, windows * heads, n, n)
    with sdpa_kernel(_BACKENDS):
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=mask)
    o = o.view(b, windows, heads, n, c // heads).permute(0, 1, 3, 2, 4)
    return gather_rows(o.reshape(b, windows * n, c), g.inverse)


def _check(qkv: torch.Tensor, qkv_bias: torch.Tensor, table: torch.Tensor,
           g, heads: int) -> None:
    """Refuse what K9 is not built for, before a launch."""
    n = WINDOW * WINDOW
    if qkv.dim() != 3 or qkv.shape[1] != g.h * g.w:
        raise ValueError(f"qkv must be [B, {g.h * g.w}, 3C], got "
                         f"{tuple(qkv.shape)}")
    c3 = qkv.shape[2]
    if c3 % (3 * heads) or c3 // (3 * heads) != HEAD_DIM:
        raise ValueError(f"K9 is built for heads of width {HEAD_DIM}, got "
                         f"{c3 // 3} channels in {heads} heads")
    if qkv.shape[1] * c3 > 8 << 22:
        raise ValueError(f"K9 addresses at most 2^25 qkv elements an image, "
                         f"got {qkv.shape[1]} x {c3}")
    if qkv.dtype != torch.bfloat16 or qkv_bias.dtype != torch.bfloat16:
        raise TypeError(f"K9 takes a bf16 qkv and bias, got {qkv.dtype} "
                        f"and {qkv_bias.dtype}")
    if tuple(qkv_bias.shape) != (c3,):
        raise ValueError(f"qkv_bias must be [{c3}], got "
                         f"{tuple(qkv_bias.shape)}")
    windows = g.order.numel() // n
    if (table.shape[-1] != n or g.hp != -(-g.h // WINDOW) * WINDOW
            or g.wp != -(-g.w // WINDOW) * WINDOW
            or g.order.numel() != g.hp * g.wp):
        raise ValueError(f"K9 is built for {WINDOW}x{WINDOW} windows: got "
                         f"a table of {table.shape[-1]} keys over a "
                         f"{g.hp}x{g.wp} map of {g.order.numel()} tokens")
    if (table.dtype != torch.float32 or table.dim() != 4
            or table.shape[0] not in (1, windows)
            or tuple(table.shape[1:]) != (heads, n, n)
            or table.stride(-1) != 1):
        raise ValueError(f"table must be fp32 [1 or {windows}, {heads}, {n}, "
                         f"{n}] with unit column stride, got {table.dtype} "
                         f"{tuple(table.shape)} strides {table.stride()}")
    if g.order.dtype != torch.int32:
        raise TypeError(f"the window order must be int32, got "
                        f"{g.order.dtype}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (qkv, qkv_bias, table)):
        raise RuntimeError("K9 has no backward: call it under no_grad or "
                           "inference_mode")


def _launch(qkv, qkv_bias, table, g, heads: int) -> torch.Tensor:
    """Check the operands, then launch K9."""
    _check(qkv, qkv_bias, table, g, heads)
    check_aligned("K9's qkv and bias", qkv, qkv_bias)
    b, hw, c3 = qkv.shape
    out = torch.empty((b, hw, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    if b == 0:
        return out
    order = g.order.contiguous()
    launch("window_attn", qkv.data_ptr(), qkv_bias.data_ptr(),
           table.data_ptr(), table.stride(0) if table.shape[0] > 1 else 0,
           table.stride(1), table.stride(2), order.data_ptr(),
           out.data_ptr(), b, g.h, g.w, g.hp, g.wp, heads)
    count("swin.wmsa_fused", b * hw)
    return out


def window_attention(qkv: torch.Tensor, qkv_bias: torch.Tensor,
                     table: torch.Tensor, g, heads: int) -> torch.Tensor:
    """K9: one Swin block's window attention over the real tokens' ``qkv``
    [B, h * w, 3C] -> o [B, h * w, C] (see the module's docstring). The
    plain version for CPU tensors."""
    if on_cpu(qkv, qkv_bias, table, g.order):
        return window_attention_plain(qkv, qkv_bias, table, g, heads)
    return _launch(qkv, qkv_bias, table, g, heads)
