"""Floating-point operations of one image through SOLIDER-REID's Swin
(``models/swin.py``), from a configuration's ``published`` widths, as the
published code performs them, padding included: two per multiply-add of
the patch conv; per block over its stage's N tokens, padded to N_pad for
the windows, 8 N_pad C^2 for qkv and proj, 4 N_pad W^2 C for attention (q
k^T and the weighted sum over a window of W^2 tokens) and 16 N C^2 for the
MLP at a ratio of 4 (2 N C^2 r for each of its two linears); per patch
merging 16 N_out C^2 (``Linear(4C, 2C)`` over the N_out merged tokens).
LayerNorm, softmax, GELU, the pads, rolls and gathers, the residual adds,
the semantic controller and the BNNeck are left out (memory-bound, and a
few per cent of nothing). Swin-B at 384x128: 39.4 GFLOP an image, 30.2 of
them on real tokens (``real=True``: N in place of N_pad), so 9.2 GFLOP,
23 %, are the padded tokens' (most in stage 3's qkv and proj)."""

from __future__ import annotations


def _padded(n: int, window: int) -> int:
    return -(-n // window) * window


def flops_per_image(w: dict, real: bool = False) -> float:
    """``w``: ``input_hw``, ``patch_size``, ``embed_dim``, ``depths``,
    ``window_size``, ``mlp_ratio``."""
    p, win = int(w["patch_size"]), int(w["window_size"])
    h, wd = (int(v) // p for v in w["input_hw"])
    c = int(w["embed_dim"])
    r = float(w["mlp_ratio"])
    total = 2.0 * h * wd * 3 * p * p * c
    depths = list(w["depths"])
    for i, depth in enumerate(depths):
        n = h * wd
        n_pad = n if real else _padded(h, win) * _padded(wd, win)
        block = 8.0 * n_pad * c * c + 4.0 * n_pad * win * win * c \
            + 4.0 * r * n * c * c
        total += depth * block
        if i + 1 < len(depths):
            h, wd = h // 2, wd // 2
            total += 16.0 * h * wd * c * c
            c *= 2
    return total
