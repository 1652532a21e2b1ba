"""Floating-point operations of one image through DINOv2's ViT
(``models/dinov2.py``), and the bytes K8 moves at its LayerNorm sites,
from a configuration's ``published`` widths and the input size.

FLOPs, two per multiply-add, as the published code performs them: the
patch conv (2 P C 14^2 D over the P patches); per block over its N = 1 +
registers + P tokens, 8 N D^2 for qkv and proj, 4 N^2 D for attention (q
k^T and the weighted sum), 2 N D (2 H) for SwiGLU's ``w12`` and 2 N H D
for ``w3`` (H its hidden width, ``ffn_hidden``: 4,096 at D 1,536).
LayerNorm, softmax, the gate, LayerScale, the residual adds, the position
grid's resize and the BNNeck are left out (memory-bound, well under 1 % of
the FLOPs).
ViT-g/14 with 4 registers at 252x126 (167 tokens): 385.39 GFLOP an
image, 65 % of it in the FFN.

K8's bytes: each site reads the fp32 stream (4 B an element) and writes
y, and with a branch reads it (2 B, bf16) and writes the sum (4 B).
Block 0's ``norm1`` has no branch (6 B); the other 2 x depth - 1 block
sites add a branch and write a bf16 y (12 B); the final norm adds the
last block's branch and writes an fp32 y (14 B). The LayerNorm's weight
and bias and the LayerScale (a few KB a launch, read from cache) are
left out."""

from __future__ import annotations


def tokens(w: dict, input_hw) -> int:
    """Tokens entering the blocks: cls, registers, patches."""
    p = int(w["patch_size"])
    return (1 + int(w["num_register_tokens"])
            + (int(input_hw[0]) // p) * (int(input_hw[1]) // p))


def flops_per_image(w: dict, input_hw) -> float:
    """``w``: ``embed_dim``, ``depth``, ``patch_size``, ``ffn_hidden``,
    ``num_register_tokens``."""
    p, d = int(w["patch_size"]), int(w["embed_dim"])
    n = tokens(w, input_hw)
    patches = (int(input_hw[0]) // p) * (int(input_hw[1]) // p)
    h = int(w["ffn_hidden"])
    block = (8.0 * n * d * d + 4.0 * n * n * d + 4.0 * n * d * h
             + 2.0 * n * h * d)
    return 2.0 * patches * 3 * p * p * d + int(w["depth"]) * block


def norm_bytes(w: dict, rows_fused: float) -> float:
    """Bytes K8 moves over ``rows_fused`` rows (``vit.norms_fused``) of
    whole batches: every batch runs 2 x depth + 1 sites over the same
    tokens."""
    depth, d = int(w["depth"]), int(w["embed_dim"])
    sites = 2 * depth + 1
    per_token = d * (6 + (2 * depth - 1) * 12 + 14)
    return rows_fused / sites * per_token
