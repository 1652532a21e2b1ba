"""DINOv2 ViT-g/14 with registers as a retrieval trunk, for evaluation: a
plain pre-norm ViT over 14x14 patches with LayerScale on both branches, a
SwiGLU FFN, four register tokens and a position grid interpolated to the
input in every forward, then one BNNeck.

Papers: Oquab et al., "DINOv2: Learning Robust Visual Features without
Supervision", TMLR 2024 (arXiv:2304.07193); Darcet et al., "Vision
Transformers Need Registers", ICLR 2024 (arXiv:2309.16588). Follows
github.com/facebookresearch/dinov2: ``hub/backbones.py::dinov2_vitg14_reg``
(``vit_giant2``, ``ffn_layer="swiglufused"``, ``init_values=1.0``, 4
registers, ``interpolate_antialias=True``, ``interpolate_offset=0.0``,
no block chunks) and ``models/vision_transformer.py``
(``DinoVisionTransformer``: ``prepare_tokens_with_masks``,
``interpolate_pos_encoding``, ``forward_features``), ``layers/block.py``,
``layers/attention.py``, ``layers/layer_scale.py``,
``layers/swiglu_ffn.py`` (``SwiGLUFFNFused``: the hidden width
``(int(4 D * 2 / 3) + 7) // 8 * 8``, 4,096 at D 1,536). The backbone's
parameter names are DINOv2's own under ``backbone.``
(``patch_embed.proj``, ``cls_token``, ``register_tokens``, ``pos_embed``,
``mask_token``, ``blocks.{i}.norm1 / attn.qkv / attn.proj / ls1.gamma /
norm2 / mlp.w12 / mlp.w3 / ls2.gamma``, ``norm``), so a hub state dict
loads into ``backbone`` without renaming; the head is ``bottleneck`` (and
``classifier``) as the other transformers'.

The forward of one image batch:

* ``Conv2d(3, D, 14, stride 14)`` patches, the cls token before them, the
  position embedding added: its 37x37 grid resized to the input's patch
  grid by ``F.interpolate(mode="bicubic", antialias=True, size=(H / 14,
  W / 14))`` in fp32 each call (the published shortcut, the grid itself
  when the patch count is the grid's and the input square, kept), then
  the register tokens inserted after the cls token;
* ``depth`` pre-norm blocks: ``x += ls1(attn(norm1(x)))``, ``x +=
  ls2(mlp(norm2(x)))``, where ``ls`` multiplies each channel by its
  ``gamma`` and the MLP is SwiGLU (``w12``, ``silu(x1) * x2`` over its two
  halves, ``w3``, all with bias); attention is ``transreid.Attention``
  (``scaled_dot_product_attention``, scale 1 / sqrt(64));
* the final LayerNorm over every token; its cls token is the embedding,
  returned before the BNNeck (``TEST.NECK_FEAT before``) or after, fp32.

With ``mixed_precision`` the trunk runs under bf16 autocast, the residual
stream and the LayerNorms in fp32, as TransReID's. Every LayerNorm is a
``norm_site`` (K8 on the card): a block's ``norm1`` with the previous
block's MLP branch and its LayerScale added before it, its ``norm2`` with
the attention branch and ``ls1``, the final norm with the last MLP branch
and its ``ls2``; so the residual add, LayerScale, LayerNorm and the cast
run as one pass a site. Dropout, drop-path and the mask token are the
identity or unused at evaluation (``mask_token`` is held, as published).
DINOv2's training, and its other sizes (ViT-S/B/L take an MLP FFN), are
not ported.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.profiling import annotate, count
from .transreid import (
    DINOV2,
    Attention,
    _neck,
    family,
    is_transformer,
    norm_site,
    refuse,
)

# DINOv2's hub names -> the widths of ``vit_giant2`` as the hub builds it
DINOV2_WIDTHS = {
    "dinov2_vitg14_reg": dict(embed_dim=1536, depth=40, num_heads=24,
                              mlp_ratio=4.0, patch_size=14, grid=37,
                              num_register_tokens=4),
}


def is_dinov2(cfg) -> bool:
    return is_transformer(cfg) and family(cfg) == DINOV2


def swiglu_hidden(dim: int, mlp_ratio: float) -> int:
    """``SwiGLUFFNFused``'s hidden width: two thirds of ``dim *
    mlp_ratio``, rounded up to a multiple of 8."""
    return (int(int(dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8


def interpolate_grid(grid: torch.Tensor, size,
                     antialias: bool = True) -> torch.Tensor:
    """``interpolate_pos_encoding``'s resize of the [1, D, M, M] grid to
    ``size`` (patch rows, patch columns): bicubic, by size (the hub's
    registers models set ``interpolate_offset`` 0), with antialias."""
    return F.interpolate(grid, size=tuple(size), mode="bicubic",
                         antialias=antialias)


class PatchEmbed(nn.Module):
    """DINOv2's ``PatchEmbed``: ``proj`` conv at stride = patch, flattened
    to tokens [B, rows * cols, D] (no norm)."""

    def __init__(self, patch_size: int, embed_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class LayerScale(nn.Module):
    """A per-channel ``gamma`` on a branch; its product is taken at the
    next ``norm_site`` (``factor``)."""

    def __init__(self, dim: int, init_values: float = 1.0):
        super().__init__()
        self.gamma = nn.Parameter(init_values * torch.ones(dim))

    def factor(self) -> torch.Tensor:
        return self.gamma


class SwiGLUFFN(nn.Module):
    """``SwiGLUFFNFused``: ``w3(silu(x1) * x2)``, ``x1, x2`` the halves of
    ``w12(x)``."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    @staticmethod
    def gate(x12):
        x1, x2 = x12.chunk(2, dim=-1)
        return F.silu(x1) * x2

    def forward(self, x):
        return self.w3(self.gate(self.w12(x)))


class Block(nn.Module):
    """DINOv2's ``Block`` with LayerScale (LayerNorm eps 1e-6)."""

    def __init__(self, dim: int, num_heads: int, hidden: int, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = SwiGLUFFN(dim, hidden)
        self.ls2 = LayerScale(dim)

    def forward(self, x, pending):
        """``x`` the residual stream [B, N, D], ``pending`` the previous
        block's (MLP branch, its LayerScale) not yet added to it (or None)
        -> (the stream with it and this block's scaled attention branch
        added, this block's (MLP branch, ``ls2``), not yet added)."""
        delta, scale = pending or (None, None)
        x, y = norm_site(x, delta, self.norm1, scale=scale)
        with annotate("dino.attn"):
            a = self.attn(y)
        x, y = norm_site(x, a, self.norm2, scale=self.ls1.factor())
        with annotate("dino.mlp"):
            m = self.mlp(y)
        return x, (m, self.ls2.factor())


class DinoVisionTransformer(nn.Module):
    """DINOv2's ``DinoVisionTransformer`` (``backbone``) at evaluation."""

    def __init__(self, embed_dim: int = 1536, depth: int = 40,
                 num_heads: int = 24, mlp_ratio: float = 4.0,
                 patch_size: int = 14, grid: int = 37,
                 num_register_tokens: int = 4, ln_eps: float = 1e-6):
        super().__init__()
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, grid * grid + 1,
                                                  embed_dim))
        self.register_tokens = (
            nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
            if num_register_tokens else None)
        hidden = swiglu_hidden(embed_dim, mlp_ratio)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, hidden,
                                          ln_eps) for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=ln_eps)
        self.mask_token = nn.Parameter(torch.zeros(1, embed_dim))

    def position(self, rows: int, cols: int, h: int, w: int,
                 dtype: torch.dtype) -> torch.Tensor:
        """``interpolate_pos_encoding``: [1, 1 + rows * cols, D] in
        ``dtype``, the grid resized in fp32 outside autocast."""
        n = self.pos_embed.shape[1] - 1
        if rows * cols == n and h == w:
            return self.pos_embed.to(dtype)
        pos = self.pos_embed.float()
        m = int(math.sqrt(n))
        grid = pos[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
        with torch.autocast(device_type=pos.device.type, enabled=False):
            grid = interpolate_grid(grid, (rows, cols))
        grid = grid.permute(0, 2, 3, 1).reshape(1, rows * cols, -1)
        return torch.cat((pos[:, :1], grid), dim=1).to(dtype)

    def registers(self):
        """The register tokens [1, R, D], or None."""
        return self.register_tokens

    def tokens(self, x):
        """``prepare_tokens_with_masks`` (no masks): [B, 1 + R + patches,
        D] in the parameters' type."""
        b, _, h, w = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"a {h}x{w} input is not a whole number of "
                             f"{p}x{p} patches")
        t = self.patch_embed(x).to(self.cls_token.dtype)
        t = torch.cat((self.cls_token.expand(b, -1, -1), t), dim=1)
        t = t + self.position(h // p, w // p, h, w, t.dtype)
        reg = self.registers()
        if reg is not None:
            t = torch.cat((t[:, :1], reg.expand(b, -1, -1), t[:, 1:]),
                          dim=1)
        return t

    def trunk(self, x):
        """(the residual stream after the last block [B, N, D], that
        block's (MLP branch, ``ls2``), not yet added to it); ``dino.tokens``
        counts the tokens entering the blocks."""
        with annotate("dino.patch"):
            t = self.tokens(x)
        count("dino.tokens", t.shape[0] * t.shape[1])
        pending = None
        for blk in self.blocks:
            t, pending = blk(t, pending)
        return t, pending

    def head(self, t, pending):
        """The final norm over every token, with the last MLP branch and
        its LayerScale added: its cls token [B, D]."""
        delta, scale = pending or (None, None)
        _, y = norm_site(t, delta, self.norm, to_linear=False, scale=scale)
        return y[:, 0]


class DinoV2ReID(nn.Module):
    """DINOv2's backbone with a BNNeck (bias frozen) and, with
    ``num_classes`` > 0, a bias-free classifier (held for state-dict
    compatibility; evaluation never runs it)."""

    FAMILY = DINOV2

    def __init__(self, embed_dim: int = 1536, depth: int = 40,
                 num_heads: int = 24, mlp_ratio: float = 4.0,
                 patch_size: int = 14, grid: int = 37,
                 num_register_tokens: int = 4,
                 neck_feat: str = "before", num_classes: int = 0,
                 mixed_precision: bool = False):
        super().__init__()
        if neck_feat not in ("before", "after"):
            raise ValueError(f"TEST.NECK_FEAT must be 'before' or 'after', "
                             f"got {neck_feat!r}")
        self.backbone = DinoVisionTransformer(
            embed_dim, depth, num_heads, mlp_ratio, patch_size, grid,
            num_register_tokens)
        self.bottleneck = _neck(embed_dim)
        self.num_classes = num_classes
        if num_classes > 0:
            self.classifier = nn.Linear(embed_dim, num_classes, bias=False)
        self.neck_feat = neck_feat
        self.mixed_precision = mixed_precision

    @property
    def emb_size(self) -> int:
        return self.backbone.embed_dim

    def embed(self, x, cams=None):
        """Eval-mode retrieval embedding, fp32 [B, D]: the final norm's cls
        token before or after the BNNeck (``neck_feat``). x: NCHW;
        ``cams`` is taken and not read. Call on a model in ``eval()``
        mode."""
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=self.mixed_precision):
            t, pending = self.backbone.trunk(x)
        with annotate("dino.head"):
            g = self.backbone.head(t, pending).float()
            if self.neck_feat == "after":
                g = self.bottleneck(g)
        return g


def init_dinov2(model: DinoV2ReID,
                generator: torch.Generator) -> DinoV2ReID:
    """A seeded init drawn from ``generator`` (on the parameters' device):
    DINOv2's linears N(0, 0.02) (its ``trunc_normal_`` cuts at +-2, 100
    std out), with departures that keep every part of the forward visible
    in the embedding: linear biases N(0, 0.02), not 0; the cls and
    register tokens N(0, 1), not N(0, 1e-6); ``pos_embed`` N(0, 0.2), not
    0.02; each LayerScale gamma U(0.05, 0.5) a channel, not 1e-5.
    LayerNorms and BNNecks 1 / 0, the patch conv PyTorch's default
    (uniform within 1 / sqrt(fan_in)), ``mask_token`` 0 (unused), the
    classifier N(0, 0.001)."""
    bb = model.backbone
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, LayerScale):
                m.gamma.uniform_(0.05, 0.5, generator=generator)
        for p in (bb.cls_token, bb.register_tokens):
            if p is not None:
                p.normal_(0.0, 1.0, generator=generator)
        bb.pos_embed.normal_(0.0, 0.2, generator=generator)
        bb.mask_token.zero_()
        if model.num_classes > 0:
            model.classifier.weight.normal_(0.0, 0.001, generator=generator)
    return model


def make_dinov2(cfg, num_classes: int = 0,
                generator: Optional[torch.Generator] = None) -> DinoV2ReID:
    """The DINOv2 model of ``cfg`` (``MODEL.TRANSFORMER_TYPE`` names the
    widths), initialised from ``generator`` (seed 0 when None), in eval
    mode on the current device."""
    m = cfg.MODEL
    if m.TRANSFORMER_TYPE not in DINOV2_WIDTHS:
        raise ValueError(
            f"MODEL.TRANSFORMER_TYPE {m.TRANSFORMER_TYPE!r} is not ported; "
            f"the port has {sorted(DINOV2_WIDTHS)}")
    if m.JPM:
        refuse("create_model", "DINOv2 embeds by its final norm's cls "
               "token (MODEL.JPM False); JPM's b1 and b2 copy a TransReID "
               "block", DINOV2)
    if m.SIE_CAMERA:
        refuse("create_model", "DINOv2 has no camera embedding "
               "(MODEL.SIE_CAMERA False)", DINOV2)
    model = DinoV2ReID(**DINOV2_WIDTHS[m.TRANSFORMER_TYPE],
                       neck_feat=cfg.TEST.NECK_FEAT, num_classes=num_classes,
                       mixed_precision=bool(cfg.USE_MIXED_PRECISION))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_dinov2(model, generator).eval()
