"""Swin-B as SOLIDER-REID's re-id trunk, for evaluation: a hierarchical
transformer of shifted, padded windows with a relative-position bias,
patch merging between its stages and SOLIDER's semantic controller, then
one BNNeck.

Papers: Liu et al., "Swin Transformer: Hierarchical Vision Transformer
using Shifted Windows", ICCV 2021 (arXiv:2103.14030); Chen et al., "Beyond
Appearance: a Semantic Controllable Self-Supervised Learning Framework for
Human-Centric Visual Tasks" (SOLIDER), CVPR 2023 (arXiv:2303.17602).
Follows github.com/tinyvision/SOLIDER-REID: ``model/backbones/
swin_transformer.py`` (the mmdet-style ``SwinTransformer``,
``ShiftWindowMSA``, ``WindowMSA``, ``PatchMerging``, ``semantic_embed_w`` /
``semantic_embed_b``) and ``model/make_model.py::build_transformer`` (the
global head). Parameter names are SOLIDER's (``base.patch_embed.*``,
``base.stages.{i}.blocks.{j}.*``, ``base.stages.{i}.downsample.*``,
``base.norm{i}``, ``base.semantic_embed_{w,b}.{i}``, ``bottleneck``,
``classifier``), so its state dicts load without renaming
(``transreid.load_transreid_state_dict`` loads either family's ``.pth``).

The forward of one image batch (``MODEL.SEMANTIC_WEIGHT`` is lambda):

* patch embed: ``Conv2d(3, C, 4, stride 4)``, then LayerNorm;
* four stages of ``depths`` blocks at widths C, 2C, 4C, 8C. A block is
  ``x += crop(unshift(reverse(W-MSA(partition(shift(pad(norm1(x))))))))``,
  then ``x += mlp(norm2(x))``: the map is zero-padded on the bottom and
  right to a multiple of the window (the padded tokens are not masked, so
  they take part as keys and values), odd blocks roll it by -window // 2
  and add mmdet's region mask (``SHIFT_FILL`` between tokens of different
  regions, built over the padded map), and every window adds its head's
  relative-position bias;
* between stages, patch merging: ``nn.Unfold(2, stride 2)``'s channel-major
  4C features, LayerNorm, ``Linear(4C, 2C, bias=False)``;
* after stage i the tokens passed on (and, after the last stage, its
  output through ``norm3``) become ``x * softplus(W_i [lambda, 1 - lambda]
  + b_i) + V_i [lambda, 1 - lambda] + c_i`` (lambda < 0: no controller);
* the mean over the tokens is the global feature; ``embed`` returns it
  before the BNNeck (``TEST.NECK_FEAT before``) or after, fp32.
  ``norm0``-``norm2`` feed no embedding: they are held, as published, and
  not run.

A block's window attention (``ops/window_attn.py``, K9 on the card) takes
qkv of the real tokens alone: a padded token's q, k and v are the qkv
bias (what a zero row gives), its pad, roll and partition are the token
order of ``window_geometry``, the relative-position bias and shift mask
one fp32 table a block (``window_mask``), and it writes each real token's
output in its own row, so proj runs on the real rows too. With
``mixed_precision`` the trunk runs under bf16 autocast, the
residual stream and LayerNorms in fp32, as TransReID's
(``models/transreid.py``). Every LayerNorm is a ``norm_site`` (K8 on the
card): a block's ``norm1`` with the previous block's MLP branch added
before it, its ``norm2`` with the attention branch, ``norm3`` with the
last block's MLP branch, and the merging norms with no add. SOLIDER's
training is not ported.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.window_attn import window_attention
from ..utils.profiling import annotate, count
from .transreid import SWIN, _neck, family, is_transformer, norm_site, refuse

# SOLIDER-REID's factory names -> the widths of ``swin_transformer.py``
SWIN_WIDTHS = {
    "swin_base_patch4_window7_224": dict(embed_dim=128, depths=(2, 2, 18, 2),
                                         num_heads=(4, 8, 16, 32)),
}

SHIFT_FILL = -100.0   # mmdet's mask between tokens of different regions
_MASK_ALIGN = 16      # attn_mask rows: memory-efficient SDPA's alignment


def is_swin(cfg) -> bool:
    return is_transformer(cfg) and family(cfg) == SWIN


class Windows(NamedTuple):
    """Where a block's windows lie on an ``h`` x ``w`` map padded to ``hp``
    x ``wp``: ``order`` [windows * N] (int32) the padded map's row (``y *
    wp + x``) of each window token, after the roll; ``inverse`` [h * w]
    (int32) the window token of each real token; ``region`` [windows, N,
    N] the shift mask (0 or ``SHIFT_FILL``), None for a block that does
    not shift."""

    h: int
    w: int
    hp: int
    wp: int
    order: torch.Tensor
    inverse: torch.Tensor
    region: Optional[torch.Tensor]


@functools.lru_cache(maxsize=32)
def window_geometry(h: int, w: int, window: int, shift: int,
                    device: torch.device) -> Windows:
    """``Windows`` of an ``h`` x ``w`` map (cached: index tensors only,
    never written). ``torch.roll`` by ``-shift`` puts padded row ``(i +
    shift) % hp`` at ``i``; mmdet's ``window_partition`` orders the tokens
    by window (row-major), then row-major inside each window; mmdet's
    ``img_mask`` labels the shifted map in 3 x 3 regions."""
    with torch.inference_mode(False):   # plain tensors, kept across calls
        return _geometry(h, w, window, shift, device)


def _geometry(h: int, w: int, window: int, shift: int,
              device: torch.device) -> Windows:
    hp, wp = -(-h // window) * window, -(-w // window) * window
    nh, nw = hp // window, wp // window
    rows = (torch.arange(hp) + shift) % hp
    cols = (torch.arange(wp) + shift) % wp
    order = (rows.view(nh, 1, window, 1) * wp
             + cols.view(1, nw, 1, window)).reshape(-1)
    where = torch.empty_like(order)
    where[order] = torch.arange(order.numel())
    inverse = where.view(hp, wp)[:h, :w].reshape(-1)
    region = None
    if shift:
        def labels(n):
            lab = torch.zeros(n, dtype=torch.int64)
            lab[n - window:n - shift] = 1
            lab[n - shift:] = 2
            return lab

        lab = (labels(hp).view(nh, 1, window, 1) * 3
               + labels(wp).view(1, nw, 1, window)).reshape(nh * nw, -1)
        region = torch.zeros(lab.shape + lab.shape[-1:])
        region.masked_fill_(lab[:, None, :] != lab[:, :, None], SHIFT_FILL)
        region = region.to(device)
    return Windows(h, w, hp, wp, order.to(device, torch.int32),
                   inverse.to(device, torch.int32), region)


def window_mask(bias: torch.Tensor, region: Optional[torch.Tensor], b: int,
                dtype: torch.dtype) -> torch.Tensor:
    """The additive ``attn_mask`` of a block's windows in ``dtype``: the
    relative-position bias [heads, N, N] for every window ([1, heads, N,
    N]) or, with a shift ``region`` [windows, N, N], bias + region for
    each window of each of ``b`` images ([b * windows, heads, N, N]). Its
    rows are laid out ``_MASK_ALIGN``-aligned, so that the
    memory-efficient attention reads it where it lies instead of copying
    it padded."""
    heads, n = bias.shape[0], bias.shape[-1]
    lead = (1,) if region is None else (b, region.shape[0])
    store = torch.empty(lead + (heads, n, -(-n // _MASK_ALIGN) * _MASK_ALIGN),
                        dtype=dtype, device=bias.device)
    m = store[..., :n]
    # summed in fp32, rounded once, then copied out in ``dtype``
    m.copy_((bias if region is None else bias[None] + region[:, None])
            .to(dtype))
    return m.view(-1, heads, n, n)


def relative_position_index(window: int) -> torch.Tensor:
    """mmdet's ``WindowMSA`` index [N, N] into the bias table
    (``double_step_seq`` and its flip)."""
    coords = (torch.arange(0, (2 * window - 1) * window, 2 * window - 1)
              [:, None] + torch.arange(window)[None, :]).reshape(1, -1)
    return (coords + coords.T).flip(1).contiguous()


class WindowMSA(nn.Module):
    """mmdet's ``WindowMSA``: qkv, the bias table and proj (scale head
    width^-0.5); ``ShiftWindowMSA`` runs them."""

    def __init__(self, dim: int, num_heads: int, window: int):
        super().__init__()
        self.num_heads = num_heads
        self.window = window
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window))
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def position_bias(self) -> torch.Tensor:
        """The relative-position bias [heads, N, N]."""
        n = self.window ** 2
        return self.relative_position_bias_table[
            self.relative_position_index.view(-1)].view(n, n, -1).permute(
                2, 0, 1)


class ShiftWindowMSA(nn.Module):
    """mmdet's ``ShiftWindowMSA``: the attention branch of a block, from
    pad to crop, as qkv over the real tokens, ``window_attention`` and
    proj. Counts ``swin.tokens`` (real tokens entering window attention)
    and ``swin.window_tokens`` (the same, padding included)."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int):
        super().__init__()
        self.window = window
        self.shift = shift
        self.w_msa = WindowMSA(dim, num_heads, window)

    def forward(self, y, hw: Tuple[int, int]):
        """y: the normalised tokens [B, H * W, C] -> the branch, the same
        shape, in the dtype of proj's output."""
        b = y.shape[0]
        g = window_geometry(hw[0], hw[1], self.window, self.shift, y.device)
        count("swin.tokens", b * g.h * g.w)
        count("swin.window_tokens", b * g.hp * g.wp)
        msa = self.w_msa
        qkv = msa.qkv(y)
        # one table a block, batch-free: bias (+ shift mask) in fp32
        table = window_mask(msa.position_bias(), g.region, 1, torch.float32)
        o = window_attention(qkv, msa.qkv.bias.to(qkv.dtype), table, g,
                             msa.num_heads)
        return msa.proj(o)


class FFN(nn.Module):
    """mmcv's ``FFN`` (two linears, exact GELU; its residual add is the
    block's): ``layers.0.0`` fc1, ``layers.1`` fc2."""

    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(dim, hidden), nn.GELU()),
            nn.Linear(hidden, dim))

    def forward(self, y):
        return self.layers(y)


class SwinBlock(nn.Module):
    """mmdet's ``SwinBlock`` (pre-norm), shifted when ``shift`` > 0."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float, eps: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = ShiftWindowMSA(dim, num_heads, window, shift)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.ffn = FFN(dim, int(dim * mlp_ratio))

    def forward(self, x, pending, hw):
        """``x`` the residual stream [B, H * W, C], ``pending`` the previous
        block's MLP branch not yet added to it (or None) -> (the stream
        with it and this block's attention branch added, this block's MLP
        branch, not yet added)."""
        x, y = norm_site(x, pending, self.norm1)
        with annotate("swin.wmsa"):
            a = self.attn(y, hw)
        with annotate("swin.mlp"):
            x, y = norm_site(x, a, self.norm2)
            return x, self.ffn(y)


class PatchMerging(nn.Module):
    """mmdet's ``PatchMerging`` at kernel 2, stride 2: ``nn.Unfold``'s
    features (channel-major: ``c * 4 + dy * 2 + dx``), LayerNorm(4C),
    ``Linear(4C, out, bias=False)``, written in the residual stream's
    type. Its corner padding of an odd map is not ported (no published
    input size makes one)."""

    def __init__(self, dim: int, out: int, eps: float):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=eps)
        self.reduction = nn.Linear(4 * dim, out, bias=False)

    def forward(self, x, hw):
        b, _, c = x.shape
        h, w = hw
        if h % 2 or w % 2:
            raise ValueError(f"patch merging of a {h}x{w} map: the corner "
                             "padding of an odd map is not ported")
        u = x.view(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 5, 2, 4)
        _, y = norm_site(u.reshape(b, h * w // 4, 4 * c), None, self.norm)
        return self.reduction(y).to(x.dtype), (h // 2, w // 2)


class SwinStage(nn.Module):
    """mmdet's ``SwinBlockSequence``: blocks (odd ones shifted by
    window // 2), then the patch merging to ``out`` (None: none)."""

    def __init__(self, dim: int, depth: int, num_heads: int, window: int,
                 mlp_ratio: float, eps: float, out: Optional[int]):
        super().__init__()
        self.blocks = nn.ModuleList(
            SwinBlock(dim, num_heads, window, (window // 2) * (j % 2),
                      mlp_ratio, eps) for j in range(depth))
        self.downsample = (PatchMerging(dim, out, eps) if out is not None
                           else None)


class PatchEmbed(nn.Module):
    """mmdet's ``PatchEmbed``: ``projection`` conv, then ``norm``."""

    def __init__(self, dim: int, patch_size: int, eps: float):
        super().__init__()
        self.projection = nn.Conv2d(3, dim, patch_size, stride=patch_size)
        self.norm = nn.LayerNorm(dim, eps=eps)


class SwinTransformer(nn.Module):
    """SOLIDER's ``SwinTransformer`` (``base``), with no absolute
    position embedding; ``semantic_weight`` is lambda."""

    def __init__(self, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 7,
                 patch_size: int = 4, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-5, semantic_weight: float = 0.2):
        super().__init__()
        dims = [embed_dim * 2 ** i for i in range(len(depths))]
        self.num_features = dims[-1]
        self.patch_embed = PatchEmbed(embed_dim, patch_size, ln_eps)
        self.stages = nn.ModuleList(
            SwinStage(dims[i], depths[i], num_heads[i], window, mlp_ratio,
                      ln_eps, dims[i + 1] if i + 1 < len(dims) else None)
            for i in range(len(dims)))
        for i, d in enumerate(dims):
            setattr(self, f"norm{i}", nn.LayerNorm(d, eps=ln_eps))
        self.semantic_weight = float(semantic_weight)
        if self.semantic_weight >= 0:
            widths = dims[1:] + dims[-1:]
            self.semantic_embed_w = nn.ModuleList(nn.Linear(2, d)
                                                  for d in widths)
            self.semantic_embed_b = nn.ModuleList(nn.Linear(2, d)
                                                  for d in widths)

    def semantic(self, i: int, x):
        """The controller after stage ``i``: ``x * softplus(W_i l + b_i) +
        V_i l + c_i``, l = [lambda, 1 - lambda], in the parameters' type
        (outside autocast); ``x`` itself when lambda < 0."""
        if self.semantic_weight < 0:
            return x
        w, b = self.semantic_embed_w[i], self.semantic_embed_b[i]
        lam = torch.full((1, 1), self.semantic_weight, dtype=w.weight.dtype,
                         device=x.device)
        lam = torch.cat([lam, 1 - lam], dim=-1)
        with torch.autocast(device_type=x.device.type, enabled=False):
            scale, shift = F.softplus(w(lam)), b(lam)
        return x * scale + shift

    def tokens(self, x):
        """(the residual stream after the last stage [B, tokens, C_last],
        the last block's MLP branch, not yet added to it)."""
        with annotate("swin.patch"):
            t = self.patch_embed.projection(x)
            hw = (t.shape[2], t.shape[3])
            t = t.flatten(2).transpose(1, 2).to(
                self.patch_embed.norm.weight.dtype)
            _, t = norm_site(t, None, self.patch_embed.norm,
                             to_linear=False)
        pending = None
        for i, stage in enumerate(self.stages):
            for blk in stage.blocks:
                t, pending = blk(t, pending, hw)
            if stage.downsample is not None:
                with annotate("swin.merge"):
                    t, hw = stage.downsample(t + pending, hw)
                    t = self.semantic(i, t)
                pending = None
        return t, pending

    def head(self, t, pending):
        """``norm3`` over the stream with the last MLP branch added, the
        controller, the mean over the tokens: [B, C_last]."""
        last = len(self.stages) - 1
        _, y = norm_site(t, pending, getattr(self, f"norm{last}"),
                         to_linear=False)
        return self.semantic(last, y).mean(1)


class SwinReID(nn.Module):
    """``build_transformer`` over Swin: the backbone, one BNNeck (bias
    frozen) and, with ``num_classes`` > 0, a bias-free classifier (held for
    state-dict compatibility; evaluation never runs it)."""

    FAMILY = SWIN

    def __init__(self, embed_dim: int = 128,
                 depths: Sequence[int] = (2, 2, 18, 2),
                 num_heads: Sequence[int] = (4, 8, 16, 32), window: int = 7,
                 patch_size: int = 4, mlp_ratio: float = 4.0,
                 ln_eps: float = 1e-5, semantic_weight: float = 0.2,
                 neck_feat: str = "before", num_classes: int = 0,
                 mixed_precision: bool = False):
        super().__init__()
        if neck_feat not in ("before", "after"):
            raise ValueError(f"TEST.NECK_FEAT must be 'before' or 'after', "
                             f"got {neck_feat!r}")
        self.base = SwinTransformer(embed_dim, depths, num_heads, window,
                                    patch_size, mlp_ratio, ln_eps,
                                    semantic_weight)
        dim = self.base.num_features
        self.bottleneck = _neck(dim)
        self.num_classes = num_classes
        if num_classes > 0:
            self.classifier = nn.Linear(dim, num_classes, bias=False)
        self.neck_feat = neck_feat
        self.mixed_precision = mixed_precision

    @property
    def emb_size(self) -> int:
        return self.base.num_features

    def embed(self, x, cams=None):
        """Eval-mode retrieval embedding, fp32 [B, C_last], before or after
        the BNNeck (``neck_feat``). x: NCHW; ``cams`` is taken and not
        read. Call on a model in ``eval()`` mode."""
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=self.mixed_precision):
            t, pending = self.base.tokens(x)
        with annotate("swin.head"):
            g = self.base.head(t, pending).float()
            if self.neck_feat == "after":
                g = self.bottleneck(g)
        return g


def init_swin(model: SwinReID, generator: torch.Generator) -> SwinReID:
    """A seeded init drawn from ``generator`` (on the parameters' device):
    Swin's linears N(0, 0.02), with their biases N(0, 0.02) too where
    Swin's are 0 (so that a padded token's q, k and v, which equal those
    biases, are not 0), relative-position tables N(0, 1) (near trained
    tables' scale), LayerNorms and BNNecks 1 / 0, the classifier N(0,
    0.001); the patch conv and the controller's ``Linear(2, .)`` take
    PyTorch's default distributions (uniform within 1 / sqrt(fan_in))."""
    base = model.base
    default = [base.patch_embed.projection]
    if base.semantic_weight >= 0:
        default += [*base.semantic_embed_w, *base.semantic_embed_b]
    default = {id(m) for m in default}
    with torch.no_grad():
        for m in model.modules():
            if id(m) in default:
                bound = 1.0 / math.sqrt(m.weight[0].numel())
                m.weight.uniform_(-bound, bound, generator=generator)
                m.bias.uniform_(-bound, bound, generator=generator)
            elif isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.normal_(0.0, 0.02, generator=generator)
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, WindowMSA):
                m.relative_position_bias_table.normal_(0.0, 1.0,
                                                       generator=generator)
        if model.num_classes > 0:
            model.classifier.weight.normal_(0.0, 0.001, generator=generator)
    return model


def make_swin(cfg, num_classes: int = 0,
              generator: Optional[torch.Generator] = None) -> SwinReID:
    """The Swin model of ``cfg`` (``MODEL.TRANSFORMER_TYPE`` names the
    widths, ``MODEL.SEMANTIC_WEIGHT`` is lambda), initialised from
    ``generator`` (seed 0 when None), in eval mode on the current
    device."""
    m = cfg.MODEL
    if m.TRANSFORMER_TYPE not in SWIN_WIDTHS:
        raise ValueError(
            f"MODEL.TRANSFORMER_TYPE {m.TRANSFORMER_TYPE!r} is not ported; "
            f"the port has {sorted(SWIN_WIDTHS)}")
    if m.JPM:
        refuse("create_model", "SOLIDER-REID's Swin runs the global head "
               "(build_transformer, MODEL.JPM False); JPM's b1 and b2 copy "
               "a ViT block", SWIN)
    if m.SIE_CAMERA:
        refuse("create_model", "SOLIDER-REID's Swin has no camera "
               "embedding (MODEL.SIE_CAMERA False)", SWIN)
    model = SwinReID(**SWIN_WIDTHS[m.TRANSFORMER_TYPE],
                     semantic_weight=m.SEMANTIC_WEIGHT,
                     neck_feat=cfg.TEST.NECK_FEAT, num_classes=num_classes,
                     mixed_precision=bool(cfg.USE_MIXED_PRECISION))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_swin(model, generator).eval()
