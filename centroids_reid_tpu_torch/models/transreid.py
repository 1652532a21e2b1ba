"""TransReID (He et al., "TransReID: Transformer-based Object
Re-Identification", ICCV 2021, arXiv:2102.04378) for evaluation: a ViT over
overlapping patches with a learned camera embedding (SIE) and the jigsaw
patch module (JPM) head.

Follows ``model/backbones/vit_pytorch.py`` (``TransReID``,
``PatchEmbed_overlap``, ``Block``) and ``model/make_model.py``
(``build_transformer_local``, ``shuffle_unit``) of
github.com/damo-cv/TransReID. Parameter names are TransReID's (``base.*``,
``b1.*``, ``b2.*``, ``bottleneck*``, ``classifier*``), so its state dicts
load without renaming (``load_transreid_state_dict``).

The forward of one image batch:

* ``base``: ``Conv2d(3, D, patch, stride)`` patches, a cls token, the
  position embedding and ``SIE_COE x sie_embed[camera]`` on every token,
  then the first ``depth - 1`` pre-norm blocks (``base.blocks[-1]`` and
  ``base.norm`` are held, as published, and not run);
* ``b1``: a copy of the last block plus the final LayerNorm over all tokens,
  whose cls token is the global feature;
* ``b2``: a second copy over ``DEVIDE_LENGTH`` groups of ``(N - 1) //
  DEVIDE_LENGTH`` patch tokens, each behind the cls token, after
  ``shuffle_unit`` (shift by ``SHIFT_NUM``, shuffle in ``SHUFFLE_GROUP``
  groups) when ``RE_ARRANGE``; the groups run as one stacked batch;
* ``embed``: ``cat(global, local_1 / 4, ..., local_4 / 4)`` before the
  BNNecks (``TEST.NECK_FEAT before``) or after them (``after``), fp32.

Attention is ``scaled_dot_product_attention`` (scale 1 / sqrt(head dim));
with ``mixed_precision`` the model runs under bf16 autocast. Every
LayerNorm runs with the residual add before it as one site
(``ops/add_norm.py``: K8 on the card, today's ops on the CPU): the
trunk carries each block's MLP branch to the next block's ``norm1``
instead of adding it at the block's end, and a site that feeds a linear
writes its output in autocast's dtype, as the linear would cast it.
Training (JPM's ID and triplet losses over the five branches) is not
ported.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.add_norm import add_norm
from ..utils.profiling import annotate, count

# TransReID's factory names -> the widths of ``vit_pytorch.py``
VIT_WIDTHS = {
    "vit_base_patch16_224_TransReID": dict(embed_dim=768, depth=12,
                                           num_heads=12, mlp_ratio=4.0,
                                           patch_size=16),
}

NAME = "transformer"   # MODEL.NAME of TransReID's transformer models


def is_transreid(cfg) -> bool:
    return cfg.MODEL.NAME == NAME


def refuse(what: str, why: str):
    """Raise for a path that does not run TransReID."""
    raise NotImplementedError(
        f"{what} does not run TransReID (MODEL.NAME {NAME}): {why}")


def refuse_model(model, what: str, why: str) -> None:
    if isinstance(model, TransReIDModel):
        refuse(what, why)


class PatchEmbedOverlap(nn.Module):
    """``PatchEmbed_overlap``: a ``patch`` x ``patch`` conv at ``stride``,
    flattened to tokens [B, num_y * num_x, D]."""

    def __init__(self, img_size: Sequence[int], patch_size: int,
                 stride: Sequence[int], embed_dim: int):
        super().__init__()
        self.num_y = (img_size[0] - patch_size) // stride[0] + 1
        self.num_x = (img_size[1] - patch_size) // stride[1] + 1
        self.num_patches = self.num_y * self.num_x
        self.proj = nn.Conv2d(3, embed_dim, patch_size,
                              stride=tuple(stride))

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=True)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads,
                                  c // self.num_heads).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2])
        return self.proj(o.transpose(1, 2).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


def norm_site(x, delta, norm: nn.LayerNorm, to_linear: bool = True):
    """One LayerNorm site: ``(x + delta, norm(x + delta))`` in one pass
    (``delta`` None: no add). The output is written in the dtype its
    consumer receives today: autocast's where it feeds a linear (``norm1``
    -> qkv, ``norm2`` -> fc1), LayerNorm's own otherwise (``b1``'s and
    ``b2``'s final norms: fp32 under autocast, else the stream's). Under a profiler ``vit.norms`` counts the site's
    rows; K8's wrapper counts those it launched on as ``vit.norms_fused``."""
    dev = x.device.type
    dtype = (torch.get_autocast_dtype(dev)
             if to_linear and torch.is_autocast_enabled(dev) else None)
    count("vit.norms", x.numel() // x.shape[-1])
    return add_norm(x, delta, norm.weight, norm.bias, norm.eps, dtype)


class Block(nn.Module):
    """Pre-norm ViT block (LayerNorm eps 1e-6, exact GELU)."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))

    def after_norm1(self, x, y):
        """The block past its ``norm1`` site: ``x`` the residual stream,
        ``y = norm1(x)`` -> (``x`` + the attention branch, the MLP branch,
        not yet added)."""
        x, y = norm_site(x, self.attn(y), self.norm2)
        return x, self.mlp(y)

    def forward(self, x):
        x, y = norm_site(x, None, self.norm1)
        x, m = self.after_norm1(x, y)
        return x + m


class TransReID(nn.Module):
    """The backbone (``base``) with ``local_feature`` on: tokens after the
    first ``depth - 1`` blocks, [B, 1 + patches, D]. ``cameras`` 0 leaves
    SIE out (``SIE_CAMERA False``)."""

    def __init__(self, img_size: Sequence[int] = (256, 128),
                 patch_size: int = 16, stride: Sequence[int] = (12, 12),
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, cameras: int = 0,
                 sie_coe: float = 3.0):
        super().__init__()
        self.patch_embed = PatchEmbedOverlap(img_size, patch_size, stride,
                                             embed_dim)
        n = self.patch_embed.num_patches + 1
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, n, embed_dim))
        self.sie_embed = (nn.Parameter(torch.zeros(cameras, 1, embed_dim))
                          if cameras > 0 else None)
        self.sie_coe = float(sie_coe)
        self.blocks = nn.ModuleList(Block(embed_dim, num_heads, mlp_ratio)
                                    for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)

    def side_info(self, cams):
        """SIE's term for each row, [B, 1, D] (0 without SIE)."""
        if self.sie_embed is None:
            return 0.0
        return self.sie_coe * self.sie_embed[cams]

    def tokens(self, x, cams=None):
        """(the residual stream after the first ``depth - 1`` blocks, the
        last block's MLP branch still to add to it, or None)."""
        with annotate("vit.patch"):
            t = self.patch_embed(x)
            t = torch.cat((self.cls_token.expand(t.shape[0], -1, -1), t),
                          dim=1)
            t = t + self.pos_embed + self.side_info(cams)
        pending = None
        with annotate("vit.blocks"):
            for blk in self.blocks[:-1]:
                t, y = norm_site(t, pending, blk.norm1)
                t, pending = blk.after_norm1(t, y)
        return t, pending

    def forward(self, x, cams=None):
        t, pending = self.tokens(x, cams)
        return t if pending is None else t + pending


def shuffle_unit(features, shift: int, group: int, begin: int = 1):
    """TransReID's ``shuffle_unit``: the patch tokens shifted by ``shift``
    (the cls token dropped), then shuffled by a [group, -1] transpose; a
    token count that ``group`` does not divide is padded with token
    ``[-2]`` once, as its ``except`` branch does."""
    b, _, d = features.shape
    x = torch.cat([features[:, begin - 1 + shift:],
                   features[:, begin:begin - 1 + shift]], dim=1)
    if x.shape[1] % group:
        x = torch.cat([x, x[:, -2:-1, :]], dim=1)
    x = x.view(b, group, -1, d)
    return torch.transpose(x, 1, 2).contiguous().view(b, -1, d)


def _branch(seq: nn.Sequential, x, delta=None):
    """``b1`` or ``b2`` (a block, then the final LayerNorm) over ``x +
    delta``: (``x + delta``, the final norm's fp32 tokens, as ``seq(x +
    delta)``)."""
    blk, norm = seq
    x, y = norm_site(x, delta, blk.norm1)
    s, m = blk.after_norm1(x, y)
    return x, norm_site(s, m, norm, to_linear=False)[1]


def _neck(dim: int) -> nn.BatchNorm1d:
    bn = nn.BatchNorm1d(dim)
    bn.bias.requires_grad_(False)
    return bn


class TransReIDModel(nn.Module):
    """``build_transformer_local``: the backbone, the global branch ``b1``
    and the JPM branch ``b2``, five BNNecks (bias frozen) and, with
    ``num_classes`` > 0, five bias-free classifiers (held for state-dict
    compatibility; evaluation never runs them)."""

    def __init__(self, img_size: Sequence[int] = (256, 128),
                 patch_size: int = 16, stride: Sequence[int] = (12, 12),
                 embed_dim: int = 768, depth: int = 12, num_heads: int = 12,
                 mlp_ratio: float = 4.0, cameras: int = 0,
                 sie_coe: float = 3.0, shift_num: int = 5,
                 shuffle_groups: int = 2, divide_length: int = 4,
                 rearrange: bool = True, neck_feat: str = "before",
                 num_classes: int = 0, mixed_precision: bool = False):
        super().__init__()
        if neck_feat not in ("before", "after"):
            raise ValueError(f"TEST.NECK_FEAT must be 'before' or 'after', "
                             f"got {neck_feat!r}")
        self.base = TransReID(img_size, patch_size, stride, embed_dim, depth,
                              num_heads, mlp_ratio, cameras, sie_coe)
        self.b1 = nn.Sequential(Block(embed_dim, num_heads, mlp_ratio),
                                nn.LayerNorm(embed_dim, eps=1e-6))
        self.b2 = nn.Sequential(Block(embed_dim, num_heads, mlp_ratio),
                                nn.LayerNorm(embed_dim, eps=1e-6))
        self.bottleneck = _neck(embed_dim)
        for i in range(1, divide_length + 1):
            setattr(self, f"bottleneck_{i}", _neck(embed_dim))
        self.num_classes = num_classes
        if num_classes > 0:
            self.classifier = nn.Linear(embed_dim, num_classes, bias=False)
            for i in range(1, divide_length + 1):
                setattr(self, f"classifier_{i}",
                        nn.Linear(embed_dim, num_classes, bias=False))
        self.cameras = cameras
        self.shift_num = shift_num
        self.shuffle_groups = shuffle_groups
        self.divide_length = divide_length
        self.rearrange = rearrange
        self.neck_feat = neck_feat
        self.mixed_precision = mixed_precision
        self.embed_dim = embed_dim

    @property
    def emb_size(self) -> int:
        return self.embed_dim * (1 + self.divide_length)

    def jpm(self, features):
        """The local features [B, DEVIDE_LENGTH, D]: each group of patch
        tokens behind the cls token through ``b2``, all groups stacked
        into one batch."""
        b, n, d = features.shape
        k = self.divide_length
        length = (n - 1) // k
        x = (shuffle_unit(features, self.shift_num, self.shuffle_groups)
             if self.rearrange else features[:, 1:])
        parts = x[:, :length * k].reshape(b, k, length, d)
        token = features[:, None, 0:1].expand(b, k, 1, d)
        seqs = torch.cat((token, parts), dim=2).reshape(b * k, length + 1, d)
        return _branch(self.b2, seqs)[1][:, 0].reshape(b, k, d)

    def features(self, x, cams=None):
        """(global feature [B, D], local features [B, k, D]), before the
        BNNecks."""
        if self.cameras > 0 and cams is None:
            raise ValueError(
                "TransReID with SIE (MODEL.SIE_CAMERA True) needs each "
                "image's camera id: pass cams to embed")
        t, pending = self.base.tokens(x, cams)
        with annotate("vit.global"):
            # f: the backbone's tokens, which JPM reads too
            f, g = _branch(self.b1, t, pending)
            g = g[:, 0]
        with annotate("vit.jpm"):
            loc = self.jpm(f)
        return g, loc

    def embed(self, x, cams=None):
        """Eval-mode retrieval embedding, fp32 [B, D x (1 + k)]: the global
        feature and each local one / k, before or after the BNNecks
        (``neck_feat``). x: NCHW; ``cams``: int64 [B] camera ids on x's
        device (needed with SIE). Call on a model in ``eval()`` mode."""
        with torch.autocast(device_type=x.device.type, dtype=torch.bfloat16,
                            enabled=self.mixed_precision):
            g, loc = self.features(x, cams)
        g, loc = g.float(), loc.float()
        k = self.divide_length
        if self.neck_feat == "after":
            g = self.bottleneck(g)
            loc = torch.stack([getattr(self, f"bottleneck_{i + 1}")(
                loc[:, i]) for i in range(k)], dim=1)
        return torch.cat([g, (loc / k).flatten(1)], dim=1)


def init_transreid(model: TransReIDModel,
                   generator: torch.Generator) -> TransReIDModel:
    """TransReID's random init, drawn from ``generator`` (a CPU generator):
    linears ``trunc_normal_(std=0.02)`` with zero bias (its cut at +-2 lies
    100 std out, so a plain normal), LayerNorms 1 / 0, the patch conv
    N(0, sqrt(2 / (k * k * out))) with PyTorch's default uniform bias, the
    cls token, position and SIE embeddings N(0, 0.02), BNNecks 1 / 0
    (``weights_init_kaiming``), classifiers N(0, 0.001)
    (``weights_init_classifier``). Departure: ``b1`` and ``b2`` are drawn
    on their own, where TransReID copies both from the ImageNet-loaded
    last block (at a seeded init the global and local branches would then
    run one block)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.normal_(0.0, 0.02, generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.LayerNorm, nn.BatchNorm1d)):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, nn.Conv2d):
                fan = m.kernel_size[0] * m.kernel_size[1] * m.out_channels
                m.weight.normal_(0.0, math.sqrt(2.0 / fan),
                                 generator=generator)
                bound = 1.0 / math.sqrt(m.in_channels * m.kernel_size[0]
                                        * m.kernel_size[1])
                m.bias.uniform_(-bound, bound, generator=generator)
        for name, m in model.named_children():
            if name.startswith("classifier"):
                m.weight.normal_(0.0, 0.001, generator=generator)
        base = model.base
        for p in (base.cls_token, base.pos_embed, base.sie_embed):
            if p is not None:
                p.normal_(0.0, 0.02, generator=generator)
    return model


def make_transreid(cfg, num_classes: int = 0, cameras: int = 0,
                   generator: Optional[torch.Generator] = None
                   ) -> TransReIDModel:
    """The TransReID model of ``cfg`` (``MODEL.TRANSFORMER_TYPE`` names the
    widths; ``cameras`` is the dataset's camera count, which SIE needs),
    initialised from ``generator`` (seed 0 when None), in eval mode on the
    CPU."""
    m = cfg.MODEL
    if m.TRANSFORMER_TYPE not in VIT_WIDTHS:
        raise ValueError(
            f"MODEL.TRANSFORMER_TYPE {m.TRANSFORMER_TYPE!r} is not ported; "
            f"the port has {sorted(VIT_WIDTHS)}")
    if not m.JPM:
        refuse("create_model", "only the JPM head (build_transformer_local, "
               "MODEL.JPM True) is ported")
    if m.SIE_CAMERA and cameras <= 0:
        raise ValueError("MODEL.SIE_CAMERA needs the dataset's camera count")
    if list(cfg.INPUT.SIZE_TEST) != list(cfg.INPUT.SIZE_TRAIN):
        raise ValueError(
            "TransReID's position embedding is laid out for INPUT.SIZE_TRAIN "
            f"{list(cfg.INPUT.SIZE_TRAIN)}; INPUT.SIZE_TEST "
            f"{list(cfg.INPUT.SIZE_TEST)} would need it resized, which is "
            "not ported")
    model = TransReIDModel(
        img_size=tuple(cfg.INPUT.SIZE_TRAIN), stride=tuple(m.STRIDE_SIZE),
        **VIT_WIDTHS[m.TRANSFORMER_TYPE],
        cameras=cameras if m.SIE_CAMERA else 0, sie_coe=m.SIE_COE,
        shift_num=m.SHIFT_NUM, shuffle_groups=m.SHUFFLE_GROUP,
        divide_length=m.DEVIDE_LENGTH, rearrange=bool(m.RE_ARRANGE),
        neck_feat=cfg.TEST.NECK_FEAT, num_classes=num_classes,
        mixed_precision=bool(cfg.USE_MIXED_PRECISION))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return init_transreid(model, generator).eval()


def transreid_state_dict(sd) -> dict:
    """A TransReID checkpoint's state dict -> the port's keys: the same
    names, less a ``module.`` prefix (DataParallel) and ``base.fc.*`` (the
    backbone's ImageNet head, which TransReID builds and never runs)."""
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out = {}
    for k, v in sd.items():
        k = k[len("module."):] if k.startswith("module.") else k
        if not k.startswith("base.fc."):
            out[k] = v
    return out


def checkpoint_cameras(sd) -> int:
    """The SIE camera count a TransReID state dict was trained with (0
    without SIE)."""
    e = transreid_state_dict(sd).get("base.sie_embed")
    return 0 if e is None else int(e.shape[0])


def load_transreid_state_dict(model: TransReIDModel, sd) -> TransReIDModel:
    """Load a TransReID state dict (strict; classifiers may be absent
    from an inference model's view)."""
    sd = transreid_state_dict(sd)
    if model.num_classes == 0:
        sd = {k: v for k, v in sd.items() if not k.startswith("classifier")}
    model.load_state_dict(sd)
    return model

