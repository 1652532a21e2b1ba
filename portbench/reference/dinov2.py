"""Plain DINOv2 ViT forward with registers (Oquab et al., TMLR 2024,
arXiv:2304.07193; Darcet et al., ICLR 2024, arXiv:2309.16588), fp32, for
the comparison that decides a DINOv2 cell's ``correct``.

Follows github.com/facebookresearch/dinov2 step by step:
``models/vision_transformer.py`` (``prepare_tokens_with_masks``: the patch
conv, the cls token, ``interpolate_pos_encoding`` over the 37x37 grid each
call with ``F.interpolate(mode="bicubic", antialias=...)`` at ``size=(H /
14, W / 14)``, as ``interpolate_offset`` 0 has it, then the register tokens
after the cls token; ``forward_features``: the blocks, then ``norm`` over
every token and its cls token), ``layers/block.py`` (``x = x +
ls1(attn(norm1(x)))``, ``x = x + ls2(mlp(norm2(x)))``),
``layers/attention.py`` (explicit ``softmax(q k^T * head_dim^-0.5) v``),
``layers/layer_scale.py`` (``x * gamma``) and ``layers/swiglu_ffn.py``
(``w3(silu(x1) * x2)`` over the halves of ``w12(x)``); then the BNNeck at
test time when ``neck_feat`` is "after". Plain ``torch`` in fp32 with
TF32 off for matmuls and convolutions; nothing of the program under test
is imported.

Weights are a state dict under DINOv2's names below ``backbone.`` and
``bottleneck.*``. Departures: the input is uint8 NHWC, normalised here
with the configuration's mean and std as the port's loader feeds the
model; dropout and drop-path are the identity and the mask token is
unused (evaluation, no masks); ``linear`` lets a control put its own
rounding on the inputs and weights of every linear layer."""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def _tf32_off():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _identity(t):
    return t


class _Ref:
    def __init__(self, sd: dict, spec: dict, linear: Optional[Callable]):
        self.sd = sd
        self.spec = spec
        self.cast = linear or _identity
        self.eps = float(spec["ln_eps"])
        self.patch = int(spec["patch_size"])

    def linear(self, x, name):
        return F.linear(self.cast(x), self.cast(self.sd[name + ".weight"]),
                        self.sd.get(name + ".bias"))

    def layer_norm(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.sd[name + ".weight"],
                            self.sd[name + ".bias"], self.eps)

    def interpolate_pos_encoding(self, x, w, h):
        """``DinoVisionTransformer.interpolate_pos_encoding`` (``w``, ``h``
        are the input's dims 2 and 3, as the published code names them)."""
        pos_embed = self.sd["backbone.pos_embed"]
        npatch = x.shape[1] - 1
        N = pos_embed.shape[1] - 1
        if npatch == N and w == h:
            return pos_embed
        class_pos_embed = pos_embed[:, 0]
        patch_pos_embed = pos_embed[:, 1:]
        dim = x.shape[-1]
        w0 = w // self.patch
        h0 = h // self.patch
        M = int(math.sqrt(N))
        assert N == M * M
        # interpolate_offset 0 (the hub's registers models): by size
        patch_pos_embed = F.interpolate(
            patch_pos_embed.reshape(1, M, M, dim).permute(0, 3, 1, 2),
            mode="bicubic", antialias=bool(self.spec["interpolate_antialias"]),
            size=(w0, h0))
        assert (w0, h0) == patch_pos_embed.shape[-2:]
        patch_pos_embed = patch_pos_embed.permute(0, 2, 3, 1).view(1, -1, dim)
        return torch.cat((class_pos_embed.unsqueeze(0), patch_pos_embed),
                         dim=1)

    def prepare_tokens(self, x):
        """``prepare_tokens_with_masks`` with no masks."""
        B, nc, w, h = x.shape
        x = F.conv2d(x, self.sd["backbone.patch_embed.proj.weight"],
                     self.sd["backbone.patch_embed.proj.bias"],
                     stride=self.patch)
        x = x.flatten(2).transpose(1, 2)
        x = torch.cat((self.sd["backbone.cls_token"].expand(
            x.shape[0], -1, -1), x), dim=1)
        x = x + self.interpolate_pos_encoding(x, w, h)
        reg = self.sd.get("backbone.register_tokens")
        if int(self.spec["num_register_tokens"]) > 0:
            x = torch.cat((x[:, :1], reg.expand(x.shape[0], -1, -1),
                           x[:, 1:]), dim=1)
        return x

    def attention(self, x, name):
        """``Attention.forward``."""
        B, N, C = x.shape
        heads = int(self.spec["num_heads"])
        qkv = self.linear(x, name + ".qkv").reshape(
            B, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (C // heads) ** -0.5, qkv[1], qkv[2]
        attn = q @ k.transpose(-2, -1)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.linear(x, name + ".proj")

    def swiglu(self, x, name):
        """``SwiGLUFFN.forward``."""
        x12 = self.linear(x, name + ".w12")
        x1, x2 = x12.chunk(2, dim=-1)
        hidden = F.silu(x1) * x2
        return self.linear(hidden, name + ".w3")

    def block(self, x, name):
        """``Block.forward`` at evaluation (no drop-path)."""
        x = x + self.attention(self.layer_norm(x, name + ".norm1"),
                               name + ".attn") * self.sd[name + ".ls1.gamma"]
        x = x + self.swiglu(self.layer_norm(x, name + ".norm2"),
                            name + ".mlp") * self.sd[name + ".ls2.gamma"]
        return x

    def bn(self, x, name):
        sd = self.sd
        return (x - sd[name + ".running_mean"]) / torch.sqrt(
            sd[name + ".running_var"] + 1e-5) * sd[name + ".weight"] \
            + sd[name + ".bias"]

    def forward(self, x):
        """``forward_features``' ``x_norm_clstoken``, then the test
        feature."""
        x = self.prepare_tokens(x)
        for i in range(int(self.spec["depth"])):
            x = self.block(x, f"backbone.blocks.{i}")
        x_norm = self.layer_norm(x, "backbone.norm")
        cls = x_norm[:, 0]
        if self.spec["neck_feat"] == "after":
            return self.bn(cls, "bottleneck")
        return cls


def normalise(images_u8, mean, std):
    """uint8 [N, H, W, 3] -> fp32 NCHW, ``(x / 255 - mean) / std``."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2)


@torch.no_grad()
def embed(sd: dict, images_u8, spec: dict, block: int = 32,
          linear: Optional[Callable] = None):
    """The DINOv2 test feature of each image, fp32 [N, D], in blocks of
    ``block`` images. ``sd``: the weights by DINOv2's names (on the
    images' device); ``spec``: ``depth``, ``num_heads``, ``patch_size``,
    ``num_register_tokens``, ``interpolate_antialias``, ``ln_eps``,
    ``neck_feat``, ``pixel_mean``, ``pixel_std``."""
    sd = {k: v.float() if v.is_floating_point() else v
          for k, v in sd.items()}
    ref = _Ref(sd, spec, linear)
    out = []
    with _tf32_off():
        for s in range(0, images_u8.shape[0], block):
            x = normalise(images_u8[s:s + block], spec["pixel_mean"],
                          spec["pixel_std"])
            out.append(ref.forward(x))
    return torch.cat(out)
