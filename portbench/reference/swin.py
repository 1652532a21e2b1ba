"""Plain SOLIDER-REID Swin forward (Liu et al., ICCV 2021, arXiv:2103.14030;
Chen et al., CVPR 2023, arXiv:2303.17602), fp32, for the comparison that
decides a Swin cell's ``correct``.

Follows github.com/tinyvision/SOLIDER-REID step by step:
``model/backbones/swin_transformer.py`` (``PatchEmbed``, ``SwinBlock``,
``ShiftWindowMSA`` with ``F.pad``, ``torch.roll``, ``window_partition`` /
``window_reverse`` and the ``img_mask`` filled with -100, ``WindowMSA``
with explicit ``softmax(q k^T * scale + bias + mask) v``, ``PatchMerging``
through ``F.unfold``, the semantic controller) and
``model/make_model.py::build_transformer`` at test time (the mean over
the last stage's tokens, ``TEST.NECK_FEAT`` before or after the BNNeck).
Plain ``torch`` in fp32 with TF32 off for matmuls and convolutions;
nothing of the program under test is imported.

Weights are a state dict under SOLIDER's names (``base.*``,
``bottleneck.*``). Departures: the input is uint8 NHWC, normalised here as
the port's loader feeds the model; dropout and drop-path are the identity
(evaluation); the semantic controller's parametrisation after the last
stage (``norm3``, then the affine, then the mean) is the one the
configuration states under ``assumed``; ``linear`` lets a control put its
own rounding on the inputs and weights of every linear layer."""

from __future__ import annotations

import contextlib
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


def window_partition(x, window_size):
    """``ShiftWindowMSA.window_partition``."""
    B, H, W, C = x.shape
    x = x.view(B, H // window_size, window_size, W // window_size,
               window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).contiguous()
    return windows.view(-1, window_size, window_size, C)


def window_reverse(windows, H, W, window_size):
    """``ShiftWindowMSA.window_reverse``."""
    B = int(windows.shape[0] / (H * W / window_size / window_size))
    x = windows.view(B, H // window_size, W // window_size, window_size,
                     window_size, -1)
    return x.permute(0, 1, 3, 2, 4, 5).contiguous().view(B, H, W, -1)


def double_step_seq(step1, len1, step2, len2):
    """``WindowMSA.double_step_seq``."""
    seq1 = torch.arange(0, step1 * len1, step1)
    seq2 = torch.arange(0, step2 * len2, step2)
    return (seq1[:, None] + seq2[None, :]).reshape(1, -1)


def relative_position_index(window_size):
    Wh = Ww = window_size
    rel_index_coords = double_step_seq(2 * Ww - 1, Wh, 1, Ww)
    rel_position_index = rel_index_coords + rel_index_coords.T
    return rel_position_index.flip(1).contiguous()


class _Ref:
    def __init__(self, sd: dict, spec: dict, linear: Optional[Callable]):
        self.sd = sd
        self.spec = spec
        self.cast = linear or _identity
        self.eps = float(spec["ln_eps"])
        self.window = int(spec["window_size"])

    def linear(self, x, name):
        w = self.sd[name + ".weight"]
        b = self.sd.get(name + ".bias")
        return F.linear(self.cast(x), self.cast(w), b)

    def layer_norm(self, x, name):
        return F.layer_norm(x, (x.shape[-1],), self.sd[name + ".weight"],
                            self.sd[name + ".bias"], self.eps)

    def window_msa(self, x, name, num_heads, mask=None):
        """``WindowMSA.forward``."""
        B, N, C = x.shape
        qkv = self.linear(x, name + ".qkv").reshape(
            B, N, 3, num_heads, C // num_heads).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        q = q * (C // num_heads) ** -0.5
        attn = q @ k.transpose(-2, -1)
        ws = self.window
        table = self.sd[name + ".relative_position_bias_table"]
        index = relative_position_index(ws).to(table.device)
        bias = table[index.view(-1)].view(ws * ws, ws * ws, -1)
        bias = bias.permute(2, 0, 1).contiguous()
        attn = attn + bias.unsqueeze(0)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.view(B // nW, nW, num_heads, N, N) \
                + mask.unsqueeze(1).unsqueeze(0)
            attn = attn.view(-1, num_heads, N, N)
        attn = attn.softmax(dim=-1)
        x = (attn @ v).transpose(1, 2).reshape(B, N, C)
        return self.linear(x, name + ".proj")

    def shift_window_msa(self, query, hw_shape, name, num_heads, shift):
        """``ShiftWindowMSA.forward``."""
        B, L, C = query.shape
        H, W = hw_shape
        ws = self.window
        query = query.view(B, H, W, C)
        pad_r = (ws - W % ws) % ws
        pad_b = (ws - H % ws) % ws
        query = F.pad(query, (0, 0, 0, pad_r, 0, pad_b))
        H_pad, W_pad = query.shape[1], query.shape[2]
        if shift > 0:
            shifted_query = torch.roll(query, shifts=(-shift, -shift),
                                       dims=(1, 2))
            img_mask = torch.zeros((1, H_pad, W_pad, 1),
                                   device=query.device)
            h_slices = (slice(0, -ws), slice(-ws, -shift),
                        slice(-shift, None))
            w_slices = (slice(0, -ws), slice(-ws, -shift),
                        slice(-shift, None))
            cnt = 0
            for h in h_slices:
                for w in w_slices:
                    img_mask[:, h, w, :] = cnt
                    cnt += 1
            mask_windows = window_partition(img_mask, ws)
            mask_windows = mask_windows.view(-1, ws * ws)
            attn_mask = mask_windows.unsqueeze(1) - mask_windows.unsqueeze(2)
            attn_mask = attn_mask.masked_fill(attn_mask != 0, float(-100.0)) \
                .masked_fill(attn_mask == 0, float(0.0))
        else:
            shifted_query = query
            attn_mask = None
        query_windows = window_partition(shifted_query, ws)
        query_windows = query_windows.view(-1, ws ** 2, C)
        attn_windows = self.window_msa(query_windows, name + ".w_msa",
                                       num_heads, mask=attn_mask)
        attn_windows = attn_windows.view(-1, ws, ws, C)
        shifted_x = window_reverse(attn_windows, H_pad, W_pad, ws)
        if shift > 0:
            x = torch.roll(shifted_x, shifts=(shift, shift), dims=(1, 2))
        else:
            x = shifted_x
        if pad_r > 0 or pad_b:
            x = x[:, :H, :W, :].contiguous()
        return x.view(B, H * W, C)

    def block(self, x, hw_shape, name, num_heads, shift):
        """``SwinBlock.forward``."""
        identity = x
        x = self.layer_norm(x, name + ".norm1")
        x = self.shift_window_msa(x, hw_shape, name + ".attn", num_heads,
                                  shift)
        x = x + identity
        identity = x
        x = self.layer_norm(x, name + ".norm2")
        x = self.linear(F.gelu(self.linear(x, name + ".ffn.layers.0.0")),
                        name + ".ffn.layers.1")
        return x + identity

    def patch_merging(self, x, input_size, name):
        """``PatchMerging.forward`` at kernel 2, stride 2 (an even map)."""
        B, L, C = x.shape
        H, W = input_size
        x = x.view(B, H, W, C).permute([0, 3, 1, 2])
        x = F.unfold(x, kernel_size=2, stride=2)
        out_hw = (H // 2, W // 2)
        x = x.transpose(1, 2)
        x = self.layer_norm(x, name + ".norm")
        return self.linear(x, name + ".reduction"), out_hw

    def semantic(self, x, i, batch):
        """The controller after stage ``i`` (lambda < 0: none)."""
        lam = float(self.spec["semantic_weight"])
        if lam < 0:
            return x
        w = torch.ones(batch, 1, device=x.device) * lam
        w = torch.cat([w, 1 - w], axis=-1)
        sw = self.linear(w, f"base.semantic_embed_w.{i}").unsqueeze(1)
        sb = self.linear(w, f"base.semantic_embed_b.{i}").unsqueeze(1)
        return x * F.softplus(sw) + sb

    def bn(self, x, name):
        sd = self.sd
        return (x - sd[name + ".running_mean"]) / torch.sqrt(
            sd[name + ".running_var"] + 1e-5) * sd[name + ".weight"] \
            + sd[name + ".bias"]

    def forward(self, x):
        """``SwinTransformer.forward``, then ``build_transformer``'s test
        feature."""
        spec = self.spec
        B = x.shape[0]
        x = F.conv2d(x, self.sd["base.patch_embed.projection.weight"],
                     self.sd["base.patch_embed.projection.bias"],
                     stride=int(spec["patch_size"]))
        hw_shape = (x.shape[2], x.shape[3])
        x = x.flatten(2).transpose(1, 2)
        x = self.layer_norm(x, "base.patch_embed.norm")
        depths = spec["depths"]
        for i, depth in enumerate(depths):
            heads = int(spec["num_heads"][i])
            for j in range(depth):
                shift = self.window // 2 if j % 2 else 0
                x = self.block(x, hw_shape, f"base.stages.{i}.blocks.{j}",
                               heads, shift)
            if i + 1 < len(depths):
                x, hw_shape = self.patch_merging(
                    x, hw_shape, f"base.stages.{i}.downsample")
                x = self.semantic(x, i, B)
        last = len(depths) - 1
        x = self.layer_norm(x, f"base.norm{last}")
        x = self.semantic(x, last, B)
        global_feat = x.mean(dim=1)
        if spec["neck_feat"] == "after":
            return self.bn(global_feat, "bottleneck")
        return global_feat


def normalise(images_u8, mean, std):
    """uint8 [N, H, W, 3] -> fp32 NCHW, ``(x / 255 - mean) / std``."""
    x = images_u8.float() / 255.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return ((x - m) / s).permute(0, 3, 1, 2)


@torch.no_grad()
def embed(sd: dict, images_u8, spec: dict, block: int = 32,
          linear: Optional[Callable] = None):
    """The Swin test feature of each image, fp32 [N, C_last], in blocks of
    ``block`` images. ``sd``: the weights by SOLIDER's names (on the
    images' device); ``spec``: ``depths``, ``num_heads``, ``window_size``,
    ``patch_size``, ``ln_eps``, ``semantic_weight``, ``neck_feat``,
    ``pixel_mean``, ``pixel_std``."""
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
