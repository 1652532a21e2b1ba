"""int8 post-training-quantized (PTQ) embed for serving.

Counterpart of ``centroids_reid_tpu/models/quantized.py``, read from the
port's ``ReidModel`` and run in PyTorch:

* **Folding.** Every conv -> BN pair folds into one affine conv; the eval
  normalisation ``(u / 255 - mean) / std`` folds into the stem, whose input
  is the uint8 image padded with the rounded mean pixel and shifted by -128
  (an exact int8 field). IBN-a's BatchNorm half folds like any BN; its
  InstanceNorm half stays a runtime op.
* **Quantization.** Per-output-channel symmetric int8 weights (HWIO, fp32
  ``w_scale``); per-tensor symmetric int8 activations with scales
  calibrated by absolute max (or a percentile) over calibration batches run
  through the folded fp32 graph (``_FpEngine``). Requantization after every
  ReLU, the stem and the downsample branch; max pool on int8 with -128
  padding; the tail (GAP, BNNeck) in fp32.
* **Execution** (``_Int8Engine``). With ``use_pallas`` truthy, every 1x1
  conv (stride-2 ones after a row slice) runs on K5 and every stride-1 3x3
  conv on K6 (``ops/int8_conv.py``; their plain versions on the CPU),
  each with its weight packed K-major once, at first use, and kept. The
  7x7 stem and the stride-2 3x3 convs, and every conv with
  ``use_pallas=False``, run as an int8 conv with the accumulator
  ``acc_dtype`` (int32 exact, or rounded to bf16), then a separate
  requantization.

Tensors are NHWC, as in the reference, so its artifacts (``.npz``, HWIO)
load unchanged: ``QuantizedEmbed.save`` and ``load`` read and write the JAX
package's format.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .resnet import _ARCHS

_EPS = 1e-5  # BN epsilon of every norm in resnet.py


# ---------------------------------------------------------------------------
# Folding
# ---------------------------------------------------------------------------


def _hwio(conv) -> torch.Tensor:
    return conv.weight.detach().float().permute(2, 3, 1, 0)  # OIHW -> HWIO


def _bn_affine(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    g = bn.weight.detach().float() * torch.rsqrt(
        bn.running_var.detach().float() + _EPS)
    return g, bn.bias.detach().float() - bn.running_mean.detach().float() * g


def _fold_conv_bn(conv, bn) -> Dict[str, torch.Tensor]:
    """conv -> BN folded to (W_f [kh, kw, ci, co] fp32, b_f [co] fp32)."""
    g, b = _bn_affine(bn)
    return {"w": (_hwio(conv) * g).contiguous(), "b": b}


def _block_plan(name: str, last_stride: int) -> List[Tuple]:
    """Static per-block plan
    [(block_name, kind, planes, stride, has_downsample, use_ibn)], as the
    trunk builds its blocks; serialised into ``QuantizedEmbed.save``."""
    spec = _ARCHS[name]
    kind = "bottleneck" if spec["block"].__name__ == "Bottleneck" else "basic"
    expansion = 4 if kind == "bottleneck" else 1
    strides = (1, 2, 2, last_stride)
    plan = []
    inplanes = 64
    for stage, (mult, nblocks) in enumerate(zip((1, 2, 4, 8), spec["layers"])):
        planes = 64 * mult
        use_ibn = spec["ibn"] and planes != 512
        for b in range(nblocks):
            stride = strides[stage] if b == 0 else 1
            has_ds = b == 0 and (stride != 1 or inplanes != planes * expansion)
            plan.append((f"layer{stage + 1}_{b}", kind, planes, stride, has_ds,
                         use_ibn))
            inplanes = planes * expansion
    return plan


def _fold_conv_ibn(conv, ibn) -> Dict[str, torch.Tensor]:
    """conv -> IBN: the BatchNorm half (channels [half:]) folds into the conv
    as conv+BN; the InstanceNorm half stays a runtime op, its affine
    parameters ride along as ``in_scale`` / ``in_bias``."""
    w = _hwio(conv)
    half = w.shape[3] // 2
    g_bn, b_bn = _bn_affine(ibn.BN)
    g = torch.cat([g_bn.new_ones(half), g_bn])
    b = torch.cat([b_bn.new_zeros(half), b_bn])
    return {
        "w": (w * g).contiguous(),
        "b": b,
        "in_scale": ibn.IN.weight.detach().float(),
        "in_bias": ibn.IN.bias.detach().float(),
    }


def _instance_norm_int8_domain(z_half, s, in_scale, in_bias):
    """Per-sample InstanceNorm whose reductions read the int8 tensor
    ``z_half`` (real values ``s * int``). With ``mu_r = s mu`` and
    ``var_r = s^2 var``, ``(real - mu_r) rsqrt(var_r + eps) = (int - mu)
    rsqrt(var + eps / s^2)``: the scale cancels out of the statistics and
    re-enters only through the eps term."""
    x = z_half.float()
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = torch.clamp((x * x).mean(dim=(1, 2), keepdim=True) - mu * mu,
                      min=0.0)
    k = torch.rsqrt(var + torch.full_like(s, _EPS) / (s * s)) * in_scale
    return (x - mu) * k + in_bias


def _apply_instance_norm(y, in_scale, in_bias):
    """Per-sample InstanceNorm over H, W on the first half of the channels
    (fp32, eps 1e-5)."""
    half = in_scale.shape[0]
    x = y[..., :half]
    mu = x.mean(dim=(1, 2), keepdim=True)
    var = torch.clamp((x * x).mean(dim=(1, 2), keepdim=True) - mu * mu,
                      min=0.0)
    xh = (x - mu) * torch.rsqrt(var + _EPS)
    return torch.cat([xh * in_scale + in_bias, y[..., half:]], dim=-1)


def _block(backbone, bname: str):
    stage, idx = bname[len("layer"):].split("_")
    return getattr(backbone, f"layer{stage}")[int(idx)]


def fold_backbone(model, pixel_mean: Sequence[float],
                  pixel_std: Sequence[float]) -> Dict[str, Any]:
    """Fold every conv+BN pair of a ``ReidModel``, with the input
    normalisation folded into the stem. Returns the folded fp32 tree (on
    the model's device) plus the static plan and input-prep constants."""
    bb = model.backbone
    mean = np.asarray(pixel_mean, np.float32)
    std = np.asarray(pixel_std, np.float32)
    # z = pad(u8, round(255 mean)) - 128; x_norm = alpha z + delta exactly
    alpha = 1.0 / (255.0 * std)
    delta = (128.0 / 255.0 - mean) / std
    pad_value = np.round(255.0 * mean).astype(np.int32)

    stem = _fold_conv_bn(bb.conv1, bb.bn1)
    w_f = stem["w"]  # [7, 7, 3, 64]
    dev = w_f.device
    stem_w = w_f * torch.from_numpy(alpha).to(dev)[None, None, :, None]
    stem_b = stem["b"] + torch.einsum("hwco,c->o", w_f,
                                      torch.from_numpy(delta).to(dev))

    blocks = []
    plan = _block_plan(model.backbone_name, model.last_stride)
    for bname, kind, _, _, has_ds, use_ibn in plan:
        blk = _block(bb, bname)
        entry = {
            "conv1": (_fold_conv_ibn(blk.conv1, blk.bn1) if use_ibn
                      else _fold_conv_bn(blk.conv1, blk.bn1)),
            "conv2": _fold_conv_bn(blk.conv2, blk.bn2),
        }
        if kind == "bottleneck":
            entry["conv3"] = _fold_conv_bn(blk.conv3, blk.bn3)
        if has_ds:
            entry["ds"] = _fold_conv_bn(blk.downsample[0], blk.downsample[1])
        blocks.append(entry)

    neck = model.bn
    return {
        "stem": {"w": stem_w.contiguous(), "b": stem_b},
        "blocks": blocks,
        "bnneck": {
            "scale": neck.weight.detach().float(),
            "bias": neck.bias.detach().float(),
            "mean": neck.running_mean.detach().float(),
            "var": neck.running_var.detach().float(),
        },
        "plan": plan,
        "pad_value": pad_value,
        "stem_relu": _ARCHS[model.backbone_name]["ibn"],  # plain: no stem ReLU
    }


# ---------------------------------------------------------------------------
# Shared forward structure; two engines (fp32 observe / int8 execute)
# ---------------------------------------------------------------------------


def _prep_input(imgs_u8, pad_value) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> int8 field [B, H + 6, W + 6, 3] (stem pad 3,
    VALID conv): the border holds the rounded mean pixel (normalised zero),
    and the -128 shift keeps every pixel value exact in int8."""
    b, h, w, _ = imgs_u8.shape
    z = torch.as_tensor(pad_value, dtype=torch.int32,
                        device=imgs_u8.device).expand(b, h + 6, w + 6, 3)
    z = z.clone()
    z[:, 3:-3, 3:-3, :] = imgs_u8
    return (z - 128).to(torch.int8)


def _conv_nhwc(x, w_hwio, stride: int, pad: int):
    """NHWC x HWIO conv in the dtype of ``x`` -> NHWC."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w_hwio.permute(3, 2, 0, 1),
                 stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1)


def _conv_int8(z_i8, w_i8, stride: int, pad: int, acc_dtype=torch.int32):
    """int8 conv with the accumulator dtype ``acc_dtype``. The sum is exact
    in fp64 (|acc| <= 7 * 7 * 2048 * 128 * 127 < 2^53) and is returned as
    int32, or rounded to bf16 (through fp32). The fp64 operands are
    contiguous NCHW / OIHW, the layout every fp64 conv backend takes."""
    acc = F.conv2d(z_i8.permute(0, 3, 1, 2).contiguous().double(),
                   w_i8.permute(3, 2, 0, 1).contiguous().double(),
                   stride=stride, padding=pad).permute(0, 2, 3, 1)
    if acc_dtype == torch.int32:
        return acc.to(torch.int32)
    return acc.float().to(acc_dtype)


def _maxpool(x, fill):
    """3x3, stride 2, pad 1 max pool over NHWC, padding with ``fill``."""
    _, h, w, _ = x.shape
    xp = F.pad(x, (0, 0, 1, 1, 1, 1), value=fill)
    ho, wo = (h - 1) // 2 + 1, (w - 1) // 2 + 1
    out = None
    for i in range(3):
        for j in range(3):
            s = xp[:, i:i + 2 * ho - 1:2, j:j + 2 * wo - 1:2, :]
            out = s if out is None else torch.maximum(out, s)
    return out


class _FpEngine:
    """fp32 engine over the folded graph; records the range at each
    requantization point. Running it is the calibration pass: ranges are
    observed at exactly the quantization points of the int8 engine."""

    def __init__(self, fold, percentile: float = 100.0):
        self.fold = fold
        self.percentile = percentile
        self.maxes: Dict[str, torch.Tensor] = {}

    def input(self, imgs_u8):
        return _prep_input(imgs_u8, self.fold["pad_value"]).float()

    def _observe(self, name, x):
        a = x.abs()
        if self.percentile >= 100.0:
            self.maxes[name] = a.amax()
        else:
            # percentile over a strided subsample of <= 2^20 elements
            flat = a.reshape(-1)
            stride = -(-flat.numel() // (1 << 20))
            self.maxes[name] = torch.quantile(flat[::stride],
                                              self.percentile / 100.0)
        return x

    def conv_act(self, x, entry, stride, pad, qname, relu=True):
        y = _conv_nhwc(x, entry["w"], stride, pad) + entry["b"]
        if relu:
            y = torch.relu(y)
        return self._observe(qname, y)

    def conv_add_act(self, x, entry, stride, pad, res, qname):
        y = _conv_nhwc(x, entry["w"], stride, pad) + entry["b"]
        return self._observe(qname, torch.relu(y + res))

    def conv_in_act(self, x, entry, qname):
        """conv (BN half folded) -> InstanceNorm on the first half -> ReLU;
        also observes the conv output, where the int8 engine requantizes
        before its int8-domain InstanceNorm (``qname + ".pre"``)."""
        y = _conv_nhwc(x, entry["w"], 1, 0) + entry["b"]
        self._observe(qname + ".pre", y)
        y = _apply_instance_norm(y, entry["in_scale"], entry["in_bias"])
        return self._observe(qname, torch.relu(y))

    def dequant(self, x):
        return x

    def maxpool(self, x):
        return _maxpool(x, float("-inf"))


class _Int8Engine:
    """int8 engine: tensors are (int8 NHWC values, fp32 scalar scale)
    pairs. Eligible convs run on the fused kernels K5 / K6 (conv, scale and
    bias, residual, ReLU and the int8 rounding in one launch); the others
    run an int8 conv and a separate requantization. ``packed`` maps
    ``id(w)`` of a fused conv's weight to ``(w, pack_weight(w))``; the
    caller keeps it across calls, so each weight is packed once."""

    def __init__(self, qtree, use_pallas, acc_dtype=torch.int32,
                 packed: Optional[Dict] = None):
        self.q = qtree
        self.use_pallas = use_pallas
        self.acc_dtype = acc_dtype
        self.packed = {} if packed is None else packed

    def input(self, imgs_u8):
        # exact: int8 pixel values with scale 1 (alpha folded into weights)
        z = _prep_input(imgs_u8, self.q["pad_value"])
        return z, torch.ones((), device=z.device)

    # -- unfused pieces ------------------------------------------------------
    def _conv_fp_out(self, rep, entry, stride, pad):
        z, s_in = rep
        acc = _conv_int8(z, entry["w"], stride, pad, self.acc_dtype)
        return acc.float() * (s_in * entry["w_scale"]) + entry["b"]

    def _quant(self, name, x):
        s = self.q["act_scales"][name]
        q = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
        return q, s

    # -- fused kernels -------------------------------------------------------
    def _folded(self, rep, entry, qname):
        """Output-scale-folded per-channel scale and bias for the epilogue."""
        _, s_in = rep
        s_out = self.q["act_scales"][qname]
        return (s_in * entry["w_scale"]) / s_out, entry["b"] / s_out, s_out

    def _kernel_eligible(self, entry, stride, hw_elems: int):
        kh, kw = entry["w"].shape[:2]
        if not self.use_pallas:
            return None
        if self.use_pallas == "large" and hw_elems < 2048:
            return None
        if (kh, kw) == (1, 1):
            return "matmul"
        if (kh, kw) == (3, 3) and stride == 1:
            return "conv3x3"
        return None

    def _packed(self, w, kind):
        """The kernels' K-major copy of ``w``, packed at its first use."""
        from ..ops.int8_conv import pack_weight

        hit = self.packed.get(id(w))
        if hit is None or hit[0] is not w:
            hit = (w, pack_weight(w if kind == "conv3x3"
                                  else w.reshape(w.shape[2], w.shape[3])))
            self.packed[id(w)] = hit
        return hit[1]

    def _fused(self, kind, z, entry, scale, bias, relu, res=None,
               res_scale=None):
        from ..ops.int8_conv import conv3x3_requant, matmul_requant

        # the kernels read dense NHWC rows; a conv or pool output may be a
        # strided view
        z = z.contiguous()
        res = None if res is None else res.contiguous()
        w_packed = self._packed(entry["w"], kind)
        if kind == "conv3x3":
            return conv3x3_requant(z, entry["w"], scale, bias, res_nhwc=res,
                                   res_scale=res_scale, relu=relu,
                                   w_packed=w_packed)
        b, h, w, c = z.shape
        n = entry["w"].shape[3]
        y = matmul_requant(
            z.reshape(b * h * w, c), entry["w"].reshape(c, n), scale, bias,
            res=None if res is None else res.reshape(b * h * w, n),
            res_scale=res_scale, relu=relu, w_packed=w_packed)
        return y.reshape(b, h, w, n)

    def conv_act(self, rep, entry, stride, pad, qname, relu=True):
        z = rep[0]
        kind = self._kernel_eligible(entry, stride, z.shape[1] * z.shape[2])
        if kind is None:
            y = self._conv_fp_out(rep, entry, stride, pad)
            if relu:
                y = torch.relu(y)
            return self._quant(qname, y)
        scale, bias, s_out = self._folded(rep, entry, qname)
        if kind == "matmul" and stride > 1:
            z = z[:, ::stride, ::stride, :]
        return self._fused(kind, z, entry, scale, bias, relu), s_out

    def conv_add_act(self, rep, entry, stride, pad, res_rep, qname):
        z = rep[0]
        kind = self._kernel_eligible(entry, stride, z.shape[1] * z.shape[2])
        res_z, res_s = res_rep
        if kind is None:
            y = self._conv_fp_out(rep, entry, stride, pad)
            y = torch.relu(y + res_z.float() * res_s)
            return self._quant(qname, y)
        scale, bias, s_out = self._folded(rep, entry, qname)
        y = self._fused(kind, z, entry, scale, bias, True, res=res_z,
                        res_scale=res_s / s_out)
        return y, s_out

    def conv_in_act(self, rep, entry, qname):
        """IBN bn1 in the int8 dataflow: requantize the conv output, then run
        the per-sample InstanceNorm in the int8 domain."""
        half = entry["in_scale"].shape[0]
        z, s = self._quant(qname + ".pre", self._conv_fp_out(rep, entry, 1, 0))
        s_out = self.q["act_scales"][qname]
        yin = _instance_norm_int8_domain(z[..., :half], s, entry["in_scale"],
                                         entry["in_bias"])
        q_in = torch.clamp(torch.round(torch.relu(yin) / s_out), -127, 127)
        xbn = z[..., half:].float() * s
        q_bn = torch.clamp(torch.round(torch.relu(xbn) / s_out), -127, 127)
        return torch.cat([q_in, q_bn], dim=-1).to(torch.int8), s_out

    def dequant(self, rep):
        z, s = rep
        return z.float() * s

    def maxpool(self, rep):
        z, s = rep
        return _maxpool(z, -128), s


def _backbone_forward(eng, f, imgs_u8):
    """The folded ResNet trunk, engine-agnostic. Returns fp32 [B, h, w, C]."""
    rep = eng.input(imgs_u8)
    # stem: input pre-padded by 3, VALID conv; no fused kernel (7x7, Cin=3)
    rep = eng.conv_act(rep, f["stem"], stride=2, pad=0, qname="stem",
                       relu=bool(f["stem_relu"]))
    rep = eng.maxpool(rep)

    for entry, (bname, kind, _, stride, has_ds, use_ibn) in zip(f["blocks"],
                                                              f["plan"]):
        if kind == "bottleneck":
            if use_ibn:
                r1 = eng.conv_in_act(rep, entry["conv1"], f"{bname}.a1")
            else:
                r1 = eng.conv_act(rep, entry["conv1"], 1, 0, f"{bname}.a1")
            r2 = eng.conv_act(r1, entry["conv2"], stride, 1, f"{bname}.a2")
            last, last_stride, last_pad = entry["conv3"], 1, 0
            pre = r2
        else:  # basic
            r1 = eng.conv_act(rep, entry["conv1"], stride, 1, f"{bname}.a1")
            last, last_stride, last_pad = entry["conv2"], 1, 1
            pre = r1
        if has_ds:
            res = eng.conv_act(rep, entry["ds"], stride, 0, f"{bname}.ds",
                               relu=False)
        else:
            res = rep
        rep = eng.conv_add_act(pre, last, last_stride, last_pad, res,
                               f"{bname}.out")
    return eng.dequant(rep)


def _embed_tail(bnneck, trunk_fp32):
    feat = trunk_fp32.mean(dim=(1, 2))
    g = bnneck["scale"] * torch.rsqrt(bnneck["var"] + _EPS)
    return (feat - bnneck["mean"]) * g + bnneck["bias"]


# ---------------------------------------------------------------------------
# Calibration + weight quantization
# ---------------------------------------------------------------------------


def _quantize_weights(entry) -> Dict[str, torch.Tensor]:
    w = entry["w"]
    s = torch.clamp(w.abs().amax(dim=(0, 1, 2)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(w / s), -127, 127)
    out = {"w": q.to(torch.int8).contiguous(), "w_scale": s, "b": entry["b"]}
    for key in ("in_scale", "in_bias"):  # IBN affine rides along
        if key in entry:
            out[key] = entry[key]
    return out


def _as_device_u8(imgs, device) -> torch.Tensor:
    x = imgs if torch.is_tensor(imgs) else torch.from_numpy(
        np.ascontiguousarray(imgs))
    return x.to(device)


@torch.inference_mode()
def calibrate(fold, calib_batches, percentile: float = 100.0
              ) -> Dict[str, float]:
    """Run the folded fp32 graph over calibration uint8 batches; returns
    per-quantization-point activation scales (range / 127). ``percentile``
    < 100 clips activation outliers (per batch) instead of taking the
    absolute max."""
    device = fold["stem"]["w"].device
    maxes: Dict[str, float] = {}
    n = 0
    for imgs in calib_batches:
        eng = _FpEngine(fold, percentile)
        _backbone_forward(eng, fold, _as_device_u8(imgs, device))
        # one device-to-host copy for the whole batch
        vals = torch.stack(list(eng.maxes.values())).tolist()
        for k, v in zip(eng.maxes, vals):
            maxes[k] = max(maxes.get(k, 0.0), float(v))
        n += 1
    if n == 0:
        raise ValueError("calibration requires at least one batch")
    return {k: max(v, 1e-12) / 127.0 for k, v in maxes.items()}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


class QuantizedEmbed:
    """Callable int8 embed pipeline: uint8 [B, H, W, 3] -> fp32 [B, D].

    Build with :func:`quantize_reid_model` or :meth:`load`. The quantized
    parameters are a tree of tensors on one device (``.qtree``); act scales
    are 0-d fp32 tensors. ``use_pallas`` routes the eligible convs to K5 /
    K6 (``True``, or ``"large"`` for feature maps of >= 2048 pixels);
    ``acc_dtype`` is the accumulator of the other convs (``torch.int32``
    exact, ``torch.bfloat16`` rounded). The fused convs' K-major weights
    are packed at their first call and kept (``_packed``), beside the HWIO
    tree that ``save`` writes."""

    def __init__(self, qtree, plan, stem_relu, use_pallas=False,
                 acc_dtype=torch.bfloat16):
        self.qtree = qtree
        self._static = {"plan": [tuple(p) for p in plan],
                        "stem_relu": bool(stem_relu)}
        self._use_pallas = use_pallas
        self._acc_dtype = acc_dtype
        self._packed: Dict = {}
        self.extra_meta: Dict = {}

    @property
    def device(self) -> torch.device:
        return self.qtree["stem"]["w"].device

    def to(self, device) -> "QuantizedEmbed":
        """A copy of this embed with its parameters on ``device``."""
        out = QuantizedEmbed(
            _tree_map(lambda v: v.to(device) if torch.is_tensor(v) else v,
                      self.qtree),
            self._static["plan"], self._static["stem_relu"],
            use_pallas=self._use_pallas, acc_dtype=self._acc_dtype)
        out.extra_meta = self.extra_meta
        return out

    def apply(self, qtree, imgs_u8):
        """The forward on explicit parameters: ``imgs_u8`` a uint8 tensor on
        the parameters' device."""
        f = dict(qtree)
        f.update(self._static)
        eng = _Int8Engine(f, self._use_pallas, self._acc_dtype, self._packed)
        return _embed_tail(f["bnneck"], _backbone_forward(eng, f, imgs_u8))

    @torch.inference_mode()
    def __call__(self, imgs_u8):
        return self.apply(self.qtree, _as_device_u8(imgs_u8, self.device))

    def embed_many(self, imgs_u8_sb):
        """[S, B, H, W, 3] uint8 -> [S, B, D] fp32, one batch at a time."""
        return torch.stack([self(x) for x in imgs_u8_sb])

    @staticmethod
    def npz_path(path: str) -> str:
        """np.savez appends '.npz' to bare paths; normalise once so save,
        load and existence checks agree."""
        return path if path.endswith(".npz") else path + ".npz"

    def save(self, path: str, extra_meta: Optional[Dict] = None) -> None:
        """Write the quantized model (weights, scales, plan) to one ``.npz``
        in the JAX package's format (``q/<tree path>`` arrays, HWIO weights,
        a ``__meta__`` JSON string). ``extra_meta`` is stored verbatim and
        comes back as ``.extra_meta`` on load."""
        path = self.npz_path(path)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        flat: Dict[str, np.ndarray] = {}

        def walk(prefix, obj):
            if isinstance(obj, dict):
                for k, v in obj.items():
                    walk(f"{prefix}/{k}", v)
            elif isinstance(obj, (list, tuple)):
                for i, v in enumerate(obj):
                    walk(f"{prefix}/{i}", v)
            elif torch.is_tensor(obj):
                flat[prefix] = obj.detach().cpu().numpy()
            else:
                flat[prefix] = np.asarray(obj)

        walk("q", self.qtree)
        meta = json.dumps({
            "plan": self._static["plan"],
            "stem_relu": self._static["stem_relu"],
            "n_blocks": len(self.qtree["blocks"]),
            "acc_dtype": str(self._acc_dtype).removeprefix("torch."),
            "use_pallas": self._use_pallas,
            "extra": extra_meta or {},
        })
        np.savez(path, __meta__=np.asarray(meta), **flat)

    @staticmethod
    def load(path: str, device="cuda") -> "QuantizedEmbed":
        """Read a ``.npz`` written by either package's ``save``, onto
        ``device`` (the card unless the caller asks for the CPU), with the
        engine options the artifact names."""
        raw = np.load(QuantizedEmbed.npz_path(path), allow_pickle=False)
        meta = json.loads(str(raw["__meta__"]))
        tree: Dict[str, Any] = {}
        for key in raw.files:
            if key == "__meta__":
                continue
            parts = key.split("/")[1:]  # strip the "q" root
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = torch.from_numpy(np.array(raw[key])).to(device)
        qtree = {
            "stem": tree["stem"],
            "blocks": [tree["blocks"][str(i)] for i in range(meta["n_blocks"])],
            "bnneck": tree["bnneck"],
            "act_scales": tree["act_scales"],
            "pad_value": np.asarray(raw["q/pad_value"], np.int32),
        }
        out = QuantizedEmbed(
            qtree, meta["plan"], meta["stem_relu"],
            use_pallas=meta.get("use_pallas", False),
            acc_dtype=getattr(torch, meta.get("acc_dtype", "bfloat16")),
        )
        out.extra_meta = meta.get("extra", {})
        return out


def quantize_reid_model(model, calib_batches, pixel_mean: Sequence[float],
                        pixel_std: Sequence[float], use_pallas=False,
                        acc_dtype=torch.bfloat16,
                        calib_percentile: float = 100.0) -> QuantizedEmbed:
    """PTQ of a ``ReidModel`` for serving: fold, calibrate, quantize, on the
    model's device. ``calib_batches``: uint8 [B, H, W, 3] arrays or tensors
    of the target domain. ``calib_percentile`` < 100 clips outliers."""
    fold = fold_backbone(model, pixel_mean, pixel_std)
    act_scales = calibrate(fold, calib_batches, calib_percentile)
    device = fold["stem"]["w"].device
    qtree = {
        "stem": _quantize_weights(fold["stem"]),
        "blocks": [{k: _quantize_weights(v) for k, v in entry.items()}
                   for entry in fold["blocks"]],
        "bnneck": fold["bnneck"],
        "act_scales": {k: torch.tensor(v, dtype=torch.float32, device=device)
                       for k, v in act_scales.items()},
        "pad_value": fold["pad_value"],
    }
    return QuantizedEmbed(qtree, fold["plan"], fold["stem_relu"],
                          use_pallas=use_pallas, acc_dtype=acc_dtype)


def serving_identity(cfg, model) -> Dict:
    """The identity metadata stamped into (and checked against) a cached
    int8 artifact: everything whose change must invalidate the cache."""
    return {
        "model_name": model.backbone_name,
        "last_stride": model.last_stride,
        "input_size": list(cfg.INPUT.SIZE_TEST),
        "pretrain_path": str(cfg.MODEL.PRETRAIN_PATH),
        "calib_pct": float(cfg.TPU.INT8_CALIB_PCT),
        "pixel_mean": [float(v) for v in cfg.INPUT.PIXEL_MEAN],
        "pixel_std": [float(v) for v in cfg.INPUT.PIXEL_STD],
        "calib_batches": int(cfg.TPU.INT8_CALIB_BATCHES),
        # dataflow format 2: int8-domain InstanceNorm (".pre" act scales)
        "format": 2,
    }


def quantize_for_serving(cfg, model, records, store=None) -> QuantizedEmbed:
    """The cfg-driven serving flow of the ONLY_TEST int8 eval and the
    offline CLIs, on the model's device:

    * ``TPU.INT8_CACHE_PATH`` set and present: load the saved artifact
      after checking its identity metadata (``serving_identity``) against
      the current config; a mismatch recalibrates and overwrites it;
    * otherwise: calibrate on the leading ``TPU.INT8_CALIB_BATCHES`` full
      batches of ``records`` (a ``Record`` list), honouring
      ``TPU.INT8_CALIB_PCT``, and save to the cache path when one is set.

    As in the reference, a fresh calibration takes ``quantize_reid_model``'s
    engine defaults (unfused convs, bf16 accumulator) and a loaded artifact
    runs on the engine it names."""
    import logging

    from ..data.loader import EvalLoader

    log = logging.getLogger(__name__)
    device = next(model.parameters()).device
    identity = serving_identity(cfg, model)
    cache = cfg.TPU.INT8_CACHE_PATH
    cache = QuantizedEmbed.npz_path(cache) if cache else ""
    if cache and os.path.exists(cache):
        qfn = QuantizedEmbed.load(cache, device)
        if qfn.extra_meta == identity:
            log.info(f"int8 serving: loaded quantized model {cache}")
            return qfn
        log.warning(
            f"int8 serving: cached artifact {cache} was built for "
            f"{qfn.extra_meta}, current run is {identity}; recalibrating")

    n = max(1, cfg.TPU.INT8_CALIB_BATCHES) * cfg.TEST.IMS_PER_BATCH
    # full batches only, so every calibration batch has one shape; a
    # partial tail is detectable through the loader's valid mask
    calib = [b["images"][b["valid"]]
             for b in EvalLoader(records[:n], cfg, store=store)
             if bool(b["valid"].all())]
    if not calib:  # fewer records than one batch: pad by repetition
        b = next(iter(EvalLoader(records[:n], cfg, store=store)))
        imgs = b["images"][b["valid"]]
        reps = -(-cfg.TEST.IMS_PER_BATCH // max(len(imgs), 1))
        calib = [np.tile(imgs, (reps, 1, 1, 1))[:cfg.TEST.IMS_PER_BATCH]]
    qfn = quantize_reid_model(model, calib, cfg.INPUT.PIXEL_MEAN,
                              cfg.INPUT.PIXEL_STD,
                              calib_percentile=cfg.TPU.INT8_CALIB_PCT)
    log.info(f"int8 serving active (calibrated on {len(calib)} batches)")
    if cache:
        qfn.save(cache, extra_meta=identity)
        qfn.extra_meta = identity
        log.info(f"saved quantized model to {cache}")
    return qfn


def folded_fp_embed(model, pixel_mean, pixel_std):
    """The folded fp32 embed fn (no quantization), the calibration graph:
    uint8 [B, H, W, 3] -> fp32 [B, D] on the model's device."""
    fold = fold_backbone(model, pixel_mean, pixel_std)
    device = fold["stem"]["w"].device

    @torch.inference_mode()
    def run(imgs_u8):
        eng = _FpEngine(fold)
        trunk = _backbone_forward(eng, fold, _as_device_u8(imgs_u8, device))
        return _embed_tail(fold["bnneck"], trunk)

    return run
