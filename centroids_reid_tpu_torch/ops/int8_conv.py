"""Fused int8 conv + requantization on hand-written CUDA kernels (Hopper).

Counterpart of ``centroids_reid_tpu/ops/int8_conv.py``, the fused convs of
the int8 PTQ embed (``models/quantized.py``):

* K5 ``matmul_requant`` / ``matmul_requant_plain``: int8 [M, K] x [K, N],
  the 1x1 convs (a stride-2 1x1 conv after a row slice);
* K6 ``conv3x3_requant`` / ``conv3x3_requant_plain``: the stride-1, pad-1
  3x3 conv over NHWC int8 with HWIO weights.

Both accumulate exactly in int32 and apply the serving epilogue (the
reference's ``_epilogue``): ``t = acc * scale[c] + bias[c]``, plus
``res * res_scale`` when there is a residual, then ReLU as
``min(max(t, 0), 127) + 0.5`` or else ``clip(t, +-127) +- 0.5`` by sign,
then truncation toward zero to int8. ``scale`` and ``bias`` are fp32 [N],
``res_scale`` an fp32 scalar tensor, all with the output scale folded in.

A wrapper takes its plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. Each launch adds one to
``LAUNCHES[name]``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .retrieval import _check, _on_cpu, _stream

# the kernels' tile: 64 input channels per stage, 64 output channels per
# block; every K and N of the ResNet trunks is a multiple of 64
_K_TILE = 64
_N_TILE = 64

LAUNCHES: Dict[str, int] = {"matmul_requant": 0, "conv3x3_requant": 0}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _epilogue_plain(acc, scale, bias, relu: bool, res=None, res_scale=None):
    """The requant epilogue on an exact accumulator ``acc`` (any float
    dtype holding the int32 values) -> int8."""
    t = acc.float() * scale + bias
    if res is not None:
        t = t + res.float() * res_scale
    if relu:
        t = torch.clamp(torch.clamp(t, min=0.0), max=127.0) + 0.5
    else:
        t = torch.clamp(t, -127.0, 127.0)
        t = t + torch.where(t >= 0, 0.5, -0.5)
    return t.trunc().to(torch.int8)


def _res_scale(res_scale, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(res_scale, dtype=torch.float32, device=like.device)


# --------------------------------------------------------------- K5 ------

def matmul_requant_plain(x, w, scale, bias, res=None, res_scale=None,
                         relu: bool = True):
    """int8 [M, K] x [K, N] -> int8 [M, N]; the accumulator is exact in
    fp64 (|acc| <= K 128 127 < 2^53)."""
    acc = x.double() @ w.double()
    if res is not None:
        res_scale = _res_scale(res_scale, x)
    return _epilogue_plain(acc, scale, bias, relu, res, res_scale)


def matmul_requant(x, w, scale, bias, res=None, res_scale=None,
                   relu: bool = True):
    """K5: int8 [M, K] x [K, N] -> int8 [M, N] with the fused epilogue;
    ``res`` an optional int8 [M, N] residual with scalar ``res_scale``.
    Kernel shapes: K % 64 == 0, N % 64 == 0."""
    tensors = [x, w, scale, bias] + ([] if res is None else [res])
    if _on_cpu(*tensors):
        return matmul_requant_plain(x, w, scale, bias, res, res_scale, relu)
    from . import _build

    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} x {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    rs = _check_requant_inputs(x, w, scale, bias, res, res_scale, (m, n))
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    rc = _build.load().crt_matmul_requant(
        x.data_ptr(), w.data_ptr(), scale.data_ptr(), bias.data_ptr(),
        None if res is None else res.data_ptr(),
        None if rs is None else rs.data_ptr(), int(relu), out.data_ptr(),
        m, k, n, _stream(),
    )
    _check(rc, "matmul_requant")
    LAUNCHES["matmul_requant"] += 1
    return out


# --------------------------------------------------------------- K6 ------

def conv3x3_requant_plain(x_nhwc, w_hwio, scale, bias, res_nhwc=None,
                          res_scale=None, relu: bool = True):
    """Stride-1, pad-1 3x3 int8 conv: [B, H, W, K] x HWIO [3, 3, K, N] ->
    int8 [B, H, W, N]; the accumulator is exact in fp64."""
    acc = F.conv2d(x_nhwc.permute(0, 3, 1, 2).contiguous().double(),
                   w_hwio.permute(3, 2, 0, 1).contiguous().double(),
                   padding=1).permute(0, 2, 3, 1)
    if res_nhwc is not None:
        res_scale = _res_scale(res_scale, x_nhwc)
    return _epilogue_plain(acc, scale, bias, relu, res_nhwc, res_scale)


def conv3x3_requant(x_nhwc, w_hwio, scale, bias, res_nhwc=None,
                    res_scale=None, relu: bool = True):
    """K6: stride-1, pad-1 3x3 int8 conv [B, H, W, K] -> [B, H, W, N] with
    the fused epilogue; weights HWIO [3, 3, K, N]. Kernel shapes:
    K % 64 == 0, N % 64 == 0."""
    tensors = [x_nhwc, w_hwio, scale, bias]
    if res_nhwc is not None:
        tensors.append(res_nhwc)
    if _on_cpu(*tensors):
        return conv3x3_requant_plain(x_nhwc, w_hwio, scale, bias, res_nhwc,
                                     res_scale, relu)
    from . import _build

    if x_nhwc.dim() != 4 or tuple(w_hwio.shape[:2]) != (3, 3) \
            or w_hwio.dim() != 4 or x_nhwc.shape[3] != w_hwio.shape[2]:
        raise ValueError(f"shapes {tuple(x_nhwc.shape)} x "
                         f"{tuple(w_hwio.shape)} (NHWC x HWIO 3x3)")
    b, h, wd, k = x_nhwc.shape
    n = w_hwio.shape[3]
    rs = _check_requant_inputs(x_nhwc, w_hwio, scale, bias, res_nhwc,
                               res_scale, (b, h, wd, n))
    out = torch.empty((b, h, wd, n), dtype=torch.int8, device=x_nhwc.device)
    rc = _build.load().crt_conv3x3_requant(
        x_nhwc.data_ptr(), w_hwio.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), None if res_nhwc is None else res_nhwc.data_ptr(),
        None if rs is None else rs.data_ptr(), int(relu), out.data_ptr(),
        b, h, wd, k, n, _stream(),
    )
    _check(rc, "conv3x3_requant")
    LAUNCHES["conv3x3_requant"] += 1
    return out


def _check_requant_inputs(x, w, scale, bias, res, res_scale,
                          out_shape) -> Optional[torch.Tensor]:
    """Refuse what the kernels do not take; returns ``res_scale`` as a
    one-element fp32 tensor on the device (None without a residual)."""
    k, n = w.shape[-2:]
    if x.dtype != torch.int8 or w.dtype != torch.int8:
        raise TypeError(f"int8 x and w required, got {x.dtype}, {w.dtype}")
    if scale.dtype != torch.float32 or bias.dtype != torch.float32:
        raise TypeError(f"fp32 scale and bias required, got {scale.dtype}, "
                        f"{bias.dtype}")
    if tuple(scale.shape) != (n,) or tuple(bias.shape) != (n,):
        raise ValueError(f"scale {tuple(scale.shape)} and bias "
                         f"{tuple(bias.shape)} must be ({n},)")
    if k % _K_TILE or n % _N_TILE:
        raise ValueError(
            f"kernel tiles need K % {_K_TILE} == 0 and N % {_N_TILE} == 0; "
            f"got K={k}, N={n}")
    tensors = [x, w, scale, bias]
    rs = None
    if res is not None:
        if res.dtype != torch.int8 or tuple(res.shape) != tuple(out_shape):
            raise ValueError(f"res must be int8 {tuple(out_shape)}, got "
                             f"{res.dtype} {tuple(res.shape)}")
        if res_scale is None:
            raise ValueError("res needs res_scale")
        rs = _res_scale(res_scale, x).reshape(1)
        tensors.append(res)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("x, w, scale, bias and res must be contiguous")
    # 16-byte loads of x, w, scale and bias; 4-byte loads of res
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(
            "x, w, scale, bias and res must start on a 16-byte boundary")
    return rs
