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

The kernels read the weights K-major, since 8-bit ``wgmma`` reads both
operands K-major only: ``pack_weight`` turns a K5 weight [K, N] into [N, K]
and a K6 weight HWIO [3, 3, K, N] into [9, N, K] (``unpack_weight`` is its
inverse). A caller that runs a weight more than once packs it once and
passes it as ``w_packed`` (``models/quantized.py::_Int8Engine`` keeps one
per fused conv); without it the wrapper packs on every call. The artifact
on disk stays HWIO.

Split-K, for the deep layers at small batch (``_requant_plan``): where
the output tiles are few, the kernel splits the stages of each tile 2 ways
(it takes up to 8), and the splits run as one thread-block cluster. Each
keeps its int32 partial tile in its own shared memory, then adds one
column slice of the tile over the cluster's shared memory (integer sums:
exact in any order) and runs the epilogue on it. One launch and no
workspace: nothing outlives a launch, so launches on any stream are
independent.

Each wrapper runs through a PyTorch operator, ``torch.ops.crt.
matmul_requant`` and ``torch.ops.crt.conv3x3_requant``, defined on
``_build.LIB`` with a fake implementation that gives the int8 output's
shape. They are operators only so that ``torch.export`` records a launch
as one node of the program (``inference/export.py``) where it cannot
follow a ``ctypes`` call on ``data_ptr()``; their schemas are those that
artifacts on disk name. The operator takes its plain version only for
tensors on the CPU; for CUDA tensors it launches its kernel
(``_build.launch``) or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ._build import LIB, check_aligned, launch, on_cpu, sm_count

# the kernels' tile: 128 output rows, 128 input channels per stage (a
# 64-channel K reads as one half-empty stage), 128 output channels (64
# where N % 128 != 0); every K and N of the ResNet trunks is a multiple of
# 64
_M_TILE = 128
_K_STAGE = 128
_K_TILE = 64
_N_TILE = 64

# K splits of a tile run as one cluster. Measured on an H100 at the embed's
# shapes: 4- and 8-block clusters ran slower than 2-block ones where the
# stages are 128 deep, a split of fewer than 8 stages lost more in the
# exchange of partial tiles than it saved, and clustered blocks beyond one
# per SM ran as a second wave
_MAX_SPLITS = 2
_STAGES_PER_SPLIT = 8
_SLICE_MIN = 16   # columns of a split's epilogue slice (a 16-byte TMA box)


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


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """The kernels' K-major copy of a weight: K5 [K, N] -> [N, K]; K6 HWIO
    [3, 3, K, N] -> [9, N, K] (tap-major, each tap transposed)."""
    if w.dim() == 2:
        return w.t().contiguous()
    if w.dim() == 4 and tuple(w.shape[:2]) == (3, 3):
        return w.reshape(9, w.shape[2], w.shape[3]).transpose(1, 2).contiguous()
    raise ValueError(f"no K-major packing for a weight of shape "
                     f"{tuple(w.shape)}: [K, N] or HWIO [3, 3, K, N]")


def unpack_weight(w_packed: torch.Tensor) -> torch.Tensor:
    """The inverse of ``pack_weight``: [N, K] -> [K, N]; [9, N, K] -> HWIO
    [3, 3, K, N]."""
    if w_packed.dim() == 2:
        return w_packed.t().contiguous()
    _, n, k = w_packed.shape
    return w_packed.transpose(1, 2).reshape(3, 3, k, n).contiguous()


def _stages(k: int, taps: int) -> int:
    """The pipeline stages of a launch: taps x the 128-deep stages of K
    (K = 64: one 64-deep stage per tap)."""
    return taps * -(-k // _K_STAGE)


def _max_splits(bn: int, stages: int) -> int:
    """The most K splits the kernel takes: a power of two up to 8 (the
    portable cluster size), with at least one 128-deep stage and 16
    epilogue columns each."""
    cap = min(8, bn // _SLICE_MIN, stages)
    return 1 << (cap.bit_length() - 1)


def _requant_plan(m: int, n: int, stages: int, sms: int) -> Tuple[int, int]:
    """(tile width, K splits) of one launch: 128-channel tiles where N
    allows, else 64. The splits double while the tiles x splits blocks fit
    one per SM, each split keeps ``_STAGES_PER_SPLIT`` of the ``stages``,
    and the cluster stays within
    ``_MAX_SPLITS``: so no split where the tiles alone fill half of the
    ``sms`` SMs or more, and at M = 1024 (8 row tiles) the deep layers
    split 2 ways. ``stages``: ``_stages(K, taps)``."""
    bn = 128 if n % 128 == 0 else 64
    tiles = -(-m // _M_TILE) * (n // bn)
    splits = 1
    while (2 * splits <= min(_MAX_SPLITS, _max_splits(bn, stages))
           and 2 * splits * tiles <= sms
           and stages // (2 * splits) >= _STAGES_PER_SPLIT):
        splits *= 2
    return bn, splits


def _launch(name: str, x, w_packed, scale, bias, res, rs, relu, out,
            dims, m: int, k: int, n: int, taps: int) -> None:
    """Plan one K5 / K6 launch (tile width, K splits) and make it."""
    if m == 0:
        return
    bn, splits = _requant_plan(m, n, _stages(k, taps),
                               sm_count(x.get_device()))
    launch(name, x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
           bias.data_ptr(), None if res is None else res.data_ptr(),
           None if rs is None else rs.data_ptr(), int(relu), out.data_ptr(),
           *dims, k, n, bn, splits)


# --------------------------------------------------------------- K5 ------

def matmul_requant_plain(x, w, scale, bias, res=None, res_scale=None,
                         relu: bool = True, w_packed=None):
    """int8 [M, K] x [K, N] -> int8 [M, N]; the accumulator is exact in
    fp64 (|acc| <= K 128 127 < 2^53). With ``w_packed`` ([N, K]) the
    product reads it in place of ``w``."""
    if w_packed is not None:
        w = w_packed.t()
    acc = x.double() @ w.double()
    if res is not None:
        res_scale = _res_scale(res_scale, x)
    return _epilogue_plain(acc, scale, bias, relu, res, res_scale)


def _matmul_requant_impl(x: torch.Tensor, w: torch.Tensor,
                         scale: torch.Tensor, bias: torch.Tensor,
                         res: Optional[torch.Tensor],
                         res_scale: Optional[torch.Tensor], relu: bool,
                         w_packed: Optional[torch.Tensor]) -> torch.Tensor:
    """The body of the operator ``crt::matmul_requant``: the plain version
    for CPU tensors, else the kernel."""
    if on_cpu(x, w, scale, bias, res, w_packed):
        return matmul_requant_plain(x, w, scale, bias, res, res_scale, relu,
                                    w_packed)
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"shapes {tuple(x.shape)} x {tuple(w.shape)}")
    m, k = x.shape
    n = w.shape[1]
    rs = _check_requant_inputs(x, w, scale, bias, res, res_scale, (m, n))
    w_packed = _checked_packed(w, w_packed, (n, k))
    out = torch.empty((m, n), dtype=torch.int8, device=x.device)
    _launch("matmul_requant", x, w_packed, scale, bias, res, rs, relu, out,
            (m,), m, k, n, 1)
    return out


LIB.define("matmul_requant(Tensor x, Tensor w, Tensor scale, Tensor bias, "
           "Tensor? res, Tensor? res_scale, bool relu, Tensor? w_packed) "
           "-> Tensor")
LIB.impl("matmul_requant", _matmul_requant_impl, "CompositeExplicitAutograd")


@torch.library.register_fake("crt::matmul_requant", lib=LIB)
def _(x, w, scale, bias, res, res_scale, relu, w_packed):
    return x.new_empty((x.shape[0], w.shape[-1]), dtype=torch.int8)


def matmul_requant(x, w, scale, bias, res=None, res_scale=None,
                   relu: bool = True, w_packed=None):
    """K5: int8 [M, K] x [K, N] -> int8 [M, N] with the fused epilogue;
    ``res`` an optional int8 [M, N] residual with scalar ``res_scale``;
    ``w_packed`` an optional ``pack_weight(w)``. Kernel shapes: K % 64 ==
    0, N % 64 == 0. Runs the operator ``torch.ops.crt.matmul_requant``,
    which ``torch.export`` records as one node."""
    return torch.ops.crt.matmul_requant(
        x, w, scale, bias, res, _res_scale_arg(res, res_scale, x),
        bool(relu), w_packed)


# --------------------------------------------------------------- K6 ------

def conv3x3_requant_plain(x_nhwc, w_hwio, scale, bias, res_nhwc=None,
                          res_scale=None, relu: bool = True, w_packed=None):
    """Stride-1, pad-1 3x3 int8 conv: [B, H, W, K] x HWIO [3, 3, K, N] ->
    int8 [B, H, W, N]; the accumulator is exact in fp64. With ``w_packed``
    ([9, N, K]) the conv reads it in place of ``w_hwio``."""
    if w_packed is not None:
        w_hwio = unpack_weight(w_packed)
    acc = F.conv2d(x_nhwc.permute(0, 3, 1, 2).contiguous().double(),
                   w_hwio.permute(3, 2, 0, 1).contiguous().double(),
                   padding=1).permute(0, 2, 3, 1)
    if res_nhwc is not None:
        res_scale = _res_scale(res_scale, x_nhwc)
    return _epilogue_plain(acc, scale, bias, relu, res_nhwc, res_scale)


def _conv3x3_requant_impl(x_nhwc: torch.Tensor, w_hwio: torch.Tensor,
                          scale: torch.Tensor, bias: torch.Tensor,
                          res_nhwc: Optional[torch.Tensor],
                          res_scale: Optional[torch.Tensor], relu: bool,
                          w_packed: Optional[torch.Tensor]) -> torch.Tensor:
    """The body of the operator ``crt::conv3x3_requant``: the plain version
    for CPU tensors, else the kernel."""
    if on_cpu(x_nhwc, w_hwio, scale, bias, res_nhwc, w_packed):
        return conv3x3_requant_plain(x_nhwc, w_hwio, scale, bias, res_nhwc,
                                     res_scale, relu, w_packed)
    if x_nhwc.dim() != 4 or tuple(w_hwio.shape[:2]) != (3, 3) \
            or w_hwio.dim() != 4 or x_nhwc.shape[3] != w_hwio.shape[2]:
        raise ValueError(f"shapes {tuple(x_nhwc.shape)} x "
                         f"{tuple(w_hwio.shape)} (NHWC x HWIO 3x3)")
    b, h, wd, k = x_nhwc.shape
    n = w_hwio.shape[3]
    rs = _check_requant_inputs(x_nhwc, w_hwio, scale, bias, res_nhwc,
                               res_scale, (b, h, wd, n))
    w_packed = _checked_packed(w_hwio, w_packed, (9, n, k))
    out = torch.empty((b, h, wd, n), dtype=torch.int8, device=x_nhwc.device)
    _launch("conv3x3_requant", x_nhwc, w_packed, scale, bias, res_nhwc, rs,
            relu, out, (b, h, wd), b * h * wd, k, n, 9)
    return out


LIB.define("conv3x3_requant(Tensor x_nhwc, Tensor w_hwio, Tensor scale, "
           "Tensor bias, Tensor? res_nhwc, Tensor? res_scale, bool relu, "
           "Tensor? w_packed) -> Tensor")
LIB.impl("conv3x3_requant", _conv3x3_requant_impl,
         "CompositeExplicitAutograd")


@torch.library.register_fake("crt::conv3x3_requant", lib=LIB)
def _(x_nhwc, w_hwio, scale, bias, res_nhwc, res_scale, relu, w_packed):
    return x_nhwc.new_empty((*x_nhwc.shape[:3], w_hwio.shape[-1]),
                            dtype=torch.int8)


def conv3x3_requant(x_nhwc, w_hwio, scale, bias, res_nhwc=None,
                    res_scale=None, relu: bool = True, w_packed=None):
    """K6: stride-1, pad-1 3x3 int8 conv [B, H, W, K] -> [B, H, W, N] with
    the fused epilogue; weights HWIO [3, 3, K, N], ``w_packed`` an optional
    ``pack_weight(w_hwio)``. Kernel shapes: K % 64 == 0, N % 64 == 0. Runs
    the operator ``torch.ops.crt.conv3x3_requant``."""
    return torch.ops.crt.conv3x3_requant(
        x_nhwc, w_hwio, scale, bias, res_nhwc,
        _res_scale_arg(res_nhwc, res_scale, x_nhwc), bool(relu), w_packed)


def _res_scale_arg(res, res_scale, like) -> Optional[torch.Tensor]:
    """``res_scale`` as the operators take it: an fp32 tensor on the device
    of ``like`` (a Python or numpy scalar converted), or None without a
    residual."""
    if res is None or res_scale is None:
        return None
    return _res_scale(res_scale, like)


def _checked_packed(w, w_packed, shape) -> torch.Tensor:
    """``w_packed`` checked against the packed shape, or ``w`` packed here
    (a transpose on the device per call) when it is None."""
    if w_packed is None:
        return pack_weight(w)
    if w_packed.dtype != torch.int8 or tuple(w_packed.shape) != shape:
        raise ValueError(f"w_packed must be int8 {shape}, got "
                         f"{w_packed.dtype} {tuple(w_packed.shape)}")
    check_aligned("w_packed", w_packed)
    return w_packed


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
    # TMA loads of x and w need 16-byte aligned bases; 8-byte loads of
    # scale and bias, 2-byte loads of res
    check_aligned("x, w, scale, bias and res", *tensors)
    return rs
