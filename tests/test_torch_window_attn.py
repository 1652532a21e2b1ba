"""Swin's window attention on the real tokens' qkv (``ops/window_attn.py``)
on the CPU, at Swin-B's widths and its four 384x128 stage maps (96x32,
48x16, 24x8, 12x4; heads 4, 8, 16, 32 of width 32), batch 2, fp32:
``window_attention_plain`` against the op-by-op path it replaced (pad,
qkv on the padded map, gather, SDPA with the per-image mask, gather back),
the padded rows of that path's qkv against the bias, the refusals of K9's
wrapper, and the CPU path counting no fused tokens. The kernel itself runs
on the card (``tests/test_torch_gpu.py``)."""

import pytest
import torch
import torch.nn.functional as F

from centroids_reid_tpu_torch.models import swin as S
from centroids_reid_tpu_torch.ops import window_attn as WA
from centroids_reid_tpu_torch.utils import profiling

# (map, heads) of Swin-B's stages at 384x128; C = 32 x heads
STAGES = [((96, 32), 4), ((48, 16), 8), ((24, 8), 16), ((12, 4), 32)]
ATOL = 1e-6   # two fp32 orders of the same sums; values of order 0.1


def _msa(heads, seed=3):
    """A ``WindowMSA`` at head width 32 with seeded weights, nonzero qkv
    biases and an N(0, 1) bias table, as ``init_swin`` draws them."""
    m = S.WindowMSA(32 * heads, heads, 7)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in (m.qkv.weight, m.qkv.bias, m.proj.weight, m.proj.bias):
            p.normal_(0.0, 0.02, generator=g)
        m.relative_position_bias_table.normal_(0.0, 1.0, generator=g)
    return m.eval()


def _tokens(b, hw, c, seed=4):
    return torch.randn(b, hw[0] * hw[1], c,
                       generator=torch.Generator().manual_seed(seed))


def _op_by_op(msa, y, g):
    """The path ``window_attention`` replaced, before proj: the map
    zero-padded, qkv over the padded map, one gather by ``order``, SDPA
    with ``window_mask`` materialised per image, one gather back."""
    b, _, c = y.shape
    heads, n = msa.num_heads, 49
    padded = F.pad(y.view(b, g.h, g.w, c),
                   (0, 0, 0, g.wp - g.w, 0, g.hp - g.h))
    win = padded.view(b, g.hp * g.wp, c).index_select(1, g.order)
    mask = S.window_mask(msa.position_bias(), g.region, b, y.dtype)
    x = win.reshape(-1, n, c)
    qkv = msa.qkv(x).reshape(x.shape[0], n, 3, heads, c // heads).permute(
        2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2],
                                       attn_mask=mask)
    o = o.transpose(1, 2).reshape(b, -1, c)
    return o.index_select(1, g.inverse)


def _table(msa, g):
    return S.window_mask(msa.position_bias(), g.region, 1, torch.float32)


@pytest.mark.parametrize("shift", [0, 3])
@pytest.mark.parametrize("hw,heads", STAGES)
def test_plain_matches_the_op_by_op_path(hw, heads, shift):
    """On the real tokens' qkv, with the padding's q, k and v taken from
    the bias and the table broadcast over the images, the plain version
    gives the op-by-op path's output within fp32 rounding."""
    msa = _msa(heads)
    g = S.window_geometry(hw[0], hw[1], 7, shift, torch.device("cpu"))
    y = _tokens(2, hw, 32 * heads)
    with torch.no_grad():
        want = _op_by_op(msa, y, g)
        got = WA.window_attention(msa.qkv(y), msa.qkv.bias, _table(msa, g),
                                  g, heads)
    assert got.shape == want.shape == (2, hw[0] * hw[1], 32 * heads)
    torch.testing.assert_close(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hw,heads", STAGES)
def test_padded_rows_of_qkv_are_the_bias(hw, heads, dtype):
    """A zero-padded token's row of qkv is the qkv bias bit for bit (the
    matrix product of a zero row is 0), in fp32 and with the layer in
    bf16: what the kernel reads in its place."""
    msa = _msa(heads).to(dtype)
    g = S.window_geometry(hw[0], hw[1], 7, 3, torch.device("cpu"))
    y = _tokens(2, hw, 32 * heads).to(dtype)
    padded = F.pad(y.view(2, g.h, g.w, -1),
                   (0, 0, 0, g.wp - g.w, 0, g.hp - g.h))
    with torch.no_grad():
        qkv = msa.qkv(padded)
    pad = torch.ones(g.hp, g.wp, dtype=torch.bool)
    pad[:g.h, :g.w] = False
    rows = qkv[:, pad]
    assert rows.shape[1] == g.hp * g.wp - g.h * g.w > 0
    assert torch.equal(rows, msa.qkv.bias.detach().expand_as(rows))


def test_the_window_order_is_int32():
    """``window_geometry`` hands the kernel int32 token orders."""
    g = S.window_geometry(24, 8, 7, 3, torch.device("cpu"))
    assert g.order.dtype == g.inverse.dtype == torch.int32
    assert g.order.numel() == 28 * 14 and g.inverse.numel() == 24 * 8


def _operands(heads=16, hw=(24, 8), shift=3, dtype=torch.bfloat16):
    msa = _msa(heads)
    g = S.window_geometry(hw[0], hw[1], 7, shift, torch.device("cpu"))
    qkv = torch.zeros(2, hw[0] * hw[1], 96 * heads, dtype=dtype)
    bias = torch.zeros(96 * heads, dtype=dtype)
    with torch.no_grad():
        table = _table(msa, g)
    return qkv, bias, table, g, heads


def _refusal(case):
    qkv, bias, table, g, heads = _operands()
    if case == "head_width":
        heads = 8                                # width 64
        table = table[:, :8]
    elif case == "window":
        g = S.window_geometry(24, 8, 8, 4, torch.device("cpu"))
        table = torch.zeros(g.order.numel() // 64, heads, 64, 64)
    elif case == "image_size":                  # 224x224 tokens of 3 x 256
        g = S.window_geometry(224, 224, 7, 0, torch.device("cpu"))
        qkv = torch.empty(1, 224 * 224, 96 * 8, dtype=qkv.dtype,
                          device="meta")
        bias, heads = bias[:768], 8
        table = table[:1, :8]
    elif case == "fp32":
        qkv, bias = qkv.float(), bias.float()
    elif case == "bias_shape":
        bias = bias[:-8]
    elif case == "tokens":
        qkv = qkv[:, :-1]
    elif case == "table_type":
        table = table.to(torch.bfloat16)
    elif case == "table_lead":
        table = torch.zeros(3, heads, 49, 49)
    elif case == "table_layout":
        table = table.transpose(-1, -2)
    elif case == "order":
        g = g._replace(order=g.order.long())
    else:
        qkv = qkv.clone().requires_grad_()
    return qkv, bias, table, g, heads


@pytest.mark.parametrize("case,error,what", [
    ("head_width", ValueError, "heads of width 32"),
    ("window", ValueError, "7x7 windows"),
    ("image_size", ValueError, "at most 2"),
    ("fp32", TypeError, "bf16 qkv"),
    ("bias_shape", ValueError, "qkv_bias must be"),
    ("tokens", ValueError, "qkv must be"),
    ("table_type", ValueError, "table must be fp32"),
    ("table_lead", ValueError, "table must be fp32"),
    ("table_layout", ValueError, "unit column stride"),
    ("order", TypeError, "must be int32"),
    ("grad", RuntimeError, "no backward"),
])
def test_wrapper_refuses_what_the_kernel_is_not_built_for(case, error, what):
    """K9's checks, run before every launch, raise on another window, head
    width, type or layout, and on inputs that need a gradient; the sound
    operands pass them."""
    WA._check(*_operands())
    with pytest.raises(error, match=what):
        WA._check(*_refusal(case))


def test_no_kernel_for_other_devices():
    """A device other than the CPU or CUDA has no path."""
    qkv, bias, table, g, heads = _operands()
    with pytest.raises(ValueError, match="no CUDA kernel"):
        WA.window_attention(qkv.to("meta"), bias.to("meta"),
                            table.to("meta"), g._replace(
                                order=g.order.to("meta")), heads)


def test_the_cpu_path_fuses_nothing():
    """Under a profiler a block on the CPU counts its real and padded
    tokens and no ``swin.wmsa_fused``: only K9 counts those."""
    blk = S.ShiftWindowMSA(128, 4, 7, 3).eval()
    y = _tokens(2, (12, 4), 128)
    profiling.reset()
    with torch.no_grad(), torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        out = blk(y, (12, 4))
    counts = profiling.counts()
    profiling.reset()
    assert out.shape == y.shape
    assert counts["swin.tokens"] == 2 * 48
    assert counts["swin.window_tokens"] == 2 * 98
    assert "swin.wmsa_fused" not in counts
