"""Int8 quantized-inference op lowerings (ref: paddle_tpu/ops/quant_ops.py),
the op family passes/quantize.py emits over a calibrated inference
program:

  quantize_int8     f32 activation -> int8 at a calibrated per-tensor scale
                    (round half to even, symmetric [-127, 127])
  dequantize_int8   int8 -> f32 at a fixed scale
  mul_int8          int8 activation x int8 per-output-channel weight, the
                    dequant in the epilogue
  conv2d_int8       int8 NCHW conv over per-output-channel int8 filters,
  (+ depthwise)     the dequant in the epilogue

The reference splits by platform inside XLA: on the TPU an s8 x s8 -> s32
dot or convolution, elsewhere the same integer values computed in f32. The
port keeps that split by the tensor's device:

- On a CUDA tensor the int8 operands multiply with exact int32
  accumulation and the dequant runs on the int32 sums, as the TPU branch
  does. mul_int8 and conv2d_int8 reach cuBLASLt's int8 GEMM through
  `int8_gemm` (torch._int_mm); a convolution is an im2col built on the
  int8 tensor itself (F.pad and as_strided: F.unfold has no int8 CUDA
  kernel), one GEMM a group. _int_mm takes more than 16 rows, and inner
  and output sizes that are multiples of 8: int8_gemm zero-pads the rows
  to 17, the inner size on both operands (exact: the pads multiply to 0)
  and the output columns, and slices the pads off. depthwise_conv2d_int8
  sums int32 products in plain torch. None of these is a hand-written
  kernel: the reference computes them outside any Pallas kernel too. A
  shape _int_mm refuses raises; nothing falls back to an f32 convolution
  of the cast values on the card.
- On any other device (the CPU, and the 'meta' device of build-time shape
  inference) the reference's default branch: f32 on the integer values
  (`*_plain` below). Products past f32's 2^24 exact-integer range (K *
  127^2 > 2^24, K > 1040) round there and not on the card: a ~1e-7
  relative difference against a quantization step of ~1e-2.

`int8_gemm.launches` counts the integer GEMM dispatches (one per call,
i.e. one per quantized op and group), `int8_gemm.launches_by_op` by the
calling op type; only the CUDA path counts.

All ops are serving-only (no_grad): quantization-aware training is the
reference's contrib/quantize.py and is not part of this family.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.registry import register

# the symmetric signed-int8 grid: +-127 levels, -128 unused
QMAX = 127.0

# torch._int_mm's shape rules on CUDA
_MIN_ROWS = 17
_ALIGN = 8


def _divisor(scale, like):
    """`scale` as a divisor tensor on like's device. A Python scalar
    divisor of a CUDA tensor is applied as a multiply by its f32
    reciprocal (ATen's div_true_kernel), which is not the reference's
    x / scale; a 0-d device tensor divides."""
    if torch.is_tensor(scale):
        return scale.to(like.device)
    return torch.full((), scale, dtype=torch.float32, device=like.device)


def quantize_array(x, scale):
    """round(x / scale), half to even, clipped to the symmetric int8 grid;
    `scale` a scalar or any broadcastable per-channel tensor. Shared by the
    lowerings below and passes/quantize.quantize_weight's per-channel
    weight quantization: one rounding rule everywhere."""
    q = torch.clamp(torch.round(x / _divisor(scale, x)), -QMAX, QMAX)
    return q.to(torch.int8)


def _pad_dim(t, dim, size):
    """t zero-padded at the end of `dim` to `size`."""
    extra = size - t.shape[dim]
    if extra <= 0:
        return t
    pad = [0, 0] * (t.dim() - dim - 1) + [0, extra]
    return F.pad(t, pad)


def _round_up(n, m):
    return -(-n // m) * m


def padded_int_mm(a, bt):
    """a @ bt.T in exact int32 for int8 a [M, K] and bt [N, K] through
    torch._int_mm with both operands K-contiguous (the int8 GEMM's "TN"
    layout), the operands zero-padded to the card's shape rules (rows to
    17 when M <= 16, K and N to multiples of 8) and the pads sliced off.
    The padding is exact: pad rows and columns are zeros."""
    m, k = a.shape
    n = bt.shape[0]
    kp = _round_up(k, _ALIGN)
    a = _pad_dim(_pad_dim(a, 1, kp), 0, max(m, _MIN_ROWS)).contiguous()
    bt = _pad_dim(_pad_dim(bt, 1, kp), 0, _round_up(n, _ALIGN)).contiguous()
    return torch._int_mm(a, bt.t())[:m, :n]


def int8_gemm(a, bt, op_type=None):
    """padded_int_mm on the card (cuBLASLt's int8 GEMM), counting one
    launch. Raises for a tensor that is not on a CUDA device: the CPU
    takes the plain f32 version, in the caller."""
    if a.device.type != 'cuda':
        raise ValueError('int8_gemm runs on a CUDA tensor; the CPU takes the '
                         'plain f32 version')
    out = padded_int_mm(a, bt)
    int8_gemm.launches += 1
    if op_type is not None:
        int8_gemm.launches_by_op[op_type] = (
            int8_gemm.launches_by_op.get(op_type, 0) + 1)
    return out


int8_gemm.launches = 0
int8_gemm.launches_by_op = {}


def reset_launches():
    int8_gemm.launches = 0
    int8_gemm.launches_by_op = {}


def _on_card(t):
    return t.device.type == 'cuda'


@register('quantize_int8', no_grad=True)
def _quantize_int8(ctx, ins):
    """Per-tensor symmetric activation quant at the calibrated scale (attr
    'scale' > 0, fixed at pass time)."""
    return {'Out': [quantize_array(ins['X'][0], float(ctx.attr('scale')))]}


@register('dequantize_int8', no_grad=True)
def _dequantize_int8(ctx, ins):
    return {'Out': [ins['X'][0].float() * float(ctx.attr('scale'))]}


def _mul_2d(x, y, xn, yn):
    """mul's operands flattened to 2-D at their num_col_dims."""
    return (x.reshape(math.prod(x.shape[:xn]), -1),
            y.reshape(math.prod(y.shape[:yn]), -1))


def mul_int8_plain(x2, y2, dtype=torch.float32):
    """The reference's default branch of mul_int8's product: f32 on the
    integer values. In float64 (`dtype`) every sum of int8 products is
    exact, the card's int32 sums bit for bit."""
    return torch.matmul(x2.to(dtype), y2.to(dtype))


@register('mul_int8', no_grad=True)
def _mul_int8(ctx, ins):
    """Quantized `mul`: X int8 (activation), Y int8 (per-output-column
    quantized weight), Scale f32 [N]; out = (x_q . w_q) * (in_scale *
    w_scale), the product exact in int32 on the card."""
    x, y = ins['X'][0], ins['Y'][0]
    w_scale = ins['Scale'][0]
    xn = ctx.attr('x_num_col_dims', 1)
    yn = ctx.attr('y_num_col_dims', 1)
    x2, y2 = _mul_2d(x, y, xn, yn)
    if _on_card(x2):
        acc = int8_gemm(x2, y2.t(), 'mul_int8')
    else:
        acc = mul_int8_plain(x2, y2)
    # int32 * f32 converts each sum to f32 and multiplies, in one pass
    out = acc * (float(ctx.attr('in_scale')) * w_scale.reshape(1, -1))
    return {'Out': [out.reshape(tuple(x.shape[:xn]) + tuple(y.shape[yn:]))]}


def _pair(v):
    return [int(a) for a in v] if isinstance(v, (list, tuple)) \
        else [int(v), int(v)]


def _conv_attrs(ctx):
    return (_pair(ctx.attr('strides', [1, 1])),
            _pair(ctx.attr('paddings', [0, 0])),
            _pair(ctx.attr('dilations', [1, 1])),
            int(ctx.attr('groups', 1) or 1))


def conv2d_int8_plain(x, w, strides, pads, dils, groups,
                      dtype=torch.float32):
    """The reference's default branch of the int8 convolution's sums: an
    f32 convolution of the integer values. In float64 (`dtype`) every sum
    is exact, the card's int32 sums bit for bit (cuDNN's f32 algorithms,
    Winograd and FFT among them, need not be exact on integers)."""
    return F.conv2d(x.to(dtype), w.to(dtype), stride=strides, padding=pads,
                    dilation=dils, groups=groups)


def _windows(x, kh, kw, strides, pads, dils):
    """The int8 input's convolution windows as a strided view [N, OH, OW,
    C, KH, KW] of the zero-padded input (no copy yet)."""
    xp = (F.pad(x, [pads[1], pads[1], pads[0], pads[0]]) if any(pads)
          else x).contiguous()
    n, c, hp, wp = xp.shape
    oh = (hp - dils[0] * (kh - 1) - 1) // strides[0] + 1
    ow = (wp - dils[1] * (kw - 1) - 1) // strides[1] + 1
    sn, sc, sh, sw = xp.stride()
    return xp.as_strided((n, oh, ow, c, kh, kw),
                         (sn, sh * strides[0], sw * strides[1], sc,
                          sh * dils[0], sw * dils[1]))


def conv2d_int8_card(x, w, strides, pads, dils, groups, op_type='conv2d_int8'):
    """The int32 sums of the int8 convolution on the card: an im2col of
    the int8 input, one int8_gemm a group. x int8 [N, C, H, W], w int8
    [O, C / groups, KH, KW] -> int32 [N, OH, OW, O] (channels last, the
    GEMM's own layout)."""
    o, cg, kh, kw = w.shape
    win = _windows(x, kh, kw, strides, pads, dils)
    n, oh, ow = win.shape[:3]
    og = o // groups
    outs = []
    for g in range(groups):
        cols = win[:, :, :, g * cg:(g + 1) * cg].reshape(n * oh * ow, -1)
        wg = w[g * og:(g + 1) * og].reshape(og, -1)
        outs.append(int8_gemm(cols, wg, op_type))
    acc = outs[0] if groups == 1 else torch.cat(outs, dim=1)
    return acc.reshape(n, oh, ow, o)


def depthwise_conv2d_int8_card(x, w, strides, pads, dils):
    """A depthwise int8 convolution's int32 sums on the card in plain torch
    (one filter a channel: no GEMM): the products of each window, summed
    in int32. x int8 [N, C, H, W], w int8 [C * m, 1, KH, KW] -> int32
    [N, OH, OW, C * m]."""
    o, _, kh, kw = w.shape
    c = x.shape[1]
    mult = o // c
    win = _windows(x, kh, kw, strides, pads, dils)      # [N,OH,OW,C,KH,KW]
    n, oh, ow = win.shape[:3]
    wi = w.reshape(c, mult, kh * kw).to(torch.int32)
    cols = win.reshape(n, oh, ow, c, 1, kh * kw).to(torch.int32)
    acc = (cols * wi).sum(dim=-1, dtype=torch.int32)    # [N,OH,OW,C,m]
    return acc.reshape(n, oh, ow, o)


def _conv2d_int8_impl(ctx, ins, op_type):
    x, w = ins['Input'][0], ins['Filter'][0]
    strides, pads, dils, groups = _conv_attrs(ctx)
    # the dequant factor, in_scale * w_scale rounded in f32 as the
    # reference's epilogue rounds it
    factor = float(ctx.attr('in_scale')) * ins['Scale'][0]
    if not _on_card(x):
        acc = conv2d_int8_plain(x, w, strides, pads, dils, groups)
        return {'Output': [acc * factor.reshape(1, -1, 1, 1)]}
    if groups > 1 and groups == x.shape[1] and w.shape[1] == 1:
        acc = depthwise_conv2d_int8_card(x, w, strides, pads, dils)
    else:
        acc = conv2d_int8_card(x, w, strides, pads, dils, groups, op_type)
    # int32 * f32 converts each sum to f32 and multiplies; written into an
    # NCHW output, the same pass transposes the channels-last sums
    n, oh, ow, o = acc.shape
    out = torch.empty((n, o, oh, ow), dtype=torch.float32, device=x.device)
    torch.mul(acc.permute(0, 3, 1, 2), factor.reshape(1, -1, 1, 1), out=out)
    return {'Output': [out]}


@register('conv2d_int8', no_grad=True)
def _conv2d_int8(ctx, ins):
    """Quantized conv2d: Input int8 NCHW, Filter int8 OIHW quantized per
    output channel, Scale f32 [O]; the dequant in the epilogue as with
    mul_int8."""
    return _conv2d_int8_impl(ctx, ins, 'conv2d_int8')


@register('depthwise_conv2d_int8', no_grad=True)
def _depthwise_conv2d_int8(ctx, ins):
    return _conv2d_int8_impl(ctx, ins, 'depthwise_conv2d_int8')
