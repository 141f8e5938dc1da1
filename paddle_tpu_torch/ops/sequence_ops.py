"""Sequence op lowerings (ref: operators/im2sequence_op.cc; the port's copy
of paddle_tpu/ops/sequence_ops.py's `_im2sequence` :415 and its shape rule
:552). The other sequence ops of that file wait for their slice (ROADMAP.md
queue 1 item 8)."""
from __future__ import annotations

import numpy as np
import torch.nn.functional as F

from ..core import registry as _registry
from ..core.lod import LoDArray
from ..core.registry import register


@register('im2sequence')
def _im2sequence(ctx, ins):
    """X [N, C, H, W] -> Out, LoD rows [N*oh*ow, C*kh*kw]: each image's
    patches in row-major (oh, ow) order, one sequence an image; a patch's
    columns run channel slowest, then kh, then kw, as
    jax.lax.conv_general_dilated_patches orders them (and F.unfold)."""
    x = ins['X'][0]
    kh, kw = ctx.attr('kernels')
    strides = ctx.attr('strides', [1, 1])
    paddings = ctx.attr('paddings', [0, 0, 0, 0])
    ph0, pw0, ph1, pw1 = (list(paddings) * 2)[:4] if len(paddings) == 2 \
        else paddings
    n, c, h, w = x.shape
    if any((ph0, pw0, ph1, pw1)):
        x = F.pad(x, (pw0, pw1, ph0, ph1))
    oh = (h + ph0 + ph1 - kh) // strides[0] + 1
    ow = (w + pw0 + pw1 - kw) // strides[1] + 1
    patches = F.unfold(x, (kh, kw), stride=tuple(strides))  # [N, CKK, L]
    out = patches.transpose(1, 2).reshape(n * oh * ow, c * kh * kw)
    off = np.arange(n + 1, dtype=np.int64) * (oh * ow)
    return {'Out': [LoDArray(out, (off,))]}


def _im2seq_infer(op, block):
    x = block._find_var_recursive(op.inputs['X'][0])
    if x is None or x.shape is None:
        return
    kh, kw = op.attrs['kernels']
    for n in op.outputs.get('Out', []):
        v = block._find_var_recursive(n)
        if v is not None:
            v.shape = (-1, x.shape[1] * kh * kw)


_registry.get('im2sequence').infer_shape = _im2seq_infer
