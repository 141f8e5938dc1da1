"""Metric op lowerings (ref: operators/metrics/accuracy_op.cc;
paddle_tpu/ops/metric_ops.py:9)."""
from __future__ import annotations

import torch

from ..core.registry import register


@register('accuracy', no_grad=True)
def _accuracy(ctx, ins):
    """Top-k accuracy from top_k's Indices [N, k] and Label [N, 1]: a row
    is correct when any of its k indices is its label. Accuracy is f32
    [1]; Correct and Total are int32 [1]."""
    indices = ins['Indices'][0]
    label = ins['Label'][0]
    lab = label.reshape(-1, 1).to(indices.dtype)
    correct = (indices == lab).any(dim=1)
    num_correct = correct.to(torch.int32).sum(dtype=torch.int32)
    n = indices.shape[0]
    total = torch.full((1,), n, dtype=torch.int32, device=indices.device)
    acc = num_correct.float() / n
    return {'Accuracy': [acc.reshape(1)], 'Correct': [num_correct.reshape(1)],
            'Total': [total]}
