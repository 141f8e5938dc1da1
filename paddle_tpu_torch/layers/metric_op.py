"""Metric layers (ref: python/paddle/fluid/layers/metric_op.py;
paddle_tpu/layers/metric_op.py:10)."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from .nn import topk


def accuracy(input, label, k=1, correct=None, total=None):
    """Top-k accuracy of `input` ([N, D] scores) against `label` ([N, 1]):
    a top_k op, then an accuracy op; the result, f32 [1], stops
    gradients."""
    helper = LayerHelper("accuracy")
    values, indices = topk(input, k=k)
    acc_out = helper.create_variable_for_type_inference(dtype="float32")
    if correct is None:
        correct = helper.create_variable_for_type_inference(dtype="int32")
    if total is None:
        total = helper.create_variable_for_type_inference(dtype="int32")
    helper.append_op(
        type="accuracy",
        inputs={"Out": values, "Indices": indices, "Label": label},
        outputs={"Accuracy": acc_out, "Correct": correct, "Total": total},
        attrs={})
    acc_out.stop_gradient = True
    return acc_out
