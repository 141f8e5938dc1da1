"""Contrib namespace (ref: python/paddle/fluid/contrib/;
paddle_tpu/contrib/__init__.py).

Ported submodules:
  - mixed_precision: the bf16 AMP decorator (see core/amp.py);
  - gradient_merge: k-microbatch gradient accumulation (executor.py).
"""
from . import gradient_merge, mixed_precision  # noqa: F401

__all__ = ['gradient_merge', 'mixed_precision']
