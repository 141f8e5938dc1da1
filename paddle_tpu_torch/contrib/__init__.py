"""Contrib namespace (ref: python/paddle/fluid/contrib/;
paddle_tpu/contrib/__init__.py).

Ported submodules:
  - mixed_precision: the bf16 AMP decorator (see core/amp.py).
"""
from . import mixed_precision  # noqa: F401

__all__ = ['mixed_precision']
