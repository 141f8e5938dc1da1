"""Serving API (ref: paddle/fluid/inference; paddle_tpu/inference)."""
from .predictor import Config, Predictor, create_predictor  # noqa: F401
