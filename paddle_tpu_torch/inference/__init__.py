"""Serving API (ref: paddle/fluid/inference; paddle_tpu/inference)."""
from .predictor import Config, Predictor, create_predictor  # noqa: F401
from .batching import DeadlineExceeded, ServerOverloaded  # noqa: F401
from .decoding import (DecodeStats, DecodingPredictor,  # noqa: F401
                       TokenStream, load_decoding)
from .export import export_decode  # noqa: F401
