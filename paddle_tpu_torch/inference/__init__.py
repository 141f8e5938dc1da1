"""Serving API (ref: paddle/fluid/inference; paddle_tpu/inference)."""
from .predictor import Config, Predictor, create_predictor  # noqa: F401
from .batching import (BatchingPredictor, DeadlineExceeded,  # noqa: F401
                       ServerOverloaded, ServingStats, load_batching)
from .decoding import (DecodeStats, DecodingPredictor,  # noqa: F401
                       DraftModelDrafter, MidStreamEvicted, NgramDrafter,
                       TokenStream, load_decoding)
from .kv_blocks import (BlockManager, BlockPoolExhausted,  # noqa: F401
                        TRASH_BLOCK)
from .fleet import (Autoscaler, FleetRouter, FleetStats,  # noqa: F401
                    FleetUnavailable, ReplicaFailed, RolloutRolledBack,
                    RollingRollout, load_fleet)
from .export import (export_compiled, export_decode,  # noqa: F401
                     export_train_step)
from .ref_format import (load_reference_inference_model,  # noqa: F401
                         load_reference_persistables,
                         save_reference_inference_model)
from .serve import (CompiledPredictor, CompiledTrainer,  # noqa: F401
                    load_compiled, load_trainer)
