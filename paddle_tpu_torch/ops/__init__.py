"""Op lowerings. Importing this package registers every lowering."""
from . import (tensor_ops, math_ops, nn_ops, metric_ops,  # noqa: F401
               optimizer_ops, control_ops, decode_ops)
