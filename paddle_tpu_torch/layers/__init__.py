"""fluid.layers namespace (ref: python/paddle/fluid/layers/__init__.py),
holding the layers the ported slices need. Importing it installs the
Variable operators (math_op_patch), as the reference does."""
from . import math_op_patch
from .control_flow import *  # noqa: F401,F403
from .io import data  # noqa: F401
from .learning_rate_scheduler import *  # noqa: F401,F403
from .metric_op import accuracy  # noqa: F401
from .nn import *  # noqa: F401,F403
from .ops import *  # noqa: F401,F403
from .tensor import create_parameter, fill_constant, range  # noqa: F401

math_op_patch.monkey_patch_variable()
