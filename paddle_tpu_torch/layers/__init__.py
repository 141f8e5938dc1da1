"""fluid.layers namespace (ref: python/paddle/fluid/layers/__init__.py),
holding the layers the serving slice needs."""
from .io import data  # noqa: F401
from .nn import *  # noqa: F401,F403
