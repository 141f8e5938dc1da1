"""Core runtime: op registry, Scope and the program interpreter."""
from .scope import Scope, global_scope, scope_guard  # noqa: F401
