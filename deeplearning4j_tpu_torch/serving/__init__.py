"""Model serving: the HTTP inference endpoint over ``output()``."""

from .server import InferenceServer

__all__ = ["InferenceServer"]
