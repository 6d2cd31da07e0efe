"""Architecture registry: one exact config per assigned architecture."""
from .base import (
    LONG_CONTEXT_ARCHS,
    SHAPES,
    ModelConfig,
    ShapeConfig,
    all_configs,
    cells,
    get_config,
)

__all__ = [
    "LONG_CONTEXT_ARCHS",
    "SHAPES",
    "ModelConfig",
    "ShapeConfig",
    "all_configs",
    "cells",
    "get_config",
]
