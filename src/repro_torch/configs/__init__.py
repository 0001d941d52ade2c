from .base import (ArchConfig, ShapeSpec, SHAPES, get_config, list_archs,
                   reduced_config)

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "get_config", "list_archs",
           "reduced_config"]
