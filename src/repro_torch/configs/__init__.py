from .base import (ArchConfig, MLAConfig, MoEConfig, SSMConfig, ShapeConfig,
                   SHAPES, REGISTRY, applicable_shapes, get_arch, list_archs,
                   reduced)
from .all_archs import ALL_ARCHS  # registers every arch

__all__ = ["ArchConfig", "MLAConfig", "MoEConfig", "SSMConfig", "ShapeConfig",
           "SHAPES", "REGISTRY", "ALL_ARCHS", "applicable_shapes", "get_arch",
           "list_archs", "reduced"]
