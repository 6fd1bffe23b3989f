from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      SSMConfig, reduced)
from repro_torch.configs.registry import (ALL_ARCHS, get_config,
                                          get_reduced_config)
from repro_torch.configs.shapes import (ALL_SHAPES, SHAPES, ShapeSuite,
                                        shapes_for, skip_reason)

__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig", "reduced",
           "ALL_ARCHS", "get_config", "get_reduced_config", "ALL_SHAPES",
           "SHAPES", "ShapeSuite", "shapes_for", "skip_reason"]
