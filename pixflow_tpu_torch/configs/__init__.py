from .config import (DataConfig, FlowConfig, LinearConfig, ModelConfig, OptimConfig,
                     PretrainConfig, RuntimeConfig)
from .recipes import RECIPES, get_recipe

__all__ = ["DataConfig", "FlowConfig", "LinearConfig", "ModelConfig", "OptimConfig",
           "PretrainConfig", "RuntimeConfig", "RECIPES", "get_recipe"]
