"""Configs, the process grid and the seed discipline of the port
(counterpart of sm3x/core/; its precision policy and compilation cache
have no counterpart: `torch.autocast` takes their place)."""

from sm3x_torch.core.config import (  # noqa: F401
    DataConfig, EvalConfig, MLCTrainConfig, ModelConfig, OptimConfig,
    RunConfig, SSLConfig)
from sm3x_torch.core.mesh import make_mesh  # noqa: F401

__all__ = ["make_mesh", "DataConfig", "ModelConfig", "OptimConfig",
           "RunConfig", "SSLConfig", "MLCTrainConfig", "EvalConfig"]
