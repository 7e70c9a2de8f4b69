"""Configs: the paper tasks, the round config and the LM zoo's registry
(``get_config(arch_id)`` / ``--arch <id>``)."""
import importlib

from repro_torch.configs.base import (INPUT_SHAPES, FLConfig, ModelConfig,
                                     ShapeConfig)
from repro_torch.configs.paper_tasks import (CNN_PAPER, MLP_SMALL, MLP_WIDE,
                                             CNNConfig, MLPConfig)

# every arch id of the reference
_ARCH_MODULES = {
    "zamba2-7b": "zamba2_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen2.5-14b": "qwen2_5_14b",
    "whisper-tiny": "whisper_tiny",
    "xlstm-1.3b": "xlstm_1_3b",
    "internvl2-1b": "internvl2_1b",
    "granite-20b": "granite_20b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    try:
        modname = _ARCH_MODULES[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}") from None
    return importlib.import_module(f"repro_torch.configs.{modname}").CONFIG


__all__ = ["ARCH_IDS", "INPUT_SHAPES", "FLConfig", "ModelConfig",
           "ShapeConfig", "get_config", "CNN_PAPER",
           "MLP_SMALL", "MLP_WIDE", "CNNConfig", "MLPConfig"]
