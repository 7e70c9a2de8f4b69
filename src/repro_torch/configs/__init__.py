"""Configs: the paper tasks, the round config and the LM zoo's registry
(``get_config(arch_id)`` / ``--arch <id>``)."""
import importlib

from repro_torch.configs.base import FLConfig, ModelConfig
from repro_torch.configs.paper_tasks import (CNN_PAPER, MLP_SMALL, MLP_WIDE,
                                             CNNConfig, MLPConfig)

# every arch id of the reference; None marks one that is not ported yet
_ARCH_MODULES = {
    "zamba2-7b": "zamba2_7b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "codeqwen1.5-7b": "codeqwen1_5_7b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen2.5-14b": "qwen2_5_14b",
    "whisper-tiny": None,
    "xlstm-1.3b": None,
    "internvl2-1b": None,
    "granite-20b": "granite_20b",
}

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch_id: str) -> ModelConfig:
    try:
        modname = _ARCH_MODULES[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: "
                       f"{sorted(_ARCH_MODULES)}") from None
    if modname is None:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported to repro_torch yet: it comes "
            "with ROADMAP A15 (LM zoo)")
    return importlib.import_module(f"repro_torch.configs.{modname}").CONFIG


__all__ = ["ARCH_IDS", "FLConfig", "ModelConfig", "get_config", "CNN_PAPER",
           "MLP_SMALL", "MLP_WIDE", "CNNConfig", "MLPConfig"]
