from repro_torch.configs.base import FLConfig
from repro_torch.configs.paper_tasks import (CNN_PAPER, MLP_SMALL, MLP_WIDE,
                                             CNNConfig, MLPConfig)

__all__ = ["FLConfig", "CNN_PAPER", "MLP_SMALL", "MLP_WIDE", "CNNConfig",
           "MLPConfig"]
