"""Paper-side configs for the faithful Δ-SGD reproduction (Section 4).

A copy of ``repro/configs/paper_tasks.py``: the port keeps its own so it
never imports the reference package.

The paper trains a shallow CNN (MNIST/FMNIST), ResNet-18/50 (CIFAR), and
DistilBERT (text). Those datasets are unavailable offline, so the repro
protocol runs on synthetic federated tasks (see
repro_torch/data/synthetic.py) with small models of the same *kinds*: an
MLP and a shallow CNN. They exist to validate the paper's own claims.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class MLPConfig:
    name: str
    input_dim: int
    hidden_dims: Tuple[int, ...]
    num_classes: int


@dataclass(frozen=True)
class CNNConfig:
    """Paper's shallow CNN: two conv + two FC layers, dropout + ReLU."""
    name: str
    image_size: int
    channels: int
    conv_channels: Tuple[int, int]
    fc_dim: int
    num_classes: int


MLP_SMALL = MLPConfig("mlp-small", input_dim=32, hidden_dims=(64, 64), num_classes=10)
MLP_WIDE = MLPConfig("mlp-wide", input_dim=32, hidden_dims=(256, 256, 128), num_classes=10)
CNN_PAPER = CNNConfig("cnn-paper", image_size=16, channels=1,
                      conv_channels=(16, 32), fc_dim=128, num_classes=10)
