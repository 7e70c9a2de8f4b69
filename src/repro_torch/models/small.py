"""Small models for the paper reproduction: an MLP and the paper's shallow
CNN (two conv + two FC, ReLU; dropout omitted — deterministic repro).

Port of ``repro/models/small.py`` as plain functions on a dict of
tensors, so ``torch.func`` can vmap them over a client axis of the
params. The parameter names, shapes and layouts are the reference's —
dense ``w`` is (in, out) and conv ``w`` is HWIO — so packed flat buffers
line up element by element; the convolutions permute at use. Inputs are
NHWC, as in the reference.

Two details of the reference are reproduced on purpose:
  * ``padding="SAME"`` with stride 2 and a 3×3 kernel pads 0 before and
    1 after (16 -> 8 and 8 -> 4). ``nn.Conv2d(padding=1)`` gives the same
    shape over shifted windows, so the port pads with
    ``F.pad(x, (0, 1, 0, 1))`` and convolves with ``padding=0``.
  * the reference flattens NHWC before ``fc1``; the port permutes back to
    NHWC before the reshape, or ``fc1`` would read the wrong features.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.paper_tasks import CNNConfig, MLPConfig
from repro_torch.models.common import dense_init

Params = Dict[str, Dict[str, torch.Tensor]]


def _gen(seed_or_gen) -> torch.Generator:
    if isinstance(seed_or_gen, torch.Generator):
        return seed_or_gen
    return torch.Generator().manual_seed(int(seed_or_gen))


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def init_mlp_model(gen, cfg: MLPConfig, dtype=torch.float32) -> Params:
    gen = _gen(gen)
    dims = (cfg.input_dim,) + cfg.hidden_dims + (cfg.num_classes,)
    return {f"l{i}": {"w": dense_init(gen, (dims[i], dims[i + 1]), dtype),
                      "b": torch.zeros((dims[i + 1],), dtype=dtype)}
            for i in range(len(dims) - 1)}


def mlp_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        x = x @ params[f"l{i}"]["w"] + params[f"l{i}"]["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


# ---------------------------------------------------------------------------
# Shallow CNN (paper's MNIST/FMNIST model)
# ---------------------------------------------------------------------------
def init_cnn_model(gen, cfg: CNNConfig, dtype=torch.float32) -> Params:
    gen = _gen(gen)
    c1, c2 = cfg.conv_channels
    flat = (cfg.image_size // 4) ** 2 * c2   # two stride-2 convs: /4
    return {
        "conv1": {"w": dense_init(gen, (3, 3, cfg.channels, c1), dtype,
                                  fan_in=9 * cfg.channels),
                  "b": torch.zeros((c1,), dtype=dtype)},
        "conv2": {"w": dense_init(gen, (3, 3, c1, c2), dtype,
                                  fan_in=9 * c1),
                  "b": torch.zeros((c2,), dtype=dtype)},
        "fc1": {"w": dense_init(gen, (flat, cfg.fc_dim), dtype),
                "b": torch.zeros((cfg.fc_dim,), dtype=dtype)},
        "fc2": {"w": dense_init(gen, (cfg.fc_dim, cfg.num_classes), dtype),
                "b": torch.zeros((cfg.num_classes,), dtype=dtype)},
    }


def _conv_same_s2(x: torch.Tensor, p) -> torch.Tensor:
    """NCHW stride-2 3×3 conv with XLA's SAME padding (0 before, 1 after)
    and an HWIO weight, then bias + ReLU."""
    x = F.pad(x, (0, 1, 0, 1))
    y = F.conv2d(x, p["w"].permute(3, 2, 0, 1), stride=2)
    return torch.relu(y + p["b"][:, None, None])


def cnn_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """x: (B, H, W, C) -> (B, num_classes)."""
    x = x.permute(0, 3, 1, 2)
    x = _conv_same_s2(x, params["conv1"])
    x = _conv_same_s2(x, params["conv2"])
    x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)   # flatten NHWC
    x = torch.relu(x @ params["fc1"]["w"] + params["fc1"]["b"])
    return x @ params["fc2"]["w"] + params["fc2"]["b"]


# ---------------------------------------------------------------------------
# Shared loss / metrics
# ---------------------------------------------------------------------------
def softmax_ce(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, y.long()[:, None])[:, 0]
    return torch.mean(lse - ll)


def accuracy(logits: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (torch.argmax(logits, -1) == y).to(torch.float32).mean()


def make_small_model(cfg):
    """(init_fn(seed_or_generator, dtype=f32), logits_fn) for an MLPConfig
    or CNNConfig. ``init_fn`` draws on the CPU; move the result with
    ``repro_torch.utils.tree.tree_map``."""
    if isinstance(cfg, MLPConfig):
        return (lambda gen, dtype=torch.float32:
                init_mlp_model(gen, cfg, dtype), mlp_logits)
    return (lambda gen, dtype=torch.float32:
            init_cnn_model(gen, cfg, dtype), cnn_logits)
