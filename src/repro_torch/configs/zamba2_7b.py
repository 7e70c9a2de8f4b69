"""Zamba2-7B — Mamba2 backbone + shared attention blocks. [arXiv:2411.15242]

A copy of ``repro/configs/zamba2_7b.py``.
81 layers, d_model=3584, 32 heads (GQA kv=32 for the shared attention block),
d_ff=14336, vocab=32000, ssm_state=64. One globally *shared*
attention+MLP block follows every 6 Mamba2 layers (the HF model alternates two
shared blocks with per-site LoRA; the reference uses one shared block).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    block_pattern=("mamba2",) * 6 + ("shared_attn",),
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    sliding_window=8192,   # shared attention uses a window on the 500k path
    citation="arXiv:2411.15242",
)
