"""Granite-20B (code) — llama-arch with MQA. [arXiv:2405.04324]
A copy of ``repro/configs/granite_20b.py``.

52L, d_model=6144, 48H (MQA kv=1), d_ff=24576, vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_variant="gelu",     # granite-20b-code uses gpt-bigcode style MLP
    block_pattern=("attn",),
    sliding_window=8192,
    citation="arXiv:2405.04324",
)
