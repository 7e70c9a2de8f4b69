"""Qwen2.5-14B — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B card family]
A copy of ``repro/configs/qwen2_5_14b.py``.

48L, d_model=5120, 40H (GQA kv=8), d_ff=13824, vocab=152064.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=13824,
    vocab_size=152064,
    qkv_bias=True,
    block_pattern=("attn",),
    sliding_window=8192,
    citation="hf:Qwen/Qwen2.5-0.5B",
)
