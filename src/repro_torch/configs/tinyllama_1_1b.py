"""TinyLlama-1.1B — llama2-arch small. [arXiv:2401.02385]

A copy of ``repro/configs/tinyllama_1_1b.py``.
22L, d_model=2048, 32H (GQA kv=4), d_ff=5632, vocab=32000.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    block_pattern=("attn",),
    sliding_window=8192,   # long-context decode path only
    citation="arXiv:2401.02385",
)
