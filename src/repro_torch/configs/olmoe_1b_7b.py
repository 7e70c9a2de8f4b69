"""OLMoE-1B-7B — 64 experts, top-8. [arXiv:2409.02060]
A copy of ``repro/configs/olmoe_1b_7b.py``.

16L, d_model=2048, 16H (kv=16), per-expert d_ff=1024, vocab=50304.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1024,
    vocab_size=50304,
    block_pattern=("moe",),
    num_experts=64,
    num_experts_per_tok=8,
    moe_d_ff=1024,
    sliding_window=8192,
    citation="arXiv:2409.02060",
)
