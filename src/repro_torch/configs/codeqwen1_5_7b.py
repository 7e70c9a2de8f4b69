"""CodeQwen1.5-7B — qwen1.5 arch (QKV bias). [hf:Qwen/CodeQwen1.5-7B]
A copy of ``repro/configs/codeqwen1_5_7b.py``.

32L, d_model=4096, 32H (GQA kv=32 == MHA), d_ff=13440, vocab=92416.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    qkv_bias=True,
    block_pattern=("attn",),
    sliding_window=8192,
    citation="hf:Qwen/CodeQwen1.5-7B",
)
