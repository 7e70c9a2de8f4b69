"""InternVL2-1B — InternViT (stub) + InternLM2/Qwen2-style LM. [arXiv:2404.16821]
A copy of ``repro/configs/internvl2_1b.py``.

24L, d_model=896, 14H (GQA kv=2), d_ff=4864, vocab=151655. The vision
encoder and projector are a stub: a batch carries 256 precomputed patch
embeddings ``image_embeds`` of width d_model, prepended to the text.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    qkv_bias=True,
    block_pattern=("attn",),
    num_image_tokens=256,
    sliding_window=8192,
    citation="arXiv:2404.16821",
)
