"""Whisper-tiny — encoder-decoder, conv frontend stubbed. [arXiv:2212.04356]
A copy of ``repro/configs/whisper_tiny.py``.

4 encoder + 4 decoder layers, d_model=384, 6H, d_ff=1536, vocab=51865.
The mel-spectrogram and conv feature extractor are a stub: a batch
carries precomputed frame embeddings ``frames`` (B, 1500, 384).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    block_pattern=("attn",),
    encoder_layers=4,
    encoder_seq=1500,
    cross_attention=True,
    mlp_variant="gelu",
    norm_variant="layernorm",
    rope_theta=0.0,          # whisper uses learned/sinusoidal abs positions
    sliding_window=8192,
    citation="arXiv:2212.04356",
)
