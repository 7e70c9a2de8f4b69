"""DeepSeek-V3-671B — MLA + MoE (1 shared + 256 routed, top-8) + MTP.
[arXiv:2412.19437]
A copy of ``repro/configs/deepseek_v3_671b.py``.

61L, d_model=7168, 128 heads, per-expert d_ff=2048, vocab=129280.
MLA dims follow the paper: q_lora=1536, kv_lora=512, rope head dim 64,
nope head dim 128, v head dim 128. Per the assignment's single d_ff we use
MoE in every layer (the release model keeps 3 dense first layers; DESIGN §5).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=2048,
    vocab_size=129280,
    block_pattern=("moe",),
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    num_experts=256,
    num_experts_per_tok=8,
    num_shared_experts=1,
    moe_d_ff=2048,
    mtp_depth=1,
    sliding_window=8192,
    citation="arXiv:2412.19437",
)
