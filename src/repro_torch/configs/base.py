"""Config dataclasses, after the reference's ``repro/configs/base.py``.

``ModelConfig`` describes one architecture of the LM zoo; the model
builder (``repro_torch.models.model.build_model``) reads only it. The
reference's analytic ``param_count`` is
``repro_torch.launch.specs.param_count`` (an init on fake tensors).

``ShapeConfig`` and ``INPUT_SHAPES`` are the reference's input shapes
(the dry run's programs, ``repro_torch.launch.dryrun``).

``FLConfig`` holds the fields of the reference's ``FLConfig`` that the
ported training slices and the step builders (``launch/steps.py``) read,
with the reference's defaults (paper §4). MOON's two fields and
``telemetry`` are not here: the train CLI takes them as flags.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# Block types understood by the model builder. A layer is one block.
#   attn        : self-attention (GQA/MQA/MLA per config) + dense MLP
#   moe         : self-attention + MoE MLP (top-k routed + shared experts)
#   mamba2      : Mamba2 SSD mixer block (norm + mixer; no separate MLP)
#   mlstm       : xLSTM matrix-LSTM block
#   slstm       : xLSTM scalar-LSTM block
#   shared_attn : attention+MLP block whose params are SHARED across all
#                 occurrences (Zamba2-style global shared block)
BLOCK_TYPES = ("attn", "moe", "mamba2", "mlstm", "slstm", "shared_attn")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    block_pattern: Tuple[str, ...] = ("attn",)   # cycled to num_layers
    head_dim: int = 0                # 0 -> d_model // num_heads
    # --- attention options ---
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    sliding_window: Optional[int] = None   # used by long-context decode path
    tie_embeddings: bool = False
    # --- MLA (DeepSeek-V3) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_head_dim: int = 0
    qk_nope_head_dim: int = 0
    v_head_dim: int = 0
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (d_ff used if 0)
    router_aux_coef: float = 0.01
    # --- SSM (Mamba2 / xLSTM) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_head_dim: int = 64
    ssm_ngroups: int = 1
    # --- encoder-decoder (Whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0             # frames produced by the (stub) frontend
    cross_attention: bool = False
    # --- VLM ---
    num_image_tokens: int = 0        # stub-frontend patch embeddings prepended
    # --- multi-token prediction (DeepSeek-V3) ---
    mtp_depth: int = 0
    # --- activation / norm flavour ---
    mlp_variant: str = "swiglu"      # swiglu | gelu
    norm_variant: str = "rmsnorm"    # rmsnorm | layernorm
    citation: str = ""

    def __post_init__(self):
        for b in self.block_pattern:
            if b not in BLOCK_TYPES:
                raise ValueError(f"unknown block type {b!r}")
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def layer_types(self) -> Tuple[str, ...]:
        """Per-layer block types, pattern cycled to num_layers."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def padded_vocab(self) -> int:
        """Embedding and head tables are padded to a multiple of 128;
        logits at or beyond ``vocab_size`` are masked to −1e30."""
        return -(-self.vocab_size // 128) * 128

    @property
    def expert_d_ff(self) -> int:
        return self.moe_d_ff or self.d_ff

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                vocab: int = 512) -> "ModelConfig":
        """A tiny same-family variant for CPU smoke tests (the
        reference's rule, field for field)."""
        nh = max(2, min(4, self.num_heads))
        kv = max(1, min(nh, self.num_kv_heads if self.num_kv_heads < self.num_heads else nh))
        if self.num_kv_heads == self.num_heads:
            kv = nh
        upd = dict(
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=nh,
            num_kv_heads=kv,
            head_dim=d_model // nh,
            d_ff=2 * d_model,
            vocab_size=vocab,
        )
        if self.num_experts:
            upd.update(num_experts=4, num_experts_per_tok=2,
                       moe_d_ff=d_model, num_shared_experts=min(1, self.num_shared_experts))
        if self.use_mla:
            upd.update(q_lora_rank=64, kv_lora_rank=32, qk_rope_head_dim=16,
                       qk_nope_head_dim=16, v_head_dim=d_model // nh)
        if self.ssm_state:
            upd.update(ssm_state=16, ssm_head_dim=32)
        if self.encoder_layers:
            upd.update(encoder_layers=2, encoder_seq=64)
        if self.num_image_tokens:
            upd.update(num_image_tokens=16)
        if self.mtp_depth:
            upd.update(mtp_depth=1)
        if self.sliding_window:
            upd.update(sliding_window=64)
        return dataclasses.replace(self, **upd)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


# the reference's input shapes (the dry run's programs)
INPUT_SHAPES = {
    "train_4k":    ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k":  ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k":   ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class FLConfig:
    num_clients: int = 100           # m
    participation: float = 0.1       # p  -> |S_t| = p*m
    local_steps: int = 2             # K of the LM trainers' rounds
    client_opt: str = "delta_sgd"
    server_opt: str = "fedavg"
    fedprox_mu: float = 0.0
    # Δ-SGD defaults (paper footnotes 2-3: γ=2, η0=0.2, θ0=1, δ=0.1)
    gamma: float = 2.0
    eta0: float = 0.2
    theta0: float = 1.0
    delta: float = 0.1
    # generic client-opt hparams
    lr: float = 0.01
    momentum: float = 0.9
    weighted_agg: bool = False
    # the flat-parameter Δ-SGD engine (core/fed_round) by default
    flat_engine: bool = False
    # a federation scenario preset name (repro_torch.federation); None is
    # the plain sync round
    scenario: Optional[str] = None
    # client-delta compression over the LEVELS ladder ("none"|"int8"|
    # "topk"), top-k's keep fraction a chunk, EF21 error feedback;
    # "none" without error feedback is inert
    compression: str = "none"
    compression_k_frac: float = 0.25
    error_feedback: bool = False
    # robust aggregation and quorum, applied onto the scenario; "mean"
    # and 0 are inert
    robust_agg: str = "mean"         # mean|clip|trimmed|median
    quorum: int = 0
    # the fleet regime: C_registered clients known to the server (None:
    # registered == num_clients)
    num_registered_clients: Optional[int] = None

    @property
    def compression_spec(self):
        from repro_torch.compression import CompressionSpec
        return CompressionSpec(kind=self.compression,
                               k_frac=self.compression_k_frac,
                               error_feedback=self.error_feedback)

    @property
    def registered_clients(self) -> int:
        """C_registered: the fleet size the schedulers draw over
        (``num_clients`` outside the fleet regime)."""
        m = self.num_registered_clients
        if m is not None and m < self.num_clients:
            raise ValueError(f"num_registered_clients={m} must be >= "
                             f"num_clients={self.num_clients}")
        return self.num_clients if m is None else m

    @property
    def fleet(self) -> bool:
        return self.num_registered_clients is not None

    @property
    def clients_per_round(self) -> int:
        """|S_t| = round(p·C_registered), at least 1."""
        from repro_torch.federation.schedulers import cohort_size
        return cohort_size(self.participation, self.registered_clients)
