"""Model facade: build a ported architecture from its ModelConfig. Port of
``repro/models/model.py`` for decoder-only stacks of ``attn``,
``mamba2`` and ``shared_attn`` blocks (TinyLlama, Zamba2).

    model = build_model(cfg, dtype)
    params = model.init(gen)                                  # on gen's device
    logits, aux = model.apply(params, batch)                  # full forward
    loss, metrics = model.loss(params, batch)                 # CE (+aux)
    logits, cache = model.prefill(params, batch, cache_len=)  # inference
    logits, cache = model.decode_step(params, cache, tokens)  # one token

Batch dict keys: tokens (B,S) integer, labels (B,S) integer. Logits at
or beyond ``vocab_size`` (the padded tail of the vocab table) are −1e30.
Encoders, image tokens, MLA, MoE, xLSTM and multi-token prediction are
not ported yet (ROADMAP A15): ``build_model`` refuses such configs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       init_norm)
from repro_torch.utils.tree import tree_leaves, tree_map

NEG_INF = -1e30


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    dtype: torch.dtype = torch.float32

    # ------------------------------------------------------------------ init
    def init(self, gen: torch.Generator) -> Dict:
        """Random params on ``gen``'s device (the reference's
        distributions, not its bits)."""
        cfg, dtype = self.cfg, self.dtype
        params = {
            "embed": embed_init(gen, (cfg.padded_vocab, cfg.d_model), dtype),
            "final_norm": init_norm(gen, cfg, dtype),
            "stack": tfm.init_stack(gen, cfg, dtype),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model,
                                                 cfg.padded_vocab), dtype)
        return params

    # ------------------------------------------------------------ embedding
    def _embed(self, params: Dict, batch: Dict) -> torch.Tensor:
        return params["embed"][batch["tokens"].long()]

    def _project_vocab(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        """Vocab projection over the padded table; padding logits −1e30."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            logits = torch.einsum("bsd,vd->bsv", x, params["embed"])
        else:
            logits = torch.einsum("bsd,dv->bsv", x, params["lm_head"])
        if cfg.padded_vocab != cfg.vocab_size:
            vid = torch.arange(cfg.padded_vocab, device=x.device)
            logits = torch.where(vid < cfg.vocab_size, logits, NEG_INF)
        return logits

    def _head(self, params: Dict, x: torch.Tensor) -> torch.Tensor:
        return self._project_vocab(params,
                                   apply_norm(params["final_norm"], x,
                                              self.cfg))

    # ---------------------------------------------------------- full forward
    def apply(self, params: Dict, batch: Dict):
        """Full causal forward. Returns (logits (B,S,V), aux)."""
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        x, _, aux = tfm.stack_full(params["stack"], x, self.cfg,
                                   positions=positions)
        return self._head(params, x), aux

    def loss(self, params: Dict, batch: Dict):
        logits, aux = self.apply(params, batch)
        ce = _ce(logits, batch["labels"])
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------ inference
    def cache_len_for(self, seq_len: int, window: Optional[int]) -> int:
        return min(seq_len, window) if window else seq_len

    def prefill(self, params: Dict, batch: Dict, *,
                cache_len: Optional[int] = None,
                window: Optional[int] = None):
        """Forward + decode cache. Returns (last-position logits
        (B,1,V), cache)."""
        x = self._embed(params, batch)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None]
        x, caches, _ = tfm.stack_full(params["stack"], x, self.cfg,
                                      positions=positions, window=window,
                                      build_cache=True)
        logits = self._head(params, x[:, -1:])
        cache_len = cache_len or self.cache_len_for(S, window)
        return logits, self._assemble_cache(caches, S, cache_len)

    def _assemble_cache(self, built: Dict, S: int, cache_len: int) -> Dict:
        """Pad or crop the per-layer prefill caches to the decode cache
        length and attach the position bookkeeping. When cropping (ring
        buffer), entries are rolled so that absolute position p sits at
        slot p % W: decode_step then always overwrites the oldest."""
        dev = tree_leaves(built)[0].device

        def fit(leaf):  # kv leaves: (n, B, S, ...)
            if S >= cache_len:
                return torch.roll(leaf[:, :, S - cache_len:],
                                  shifts=S % cache_len, dims=2)
            pad = torch.zeros(leaf.shape[:2] + (cache_len - S,)
                              + leaf.shape[3:], dtype=leaf.dtype,
                              device=leaf.device)
            return torch.cat([leaf, pad], dim=2)

        runs = {}
        for i, (btype, n) in enumerate(tfm.segment_runs(self.cfg.layer_types)):
            c = built[f"run{i}"]
            # recurrent states are already O(1)
            runs[f"run{i}"] = tree_map(fit, c) if btype in tfm.ATTN_TYPES else c
        if S >= cache_len:
            pos = torch.roll(torch.arange(S - cache_len, S, dtype=torch.int32,
                                          device=dev), S % cache_len)
        else:
            pos = torch.cat([torch.arange(S, dtype=torch.int32, device=dev),
                             torch.full((cache_len - S,), -1,
                                        dtype=torch.int32, device=dev)])
        return {"runs": runs,
                "t": torch.tensor(S, dtype=torch.int32, device=dev),
                "positions": pos}

    def init_cache(self, B: int, cache_len: int, *, device) -> Dict:
        """Empty decode cache (serving from scratch)."""
        cfg, dtype = self.cfg, self.dtype
        runs = {}
        for i, (btype, n) in enumerate(tfm.segment_runs(cfg.layer_types)):
            if btype in tfm.ATTN_TYPES:
                one = attn.init_gqa_cache(cfg, B, cache_len, dtype, device)
            else:
                one = ssm.init_mamba2_cache(cfg, B, dtype, device)
            runs[f"run{i}"] = tree_map(
                lambda x: x[None].repeat((n,) + (1,) * x.dim()), one)
        return {"runs": runs,
                "t": torch.tensor(0, dtype=torch.int32, device=device),
                "positions": torch.full((cache_len,), -1, dtype=torch.int32,
                                        device=device)}

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor, *,
                    window: Optional[int] = None):
        """tokens: (B,1) -> (logits (B,1,V), cache). ``window`` must
        match the value used at prefill / init_cache.

        Two cache forms, told apart by the rank of ``cache["t"]``:
          * scalar ``t`` + (W,) ``positions``: the lockstep cache (every
            row at the same position), as prefill returns it;
          * (B,) ``t`` + (B, W) ``positions``: the per-slot pool of the
            serving engine, each row at its own position and ring slot.
        The lockstep form runs as the per-slot form with every row equal.
        """
        t = cache["t"]
        vec = t.dim() > 0
        B = tokens.shape[0]
        W = cache["positions"].shape[-1]
        tv = t if vec else t.expand(B)
        pos = cache["positions"] if vec else cache["positions"].expand(B, W)
        slot = tv % W
        rows = torch.arange(B, device=tv.device)
        positions_buf = pos.index_put((rows, slot.long()), tv)
        x = self._embed(params, {"tokens": tokens})
        x, runs = tfm.stack_step(params["stack"], x, self.cfg, cache["runs"],
                                 t=tv, slot=slot,
                                 positions_buf=positions_buf, window=window)
        logits = self._head(params, x)
        return logits, {"runs": runs, "t": t + 1,
                        "positions": positions_buf if vec
                        else positions_buf[0]}


_NOT_PORTED = (("use_mla", "MLA"), ("num_experts", "MoE"),
               ("encoder_layers", "the encoder"),
               ("cross_attention", "cross-attention"),
               ("num_image_tokens", "image tokens"),
               ("mtp_depth", "multi-token prediction"))


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32
                ) -> Model:
    for field, what in _NOT_PORTED:
        if getattr(cfg, field):
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported to repro_torch yet: it "
                "comes with ROADMAP A15 (LM zoo)")
    for btype in cfg.layer_types:
        tfm.check_ported(btype)
    if not cfg.rope_theta:
        raise NotImplementedError(
            f"{cfg.name}: sinusoidal positions are not ported to repro_torch "
            "yet: they come with ROADMAP A15 (LM zoo)")
    return Model(cfg, dtype)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)
