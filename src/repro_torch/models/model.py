"""Model facade: build any architecture of the LM zoo from its
ModelConfig. Port of ``repro/models/model.py``: decoder stacks of
``attn``, ``moe``, ``mamba2``, ``shared_attn``, ``mlstm`` and ``slstm``
blocks, with GQA or MLA attention and DeepSeek-V3's multi-token
prediction, Whisper's encoder-decoder with cross-attention and
sinusoidal positions, and InternVL2's image tokens (all 10 archs).

    model = build_model(cfg, dtype)
    params = model.init(gen)                                  # on gen's device
    logits, aux = model.apply(params, batch)                  # full forward
    loss, metrics = model.loss(params, batch)                 # CE (+aux)
    logits, cache = model.prefill(params, batch, cache_len=)  # inference
    logits, cache = model.decode_step(params, cache, tokens)  # one token

Batch dict keys: tokens (B,S) integer, labels (B,S) integer, and for
the stub frontends ``frames`` (B, encoder_seq, D) (Whisper's encoder
input) or ``image_embeds`` (B, num_image_tokens, D) (InternVL2's patch
embeddings, prepended to the text): precomputed embeddings. Logits at
or beyond ``vocab_size`` (the padded tail of the vocab table) are
−1e30; with image tokens, logits are for the text positions only.
``apply``'s aux is the MoE layers' auxiliary loss, plus, for a config
with ``mtp_depth`` and a batch with labels, the multi-token prediction
loss (``_mtp_loss``).

``apply``, ``loss`` and ``prefill`` take the reference's ``use_pallas``
route keyword. True (the port's default, the route its serving has
always taken) runs causal attention and the SSD through their kernel
wrappers; False runs the reference's plain model code
(``attention._sdpa``, ``ssm._ssd_chunked``), which autograd and
``torch.func`` differentiate. The training builders
(``repro_torch.launch.steps``) pass False, as the reference's default
gives its trainers; the kernel wrappers refuse tensors that require
grad, as the reference cannot differentiate its kernels. Nothing picks
a route by itself. The encoder's bidirectional attention, the
cross-attention and the xLSTM mixers run in plain torch on either
route, as in the reference.

Sinusoidal positions take the reference's two routes: the full-sequence
table in numpy f64 rounded to f32 (``_embed``, ``_encode``), and each
row's own position in f32 on the device in ``decode_step``.

Tensor-parallel serving: under installed logical rules
(``models.common.logical_rules``) ``prefill``, ``decode_step`` and
``init_cache`` run one rank's share on its local params, batch rows and
cache (``repro_torch.launch.steps.place_for_rank`` cuts them): the
embedding is vocab-parallel (ids outside the rank's slice of the table
masked, one ``vocab`` all-reduce), the vocab projection gives the
rank's slice of the logits, masked by their global ids, and one
``vocab`` all-gather makes them whole, so the greedy token is the
unsharded argmax's. Where the rules also shard a table's model dim
over an fsdp axis (``cross_silo``), the rank gathers the table at use,
or, where that moves fewer bytes (``moves_rows``: a decode step of
fewer rows than the rank's vocab ids), moves its fsdp group's rows
instead (``fsdp_rows``: the ids and the looked-up columns; the head's
input and its partial logits).

Tensor-parallel training (``LogicalRules(serve=False)``): ``apply`` and
``loss`` run one rank's share of the full forward on its local params
and rows, differentiably. The tables are gathered at use (the rows
route stays serving's), the head's input enters through ``tp_enter``,
and ``loss`` is a vocab-parallel cross-entropy on the rank's block of
the logits (``_ce_parallel``), which are never gathered whole. Every
arch runs under rules: the decoders of GQA or MLA attention with dense MLP or MoE blocks (TinyLlama, CodeQwen1.5,
Qwen2.5, Granite, OLMoE, DeepSeek-V3 with its MTP block: ``mtp/proj``
is column-parallel, its output gathered whole with a backward that
keeps the rank's block, ``dist.gather_split``, and the MTP head's
cross-entropy is vocab-parallel as the main head's); Zamba2's Mamba2
mixer (``ssm``'s TP branch) and its shared block, whose one set of
params every site reads (gathered at each site under an fsdp axis, its
gradient the sites' sum); Whisper's encoder (its non-causal attention
on the rank's heads) and cross-attention (the cached ``enc_kv`` holds
every KV head of the rank's rows); InternVL2's image rows, placed with
the batch and prepended after the vocab-parallel embedding; xLSTM's
mLSTM and sLSTM (``ssm``'s TP branches: the recurrences run whole on
every rank, with no collective inside the sLSTM's time loop). Heads
that do not split over the tensor axis (``tp_refusal``) are refused
naming why, as are prefill and decode under training rules and the
full forward under serving rules.

Where the rows of a decode cache do not split over the data axes (one
row, or a batch the data ranks do not divide), the reference's
``cache_shardings`` cuts each leaf's next dim over ``model``: an
attention cache's time dim, an xLSTM state's heads or units. ``init_cache``
and ``launch.steps.place_for_rank`` give each rank that block, and the
decode reads it: attention on the rank's time block combined over
``model`` by the log-sum-exp rule (``attention``), the new token
written by the rank that owns its ring slot; the xLSTM steps on the
rank's mLSTM heads or its gathered sLSTM state (``ssm``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tfm
from repro_torch.models.common import (apply_norm, dense_init, embed_init,
                                       fsdp_gather, fsdp_gather_tree,
                                       get_logical_rules, logical_rules,
                                       init_norm, sinusoidal_position_at,
                                       sinusoidal_positions, tp_enter,
                                       tp_gather, tp_index, tp_reduce)
from repro_torch.utils.numerics import reciprocal
from repro_torch.sharding import dist
from repro_torch.sharding.spec import (cache_shardings, entry_axes,
                                       local_shape, unread_seq_cut)
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
            "stack": tfm.init_stack(gen, cfg, dtype,
                                    decoder=cfg.cross_attention),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = dense_init(gen, (cfg.d_model,
                                                 cfg.padded_vocab), dtype)
        if cfg.encoder_layers:
            params["encoder"] = {
                "stack": tfm.init_stack(gen, cfg, dtype,
                                        layer_types=self._enc_types),
                "norm": init_norm(gen, cfg, dtype),
            }
        if cfg.mtp_depth:
            params["mtp"] = {
                "proj": dense_init(gen, (2 * cfg.d_model, cfg.d_model),
                                   dtype),
                "block": tfm.init_block(gen, cfg, cfg.layer_types[-1],
                                        dtype),
                "norm": init_norm(gen, cfg, dtype),
            }
        return params

    # ------------------------------------------------------------ embedding
    @property
    def _enc_types(self):
        return ("attn",) * self.cfg.encoder_layers

    def _table(self, params: Dict, key: str) -> torch.Tensor:
        """``params[key]`` with its fsdp dims gathered under rules."""
        rules = get_logical_rules()
        if rules is None or not rules.fsdp_live:
            return params[key]
        return fsdp_gather(params[key], rules.param_axes[key])

    def _vocab_block(self, table: torch.Tensor, dim: int):
        """(first global id, ids) of the rank's block of the vocab dim
        ``dim`` of ``table``."""
        n = table.shape[dim]
        return (tp_index() * n if n < self.cfg.padded_vocab else 0), n

    def _fsdp_rows(self, key: str, vdim: int, tokens: int, head: bool):
        """The live fsdp axes of the table ``key``'s model dim (the one
        that is not its vocab dim ``vdim``) where the rules shard it
        there and moving the fsdp group's ``tokens`` rows costs less
        than gathering the table (``moves_rows``); else None."""
        rules = get_logical_rules()
        if rules is None or not rules.fsdp_live or not rules.serve:
            return None
        ax = tuple(a for a in entry_axes(rules.param_axes[key][1 - vdim])
                   if a != rules.tp and rules.size(a) > 1)
        if not ax or not moves_rows(tokens * rules.size(ax), self.cfg.d_model,
                                    local_vocab(self.cfg, rules), head):
            return None
        return ax

    def _tok_embed(self, params: Dict, tokens: torch.Tensor) -> torch.Tensor:
        # F.embedding: its backward on the card sums a token's rows in a
        # fixed order, so a trained step's bits do not vary run to run
        rules = get_logical_rules()
        ax = self._fsdp_rows("embed", 0, tokens.numel(), head=False)
        if ax is None:
            table = self._table(params, "embed")
        else:
            # the fsdp group's ids, looked up in the rank's columns of
            # the table, the columns gathered after: rows move, not the
            # table
            B, table = tokens.shape[0], params["embed"]
            tokens = dist.all_gather(tokens, rules.mesh, ax, 0,
                                     role="fsdp_rows")
        v0, n = self._vocab_block(table, 0)
        if n == self.cfg.padded_vocab:
            x = F.embedding(tokens.long(), table)
        else:
            # vocab-parallel: a row of another rank's block is zeros
            # here, and the sum over the tensor axis adds one row to zeros
            ids = tokens.long() - v0
            mine = (ids >= 0) & (ids < n)
            x = F.embedding(torch.where(mine, ids, 0), table)
            x = tp_reduce(x * mine[..., None].to(x.dtype), "vocab")
        if ax is not None:
            x = dist.all_gather(x, rules.mesh, ax, x.dim() - 1,
                                role="fsdp_rows").narrow(
                0, rules.index(ax) * B, B)
        return x

    def _embed(self, params: Dict, batch: Dict) -> torch.Tensor:
        """Token embeddings, after the image embeddings where the config
        and the batch have them, plus the sinusoidal table where the
        config has no rope."""
        cfg = self.cfg
        x = self._tok_embed(params, batch["tokens"])
        if cfg.num_image_tokens and "image_embeds" in batch:
            x = torch.cat([batch["image_embeds"].to(x.dtype), x], dim=1)
        if not cfg.rope_theta:
            x = x + _sinusoid_table(x.shape[1], cfg.d_model, x.device
                                    ).to(x.dtype)[None]
        return x

    def _encode(self, params: Dict, batch: Dict) -> torch.Tensor:
        """The Whisper encoder over the stub frame embeddings: the
        sinusoidal table, non-causal attention blocks, a final norm."""
        cfg = self.cfg
        frames = batch["frames"].to(self.dtype)
        S = frames.shape[1]
        x = frames + _sinusoid_table(S, cfg.d_model, frames.device
                                     ).to(frames.dtype)[None]
        positions = torch.arange(S, device=x.device)[None]
        x, _, _ = tfm.stack_full(params["encoder"]["stack"], x, cfg,
                                 layer_types=self._enc_types,
                                 positions=positions, causal=False,
                                 where=("encoder", "stack"))
        return apply_norm(params["encoder"]["norm"], x, cfg)

    def _cross_kv(self, params: Dict, enc_out: torch.Tensor) -> Dict:
        """Each decoder layer's cross K/V, stacked (num_layers, B, T, KV,
        hd). The decoder stack is one run of blocks. Under rules with an
        fsdp axis, each layer's K/V projections (``attention.CROSS_KV``)
        are gathered at use."""
        runs = tfm.segment_runs(self.cfg.layer_types)
        if len(runs) != 1:
            raise ValueError("an encoder-decoder config needs a uniform "
                             f"decoder stack, got runs {runs}")
        btype, n = runs[0]
        rules = get_logical_rules()
        kvs = []
        for p in tfm._run_params(params["stack"], 0, btype, n):
            xp = p["xattn"]
            if rules is not None and rules.fsdp_live:
                axes = tfm.layer_axes(tfm.stack_axes(), 0, btype, n)["xattn"]
                kv = [k for k in xp if k in attn.CROSS_KV]
                xp = {**xp, **fsdp_gather_tree({k: xp[k] for k in kv},
                                               {k: axes[k] for k in kv})}
            kvs.append(attn.cross_kv(xp, enc_out, self.cfg))
        return tfm._stack(kvs)

    def _enc_kv(self, params: Dict, batch: Dict):
        """The decoder's cross K/V for ``batch``, None without an
        encoder."""
        if not self.cfg.encoder_layers:
            return None
        return self._cross_kv(params, self._encode(params, batch))

    def _project_vocab(self, params: Dict, x: torch.Tensor, *,
                       whole: bool = True):
        """Vocab projection over the padded table; padding logits −1e30.
        With ``whole=False``, (the rank's block of the logits, its first
        global id): training's cross-entropy runs on the block."""
        cfg = self.cfg
        if cfg.tie_embeddings:
            table = self._table(params, "embed")
            v0, n = self._vocab_block(table, 0)
            logits = torch.einsum("bsd,vd->bsv", x, table)
        else:
            rules = get_logical_rules()
            ax = self._fsdp_rows("lm_head", 1, x.shape[0] * x.shape[1],
                                 head=True)
            if ax is None:
                table = self._table(params, "lm_head")
                logits = torch.einsum("bsd,dv->bsv", x, table)
            else:
                # the fsdp group's rows against the rank's rows of the
                # table, the partial logits summed over the group
                table, f, B = params["lm_head"], rules.index(ax), x.shape[0]
                xg = dist.all_gather(x, rules.mesh, ax, 0, role="fsdp_rows")
                part = torch.einsum("bsd,dv->bsv", xg.narrow(
                    2, f * table.shape[0], table.shape[0]), table)
                logits = dist.all_reduce(part, rules.mesh, ax,
                                         role="fsdp_rows").narrow(0, f * B, B)
            v0, n = self._vocab_block(table, 1)
        if cfg.padded_vocab != cfg.vocab_size:
            vid = v0 + torch.arange(n, device=x.device)
            logits = torch.where(vid < cfg.vocab_size, logits, NEG_INF)
        if not whole:
            return logits, v0
        if n < cfg.padded_vocab:
            logits = tp_gather(logits, -1 % logits.dim(), "vocab")
        return logits

    def _head(self, params: Dict, x: torch.Tensor, *, whole: bool = True):
        """The final norm and the vocab projection. Under training rules
        the normed input enters the rank's vocab block through
        ``tp_enter``."""
        x = apply_norm(params["final_norm"], x, self.cfg)
        if self._vocab_split(params):
            x = tp_enter(x)
        return self._project_vocab(params, x, whole=whole)

    def _vocab_split(self, params: Dict) -> bool:
        """The installed rules split the head's vocab dim."""
        if get_logical_rules() is None:
            return False
        if self.cfg.tie_embeddings:
            return params["embed"].shape[0] < self.cfg.padded_vocab
        return params["lm_head"].shape[-1] < self.cfg.padded_vocab

    # ---------------------------------------------------------- full forward
    def _check_rules(self, what: str) -> None:
        """Refuse what tensor parallelism does not run: heads that do
        not split over the tensor axis (``tp_refusal``), the
        sequence-sharded rules (ROADMAP A17, with ``launch/perf.py``),
        the full forward (training's) under serving rules and serving
        under training rules."""
        rules = get_logical_rules()
        if rules is None:
            return
        cfg = self.cfg
        if rules.seq_shard:
            raise ValueError("sequence-sharded rules (seq_shard) are "
                             "ROADMAP A17: the Megatron-SP residual of "
                             "launch/perf.py's variants")
        why = tp_refusal(cfg, rules.size(rules.tp))
        if why:
            raise ValueError(why)
        if (what == "apply") == rules.serve:
            raise ValueError(
                f"{what} under {'serving' if rules.serve else 'training'} "
                "rules: the full forward runs under LogicalRules("
                "serve=False), prefill and decode under serve=True")

    def _forward(self, params: Dict, batch: Dict, use_pallas: bool,
                 whole: bool):
        """The full causal forward -> (logits, aux, first global vocab
        id of the logits)."""
        self._check_rules("apply")
        cfg = self.cfg
        x = self._embed(params, batch)
        positions = torch.arange(x.shape[1], device=x.device)[None]
        x, _, aux = tfm.stack_full(params["stack"], x, cfg,
                                   positions=positions,
                                   enc_kv=self._enc_kv(params, batch),
                                   use_pallas=use_pallas)
        if cfg.num_image_tokens and "image_embeds" in batch:
            x = x[:, cfg.num_image_tokens:]   # text positions only
        out = self._head(params, x, whole=whole)
        logits, v0 = out if not whole else (out, 0)
        if self.cfg.mtp_depth and "labels" in batch:
            aux = aux + self._mtp_loss(params, x, batch)
        return logits, aux, v0

    def apply(self, params: Dict, batch: Dict, *, use_pallas: bool = True):
        """Full causal forward. Returns (logits (B,S,V) over the text
        positions, aux). Under training rules, on the rank's local
        params and rows, with the logits gathered whole."""
        logits, aux, _ = self._forward(params, batch, use_pallas, True)
        return logits, aux

    def _mtp_loss(self, params: Dict, h: torch.Tensor, batch: Dict,
                  weight: float = 0.3) -> torch.Tensor:
        """DeepSeek-V3 multi-token prediction: token t+2 (the labels
        shifted by one) from [h_t ; emb(token_{t+1})] through one extra
        block of the last layer's type, on the plain route as the
        reference runs it. Returns weight·CE + the block's aux."""
        cfg = self.cfg
        rules = get_logical_rules()
        mtp = params["mtp"]
        if rules is not None and rules.fsdp_live:
            mtp = fsdp_gather_tree(mtp, rules.param_axes["mtp"])
        nxt = self._tok_embed(params, batch["tokens"][:, 1:])
        hcat = torch.cat([h[:, :-1], nxt], dim=-1)
        # under rules ``proj`` is column-parallel: the rank's block of D,
        # gathered whole for the block (its gradient, whole on every
        # rank, is split back to the block, not reduce-scattered)
        split = rules is not None and mtp["proj"].shape[1] < cfg.d_model
        if split:
            hcat = tp_enter(hcat)
        x = torch.einsum("bsd,dk->bsk", hcat, mtp["proj"])
        if split:
            x = dist.gather_split(x, rules.mesh, (rules.tp,), -1,
                                  role="mtp_gather")
        positions = torch.arange(x.shape[1], device=x.device)[None]
        x, _, aux = tfm.block_full(mtp["block"], x, cfg,
                                   cfg.layer_types[-1], positions=positions,
                                   use_pallas=False)
        x = apply_norm(mtp["norm"], x, cfg)
        labels = batch["labels"][:, 1:]
        if rules is None:
            ll = _ce(self._project_vocab(params, x), labels)
        else:
            vsplit = self._vocab_split(params)
            if vsplit:
                x = tp_enter(x)
            logits, v0 = self._project_vocab(params, x, whole=False)
            ll = _ce_parallel(logits, labels, v0, rules, vsplit)
        return weight * ll + (aux if aux is not None else 0.0)

    def loss(self, params: Dict, batch: Dict, *, use_pallas: bool = True):
        """Mean token cross-entropy (+ aux). Under training rules it is
        vocab-parallel on the rank's block of the logits
        (``_ce_parallel``), never gathered whole."""
        rules = get_logical_rules()
        if rules is None or rules.serve:
            logits, aux = self.apply(params, batch, use_pallas=use_pallas)
            ce = _ce(logits, batch["labels"])
        else:
            logits, aux, v0 = self._forward(params, batch, use_pallas,
                                            False)
            ce = _ce_parallel(logits, batch["labels"], v0, rules,
                              self._vocab_split(params))
        return ce + aux, {"ce": ce, "aux": aux}

    # ------------------------------------------------------------ inference
    def cache_len_for(self, seq_len: int, window: Optional[int]) -> int:
        return min(seq_len, window) if window else seq_len

    def prefill(self, params: Dict, batch: Dict, *,
                cache_len: Optional[int] = None,
                window: Optional[int] = None, use_pallas: bool = True):
        """Forward + decode cache. Returns (last-position logits
        (B,1,V), cache). S, the cache's ``t`` after prefill, counts the
        image tokens; an encoder-decoder cache carries ``enc_kv``, the
        decoder's cross K/V. Under rules, the rank's rows: (B_loc,1,V)
        logits and its block of the cache."""
        self._check_rules("prefill")
        x = self._embed(params, batch)
        S = x.shape[1]
        positions = torch.arange(S, device=x.device)[None]
        enc_kv = self._enc_kv(params, batch)
        x, caches, _ = tfm.stack_full(params["stack"], x, self.cfg,
                                      positions=positions, window=window,
                                      build_cache=True, enc_kv=enc_kv,
                                      use_pallas=use_pallas)
        logits = self._head(params, x[:, -1:])
        cache_len = cache_len or self.cache_len_for(S, window)
        cache = self._assemble_cache(caches, S, cache_len)
        if enc_kv is not None:
            cache["enc_kv"] = enc_kv
        return logits, cache

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

    def init_cache(self, B: int, cache_len: int, *, device,
                   quant_kv: bool = False) -> Dict:
        """Empty decode cache (serving from scratch). ``quant_kv`` stores
        the GQA caches' K and V in int8 with f16 scales; MLA and the
        recurrent states ignore it, as in the reference. Under rules,
        ``B`` is the global batch and the cache the rank's block of it
        (``sharding.spec.cache_shardings``: the rows over the data axes
        where B divides them, else each leaf's next dim over ``model``
        where it divides: an attention cache's time dim, an xLSTM
        state's heads or units); a Mamba2 state holds the rank's heads
        and conv channels (``ssm.init_mamba2_cache``). A Mamba2 conv
        whose taps that placement cuts (tp divides ``ssm_conv`` − 1) is
        refused (``sharding.spec.unread_seq_cut``, ROADMAP A17)."""
        self._check_rules("init_cache")
        rules = get_logical_rules()
        if rules is not None:
            return self._rank_cache(rules, B, cache_len, device, quant_kv)
        cfg, dtype = self.cfg, self.dtype
        runs = {}
        for i, (btype, n) in enumerate(tfm.segment_runs(cfg.layer_types)):
            if btype in tfm.ATTN_TYPES:
                one = (attn.init_mla_cache(cfg, B, cache_len, dtype, device)
                       if cfg.use_mla else
                       attn.init_gqa_cache(cfg, B, cache_len, dtype, device,
                                           quant=quant_kv))
            else:
                one = tfm.RECURRENT[btype][3](cfg, B, dtype, device)
            runs[f"run{i}"] = tree_map(
                lambda x: x[None].repeat((n,) + (1,) * x.dim()), one)
        return {"runs": runs,
                "t": torch.tensor(0, dtype=torch.int32, device=device),
                "positions": torch.full((cache_len,), -1, dtype=torch.int32,
                                        device=device)}

    def _rank_cache(self, rules, B: int, cache_len: int, device,
                    quant_kv: bool) -> Dict:
        """``init_cache`` under ``rules``: each leaf of the whole cache
        allocated at its block's shape (``cache_shardings``), a Mamba2
        run at the rank's heads and conv channels."""
        with logical_rules(None):
            whole = self.init_cache(B, cache_len, device="meta",
                                    quant_kv=quant_kv)
        cut = unread_seq_cut(rules.spec, rules.mesh, whole, batch_size=B)
        if cut:
            raise ValueError(refuse_seq_cut(cut))
        axes = cache_shardings(rules.spec, rules.mesh, whole, batch_size=B)
        runs = {}
        for i, (btype, n) in enumerate(tfm.segment_runs(self.cfg.layer_types)):
            key = f"run{i}"
            if btype == "mamba2":
                one = tfm.RECURRENT[btype][3](self.cfg, rules.cache_rows(B),
                                              self.dtype, device)
                runs[key] = tree_map(
                    lambda x: x[None].repeat((n,) + (1,) * x.dim()), one)
                continue
            runs[key] = tree_map(
                lambda x, a: torch.zeros(
                    local_shape(tuple(x.shape), a, rules.mesh),
                    dtype=x.dtype, device=device),
                whole["runs"][key], axes["runs"][key])
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
        Without rope, each row adds the sinusoidal embedding of its own
        position; an ``enc_kv`` in the cache passes through unchanged.
        Under rules, the rank's rows and its block of the cache.
        """
        self._check_rules("decode_step")
        t = cache["t"]
        vec = t.dim() > 0
        B = tokens.shape[0]
        W = cache["positions"].shape[-1]
        tv = t if vec else t.expand(B)
        pos = cache["positions"] if vec else cache["positions"].expand(B, W)
        slot = tv % W
        rows = torch.arange(B, device=tv.device)
        positions_buf = pos.index_put((rows, slot.long()), tv)
        x = self._tok_embed(params, tokens)
        if not self.cfg.rope_theta:
            x = x + sinusoidal_position_at(tv, self.cfg.d_model
                                           )[:, None, :].to(x.dtype)
        enc_kv = cache.get("enc_kv")
        x, runs = tfm.stack_step(params["stack"], x, self.cfg, cache["runs"],
                                 t=tv, slot=slot,
                                 positions_buf=positions_buf, window=window,
                                 enc_kv=enc_kv)
        logits = self._head(params, x)
        new_cache = {"runs": runs, "t": t + 1,
                     "positions": positions_buf if vec
                     else positions_buf[0]}
        if enc_kv is not None:
            new_cache["enc_kv"] = enc_kv
        return logits, new_cache


def moves_rows(tokens: int, d: int, v_loc: int, head: bool) -> bool:
    """Under a vocab table whose model dim d is sharded over an fsdp
    axis, whether a rank moves its fsdp group's ``tokens`` rows rather
    than gather the table's (v_loc, d) block: the rows' cost is
    tokens·d (the embedding's looked-up columns; its ids are smaller)
    or tokens·(d + 2·v_loc) (the head: its input gathered, its partial
    logits all-reduced), the table's v_loc·d. A decode step moves rows
    where its group has fewer rows than v_loc; a long prefill's
    embedding gathers the table."""
    moved = tokens * (d + 2 * v_loc) if head else tokens * d
    return moved < v_loc * d


def local_vocab(cfg: ModelConfig, rules) -> int:
    """A rank's ids of the padded vocab under ``rules``."""
    return rules.local_extent("vocab", cfg.padded_vocab)


def tp_refusal(cfg: ModelConfig, tp: int) -> Optional[str]:
    """Why tensor parallelism over a tensor axis of ``tp`` ranks does not
    run ``cfg``, or None: attention or Mamba2 heads that do not split
    into ``tp`` blocks (the reference's placement then leaves a layer's
    heads whole while it splits its other dims). The xLSTM mixers split
    no param by heads (their recurrences run whole on every rank), so
    their heads are not read."""
    heads = {}
    if set(cfg.layer_types) & set(tfm.ATTN_TYPES) or cfg.encoder_layers:
        heads["attention"] = cfg.num_heads
    if "mamba2" in cfg.layer_types:
        heads["Mamba2"] = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    for what, n in heads.items():
        if n % tp:
            return (f"{cfg.name}: its {n} {what} heads do not split over a "
                    f"tensor axis of {tp} ranks ({n} % {tp} = {n % tp})")
    return None


def refuse_seq_cut(paths) -> str:
    """The refusal of a decode cache whose Mamba2 conv taps are cut over
    the tensor axis (``sharding.spec.unread_seq_cut``)."""
    return (f"the cache leaves {list(paths)} are the Mamba2 conv's taps, "
            "cut over the tensor axis (rows that do not split over the "
            "data axes, and a tensor axis that divides ssm_conv - 1): the "
            "decode reads every tap of its channels (ROADMAP A17)")


def batch_extras(cfg: ModelConfig) -> Dict[str, tuple]:
    """The stub-frontend inputs a batch of ``cfg`` carries beside its
    tokens, {name: shape of one sequence's}, in the reference's order:
    Whisper's ``frames``, InternVL2's ``image_embeds``."""
    extras = {}
    if cfg.encoder_layers:
        extras["frames"] = (cfg.encoder_seq, cfg.d_model)
    if cfg.num_image_tokens:
        extras["image_embeds"] = (cfg.num_image_tokens, cfg.d_model)
    return extras


@functools.lru_cache(maxsize=16)
def _sinusoid_table(S: int, d: int, device: torch.device) -> torch.Tensor:
    """``sinusoidal_positions(S, d)`` on ``device``, copied there once
    (a forward pass then makes no host-to-device copy)."""
    return torch.from_numpy(sinusoidal_positions(S, d)).to(device)


def build_model(cfg: ModelConfig, dtype: torch.dtype = torch.float32
                ) -> Model:
    return Model(cfg, dtype)


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)


def _ce_parallel(logits: torch.Tensor, labels: torch.Tensor, v0: int, rules,
                 split: bool) -> torch.Tensor:
    """``_ce`` of a rank's logits block (global ids [v0, v0 + n)) under
    training rules: the shift is the max over the tensor axis
    (``max_over``, no gradient); Σexp and the label's logit, masked to
    the block, are summed over it in one ``reduce_from``. Where the
    rules split the batch rows over an fsdp axis, the mean over every
    row is the local sum reduced over that axis (``loss``) times
    f32(1/count)."""
    z = logits.float()
    if split:
        mesh, tp = rules.mesh, (rules.tp,)
        m = dist.max_over(z.max(dim=-1).values, mesh, tp)
        n = z.shape[-1]
        lab = labels.long() - v0
        mine = (lab >= 0) & (lab < n)
        ll = torch.gather(z, -1, torch.where(mine, lab, 0)[..., None])[..., 0]
        se = torch.exp(z - m[..., None]).sum(dim=-1)
        both = dist.reduce_from(torch.stack([se, ll * mine.to(z.dtype)]),
                                mesh, tp, role="vocab")
        tok = torch.log(both[0]) + m - both[1]
    else:
        lse = torch.logsumexp(z, dim=-1)
        tok = lse - torch.gather(z, -1, labels.long()[..., None])[..., 0]
    rows = rules.map["batch"]
    if rules.size(rows) > 1:
        total = dist.reduce_from(tok.sum(), rules.mesh, entry_axes(rows),
                                 role="loss")
        return total * reciprocal(tok.numel() * rules.size(rows))
    return torch.mean(tok)
