"""Continuous-batching decode engine: a fixed-slot KV-cache pool with
per-slot sequence state, flush-interval decode blocks, block-boundary
checkpoint hot swap and personalized overlays. Port of
``repro/serving/engine.py``.

  * POOL — one vectorized decode cache for S slots built from
    ``model.init_cache``: every ``runs`` leaf keeps its batch axis
    (axis 1), ``t`` is (S,) and ``positions`` (S, W). Slot s is row s of
    every leaf; ``model.decode_step`` runs each row at its own position
    and ring slot, so admitting or retiring one sequence never touches
    another row's state.
  * DECODE BLOCK — ``flush_tokens`` greedy steps, a Python loop over
    pool tensors of fixed shape (the reference fuses them into one
    ``lax.scan``). Inactive slots are kept out of the new state by
    ``_merge_cache``: their cache rows, t and last token stay bit for
    bit as they were while the active rows advance. Nothing in the block
    reads the device from the host.
  * ONE COPY PER FLUSH — the host reads the flush's (S, flush_tokens)
    token matrix of each overlay group, together with the first token of
    every request admitted in this flush, in one device-to-host copy (the
    reference's one ``device_get`` per flush).
  * ADMIT / EVICT — at flush boundaries only. Admission prefills the
    request alone (B = 1; on the card that runs the flash-attention and
    SSD kernels), with its stub-frontend inputs (``extras``: Whisper's
    frames, InternVL2's image embeddings), and copies the resulting
    cache rows into its pool row; eviction frees the host-side slot
    record (the pool row is garbage until the next admission overwrites
    it). The recurrent states (Mamba2, mLSTM, sLSTM) pool as KV caches
    do, batch on axis 1 of each run's leaves. An encoder-decoder's
    cross K/V (``enc_kv``, (layers, slots, T, KV, hd)) is made at the
    first admission that has one, written only at admission and passed
    through every decode step unchanged.
  * HOT SWAP — ``step()`` polls the
    :class:`~repro_torch.serving.registry.ModelRegistry` once per flush
    and applies a staged version before the flush's decode blocks: every
    token of a flush comes from one params version. The KV pool is kept
    across the swap (the cache holds activations keyed only by the model
    config), and the swap is gated on every leaf's shape and dtype:
    params that do not match the serving template are refused (build a
    new engine for a new architecture).
  * PERSONALIZATION — a request whose client id the
    :class:`~repro_torch.serving.personalize.PersonalizationStore` knows
    is prefilled and decoded under ``unpack(pack(params) + scale ·
    delta_c)``, kept until the next swap. Each flush groups the active
    slots by overlay, in the order the slots first show each; every
    group runs one masked decode block over the whole pool, and the one
    copy of the flush holds every group's token matrix.
  * EVENTS — with an ``EventLog``, each flush writes a ``serve_flush``
    row of host numbers (tokens, occupancy, version, swap and its stall),
    so the log adds no device read to the flush.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.flat import pack
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.utils.tree import tree_leaves, tree_map


# ---------------------------------------------------------------------------
# greedy decode (lockstep)
# ---------------------------------------------------------------------------
def greedy_decode(model, params, cache, tok, n, *, window=None):
    """n greedy decode steps on either cache form. Returns (tokens (B, n),
    cache, last token (B, 1))."""
    step = make_serve_step(model, window=window)
    toks = []
    for _ in range(n):
        tok, cache = step(params, cache, tok)
        toks.append(tok[:, 0])
    return torch.stack(toks, dim=1), cache, tok


# ---------------------------------------------------------------------------
# masked decode block (per-slot): the engine's flush interval
# ---------------------------------------------------------------------------
def _bcast(mask: torch.Tensor, ndim: int, axis: int) -> torch.Tensor:
    shape = [1] * ndim
    shape[axis] = mask.shape[0]
    return mask.reshape(shape)


def _merge_cache(active: torch.Tensor, new: Dict, old: Dict) -> Dict:
    """Keep ``new`` state only on active rows; inactive rows stay
    bit-identical to ``old`` (runs leaves carry the batch on axis 1,
    t and positions on axis 0; ``enc_kv`` is static per slot and passes
    through)."""
    out = {"runs": tree_map(
        lambda n_, o: torch.where(_bcast(active, n_.dim(), 1), n_, o),
        new["runs"], old["runs"]),
        "t": torch.where(active, new["t"], old["t"]),
        "positions": torch.where(active[:, None], new["positions"],
                                 old["positions"])}
    if "enc_kv" in new:
        out["enc_kv"] = new["enc_kv"]
    return out


def _decode_block(model, params, cache, tok, active, n, window):
    """n masked greedy steps; returns (cache, tok, tokens (S, n))."""
    step = make_serve_step(model, window=window)
    toks = []
    for _ in range(n):
        nxt, new_cache = step(params, cache, tok)
        nxt = torch.where(active[:, None], nxt, tok)
        cache = _merge_cache(active, new_cache, cache)
        tok = nxt
        toks.append(nxt[:, 0])
    return cache, tok, torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# requests
# ---------------------------------------------------------------------------
@dataclass
class Request:
    prompt: np.ndarray                 # (S,) int32 token ids
    max_new_tokens: int
    client_id: Optional[int] = None
    request_id: int = 0
    extras: Optional[Dict[str, np.ndarray]] = None  # frames/image_embeds
    submit_time: float = field(default_factory=time.time)


class Completion(NamedTuple):
    request_id: int
    tokens: np.ndarray                 # (max_new_tokens,) int32
    client_id: Optional[int]
    latency_s: float
    versions: tuple                    # params version per flush touched


class _Slot(NamedTuple):
    req: Request
    remaining: int
    out: List[int]
    overlay: Optional[int]             # personalization key (client id)
    versions: List[int]


def _leaf_specs(params) -> List[tuple]:
    """(shape, dtype) of every leaf: what a hot swap must keep."""
    return [(tuple(a.shape), str(a.dtype)) for a in tree_leaves(params)]


class DecodeEngine:
    """Fixed-slot continuous-batching greedy decode; see module doc."""

    def __init__(self, model, params, *, slots: int = 4,
                 cache_len: int = 64, flush_tokens: int = 8,
                 window: Optional[int] = None, version: int = 0,
                 registry=None, personalization=None, events=None):
        self.model = model
        self.slots = int(slots)
        self.cache_len, self.flush_tokens = int(cache_len), int(flush_tokens)
        self.window = window
        self.registry = registry
        self.store = personalization
        self.events = events
        self._params = params
        self._shapes = _leaf_specs(params)
        self._params_flat = None       # packed lazily (personalization)
        self._overlays: Dict[int, Any] = {}
        self.version = int(version)
        self.device = tree_leaves(params)[0].device
        self._ids = itertools.count()
        self.queue: List[Request] = []
        self._slots: List[Optional[_Slot]] = [None] * self.slots
        self.pool = self._init_pool()
        self._tok = torch.zeros((self.slots, 1), dtype=torch.long,
                                device=self.device)
        self._prefill = make_prefill_step(model, window=window,
                                          cache_len=self.cache_len)
        self.history: List[dict] = []
        self.completed: List[Completion] = []
        self.stats = {"tokens": 0, "flushes": 0, "occupancy_sum": 0.0,
                      "swaps": 0, "swap_stalls": [], "kv_reuse_swaps": 0,
                      "admitted": 0, "completed": 0}
        if self.registry is not None:
            staged = self.registry.poll()   # initial version, if any
            if staged is not None:
                self._params = staged.params
                self._params_flat = None
                self.version = staged.step

    # --------------------------------------------------------------- pool
    def _init_pool(self) -> Dict:
        cache = self.model.init_cache(self.slots, self.cache_len,
                                      device=self.device)
        cache["t"] = torch.zeros((self.slots,), dtype=torch.int32,
                                 device=self.device)
        cache["positions"] = torch.full((self.slots, self.cache_len), -1,
                                        dtype=torch.int32,
                                        device=self.device)
        return cache

    def _insert(self, c1: Dict, tok0: torch.Tensor, s: int) -> None:
        """Copy a B = 1 prefill cache into pool row s, in place."""
        for key in ("runs", "enc_kv"):
            if key in c1:
                tree_map(lambda pl, cl: pl[:, s].copy_(cl[:, 0]),
                         self.pool[key], c1[key])
        self.pool["t"][s] = c1["t"]
        self.pool["positions"][s] = c1["positions"]
        self._tok[s] = tok0[0]

    # ------------------------------------------------------------ params
    def _client_params(self, overlay_key):
        if overlay_key is None:
            return self._params
        if overlay_key not in self._overlays:
            if self._params_flat is None:
                self._params_flat = pack(self._params, self.store.layout)
            self._overlays[overlay_key] = self.store.overlay(
                self._params_flat, overlay_key)
        return self._overlays[overlay_key]

    def swap(self, params, step: int, *, seen_at: Optional[float] = None
             ) -> float:
        """Hot-swap the serving params at this block boundary; returns the
        stall (seconds from ``seen_at``). Gated on the template: the new
        tree must match it leaf for leaf (shape and dtype), the condition
        under which the in-flight KV pool stays valid and is kept."""
        if _leaf_specs(params) != self._shapes:
            raise ValueError(
                "hot-swap refused: new params do not match the serving "
                "template's shapes/dtypes — the KV pool cannot be "
                "reused across an architecture change; build a new "
                "DecodeEngine")
        self._params = params
        self._params_flat = None
        self._overlays.clear()
        self.version = int(step)
        self.stats["swaps"] += 1
        if any(s is not None for s in self._slots):
            self.stats["kv_reuse_swaps"] += 1
        stall = (time.time() - seen_at) if seen_at is not None else 0.0
        self.stats["swap_stalls"].append(stall)
        return stall

    # ------------------------------------------------------------ submit
    def submit(self, prompt, max_new_tokens: int, *, client_id=None,
               extras: Optional[Dict[str, np.ndarray]] = None) -> int:
        """Queue a request; ``client_id`` picks a personalized overlay
        (an id the store does not know decodes under the global params);
        ``extras`` holds its stub-frontend inputs without a batch axis.
        Its image tokens count in the cache."""
        prompt = np.asarray(prompt, np.int32)
        if prompt.ndim != 1:
            raise ValueError(f"prompt must be (S,), got {prompt.shape}")
        need = (prompt.shape[0] + max_new_tokens
                + (self.model.cfg.num_image_tokens or 0))
        if self.window is None and need > self.cache_len:
            raise ValueError(
                f"request needs {need} cache entries > pool cache_len "
                f"{self.cache_len} (pass a sliding window to roll)")
        rid = next(self._ids)
        self.queue.append(Request(prompt=prompt,
                                  max_new_tokens=int(max_new_tokens),
                                  client_id=client_id, request_id=rid,
                                  extras=extras))
        return rid

    # ------------------------------------------------------------- admit
    def _admit(self) -> List[tuple]:
        """Prefill queued requests into free slots, each under its own
        overlay's params. Returns (slot index or None, slot record, first
        token on the device) per admission; a request of one token
        completes here (slot index None)."""
        admitted = []
        for s in range(self.slots):
            if not self.queue:
                break
            if self._slots[s] is not None:
                continue
            req = self.queue.pop(0)
            overlay = (req.client_id
                       if (self.store is not None
                           and self.store.has(req.client_id)) else None)
            batch = {k: torch.from_numpy(np.asarray(v)[None]).to(self.device)
                     for k, v in {"tokens": req.prompt,
                                  **(req.extras or {})}.items()}
            logits, c1 = self._prefill(self._client_params(overlay), batch)
            tok0 = torch.argmax(logits[:, -1:], dim=-1)
            if "enc_kv" in c1 and "enc_kv" not in self.pool:
                self.pool["enc_kv"] = tree_map(
                    lambda e: torch.zeros((e.shape[0], self.slots)
                                          + e.shape[2:], dtype=e.dtype,
                                          device=e.device), c1["enc_kv"])
            self._insert(c1, tok0, s)
            slot = _Slot(req=req, remaining=req.max_new_tokens - 1, out=[],
                         overlay=overlay, versions=[self.version])
            self.stats["admitted"] += 1
            if slot.remaining == 0:
                admitted.append((None, slot, tok0))
            else:
                self._slots[s] = slot
                admitted.append((s, slot, tok0))
        return admitted

    def _finish_slot(self, slot: _Slot) -> Completion:
        self.stats["completed"] += 1
        c = Completion(request_id=slot.req.request_id,
                       tokens=np.asarray(slot.out, np.int32),
                       client_id=slot.req.client_id,
                       latency_s=time.time() - slot.req.submit_time,
                       versions=tuple(dict.fromkeys(slot.versions)))
        self.completed.append(c)
        return c

    # -------------------------------------------------------------- step
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self._slots)

    def step(self) -> List[Completion]:
        """One flush interval: swap (if staged) -> admit -> one masked
        decode block per overlay group -> ONE device-to-host copy ->
        harvest. Returns the requests completed this flush."""
        completions: List[Completion] = []
        swapped, stall = 0, 0.0
        if self.registry is not None:
            staged = self.registry.poll()
            if staged is not None:
                stall = self.swap(staged.params, staged.step,
                                  seen_at=staged.seen_at)
                swapped = 1
        admitted = self._admit()
        groups: Dict[Optional[int], List[int]] = {}
        for s, sl in enumerate(self._slots):
            if sl is not None:
                groups.setdefault(sl.overlay, []).append(s)
        parts = [tok0.reshape(1) for _, _, tok0 in admitted]
        for key, idxs in groups.items():
            act = torch.zeros((self.slots,), dtype=torch.bool)
            act[idxs] = True
            self.pool, self._tok, toks = _decode_block(
                self.model, self._client_params(key), self.pool, self._tok,
                act.to(self.device), self.flush_tokens, self.window)
            parts.append(toks.reshape(-1))
        host = (torch.cat(parts).cpu().numpy() if parts     # the ONE copy
                else np.zeros((0,), np.int64))
        for k, (s, slot, _) in enumerate(admitted):
            slot.out.append(int(host[k]))
            if s is None:
                completions.append(self._finish_slot(slot))
        mats = host[len(admitted):].reshape(len(groups), self.slots,
                                           self.flush_tokens)
        emitted = 0
        for idxs, mat in zip(groups.values(), mats):
            for s in idxs:
                sl = self._slots[s]
                take = min(sl.remaining, self.flush_tokens)
                sl.out.extend(int(x) for x in mat[s, :take])
                sl.versions.append(self.version)
                emitted += take
                sl = sl._replace(remaining=sl.remaining - take)
                self._slots[s] = sl
                if sl.remaining == 0:
                    self._slots[s] = None
                    completions.append(self._finish_slot(sl))
        occ = sum(len(v) for v in groups.values()) / self.slots
        self.stats["tokens"] += emitted
        self.stats["flushes"] += 1
        self.stats["occupancy_sum"] += occ
        self.history.append({"flush": self.stats["flushes"] - 1,
                             "version": self.version,
                             "groups": {k: list(v)
                                        for k, v in groups.items()},
                             "swapped": swapped, "swap_stall_s": stall,
                             "tokens": emitted, "occupancy": occ})
        if self.events is not None:
            self.events.emit("serve_flush",
                             t=self.stats["flushes"] - 1,
                             serve_tokens=emitted, serve_occupancy=occ,
                             serve_version=self.version,
                             serve_swapped=swapped,
                             serve_swap_stall_s=stall)
            self.events.flush()
        return completions

    def run_until_idle(self, max_flushes: int = 100_000
                       ) -> List[Completion]:
        out: List[Completion] = []
        while self.has_work():
            out.extend(self.step())
            if self.stats["flushes"] >= max_flushes:
                raise RuntimeError("run_until_idle: flush budget "
                                   "exhausted with work pending")
        return out

    # ------------------------------------------------------------ report
    def metrics(self) -> dict:
        f = max(1, self.stats["flushes"])
        stalls = self.stats["swap_stalls"]
        return {"serve_tokens_total": self.stats["tokens"],
                "serve_occupancy_mean": self.stats["occupancy_sum"] / f,
                "serve_swaps_total": self.stats["swaps"],
                "serve_swap_stall_mean": (float(np.mean(stalls))
                                          if stalls else 0.0),
                "serve_swap_stall_max": (float(np.max(stalls))
                                         if stalls else 0.0),
                "kv_reuse_swaps": self.stats["kv_reuse_swaps"],
                "requests_completed": self.stats["completed"]}
