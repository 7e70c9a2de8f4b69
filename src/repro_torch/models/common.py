"""Shared model building blocks: inits, norms, activations, rope and
sinusoidal positions. Port of ``repro/models/common.py``.

Every block exposes ``init_*(gen, cfg, dtype) -> params`` and a pure
``apply``-style function over a nested dict of tensors, as the reference
does over pytrees. Weights are drawn from a ``torch.Generator`` on the
generator's device: same distributions as the reference's ``jax.random``
draws, other bits, so parity tests carry the reference's params across
(``repro_torch.interop``). Under fake tensors (the dry run's
``FakeTensorMode``) an init draws nothing and returns a tensor of the
shape and dtype alone, as the reference's ``jax.eval_shape`` of its
init does.

Logical sharding rules (``set_logical_rules``, ``logical_rules``): a
launcher installs a ``repro_torch.sharding.spec.LogicalRules`` and the
model functions then run one rank's share of a tensor-parallel step on
its local params (every arch; ``models.model.tp_refusal`` refuses heads
that do not split over the tensor axis).
Where the reference's ``shard_logical`` is a constraint that GSPMD
turns into collectives, the port's checks that a tensor's local shape
is what the rules give and raises if not; the collectives sit where the
math needs them (``tp_reduce``, ``tp_gather``, ``tp_sum``,
``fsdp_gather``), each through ``repro_torch.sharding.dist``'s recorded
ops. With no rules installed
every model function runs as it does on one card. Under training rules
(``serve=False``) the same code differentiates: the collectives are
``repro_torch.sharding.dist``'s differentiable operators, and a
replicated tensor enters a rank's block of a layer through ``tp_enter``
(Megatron's f). The reference's scan-unroll switch has no meaning in
eager mode (every layer runs and is counted). Its remat switch
(``set_remat``/``remat_on``/``remat_blocks``) is ported: with it on,
``transformer.stack_full`` runs each block through ``remat_call``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import is_fake

from repro_torch.sharding import dist
from repro_torch.sharding.spec import entry_axes


# ---------------------------------------------------------------------------
# Logical sharding rules
# ---------------------------------------------------------------------------
_tls = threading.local()


def set_logical_rules(rules) -> None:
    _tls.rules = rules


def get_logical_rules():
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def logical_rules(rules):
    prev = get_logical_rules()
    set_logical_rules(rules)
    try:
        yield
    finally:
        set_logical_rules(prev)


def shard_logical(x: torch.Tensor, names: Tuple[Optional[str], ...],
                  dims: Tuple[Optional[int], ...]) -> torch.Tensor:
    """Check that ``x`` (local) has the shape the installed rules give a
    tensor of global ``dims`` (None: not checked) with logical axes
    ``names``; returns ``x``. A no-op without rules."""
    rules = get_logical_rules()
    if rules is None:
        return x
    want = rules.expected(names, dims)
    got = tuple(x.shape)
    if len(want) != len(got) or any(w is not None and w != g
                                    for w, g in zip(want, got)):
        raise ValueError(f"local shape {got} of a {names} tensor is not "
                         f"the rules' {want} (global {tuple(dims)})")
    return x


def _tp_live(rules) -> bool:
    return rules is not None and rules.size(rules.tp) > 1


def tp_reduce(x: torch.Tensor, role: str = "tp_reduce") -> torch.Tensor:
    """The sum of ``x``'s partial sums over the tensor axis of the
    installed rules (Megatron's g: identity backward)."""
    rules = get_logical_rules()
    return dist.reduce_from(x, rules.mesh, (rules.tp,), role=role)


def tp_gather(x: torch.Tensor, dim: int, role: str) -> torch.Tensor:
    """The tensor axis's blocks of ``x`` concatenated along ``dim``."""
    rules = get_logical_rules()
    return dist.gather_from(x, rules.mesh, (rules.tp,), dim, role=role,
                            bwd_role=role)


def tp_enter(x: torch.Tensor) -> torch.Tensor:
    """``x``, replicated over the tensor axis, as it enters the rank's
    block of a tensor-parallel layer, or a replicated param as it enters
    a read of only its rank's part (Megatron's f: the gradient, a
    partial sum on each rank, is summed over the axis, ``tp_grad``).
    The caller applies it only where the rank's work is a block of the
    layer's. ``x`` itself without training rules (serving computes no
    gradient) or with a tensor axis of size 1."""
    rules = get_logical_rules()
    if not _tp_live(rules) or rules.serve:
        return x
    return dist.copy_to(x, rules.mesh, (rules.tp,), role="tp_grad")


def tp_sum(x: torch.Tensor, role: str) -> torch.Tensor:
    """The sum of ``x``'s partial sums over the tensor axis where every
    rank's block of a layer reads the whole sum (a norm's statistics
    over channels split by rank): under training rules its gradient, a
    partial sum on each rank, is summed over the axis too (Megatron's g,
    then f; both recorded with ``role``)."""
    rules = get_logical_rules()
    y = dist.reduce_from(x, rules.mesh, (rules.tp,), role=role)
    if _tp_live(rules) and not rules.serve:
        y = dist.copy_to(y, rules.mesh, (rules.tp,), role=role)
    return y


def tp_index() -> int:
    """This rank's index on the tensor axis (0 without rules)."""
    rules = get_logical_rules()
    return rules.index(rules.tp) if rules is not None else 0


def fsdp_gather(x: torch.Tensor, axes: tuple) -> torch.Tensor:
    """``x`` with every dim its placement ``axes`` shards over a
    non-tensor axis (an fsdp dim) gathered whole: the ZeRO-3 gather at
    use, whose backward reduce-scatters the gradient
    (``fsdp_scatter``). Returns ``x`` itself when no dim is so
    sharded."""
    rules = get_logical_rules()
    for dim, entry in enumerate(axes):
        ax = tuple(a for a in entry_axes(entry) if a != rules.tp)
        if ax:
            x = dist.gather_from(x, rules.mesh, ax, dim)
    return x


def fsdp_gather_tree(tree, axes):
    """``fsdp_gather`` over every leaf of a nested dict and its
    placement tree (the same keys)."""
    if isinstance(tree, dict):
        return {k: fsdp_gather_tree(v, axes[k]) for k, v in tree.items()}
    return fsdp_gather(tree, axes)


# ---------------------------------------------------------------------------
# Per-block rematerialisation (the reference's remat switch)
# ---------------------------------------------------------------------------
def set_remat(flag: bool) -> None:
    _tls.remat = bool(flag)


def remat_on() -> bool:
    return getattr(_tls, "remat", False)


@contextlib.contextmanager
def remat_blocks(flag: bool = True):
    """Per-block activation checkpointing while the context is open:
    ``transformer.stack_full`` keeps only each block's inputs and
    recomputes its internals in the backward pass."""
    prev = remat_on()
    set_remat(flag)
    try:
        yield
    finally:
        set_remat(prev)


class _Remat(torch.autograd.Function):
    """``fn(*leaves)`` whose backward recomputes it through
    ``torch.func.vjp``: only the inputs are saved. ``generate_vmap_rule``
    lets ``torch.func.vmap`` batch both passes (``torch.utils.checkpoint``
    fails under ``torch.func``). The backward runs under the rules that
    were installed at the forward (a CUDA backward runs on autograd's
    own thread, which has none), and the recomputed block's collectives
    run again there, recorded as backward."""
    generate_vmap_rule = True

    @staticmethod
    def forward(fn, rules, *leaves):
        return fn(*leaves)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.fn, ctx.rules = inputs[0], inputs[1]
        ctx.save_for_backward(*inputs[2:])

    @staticmethod
    def backward(ctx, *gs):
        from repro_torch.sharding import hlo
        with logical_rules(ctx.rules), hlo.backward_pass():
            out, pull = torch.func.vjp(ctx.fn, *ctx.saved_tensors)
            return (None, None) + tuple(pull(gs if isinstance(out, tuple)
                                             else gs[0]))


def remat_call(fn, *leaves: torch.Tensor):
    """``fn(*leaves)`` (a tensor or a tuple of tensors),
    rematerialised in backward."""
    return _Remat.apply(fn, get_logical_rules(), *leaves)


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------
def _trunc_normal(gen: torch.Generator, shape: Sequence[int]) -> torch.Tensor:
    """Standard normal truncated to [−2, 2], f32, on ``gen``'s device."""
    w = torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)
    if is_fake(w):   # shapes only: the draw loops on its values
        return w
    torch.nn.init.trunc_normal_(w, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return w


def dense_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32,
               fan_in: Optional[int] = None) -> torch.Tensor:
    """Truncated normal on [−2σ, 2σ] with σ = 1/sqrt(fan_in) (fan_in =
    shape[0] by default), drawn on ``gen``'s device. The draw is scaled
    in place: one f32 copy at a time (DeepSeek-V3's expert stacks are
    15 GB each in f32), the same bits as an out-of-place product."""
    fan = fan_in if fan_in is not None else shape[0]
    std = 1.0 / math.sqrt(max(1, fan))
    return _trunc_normal(gen, shape).mul_(std).to(dtype)


def embed_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return _trunc_normal(gen, shape).mul_(0.02).to(dtype)


def zeros_init(gen: torch.Generator, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)


def ones_init(gen: torch.Generator, shape: Sequence[int],
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=gen.device)


# ---------------------------------------------------------------------------
# Norms / activations
# ---------------------------------------------------------------------------
def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * scale


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return y.to(dt) * scale + bias


def init_norm(gen: torch.Generator, cfg, dtype: torch.dtype,
              d: Optional[int] = None) -> dict:
    d = d or cfg.d_model
    if cfg.norm_variant == "layernorm":
        return {"scale": ones_init(gen, (d,), dtype),
                "bias": zeros_init(gen, (d,), dtype)}
    return {"scale": ones_init(gen, (d,), dtype)}


def apply_norm(params: dict, x: torch.Tensor, cfg) -> torch.Tensor:
    if "bias" in params:
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate) * up


# ---------------------------------------------------------------------------
# Rotary embeddings (half-split form: x1, x2 = the two halves of hd)
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    hd = x.shape[-1]
    freqs = torch.from_numpy(rope_freqs(hd, theta)).to(x.device)   # (hd/2,)
    angles = positions[..., None].float() * freqs        # (..., S, hd/2)
    angles = angles[..., None, :]                        # (..., S, 1, hd/2)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Absolute sinusoidal positions (Whisper). Two routes, as in the reference:
# the full-sequence table in numpy f64 rounded to f32 once, and one
# position a row computed in f32 on the device for decode. They differ in
# their last bits.
# ---------------------------------------------------------------------------
def sinusoidal_position_at(t: torch.Tensor, d: int) -> torch.Tensor:
    """t: (...) positions -> (..., d) f32 embeddings: sin at even
    channels, cos at odd, computed in f32."""
    i = torch.arange(d // 2, dtype=torch.float32, device=t.device)
    angle = t.float()[..., None] / torch.pow(10000.0, 2 * i / d)
    return torch.stack([torch.sin(angle), torch.cos(angle)],
                       dim=-1).reshape(*t.shape, d)


def sinusoidal_positions(num_pos: int, d: int) -> np.ndarray:
    """(num_pos, d) f32 table, computed in f64."""
    pos = np.arange(num_pos)[:, None]
    i = np.arange(d // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((num_pos, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------
def tree_size(tree) -> int:
    """Number of elements over the leaves of a nested dict of tensors."""
    if isinstance(tree, dict):
        return sum(tree_size(v) for v in tree.values())
    return int(tree.numel())
