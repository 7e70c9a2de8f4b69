"""Dry run of the training and serving programs on the H100 production
mesh: one rank's federated round, prefill or decode step of an (arch ×
input shape × mesh), run on fake tensors under the abstract mesh
(``launch/mesh.py``) and the ``LogicalRules`` (``serve=False`` for
training), with no process group and no allocation on any device. Port
of ``repro/launch/dryrun.py``: it proves the placement rules and the
tensor-parallel model code agree at full size, and writes the
reference's JSON fields with the roofline terms of the counted work
(``repro_torch.roofline``: FLOPs, the forward, backward and remat's
recompute included; bytes; collectives by role).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --scenario-smoke

``train_4k`` runs ``make_train_step``'s vmap round (remat on, K = 2,
bf16) with the Δ-SGD client, the state placed by
``launch.steps.state_placements`` (the reference's ``_state_shardings``)
and the batch by ``batch_shardings``. The dense GQA decoders
(TinyLlama-1.1B, CodeQwen1.5-7B, Qwen2.5-14B, Granite-20B), the MoE
ones (OLMoE-1B-7B; DeepSeek-V3-671B with MLA and its MTP block: 8 and
32 experts a rank on the single pod, 2 and 16 heads) and Zamba2-7B (14
Mamba2 heads and 4 shared-block heads a rank) run at ``train_4k``,
``prefill_32k`` and ``decode_32k``; an expert GEMM counts E/tp·C·D·F,
C the capacity of the global batch. Serving lowers on the plain route
(``use_pallas=False``), so the SSD scan's work is counted (a ctypes
kernel's launch is not a torch op). A decode cache is the rank's block
as ``launch.steps.place_for_rank`` cuts it (a Mamba2 state narrowed
to the rank's heads). xLSTM-1.3B runs its three shapes with its
recurrences whole on every rank. ``long_500k`` (one row, its 8,192-slot
window; the xLSTM states) lowers one decode step on a cache whose time
dim, or xLSTM state, the placement cuts over ``model``: every arch of
the zoo has a sliding window or a recurrent mixer, as the reference's
long-context rule asks. Refused, each naming why: Whisper's 6 and
InternVL2's 14 heads (they do not split over 8 ranks), and a global
batch of more than one row that does not split over the mesh's data
axes. ``--all`` lists refusals apart from failures.

The sLSTM's time loop is a Python loop of one cell a token: 32,768
tokens × 12 layers would dispatch about 10⁷ ops on fake tensors. An
xLSTM prefill or round is therefore counted at three points and its
work extrapolated to the shape's length (``_lower_scaled``): at two
lengths, two and three of the mLSTM's chunks (``seq_counts``), with the
sLSTM loop cut to its first ``CELL_COUNTS[0]`` cells
(``models.ssm.counted_cells``), and at the first length with
``CELL_COUNTS[1]`` cells. From two chunks on the program is affine in S
(every op is per token or per chunk, and the collectives' count does not
depend on S; at one chunk a reshape of size-1 dims is free, and the
count lies off the line) and, apart from that, affine in the cells the
loop runs (the loop makes no collective), so the three counts fix it at
S tokens and S cells exactly; ``tests/test_torch_tp_xlstm.py`` holds
the extrapolation to the full count at a third length.

``--scenario-smoke`` runs the reference's CI leg of sharded flat rounds
(``scenario_smoke``) for real, on 8 gloo CPU ranks.

``memory`` holds the argument and output bytes of one rank by the
placements; eager mode has no buffer assignment, so there is no
``temp`` (the reference's ``temp_size_in_bytes``): ``analytic_memory``
is the capacity-planning number, as in the reference.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import roofline
from repro_torch.configs import ARCH_IDS, INPUT_SHAPES, FLConfig, get_config
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.specs import (decode_specs, decode_window,
                                      federation_kind, param_count,
                                      params_struct, prefill_specs,
                                      train_specs)
from repro_torch.launch.steps import (abstract_fl_state, make_prefill_step,
                                      make_serve_step, make_train_step,
                                      place_for_rank, serve_rules,
                                      state_placements, train_rules)
from repro_torch.models.common import logical_rules
from repro_torch.models.model import build_model, tp_refusal
from repro_torch.sharding import dist
from repro_torch.sharding.spec import (batch_shardings, cache_shardings,
                                       get_federation_spec, local_shape,
                                       mesh_shape, param_placements,
                                       serve_batch_shardings, shard_bytes)
from repro_torch.utils.tree import tree_leaves, tree_map


class Refused(ValueError):
    """A program the port does not lower yet (its ROADMAP item named)."""


def analytic_memory(cfg, shape, spec, mesh, pstruct, param_sh, fl,
                    cache_struct=None, cache_sh=None):
    """Remat-aware per-device HBM estimate (bytes), the reference's
    arithmetic: live set = params/opt + per-layer residual saves + one
    block's internals + logits."""
    sizes = mesh_shape(mesh)
    tp = sizes.get(spec.tp_axes[0], 1) if spec.tp_axes else 1
    fsdp = 1
    for a in spec.fsdp_axes:
        fsdp *= sizes[a]
    pdev = shard_bytes(pstruct, param_sh, mesh)
    D, L = cfg.d_model, cfg.num_layers
    Vt = cfg.padded_vocab // tp if cfg.padded_vocab % tp == 0 \
        else cfg.padded_vocab
    out = {"params_dev": pdev}
    if shape.kind == "train":
        C = spec.clients_on(mesh)
        b = max(1, shape.global_batch // C)
        tok = b * shape.seq_len // fsdp
        resid = L * tok * D * 2
        att = 3 * (shape.seq_len // 8) * shape.seq_len \
            * max(1, cfg.num_heads // tp) * 4 * b // fsdp
        blk = att
        if cfg.num_experts:
            cap = max(4, int(tok * cfg.num_experts_per_tok * 1.25
                             / cfg.num_experts))
            blk = max(blk, 3 * (cfg.num_experts // max(1, tp)) * cap * D * 2)
        logits = 2 * tok * Vt * 4
        opt_copies = 4 if fl.client_opt == "delta_sgd" else 3
        out.update(residuals=resid, block_peak=blk, logits=logits,
                   total=pdev * opt_copies + resid + blk + logits)
    elif shape.kind == "prefill":
        tp_axis = spec.tp_axes[0] if spec.tp_axes else ""
        data = 1
        for a, n in sizes.items():
            if a != tp_axis:
                data *= n
        bloc = max(1, shape.global_batch // data)
        cache = (shard_bytes(cache_struct, cache_sh, mesh) if cache_struct
                 else L * bloc * shape.seq_len * cfg.num_kv_heads
                 * cfg.head_dim * 2 * 2)
        att = 3 * (shape.seq_len // 8) * shape.seq_len \
            * max(1, cfg.num_heads // tp) * 4 * bloc
        out.update(cache=cache, block_peak=att,
                   total=pdev + cache + att + bloc * Vt * 4)
    else:
        cache = (shard_bytes(cache_struct, cache_sh, mesh) if cache_struct
                 else 0)
        out.update(cache=cache, total=pdev + cache + shape.global_batch
                   * Vt * 4)
    return out


def check_lowerable(arch: str, shape_id: str, multi_pod: bool) -> None:
    """Raise ``Refused`` for a program the port does not lower yet."""
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_id]
    sizes = production_shape(multi_pod)
    why = tp_refusal(cfg, sizes["model"])
    if why:
        raise Refused(why)
    d = sizes.get("pod", 1) * sizes["data"]
    if shape.kind != "train" and shape.global_batch > 1 \
            and shape.global_batch % d:
        raise Refused(f"{shape_id}: its global batch {shape.global_batch} "
                      f"does not split over the {d} data ranks of this "
                      "mesh (the H100 mesh keeps 8 GPUs a host on model)")


def _local(tree, axes, mesh):
    """Fake tensors of the rank's block shapes of ``tree``."""
    return tree_map(lambda x, a: x.new_empty(local_shape(tuple(x.shape), a,
                                                         mesh)),
                    tree, axes)


def _local_state(state, axes, mesh):
    """The rank's ``FLState`` of fake blocks."""
    fields = []
    for x, ax in zip(state, axes):
        if x is None or isinstance(x, int):
            fields.append(x)
        elif isinstance(x, tuple):      # the async buffer's NamedTuple
            fields.append(type(x)(*(_local(a, b, mesh)
                                    for a, b in zip(x, ax))))
        else:
            fields.append(_local(x, ax, mesh))
    return type(state)(*fields)


def _state_bytes(state, axes, mesh) -> int:
    total = 0
    for x, ax in zip(state, axes):
        if x is None or isinstance(x, int):
            continue
        parts = zip(x, ax) if isinstance(x, tuple) else [(x, ax)]
        total += sum(shard_bytes(a, b, mesh) for a, b in parts)
    return total


def _lower_train(model, shape, fl, mesh, spec, mode, *, remat: bool,
                 use_pallas: bool, seq: int = None, flat_fed: bool = False,
                 flat_sharded: bool = False, scenario=None, compression=None,
                 rounds_per_call: int = 1):
    """One rank's round on fake blocks, counted (its batches ``seq``
    tokens long, the shape's by default): ``make_train_step``'s vmap
    round; with ``flat_fed`` the flat engine off the mesh (N whole on the
    rank's clients: the rank's (C_loc, K, b_loc) rows, each client's
    model whole, no rules); with ``flat_sharded`` too the sharded flat
    round on the rank's tensor-parallel blocks (``core.sharded``) under
    the training rules, ``rounds_per_call`` > 1 its fused block
    (``make_train_loop``). ``scenario`` and ``compression`` reach the
    flat rounds. Returns (work, memory fields, analytic memory)."""
    cfg = model.cfg
    C = spec.clients_on(mesh)
    sizes = mesh_shape(mesh)
    if flat_fed:
        return _lower_flat(model, shape, fl, mesh, spec, mode, remat=remat,
                           use_pallas=use_pallas, seq=seq,
                           sharded=flat_sharded, scenario=scenario,
                           compression=compression,
                           rounds_per_call=rounds_per_call)
    step, sopt, scn, comp = make_train_step(model, fl, use_pallas=use_pallas,
                                            remat=remat, flat=False)
    state = abstract_fl_state(model, sopt, scn, comp, C, mode=mode)
    batch = train_specs(model, _at(shape, seq), fl, C, mode)
    rules = train_rules(model, mesh, state.params, spec=spec,
                        coords={a: 0 for a in sizes})
    state_sh = state_placements(spec, mesh, state, rules.param_axes)
    batch_sh = batch_shardings(spec, mesh, batch)
    with mode:
        args = (_local_state(state, state_sh, mesh),
                _local(batch, batch_sh, mesh))
        with roofline.count_work() as work, logical_rules(rules):
            out_state, metrics = step(*args)
    mem = {"argument_size_in_bytes": _state_bytes(state, state_sh, mesh)
           + shard_bytes(batch, batch_sh, mesh),
           "output_size_in_bytes": _nbytes({
               "params": out_state.params,
               "server_state": out_state.server_state,
               "metrics": metrics})}
    analytic = analytic_memory(cfg, shape, spec, mesh, state.params,
                               rules.param_axes, fl)
    return work, mem, analytic


def _lower_flat(model, shape, fl, mesh, spec, mode, *, remat, use_pallas,
                seq, sharded, scenario, compression, rounds_per_call):
    """``_lower_train``'s flat rounds (its docstring). The quorum test
    reads the survivor count on the host, which a fake tensor cannot
    give: on fake tensors the round counts the path that steps."""
    from repro_torch.core import init_fl_state
    from repro_torch.core import flat as flatlib
    from repro_torch.core.fed_loop import FlatFLState
    from repro_torch.launch.steps import make_train_loop
    cfg = model.cfg
    C = spec.clients_on(mesh)
    sizes = mesh_shape(mesh)
    R = max(1, int(rounds_per_call))
    pstruct = params_struct(model, mode)
    rules = train_rules(model, mesh, pstruct, spec=spec,
                        coords={a: 0 for a in sizes})
    batch = train_specs(model, _at(shape, seq), fl, C, mode)
    batch_sh = batch_shardings(spec, mesh, batch)
    kw = dict(use_pallas=use_pallas, remat=remat, scenario=scenario,
              compression=compression)
    if sharded and R > 1:
        run, sopt, scn, comp = make_train_loop(
            model, fl, rounds_per_call=R, mesh=mesh, federation=spec, **kw)
    elif sharded:
        run, sopt, scn, comp = make_train_step(
            model, fl, flat=True, mesh=mesh, federation=spec, **kw)
    elif R > 1:
        raise ValueError("rounds_per_call > 1 on a mesh requires the "
                         "sharded flat engine (flat_sharded)")
    else:
        run, sopt, scn, comp = make_train_step(model, fl, flat=True, **kw)
    with mode:
        loc_batch = _local(batch, batch_sh, mesh)
        if sharded:
            state = init_fl_state(pstruct, sopt, scn, comp, cohort=C,
                                  mesh=mesh, federation=spec)
        else:
            C_loc = tree_leaves(loc_batch)[0].shape[0]
            state = init_fl_state(pstruct, sopt, scn, comp, cohort=C_loc)
        if R > 1:
            carry = FlatFLState(flatlib.pack(state.params, run.layout),
                                state.server_state, 0, state.buffer,
                                state.ef)
            args = (carry, tree_map(lambda x: x.new_empty((R,) + tuple(
                x.shape)), loc_batch))
        else:
            args = (state, loc_batch)
        with roofline.count_work() as work:
            with logical_rules(rules if sharded else None):
                out, metrics = run(*args)
    params_out = out.P if R > 1 else out.params
    mem = {"argument_size_in_bytes": _nbytes({
               "params": state.params, "server_state": state.server_state,
               "ef": state.ef}) + shard_bytes(batch, batch_sh, mesh) * R,
           "output_size_in_bytes": _nbytes({"params": params_out,
                                            "metrics": metrics}),
           "rounds_per_call": R}
    analytic = analytic_memory(cfg, shape, spec, mesh, pstruct,
                               rules.param_axes, fl)
    return work, mem, analytic


def _at(shape, seq):
    """``shape`` with ``seq`` tokens (itself where ``seq`` is None)."""
    return shape if seq is None else dataclasses.replace(shape,
                                                         seq_len=seq)


def seq_counts():
    """The xLSTM programs' two counted lengths: two and three of the
    mLSTM's chunks."""
    from repro_torch.models.ssm import MLSTM_CHUNK
    return 2 * MLSTM_CHUNK, 3 * MLSTM_CHUNK


# the sLSTM cells run at the counted points (``_lower_scaled``)
CELL_COUNTS = (2, 3)


def _loop_scaled(cfg, shape) -> bool:
    """A program whose sLSTM time loop is counted at three points and
    extrapolated (``_lower_scaled``)."""
    return "slstm" in cfg.layer_types and shape.kind != "decode" \
        and shape.seq_len > seq_counts()[1]


def _lower_scaled(lower, model, shape, fl, mesh, spec, mode, **kw):
    """``lower`` (``_lower_train`` or ``_lower_serve``) counted at the two
    lengths of ``seq_counts`` with the sLSTM loop cut to ``CELL_COUNTS[0]``
    cells, and at the first length with ``CELL_COUNTS[1]``, and
    extrapolated to the shape's length and as many cells: a program
    a + b·S + c·cells. FLOPs, bytes, argument and output bytes and each
    collective's bytes and shape lie on that plane (the same ops in the
    same order at the three points). The analytic memory is the
    shape's own."""
    from repro_torch.models.ssm import counted_cells
    s1, s2 = seq_counts()
    n1, n2 = CELL_COUNTS

    def count(seq, cells):
        with counted_cells(cells):
            return lower(model, shape, fl, mesh, spec, mode, seq=seq,
                         **kw)[:2]
    (w1, m1), (w2, m2), (w3, m3) = (count(s1, n1), count(s2, n1),
                                    count(s1, n2))
    S = shape.seq_len
    ks, kn = (S - s1) / (s2 - s1), (S - n1) / (n2 - n1)
    plane = lambda a, b, c: a + (b - a) * ks + (c - a) * kn
    sig = lambda w: [(o.kind, o.role, o.axes) for o in w.collectives]
    if not sig(w1) == sig(w2) == sig(w3):
        raise AssertionError("the collectives differ between the counted "
                             "points: the program is not affine in S")
    ops = [dataclasses.replace(
        a, bytes=int(round(plane(a.bytes, b.bytes, c.bytes))),
        shape=tuple(int(round(plane(x, y, z)))
                    for x, y, z in zip(a.shape, b.shape, c.shape)))
        for a, b, c in zip(w1.collectives, w2.collectives, w3.collectives)]
    work = roofline.Work(plane(w1.flops, w2.flops, w3.flops),
                         plane(w1.hbm_bytes, w2.hbm_bytes, w3.hbm_bytes),
                         ops)
    mem = {f: int(round(plane(m1[f], m2[f], m3[f])))
           for f in ("argument_size_in_bytes", "output_size_in_bytes")}
    mem["counted_at_seq"] = [s1, s2]
    mem["counted_at_cells"] = [n1, n2]
    pstruct = params_struct(model, mode)
    return work, mem, analytic_memory(
        model.cfg, shape, spec, mesh, pstruct,
        param_placements(spec, mesh, pstruct), fl)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


# the knobs of ``launch/perf.py``'s variants (the reference's
# ``_compile_step`` arguments) and the lowering they reach
TRAIN_KNOBS = ("flat_fed", "flat_sharded", "scenario", "compression",
               "rounds_per_call")
SERVE_KNOBS = ("quant_kv", "cache_seq_shard")
SWITCHES = ("softmax_bf16", "capacity", "expert_2d", "seq_shard")


def refuse_knobs(knobs) -> None:
    """Raise ``Refused`` for a knob the port does not lower, ValueError
    for one no variant has."""
    unknown = set(knobs) - set(TRAIN_KNOBS + SERVE_KNOBS + SWITCHES)
    if unknown:
        raise ValueError(f"unknown knobs {sorted(unknown)}")
    if knobs.get("seq_shard"):
        raise Refused("seq_shard: the Megatron-SP residual (the residual "
                      "stream cut over model along the sequence) is not "
                      "ported; every mixer needs its all-gather and "
                      "reduce-scatter (ROADMAP A17)")


@contextlib.contextmanager
def switches(softmax_bf16: bool = False, capacity=None):
    """The model-level switches of a variant, each restored on exit:
    ``attention.SOFTMAX_BF16`` and ``moe.CAPACITY_FACTOR``."""
    from repro_torch.models import attention, moe
    prev = attention.SOFTMAX_BF16, moe.CAPACITY_FACTOR
    attention.SOFTMAX_BF16 = bool(softmax_bf16)
    if capacity is not None:
        moe.CAPACITY_FACTOR = capacity
    try:
        yield
    finally:
        attention.SOFTMAX_BF16, moe.CAPACITY_FACTOR = prev


def count_program(cfg, shape, fl, mesh, spec, *, use_pallas: bool = False,
                  remat: bool = True, knobs=None):
    """Rank (0, ..., 0)'s program of ``cfg`` at ``shape`` on fake tensors,
    counted under a variant's ``knobs`` (``launch/perf.py``;
    ``expert_2d`` is the caller's ``spec``): a training shape's round
    (``_lower_train``), a serve shape's step (``_lower_serve``); an
    xLSTM program's sLSTM loop counted at three points
    (``_lower_scaled``). Returns (work, memory fields, analytic memory,
    rounds the work counts)."""
    knobs = dict(knobs or {})
    refuse_knobs(knobs)
    model = build_model(cfg, torch.bfloat16)
    mode = FakeTensorMode()
    if shape.kind == "train":
        lower = _lower_train
        kw = dict(remat=remat, **{k: knobs[k] for k in TRAIN_KNOBS
                                  if k in knobs})
        rounds = int(knobs.get("rounds_per_call", 1)) \
            if knobs.get("flat_sharded") else 1
    else:
        lower = _lower_serve
        kw = {k: knobs[k] for k in SERVE_KNOBS
              if k in knobs and shape.kind == "decode"}
        rounds = 1
    with switches(knobs.get("softmax_bf16", False), knobs.get("capacity")):
        if _loop_scaled(cfg, shape):
            work, mem, analytic = _lower_scaled(lower, model, shape, fl,
                                                mesh, spec, mode,
                                                use_pallas=use_pallas, **kw)
        else:
            work, mem, analytic = lower(model, shape, fl, mesh, spec, mode,
                                        use_pallas=use_pallas, **kw)
    return work, mem, analytic, rounds


def lower_one(arch: str, shape_id: str, multi_pod: bool, *,
              fl: FLConfig = None, local_steps: int = 2,
              use_pallas: bool = False, remat: bool = True,
              verbose: bool = True):
    """One (arch, shape, mesh) dry run: rank (0, ..., 0)'s step on fake
    tensors, counted. A training shape runs ``make_train_step``'s vmap
    round with ``local_steps`` Δ-SGD steps and ``remat`` (on by
    default, as the reference's). Returns the reference's result
    fields."""
    check_lowerable(arch, shape_id, multi_pod)
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_id]
    fl = fl or FLConfig(local_steps=local_steps)
    # the abstract mesh always: a dry run makes no real collective
    mesh = dist.AbstractMesh(production_shape(multi_pod))
    sizes = mesh_shape(mesh)
    chips = 1
    for n in sizes.values():
        chips *= n
    fed_kind = federation_kind(cfg)
    spec = get_federation_spec(fed_kind, mesh)
    t0 = time.time()
    work, mem, analytic, rounds = count_program(
        cfg, shape, fl, mesh, spec, use_pallas=use_pallas, remat=remat)
    mem["note"] = ("eager mode has no buffer assignment: no temp size; "
                   "see analytic_memory")
    t_lower = time.time() - t0
    rl = roofline.analyze(work, chips, rounds)
    if shape.kind == "train":
        tokens_per_step = shape.global_batch * shape.seq_len * fl.local_steps
        mf = roofline.model_flops(cfg, tokens_per_step)
    else:
        tokens_per_step = shape.global_batch * (
            shape.seq_len if shape.kind == "prefill" else 1)
        mf = roofline.model_flops(cfg, tokens_per_step) / 3.0   # 2·N·D
    total = rl.flops * chips
    result = {
        "arch": arch, "shape": shape_id,
        "mesh": "x".join(str(n) for n in sizes.values()), "chips": chips,
        "federation": fed_kind, "clients": spec.clients_on(mesh),
        "step_kind": shape.kind,
        "param_count": param_count(cfg),
        "active_param_count": param_count(cfg, active_only=True),
        "lower_s": round(t_lower, 1), "compile_s": 0.0,
        "memory": mem,
        "analytic_memory": analytic,
        "roofline": rl.summary(),
        "calibration": None,
        "collectives": {r: sum(o.role == r for o in work.collectives)
                        for r in sorted({o.role for o in work.collectives})},
        "model_flops": mf,
        "hlo_flops_total": total,
        "useful_flops_ratio": mf / total if total else 0,
    }
    if shape.kind == "train":
        result["remat"] = remat
        result["local_steps"] = fl.local_steps
    if verbose:
        print(json.dumps(result, indent=2, default=float))
    return result


def _lower_serve(model, shape, fl, mesh, spec, mode, *, use_pallas,
                 seq: int = None, quant_kv: bool = False,
                 cache_seq_shard: bool = False):
    """One rank's prefill or decode step on fake blocks, counted (a
    prompt of ``seq`` tokens, the shape's by default). A decode step
    reads the int8 cache with ``quant_kv`` and, with
    ``cache_seq_shard``, a cache whose time dim ``cache_shardings``
    also cuts over ``model`` where the rows split over the data axes.
    Returns (work, memory fields, analytic memory)."""
    cfg = model.cfg
    sizes = mesh_shape(mesh)
    pstruct = params_struct(model, mode)
    rules = serve_rules(model, mesh, pstruct, spec=spec,
                        coords={a: 0 for a in sizes},
                        batch_size=shape.global_batch)
    cache = cache_sh = None
    with mode:
        params = _local(pstruct, rules.param_axes, mesh)
        if shape.kind == "prefill":
            batch = prefill_specs(model, _at(shape, seq), mode)
            bsh = serve_batch_shardings(mesh, batch)
            args = (params, _local(batch, bsh, mesh))
            step = make_prefill_step(model, use_pallas=use_pallas,
                                     rules=rules)
            in_bytes = shard_bytes(batch, bsh, mesh)
        else:
            window = decode_window(cfg, shape)
            cache, tokens = decode_specs(model, shape, window,
                                         quant_kv=quant_kv, mode=mode)
            cache_sh = cache_shardings(spec, mesh, cache,
                                       batch_size=shape.global_batch,
                                       seq_shard=cache_seq_shard)
            tsh = serve_batch_shardings(mesh, {"t": tokens})["t"]
            local_cache = place_for_rank(
                rules, cache=cache, batch_size=shape.global_batch,
                cache_seq_shard=cache_seq_shard)["cache"]
            args = (params, local_cache,
                    tokens.new_empty(local_shape(tuple(tokens.shape), tsh,
                                                 mesh)))
            step = make_serve_step(model, window=window, rules=rules)
            in_bytes = (shard_bytes(cache, cache_sh, mesh)
                        + shard_bytes({"t": tokens}, {"t": tsh}, mesh))
        with roofline.count_work() as work:
            out = step(*args)
    pdev = shard_bytes(pstruct, rules.param_axes, mesh)
    mem = {"argument_size_in_bytes": pdev + in_bytes,
           "output_size_in_bytes": _nbytes({"out": out[0],
                                            "cache": out[1]})}
    analytic = analytic_memory(cfg, shape, spec, mesh, pstruct,
                               rules.param_axes, fl, cache, cache_sh)
    return work, mem, analytic


# ---------------------------------------------------------------------------
# --scenario-smoke: the reference's CI leg of sharded flat rounds
# ---------------------------------------------------------------------------
SMOKE_MESH = ((4, 2), ("data", "model"))
SMOKE_SEQ, SMOKE_BATCH = 256, 8


def _smoke_variants():
    """(name, scenario, compression, rounds a call, clients a client
    shard) of the reference's five variants."""
    from repro_torch.compression import CompressionSpec
    from repro_torch.federation import get_scenario
    faults = get_scenario("dirichlet_dropouts", robust_agg="trimmed",
                          quorum=2, byzantine_rate=0.1)
    ef = CompressionSpec(kind="int8", error_feedback=True)
    return (("flat_fed_hetero", "dirichlet_stragglers", None, 1, 1),
            ("flat_fed_async", "zipf_async", None, 1, 1),
            ("flat_fed_compressed", "bandwidth_tiered", ef, 1, 2),
            ("flat_fed_rounds_fused", "dirichlet_stragglers", None, 4, 1),
            ("flat_fed_faults", faults, ef, 1, 4))


def _smoke_rank(rank, world, out_dir):
    """Every variant on this rank of the (data 4, model 2) CPU mesh:
    reduced TinyLlama (2 layers, d_model 256) in bf16 on the sharded
    flat engine, K = 2. Writes each variant's checks to
    ``out_dir/rank<r>.json``."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.core import flat as flatlib
    from repro_torch.core import init_fl_state
    from repro_torch.core.fed_loop import FlatFLState
    from repro_torch.launch.steps import make_train_loop
    from repro_torch.sharding import hlo
    from repro_torch.sharding.hlo import (
        assert_flat_buffer_sharded, assert_no_fullprec_delta_collective)
    from repro_torch.sharding.spec import cross_device
    cfg = get_config("tinyllama-1.1b").reduced(num_layers=2, d_model=256)
    mesh = dist.make_mesh(*SMOKE_MESH)
    spec = cross_device(mesh)
    fl = FLConfig(local_steps=2, flat_engine=True)
    model = build_model(cfg, torch.bfloat16)
    params = model.init(torch.Generator().manual_seed(0))
    layout = flatlib.layout_of(params, shards=spec.flat_shards(mesh))
    N = layout.padded_size
    n_loc = N // spec.flat_shards(mesh)
    out = []
    for name, scn, comp, rpc, cmul in _smoke_variants():
        C = spec.clients_on(mesh) * cmul
        b = max(1, SMOKE_BATCH // C)
        rng = np.random.default_rng(len(name))
        toks = rng.integers(0, cfg.vocab_size,
                            (rpc, C, fl.local_steps, b, SMOKE_SEQ + 1))
        whole = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        batch = interop.clients_local_from_numpy(whole, mesh, spec, axis=1)
        t0 = time.time()
        hlo.reset()
        if rpc > 1:
            loop, sopt, scn_r, comp_r = make_train_loop(
                model, fl, rounds_per_call=rpc, mesh=mesh, federation=spec,
                scenario=scn, compression=comp)
            state = init_fl_state(params, sopt, scn_r, comp_r, cohort=C,
                                  mesh=mesh, federation=spec)
            carry = FlatFLState(flatlib.pack(params, loop.layout),
                                state.server_state, 0, state.buffer,
                                state.ef)
            carry, metrics = loop(carry, batch)
            loss = metrics["loss"]
        else:
            step, sopt, scn_r, comp_r = make_train_step(
                model, fl, mesh=mesh, federation=spec, scenario=scn,
                compression=comp)
            state = init_fl_state(params, sopt, scn_r, comp_r, cohort=C,
                                  mesh=mesh, federation=spec)
            state, metrics = step(state, tree_map(lambda x: x[0], batch))
            loss = metrics["loss"]
        ops = hlo.snapshot()
        rep = assert_flat_buffer_sharded(ops, C, N)
        row = {"variant": name, "scenario": scn_r.name if scn_r else None,
               "C": C, "N": N, "seconds": round(time.time() - t0, 2),
               "collectives": len(ops), "full_shape": rep["full_shape"],
               "loss_finite": bool(torch.isfinite(loss).all())}
        if comp is not None:
            kw = ({"max_payload_elems": 2 * n_loc}
                  if name == "flat_fed_faults" else {})
            brep = assert_no_fullprec_delta_collective(
                ops, C, N, mesh=mesh, federation=spec, **kw)
            row["fullprec"] = brep["fullprec"]
        out.append(row)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def scenario_smoke(verbose: bool = True):
    """The reference's CI scenario leg, run for real: the hetero, async,
    compressed (int8 + EF21, 2 clients a client shard), rounds-fused
    (R = 4) and faults (dropouts, NaN and byzantine 0.1 under the
    trimmed mean and quorum 2, int8 + EF21, 4 clients a shard) rounds
    of reduced TinyLlama in bf16 on the sharded flat engine, on 8 gloo
    CPU ranks over (data 4, model 2). Each variant passes
    ``hlo.assert_flat_buffer_sharded`` and, where it compresses,
    ``assert_no_fullprec_delta_collective`` (the faults round with the
    tightened 2·N_loc payload bound), on every rank, with a finite
    loss. The quorum test reads the survivor count on the host, which
    fake tensors cannot give. Returns rank 0's rows."""
    import shutil
    import tempfile
    tmp = tempfile.mkdtemp(prefix="repro_torch_smoke_")
    try:
        dist.spawn(_smoke_rank, SMOKE_MESH[0][0] * SMOKE_MESH[0][1],
                   (tmp,), device="cpu", threads=1)
        ranks = []
        for r in range(SMOKE_MESH[0][0] * SMOKE_MESH[0][1]):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for rows in ranks:
        for row in rows:
            if not row["loss_finite"]:
                raise AssertionError(f"{row['variant']}: non-finite loss")
    if verbose:
        for row in ranks[0]:
            extra = ("" if "fullprec" not in row else
                     ", no full-precision delta over the client boundary")
            print(f"[scenario-smoke] {row['variant']} ({row['scenario']}): "
                  f"{row['seconds']} s on rank 0, ({row['C']}, {row['N']}) "
                  f"flat buffer stays sharded ({row['collectives']} "
                  f"collectives checked){extra}", flush=True)
        print("scenario smoke passed")
    return ranks[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None,
                    help="an arch id, or several joined by commas")
    ap.add_argument("--shape", default=None,
                    help="an input shape, or several joined by commas")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--local-steps", type=int, default=2)
    ap.add_argument("--remat", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="per-block rematerialisation in training shapes "
                         "(default on)")
    ap.add_argument("--scenario-smoke", action="store_true",
                    help="run the hetero, async, compressed, rounds-fused "
                         "and faults rounds on 8 gloo CPU ranks and check "
                         "the sharded-buffer and compressed-boundary "
                         "assertions")
    args = ap.parse_args(argv)
    if args.scenario_smoke:
        scenario_smoke()
        return

    archs = list(ARCH_IDS) if args.all or not args.arch \
        else args.arch.split(",")
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures, refused, done = [], [], 0
    for arch in archs:
        for shape_id in shapes:
            for multi in meshes:
                tag = f"{arch}_{shape_id}_{'multi' if multi else 'single'}"
                path = os.path.join(args.out, tag + ".json")
                if os.path.exists(path):
                    print(f"[skip] {tag} (exists)")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    res = lower_one(arch, shape_id, multi,
                                    local_steps=args.local_steps,
                                    remat=args.remat, verbose=False)
                except Refused as e:
                    refused.append((tag, str(e)))
                    print(f"  refused: {e}")
                    continue
                except Exception as e:      # noqa: BLE001 - listed below
                    failures.append((tag, repr(e)))
                    print(f"  FAIL {tag}: {e}")
                    traceback.print_exc()
                    continue
                with open(path, "w") as f:
                    json.dump(res, f, indent=2, default=float)
                done += 1
                rl = res["roofline"]
                print(f"  ok: bottleneck={rl['bottleneck']} "
                      f"t_comp={rl['t_compute_s']:.3e} "
                      f"t_mem={rl['t_memory_s']:.3e} "
                      f"t_coll={rl['t_collective_s']:.3e} "
                      f"lower={res['lower_s']}s", flush=True)
    if refused:
        print(f"\n{len(refused)} refused:")
        for t, e in refused:
            print(" ", t, "-", e)
    if failures:
        print(f"\n{len(failures)} failures:")
        for t, e in failures:
            print(" ", t, e)
        raise SystemExit(1)
    print(f"{done} dry runs passed")


if __name__ == "__main__":
    main()
