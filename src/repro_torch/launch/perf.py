"""Perf variants on the dry run: lower an (arch × shape) pair under the
baseline (paper-faithful) configuration and under the reference's
beyond-paper variants, and report the roofline terms side by side.
Port of ``repro/launch/perf.py``.

  PYTHONPATH=src python -m repro_torch.launch.perf \\
      --pair qwen2.5-14b/train_4k --variants flat_fed_sharded,flat_fed_faults

Each variant runs on the port's dry run (``launch/dryrun.py``): rank
(0, ..., 0) of the single-pod H100 mesh (data 32, model 8), on fake
tensors under the abstract mesh, touching no device. It is counted at
the reference's two calibration depths (one and two cycles of the
config's block pattern, ``_calib_depths``, ``_at_depth``) and the full
depth taken with ``roofline.extrapolate``, as the reference does (an
xLSTM program's sLSTM loop counted at its three points at each depth,
``dryrun._lower_scaled``).

Variants (``VARIANT_KNOBS``, the reference's 17 names):
  baseline      the paper-faithful program (reuses
                ``experiments/dryrun/{arch}_{shape}_single.json``)
  seq_shard, seq_shard+softmax_bf16
                the Megatron-SP residual: refused, naming ROADMAP A17
  softmax_bf16  bf16 softmax probabilities between the attention
                products (``models.attention.SOFTMAX_BF16``)
  quant_kv, cache_seq_shard, quant_kv+cache_seq_shard
                (decode shapes) the int8 KV cache; a batch-split cache
                whose time dim is also cut over ``model``
  capacity1     MoE capacity factor 1.25 -> 1.0
                (``models.moe.CAPACITY_FACTOR``)
  expert_2d, expert_2d+capacity1
                experts over (model, data) (``FederationSpec.expert_2d``)
  flat_fed      the flat Δ-SGD engine off the mesh: a rank runs its
                clients' (C_loc, K, b_loc) rows with each client's
                model and N whole
  flat_fed_sharded
                the sharded flat round on the rank's tensor-parallel
                blocks (``core.sharded``) under the training rules;
                ``hlo.assert_flat_buffer_sharded`` holds on its
                collectives (no global (C, N) payload, and no local-step
                op holding a client's whole N)
  flat_fed_hetero, flat_fed_async
                the same under ``dirichlet_stragglers`` / ``zipf_async``
  flat_fed_compressed
                int8 + EF21 under ``bandwidth_tiered``; also
                ``assert_no_fullprec_delta_collective`` (or its skip
                note with < 2 clients a client shard) and the ``wire``
                record
  flat_fed_rounds_fused
                R = 8 rounds fused (``make_train_loop``); the terms are
                one round's
  flat_fed_faults
                dropouts, NaN and byzantine 0.1 under the trimmed mean,
                int8 + EF21; both checks and the ``wire`` record
Each switch is set for the variant's lowering only and restored in a
``finally``. ``main`` writes ``{out}/{arch}_{shape}.json`` and exits 0
when every variant asked for ran or was refused.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from repro_torch import roofline
from repro_torch.compression import CompressionSpec
from repro_torch.configs import FLConfig, INPUT_SHAPES, get_config
from repro_torch.federation import get_scenario
from repro_torch.launch.dryrun import (Refused, check_lowerable,
                                       count_program)
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.specs import federation_kind
from repro_torch.sharding import dist
from repro_torch.sharding.spec import get_federation_spec


VARIANT_KNOBS = {
    "baseline": {},
    "seq_shard": {"seq_shard": True},
    "softmax_bf16": {"softmax_bf16": True},
    "seq_shard+softmax_bf16": {"seq_shard": True, "softmax_bf16": True},
    "quant_kv": {"quant_kv": True},
    "cache_seq_shard": {"cache_seq_shard": True},
    "quant_kv+cache_seq_shard": {"quant_kv": True, "cache_seq_shard": True},
    "capacity1": {"capacity": 1.0},
    "expert_2d": {"expert_2d": True},
    "expert_2d+capacity1": {"expert_2d": True, "capacity": 1.0},
    "flat_fed": {"flat_fed": True},
    "flat_fed_sharded": {"flat_fed": True, "flat_sharded": True},
    "flat_fed_hetero": {"flat_fed": True, "flat_sharded": True,
                        "scenario": "dirichlet_stragglers"},
    "flat_fed_async": {"flat_fed": True, "flat_sharded": True,
                       "scenario": "zipf_async"},
    "flat_fed_compressed": {"flat_fed": True, "flat_sharded": True,
                            "scenario": "bandwidth_tiered",
                            "compression": CompressionSpec(
                                kind="int8", error_feedback=True)},
    "flat_fed_rounds_fused": {"flat_fed": True, "flat_sharded": True,
                              "rounds_per_call": 8},
    "flat_fed_faults": {"flat_fed": True, "flat_sharded": True,
                        "scenario": get_scenario(
                            "dirichlet_dropouts", robust_agg="trimmed",
                            byzantine_rate=0.1),
                        "compression": CompressionSpec(
                            kind="int8", error_feedback=True)},
}


def _calib_depths(cfg):
    """Two reduced depths (whole pattern cycles) for the calibration."""
    cyc = len(cfg.block_pattern)
    return cyc, 2 * cyc


def _at_depth(cfg, L):
    return dataclasses.replace(cfg, name=f"{cfg.name}@{L}", num_layers=L)


def _layout(cfg, spec, mesh):
    """The flat layout of ``cfg``'s params (fake tensors) on ``mesh``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    import torch

    from repro_torch.core import flat as flatlib
    from repro_torch.launch.specs import params_struct
    from repro_torch.models.model import build_model
    pstruct = params_struct(build_model(cfg, torch.bfloat16),
                            FakeTensorMode())
    return flatlib.layout_of(pstruct, shards=spec.flat_shards(mesh))


def _check_flat_sharded(work, cfg, mesh, spec, variant, compressed=False):
    """The sharded flat round's checks on the counted collectives: no
    collective moves the global (C, N) slab and no local-step op holds a
    client's whole N (``assert_flat_buffer_sharded``); ``compressed``:
    no full-precision client delta crosses the client shards
    (``assert_no_fullprec_delta_collective``), with a skip note where
    the spec leaves < 2 clients a client shard."""
    from repro_torch.sharding.hlo import (assert_flat_buffer_sharded,
                                          assert_no_fullprec_delta_collective)
    layout = _layout(cfg, spec, mesh)
    C = spec.clients_on(mesh)
    rep = assert_flat_buffer_sharded(work.collectives, C,
                                     layout.padded_size,
                                     client_n=layout.size)
    print(f"[{variant}] ({C}, {layout.padded_size}) flat buffer stays "
          f"sharded: 0 full-shape collectives, 0 local-step collectives "
          f"holding a client's whole N ({len(work.collectives)} "
          "collectives checked)", flush=True)
    if compressed:
        try:
            brep = assert_no_fullprec_delta_collective(
                work.collectives, C, layout.padded_size, mesh=mesh,
                federation=spec)
            print(f"[{variant}] no full-precision delta crosses the "
                  f"client boundary ({brep['collectives']} collectives "
                  "checked)", flush=True)
        except ValueError as e:
            print(f"[{variant}] boundary check skipped: {e}", flush=True)
    return rep


def wire_record(cfg, spec, mesh, compression) -> dict:
    """The reference's analytic wire record: a round's client-to-server
    payload of the full-depth layout at the variant's compression kind."""
    from repro_torch.compression import get_compression
    comp = get_compression(compression)
    layout = _layout(cfg, spec, mesh)
    C = spec.clients_on(mesh)
    table = comp.level_wire_bytes(layout.size)
    wire = float(table[comp.level]) * C
    return {"kind": comp.kind, "clients": C, "wire_bytes_round": wire,
            "uncompressed_bytes_round": float(table[0]) * C,
            "comp_ratio": float(table[0]) / float(table[comp.level])}


def measure(arch: str, shape_id: str, variant: str, *, local_steps=2):
    """One variant of one pair: counted at the two calibration depths
    and extrapolated to the config's depth. Returns the roofline summary
    with ``wall_s``, the counted collectives by role at the second
    depth and, for the compressed variants, ``wire``. Raises
    ``Refused`` for a variant the port does not lower."""
    knobs = dict(VARIANT_KNOBS[variant])
    check_lowerable(arch, shape_id, False)
    cfg = get_config(arch)
    shape = INPUT_SHAPES[shape_id]
    mesh = dist.AbstractMesh(production_shape(False))
    spec = get_federation_spec(federation_kind(cfg), mesh)
    if knobs.pop("expert_2d", False):
        spec = dataclasses.replace(spec, expert_2d=True)
    fl = FLConfig(local_steps=local_steps)
    t0 = time.time()
    L1, L2 = _calib_depths(cfg)
    rls, roles = [], {}
    for L in (L1, L2):
        cfg_L = _at_depth(cfg, L)
        work, _, _, rounds = count_program(cfg_L, shape, fl, mesh, spec,
                                           remat=False, knobs=knobs)
        if knobs.get("flat_sharded") and shape.kind == "train":
            _check_flat_sharded(work, cfg_L, mesh, spec, variant,
                                compressed=bool(knobs.get("compression")))
        rls.append(roofline.analyze(work, mesh.size, rounds))
        roles = {r: sum(o.role == r for o in work.collectives)
                 for r in sorted({o.role for o in work.collectives})}
    rl = roofline.extrapolate(rls[0], rls[1], L1, L2, cfg.num_layers)
    out = rl.summary()
    out["wall_s"] = round(time.time() - t0, 1)
    out["calibration_depths"] = [L1, L2]
    out["collectives_at_depth2"] = roles
    if knobs.get("compression") and shape.kind == "train":
        out["wire"] = wire_record(cfg, spec, mesh, knobs["compression"])
        w = out["wire"]
        print(f"[{variant}] wire: {w['wire_bytes_round']/1e9:.2f} GB/round "
              f"vs {w['uncompressed_bytes_round']/1e9:.2f} GB uncompressed "
              f"(ratio {w['comp_ratio']:.2f}x)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--pair", required=True)  # arch/shape
    ap.add_argument("--variants", default="baseline,seq_shard")
    ap.add_argument("--out", default="experiments/perf")
    args = ap.parse_args(argv)
    arch, shape_id = args.pair.split("/")
    os.makedirs(args.out, exist_ok=True)
    results, failed = {"_pair": args.pair}, []
    base_path = os.path.join("experiments/dryrun",
                             f"{arch}_{shape_id}_single.json")
    for v in args.variants.split(","):
        if v not in VARIANT_KNOBS:
            raise SystemExit(f"unknown variant {v!r}: one of "
                             f"{', '.join(VARIANT_KNOBS)}")
        if v == "baseline" and os.path.exists(base_path):
            with open(base_path) as f:
                results[v] = json.load(f)["roofline"]
            print(f"[{v}] reused sweep artifact")
        else:
            print(f"[{v}] lowering...", flush=True)
            try:
                results[v] = measure(arch, shape_id, v)
            except Refused as e:
                results[v] = {"refused": str(e)}
                print(f"[{v}] refused: {e}", flush=True)
                continue
            except Exception as e:      # noqa: BLE001 - counted below
                failed.append(v)
                print(f"[{v}] FAIL: {e!r}", flush=True)
                import traceback
                traceback.print_exc()
                continue
        r = results[v]
        print(f"  t_comp={r['t_compute_s']:.3e} t_mem={r['t_memory_s']:.3e} "
              f"t_coll={r['t_collective_s']:.3e} bot={r['bottleneck']}",
              flush=True)
    tag = f"{arch}_{shape_id}".replace("/", "_")
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(results, f, indent=2, default=float)
    if failed:
        print(f"{len(failed)} variants failed: {', '.join(failed)}")
        sys.exit(1)


if __name__ == "__main__":
    main()
