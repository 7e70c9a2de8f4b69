"""Dry run of the serving programs on the H100 production mesh: one
rank's prefill or decode step of an (arch × input shape × mesh), run on
fake tensors under the abstract mesh (``launch/mesh.py``) and the serve
``LogicalRules``, with no process group and no allocation on any
device. Port of ``repro/launch/dryrun.py``'s serving half: it proves
the placement rules and the tensor-parallel model code agree at full
size, and writes the reference's JSON fields with the roofline terms of
the counted work (``repro_torch.roofline``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape decode_32k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single

The dense GQA decoders (TinyLlama-1.1B, CodeQwen1.5-7B, Qwen2.5-14B,
Granite-20B) at ``prefill_32k`` and ``decode_32k`` run. Refused, each
naming its ROADMAP item: the training shape and ``--scenario-smoke``
(tensor-parallel training), ``long_500k`` (its B = 1 cache is sharded
over the sequence on ``model``, which needs a sequence-parallel
decode), the other archs, and a global batch that does not split over
the mesh's data axes. ``--all`` lists refusals apart from failures.

``memory`` holds the argument and output bytes of one rank by the
placements; eager mode has no buffer assignment, so there is no
``temp`` (the reference's ``temp_size_in_bytes``): ``analytic_memory``
is the capacity-planning number, as in the reference.
"""
from __future__ import annotations

import argparse
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
                                      params_struct, prefill_specs)
from repro_torch.launch.steps import (make_prefill_step, make_serve_step,
                                      serve_rules)
from repro_torch.models.model import build_model, tp_supported
from repro_torch.sharding import dist
from repro_torch.sharding.spec import (cache_shardings, get_federation_spec,
                                       local_shape, mesh_shape,
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
    if shape.kind == "train":
        raise Refused(f"{shape_id}: tensor-parallel training is ROADMAP "
                      "A17 (the next slice)")
    if shape_id == "long_500k":
        raise Refused("long_500k: its B = 1 cache is sharded over the "
                      "sequence on model, which needs a sequence-parallel "
                      "decode (ROADMAP A17)")
    if not tp_supported(cfg):
        raise Refused(f"{arch}: tensor-parallel serving of MoE, MLA, "
                      "Mamba2, xLSTM, Whisper and InternVL2 is ROADMAP A17")
    sizes = production_shape(multi_pod)
    d = sizes.get("pod", 1) * sizes["data"]
    if shape.global_batch % d:
        raise Refused(f"{shape_id}: its global batch {shape.global_batch} "
                      f"does not split over the {d} data ranks of this "
                      "mesh (the H100 mesh keeps 8 GPUs a host on model)")


def _local(tree, axes, mesh):
    """Fake tensors of the rank's block shapes of ``tree``."""
    return tree_map(lambda x, a: x.new_empty(local_shape(tuple(x.shape), a,
                                                         mesh)),
                    tree, axes)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def lower_one(arch: str, shape_id: str, multi_pod: bool, *,
              fl: FLConfig = None, use_pallas: bool = False,
              verbose: bool = True):
    """One (arch, shape, mesh) dry run: rank (0, ..., 0)'s step on fake
    tensors, counted. Returns the reference's result fields."""
    check_lowerable(arch, shape_id, multi_pod)
    cfg, shape = get_config(arch), INPUT_SHAPES[shape_id]
    fl = fl or FLConfig()
    # the abstract mesh always: a dry run makes no real collective
    mesh = dist.AbstractMesh(production_shape(multi_pod))
    sizes = mesh_shape(mesh)
    chips = 1
    for n in sizes.values():
        chips *= n
    fed_kind = federation_kind(cfg)
    spec = get_federation_spec(fed_kind, mesh)
    model = build_model(cfg, torch.bfloat16)
    mode = FakeTensorMode()
    t0 = time.time()
    pstruct = params_struct(model, mode)
    rules = serve_rules(model, mesh, pstruct, spec=spec,
                        coords={a: 0 for a in sizes})
    cache = cache_sh = None
    with mode:
        params = _local(pstruct, rules.param_axes, mesh)
        if shape.kind == "prefill":
            batch = prefill_specs(model, shape, mode)
            bsh = serve_batch_shardings(mesh, batch)
            args = (params, _local(batch, bsh, mesh))
            step = make_prefill_step(model, use_pallas=use_pallas,
                                     rules=rules)
            in_bytes = shard_bytes(batch, bsh, mesh)
        else:
            window = decode_window(cfg, shape)
            cache, tokens = decode_specs(model, shape, window, mode=mode)
            cache_sh = cache_shardings(spec, mesh, cache,
                                       batch_size=shape.global_batch)
            tsh = serve_batch_shardings(mesh, {"t": tokens})["t"]
            args = (params, _local(cache, cache_sh, mesh),
                    tokens.new_empty(local_shape(tuple(tokens.shape), tsh,
                                                 mesh)))
            step = make_serve_step(model, window=window, rules=rules)
            in_bytes = (shard_bytes(cache, cache_sh, mesh)
                        + shard_bytes({"t": tokens}, {"t": tsh}, mesh))
        with roofline.count_work() as work:
            out = step(*args)
    t_lower = time.time() - t0
    pdev = shard_bytes(pstruct, rules.param_axes, mesh)
    mem = {"argument_size_in_bytes": pdev + in_bytes,
           "output_size_in_bytes": _nbytes({"out": out[0],
                                            "cache": out[1]}),
           "note": "eager mode has no buffer assignment: no temp size; "
                   "see analytic_memory"}
    analytic = analytic_memory(cfg, shape, spec, mesh, pstruct,
                               rules.param_axes, fl, cache, cache_sh)
    rl = roofline.analyze(work, chips)
    tokens_per_step = shape.global_batch * (
        shape.seq_len if shape.kind == "prefill" else 1)
    mf = roofline.model_flops(cfg, tokens_per_step) / 3.0   # fwd: 2·N·D
    total = rl.flops * chips
    n_params = param_count(cfg)
    result = {
        "arch": arch, "shape": shape_id,
        "mesh": "x".join(str(n) for n in sizes.values()), "chips": chips,
        "federation": fed_kind, "clients": spec.clients_on(mesh),
        "step_kind": shape.kind,
        "param_count": n_params,
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
    if verbose:
        print(json.dumps(result, indent=2, default=float))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--scenario-smoke", action="store_true",
                    help="the reference's CI leg of sharded training "
                         "rounds (refused: ROADMAP A17)")
    args = ap.parse_args(argv)
    if args.scenario_smoke:
        raise SystemExit("--scenario-smoke compiles sharded training "
                         "rounds: tensor-parallel training is ROADMAP A17 "
                         "(the next slice)")

    archs = list(ARCH_IDS) if args.all or not args.arch else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or not args.shape \
        else [args.shape]
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
                    res = lower_one(arch, shape_id, multi, verbose=False)
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
