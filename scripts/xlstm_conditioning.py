#!/usr/bin/env python3
"""How far an f32 Δ-SGD round of xLSTM lies from its f64 evaluation, by
η₀: the noise floor under which two f32 sum orders (the unsharded round
and a tensor-parallel one) cannot be told apart.

    python3 scripts/xlstm_conditioning.py [--eta0 0.2,0.05,0.02,0.01]
                                          [--layers 4] [--device cuda]
    python3 scripts/xlstm_conditioning.py --serve --layers 4,8 [--device cpu]

Runs ``chip_smoke.py`` phase 4g's xLSTM round (full width, the given
layers, C = 2 clients of b = 1 sequence of 256 tokens, K = 2 local
steps, weights and tokens from its seed) unsharded, in f32 and in f64
from the same f32 weights, for each η₀, and prints each metric's
relative distance between the two (loss, loss_last_step, eta_mean,
eta_min, eta_max), with the card's name and power limit. Seconds on an
H100; the default device is the card. ``--serve``: the same for phase
6c's serving run at each of ``--layers`` (full width, 2 of its prompts
of 64 tokens, prefill then 4 decode steps): the largest |f32 − f64|
logit over the steps as a share of the largest |logit| (about two
minutes an 8-layer model on 8 CPU threads, 10 GB).
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--eta0", default="0.2,0.05,0.02,0.01")
    ap.add_argument("--layers", default="4")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args()
    import torch
    from repro_torch.configs import FLConfig
    from repro_torch.core import init_fl_state
    from repro_torch.device import resolve_device
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_map
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    if args.serve:
        for layers in (int(n) for n in args.layers.split(",")):
            serve(torch, dev, layers)
        return
    key = ("xlstm-1.3b", int(args.layers), "cross_device", 2, 1)
    cfg = cs._cut_cfg(*key[:2])
    p32 = build_model(cfg).init(torch.Generator(device=dev).manual_seed(
        cs.TPT_SEED))
    batch = cs._tpt_batch(torch, key, dev)
    names = ("loss", "loss_last_step", "eta_mean", "eta_min", "eta_max")
    for eta0 in (float(e) for e in args.eta0.split(",")):
        got = {}
        for dt in (torch.float32, torch.float64):
            step, sopt, _, _ = make_train_step(
                build_model(cfg, dt), FLConfig(local_steps=cs.TPT_K,
                                               eta0=eta0))
            params = tree_map(lambda x: x.to(dt), p32)
            _, m = step(init_fl_state(params, sopt), batch)
            got[dt] = {k: float(m[k]) for k in names}
            del params, step
        rel = {k: abs(got[torch.float32][k] - got[torch.float64][k])
               / abs(got[torch.float64][k]) for k in names}
        print("xlstm round f32 vs f64", json.dumps({
            "eta0": eta0, "layers": cfg.num_layers,
            "d_model": cfg.d_model, "rel": rel,
            "f32": got[torch.float32], "f64": got[torch.float64]}),
            flush=True)


def serve(torch, dev, layers):
    """Phase 6c's xLSTM serving run at ``layers``, unsharded, in f32 and
    in f64 from the same f32 weights: prefill of 2 prompts, 4 decode
    steps fed the prompts' last token; prints the worst step's largest
    |f32 − f64| logit, alone and over the largest |logit|."""
    import numpy as np
    from repro_torch.models.model import build_model
    from repro_torch.utils.tree import tree_map
    cfg = cs._lm_cfg("xlstm-1.3b", layers)
    p32 = build_model(cfg).init(torch.Generator(device=dev).manual_seed(
        cs.TP_SEED))
    toks = torch.from_numpy(cs._tp_prompts(cfg)[:2]).to(dev)
    out = {}
    with torch.no_grad():
        for dt in (torch.float32, torch.float64):
            model = build_model(cfg, dt)
            params = tree_map(lambda x: x.to(dt), p32)
            lg, cache = model.prefill(params, {"tokens": toks})
            steps = [lg[:, 0].double()]
            for _ in range(4):
                lg, cache = model.decode_step(params, cache, toks[:, -1:])
                steps.append(lg[:, 0].double())
            out[dt] = torch.stack(steps).cpu().numpy()
            del params, model, cache
    err = np.abs(out[torch.float32] - out[torch.float64])
    scale = float(np.abs(out[torch.float64]).max())
    print("xlstm serve f32 vs f64", json.dumps({
        "layers": layers, "d_model": cfg.d_model,
        "max_abs_err": float(err.max()), "max_abs_logit": scale,
        "rel": float(err.max()) / scale}), flush=True)


if __name__ == "__main__":
    main()
