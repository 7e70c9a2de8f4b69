"""Serving driver: continuous-batching greedy decode on the
:mod:`repro_torch.serving` engine. Port of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch tinyllama-1.1b --reduced --batch 2 --prompt-len 16 --gen 8

It runs on ``cuda`` unless ``--device cpu`` is given; on the card every
prefill of a GQA attention site goes through the flash-attention kernel
(and, for Zamba2, every Mamba2 layer through the SSD chunk kernel);
DeepSeek-V3's MLA attention runs in plain torch, as the reference's
does. The weights are a random init from ``--seed``.
Decode runs in ``--flush-tokens``-step blocks with one device-to-host
copy per flush (see ``repro_torch/serving/engine.py``).

``--window`` must cover the full request (prompt + gen) unless
``--roll-cache`` is passed, in which case the KV cache is sized to the
window and rolls as a ring buffer (tokens beyond the window are
evicted); truncating the cache silently would corrupt decode state.

``--ckpt-dir`` loads the params at start-up from a checkpoint
(``repro_torch.checkpoint.restore_params``: bare params or a training
run's full FLState, written by either package), the newest one or
``--ckpt-step``. The reference also watches an unpinned directory for
newer rounds and swaps them in mid-run; that watch is the model
registry's (ROADMAP A16), so here the step loaded at start-up serves the
whole run. The load generator and personalization (``--loadgen``,
``--arrival``, ``--rate``, ``--personalize``) and serving telemetry
(``--events``) are not ported yet and exit naming their ROADMAP items.
``run(args)`` is the CLI's body; it returns the generated tokens plus
timing so tests can call it in-process.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import restore_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model
from repro_torch.serving import DecodeEngine

# flag -> (its default, the ROADMAP item that ports it): any other value
# exits with an error naming the item
_NOT_PORTED = {
    "loadgen": (0, "A16 (serving: load generator)"),
    "arrival": ("poisson", "A16 (serving: load generator)"),
    "rate": (100.0, "A16 (serving: load generator)"),
    "personalize": (0, "A16 (serving: personalization)"),
    "events": (None, "A16 (serving events: the registry's version and "
                      "swap fields)"),
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--window", type=int, default=None)
    ap.add_argument("--roll-cache", action="store_true",
                    help="with --window smaller than the full request, "
                         "size the cache to the window and roll it as a "
                         "ring buffer instead of erroring")
    ap.add_argument("--slots", type=int, default=None,
                    help="KV-pool slots (default: --batch)")
    ap.add_argument("--flush-tokens", type=int, default=8,
                    help="decode tokens per host flush")
    ap.add_argument("--ckpt-dir", default=None,
                    help="load params from this checkpoint dir (a training "
                         "FLState checkpoint works: its 'params/' keys "
                         "are matched)")
    ap.add_argument("--ckpt-step", type=int, default=None,
                    help="checkpoint step to load (default: the newest)")
    ap.add_argument("--loadgen", type=int, default=0)
    ap.add_argument("--arrival", choices=("poisson", "closed"),
                    default="poisson")
    ap.add_argument("--rate", type=float, default=100.0)
    ap.add_argument("--personalize", type=int, default=0)
    ap.add_argument("--events", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def check_ported(args) -> None:
    """Raise SystemExit for a flag or arch that is not ported yet."""
    for name, (off, item) in _NOT_PORTED.items():
        if getattr(args, name) != off:
            flag = "--" + name.replace("_", "-")
            raise SystemExit(f"{flag} is not ported to repro_torch yet: it "
                             f"comes with ROADMAP {item}")
    try:
        get_config(args.arch)
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None


def cache_len_for_request(full_len: int, window, roll_cache: bool) -> int:
    """The pool's cache length for requests of ``full_len`` tokens."""
    if window and window < full_len:
        if not roll_cache:
            raise SystemExit(
                f"--window {window} is smaller than the full request "
                f"({full_len} = prompt + gen): the KV cache would be "
                f"silently truncated and decode state corrupted. Pass "
                f"--roll-cache to serve with a rolling ring-buffer cache, "
                f"or raise --window.")
        return window
    return full_len


def run(args) -> dict:
    """Serve one batch; returns {"tokens": (B, gen) int32 array,
    "tok_per_s": float, "ckpt_step": int or None, "metrics": engine
    counters, "history": the engine's per-flush records}."""
    check_ported(args)
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    ckpt_step = None
    if args.ckpt_dir:
        params, ckpt_step = restore_params(args.ckpt_dir, params,
                                           step=args.ckpt_step)
        print(f"loaded params from {args.ckpt_dir} step {ckpt_step}")

    toks, dt, engine = decode(model, params, args)
    B, gen = args.batch, args.gen
    print(f"decoded {gen} tokens x {B} on {dev.type} in {dt:.2f}s "
          f"({gen * B / max(dt, 1e-9):.1f} tok/s, "
          f"{engine.stats['flushes']} flushes)")
    print("sample:", toks[0][:16].tolist())
    return {"tokens": toks, "tok_per_s": gen * B / max(dt, 1e-9),
            "ckpt_step": ckpt_step, "metrics": engine.metrics(),
            "history": engine.history}


def decode(model, params, args):
    """The CLI's batch of ``args.batch`` prompts (drawn from
    ``args.seed``) decoded with ``params`` -> ((B, gen) int32 tokens,
    seconds, the engine)."""
    B, S, gen = args.batch, args.prompt_len, args.gen
    cache_len = cache_len_for_request(S + gen, args.window, args.roll_cache)
    engine = DecodeEngine(model, params, slots=args.slots or B,
                          cache_len=cache_len,
                          flush_tokens=args.flush_tokens, window=args.window)
    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, model.cfg.vocab_size, (B, S)).astype(np.int32)
    rids = [engine.submit(prompts[i], gen) for i in range(B)]
    t0 = time.perf_counter()
    done = {c.request_id: c.tokens for c in engine.run_until_idle()}
    dt = time.perf_counter() - t0
    return np.stack([done[r] for r in rids]), dt, engine


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
