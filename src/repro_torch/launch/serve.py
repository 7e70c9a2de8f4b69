"""Serving driver: continuous-batching greedy decode on the
:mod:`repro_torch.serving` engine. Port of ``repro/launch/serve.py``.

  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
      --arch tinyllama-1.1b --reduced --batch 2 --prompt-len 16 --gen 8

It runs on ``cuda`` unless ``--device cpu`` is given; on the card every
prefill of a causal GQA attention site goes through the flash-attention
kernel (and, for Zamba2, every Mamba2 layer through the SSD chunk
kernel); DeepSeek-V3's MLA attention, the Whisper encoder and its
cross-attention, and xLSTM's mixers run in plain torch, as the
reference's do. The weights are a random init from ``--seed``. Each
request of an encoder-decoder (Whisper) or image-token (InternVL2)
config carries stub-frontend inputs drawn from ``--seed`` after the
prompts, as the reference draws them (``_row_extras``): (1500, 384)
frames, or 256 image embeddings that count in the cache length.
Decode runs in ``--flush-tokens``-step blocks with one device-to-host
copy per flush (see ``repro_torch/serving/engine.py``).

``--window`` must cover the full request (image tokens + prompt + gen)
unless
``--roll-cache`` is passed, in which case the KV cache is sized to the
window and rolls as a ring buffer (tokens beyond the window are
evicted); truncating the cache silently would corrupt decode state.

``--ckpt-dir`` loads the params from a checkpoint
(``repro_torch.checkpoint.restore_params``: bare params or a training
run's full FLState, written by either package) and keeps watching the
directory through a :class:`~repro_torch.serving.registry.ModelRegistry`:
a newer round saved mid-run hot-swaps at the next flush boundary, onto
the run's device. ``--ckpt-step`` pins a step (default: the newest);
pinning disables the watch.

``--loadgen N`` runs the load generator first: N requests (Poisson or
closed-loop arrival, ``--arrival``, ``--rate``) through the same engine,
reporting tokens/s, p50/p99 latency, occupancy and swap stall; the
one-batch demo runs after it. ``--personalize K`` registers K synthetic
client deltas, drawn from ``--seed`` before the demo's prompts as the
reference draws them, and routes a quarter of the load generator's
requests through the personalized-decode overlay (real fleet deltas
come from ``PersonalizationStore.from_arena`` on a training arena).
``--events F`` writes per-flush serving telemetry (``serve_flush``
rows and one ``serve_load`` row, schema-registered JSONL) to F.
``run(args)`` is the CLI's body; it returns the generated tokens plus
timing and the load report, so tests can call it in-process.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import restore_params
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.model import batch_extras, build_model
from repro_torch.serving import (DecodeEngine, ModelRegistry,
                                  PersonalizationStore, Workload, run_load)
from repro_torch.telemetry import EventLog


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
                         "are matched) and hot-swap when newer rounds "
                         "appear")
    ap.add_argument("--ckpt-step", type=int, default=None,
                    help="checkpoint step to load (default: the newest; "
                         "pinning disables the hot-swap watch)")
    ap.add_argument("--loadgen", type=int, default=0,
                    help="run the load generator with N requests before "
                         "the one-batch demo")
    ap.add_argument("--arrival", choices=("poisson", "closed"),
                    default="poisson")
    ap.add_argument("--rate", type=float, default=100.0,
                    help="poisson arrival rate (req/s)")
    ap.add_argument("--personalize", type=int, default=0,
                    help="register N synthetic client deltas; load-gen "
                         "traffic is partly routed through them")
    ap.add_argument("--events", default=None,
                    help="write per-flush serving telemetry JSONL here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap


def cache_len_for_request(full_len: int, window, roll_cache: bool) -> int:
    """The pool's cache length for requests of ``full_len`` tokens."""
    if window and window < full_len:
        if not roll_cache:
            raise SystemExit(
                f"--window {window} is smaller than the full request "
                f"({full_len} = image tokens + prompt + gen): the KV cache "
                f"would be "
                f"silently truncated and decode state corrupted. Pass "
                f"--roll-cache to serve with a rolling ring-buffer cache, "
                f"or raise --window.")
        return window
    return full_len


def run(args) -> dict:
    """Serve one batch, after a load-gen stream with ``--loadgen``;
    returns {"tokens": (B, gen) int32 array, "tok_per_s": float,
    "ckpt_step": int or None, "metrics": engine counters, "report": the
    load report or None, "history": the engine's per-flush records}."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg, torch.float32)
    params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    ckpt_step, registry = None, None
    if args.ckpt_dir:
        params, ckpt_step = restore_params(args.ckpt_dir, params,
                                           step=args.ckpt_step)
        print(f"loaded params from {args.ckpt_dir} step {ckpt_step}")
        if args.ckpt_step is None:        # unpinned: watch for new rounds
            registry = ModelRegistry(args.ckpt_dir, params)
            registry.version = ckpt_step

    B = args.batch
    rng = np.random.default_rng(args.seed)
    store = None
    if args.personalize:
        store = PersonalizationStore(params, scale=1.0)
        for cid in range(args.personalize):
            store.set_delta(cid, rng.normal(
                scale=1e-3, size=(store.layout.padded_size,)
            ).astype(np.float32))
    events = None
    if args.events:
        events = EventLog(args.events, device=dev, config={
            "arch": args.arch, "mode": "serve", "slots": args.slots or B,
            "flush_tokens": args.flush_tokens})
    try:
        engine = make_engine(model, params, args, version=ckpt_step or 0,
                             registry=registry, personalization=store,
                             events=events)
        report = None
        if args.loadgen:
            wl = Workload(num_requests=args.loadgen, arrival=args.arrival,
                          rate=args.rate, concurrency=engine.slots,
                          prompt_lens=(args.prompt_len,),
                          gen_lens=(args.gen,),
                          personalized_frac=0.25 if store else 0.0,
                          client_ids=tuple(store.client_ids()) if store
                          else (0,), seed=args.seed)
            report = run_load(engine, wl, cfg.vocab_size)
            print(f"loadgen: {report['requests']} requests, "
                  f"{report['tok_per_s']:.1f} tok/s, "
                  f"p50 {report['p50_s'] * 1e3:.1f}ms "
                  f"p99 {report['p99_s'] * 1e3:.1f}ms, "
                  f"occupancy {report['occupancy']:.2f}, "
                  f"swaps {report['swaps']}")
        # the one-batch demo (also the deterministic surface tests rely on)
        toks, dt = demo(engine, args, rng)
    finally:
        if events is not None:
            events.close()
    gen = args.gen
    print(f"decoded {gen} tokens x {B} on {dev.type} in {dt:.2f}s "
          f"({gen * B / max(dt, 1e-9):.1f} tok/s, "
          f"{engine.stats['flushes']} flushes)")
    print("sample:", toks[0][:16].tolist())
    return {"tokens": toks, "tok_per_s": gen * B / max(dt, 1e-9),
            "ckpt_step": ckpt_step, "metrics": engine.metrics(),
            "report": report, "history": engine.history}


def _row_extras(cfg, rng: np.random.Generator):
    """One request's stub-frontend inputs (``batch_extras``), f32
    standard normals drawn from ``rng`` in order (the reference's
    draw), or None."""
    return {k: rng.normal(size=shape).astype(np.float32)
            for k, shape in batch_extras(cfg).items()} or None


def make_engine(model, params, args, **kw) -> DecodeEngine:
    """The CLI's engine (``--slots``, ``--flush-tokens``, ``--window``, a
    cache for the full request); ``kw`` goes to ``DecodeEngine``."""
    cache_len = cache_len_for_request(
        (model.cfg.num_image_tokens or 0) + args.prompt_len + args.gen,
        args.window, args.roll_cache)
    return DecodeEngine(model, params, slots=args.slots or args.batch,
                        cache_len=cache_len, flush_tokens=args.flush_tokens,
                        window=args.window, **kw)


def demo(engine, args, rng: np.random.Generator):
    """The CLI's batch of ``args.batch`` prompts and their extras, drawn
    from ``rng``, decoded on ``engine`` -> ((B, gen) int32 tokens,
    seconds)."""
    cfg = engine.model.cfg
    B, S, gen = args.batch, args.prompt_len, args.gen
    prompts = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    rids = [engine.submit(prompts[i], gen, extras=_row_extras(cfg, rng))
            for i in range(B)]
    t0 = time.perf_counter()
    done = {c.request_id: c.tokens for c in engine.run_until_idle()}
    dt = time.perf_counter() - t0
    return np.stack([done[r] for r in rids]), dt


def decode(model, params, args):
    """The CLI's demo batch (drawn from ``args.seed``) decoded with
    ``params`` on a plain engine -> ((B, gen) int32 tokens, seconds, the
    engine)."""
    engine = make_engine(model, params, args)
    toks, dt = demo(engine, args, np.random.default_rng(args.seed))
    return toks, dt, engine


def main(argv=None) -> dict:
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
