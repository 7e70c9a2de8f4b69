"""Load generator for the serving plane: synthetic request streams
(Poisson open-loop or closed-loop) over prompt/generation length mixes,
driven through a :class:`~repro_torch.serving.engine.DecodeEngine`,
reporting throughput, latency percentiles, batch occupancy, and swap
stall. Port of ``repro/serving/loadgen.py``: numpy only, the same
request stream from the same seed.

Open loop ("poisson"): request i arrives at the cumulative sum of
Exponential(1/rate) gaps, regardless of how the engine keeps up —
latency includes queueing, which is what a p99 under overload should
show. Closed loop ("closed"): a fixed number of in-flight requests,
each replaced on completion — measures the engine's saturated
throughput without unbounded queue growth.

All randomness is seeded (``numpy.random.default_rng``); the request
STREAM is deterministic, only arrival timing depends on the wall clock.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class Workload:
    num_requests: int = 16
    arrival: str = "poisson"           # "poisson" | "closed"
    rate: float = 100.0                # req/s (poisson)
    concurrency: int = 4               # in-flight target (closed)
    prompt_lens: Sequence[int] = (16,)
    gen_lens: Sequence[int] = (8,)
    personalized_frac: float = 0.0     # fraction routed to a client id
    client_ids: Sequence[int] = (0,)
    seed: int = 0


def make_requests(workload: Workload, vocab: int
                  ) -> List[Tuple[np.ndarray, int, Optional[int], float]]:
    """The deterministic request stream: a list of
    (prompt, gen_len, client_id, arrival_time_s) tuples."""
    rng = np.random.default_rng(workload.seed)
    gaps = (rng.exponential(1.0 / workload.rate, workload.num_requests)
            if workload.arrival == "poisson"
            else np.zeros(workload.num_requests))
    arrivals = np.cumsum(gaps)
    out = []
    for i in range(workload.num_requests):
        plen = int(rng.choice(np.asarray(workload.prompt_lens)))
        gen = int(rng.choice(np.asarray(workload.gen_lens)))
        cid = None
        if (workload.personalized_frac > 0.0
                and rng.random() < workload.personalized_frac):
            cid = int(rng.choice(np.asarray(workload.client_ids)))
        prompt = rng.integers(0, vocab, size=(plen,)).astype(np.int32)
        out.append((prompt, gen, cid, float(arrivals[i])))
    return out


def run_load(engine, workload: Workload, vocab: int) -> dict:
    """Drive ``workload`` through ``engine``; returns the report dict
    (tok_per_s, p50/p99 latency, occupancy, swap counters)."""
    reqs = make_requests(workload, vocab)
    done: list = []
    t0 = time.time()
    if workload.arrival == "closed":
        pending = list(reqs)
        for _ in range(min(workload.concurrency, len(pending))):
            prompt, gen, cid, _at = pending.pop(0)
            engine.submit(prompt, gen, client_id=cid)
        while engine.has_work() or pending:
            done.extend(engine.step())
            while pending and engine.queue == [] and \
                    sum(s is None for s in engine._slots) > 0:
                # keep `concurrency` in flight: refill freed capacity
                in_flight = (len(engine.queue)
                             + sum(s is not None for s in engine._slots))
                if in_flight >= workload.concurrency:
                    break
                prompt, gen, cid, _at = pending.pop(0)
                engine.submit(prompt, gen, client_id=cid)
    else:
        i = 0
        while i < len(reqs) or engine.has_work():
            now = time.time() - t0
            while i < len(reqs) and reqs[i][3] <= now:
                prompt, gen, cid, _at = reqs[i]
                engine.submit(prompt, gen, client_id=cid)
                i += 1
            if engine.has_work():
                done.extend(engine.step())
            elif i < len(reqs):
                time.sleep(min(0.001, max(0.0, reqs[i][3] - now)))
    wall = max(time.time() - t0, 1e-9)
    lat = np.asarray([c.latency_s for c in done], np.float64)
    m = engine.metrics()
    report = {"requests": len(done),
              "tok_per_s": m["serve_tokens_total"] / wall,
              "p50_s": float(np.percentile(lat, 50)) if lat.size else 0.0,
              "p99_s": float(np.percentile(lat, 99)) if lat.size else 0.0,
              "occupancy": m["serve_occupancy_mean"],
              "swaps": m["serve_swaps_total"],
              "swap_stall_mean_s": m["serve_swap_stall_mean"],
              "swap_stall_max_s": m["serve_swap_stall_max"],
              "wall_s": wall}
    if engine.events is not None:
        engine.events.emit("serve_load", t=0,
                           serve_tok_per_s=report["tok_per_s"],
                           serve_latency_p50_s=report["p50_s"],
                           serve_latency_p99_s=report["p99_s"])
        engine.events.flush()
    return report
