"""Cohort means and fractions, bitwise the reference's.

The reference takes ``jnp.mean`` over the cohort (``k_eff_mean``,
``nan_guard_rate``, ``comp_level_mean``, ``drop_frac``, ``byz_frac``) and
``sum / (C·K)`` for ``eta_clip_rate``; XLA computes both as the sum times
f32(1/n), one ulp off a true division at some counts (a sum of 18 over
C = 10 gives 1.80000007, where 18/10 rounds to 1.79999995). The port
takes them the same way (``repro_torch.utils.numerics``).

Live reference runs (the flat engine's fused loop, 3 rounds of the
slice-2 federation with its draws injected) reach such counts:
``cyclic_hetero`` draws step counts that sum to 18, ``nan_rate=0.85``
trips 9 of 10 NaN guards, and ``drop_rate=0.85`` with
``byzantine_rate=0.85`` makes 9 of 10 clients byzantine. Then every count
0..8C at C ∈ {5, 10, 20, 50}, and every clip count 0..C·K, against the
reference's jitted expressions.
"""
from functools import lru_cache

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.paper_tasks import MLP_SMALL
from repro.core import arena_gather as r_gather
from repro.core import flatten_fl_state as r_flatten
from repro.core import get_client_opt as r_copt
from repro.core import get_server_opt as r_sopt
from repro.core import init_fl_state as r_init
from repro.core import make_fl_loop as r_loop
from repro.core import make_loss as r_make_loss
from repro.data.pipeline import FederatedDataset as RFed
from repro.data.synthetic import get_task as r_task
from repro.federation import get_scenario as r_scenario
from repro.models.small import make_small_model as r_model
from repro.models.small import softmax_ce as r_ce
from repro_torch import interop
from repro_torch.configs import paper_tasks as tcfg
from repro_torch.core import (arena_gather, flatten_fl_state,
                              get_client_opt, get_server_opt, make_fl_loop,
                              make_loss)
from repro_torch.data.pipeline import FederatedDataset
from repro_torch.data.synthetic import get_task
from repro_torch.federation import get_scenario
from repro_torch.models.small import make_small_model, softmax_ce
from repro_torch.utils.numerics import reciprocal, xla_mean

# the slice-2 federation (tests/test_torch_slice2.py), cohort C = 10
CLIENTS, BATCH, K, SEED, ALPHA, R, PART, C = 20, 8, 3, 7, 0.5, 3, 0.5, 10
# case -> (preset, overrides, the field whose count differs from a true
# division in some round)
CASES = {"cyclic_hetero": ("cyclic_hetero", {}, "k_eff_mean"),
         "nan_85": ("sync_iid", dict(nan_rate=0.85), "nan_guard_rate"),
         "drop_byz_85": ("sync_iid", dict(drop_rate=0.85,
                                          byzantine_rate=0.85), "byz_frac")}
FIELDS = ("k_eff_mean", "k_eff_min", "k_eff_max", "nan_guard_rate",
          "eta_clip_rate", "drop_frac", "byz_frac", "valid_count",
          "round_skipped", "cohort_ids")


def _ce(logits_fn, ce):
    return lambda q, bt: (ce(logits_fn(q, bt["x"]), bt["y"]), {})


@lru_cache(maxsize=None)
def _reference(case):
    name, over, _ = CASES[case]
    with jax.threefry_partitionable(False):
        scn = r_scenario(name, seed=SEED, **over)
        fed = RFed.build(r_task("easy", seed=SEED), num_clients=CLIENTS,
                         alpha=ALPHA, seed=SEED, scenario=scn)
        init_fn, logits_fn = r_model(MLP_SMALL)
        params = init_fn(jax.random.key(SEED))
        sopt = r_sopt("fedavg")
        loop = r_loop(r_make_loss(_ce(logits_fn, r_ce)), r_copt("delta_sgd"),
                      sopt, params_like=params, num_rounds=10,
                      rounds_per_call=R, flat="xla", scenario=scn,
                      num_clients=CLIENTS, client_sizes=fed.client_sizes(),
                      gather=r_gather)
        state0 = r_init(params, sopt, scn)
        idx, _, ids = fed.sample_block(PART, K, BATCH, round0=0, rounds=R)
        _, mets = jax.jit(loop)(r_flatten(state0, loop.layout),
                                jnp.asarray(idx),
                                arena=jax.tree.map(jnp.asarray, fed.arena()))
        draws = {t: jax.device_get({
            "cohort_ids": ids[t],
            "step_counts": scn.draw_step_counts(t, C, K),
            "faults": scn.draw_faults(t, C, K)}) for t in range(R)}
    return jax.device_get(state0), draws, jax.device_get(mets)


def _port(case, state0_np, draws):
    name, over, _ = CASES[case]
    scn = get_scenario(name, seed=SEED, draws=interop.draws_from_numpy(draws),
                       **over)
    fed = FederatedDataset.build(get_task("easy", seed=SEED),
                                 num_clients=CLIENTS, alpha=ALPHA, seed=SEED,
                                 scenario=scn)
    _, logits_fn = make_small_model(tcfg.MLP_SMALL)
    state0 = interop.fl_state_from_numpy(state0_np)
    loop = make_fl_loop(make_loss(_ce(logits_fn, softmax_ce)),
                        get_client_opt("delta_sgd"), get_server_opt("fedavg"),
                        params_like=state0.params, num_rounds=10,
                        rounds_per_call=R, scenario=scn, num_clients=CLIENTS,
                        client_sizes=fed.client_sizes(), gather=arena_gather)
    idx, _, _ = fed.sample_block(PART, K, BATCH, round0=0, rounds=R)
    _, mets = loop(flatten_fl_state(state0, loop.layout),
                   torch.from_numpy(idx),
                   arena={k: torch.from_numpy(v)
                          for k, v in fed.arena().items()})
    return mets


@pytest.mark.parametrize("case", sorted(CASES))
def test_cohort_fractions_match_a_live_reference_run_bitwise(case):
    state0, draws, rmets = _reference(case)
    mets = _port(case, state0, draws)
    fields = [k for k in FIELDS if k in rmets]
    assert CASES[case][2] in fields
    for k in fields:
        np.testing.assert_array_equal(mets[k].numpy(), np.asarray(rmets[k]),
                                      err_msg=k)
    # the run reaches a count where a true division differs
    key = CASES[case][2]
    if key == "k_eff_mean":
        sums = np.asarray([d["step_counts"].sum() for d in draws.values()])
    elif key == "nan_guard_rate":
        sums = np.asarray(rmets["nan_guard_rate"]) * C
    else:
        sums = np.asarray([d["faults"][3].sum() for d in draws.values()])
    true = np.round(sums).astype(np.float32) / np.float32(C)
    assert (np.asarray(rmets[key]) != true).any(), (key, sums)


@pytest.mark.parametrize("n", [5, 10, 20, 50])
def test_every_count_matches_jnp_mean(n):
    """Every sum 0..8n of n per-client counts in 0..8 (step counts; 0/1
    lanes for the fractions are the sums up to n), as xla_mean takes it
    and as the reference's jitted jnp.mean does."""
    counts = np.zeros((8 * n + 1, n), np.float32)
    for total in range(8 * n + 1):
        q, r = divmod(total, n)
        counts[total] = q
        counts[total, :r] += 1
    want = np.asarray(jax.jit(jax.vmap(jnp.mean))(jnp.asarray(counts)))
    got = xla_mean(torch.from_numpy(counts), dim=1).numpy()
    assert got.tobytes() == want.tobytes()
    got_each = np.stack([xla_mean(torch.from_numpy(c)).numpy()
                         for c in counts])
    assert got_each.tobytes() == want.tobytes()
    # the fix matters: a true division differs at some of these counts
    true = np.arange(8 * n + 1, dtype=np.float32) / np.float32(n)
    assert (true != want).any()


@pytest.mark.parametrize("c,k", [(10, 7), (20, 3), (4, 3)])
def test_eta_clip_rate_matches_the_references_division(c, k):
    """eta_clip_rate = Σ clips / (C·K) with a constant divisor: XLA takes
    it as a product with f32(1/(C·K)), and so does the port."""
    clips = np.zeros((c * k + 1, c), np.int32)
    for total in range(c * k + 1):
        q, r = divmod(total, c)
        clips[total] = q
        clips[total, :r] += 1
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: jnp.sum(s.astype(jnp.float32)) / jnp.float32(c * k)))(
            jnp.asarray(clips)))
    got = (torch.from_numpy(clips).to(torch.float32).sum(dim=1)
           * reciprocal(c * k)).numpy()
    assert got.tobytes() == want.tobytes()
