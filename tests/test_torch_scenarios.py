"""The port's scenario axes on the CPU: the eleven presets equal the
reference's field by field and validate the same way; the port's own
draws are pure in (seed, round) with the reference's shapes, dtypes,
ranges and distributions; adding a fault mode leaves the other modes'
draws alone; and the schedulers draw distinct ids of the right size
with the reference's weighting."""
import dataclasses

import numpy as np
import pytest

from repro.federation import SCENARIOS as R_SCENARIOS
from repro.federation import Scenario as RScenario
from repro.federation import get_scenario as r_get_scenario
from repro.federation import make_scheduler as r_make_scheduler
from repro_torch.federation import (SCENARIOS, SCHEDULERS, Scenario,
                                    SpeedModel, get_scenario,
                                    make_scheduler)

FIELDS = [f.name for f in dataclasses.fields(RScenario)]


@pytest.mark.parametrize("name", sorted(R_SCENARIOS))
def test_presets_equal_the_reference_field_by_field(name):
    assert set(SCENARIOS) == set(R_SCENARIOS)
    port, ref = SCENARIOS[name], R_SCENARIOS[name]
    for f in FIELDS:
        assert getattr(port, f) == getattr(ref, f), f
    for prop in ("heterogeneous", "is_async", "bandwidth_heterogeneous",
                 "faulty", "robust"):
        assert getattr(port, prop) == getattr(ref, prop), prop
    assert port.fault_model.active == ref.fault_model.active
    assert port.robust_model.trim_count(10) == \
        ref.robust_model.trim_count(10)
    assert get_scenario(name, seed=5).seed == \
        r_get_scenario(name, seed=5).seed == 5


@pytest.mark.parametrize("bad", [
    dict(aggregation="semi"), dict(bandwidth="fast"),
    dict(tier_probs=(0.5, 0.5)), dict(quorum=-1), dict(speed="warp"),
    dict(drop_rate=1.5), dict(nan_rate=-0.1), dict(robust_agg="krum"),
    dict(trim_frac=0.5), dict(clip_norm=0.0), dict(scheduler="uniform"),
])
def test_validation_errors_match_the_reference(bad):
    errs = []
    for cls in (Scenario, RScenario):
        try:
            cls("x", **bad)
            errs.append(None)
        except (KeyError, ValueError) as e:
            errs.append(type(e))
    assert errs[0] == errs[1]
    with pytest.raises(KeyError):
        get_scenario("nope")


def _all_draws(scn, t, C=40, K=7):
    return (scn.draw_step_counts(t, C, K),
            scn.draw_compression_levels(t, C),
            scn.draw_faults(t, C, K),
            scn.draw_cohort(t, 100, C))


def test_draws_are_pure_in_seed_and_round():
    scn = get_scenario("dirichlet_dropouts", bandwidth="uniform",
                       byzantine_rate=0.2, overstale_rate=0.2, seed=3)
    a, b = _all_draws(scn, 4), _all_draws(scn, 4)
    for x, y in zip(a[:2] + a[2] + a[3:], b[:2] + b[2] + b[3:]):
        np.testing.assert_array_equal(x, y)
    c = _all_draws(scn, 5)
    d = _all_draws(dataclasses.replace(scn, seed=4), 4)
    for other in (c, d):
        assert not np.array_equal(a[0], other[0]) or \
            not np.array_equal(a[1], other[1])
        assert not np.array_equal(a[3], other[3])


def test_draw_shapes_dtypes_and_ranges():
    C, K = 400, 7
    for name in ("dirichlet_stragglers", "cyclic_hetero"):
        scn = get_scenario(name)
        kmin = scn.speed_model.k_min(K)
        for t in range(5):
            sc = scn.draw_step_counts(t, C, K)
            assert sc.shape == (C,) and sc.dtype == np.int32
            assert sc.min() >= kmin and sc.max() <= K
    sc = np.concatenate([get_scenario("cyclic_hetero").draw_step_counts(
        t, C, K) for t in range(5)])
    assert set(sc.tolist()) == set(range(2, K + 1))       # U{K_min..K}
    strag = get_scenario("dirichlet_stragglers").draw_step_counts(0, C, K)
    assert set(strag.tolist()) == {2, K}
    assert abs((strag == 2).mean() - 0.3) < 0.08
    fixed = get_scenario("sync_iid").draw_step_counts(0, C, K)
    assert (fixed == K).all()
    tiers = get_scenario("bandwidth_tiered").draw_compression_levels(0, 4000)
    assert tiers.dtype == np.int32 and set(tiers.tolist()) == {0, 1, 2}
    np.testing.assert_allclose(np.bincount(tiers) / 4000, (0.2, 0.5, 0.3),
                               atol=0.03)
    lanes = get_scenario("dirichlet_dropouts", byzantine_rate=0.1,
                         overstale_rate=0.1).draw_faults(0, 4000, K)
    drop, nan_step, byz, over = lanes
    assert drop.dtype == nan_step.dtype == np.int32
    assert byz.dtype == over.dtype == np.bool_
    dropped = drop < K
    assert abs(dropped.mean() - 0.3) < 0.03
    assert drop[dropped].min() >= 1 and drop[dropped].max() <= K - 1
    assert set(drop[dropped].tolist()) == set(range(1, K))
    bad = nan_step < K
    assert abs(bad.mean() - 0.05) < 0.015
    assert nan_step[bad].min() >= 0
    assert abs(byz.mean() - 0.1) < 0.02 and abs(over.mean() - 0.1) < 0.02
    one = get_scenario("dirichlet_dropouts").draw_faults(0, 500, 1)
    assert (one.drop_step[one.drop_step < 1] == 0).all()   # K = 1


def test_adding_a_fault_mode_keeps_the_other_modes_draws():
    base = get_scenario("dirichlet_dropouts", seed=9)
    more = dataclasses.replace(base, byzantine_rate=0.3, overstale_rate=0.2)
    a, b = base.draw_faults(2, 64, 5), more.draw_faults(2, 64, 5)
    np.testing.assert_array_equal(a.drop_step, b.drop_step)
    np.testing.assert_array_equal(a.nan_step, b.nan_step)
    assert not a.byzantine.any() and b.byzantine.any()
    no_nan = dataclasses.replace(base, nan_rate=0.0).draw_faults(2, 64, 5)
    np.testing.assert_array_equal(a.drop_step, no_nan.drop_step)
    assert (no_nan.nan_step == 5).all()


@pytest.mark.parametrize("kind", SCHEDULERS)
def test_schedulers_draw_distinct_ids_of_the_cohort_size(kind):
    m, C = 60, 12
    sizes = np.arange(1, m + 1, dtype=np.float32)
    sch = make_scheduler(kind, num_clients=m, cohort=C, sizes=sizes)
    ref = r_make_scheduler(kind, num_clients=m, cohort=C, sizes=sizes)
    assert sch.name == ref.name
    counts = np.zeros(m)
    for t in range(300):
        ids = sch.sample(1, t)
        assert ids.shape == (C,) and ids.dtype == np.int32
        assert len(set(ids.tolist())) == C and ids.min() >= 0 \
            and ids.max() < m
        counts[ids] += 1
    np.testing.assert_array_equal(sch.sample(1, 7), sch.sample(1, 7))
    if kind == "zipf":
        assert counts[:5].sum() > counts[-5:].sum() * 3
    if kind == "size_weighted":
        assert counts[-10:].sum() > counts[:10].sum() * 3
    if kind == "cyclic":
        start = (3 * sch.stride) % m
        ids = sch.sample(1, 3)
        assert (((ids - start) % m) < sch.window).all()
        assert sch.window == ref.window and sch.stride == ref.stride
    with pytest.raises(KeyError):
        make_scheduler("lottery", num_clients=m, cohort=C)


def test_speed_model_matches_reference_k_min():
    from repro.federation import SpeedModel as RSpeedModel
    for frac in (0.0, 0.25, 0.5, 1.0):
        for k in (1, 3, 7, 20):
            assert SpeedModel("uniform", k_min_frac=frac).k_min(k) == \
                RSpeedModel("uniform", k_min_frac=frac).k_min(k)
