"""Port parity for the data path: the numpy task generators, the
Dirichlet partition, the per-round gather indices (with the reference's
cohort ids replayed) and the eval batches are bit-identical to the
reference's."""
import numpy as np
import pytest

from repro.data.dirichlet import dirichlet_partition as rpartition
from repro.data.pipeline import FederatedDataset as RFed
from repro.data.synthetic import get_task as rget_task
from repro.federation.schedulers import cohort_size as rcohort
from repro_torch.data.dirichlet import dirichlet_partition as tpartition
from repro_torch.data.pipeline import FederatedDataset as TFed
from repro_torch.data.synthetic import get_task as tget_task
from repro_torch.federation.schedulers import (UniformScheduler,
                                               cohort_size, make_scheduler)


class ReplayScheduler:
    """Hands back the reference's cohort ids, round by round."""

    def __init__(self, ids):
        self.ids = np.asarray(ids)
        self.cohort = self.ids.shape[1]

    def sample(self, seed, t):
        return self.ids[t]


@pytest.mark.parametrize("task", ["easy", "medium", "hard", "image"])
def test_get_task_is_bit_identical(task):
    r, t = rget_task(task, seed=1), tget_task(task, seed=1)
    for f in ("x", "y", "x_test", "y_test"):
        a, b = getattr(r, f), getattr(t, f)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert r.num_classes == t.num_classes


@pytest.mark.parametrize("alpha,sizes", [(0.1, None), (1.0, None),
                                         (0.01, [100, 500, 230, 80])])
def test_dirichlet_partition_is_bit_identical(alpha, sizes):
    y = np.random.default_rng(0).integers(0, 10, 5000).astype(np.int32)
    n = 4 if sizes else 20
    r = rpartition(y, n, alpha, 300, seed=3, variable_sizes=sizes)
    t = tpartition(y, n, alpha, 300, seed=3, variable_sizes=sizes)
    assert len(r) == len(t)
    for a, b in zip(r, t):
        np.testing.assert_array_equal(a, b)


def test_sample_block_and_test_batch_with_replayed_cohorts():
    task = tget_task("easy", seed=0)
    rfed = RFed.build(rget_task("easy", seed=0), num_clients=30, alpha=0.1,
                      samples_per_client=64, seed=5)
    K, b, R = rfed.epoch_steps(16), 16, 3
    idx_r, w_r, ids_r = rfed.sample_block(0.2, K, b, round0=2, rounds=R)
    # the port replays the reference's ids for rounds 2..4
    replay = ReplayScheduler(np.concatenate([np.zeros((2, 6), np.int32),
                                             ids_r]))
    tfed = TFed.build(task, num_clients=30, alpha=0.1,
                      samples_per_client=64, seed=5, scheduler=replay)
    assert tfed.epoch_steps(16) == K
    np.testing.assert_array_equal(tfed.client_sizes(), rfed.client_sizes())
    idx_t, w_t, ids_t = tfed.sample_block(0.2, K, b, round0=2, rounds=R)
    np.testing.assert_array_equal(idx_t, idx_r)
    np.testing.assert_array_equal(w_t, w_r)
    np.testing.assert_array_equal(ids_t, ids_r)
    batches_r, _, _ = rfed.sample_round(0.2, K, b, round_idx=3)
    batches_t, _, _ = tfed.sample_round(0.2, K, b, round_idx=3)
    for k in ("x", "y"):
        np.testing.assert_array_equal(batches_t[k], batches_r[k])
    for _ in range(2):   # the eval stream advances identically
        for a, c in zip(rfed.test_batch(100), tfed.test_batch(100)):
            np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(tfed.arena()["x"], rfed.arena()["x"])


@pytest.mark.parametrize("p,m", [(0.1, 100), (0.15, 10), (0.001, 50)])
def test_cohort_size_matches_reference(p, m):
    assert cohort_size(p, m) == rcohort(p, m)


def test_uniform_scheduler_is_keyed_on_seed_and_round():
    s = UniformScheduler(100, 10)
    a, b = s.sample(0, 3), s.sample(0, 3)
    np.testing.assert_array_equal(a, b)
    assert len(set(a.tolist())) == 10 and a.dtype == np.int32
    assert not np.array_equal(a, s.sample(0, 4))
    assert not np.array_equal(a, s.sample(1, 3))
    # every client is drawn about equally often
    counts = np.bincount(np.concatenate([s.sample(0, t)
                                         for t in range(2000)]), minlength=100)
    assert counts.min() > 140 and counts.max() < 270
    with pytest.raises(KeyError, match="lottery"):
        make_scheduler("lottery", num_clients=10, cohort=2)
