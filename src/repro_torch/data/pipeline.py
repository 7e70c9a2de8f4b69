"""Federated batching: the cohort draw and (C, K, b, ...) round batches.

Port of ``FederatedDataset`` and ``lm_round_batches`` (the LM trainer's
synthetic token batches) from ``repro/data/pipeline.py``. Everything
here is numpy on the host, as in the reference. The within-client
example draw (``default_rng([seed + 17, t])``) and the eval stream
(``default_rng(seed + 23)``) are the reference's, so given the same
cohort ids the port gathers bit-identical batches. The cohort itself
is keyed on the round: an explicit ``scheduler`` (``sample(seed, t)``,
the hook a test uses to replay the reference's ids) wins; otherwise a
``scenario`` draws it from its scheduler kind and seed
(``Scenario.draw_cohort``, the same draw the round reports); otherwise
it is the uniform scheduler over all clients on the dataset seed.

Fleet regime (``num_registered``): the cohort is drawn over
C_registered >> C virtual clients while the dataset keeps only
``num_clients`` physical partitions; registered client i trains on
partition ``i % num_clients``. Cohort draws and weights key on the
REGISTERED id (what the fleet loop's ``ClientArena`` is indexed by);
only the example gather maps down to the partition, so a 10^5-client
fleet costs no extra dataset memory.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from repro_torch.data.dirichlet import dirichlet_partition
from repro_torch.data.synthetic import TaskData
from repro_torch.federation.schedulers import UniformScheduler, cohort_size


@dataclass
class FederatedDataset:
    task: TaskData
    clients: List[np.ndarray]          # per-client example indices
    seed: int = 0                      # cohort and example draws
    eval_rng: Optional[np.random.Generator] = None
    # object with ``cohort`` and ``sample(seed, t) -> (cohort,) ids``;
    # None leaves the draw to the scenario, or to the uniform scheduler
    scheduler: object = None
    scenario: object = None            # repro_torch.federation.Scenario
    # fleet regime: registered (virtual) clients >= physical partitions;
    # registered id i maps to partition i % num_clients. None: registered
    # == num_clients
    num_registered: Optional[int] = None

    @classmethod
    def build(cls, task: TaskData, *, num_clients: int, alpha: float,
              samples_per_client: int = 500, seed: int = 0,
              variable_sizes=None, scheduler=None, scenario=None,
              num_registered: Optional[int] = None) -> "FederatedDataset":
        clients = dirichlet_partition(task.y, num_clients, alpha,
                                      samples_per_client, seed=seed,
                                      variable_sizes=variable_sizes)
        return cls(task, clients, seed=seed,
                   eval_rng=np.random.default_rng(seed + 23),
                   scheduler=scheduler, scenario=scenario,
                   num_registered=num_registered)

    @property
    def num_clients(self) -> int:
        return len(self.clients)

    @property
    def registered_clients(self) -> int:
        """C_registered, what the cohort is drawn over (>= num_clients)."""
        m = self.num_registered
        if m is not None and m < len(self.clients):
            raise ValueError(f"num_registered={m} < {len(self.clients)} "
                             "physical partitions")
        return len(self.clients) if m is None else m

    def client_sizes(self) -> np.ndarray:
        return np.array([len(c) for c in self.clients], np.float32)

    def registered_sizes(self) -> np.ndarray:
        """(C_registered,) sizes per REGISTERED client: the partition
        sizes cycled over the virtual ids (one numpy array)."""
        sizes = self.client_sizes()
        m = self.registered_clients
        if m == len(self.clients):
            return sizes
        return sizes[np.arange(m) % len(self.clients)]

    def _cohort_ids(self, C: int, t: int) -> np.ndarray:
        sch = self.scheduler
        if sch is not None:
            if sch.cohort != C:
                raise ValueError(f"scheduler draws cohorts of {sch.cohort}, "
                                 f"the round needs {C}")
            return np.asarray(sch.sample(self.seed, t))
        if self.scenario is not None:
            return self.scenario.draw_cohort(t, self.registered_clients, C,
                                             sizes=self.registered_sizes())
        return UniformScheduler(self.registered_clients, C).sample(
            self.seed, t)

    def sample_round_indices(self, participation: float, local_steps: int,
                             batch_size: int, round_idx: int):
        """Cohort draw + within-client example draw WITHOUT gathering:
        (take (C, K, b) int32 indices into the task arrays, client
        weights (C,), client ids (C,)). Both draws are keyed on
        (seed, round), never on call history. The ids are REGISTERED
        ids; the example gather maps them to partitions."""
        m = self.num_clients
        C = cohort_size(participation, self.registered_clients)
        t = int(round_idx)
        ids = self._cohort_ids(C, t)
        ex_rng = np.random.default_rng([self.seed + 17, t])
        takes = []
        for i in ids:
            idx = self.clients[i % m]
            take = ex_rng.choice(idx, size=local_steps * batch_size,
                                 replace=len(idx) < local_steps * batch_size)
            takes.append(take.reshape(local_steps, batch_size))
        weights = self.client_sizes()[ids % m]
        return (np.stack(takes).astype(np.int32),
                weights.astype(np.float32), ids)

    def sample_round(self, participation: float, local_steps: int,
                     batch_size: int, round_idx: int):
        """(client_batches {"x", "y"} of (C, K, b, ...) arrays,
        client_weights (C,), client_ids (C,))."""
        take, weights, ids = self.sample_round_indices(
            participation, local_steps, batch_size, round_idx)
        batches = {"x": self.task.x[take], "y": self.task.y[take]}
        return batches, weights, ids

    def sample_block(self, participation: float, local_steps: int,
                     batch_size: int, *, round0: int, rounds: int):
        """R rounds of gather indices for ONE round-fused loop call:
        (idx (R, C, K, b) int32, weights (R, C), ids (R, C)), equal to R
        ``sample_round_indices`` calls for rounds round0..round0+R-1."""
        take, w, ids = zip(*(self.sample_round_indices(
            participation, local_steps, batch_size, round_idx=round0 + r)
            for r in range(rounds)))
        return np.stack(take), np.stack(w), np.stack(ids)

    def arena(self):
        """The example arena the fused loop gathers from: the full task
        arrays, staged on the device once per run."""
        return {"x": self.task.x, "y": self.task.y}

    def epoch_steps(self, batch_size: int) -> int:
        """K for one local epoch (paper: K = E·n_i / b with E = 1)."""
        n = int(np.median(self.client_sizes()))
        return max(1, n // batch_size)

    def test_batch(self, n: Optional[int] = None):
        if n is None or n >= len(self.task.y_test):
            return self.task.x_test, self.task.y_test
        idx = self.eval_rng.choice(len(self.task.y_test), n, replace=False)
        return self.task.x_test[idx], self.task.y_test[idx]


def lm_round_batches(rng: np.random.Generator, *, clients: int,
                     local_steps: int, batch: int, seq: int, vocab: int,
                     extras: Optional[Dict] = None):
    """Synthetic LM round batch: (C, K, b, S) int32 tokens and their
    next-token labels, from ``rng`` (the reference's draw, bit for bit).
    ``extras`` ({name: per-sequence shape}) adds stub-frontend inputs
    (``frames``, ``image_embeds``) of (C, K, b, ...) f32 standard
    normals, drawn after the tokens in ``extras``' order, as the
    reference draws them."""
    toks = rng.integers(0, vocab, (clients, local_steps, batch, seq + 1),
                        dtype=np.int32)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    for k, shape in (extras or {}).items():
        out[k] = rng.normal(size=(clients, local_steps, batch) + tuple(shape)
                            ).astype(np.float32)
    return out
