"""A numpy copy of ``dirichlet_partition`` from ``repro/data/dirichlet.py``
(bit-identical partitions).

Latent-Dirichlet non-iid client partitioner (Hsu et al. 2019), exactly the
paper's protocol: each client draws a label distribution q ~ Dir(α·p) and its
local examples are sampled label-by-label from that distribution.

α = 1 ≈ near-iid; α = 0.1 moderately skewed; α = 0.01 most clients see only
one or two classes (paper Fig. 8).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def dirichlet_partition(y: np.ndarray, num_clients: int, alpha: float,
                        samples_per_client: int = 500, *, seed: int = 0,
                        variable_sizes: Optional[Sequence[int]] = None
                        ) -> List[np.ndarray]:
    """Returns per-client index arrays into ``y``.

    variable_sizes: per-client n_i (paper Appendix B.3 uses
    n_i ~ U[100, 500]); default = samples_per_client for all.
    """
    rng = np.random.default_rng(seed)
    num_classes = int(y.max()) + 1
    by_class = [np.flatnonzero(y == c) for c in range(num_classes)]
    ptr = [0] * num_classes
    for c in range(num_classes):
        rng.shuffle(by_class[c])

    prior = np.full(num_classes, 1.0 / num_classes)
    sizes = (list(variable_sizes) if variable_sizes is not None
             else [samples_per_client] * num_clients)

    clients = []
    for i in range(num_clients):
        q = rng.dirichlet(alpha * prior * num_classes)
        counts = rng.multinomial(sizes[i], q)
        idx = []
        for c, n_c in enumerate(counts):
            take = by_class[c][ptr[c]:ptr[c] + n_c]
            if len(take) < n_c:  # class exhausted: resample with replacement
                extra = rng.choice(by_class[c], n_c - len(take))
                take = np.concatenate([take, extra])
            ptr[c] += n_c
            idx.append(take)
        idx = np.concatenate(idx) if idx else np.empty((0,), np.int64)
        rng.shuffle(idx)
        clients.append(idx.astype(np.int64))
    return clients
