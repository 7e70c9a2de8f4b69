"""Production mesh factory for H100 hosts of 8 GPUs joined by NVLink.

  single-pod : (data=32, model=8)            = 256 GPUs
  multi-pod  : (pod=2, data=32, model=8)     = 512 GPUs

The reference's TPU mesh is (16, 16) a pod: its ICI torus carries the
tensor axis across 16 chips. Here the tensor axis stays inside one
NVLink domain (the 8 GPUs of a host, ranks row-major so a ``model``
group is one host) and the data axes cross hosts over InfiniBand. So
``data`` is 32 where the reference's is 16, and a ``cross_device``
federation has ``clients_on`` = 32 clients a pod, not 16.

With ranks present (``torch.distributed`` initialised with as many
ranks as the mesh) the mesh is a ``DeviceMesh`` through
``repro_torch.sharding.dist.make_mesh``; otherwise it is an
``AbstractMesh`` (the dry run's: shapes and one rank's coordinates, no
process group). Importing this module touches no device.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import torch.distributed as tdist

from repro_torch.sharding import dist

# GPUs joined by NVLink in one host: the tensor axis's size
GPUS_PER_HOST = 8


def production_shape(multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 32, "model": GPUS_PER_HOST}
    return {"data": 32, "model": GPUS_PER_HOST}


def make_production_mesh(*, multi_pod: bool = False,
                         coords: Optional[Dict[str, int]] = None):
    """The production mesh: a DeviceMesh when this process is one of
    that many ranks, else the abstract mesh seen from ``coords`` (every
    axis at 0 by default)."""
    shape = production_shape(multi_pod)
    if tdist.is_initialized() and \
            tdist.get_world_size() == math.prod(shape.values()):
        return dist.make_mesh(tuple(shape.values()), tuple(shape))
    return dist.AbstractMesh(shape, coords)


def make_debug_mesh(shape: Sequence[int] = (1, 1),
                    axes: Sequence[str] = ("data", "model")):
    """A small DeviceMesh over the current process group (CPU tests)."""
    return dist.make_mesh(shape, axes)
