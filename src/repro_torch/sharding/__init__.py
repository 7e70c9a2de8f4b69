"""Multi-device federation: how FL roles map onto a mesh of
``torch.distributed`` ranks (``spec``), the process-group runtime and
its collectives (``dist``), and the collective recorder with the
sharding checks that read it (``hlo``). Port of ``repro/sharding``."""
from repro_torch.sharding.spec import (FederationSpec, axes_size,
                                       cross_device, cross_silo,
                                       get_federation_spec, mesh_shape)

__all__ = ["FederationSpec", "axes_size", "cross_device", "cross_silo",
           "get_federation_spec", "mesh_shape"]
