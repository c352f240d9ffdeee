"""Multi-device layouts: the mesh, parameter specs and collectives
(mesh.py), and joining a process group across hosts (multihost.py)."""

from .mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    batch_sharding,
    make_mesh,
    param_pspecs,
    param_shardings,
    replicated,
    shard_params,
)

__all__ = [
    "DATA_AXIS",
    "MODEL_AXIS",
    "batch_sharding",
    "make_mesh",
    "param_pspecs",
    "param_shardings",
    "replicated",
    "shard_params",
]
