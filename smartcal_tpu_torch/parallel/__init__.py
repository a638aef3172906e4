"""Distributed training of the port (counterpart of smartcal_tpu/parallel)
on one GPU: the mesh registry collapsed onto one device (``mesh``), the
simulated multi-host edge (``multihost``), the batched SAC trainer
(``trainer``), the distributed PER learners and their supervised actor
fleets for the elastic-net (``learner``) and demixing (``demix_learner``)
workloads."""

from .mesh import (  # noqa: F401
    AXIS_BASELINE,
    AXIS_CHUNK,
    AXIS_DATA,
    AXIS_FREQ,
    AXIS_LANE,
    AXIS_REPLAY,
    MESH_AXES,
    Mesh,
    MeshFactorizationError,
    compose_mesh,
    make_mesh,
    nearest_factorization,
)
from . import multihost  # noqa: F401
from .trainer import (  # noqa: F401
    ParallelTrainState,
    episode_scores,
    make_parallel_sac,
)
