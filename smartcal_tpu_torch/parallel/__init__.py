"""Distributed training and sharded calibration of the port (counterpart of
smartcal_tpu/parallel): the mesh registry and meshes of positions
(``mesh``), the sharded calibration routes (``sharded_cal``, imported as a
submodule by its callers, as in the JAX package, so that importing this
package does not import the solver), the simulated multi-host edge
(``multihost``), the batched SAC trainer (``trainer``), the distributed PER
learners and their supervised actor fleets for the elastic-net
(``learner``) and demixing (``demix_learner``) workloads."""

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
