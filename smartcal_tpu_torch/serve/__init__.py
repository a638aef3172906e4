"""Calibration as a service on the card (the port's counterpart of
smartcal_tpu/serve): programs warmed once and cached, micro-batched
heterogeneous jobs, a supervised server, a load generator, a replica fleet
and the online-learning lifecycle.

* :mod:`~smartcal_tpu_torch.serve.export`: the program cache keyed on the
  backend's ``serve_signature`` (the policy through ``torch.export``, the
  solve and influence as prepared programs), and the nvcc build directory
  as the compile cache;
* :mod:`~smartcal_tpu_torch.serve.router`: bounded admission and
  deadline-aware micro-batching of heterogeneous jobs into
  ``BatchedEpisode`` lanes;
* :mod:`~smartcal_tpu_torch.serve.server`: the supervised ``CalibServer``
  (a 1-slot ``runtime/supervisor.Fleet`` as circuit breaker, degraded-lane
  rescue, the numerics sentinel, SLO telemetry);
* :mod:`~smartcal_tpu_torch.serve.loadgen`: the open-loop (Poisson) load
  generator and the tiers;
* :mod:`~smartcal_tpu_torch.serve.fleet`: replicated ``CalibServer``
  processes on the card (sharing one cache, so replica N starts warm)
  behind the deadline-aware least-loaded ``FleetRouter``;
* :mod:`~smartcal_tpu_torch.serve.lifecycle`: tee served transitions into
  the sharded versioned replay, learn beside the server, publish policy
  hot-swaps through the cache.

Entry points: ``python -m smartcal_tpu_torch.tools.serve_calib`` (one
server), ``...tools.serve_fleet`` (replica topologies) and
``...tools.serve_learn`` (the online lifecycle).

Exports resolve lazily (PEP 562): a spawned replica process imports this
package on its way to the fleet's worker entry point, and a stub-server
replica need not import the backend, the solver or the agents.
"""

import importlib

_EXPORTS = {
    "ExportCache": ".export", "ServeProgram": ".export",
    "abstract_like": ".export", "enable_compile_cache": ".export",
    "prime_backend_kernels": ".export", "sig_digest": ".export",
    "AutoscalePolicy": ".fleet", "FleetRouter": ".fleet",
    "calib_worker_spec": ".fleet", "make_calib_server": ".fleet",
    "Job": ".router", "JobResult": ".router", "MicroBatcher": ".router",
    "ShedError": ".router",
    "CalibServer": ".server",
    "PolicyPublisher": ".lifecycle", "ServingLearner": ".lifecycle",
    "TransitionStage": ".lifecycle", "build_obs_pool": ".lifecycle",
    "job_obs_vec": ".lifecycle",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    submodule = _EXPORTS.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(submodule, __name__), name)
    globals()[name] = value              # cache: resolve once
    return value


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
