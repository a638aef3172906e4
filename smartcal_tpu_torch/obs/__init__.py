"""Run-scoped observability of the port (counterpart of
smartcal_tpu/obs): RunLog (JSONL events), span tracing, counters and
gauges, device memory, compile events, update diagnostics and the
divergence watchdog.

Quick use::

    from smartcal_tpu_torch import obs

    with obs.recording("run.jsonl", meta={"entry": "my_tool"}):
        obs.install_compile_listener()
        with obs.span("episode", episode=0):
            ...                       # nested spans record stage timings
        obs.active().log("episode", episode=0, score=1.2)

Everything is a strict no-op while no RunLog is active; aggregate a run
with ``tools/obs_report.py``.  The package imports neither torch nor
numpy: it reads torch from ``sys.modules`` only, so importing it never
initialises a device.  The baseline store (``baselines``: fingerprinted
per-stage baselines and the bf16 band ``BF16_REL_BAND``) and the
noise-aware detector (``regress``) are the JAX package's, with the port's
own host fingerprint; ``smartcal_tpu_torch.tools.perf_gate`` runs them as
a gate.  ``costs`` is the per-stage flops/bytes accounting and the card's
roofline peak (the JAX package's API and events, counted by running the
stage under a dispatch mode).  The serving fleet's parts are the JAX
package's too: the SLO burn-rate detector (``slo``), the crash flight
recorder (``flightrec``, teed from every RunLog line) and the timeline
collector (``collect``).
"""

from . import (baselines, collect, costs, flightrec,       # noqa: F401
               regress, slo, tracectx)
from .baselines import (BF16_REL_BAND, BaselineStore,      # noqa: F401
                        host_fingerprint)
from .console import echo, emit_json                       # noqa: F401
from .costs import (device_peak, log_roofline_peak,        # noqa: F401
                    record_stage_cost, stage_cost)
from .diagnostics import (UpdateDiag, diag_steps,          # noqa: F401
                          diag_to_host, make_diag, stack_diags, zero_diag)
from .flightrec import (arm_flight_recorder,               # noqa: F401
                        flight_recorder_stats, flush_flight_recorder,
                        note_shed)
from .registry import (counter_add, counters_snapshot,     # noqa: F401
                       flush_counters, gauge_set, install_compile_listener,
                       log_memory_gauges, record_compile, reset_counters)
from .runlog import (SCHEMA_VERSION, RunLog, activate,     # noqa: F401
                     active, deactivate, recording, sanitize)
from .slo import SloBurnDetector                           # noqa: F401
from .spans import span                                    # noqa: F401
from .watchdog import Watchdog, WatchdogConfig             # noqa: F401


def log_solver_stats(stats: "object", **tags: object) -> None:
    """Record a ``solver`` event from a ``cal.solver.SolverStats`` (one
    small host transfer; called only while a RunLog is active).

    ``phi_evals_per_linesearch`` is the port's own count: the mean number
    of quartic evaluations per strong-Wolfe search in this solve
    (``SolverStats.phi_evals`` / ``SolverStats.linesearches``): 50 on the
    card, where the search is a CUDA graph that runs every branch, and
    fewer on the CPU, where the search skips the work no lane needs."""
    rl = active()
    if rl is None or stats is None:
        return
    inner = [int(v) for v in list(stats.inner_iters)]
    total_inner = sum(inner) + int(stats.init_iters)
    n_ls = int(stats.linesearches)
    per_ls = float(stats.phi_evals) / n_ls if n_ls else 0.0
    rl.log("solver",
           admm_iters=int(stats.admm_iters),
           primal_resid=[float(v) for v in list(stats.primal_resid)],
           inner_iters=inner,
           init_iters=int(stats.init_iters),
           n_segments=int(stats.n_segments),
           lbfgs_iters_total=total_inner,
           phi_evals_per_linesearch=per_ls,
           phi_evals_est=total_inner * per_ls,
           **tags)
