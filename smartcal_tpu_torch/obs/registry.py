"""Counters, gauges, device memory and compile events (counterpart of
smartcal_tpu/obs/registry.py).

Counters accumulate in memory while a RunLog is active and are written as
one ``counters`` event by :func:`flush_counters`; gauges log at once as
``gauge`` events.  Both are strict no-ops with no active RunLog.

* :func:`log_memory_gauges` samples ``torch.cuda.memory_stats`` (bytes
  allocated now and at peak, and the card's total memory) into ``memory``
  events; it does nothing on the CPU or when torch is not imported.
* :func:`install_compile_listener` arms ``compile`` events for the port's
  own compiles, which report through :func:`record_compile`: each
  ``ops/build.py`` nvcc build and each CUDA-graph capture of the quartic
  line search (``cal/solver._QuarticLineSearch``).  The JAX package's
  listener hooks ``jax.monitoring``; torch has no such stream, so the port's
  compile sites call in.

Standard library only; torch is read from ``sys.modules``.
"""

import sys
import threading

from .runlog import active

_lock = threading.Lock()
_counters: dict = {}


def counter_add(name: str, value: float = 1.0) -> None:
    """Accumulate ``value`` onto counter ``name`` (no-op when inactive)."""
    if active() is None:
        return
    with _lock:
        _counters[name] = _counters.get(name, 0.0) + value


def gauge_set(name: str, value: object, **tags: object) -> None:
    """Log gauge ``name`` as a ``gauge`` event (no-op when inactive)."""
    rl = active()
    if rl is None:
        return
    rl.log("gauge", name=name, value=value, **tags)


def counters_snapshot() -> dict:
    with _lock:
        return dict(_counters)


def flush_counters(reset: bool = False, **tags: object) -> None:
    """Write all accumulated counters as one ``counters`` event;
    ``reset=True`` clears them afterwards (a later run in the same process
    starts from zero)."""
    rl = active()
    if rl is None:
        return
    with _lock:
        snap = dict(_counters)
        if reset:
            _counters.clear()
    if snap:
        rl.log("counters", values=snap, **tags)


def reset_counters() -> None:
    with _lock:
        _counters.clear()


# ---------------------------------------------------------------------------
# compile events
# ---------------------------------------------------------------------------

_listener_installed = False


def install_compile_listener() -> bool:
    """Arm ``compile`` events from the port's compile sites (idempotent)."""
    global _listener_installed
    _listener_installed = True
    return True


def record_compile(key: str, dur_s: float, **fields: object) -> None:
    """One compile of the port (``nvcc:<source>``, ``cuda_graph:<what>``):
    a ``compile`` event plus the ``compile_events`` / ``compile_secs``
    counters and ``compile_events:<kind>`` by the key's prefix (``nvcc``,
    ``cuda_graph``), when the listener is installed and a run is
    recording.  The event names the thread that compiled."""
    rl = active()
    if rl is None or not _listener_installed:
        return
    rl.log("compile", key=key, dur_s=round(float(dur_s), 4),
           thread=threading.current_thread().name, **fields)
    kind = "compile_events:" + key.split(":", 1)[0]
    with _lock:
        _counters[kind] = _counters.get(kind, 0.0) + 1.0
        _counters["compile_events"] = _counters.get("compile_events",
                                                    0.0) + 1.0
        _counters["compile_secs"] = _counters.get("compile_secs",
                                                  0.0) + float(dur_s)


def log_memory_gauges() -> int:
    """``memory`` events from ``torch.cuda.memory_stats`` per visible card;
    returns the number of cards that reported (0 when inactive, when torch
    is not imported, or without CUDA)."""
    rl = active()
    if rl is None:
        return 0
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return 0
    try:
        cuda = torch_mod.cuda
        if not cuda.is_available() or not cuda.is_initialized():
            return 0
        n_dev = cuda.device_count()
    except Exception:
        return 0
    n = 0
    for d in range(n_dev):
        try:
            ms = cuda.memory_stats(d)
            total = cuda.get_device_properties(d).total_memory
        except Exception:
            continue
        if not ms:
            continue
        rl.log("memory", device=d, platform="gpu",
               bytes_in_use=ms.get("allocated_bytes.all.current"),
               peak_bytes_in_use=ms.get("allocated_bytes.all.peak"),
               bytes_limit=total)
        n += 1
    return n
