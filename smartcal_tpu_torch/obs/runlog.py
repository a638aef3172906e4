"""Run-scoped JSONL event log (counterpart of smartcal_tpu/obs/runlog.py,
kept as the port's own copy).

One training run = one ``RunLog``: a JSONL stream whose first line is a
header record (run id, schema version, host and device metadata) and whose
other lines are events (``episode``, ``span``, ``solver``, ``gauge``,
``diag``, ...).  The stream is the JAX package's, same schema version:

* non-finite floats serialize as ``null`` (bare ``NaN`` is not JSON);
* writes buffer up to ``flush_lines`` lines or ``flush_interval`` seconds;
* at ``max_bytes`` the stream rotates to ``<path>.<n>`` and a fresh header
  (same run id, incremented ``rotated``) opens the new segment;
* writes serialize on one lock: spans are recorded from the episode
  prefetch worker too.

The module also owns the active-run registry: ``activate`` / ``deactivate``
push and pop the process-wide current ``RunLog``, ``active()`` reads it.
Every other obs primitive is a strict no-op when no run is recording.
Standard library only; torch is read from ``sys.modules`` for the header.
"""

import contextlib
import json
import math
import os
import socket
import sys
import threading
import time
from typing import Iterator, Optional

from . import flightrec, tracectx

# Schema history (the JAX package's; the header's ``schema`` field):
# 1 — run_header / episode / span / solver / gauge / counters / memory /
#     probe / log / result / run_end (the JAX package's compile events are
#     ``jax_event``; the port's are ``compile``, obs/registry.py).
# 2 — ``diag`` (obs/diagnostics.py), ``replay_health``
#     (rl/replay.replay_health), ``watchdog_trip`` (obs/watchdog.py); the
#     JAX package's ``cost`` / ``roofline_peak`` have no port counterpart
#     yet (ROADMAP queue 1 item 12).
# 3 — optional ``trace`` / ``span`` / ``parent`` ids on any event
#     (obs/tracectx.py); ``clock_offset`` (per-peer skew from IPC envelope
#     send/receive times), ``slo_burn`` (obs/slo.py) and ``blackbox_flush``
#     (flight-recorder dump header, obs/flightrec.py).
SCHEMA_VERSION = 3


def _gen_run_id() -> str:
    return f"{int(time.time()):x}-{os.urandom(4).hex()}"


def sanitize(v: object) -> object:
    """Recursively convert ``v`` into JSON-safe data: non-finite floats ->
    None, numpy/torch scalars -> python scalars, arrays -> (sanitized)
    lists, unknown objects -> ``str``."""
    if v is None or isinstance(v, (bool, int, str)):
        return v
    if isinstance(v, float):                 # covers np.float64 (subclass)
        return v if math.isfinite(v) else None
    if isinstance(v, dict):
        return {str(k): sanitize(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [sanitize(x) for x in v]
    if getattr(v, "ndim", None) == 0 and hasattr(v, "item"):
        try:
            return sanitize(v.item())        # numpy / torch scalar
        except Exception:
            return str(v)
    if hasattr(v, "tolist"):
        try:
            return sanitize(v.tolist())      # numpy / torch array
        except Exception:
            return str(v)
    return str(v)


def _device_meta() -> dict:
    """Host/device metadata for the header.  Reads torch ONLY if it is
    already imported (never triggers the import) and probes the card only
    when CUDA is available; a failed probe is recorded, never raised.
    SMARTCAL_OBS_NO_DEVICE_META=1 skips the device probe."""
    meta = {"host": socket.gethostname(), "pid": os.getpid(),
            "python": sys.version.split()[0]}
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return meta
    try:
        meta["torch"] = torch_mod.__version__
        meta["cuda"] = torch_mod.version.cuda
    except Exception:
        pass
    if os.environ.get("SMARTCAL_OBS_NO_DEVICE_META", "") == "1":
        return meta
    try:
        cuda = torch_mod.cuda
        if not cuda.is_available():
            meta["platform"] = "cpu"
            return meta
        n = cuda.device_count()
        meta["platform"] = "gpu"
        meta["n_devices"] = n
        meta["devices"] = [cuda.get_device_name(i) for i in range(min(n, 8))]
    except Exception as e:                   # no driver, busy card, ...
        meta["device_probe_error"] = repr(e)
    return meta


def _multihost():
    """The port's ``parallel/multihost`` inside a job of several processes
    (read from ``sys.modules``), else None."""
    mh = sys.modules.get("smartcal_tpu_torch.parallel.multihost")
    return mh if mh is not None and mh.is_initialized() else None


class RunLog:
    """Append-mode, buffered, rotating JSONL event stream (``None`` path
    disables it — every method is then a no-op).  In a job of several
    processes each rank writes its own file (``<stem>.rank<r><ext>``,
    ``parallel/multihost.rank_path``) and the header carries the rank's
    ``runtime_summary()``."""

    def __init__(self, path: Optional[str], run_id: Optional[str] = None,
                 flush_interval: float = 2.0, flush_lines: int = 64,
                 max_bytes: int = 256 * 1024 * 1024, header: bool = True,
                 meta: Optional[dict] = None):
        self.run_id = run_id or _gen_run_id()
        mh = _multihost()
        if path and mh is not None:
            path = mh.rank_path(path)
        self._path = path
        self._lock = threading.RLock()
        self._buf: list = []
        self._flush_interval = max(0.0, float(flush_interval))
        self._flush_lines = max(1, int(flush_lines))
        self._max_bytes = int(max_bytes)
        self._header = header
        self._meta = dict(meta or {})
        self._rotations = 0
        self._last_flush = time.monotonic()
        if path:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(path, "a")
            try:
                self._bytes = os.path.getsize(path)
            except OSError:
                self._bytes = 0
            if header:
                self._write_header()
        else:
            self._fh = None
            self._bytes = 0

    @property
    def path(self) -> Optional[str]:
        return self._path

    def _write_header(self):
        rec = {"t": round(time.time(), 3), "event": "run_header",
               "schema": SCHEMA_VERSION, "run_id": self.run_id,
               "rotated": self._rotations, "argv": sys.argv}
        rec.update(_device_meta())
        mh = _multihost()
        if mh is not None:
            rec["multihost"] = mh.runtime_summary()
        if self._meta:
            rec["meta"] = self._meta
        self._emit(rec, force_flush=True)

    def log(self, event: str, **fields: object) -> None:
        """Append one event record (buffered; see class docstring)."""
        if self._fh is None:
            return
        rec = {"t": round(time.time(), 3), "event": event}
        tf = tracectx.current_fields()
        if tf:
            rec.update(tf)       # explicit fields below may override
        rec.update(fields)
        self._emit(rec)

    def _emit(self, rec, force_flush: bool = False):
        line = json.dumps(sanitize(rec), allow_nan=False) + "\n"
        flightrec.record_line(line)   # flight-recorder tee (no-op unarmed)
        with self._lock:
            if self._fh is None:
                return
            self._buf.append(line)
            self._bytes += len(line)
            now = time.monotonic()
            if (force_flush or len(self._buf) >= self._flush_lines
                    or now - self._last_flush >= self._flush_interval):
                self._flush_locked()
            if self._bytes >= self._max_bytes:
                self._rotate_locked()

    def _flush_locked(self):
        if self._buf:
            self._fh.write("".join(self._buf))
            self._fh.flush()
            self._buf.clear()
        self._last_flush = time.monotonic()

    def _rotate_locked(self):
        """Close the full segment as ``<path>.<n>`` and reopen fresh (same
        run-id; the new header carries the incremented ``rotated``)."""
        self._flush_locked()
        self._fh.close()
        self._rotations += 1
        os.replace(self._path, f"{self._path}.{self._rotations}")
        self._fh = open(self._path, "a")
        self._bytes = 0
        if self._header:
            self._write_header()

    def flush(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._flush_locked()

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._flush_locked()
                self._fh.close()
                self._fh = None

    @property
    def closed(self) -> bool:
        return self._fh is None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Active-run registry (process-wide; shared across threads on purpose — the
# prefetch worker must record into the run its parent opened)
# ---------------------------------------------------------------------------

_active_stack: list = []
_active_lock = threading.Lock()


def activate(runlog: RunLog) -> RunLog:
    """Make ``runlog`` the process-wide active run (stack discipline)."""
    with _active_lock:
        _active_stack.append(runlog)
    return runlog


def deactivate(runlog: Optional[RunLog] = None) -> None:
    """Pop the active run (or remove ``runlog`` specifically)."""
    with _active_lock:
        if not _active_stack:
            return
        if runlog is None:
            _active_stack.pop()
        elif runlog in _active_stack:
            _active_stack.remove(runlog)


def active() -> Optional[RunLog]:
    """The currently recording RunLog, or None (the no-op fast path)."""
    try:
        return _active_stack[-1]
    except IndexError:
        return None


@contextlib.contextmanager
def recording(path_or_runlog: "str | RunLog",
              **kwargs: object) -> Iterator[RunLog]:
    """``with recording("run.jsonl") as rl:`` — create (when given a
    path), activate, and on exit deactivate (and close only if created
    here)."""
    created = not isinstance(path_or_runlog, RunLog)
    rl = RunLog(path_or_runlog, **kwargs) if created else path_or_runlog
    activate(rl)
    try:
        yield rl
    finally:
        deactivate(rl)
        if created:
            rl.close()
