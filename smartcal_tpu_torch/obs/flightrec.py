"""Crash flight recorder: a bounded ring of recent events per process
(the port's copy of smartcal_tpu/obs/flightrec.py, same semantics).

Without it a postmortem of a fleet incident (a back-pressure halt, a
kill/requeue run) has only what the buffered RunLog happened to flush
before the process died.  When **armed**, every serialized event
line that passes through :meth:`RunLog._emit <smartcal_tpu_torch.obs.runlog.
RunLog._emit>` is also teed into an in-memory ring (independent of the
flush cadence), and :func:`flush` dumps the ring to
``blackbox_<pid>.jsonl`` in the armed directory the moment something
goes wrong — crash, circuit-open, shed burst, watchdog trip.

Each dump is self-describing: a ``blackbox_flush`` header line
(reason, pid, wall time, ring depth) followed by the ring contents,
appended so repeated trips in one process life stay ordered.  Dumps of
the same reason are rate-limited (default one per 5 s) so a shed storm
does not turn the recorder into its own I/O incident.

Armed by default in fleet workers (replica + actor worker mains);
training/bench entry points stay disarmed unless they opt in.  The ring
is process-global on purpose — one process, one black box.
"""

from __future__ import annotations

import collections
import os
import threading
import time
from typing import Deque, Dict, Optional

DEFAULT_CAPACITY = 512
_MIN_FLUSH_GAP_S = 5.0
# a shed BURST (>= _BURST_N sheds inside _BURST_WINDOW_S seconds)
# triggers a flush; isolated sheds are normal overload behavior
_BURST_N = 8
_BURST_WINDOW_S = 2.0


class FlightRecorder:
    """The per-process ring + dump machinery (module singleton below)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._ring: Optional[Deque[str]] = None
        self._dir: Optional[str] = None
        self._flushes: Dict[str, float] = {}
        self._n_flushes = 0
        self._shed_times: Deque[float] = collections.deque(maxlen=64)

    def arm(self, directory: str,
            capacity: int = DEFAULT_CAPACITY) -> None:
        """Start recording: tee every RunLog line into a ring of at most
        ``capacity`` events, dumping into ``directory`` on flush."""
        os.makedirs(directory, exist_ok=True)
        with self._lock:
            self._dir = directory
            self._ring = collections.deque(maxlen=max(1, int(capacity)))
            self._flushes.clear()

    def disarm(self) -> None:
        with self._lock:
            self._ring = None
            self._dir = None

    @property
    def armed(self) -> bool:
        return self._ring is not None

    def record_line(self, line: str) -> None:
        """Tee one serialized JSONL line (newline included) into the
        ring.  No-op when disarmed — one attribute read on the fast
        path, same bar as the spans null contract."""
        ring = self._ring
        if ring is None:
            return
        with self._lock:
            if self._ring is not None:
                self._ring.append(line)

    def flush(self, reason: str,
              extra: Optional[dict] = None) -> Optional[str]:
        """Dump the ring to ``blackbox_<pid>.jsonl``; returns the path
        (None when disarmed or rate-limited for this ``reason``)."""
        import json                      # stdlib; local to keep arm cheap

        with self._lock:
            if self._ring is None or self._dir is None:
                return None
            now = time.monotonic()
            last = self._flushes.get(reason)
            if last is not None and now - last < _MIN_FLUSH_GAP_S:
                return None
            self._flushes[reason] = now
            self._n_flushes += 1
            lines = list(self._ring)
            path = os.path.join(self._dir,
                                f"blackbox_{os.getpid()}.jsonl")
            header = {"t": round(time.time(), 3),
                      "event": "blackbox_flush", "reason": reason,
                      "pid": os.getpid(), "n_events": len(lines),
                      "flush_no": self._n_flushes}
            if extra:
                header.update(extra)
            with open(path, "a") as fh:
                fh.write(json.dumps(header) + "\n")
                fh.writelines(lines)
                fh.flush()
                os.fsync(fh.fileno())
            return path

    def note_shed(self, now: Optional[float] = None) -> None:
        """Count one shed toward burst detection; a burst flushes the
        ring with reason ``shed_burst`` (rate-limited like any flush)."""
        if self._ring is None:
            return
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._shed_times.append(t)
            recent = sum(1 for x in self._shed_times
                         if t - x <= _BURST_WINDOW_S)
        if recent >= _BURST_N:          # flush takes the lock itself
            self.flush("shed_burst", {"sheds_in_window": recent})

    def stats(self) -> dict:
        with self._lock:
            return {"armed": self._ring is not None,
                    "depth": len(self._ring) if self._ring else 0,
                    "flushes": self._n_flushes}


_RECORDER = FlightRecorder()


def arm(directory: str, capacity: int = DEFAULT_CAPACITY) -> None:
    """Arm the process-wide flight recorder (see :class:`FlightRecorder`)."""
    _RECORDER.arm(directory, capacity)


def disarm() -> None:
    """Disarm and drop the ring."""
    _RECORDER.disarm()


def armed() -> bool:
    """Whether the process-wide recorder is currently armed."""
    return _RECORDER.armed


def record_line(line: str) -> None:
    """RunLog's tee point — one serialized event line into the ring."""
    _RECORDER.record_line(line)


def flush(reason: str, extra: Optional[dict] = None) -> Optional[str]:
    """Dump the ring now (crash / circuit_open / shed_burst /
    watchdog_trip); returns the blackbox path or None."""
    return _RECORDER.flush(reason, extra)


def note_shed(now: Optional[float] = None) -> None:
    """One shed toward the burst detector (see FlightRecorder)."""
    _RECORDER.note_shed(now)


def stats() -> dict:
    """Armed flag, current ring depth, lifetime flush count."""
    return _RECORDER.stats()


# unambiguous names for the obs package namespace (``obs.arm`` would
# read as nonsense at call sites; ``obs.arm_flight_recorder`` doesn't)
arm_flight_recorder = arm
flush_flight_recorder = flush
flight_recorder_stats = stats
