"""Nestable, thread-safe stage tracing (counterpart of
smartcal_tpu/obs/spans.py).

``span("solve")`` times a host-side region and records one ``span`` event
into the active RunLog on exit: name, nesting path (``/``-joined ancestor
names, per thread), wall duration, thread name and tags.  A span records
host wall time and adds no device synchronize: where a stage ends in one
of its own (``RadioBackend``'s stages), its span carries ``synced=True``,
so a reader knows the duration includes the device's time.

When torch is already imported, the region is also a
``torch.profiler.record_function`` range, so the stages show on a
``--trace`` timeline, spans entered from the episode-prefetch worker too
(the nesting stack here is per thread, as the profiler's ranges are).

Strict no-op contract: with no active RunLog, ``span()`` returns one
shared, stateless null context manager: no allocation, no clock read, no
profiler range.
"""

import sys
import threading
import time

from . import tracectx
from .runlog import RunLog, active

_tls = threading.local()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _record_function():
    """``torch.profiler.record_function`` if torch is already imported
    (never triggers the import), else None."""
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return None
    return getattr(getattr(torch_mod, "profiler", None), "record_function",
                   None)


class _NullSpan:
    """Shared do-nothing context manager (the inactive fast path)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def tag(self, **tags: object) -> "_NullSpan":
        return self


_NULL_SPAN = _NullSpan()


class Span:
    __slots__ = ("_rl", "name", "tags", "path", "_t0", "_ann", "_ids")

    def __init__(self, rl: "RunLog", name: str, tags: dict) -> None:
        self._rl = rl
        self.name = name
        self.tags = tags
        self.path = name
        self._t0 = 0.0
        self._ann = None
        self._ids = None

    def tag(self, **tags: object) -> "Span":
        """Attach or override tags after entry."""
        self.tags.update(tags)
        return self

    def __enter__(self):
        st = _stack()
        st.append(self.name)
        self.path = "/".join(st)
        self._ids = tracectx.push_span()
        rf = _record_function()
        if rf is not None:
            try:
                self._ann = rf(self.name)
                self._ann.__enter__()
            except Exception:
                self._ann = None
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb):
        dur = time.perf_counter() - self._t0
        if self._ann is not None:
            try:
                self._ann.__exit__(et, ev, tb)
            except Exception:
                pass
        st = _stack()
        if st and st[-1] == self.name:
            st.pop()
        rec = dict(self.tags)
        if et is not None:
            # a failed stage still records, with its error
            rec["error"] = repr(ev) if ev is not None else et.__name__
        if self._ids is not None and self._ids[1] is not None:
            rec["parent"] = self._ids[1]
        self._rl.log("span", name=self.name, path=self.path,
                     dur_s=round(dur, 6),
                     thread=threading.current_thread().name, **rec)
        if self._ids is not None:
            tracectx.pop_span(self._ids[0])
        return False


def span(name: str, **tags: object) -> "Span | _NullSpan":
    """Time a stage: ``with span("solve", route="fused"): ...``.  Returns
    the shared null context manager when no RunLog is active."""
    rl = active()
    if rl is None:
        return _NULL_SPAN
    return Span(rl, name, tags)
