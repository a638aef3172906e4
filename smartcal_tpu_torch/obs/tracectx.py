"""Span ids of the adopted trace (the in-process part of
smartcal_tpu/obs/tracectx.py).

The thread-local active trace is what :func:`current_fields` reads:
:meth:`RunLog.log <smartcal_tpu_torch.obs.runlog.RunLog.log>` attaches it
to every event, and :class:`~smartcal_tpu_torch.obs.spans.Span` allocates
child span ids from it.  The cross-process carrier (envelopes, clock
offsets, ``use_trace`` across IPC) belongs to the serving slice (ROADMAP
queue 1 item 14); :func:`use_trace` adopts a carrier within the process.

Strict no-op contract: with no adopted trace :func:`current_fields`
returns the shared empty dict and :func:`push_span` returns None.
Standard library only.
"""

import contextlib
import os
import threading
from typing import Dict, Iterator, Optional, Tuple

_tls = threading.local()

_EMPTY: Dict[str, object] = {}


def new_trace_id() -> str:
    """A fresh 16-byte (32 hex character) trace id."""
    return os.urandom(16).hex()


def new_span_id() -> str:
    """A fresh 8-byte (16 hex character) span id."""
    return os.urandom(8).hex()


def _trace() -> Optional[str]:
    return getattr(_tls, "trace", None)


def _stack() -> list:
    st = getattr(_tls, "spans", None)
    if st is None:
        st = _tls.spans = []
    return st


def current_fields() -> Dict[str, object]:
    """``{"trace": ..., "span": ...}`` of the adopted trace, or the shared
    empty dict."""
    tid = _trace()
    if tid is None:
        return _EMPTY
    st = _stack()
    if st:
        return {"trace": tid, "span": st[-1]}
    return {"trace": tid}


def push_span() -> Optional[Tuple[str, Optional[str]]]:
    """Allocate a child span id under the adopted trace and make it current;
    returns ``(span_id, parent_span_id)``, or None without a trace."""
    tid = _trace()
    if tid is None:
        return None
    st = _stack()
    parent = st[-1] if st else None
    sid = new_span_id()
    st.append(sid)
    return sid, parent


def pop_span(span_id: str) -> None:
    """Pop ``span_id`` off this thread's span stack."""
    st = _stack()
    if st and st[-1] == span_id:
        st.pop()
    elif span_id in st:
        st.remove(span_id)


@contextlib.contextmanager
def use_trace(car: Optional[Dict[str, str]]) -> Iterator[None]:
    """Adopt a carrier ``{"trace": ..., "span": ...}`` for this thread;
    None is a no-op."""
    if not car or "trace" not in car:
        yield
        return
    prev_trace = getattr(_tls, "trace", None)
    prev_spans = getattr(_tls, "spans", None)
    _tls.trace = car["trace"]
    _tls.spans = [car["span"]] if car.get("span") else []
    try:
        yield
    finally:
        _tls.trace = prev_trace
        _tls.spans = prev_spans
