"""W3C-style trace context (the port's copy of
smartcal_tpu/obs/tracectx.py): span ids of the adopted trace and the
process-crossing carriers that join a request's spans across the serving
fleet's processes.

* a **carrier** is ``{"trace": <32-hex>, "span": <16-hex>}``, small enough
  to ride in a framed IPC envelope (``runtime/ipc``) or a Job payload;
* an **envelope** is a carrier plus the sender's wall clock ``t``, the raw
  material of the clock-offset handshake that lets ``obs/collect`` merge
  per-process timelines;
* the thread-local active trace is what :func:`current_fields` reads:
  :meth:`RunLog.log <smartcal_tpu_torch.obs.runlog.RunLog.log>` attaches
  it to every event, and :class:`~smartcal_tpu_torch.obs.spans.Span`
  allocates child span ids from it.

Strict no-op contract: with no adopted trace :func:`current_fields`
returns the shared empty dict and :func:`push_span` returns None.
Standard library only.
"""

import contextlib
import os
import threading
import time
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


def new_root_carrier() -> Dict[str, str]:
    """A root carrier for a new request (no thread state touched): the
    fleet router stamps one onto each Job at admission."""
    return {"trace": new_trace_id(), "span": new_span_id()}


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


def carrier() -> Optional[Dict[str, str]]:
    """The adopted trace as a serializable carrier, or None."""
    tid = _trace()
    if tid is None:
        return None
    st = _stack()
    out = {"trace": tid}
    if st:
        out["span"] = st[-1]
    return out


def envelope() -> Optional[Dict[str, object]]:
    """Carrier plus the sender's wall time ``t``: what rides an IPC frame.
    The receiver's receive time minus ``t`` (minimised over frames)
    estimates the peer's clock offset."""
    car = carrier()
    if car is None:
        return {"t": round(time.time(), 6)}
    out: Dict[str, object] = dict(car)
    out["t"] = round(time.time(), 6)
    return out


def fields_of(car: Optional[Dict[str, str]]) -> Dict[str, object]:
    """Event fields naming the carrier's own span (no new ids): for events
    that are the carrier's point of origin (``fleet_dispatch``)."""
    if not car or "trace" not in car:
        return {}
    out: Dict[str, object] = {"trace": car["trace"]}
    if car.get("span"):
        out["span"] = car["span"]
    return out


def child_fields(car: Optional[Dict[str, str]]) -> Dict[str, object]:
    """Event fields for a new child span of the carrier: a fresh span id
    with ``parent`` pointing at the carrier's span.  For point events that
    mark a hop (``serve_admit``, ``serve_request``)."""
    if not car or "trace" not in car:
        return {}
    out: Dict[str, object] = {"trace": car["trace"], "span": new_span_id()}
    if car.get("span"):
        out["parent"] = car["span"]
    return out


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
