"""Framed, integrity-checked IPC of the process fleet (counterpart of
smartcal_tpu/runtime/ipc.py; the frames are byte for byte the JAX
package's, so each package unframes the other's).

The process-backed fleet (``runtime/supervisor``, ``actor_mode="process"``)
moves versioned transition batches, weight snapshots and heartbeats
between the learner and spawned actor workers over ``multiprocessing.Pipe``
connections.  A worker can die at any byte of a send, so every payload
travels as a self-validating frame::

    MAGIC(4) | payload_len(4, BE) | crc32(4, BE) | pickle(payload)

optionally behind a trace prelude ``TRACED_MAGIC | trace_len(4, BE) |
trace_json``.  A bad magic, a length mismatch, a CRC mismatch or an
unpicklable body is a :class:`CorruptPayloadError` (a ``CorruptStateError``):
the learner drops the one frame and keeps training.

Messages (tuples, kind first): parent -> worker ``("weights", version,
host_tree)``, ``("stop",)``; worker -> parent ``("beat", iteration)``,
``("result", iteration, weights_version, host_transitions)``, ``("error",
iteration, repr_str)``.  Payloads are host data (numpy arrays and Python
values): a CUDA tensor is never pickled.

Standard library at import; a worker imports torch only to pin its CUDA
device.
"""

import importlib
import json
import os
import pickle
import struct
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

from .atomic import CorruptStateError

MAGIC = b"SCF1"
TRACED_MAGIC = b"SCT1"
_HEADER = struct.Struct("!4sII")
_THEADER = struct.Struct("!4sI")
_MAX_TRACE_BYTES = 4096


class CorruptPayloadError(CorruptStateError):
    """An IPC frame failed validation (bad magic / length / CRC /
    unpicklable body).  ``trace`` is the trace envelope when the broken
    frame's prelude survived, else None."""

    trace: Optional[Dict[str, Any]] = None


def frame_payload(obj: Any,
                  trace: Optional[Dict[str, Any]] = None) -> bytes:
    """``obj`` as one self-validating frame, optionally behind a trace
    envelope."""
    body = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    frame = _HEADER.pack(MAGIC, len(body), zlib.crc32(body)) + body
    if trace is None:
        return frame
    tbody = json.dumps(trace).encode("utf-8")
    if len(tbody) > _MAX_TRACE_BYTES:
        tbody = json.dumps({k: trace[k] for k in ("trace", "span", "t")
                            if k in trace}).encode("utf-8")
    return _THEADER.pack(TRACED_MAGIC, len(tbody)) + tbody + frame


def _split_traced(data: bytes) -> Tuple[bytes, Optional[Dict[str, Any]]]:
    """(inner frame, trace) of a frame; a mangled prelude gives (data,
    None) and the inner validation reports it."""
    if len(data) < _THEADER.size or data[:4] != TRACED_MAGIC:
        return data, None
    _, tlen = _THEADER.unpack_from(data)
    end = _THEADER.size + tlen
    if tlen > _MAX_TRACE_BYTES or len(data) < end:
        return data[_THEADER.size:], None
    try:
        trace = json.loads(data[_THEADER.size:end].decode("utf-8"))
    except (UnicodeDecodeError, ValueError):
        trace = None
    if not isinstance(trace, dict):
        trace = None
    return data[end:], trace


def _corrupt(msg: str,
             trace: Optional[Dict[str, Any]]) -> CorruptPayloadError:
    err = CorruptPayloadError(msg)
    err.trace = trace
    return err


def unframe_payload_traced(
        data: bytes) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """Validate and unpickle one frame: ``(obj, trace)``; raises
    :class:`CorruptPayloadError` on any integrity failure."""
    inner, trace = _split_traced(data)
    if len(inner) < _HEADER.size:
        raise _corrupt(f"IPC frame truncated: {len(inner)} bytes < "
                       f"{_HEADER.size}-byte header", trace)
    magic, length, crc = _HEADER.unpack_from(inner)
    body = inner[_HEADER.size:]
    if magic != MAGIC:
        raise _corrupt(f"IPC frame bad magic {magic!r}", trace)
    if len(body) != length:
        raise _corrupt(
            f"IPC frame length mismatch: header says {length}, got "
            f"{len(body)} payload bytes (mid-send death?)", trace)
    if zlib.crc32(body) != crc:
        raise _corrupt("IPC frame CRC mismatch", trace)
    try:
        return pickle.loads(body), trace
    except Exception as e:
        raise _corrupt(f"IPC frame body unpicklable ({e!r})", trace) from e


def unframe_payload(data: bytes) -> Any:
    """:func:`unframe_payload_traced` without the trace."""
    return unframe_payload_traced(data)[0]


def send_msg(conn, obj: Any,
             trace: Optional[Dict[str, Any]] = None) -> None:
    conn.send_bytes(frame_payload(obj, trace=trace))


def send_blob(conn, blob: bytes) -> None:
    """Send an already-framed payload (one serialization, N workers)."""
    conn.send_bytes(blob)


def recv_msg(conn) -> Any:
    """One validated message; ``EOFError``/``OSError`` when the peer is
    gone, :class:`CorruptPayloadError` on a bad frame."""
    return unframe_payload(conn.recv_bytes())


def recv_msg_traced(conn) -> Tuple[Any, Optional[Dict[str, Any]]]:
    return unframe_payload_traced(conn.recv_bytes())


def resolve_factory(spec: str) -> Callable:
    """``"pkg.module:callable"`` -> the callable a spawned worker builds its
    work function with."""
    mod_name, _, fn_name = spec.partition(":")
    if not mod_name or not fn_name:
        raise ValueError(
            f"worker factory spec {spec!r} must be 'module:callable'")
    mod = importlib.import_module(mod_name)
    fn = getattr(mod, fn_name, None)
    if fn is None:
        raise ValueError(f"worker factory {fn_name!r} not found in "
                         f"{mod_name!r}")
    return fn


def worker_main(conn, actor_id: int, start_iteration: int,
                factory: str, factory_kwargs: dict,
                host_id: int = 0, n_hosts: int = 1,
                device: Optional[str] = None) -> None:
    """Entry point of a spawned actor worker.

    ``device`` is the worker's device (the fleet's ``worker_spec["device"]``,
    the learner's device by default): a CUDA device becomes the worker's
    current device.  An H100 serves several processes, so a worker may
    share the learner's card; the JAX package pins its workers to the CPU
    because a TPU takes one client.  Then: attach to the (simulated)
    multi-host runtime, re-arm the fault plan from ``SMARTCAL_FAULTS``,
    build the work function from its factory spec, and loop: drain control
    frames (the newest weights win), beat, run one rollout iteration, ship
    the versioned result.  A work-function exception is reported as an
    ``error`` frame naming the iteration before the process exits."""
    import time

    if device is not None and str(device).startswith("cuda"):
        import torch

        torch.cuda.set_device(torch.device(device))

    from smartcal_tpu_torch.obs import tracectx
    from smartcal_tpu_torch.parallel import multihost
    from smartcal_tpu_torch.runtime import faults as rt_faults

    multihost.attach_simulated(host_id, n_hosts)
    rt_faults.install_from_env()
    work_fn = resolve_factory(factory)(**(factory_kwargs or {}))

    iteration = int(start_iteration)
    weights: Any = None
    version = 0
    have_weights = False
    ctl_trace: Optional[Dict[str, Any]] = None
    test_corrupt = _test_corrupt_plan()

    def beat_env() -> Dict[str, Any]:
        return {"t": round(time.time(), 6)}

    try:
        while True:
            # drain the control inbox (newest weights win); wait in short
            # ticks for the first weights
            while conn.poll(0 if have_weights else 0.2):
                try:
                    msg, msg_trace = recv_msg_traced(conn)
                except CorruptPayloadError:
                    continue
                if msg[0] == "stop":
                    return
                if msg[0] == "weights":
                    version, weights = int(msg[1]), msg[2]
                    have_weights = True
                    if msg_trace and "trace" in msg_trace:
                        ctl_trace = msg_trace
            send_msg(conn, ("beat", iteration), trace=beat_env())
            if not have_weights:
                continue
            try:
                with tracectx.use_trace(ctl_trace):
                    out = work_fn(actor_id, iteration, weights)
            except BaseException as e:  # noqa: BLE001 — death is the signal
                send_msg(conn, ("error", iteration, repr(e)),
                         trace=beat_env())
                return
            if test_corrupt is not None and iteration == test_corrupt:
                # SMARTCAL_IPC_TEST_CORRUPT=<iteration>: ship a corrupted
                # frame instead of the result, then die (a mid-send death)
                blob = bytearray(frame_payload(
                    ("result", iteration, version, out), trace=beat_env()))
                blob[-1] ^= 0xFF
                send_blob(conn, bytes(blob))
                return
            send_msg(conn, ("result", iteration, version, out),
                     trace=beat_env())
            iteration += 1
    except (EOFError, OSError, BrokenPipeError):
        return


def _test_corrupt_plan() -> Optional[int]:
    raw = os.environ.get("SMARTCAL_IPC_TEST_CORRUPT", "").strip()
    if not raw:
        return None
    try:
        return int(raw)
    except ValueError:
        return None
