"""Crash-safe file writes and corruption-tolerant loads (counterpart of
smartcal_tpu/runtime/atomic.py, kept as the port's own copy).

* **writes** go to a same-directory temp file, ``fsync``, then one
  ``os.replace``: readers see either the old bytes or the new bytes, never
  a prefix left by a kill mid-write;
* **loads** of resumable state go through :func:`safe_pickle_load`, which
  turns a missing, truncated or corrupt file into a warning on stderr and a
  default (start fresh); :func:`strict_pickle_load` raises
  :class:`CorruptStateError` for state that must exist.

Standard library only.
"""

import hashlib
import os
import pickle
import sys
import tempfile
from typing import Any


def _fsync_dir(path: str) -> None:
    """Best-effort directory fsync so the rename itself is durable."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, fsync: bool = True) -> None:
    """Write ``data`` to ``path`` atomically (temp file + ``os.replace``).
    The temp file lives in the same directory, so the rename never crosses
    a filesystem boundary."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".{os.path.basename(path)}.",
                               suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            if fsync:
                os.fsync(f.fileno())
        os.replace(tmp, path)
        if fsync:
            _fsync_dir(path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path: str, text: str, fsync: bool = True) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), fsync=fsync)


def atomic_pickle(obj: Any, path: str, fsync: bool = True) -> int:
    """Atomically pickle ``obj`` at ``path``; returns the byte count."""
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    atomic_write_bytes(path, data, fsync=fsync)
    return len(data)


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    """Hex sha256 of the file at ``path``."""
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


class CorruptStateError(RuntimeError):
    """A must-exist persisted payload is missing, truncated or unreadable."""


def strict_pickle_load(path: str) -> Any:
    """Load a pickle that must exist and parse; raises
    :class:`CorruptStateError` naming the file otherwise."""
    if not os.path.exists(path):
        raise CorruptStateError(f"required state file {path!r} does not exist")
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception as e:
        raise CorruptStateError(
            f"required state file {path!r} is unreadable ({e!r}): likely a "
            "torn write from a mid-save kill; restore or regenerate it") from e


def safe_pickle_load(path: str, default: Any = None) -> Any:
    """Load a pickle, or warn on stderr and return ``default`` when the file
    is missing, truncated or unreadable (resume paths start fresh)."""
    if not os.path.exists(path):
        sys.stderr.write(f"resume file {path!r} missing; starting fresh\n")
        return default
    try:
        with open(path, "rb") as f:
            return pickle.load(f)
    except Exception as e:
        sys.stderr.write(f"resume file {path!r} unreadable ({e!r}); "
                         "starting fresh\n")
        return default
