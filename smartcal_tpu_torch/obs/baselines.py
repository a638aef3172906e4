"""Host-fingerprinted baseline store of performance and numerics
measurements (counterpart of smartcal_tpu/obs/baselines.py).

The store half of the regression radar: a schema'd JSON document of
per-stage baselines, each keyed on

    stage | statics digest | host fingerprint digest

so a measurement recorded on one host, shape or configuration is never
compared against one from another: a lookup with a different fingerprint
finds no baseline, and the comparison layer (:mod:`.regress`) refuses an
explicit cross-fingerprint compare.

Each entry carries a noise model per metric: *sampled* metrics (wall
time) keep their raw samples plus mean / std / cv so the detector can
bootstrap a confidence interval over the ratio; *deterministic* metrics
(peak bytes, flops, compile counts, numeric scalars) keep one value.
Writes are atomic (``runtime/atomic.py``).

The fingerprint names what the port's numbers depend on: the effective
core count, the platform, Python, the ``torch`` version and its CUDA
version, the card's name once CUDA is initialised, and the dtype policy
(the package's TF32 switch and :data:`BF16_REL_BAND`).  A JAX package
store entry therefore has a different fingerprint: no baseline, or
``FingerprintMismatch`` on an explicit compare, by design.

Standard library only; torch is read from ``sys.modules``, so importing
this never initialises a device.
"""

import hashlib
import json
import os
import platform as _platform
import statistics
import sys
import threading
import time
from typing import Dict, List, Optional

SCHEMA_VERSION = 1

#: Documented relative-error band of the bf16 mixed-precision kernels
#: (``cal/precision``; held by the parity tests and by ``chip_smoke.py``'s
#: bf16 phase).  Numeric drift metrics are judged against it.
BF16_REL_BAND = 2e-2


def _nproc() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return os.cpu_count() or 1


def host_fingerprint() -> Dict[str, object]:
    """The identity a measurement is only comparable within.

    ``nproc`` is the *effective* core count (``sched_getaffinity``: a
    24-core host running in a 1-core cgroup fingerprints as 1 core).  The
    torch and CUDA versions come from the imported ``torch``, else from
    the installed package's metadata; the device is named only when CUDA
    is already initialised (nothing here initialises it)."""
    torch = sys.modules.get("torch")
    torch_v = getattr(torch, "__version__", None)
    if torch_v is None:
        try:
            from importlib import metadata
            torch_v = metadata.version("torch")
        except Exception:
            pass
    cuda_v, device, tf32 = None, None, False
    if torch is not None:
        try:
            cuda_v = torch.version.cuda
            tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
            if torch.cuda.is_initialized():
                device = torch.cuda.get_device_name()
        except Exception:
            pass
    return {
        "nproc": _nproc(),
        "platform": _platform.system().lower(),
        "machine": _platform.machine(),
        "python": _platform.python_version(),
        "torch": None if torch_v is None else str(torch_v),
        "cuda": cuda_v,
        "device": device,
        "dtype_policy": {"tf32": tf32, "bf16_rel_band": BF16_REL_BAND},
    }


def _digest(obj: object) -> str:
    blob = json.dumps(obj, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:12]


def fingerprint_digest(fp: Dict[str, object]) -> str:
    return _digest(fp)


def statics_digest(statics: Dict[str, object]) -> str:
    return _digest(statics)


def baseline_key(stage: str, statics: Dict[str, object],
                 fp: Dict[str, object]) -> str:
    return f"{stage}|{statics_digest(statics)}|{fingerprint_digest(fp)}"


def summarize_samples(samples: List[float]) -> Dict[str, object]:
    """Noise model of a sampled metric: the raw samples plus mean / std /
    cv (population std: the samples are the distribution the detector
    resamples from)."""
    xs = [float(x) for x in samples]
    if not xs:
        raise ValueError("summarize_samples: need at least one sample")
    mean = statistics.fmean(xs)
    std = statistics.pstdev(xs) if len(xs) > 1 else 0.0
    return {
        "kind": "samples",
        "samples": xs,
        "n": len(xs),
        "mean": mean,
        "std": std,
        "cv": (std / mean) if mean else 0.0,
    }


def scalar_metric(value: float) -> Dict[str, object]:
    return {"kind": "scalar", "value": float(value)}


class BaselineSchemaError(ValueError):
    """The on-disk baseline document does not match the schema: the store
    refuses to compare against it."""


class BaselineStore:
    """Load / record / save interface over one baseline JSON document.
    The cached document and its dirty flag are shared between a recording
    caller and concurrent readers, so every access holds ``_lock``."""

    def __init__(self, path: str) -> None:
        self._path = os.fspath(path)
        self._lock = threading.Lock()
        self._doc: Optional[Dict[str, object]] = None
        self._dirty = False

    @property
    def path(self) -> str:
        return self._path

    # -- document lifecycle -------------------------------------------

    def _load_locked(self) -> Dict[str, object]:
        if self._doc is not None:
            return self._doc
        if not os.path.exists(self._path):
            self._doc = {"schema": SCHEMA_VERSION, "entries": {}}
            return self._doc
        try:
            with open(self._path, "r", encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise BaselineSchemaError(
                f"baseline store {self._path!r} unreadable ({e!r}): delete "
                "it or restore it, then record again") from e
        self._validate(doc)
        self._doc = doc
        return doc

    @staticmethod
    def _validate(doc: object) -> None:
        if not isinstance(doc, dict) or not isinstance(
                doc.get("entries"), dict):
            raise BaselineSchemaError(
                "baseline document must be {schema, entries:{...}}")
        if doc.get("schema") != SCHEMA_VERSION:
            raise BaselineSchemaError(
                f"baseline schema {doc.get('schema')!r} != "
                f"{SCHEMA_VERSION}: record again")
        for key, ent in doc["entries"].items():
            for field in ("stage", "statics", "fingerprint", "metrics"):
                if field not in ent:
                    raise BaselineSchemaError(
                        f"baseline entry {key!r} missing {field!r}")
            for mname, m in ent["metrics"].items():
                kind = m.get("kind")
                if kind == "samples":
                    if not m.get("samples"):
                        raise BaselineSchemaError(
                            f"{key}:{mname} sampled metric has no "
                            "samples")
                elif kind == "scalar":
                    if "value" not in m:
                        raise BaselineSchemaError(
                            f"{key}:{mname} scalar metric has no value")
                else:
                    raise BaselineSchemaError(
                        f"{key}:{mname} unknown metric kind {kind!r}")

    # -- lookup / record ----------------------------------------------

    def get(self, stage: str, statics: Dict[str, object],
            fp: Dict[str, object]) -> Optional[Dict[str, object]]:
        """The baseline entry of exactly this (stage, statics, host), or
        None.  Another fingerprint cannot return this host's entry: its
        digest is part of the key."""
        key = baseline_key(stage, statics, fp)
        with self._lock:
            doc = self._load_locked()
            ent = doc["entries"].get(key)
            return json.loads(json.dumps(ent)) if ent else None

    def record(self, stage: str, statics: Dict[str, object],
               fp: Dict[str, object],
               metrics: Dict[str, Dict[str, object]]) -> Dict[str, object]:
        """Bless new numbers for (stage, statics, host), replacing any
        earlier entry under the same key."""
        for mname, m in metrics.items():
            if m.get("kind") not in ("samples", "scalar"):
                raise BaselineSchemaError(
                    f"metric {mname!r}: build it with summarize_samples"
                    "() or scalar_metric()")
        entry = {
            "stage": stage,
            "statics": dict(statics),
            "statics_digest": statics_digest(statics),
            "fingerprint": dict(fp),
            "fingerprint_digest": fingerprint_digest(fp),
            "recorded_unix": time.time(),
            "metrics": metrics,
        }
        key = baseline_key(stage, statics, fp)
        with self._lock:
            doc = self._load_locked()
            doc["entries"][key] = entry
            self._dirty = True
        return entry

    def entries(self) -> List[Dict[str, object]]:
        with self._lock:
            doc = self._load_locked()
            return [json.loads(json.dumps(e))
                    for e in doc["entries"].values()]

    def save(self) -> bool:
        """Persist atomically if dirty; returns whether a write happened
        (readers see the old or the new document, never a torn one)."""
        from smartcal_tpu_torch.runtime.atomic import atomic_write_text
        with self._lock:
            if not self._dirty or self._doc is None:
                return False
            text = json.dumps(self._doc, indent=1, sort_keys=True)
            self._dirty = False
        atomic_write_text(self._path, text + "\n")
        return True
