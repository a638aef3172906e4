"""Program cache of the serving layer, keyed on a signature (the port's
counterpart of smartcal_tpu/serve/export.py, same API and counters).

The JAX server exports its three programs with ``jax.export`` and keeps the
serialized StableHLO on disk, so a restarted server neither traces nor
compiles.  The port's programs map onto that as follows:

* **the policy program** goes through ``torch.export``: the actor's
  ``rl/sac.policy_heads`` is a plain module, exported once per signature
  with the weights as an operand (``torch.func.functional_call`` on a
  weightless template of the actor), so one program serves every weight
  version, as the JAX program takes ``actor_params`` as a traced operand.
  It is persisted with ``torch.export.save`` as ``<kind>-<digest>.pt2``
  beside a JSON sidecar of its signature; a restart loads it instead of
  tracing it again;
* **the solve and influence programs** cannot go through ``torch.export``:
  they run host-decided L-BFGS loops, ctypes kernels and a captured CUDA
  graph.  Their :class:`ServeProgram` is the backend's prepared in-process
  callable (``RadioBackend.batched_solve_callable`` /
  ``batched_influence_callable``, the solve owning one line search per lane
  count), and their cache entry is the signature sidecar alone: a restart
  reports ``source == "cache"`` when the sidecar of its digest exists, but
  nothing is loaded, so it counts ``export_cache_prepared_hit`` (or
  ``_miss``), never ``export_cache_hit``.  The CUDA graph of the line
  search is captured again at every warmup (nothing on disk holds it);
* :func:`enable_compile_cache` points the nvcc build directory of the
  port's kernels at the cache tree (``ops/build.set_build_dir``, what the
  trainers' ``--compile-cache`` does), the counterpart of JAX's persistent
  XLA cache: a restarted server loads the libraries built before.

Writes are atomic (``runtime/atomic``: tmp + rename), so a killed server
never leaves a torn entry.  Counters: ``export_cache_hit`` /
``export_cache_miss`` / ``export_cache_store`` / ``export_cache_pruned``
(exported programs, the JAX package's names) and
``export_cache_prepared_hit`` / ``export_cache_prepared_miss`` (the
sidecars of prepared programs).
"""

import hashlib
import json
import os
from typing import Any, Callable, Optional, Sequence

from smartcal_tpu_torch import obs
from smartcal_tpu_torch.runtime import atomic

_PT2, _SIDECAR = ".pt2", ".json"


def prime_backend_kernels(device="cuda") -> None:
    """Load torch's lazily loaded CUDA linear-algebra library in this
    thread before any served program runs (``parallel/learner.
    warm_cuda_libraries``): threads that reach it first at the same time
    race.  A no-op off the card."""
    import torch

    from smartcal_tpu_torch.parallel.learner import warm_cuda_libraries

    warm_cuda_libraries(torch.device(device))


def sig_digest(sig: dict) -> str:
    """Stable short digest of a signature dict (sorted-key JSON), the JAX
    package's: one backend gives one digest in both packages."""
    blob = json.dumps(sig, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def abstract_like(tree: Any):
    """The tensors of ``tree`` (through tuples, lists and dicts) as zero
    tensors of the same shape, dtype and device: the stand-ins a program
    is exported at."""
    import torch

    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    if isinstance(tree, dict):
        return {k: abstract_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(abstract_like(v) for v in tree)
    return tree


class ServeProgram:
    """A served program: call it like the function it was made from.
    ``source`` records where it came from ("export": built in this process,
    "cache": loaded from disk, "publish": re-persisted under a new
    signature).  ``exported`` is the ``torch.export.ExportedProgram`` of an
    exported program (None for a prepared one)."""

    def __init__(self, fn: Callable, sig: dict, source: str, exported=None):
        self.fn = fn
        self.exported = exported
        self.sig = dict(sig)
        self.source = source

    def __call__(self, *args):
        return self.fn(*args)


class ExportCache:
    """Persist and load the programs of a signature dict.  Layout:
    ``<dir>/<kind>-<digest>.pt2`` (an exported program) and
    ``<dir>/<kind>-<digest>.json`` (the human-readable signature, the whole
    entry of a prepared program)."""

    def __init__(self, cache_dir: str):
        self.dir = cache_dir
        os.makedirs(cache_dir, exist_ok=True)

    def _base(self, sig: dict) -> str:
        kind = sig.get("kind", "program")
        return os.path.join(self.dir, f"{kind}-{sig_digest(sig)}")

    def _store_sig(self, sig: dict) -> None:
        atomic.atomic_write_text(
            self._base(sig) + _SIDECAR,
            json.dumps(sig, sort_keys=True, default=str, indent=1))

    # -- exported programs (torch.export) -----------------------------------
    def load(self, sig: dict) -> Optional[ServeProgram]:
        """The persisted exported program of ``sig``, or None (a miss).  A
        corrupt file counts as a miss: the caller rebuilds and overwrites
        it."""
        import torch

        path = self._base(sig) + _PT2
        if not os.path.exists(path):
            obs.counter_add("export_cache_miss")
            self._log("miss", sig, path)
            return None
        try:
            exported = torch.export.load(path)
        except Exception as e:     # torn or incompatible file: rebuild
            obs.counter_add("export_cache_miss")
            self._log("corrupt", sig, path, error=repr(e))
            return None
        obs.counter_add("export_cache_hit")
        self._log("hit", sig, path, bytes=os.path.getsize(path))
        return ServeProgram(exported.module(), sig, "cache", exported)

    def store(self, sig: dict, exported) -> str:
        """Persist an exported program (without its example inputs) and its
        sidecar."""
        import torch

        path = self._base(sig) + _PT2
        exported.example_inputs = None     # the weights, not the program
        tmp = os.path.join(self.dir, f".tmp{os.getpid()}-"
                           f"{os.path.basename(path)}")
        torch.export.save(exported, tmp)
        os.replace(tmp, path)
        self._store_sig(sig)
        obs.counter_add("export_cache_store")
        self._log("store", sig, path, bytes=os.path.getsize(path))
        return path

    def build(self, sig: dict, module, example_args: Sequence[Any]
              ) -> ServeProgram:
        """Export ``module`` at ``example_args`` (non-strict
        ``torch.export``), persist, return."""
        import torch

        with obs.span("serve_export", kind=sig.get("kind")):
            exported = torch.export.export(module, tuple(example_args),
                                           strict=False)
            self.store(sig, exported)
        return ServeProgram(exported.module(), sig, "export", exported)

    def get_or_build(self, sig: dict, module, example_args: Sequence[Any]
                     ) -> ServeProgram:
        prog = self.load(sig)
        if prog is None:
            prog = self.build(sig, module, example_args)
        return prog

    # -- prepared programs (solve, influence) -------------------------------
    def prepare(self, sig: dict, fn: Callable) -> ServeProgram:
        """A prepared in-process program: its entry is the signature
        sidecar, ``source="cache"`` when it exists, else ``"export"`` and
        the sidecar is written.  Nothing is loaded or built either way, so
        it counts ``export_cache_prepared_hit`` / ``_miss`` apart from the
        exported programs' hits and misses."""
        path = self._base(sig) + _SIDECAR
        if os.path.exists(path):
            obs.counter_add("export_cache_prepared_hit")
            self._log("hit", sig, path, prepared=True)
            return ServeProgram(fn, sig, "cache")
        obs.counter_add("export_cache_prepared_miss")
        self._log("miss", sig, path, prepared=True)
        self._store_sig(sig)
        return ServeProgram(fn, sig, "export")

    # -- publication --------------------------------------------------------
    def publish(self, sig: dict, program: ServeProgram) -> ServeProgram:
        """Persist an already exported program under a new signature and
        return it rebadged (``source="publish"``): the policy program takes
        the weights as an operand, so a new weight version is the same
        program, re-persisted under its ``(version, serve_signature)`` key
        with no rebuild.  Skips the write when the entry exists."""
        if program.exported is not None:
            if not os.path.exists(self._base(sig) + _PT2):
                self.store(sig, program.exported)
        elif not os.path.exists(self._base(sig) + _SIDECAR):
            self._store_sig(sig)
        return ServeProgram(program.fn, sig, "publish", program.exported)

    def prune(self, kind: str, keep: int) -> int:
        """Drop all but the ``keep`` most recent exported entries of
        ``kind`` (mtime order); returns the number removed.  Never raises on
        a concurrent unlink."""
        base = []
        for name in os.listdir(self.dir):
            if name.startswith(f"{kind}-") and name.endswith(_PT2):
                p = os.path.join(self.dir, name)
                try:
                    base.append((os.path.getmtime(p), p))
                except OSError:
                    continue
        base.sort(reverse=True)
        removed = 0
        for _, p in base[max(0, int(keep)):]:
            for victim in (p, p[:-len(_PT2)] + _SIDECAR):
                try:
                    os.remove(victim)
                except OSError:
                    continue
            removed += 1
        if removed:
            obs.counter_add("export_cache_pruned", removed)
        return removed

    def _log(self, action: str, sig: dict, path: str, **extra) -> None:
        rl = obs.active()
        if rl is not None:
            rl.log("export_cache", action=action, kind=sig.get("kind"),
                   digest=sig_digest(sig), path=os.path.basename(path),
                   **extra)


def enable_compile_cache(cache_dir: str) -> bool:
    """Build and load the port's CUDA kernels under ``cache_dir`` from now
    on (``ops/build.set_build_dir``), so a restarted server finds the
    libraries its first boot built.  Process-wide; returns True."""
    from smartcal_tpu_torch.ops import build

    build.set_build_dir(cache_dir)
    return True
