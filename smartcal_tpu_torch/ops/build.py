"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into ``smartcal_tpu_torch/_build/lib<name>-<hash>.so`` on
first use, then loaded with ``ctypes``.  The file name carries a hash of
the source, of the shared headers ``csrc/*.cuh`` it may include and of the
flags, so an edited source or header is rebuilt, never reused stale.
:func:`build` starts one ``nvcc`` per source, all at once, and reports each
build as a ``compile`` event while a RunLog records
(``obs.record_compile``).  The build directory is the port's persistent
compile cache: :func:`set_build_dir` (the trainers' ``--compile-cache
DIR``) moves it, so repeat runs load the libraries built before.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

from smartcal_tpu_torch import obs

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_loaded = {}


def set_build_dir(path) -> Path:
    """Build and load the kernels' libraries under ``path`` from now on
    (created if missing); returns it."""
    global BUILD_DIR
    BUILD_DIR = Path(path).resolve()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    return BUILD_DIR


def sources():
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """``nvcc`` from CUDA_HOME, the PATH, or /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` is built: the name carries a
    hash of its source, of every shared header ``csrc/*.cuh`` and of the
    flags, so an edit to any of them builds anew."""
    digest = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=None) -> dict:
    """Compile the named sources (default: all) that are not built yet, in
    parallel.  Returns {name: (seconds, nvcc stderr)} for those compiled;
    raises with the compiler's output if any build fails."""
    names = sources() if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: library_path(n) for n in names if not library_path(n).exists()}
    if not todo:
        return {}
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    procs = {}
    for n, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    report, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{n}:\n{log}")
            continue
        os.replace(tmp, out)
        report[n] = (time.perf_counter() - t0, log)
        obs.record_compile(f"nvcc:{n}", report[n][0], library=out.name)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = library_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _loaded[name] = lib
        return lib


class DeviceLaunchCount:
    """A kernel's count of its own runs, kept on the card: one int64 per
    device, which the kernel's first thread increments each time it runs.
    A launch replayed from a CUDA graph counts as an eager one does, and a
    capture, which runs nothing, adds nothing.  The wrapper passes
    :meth:`pointer` to every launch; :meth:`read` sums the devices and
    :meth:`reset` zeroes them (each synchronises the devices first)."""

    def __init__(self, name: str):
        self.name = name
        self._counts = {}

    def pointer(self, device) -> int:
        """The device address of ``device``'s count, made (zeroed) on first
        use; the first use may not be inside a CUDA graph capture, where a
        zeroing would be recorded and replayed."""
        import torch
        t = self._counts.get(device)
        if t is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{self.name}: first launch on {device} inside a CUDA "
                    "graph capture; launch it once before capturing")
            t = torch.zeros((), dtype=torch.int64, device=device)
            self._counts[device] = t
        return t.data_ptr()

    def _sync(self):
        import torch
        for d in self._counts:
            torch.cuda.synchronize(d)

    def read(self) -> int:
        self._sync()
        return sum(int(t) for t in self._counts.values())

    def reset(self) -> None:
        self._sync()
        for t in self._counts.values():
            t.zero_()
        self._sync()


def summed_over_ranks(counts: dict) -> dict:
    """``{kernel: launches}`` of this process summed over every rank of a
    job of several processes (``ops/collectives.process_allgather``; each
    process keeps its own counts); ``counts`` itself on one process."""
    import numpy as np

    from smartcal_tpu_torch.ops import collectives

    names = sorted(counts)
    every = collectives.process_allgather(
        np.asarray([int(counts[k]) for k in names], np.int64))
    return dict(zip(names, (int(v) for v in every.sum(axis=0))))
