"""The port's own native (C++) runtime library, bound with ctypes
(counterpart of smartcal_tpu/native, whose sources ``_src/sct.cc`` and
``_src/sumtree.cc`` are copied here unchanged):

* ``sct.cc``: the single-file binary columnar table store ``TABLE.sct``
  behind :mod:`smartcal_tpu_torch.cal.ms_io` (the casacore-table role for
  synthetic and work Measurement Sets).  Its format is a contract: a store
  written here is byte-identical to the JAX package's from the same
  columns, and each package reads the other's;
* ``sumtree.cc``: the host-side O(log n) sum tree of prioritized replay
  (:class:`SumTree`).

The library is compiled on first use by one ``g++ -O3 -std=c++17 -shared
-fPIC`` into ``<build dir>/native/libsmartcal_native-<hash>.so``, the hash
over the sources and the flags (the build dir is ``ops.build``'s, moved by
``--compile-cache``), and reported as a ``compile`` event while a RunLog
records.  A failed build RAISES with g++'s output: the port never falls
back to npz on its own (``SMARTCAL_MS_FORMAT=npz`` chooses npz).
:func:`py_read`, a pure-Python reader of the same format, reads a store
without a compiler.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import struct
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np

from smartcal_tpu_torch import obs

SRC_DIR = Path(__file__).resolve().parent / "_src"
SOURCES = ("sct.cc", "sumtree.cc")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ct.CDLL] = None

# numpy dtype <-> SCT dtype code (sct.cc header)
DTYPE_CODES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
    np.dtype(np.complex64): 4,
    np.dtype(np.complex128): 5,
    np.dtype(np.uint8): 6,
}
CODE_DTYPES = {v: k for k, v in DTYPE_CODES.items()}


def library_path() -> Path:
    """Where the library is built: the name carries a hash of the sources
    and the flags, so an edit builds anew."""
    from smartcal_tpu_torch.ops import build as ops_build

    digest = hashlib.sha1(" ".join(CXX_FLAGS).encode())
    for s in SOURCES:
        digest.update(s.encode() + b"\0" + (SRC_DIR / s).read_bytes())
    return (ops_build.BUILD_DIR / "native"
            / f"libsmartcal_native-{digest.hexdigest()[:12]}.so")


def build() -> Path:
    """Compile the library unless it is built; returns its path.  Raises
    with the compiler's output if g++ fails."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp),
           *(str(SRC_DIR / s) for s in SOURCES)]
    t0 = time.perf_counter()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"native build failed to run g++: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native build failed ({' '.join(cmd)}):\n"
                           f"{r.stderr}")
    os.replace(tmp, out)
    obs.record_compile("g++:native", time.perf_counter() - t0,
                       library=out.name)
    return out


def _bind(path) -> ct.CDLL:
    lib = ct.CDLL(str(path))
    c_i64 = ct.c_int64
    lib.sct_write.restype = ct.c_int
    lib.sct_write.argtypes = [
        ct.c_char_p, ct.c_int, ct.POINTER(ct.c_char_p),
        ct.POINTER(ct.c_int), ct.POINTER(ct.c_int), ct.POINTER(c_i64),
        ct.POINTER(ct.c_void_p)]
    lib.sct_open.restype = ct.c_void_p
    lib.sct_open.argtypes = [ct.c_char_p]
    lib.sct_close.restype = None
    lib.sct_close.argtypes = [ct.c_void_p]
    lib.sct_h_ncols.restype = ct.c_int
    lib.sct_h_ncols.argtypes = [ct.c_void_p]
    lib.sct_h_find.restype = ct.c_int
    lib.sct_h_find.argtypes = [ct.c_void_p, ct.c_char_p]
    lib.sct_h_col_meta.restype = ct.c_int
    lib.sct_h_col_meta.argtypes = [
        ct.c_void_p, ct.c_int, ct.c_char_p, ct.c_int,
        ct.POINTER(ct.c_int), ct.POINTER(c_i64)]
    lib.sct_h_read_col.restype = c_i64
    lib.sct_h_read_col.argtypes = [ct.c_void_p, ct.c_int, ct.c_void_p,
                                   c_i64]
    lib.st_create.restype = ct.c_void_p
    lib.st_create.argtypes = [c_i64]
    lib.st_free.argtypes = [ct.c_void_p]
    for name in ("st_capacity", "st_filled", "st_cursor"):
        fn = getattr(lib, name)
        fn.restype = c_i64
        fn.argtypes = [ct.c_void_p]
    for name in ("st_total", "st_max_priority", "st_min_priority"):
        fn = getattr(lib, name)
        fn.restype = ct.c_double
        fn.argtypes = [ct.c_void_p]
    lib.st_add.restype = c_i64
    lib.st_add.argtypes = [ct.c_void_p, ct.c_double]
    lib.st_update.restype = None
    lib.st_update.argtypes = [ct.c_void_p, c_i64, ct.c_double]
    lib.st_update_batch.restype = None
    lib.st_update_batch.argtypes = [ct.c_void_p, c_i64,
                                    ct.POINTER(c_i64), ct.POINTER(ct.c_double)]
    lib.st_get_leaf.restype = c_i64
    lib.st_get_leaf.argtypes = [ct.c_void_p, ct.c_double,
                                ct.POINTER(ct.c_double)]
    lib.st_sample_stratified.restype = None
    lib.st_sample_stratified.argtypes = [
        ct.c_void_p, c_i64, ct.POINTER(ct.c_double), ct.POINTER(c_i64),
        ct.POINTER(ct.c_double)]
    lib.st_get_leaves.restype = None
    lib.st_get_leaves.argtypes = [ct.c_void_p, ct.POINTER(ct.c_double)]
    lib.st_set_state.restype = None
    lib.st_set_state.argtypes = [ct.c_void_p, ct.POINTER(ct.c_double),
                                 c_i64, c_i64]
    return lib


def lib() -> ct.CDLL:
    """The loaded library, built on first use (raises if it cannot be)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(build())
        return _lib


def available() -> bool:
    """True when the library builds and loads (the JAX package's probe;
    :func:`lib` raises where this says False)."""
    try:
        lib()
    except (OSError, RuntimeError):
        return False
    return True


# ---------------------------------------------------------------------------
# SCT store: numpy dict <-> single binary file
# ---------------------------------------------------------------------------

def sct_write(path: str, columns: dict) -> None:
    """Write ``{name: ndarray}`` as one SCT file (atomic replace)."""
    L = lib()
    names, codes, ndims, dims, ptrs, keep = [], [], [], [], [], []
    for name, arr in columns.items():
        # NOT ascontiguousarray: it promotes 0-d scalars to shape (1,)
        a = np.asarray(arr)
        if not a.flags["C_CONTIGUOUS"]:
            a = np.ascontiguousarray(a)
        if a.dtype == np.bool_:
            a = a.astype(np.uint8)
        if a.dtype not in DTYPE_CODES:
            raise TypeError(f"unsupported dtype {a.dtype} for column {name}")
        keep.append(a)                       # hold buffers until the call
        names.append(name.encode())
        codes.append(DTYPE_CODES[a.dtype])
        ndims.append(a.ndim)
        dims.extend(int(d) for d in a.shape)
        ptrs.append(a.ctypes.data_as(ct.c_void_p))
    n = len(names)
    rc = L.sct_write(
        str(path).encode(), n,
        (ct.c_char_p * n)(*names),
        (ct.c_int * n)(*codes),
        (ct.c_int * n)(*ndims),
        (ct.c_int64 * max(1, len(dims)))(*(dims or [0])),
        (ct.c_void_p * n)(*[ct.cast(p, ct.c_void_p) for p in ptrs]))
    if rc != 0:
        raise IOError(f"sct_write({path}) failed: rc={rc}")


class _SctReader:
    """Handle over one open SCT file; the header parses once."""

    def __init__(self, path: str):
        self._L = lib()
        self.path = str(path)
        self._h = self._L.sct_open(self.path.encode())
        if not self._h:
            raise IOError(f"sct_open({path}): cannot open / bad header")

    def close(self):
        if getattr(self, "_h", None):
            self._L.sct_close(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def ncols(self) -> int:
        return self._L.sct_h_ncols(self._h)

    def col(self, index: int):
        """(name, array) of column ``index``."""
        name_buf = ct.create_string_buffer(4097)
        dims_buf = (ct.c_int64 * 16)()
        dtype_out = ct.c_int(0)
        ndim = self._L.sct_h_col_meta(self._h, index, name_buf, 4097,
                                      ct.byref(dtype_out), dims_buf)
        if ndim < 0:
            raise IOError(f"sct_h_col_meta({self.path}, {index}) rc={ndim}")
        shape = tuple(int(dims_buf[d]) for d in range(ndim))
        arr = np.empty(shape, CODE_DTYPES[int(dtype_out.value)])
        got = self._L.sct_h_read_col(self._h, index,
                                     arr.ctypes.data_as(ct.c_void_p),
                                     ct.c_int64(arr.nbytes))
        if got != arr.nbytes:
            raise IOError(f"sct_h_read_col({self.path}, {index}) rc={got}")
        return name_buf.value.decode(), arr

    def read_one(self, name: str) -> np.ndarray:
        """One named column's payload; nothing else is read."""
        idx = self._L.sct_h_find(self._h, name.encode())
        if idx < 0:
            raise KeyError(f"column {name} not in {self.path}")
        return self.col(idx)[1]


def _py_parse_header(f):
    """Pure-Python mirror of sct.cc's parse_header (same field order,
    limits and 64-byte payload alignment): [(name, dtype, shape, offset,
    nbytes)].  Corruption raises IOError, as in the native reader."""

    def read_exact(n):
        buf = f.read(n)
        if len(buf) != n:
            raise IOError("truncated SCT header")
        return buf

    if f.read(4) != b"SCT1":
        raise IOError("bad SCT magic")
    (ncols,) = struct.unpack("<I", read_exact(4))
    if ncols > 1 << 20:
        raise IOError(f"bad SCT header: ncols={ncols}")
    cols = []
    for _ in range(ncols):
        (name_len,) = struct.unpack("<I", read_exact(4))
        if name_len > 4096:
            raise IOError(f"bad SCT header: name_len={name_len}")
        try:
            name = read_exact(name_len).decode()
        except UnicodeDecodeError as e:
            raise IOError(f"bad SCT header: undecodable name ({e})")
        dtype_code, ndim = struct.unpack("<II", read_exact(8))
        if ndim > 16:
            raise IOError(f"bad SCT header: ndim={ndim}")
        if dtype_code not in CODE_DTYPES:
            raise IOError(f"bad SCT header: dtype code {dtype_code}")
        dims = (struct.unpack(f"<{ndim}Q", read_exact(8 * ndim))
                if ndim else ())
        (nbytes,) = struct.unpack("<Q", read_exact(8))
        dtype = CODE_DTYPES[dtype_code]
        itemsize = np.dtype(dtype).itemsize
        count = 1
        for d in dims:
            count *= d
        if nbytes % itemsize or count * itemsize != nbytes:
            raise IOError(
                f"bad SCT header: column {name} dims {dims} x itemsize "
                f"{itemsize} disagree with nbytes={nbytes}")
        cols.append([name, dtype, tuple(dims), 0, nbytes])
    off = f.tell()
    for c in cols:
        off = (off + 63) // 64 * 64
        c[3] = off
        off += c[4]
    return cols


def py_read(path: str, only: Optional[str] = None):
    """Pure-Python SCT reader: ``{name: ndarray}``, or the one column
    ``only``.  Needs no compiler."""
    out = {}
    with open(path, "rb") as f:
        for name, dtype, shape, offset, nbytes in _py_parse_header(f):
            if only is not None and name != only:
                continue
            f.seek(offset)
            buf = f.read(nbytes)
            if len(buf) != nbytes:
                raise IOError(f"truncated SCT column {name} in {path}")
            out[name] = np.frombuffer(buf, dtype).reshape(shape).copy()
    if only is not None:
        if only not in out:
            raise KeyError(f"column {only} not in {path}")
        return out[only]
    return out


def sct_read(path: str) -> dict:
    """Read an SCT file back into ``{name: ndarray}`` (native reader)."""
    with _SctReader(path) as r:
        return dict(r.col(i) for i in range(r.ncols))


def sct_read_one(path: str, name: str) -> np.ndarray:
    """Read a single named column without touching the other payloads."""
    with _SctReader(path) as r:
        return r.read_one(name)


# ---------------------------------------------------------------------------
# Native sum tree handle
# ---------------------------------------------------------------------------

class SumTree:
    """ctypes handle to the C++ sum tree; capacity rounds up to 2^k."""

    def __init__(self, capacity: int):
        self._L = lib()
        self._h = self._L.st_create(int(capacity))
        if not self._h:
            raise MemoryError("st_create failed")

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._L.st_free(h)
            self._h = None

    @property
    def capacity(self) -> int:
        return int(self._L.st_capacity(self._h))

    @property
    def filled(self) -> int:
        return int(self._L.st_filled(self._h))

    @property
    def cursor(self) -> int:
        return int(self._L.st_cursor(self._h))

    def total(self) -> float:
        return float(self._L.st_total(self._h))

    def max_priority(self) -> float:
        return float(self._L.st_max_priority(self._h))

    def add(self, priority: float) -> int:
        return int(self._L.st_add(self._h, float(priority)))

    def update(self, leaf: int, priority: float) -> None:
        self._L.st_update(self._h, int(leaf), float(priority))

    def update_batch(self, leaves, priorities) -> None:
        leaves = np.ascontiguousarray(leaves, np.int64)
        priorities = np.ascontiguousarray(priorities, np.float64)
        self._L.st_update_batch(
            self._h, leaves.size,
            leaves.ctypes.data_as(ct.POINTER(ct.c_int64)),
            priorities.ctypes.data_as(ct.POINTER(ct.c_double)))

    def get_leaf(self, v: float):
        p = ct.c_double(0.0)
        leaf = int(self._L.st_get_leaf(self._h, float(v), ct.byref(p)))
        return leaf, float(p.value)

    def sample_stratified(self, batch: int, uniforms):
        uniforms = np.ascontiguousarray(uniforms, np.float64)
        if uniforms.size != batch:
            raise ValueError(f"{uniforms.size} uniforms for a batch of "
                             f"{batch}")
        idx = np.empty(batch, np.int64)
        pri = np.empty(batch, np.float64)
        self._L.st_sample_stratified(
            self._h, batch,
            uniforms.ctypes.data_as(ct.POINTER(ct.c_double)),
            idx.ctypes.data_as(ct.POINTER(ct.c_int64)),
            pri.ctypes.data_as(ct.POINTER(ct.c_double)))
        return idx, pri

    def leaves(self) -> np.ndarray:
        out = np.empty(self.capacity, np.float64)
        self._L.st_get_leaves(self._h,
                              out.ctypes.data_as(ct.POINTER(ct.c_double)))
        return out

    def set_state(self, leaves, cursor: int, filled: int) -> None:
        leaves = np.ascontiguousarray(leaves, np.float64)
        if leaves.size != self.capacity:
            raise ValueError(f"{leaves.size} leaves for a capacity of "
                             f"{self.capacity}")
        self._L.st_set_state(
            self._h, leaves.ctypes.data_as(ct.POINTER(ct.c_double)),
            int(cursor), int(filled))
