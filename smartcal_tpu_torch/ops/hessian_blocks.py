"""Blocked residual-Hessian sums: the CUDA kernel ``csrc/hessian_blocks.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_hessian.py
``_hessian_kernel`` (wrappers ``hessian_block_sums_pallas`` and
``hessian_res_core_pallas_sr``): per baseline, the off-diagonal block table
off[k, (i,u), (j,v)] = -sum_t conj(C)[k,t,(i,j)] R[t,(u,v)] and the
diagonal terms Sp = sum A1 A1^H (A1 = C conj(Jq)^T), Sq = sum A2^H A2
(A2 = Jp C), summed onto stations as Dsum.

On the card the kernel is bound by bytes: it reads C5, R3, Jp, Jq once and
writes off and Dsum once (~178 MB per launch at N=256, K=10, Td=10).  One
CTA takes one tile of 8 x 8 cells (one baseline each) for every direction;
per sample it accumulates off and the 4x4 Gram matrix of C, from which Sp
and Sq follow once per (direction, baseline); it sums Sp along the tile's
cell rows and Sq along its columns into per-(tile, slot) partial rows, and
a short second launch sums each station's partial rows in a fixed order
(see the source).

The host lays the baselines out in tiles (:func:`schedule`):

* the full baseline set (p < q row-major, :func:`full_cells`): tile (i, j),
  i <= j, is the block of p-stations 8i..8i+7 by q-stations 8j..8j+7, so a
  cell row is one p-station and a cell column one q-station;
* any other index set (:func:`subset_cells`): baseline g*8 + i at cell
  (i, i) of tile g, each baseline a row and a column of its own.

``slot_dst`` gives each (tile, row or column) the partial row it writes, or
-1 (no station, or a sentinel index >= N); ``st_off`` gives each station's
run of partial rows, ordered p side then q side, each in tile order.
:func:`combine` applies that schedule to per-baseline Sp and Sq in
PyTorch, the kernel's reduction in its order.

:func:`hessian_block_sums` launches the kernel for CUDA tensors and raises
if the build or the launch fails; it runs the plain version
(``cal/kernels._hessian_block_sums``) only for tensors on the CPU.
``launches`` counts one per call (the tile pass and the combine).
:func:`block_sums_cost` is a call's analytic work (the bound of PERF.md's
kernel table), added to an ``obs.costs`` count on either path.
"""

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from smartcal_tpu_torch.cal import kernels
from smartcal_tpu_torch.obs import costs

F32 = torch.float32
ROWS, COLS = 8, 8        # p-stations x q-stations per tile (csrc kRows, kCols)
CELLS = ROWS * COLS

#: kernel launches so far; only the CUDA path counts (under a lock: the
#: positions of a sharded route launch from threads of their own)
launches = 0
_count_lock = threading.Lock()

_argtypes_set = False
_full = {}


class Schedule(NamedTuple):
    cell_b: torch.Tensor     # (tiles, 64) int32: baseline per cell, or -1
    slot_dst: torch.Tensor   # (tiles, ROWS + COLS) int32: partial row, or -1
    st_off: torch.Tensor     # (N + 1,) int32: each station's partial rows
    n_rows: int


def _lib():
    global _argtypes_set
    from smartcal_tpu_torch.ops import build

    lib = build.load("hessian_blocks")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hessian_blocks_launch.argtypes = [p, p, p, p, p, p, p, i, i, i,
                                              i, i, i, p, p, p, p]
        lib.hessian_blocks_launch.restype = ctypes.c_int
        lib.hessian_blocks_error_string.argtypes = [ctypes.c_int]
        lib.hessian_blocks_error_string.restype = ctypes.c_char_p
        _argtypes_set = True
    return lib


def full_cells(n_stations, shape=(ROWS, COLS)):
    """(tiles, rows*cols) int32 cell layout of the full baseline set: tile
    (i, j), row-major over blocks of ``rows`` p-stations and ``cols``
    q-stations, kept where it holds a baseline; cell (r, c) holds the
    baseline of p = rows*i + r, q = cols*j + c if p < q < N, else -1.
    Another ``shape`` than (ROWS, COLS) needs the kernel built with the same
    kRows, kCols (the tile-shape variants of chip_smoke.py
    --hessian-split)."""
    N = int(n_stations)
    rows, cols = shape
    i, j = (g.reshape(-1) for g in np.meshgrid(
        np.arange(-(-N // rows)), np.arange(-(-N // cols)), indexing="ij"))
    p = i[:, None, None] * rows + np.arange(rows)[None, :, None]
    q = j[:, None, None] * cols + np.arange(cols)[None, None, :]
    b = p * N - p * (p + 1) // 2 + (q - p - 1)
    cells = np.where((p < q) & (q < N), b, -1).reshape(-1, rows * cols)
    return cells[(cells >= 0).any(axis=1)].astype(np.int32)


def subset_cells(n_baselines):
    """(tiles, 64) int32 cell layout of any index set: with d = min(ROWS,
    COLS), baseline g*d + i at cell (i, i) of tile g, every other cell
    -1."""
    nb = int(n_baselines)
    d = min(ROWS, COLS)
    n_tiles = -(-nb // d)
    b = np.arange(n_tiles * d)
    cells = np.full((n_tiles, ROWS, COLS), -1, np.int64)
    r = np.arange(d)
    cells[:, r, r] = np.where(b < nb, b, -1).reshape(n_tiles, d)
    return cells.reshape(n_tiles, CELLS).astype(np.int32)


def schedule(cells, p_idx, q_idx, n_stations, shape=(ROWS, COLS)):
    """(slot_dst (tiles, rows + cols), st_off (N + 1,), n_rows) of a cell
    layout for station indices ``p_idx``/``q_idx`` (numpy).  Slot x < rows
    is cell row x (its cells' p), slot rows + y cell column y (its cells'
    q); a slot with no live cell or a station outside [0, N) writes
    nothing.  Each station's rows are numbered p side first, then q side,
    each in tile order.  Raises if a row's cells disagree on p or a
    column's on q."""
    N = int(n_stations)
    rows, cols = shape
    cb = np.asarray(cells).reshape(-1, rows, cols)
    n_tiles = cb.shape[0]
    live = cb >= 0
    safe = np.where(live, cb, 0)
    big = np.iinfo(np.int64).max
    st = []
    for idx, axis in ((np.asarray(p_idx), 2), (np.asarray(q_idx), 1)):
        s = idx[safe].astype(np.int64)
        lo = np.where(live, s, big).min(axis=axis)
        hi = np.where(live, s, -big).max(axis=axis)
        any_live = live.any(axis=axis)
        if np.any(any_live & (lo != hi)):
            raise ValueError("hessian_blocks: a tile row or column mixes "
                             "stations")
        st.append(np.where(any_live & (lo >= 0) & (lo < N), lo, -1))
    st = np.concatenate(st, axis=1)                      # (tiles, slots)
    slots = rows + cols
    flat = st.reshape(-1)
    valid = np.flatnonzero(flat >= 0)
    order = valid[np.lexsort((valid // slots, valid % slots >= rows,
                              flat[valid]))]
    slot_dst = np.full(n_tiles * slots, -1, np.int32)
    slot_dst[order] = np.arange(order.size, dtype=np.int32)
    st_off = np.zeros(N + 1, np.int32)
    st_off[1:] = np.cumsum(np.bincount(flat[valid], minlength=N))
    return slot_dst.reshape(n_tiles, slots), st_off, int(order.size)


def to_schedule(cells, p_idx, q_idx, n_stations, device, shape=(ROWS, COLS)):
    """:func:`schedule` of a cell layout as int32 tensors on ``device``."""
    slot_dst, st_off, n_rows = schedule(cells, p_idx, q_idx, n_stations,
                                        shape)
    return Schedule(torch.from_numpy(cells).to(device),
                    torch.from_numpy(slot_dst).to(device),
                    torch.from_numpy(st_off).to(device), n_rows)


def full_schedule(n_stations, device):
    """(Schedule, p_idx, q_idx) of the full baseline set (p < q row-major),
    built once per (N, device) on the host, so a launch of
    :func:`hessian_res_core_sr` copies nothing to the device."""
    key = (int(n_stations), torch.device(device))
    if key not in _full:
        p, q = np.triu_indices(key[0], 1)
        sched = to_schedule(full_cells(key[0]), p, q, key[0], key[1])
        _full[key] = (sched, torch.as_tensor(p, device=key[1]),
                      torch.as_tensor(q, device=key[1]))
    return _full[key]


def subset_schedule(p_idx, q_idx, n_stations, device):
    """Schedule of any index set (:func:`subset_cells`), built on the host
    from the indices."""
    p = p_idx.detach().cpu().numpy()
    q = q_idx.detach().cpu().numpy()
    return to_schedule(subset_cells(p.size), p, q, n_stations, device)


def combine(Sp, Sq, sched, n_stations):
    """The kernel's station reduction in PyTorch: per-baseline Sp, Sq
    (K, B, 8) -> Dsum (K, N, 8).  Cell rows are summed over their columns
    and cell columns over their rows into the partial rows ``slot_dst``
    names; station n's rows ``st_off[n]:st_off[n+1]`` are summed in four
    groups (rows g, g+4, ... in order) and the groups added as
    (g0 + g1) + (g2 + g3), as the combine launch does."""
    K = Sp.shape[0]
    cb = sched.cell_b.to(torch.int64)
    live = (cb >= 0)[None, :, :, None]
    cb = cb.clamp(min=0)

    def cells(S):
        return torch.where(live, S[:, cb], 0.0).reshape(K, -1, ROWS, COLS,
                                                        8)

    slots = torch.cat([cells(Sp).sum(dim=3), cells(Sq).sum(dim=2)], dim=2)
    dst = sched.slot_dst.reshape(-1).to(torch.int64)
    part = torch.zeros((K, sched.n_rows, 8), dtype=Sp.dtype, device=Sp.device)
    part[:, dst[dst >= 0]] = slots.reshape(K, -1, 8)[:, dst >= 0]
    st_off = sched.st_off.tolist()
    out = []
    for n in range(int(n_stations)):
        rows = part[:, st_off[n]:st_off[n + 1]]
        g = [rows[:, i::4].sum(dim=1) for i in range(4)]
        out.append((g[0] + g[1]) + (g[2] + g[3]))
    return torch.stack(out, dim=1)


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernel reads float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def hessian_block_sums_cuda(R3, C5, Jp, Jq, p_idx, q_idx, n_stations,
                            sched=None):
    """Launch the kernel on CUDA float32 tensors R3 (Td, B, 2, 2, 2),
    C5 (K, Td, B, 2, 2, 2), Jp/Jq (K, B, 2, 2, 2), p_idx/q_idx (B,), on the
    current stream.  ``sched`` is :func:`full_schedule`'s when p_idx/q_idx
    are the full baseline set, else None (built here from the indices).
    Returns (off (K, B, 4, 4, 2), Dsum (K, N, 2, 2, 2))."""
    global launches
    K, Td, B = C5.shape[0], C5.shape[1], C5.shape[2]
    N = int(n_stations)
    want = {"R3": (R3, (Td, B, 2, 2, 2)), "C5": (C5, (K, Td, B, 2, 2, 2)),
            "Jp": (Jp, (K, B, 2, 2, 2)), "Jq": (Jq, (K, B, 2, 2, 2))}
    for name, (t, shape) in want.items():
        if t.device.type != "cuda" or t.dtype != F32 \
                or tuple(t.shape) != shape or t.device != C5.device:
            raise ValueError(f"hessian_blocks: {name} must be a float32 "
                             f"{shape} tensor on {C5.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    for name, t in (("p_idx", p_idx), ("q_idx", q_idx)):
        if tuple(t.shape) != (B,) or t.device != C5.device \
                or t.dtype.is_floating_point:
            raise ValueError(f"hessian_blocks: {name} must be an integer "
                             f"({B},) tensor on {C5.device}")
    if K == 0 or Td == 0 or B == 0 or N == 0:
        raise ValueError("hessian_blocks: empty operand")
    dev = C5.device
    R3, C5, Jp, Jq = (_aligned(t) for t in (R3, C5, Jp, Jq))
    if sched is None:
        sched = subset_schedule(p_idx, q_idx, N, dev)
    off = torch.empty((K, B, 4, 4, 2), dtype=F32, device=dev)
    part = torch.empty((K, max(sched.n_rows, 1), 8), dtype=F32, device=dev)
    dsum = torch.empty((K, N, 2, 2, 2), dtype=F32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hessian_blocks_launch(
            C5.data_ptr(), R3.data_ptr(), Jp.data_ptr(), Jq.data_ptr(),
            sched.cell_b.data_ptr(), sched.slot_dst.data_ptr(),
            sched.st_off.data_ptr(), K, Td, B, N, sched.cell_b.shape[0],
            sched.n_rows, off.data_ptr(), part.data_ptr(), dsum.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError("hessian_blocks launch failed: "
                           + lib.hessian_blocks_error_string(rc).decode())
    with _count_lock:
        launches += 1
    return off, dsum


def block_sums_cost(R3, C5, Jp, Jq, p_idx, q_idx, n_stations):
    """(flops, bytes) of one block-sums call: every operand read once, off
    and Dsum written once; 192 FP32 flops per (k, t, b) (off 128, the Gram
    matrix of C 64) and 384 per (k, b)."""
    K, Td, B = C5.shape[0], C5.shape[1], C5.shape[2]
    n_in = sum(t.numel() * t.element_size()
               for t in (R3, C5, Jp, Jq, p_idx, q_idx))
    n_out = (K * B * 32 + K * int(n_stations) * 8) * 4
    return 192.0 * K * Td * B + 384.0 * K * B, n_in + n_out


def hessian_block_sums(R3, C5, Jp, Jq, p_idx, q_idx, n_stations,
                       sched=None):
    """Unnormalized (off, Dsum) of the baselines ``p_idx``/``q_idx``: the
    kernel for CUDA tensors, the plain version for CPU tensors.  Any other
    device raises."""
    if C5.device.type not in ("cuda", "cpu"):
        raise ValueError(f"hessian_blocks: unsupported device {C5.device}")
    with costs.kernel_cost(*block_sums_cost(R3, C5, Jp, Jq, p_idx, q_idx,
                                            n_stations)):
        if C5.device.type == "cuda":
            return hessian_block_sums_cuda(R3, C5, Jp, Jq, p_idx, q_idx,
                                           n_stations, sched=sched)
        return kernels._hessian_block_sums(R3, C5, Jp, Jq, p_idx, q_idx,
                                           n_stations)


def hessian_res_core_sr(R3, C5, Jp, Jq, n_stations):
    """Residual Hessian (K, 4N, 4N, 2) normalized by B*Td: the block sums
    of :func:`hessian_block_sums` over every baseline, then the shared
    placement tail ``kernels._hessian_assemble``."""
    Td, B = C5.shape[1], C5.shape[2]
    sched, p_idx, q_idx = full_schedule(n_stations, C5.device)
    off, Dsum = hessian_block_sums(R3, C5, Jp, Jq, p_idx, q_idx, n_stations,
                                   sched=sched)
    return kernels._hessian_assemble(off, Dsum, n_stations, B, Td)
