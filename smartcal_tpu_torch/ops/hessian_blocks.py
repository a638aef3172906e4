"""Blocked residual-Hessian sums: the CUDA kernel ``csrc/hessian_blocks.cu``
and its plain PyTorch version.

Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_hessian.py
``_hessian_kernel`` (wrappers ``hessian_block_sums_pallas`` and
``hessian_res_core_pallas_sr``): per baseline, the off-diagonal block table
off[k, (i,u), (j,v)] = -sum_t conj(C)[k,t,(i,j)] R[t,(u,v)] and the
diagonal terms Sp = sum A1 A1^H (A1 = C conj(Jq)^T), Sq = sum A2^H A2
(A2 = Jp C), summed onto stations as Dsum.

On the card the kernel is bound by bytes: it reads C5, R3, Jp, Jq once and
writes off and Dsum once (~178 MB per launch at N=256, K=10, Td=10).  The
TPU kernel's accumulation of Dsum across a sequential grid becomes a second
pass with a fixed summation order (see the source).

:func:`hessian_block_sums` launches the kernel for CUDA tensors and raises
if the build or the launch fails; it runs the plain version
(``cal/kernels._hessian_block_sums``) only for tensors on the CPU.
``launches`` counts kernel launches (both passes count as one).
"""

import ctypes

import numpy as np
import torch

from smartcal_tpu_torch.cal import kernels

F32 = torch.float32

#: kernel launches so far; only the CUDA path counts
launches = 0

_argtypes_set = False
_full_csr = {}


def _lib():
    global _argtypes_set
    from smartcal_tpu_torch.ops import build

    lib = build.load("hessian_blocks")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.hessian_blocks_launch.argtypes = [p, p, p, p, p, p, p, p, i, i, i,
                                              i, p, p, p, p]
        lib.hessian_blocks_launch.restype = ctypes.c_int
        lib.hessian_blocks_error_string.argtypes = [ctypes.c_int]
        lib.hessian_blocks_error_string.restype = ctypes.c_char_p
        _argtypes_set = True
    return lib


def station_csr(idx, n_stations):
    """(perm, offsets) of a station-index vector: the baselines sorted
    stably by station, as int32, and the (N + 1,) start of each station's
    run.  Sentinel indices >= N sort after offsets[N] and are never read."""
    idx = idx.to(torch.int64)
    perm = torch.argsort(idx, stable=True).to(torch.int32)
    counts = torch.bincount(idx, minlength=n_stations + 1)[:n_stations]
    offsets = torch.zeros(n_stations + 1, dtype=torch.int32, device=idx.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return perm, offsets


def full_csr(n_stations, device):
    """(p_perm, p_off, q_perm, q_off) of the full baseline set (p < q
    row-major), built once per (N, device) on the host, so a launch of
    :func:`hessian_res_core_sr` does no sorting on the device."""
    key = (int(n_stations), torch.device(device))
    if key not in _full_csr:
        out = []
        for idx in np.triu_indices(n_stations, 1):
            perm = np.argsort(idx, kind="stable").astype(np.int32)
            offsets = np.zeros(n_stations + 1, np.int32)
            offsets[1:] = np.cumsum(np.bincount(idx, minlength=n_stations))
            out += [torch.from_numpy(perm).to(device),
                    torch.from_numpy(offsets).to(device)]
        _full_csr[key] = tuple(out)
    return _full_csr[key]


def _aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernel reads float4)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def hessian_block_sums_cuda(R3, C5, Jp, Jq, p_idx, q_idx, n_stations,
                            csr=None):
    """Launch the kernel on CUDA float32 tensors R3 (Td, B, 2, 2, 2),
    C5 (K, Td, B, 2, 2, 2), Jp/Jq (K, B, 2, 2, 2), p_idx/q_idx (B,), on the
    current stream.  ``csr`` is :func:`full_csr` when p_idx/q_idx are the
    full baseline set, else None (built here from the indices).  Returns
    (off (K, B, 4, 4, 2), Dsum (K, N, 2, 2, 2))."""
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
    if csr is None:
        csr = station_csr(p_idx, N) + station_csr(q_idx, N)
    p_perm, p_off, q_perm, q_off = csr
    off = torch.empty((K, B, 4, 4, 2), dtype=F32, device=dev)
    spsq = torch.empty((2, K, B, 8), dtype=F32, device=dev)
    dsum = torch.empty((K, N, 2, 2, 2), dtype=F32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.hessian_blocks_launch(
            C5.data_ptr(), R3.data_ptr(), Jp.data_ptr(), Jq.data_ptr(),
            p_perm.data_ptr(), p_off.data_ptr(), q_perm.data_ptr(),
            q_off.data_ptr(), K, Td, B, N, off.data_ptr(), spsq.data_ptr(),
            dsum.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("hessian_blocks launch failed: "
                           + lib.hessian_blocks_error_string(rc).decode())
    launches += 1
    return off, dsum


def hessian_block_sums(R3, C5, Jp, Jq, p_idx, q_idx, n_stations,
                       csr=None):
    """Unnormalized (off, Dsum) of the baselines ``p_idx``/``q_idx``: the
    kernel for CUDA tensors, the plain version for CPU tensors.  Any other
    device raises."""
    if C5.device.type == "cuda":
        return hessian_block_sums_cuda(R3, C5, Jp, Jq, p_idx, q_idx,
                                       n_stations, csr=csr)
    if C5.device.type == "cpu":
        return kernels._hessian_block_sums(R3, C5, Jp, Jq, p_idx, q_idx,
                                           n_stations)
    raise ValueError(f"hessian_blocks: unsupported device {C5.device}")


def hessian_res_core_sr(R3, C5, Jp, Jq, n_stations):
    """Residual Hessian (K, 4N, 4N, 2) normalized by B*Td: the block sums
    of :func:`hessian_block_sums` over every baseline, then the shared
    placement tail ``kernels._hessian_assemble``."""
    Td, B = C5.shape[1], C5.shape[2]
    p_idx, q_idx = kernels.baseline_indices(n_stations, C5.device)
    csr = full_csr(n_stations, C5.device) if C5.device.type == "cuda" \
        else None
    off, Dsum = hessian_block_sums(R3, C5, Jp, Jq, p_idx, q_idx, n_stations,
                                   csr=csr)
    return kernels._hessian_assemble(off, Dsum, n_stations, B, Td)
