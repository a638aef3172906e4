"""Eigenvalues of the symmetric part of small matrices: the CUDA kernel
``csrc/sym_eigvals.cu`` (kernel 5 of the port) and its plain PyTorch
version.

Replaces no Pallas kernel: the JAX package takes ``eigvalsh(0.5 (B +
B^T))`` inside its one-program episode (``envs/enet._eig_state``).
``torch.linalg.eigvalsh`` on CUDA synchronises the device with the host,
so a CUDA graph cannot hold it; the kernel (parallel cyclic Jacobi in
float64, one block per matrix, the disjoint rotations of a round applied
together, see the source) keeps the episode capturable.  The eigenvalues
come out ascending, in ``eigvalsh``'s order.  :func:`round_robin` builds
the kernel's order of rotations on the host.

:func:`sym_eigvals` launches the kernel for CUDA tensors and raises if the
build or the launch fails; it runs the plain version (``eigvalsh``) only
for tensors on the CPU.  ``launches`` counts the launches the host made
outside a CUDA graph capture; ``device_launches`` is the kernel's own
count of its runs on the card, graph replays included.
"""

import ctypes

import torch

from smartcal_tpu_torch.obs import costs
from smartcal_tpu_torch.ops.build import DeviceLaunchCount

F32 = torch.float32
MAX_N = 88            # one thread per 2 x 2 block of the upper triangle

#: kernel launches so far made outside a CUDA graph capture (the host's
#: count); only the CUDA path counts
launches = 0
#: the kernel's runs on the card, counted by the kernel (replays included)
device_launches = DeviceLaunchCount("sym_eigvals")

_argtypes_set = False
_schedules = {}


def sym_eigvals_plain(B):
    """The plain version: ``eigvalsh`` of ``0.5 (B + B^T)``."""
    return torch.linalg.eigvalsh(0.5 * (B + B.transpose(-1, -2)))


def round_robin(n):
    """The kernel's order of rotations for n x n matrices: (n_p - 1, n_p /
    2, 2) int32 pairs (p, q), p < q, n_p = n rounded up to even (index n
    is an all-zero phantom when n is odd).  The circle method: index n_p -
    1 stays put and the others turn one place a round, so each round pairs
    every index once and each pair meets once in the n_p - 1 rounds of a
    sweep."""
    n_p = n + n % 2
    rounds = []
    for r in range(n_p - 1):
        pairs = [(r, n_p - 1)]
        for i in range(1, n_p // 2):
            a, b = (r + i) % (n_p - 1), (r - i) % (n_p - 1)
            pairs.append((min(a, b), max(a, b)))
        rounds.append(pairs)
    return torch.tensor(rounds, dtype=torch.int32).reshape(n_p - 1,
                                                           n_p // 2, 2)


def _schedule(n, device):
    """:func:`round_robin` on ``device``, made on first use; the first use
    may not be inside a CUDA graph capture, which cannot copy from the
    host."""
    key = (n, device)
    sched = _schedules.get(key)
    if sched is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"sym_eigvals: first launch at n={n} inside a "
                               "CUDA graph capture; launch it once before "
                               "capturing")
        sched = round_robin(n).to(device)
        _schedules[key] = sched
    return sched


def _lib():
    global _argtypes_set
    from smartcal_tpu_torch.ops import build

    lib = build.load("sym_eigvals")
    if not _argtypes_set:
        bind(lib)
        _argtypes_set = True
    return lib


def bind(lib):
    """Set the C entry points' argument types on a loaded library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sym_eigvals_launch.argtypes = [p, i, i, p, p, p, p, p]
    lib.sym_eigvals_launch.restype = ctypes.c_int
    lib.sym_eigvals_error_string.argtypes = [ctypes.c_int]
    lib.sym_eigvals_error_string.restype = ctypes.c_char_p


def launch(lib, B, sched, stream, sweeps=None, counter=0):
    """One launch of ``lib``'s kernel on a contiguous float32 (L, n, n)
    ``B`` with the :func:`round_robin` schedule ``sched`` on B's device, on
    ``stream`` (an int); ``sweeps`` an (L,) int32 tensor for the sweeps
    each matrix took, or None; ``counter`` the device address of an int64
    the kernel increments, or 0.  Returns (L, n) ascending."""
    L, n = B.shape[0], B.shape[-1]
    out = torch.empty((L, n), dtype=F32, device=B.device)
    rc = lib.sym_eigvals_launch(B.data_ptr(), L, n, sched.data_ptr(),
                                out.data_ptr(),
                                0 if sweeps is None else sweeps.data_ptr(),
                                counter, stream)
    if rc != 0:
        raise RuntimeError("sym_eigvals launch failed: "
                           + lib.sym_eigvals_error_string(rc).decode())
    return out


def sym_eigvals_cuda(B, sweeps=None):
    """Launch the kernel on a CUDA (..., n, n) tensor on the current
    stream; returns (..., n) float32."""
    global launches
    if B.device.type != "cuda" or B.dim() < 2 or B.shape[-1] != B.shape[-2]:
        raise ValueError(f"sym_eigvals: needs a CUDA (..., n, n) tensor, got "
                         f"{tuple(B.shape)} on {B.device}")
    n = B.shape[-1]
    if not 0 < n <= MAX_N or B.numel() == 0:
        raise ValueError(f"sym_eigvals: n={n} outside 1..{MAX_N} (one "
                         "thread per 2 x 2 block, 1024 at most), or empty")
    lead = B.shape[:-2]
    flat = B.reshape(-1, n, n).to(F32).contiguous()
    with torch.cuda.device(B.device):
        stream = torch.cuda.current_stream(B.device).cuda_stream
        out = launch(_lib(), flat, _schedule(n, B.device), stream, sweeps,
                     device_launches.pointer(B.device))
        if not torch.cuda.is_current_stream_capturing():
            launches += 1
    return out.reshape(lead + (n,))


def eig_cost(B) -> tuple:
    """(flops, bytes) of the function, whatever computes it: ~4/3 n^3
    flops per matrix (the reduction to tridiagonal form that a symmetric
    eigensolve needs; the Jacobi kernel does more), B read once and the
    eigenvalues written once."""
    n = B.shape[-1]
    L = B.numel() // max(n * n, 1)
    return 4.0 / 3.0 * n ** 3 * L, 4.0 * (B.numel() + L * n)


def sym_eigvals(B):
    """Ascending eigenvalues of ``0.5 (B + B^T)`` for (..., n, n) ``B``:
    the kernel for CUDA tensors, the plain version for CPU tensors.  Any
    other device raises."""
    if B.device.type not in ("cuda", "cpu"):
        raise ValueError(f"sym_eigvals: unsupported device {B.device}")
    with costs.kernel_cost(*eig_cost(B)):
        if B.device.type == "cuda":
            return sym_eigvals_cuda(B)
        return sym_eigvals_plain(B)
