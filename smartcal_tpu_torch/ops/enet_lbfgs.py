"""The elastic-net L-BFGS solve: the CUDA kernel ``csrc/enet_lbfgs.cu``
(kernel 4 of the port) and its plain PyTorch version.

Replaces no Pallas kernel: the JAX package runs this solve as plain XLA
inside its one-program episode, the ``while_loop`` on the device.  The
port's plain version, :func:`~smartcal_tpu_torch.ops.lbfgs.lbfgs_solve` over
autograd, asks the host once per iteration whether a lane is still
active, so a CUDA graph cannot hold it; the kernel runs each lane's whole
loop in one launch.

The objective of lane ``l`` is ``sum((w (y - A x))^2) + l2 ||x||^2 + l1
sum |x|`` (``envs/enet``'s ``_lane_loss``), from x = 0, with the L-BFGS of
``ops/lbfgs`` step for step (see the source).  ``A`` (G, N, M) and ``y``
(G, N) are shared by runs of L / G consecutive lanes (G = L: one problem
per lane, the env step; G = E: the hint's 50 lanes per env), ``w`` (L, N)
is an optional per-lane row weight (the hint's 2-fold CV), ``l2``/``l1``
(L,) per lane.

:func:`solve` launches the kernel for CUDA tensors and raises if the
build or the launch fails; it runs the plain version only for tensors on
the CPU.  ``launches`` counts the launches the host made outside a CUDA
graph capture; ``device_launches`` is the kernel's own count of its runs
on the card, graph replays included.  Under ``obs.costs`` a call adds
:func:`solve_cost`.
"""

import ctypes

import torch

from smartcal_tpu_torch.obs import costs
from smartcal_tpu_torch.ops.autodiff import lane_value_and_grad
from smartcal_tpu_torch.ops.build import DeviceLaunchCount
from smartcal_tpu_torch.ops.lbfgs import (LBFGS_HISTORY_DEFAULT, LBFGSHistory,
                                          LBFGSResult, lbfgs_solve,
                                          linesearch_phi_evals)

F32 = torch.float32
#: the H100's per-block shared memory (opt-in); the kernel keeps a lane in it
MAX_SMEM_BYTES = 232448

#: kernel launches so far made outside a CUDA graph capture (the host's
#: count); only the CUDA path counts
launches = 0
#: the kernel's runs on the card, counted by the kernel (replays included)
device_launches = DeviceLaunchCount("enet_lbfgs")

_argtypes_set = False


def abs_jax(x):
    """``|x|`` whose derivative at 0 is +1 (JAX's rule for ``abs``,
    ``select(x >= 0, g, -g)``; torch's own ``abs`` gives 0 there)."""
    return torch.where(x >= 0, x, -x)


def lane_loss(A, y, x, l2, l1, w=None):
    """Per-lane elastic-net loss of x (L, M): ``sum(((y - A x) w)^2) +
    l2 ||x||^2 + l1 ||x||_1`` with A (N, M) shared by the lanes or (L, N,
    M) per lane, y (N,) or (L, N), (L,) or scalar l2, l1 and an optional
    (L, N) row weight w."""
    err = y - (A @ x[..., None]).squeeze(-1)
    if w is not None:
        err = err * w
    return (torch.sum(err ** 2, dim=-1) + l2 * torch.sum(x ** 2, dim=-1)
            + l1 * torch.sum(abs_jax(x), dim=-1))


#: the kernel's fast path (csrc ``fast_path``): one thread per element and
#: a history held in registers; the CUDA tests hold :func:`smem_bytes` to
#: the kernel's own ``enet_lbfgs_smem_bytes``
FAST_WIDTH, FAST_HISTORY = 32, 8


def fast_path(N, M, history_size) -> bool:
    """Whether (N, M, history_size) takes the kernel's fast path: one
    thread per element of x and of the residual, A and the history in
    registers (see the source); wider problems take its wide path."""
    return N <= FAST_WIDTH and M <= FAST_WIDTH and history_size <= \
        FAST_HISTORY


def smem_bytes(N, M, history_size):
    """Shared memory of one lane's block (csrc ``enet_lbfgs_smem_bytes``):
    on the fast path two 32-wide operand buffers; on the wide path A and
    its transpose, y, w, the residual, six M-vectors and the curvature
    pairs."""
    if fast_path(N, M, history_size):
        return 4 * 2 * FAST_WIDTH
    return 4 * (2 * N * M + 3 * N + 6 * M + 2 * history_size * M
                + 2 * history_size)


def _expand(A, y, L):
    per = L // A.shape[0]
    if per == 1:
        return A, y
    return A.repeat_interleave(per, dim=0), y.repeat_interleave(per, dim=0)


def solve_plain(A, y, l2, l1, w=None, max_iters=200,
                history_size=LBFGS_HISTORY_DEFAULT, tolerance_grad=1e-5,
                tolerance_change=1e-9) -> LBFGSResult:
    """The plain version: :func:`lbfgs_solve` over the autograd gradient
    of :func:`lane_loss`, every lane from x = 0."""
    L, M = l2.shape[0], A.shape[-1]
    Ae, ye = _expand(A, y, L)
    x0 = torch.zeros((L, M), dtype=A.dtype, device=A.device)
    return lbfgs_solve(
        lane_value_and_grad(lambda x: lane_loss(Ae, ye, x, l2, l1, w)), x0,
        max_iters=max_iters, history_size=history_size,
        tolerance_grad=tolerance_grad, tolerance_change=tolerance_change)


def _lib():
    global _argtypes_set
    from smartcal_tpu_torch.ops import build

    lib = build.load("enet_lbfgs")
    if not _argtypes_set:
        bind(lib)
        _argtypes_set = True
    return lib


def bind(lib):
    """Set the C entry points' argument types on a loaded library."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.enet_lbfgs_launch.argtypes = [p, p, p, p, p, i, i, i, i, i, i, f, f,
                                      p, p, p, p, p, p, p, p, p, p, p, p, p,
                                      p]
    lib.enet_lbfgs_launch.restype = ctypes.c_int
    lib.enet_lbfgs_error_string.argtypes = [ctypes.c_int]
    lib.enet_lbfgs_error_string.restype = ctypes.c_char_p
    lib.enet_lbfgs_smem_bytes.argtypes = [i, i, i]
    lib.enet_lbfgs_smem_bytes.restype = ctypes.c_size_t


def launch(lib, A, y, l2, l1, w, max_iters, history_size, tolerance_grad,
           tolerance_change, stream, counter=0):
    """One launch of ``lib``'s kernel on checked, contiguous operands, on
    ``stream`` (an int); ``counter`` the device address of an int64 the
    kernel increments, or 0.  Returns (LBFGSResult, per-lane
    evaluations the kernel performed: on its fast path the search's
    phi(0) is the accepted point's loss and g . d, not evaluated again)."""
    G, N, M = A.shape
    L, m = l2.shape[0], int(history_size)
    dev = A.device
    # three allocations, the outputs views into them: a lone launch's time
    # is mostly the host's
    fl = torch.empty(L * (2 * M + 2 + 2 * m * M), dtype=F32, device=dev)
    x, grad, loss, gamma, S, Y = torch.split(
        fl, [L * M, L * M, L, L, L * m * M, L * m * M])
    x, grad = x.view(L, M), grad.view(L, M)
    S, Y = S.view(L, m, M), Y.view(L, m, M)
    count, n_iters, evals = torch.empty(
        (3, L), dtype=torch.int32, device=dev).unbind(0)
    conv, stop, div = torch.empty((3, L), dtype=torch.bool,
                                  device=dev).unbind(0)
    rc = lib.enet_lbfgs_launch(
        A.data_ptr(), y.data_ptr(), 0 if w is None else w.data_ptr(),
        l2.data_ptr(), l1.data_ptr(), L, G, N, M, m, int(max_iters),
        float(tolerance_grad), float(tolerance_change), x.data_ptr(),
        loss.data_ptr(), grad.data_ptr(), S.data_ptr(), Y.data_ptr(),
        count.data_ptr(), gamma.data_ptr(), n_iters.data_ptr(),
        conv.data_ptr(), stop.data_ptr(), div.data_ptr(), evals.data_ptr(),
        counter, stream)
    if rc != 0:
        raise RuntimeError("enet_lbfgs launch failed: "
                           + lib.enet_lbfgs_error_string(rc).decode())
    res = LBFGSResult(x=x, loss=loss, grad=grad,
                      hist=LBFGSHistory(s=S, y=Y, count=count, gamma=gamma),
                      n_iters=n_iters, converged=conv, stop=stop,
                      diverged=div)
    return res, evals


def check(A, y, l2, l1, w, history_size):
    """Contiguous float32 operands of one device, checked against the
    kernel's layout; raises ValueError naming what does not fit."""
    if A.dim() != 3 or y.dim() != 2 or y.shape != A.shape[:2]:
        raise ValueError(f"enet_lbfgs: A must be (G, N, M) and y (G, N), got "
                         f"{tuple(A.shape)} and {tuple(y.shape)}")
    G, N, M = A.shape
    L = l2.shape[0]
    if l2.shape != (L,) or l1.shape != (L,) or L == 0 or L % G:
        raise ValueError(f"enet_lbfgs: l2 and l1 must be (L,) with L a "
                         f"multiple of G={G}, got {tuple(l2.shape)} and "
                         f"{tuple(l1.shape)}")
    if w is not None and tuple(w.shape) != (L, N):
        raise ValueError(f"enet_lbfgs: w must be ({L}, {N}), got "
                         f"{tuple(w.shape)}")
    need = smem_bytes(N, M, history_size)
    if need > MAX_SMEM_BYTES:
        raise ValueError(f"enet_lbfgs: N={N}, M={M} and a history of "
                         f"{history_size} need {need} bytes of shared "
                         f"memory per lane, above the {MAX_SMEM_BYTES} a "
                         "block may hold")
    ops = [A, y, l2, l1] + ([] if w is None else [w])
    for t in ops:
        if t.device != A.device:
            raise ValueError("enet_lbfgs: operands on more than one device")
    return [t.to(F32).contiguous() if t is not None else None
            for t in (A, y, l2, l1, w)]


def solve_cuda(A, y, l2, l1, w=None, max_iters=200,
               history_size=LBFGS_HISTORY_DEFAULT, tolerance_grad=1e-5,
               tolerance_change=1e-9, with_evals=False):
    """Launch the kernel on CUDA tensors on the current stream; returns
    the :class:`LBFGSResult` (and with ``with_evals`` the (L,) int32
    objective evaluations each lane performed)."""
    global launches
    if A.device.type != "cuda":
        raise ValueError(f"enet_lbfgs: the kernel needs CUDA tensors, got "
                         f"{A.device}")
    A, y, l2, l1, w = check(A, y, l2, l1, w, history_size)
    lib = _lib()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        res, evals = launch(lib, A, y, l2, l1, w, max_iters, history_size,
                            tolerance_grad, tolerance_change, stream,
                            device_launches.pointer(A.device))
        if not torch.cuda.is_current_stream_capturing():
            launches += 1
    return (res, evals) if with_evals else res


def eval_flops(N, M, weighted):
    """Flops of one objective evaluation (value, gradient and the slope
    along the direction): A x and A^T r, 2NM each, and the elementwise
    terms."""
    return 4.0 * N * M + (6.0 if weighted else 4.0) * N + 10.0 * M


def solve_cost(A, y, l2, l1, w, evals) -> tuple:
    """(flops, bytes) of one call whose lanes made ``evals`` objective
    evaluations in all (the work this data needed): each evaluation's
    flops, every operand read once and the result written once."""
    G, N, M = A.shape
    L = l2.shape[0]
    n_in = sum(t.numel() * 4 for t in (A, y, l2, l1) + (() if w is None
                                                          else (w,)))
    n_out = L * (2 * M + 2 + 2 * LBFGS_HISTORY_DEFAULT * M + 3) * 4 + 3 * L
    return eval_flops(N, M, w is not None) * float(evals), float(n_in + n_out)


def solve(A, y, l2, l1, w=None, max_iters=200,
          history_size=LBFGS_HISTORY_DEFAULT, tolerance_grad=1e-5,
          tolerance_change=1e-9) -> LBFGSResult:
    """Per-lane elastic-net L-BFGS from x = 0: the kernel for CUDA
    tensors, the plain version for CPU tensors.  Any other device
    raises."""
    kw = dict(max_iters=max_iters, history_size=history_size,
              tolerance_grad=tolerance_grad,
              tolerance_change=tolerance_change)
    if A.device.type not in ("cuda", "cpu"):
        raise ValueError(f"enet_lbfgs: unsupported device {A.device}")
    cuda = A.device.type == "cuda"
    if not costs.counting():
        return (solve_cuda if cuda else solve_plain)(A, y, l2, l1, w, **kw)
    with costs.uncounted():
        if cuda:
            res, evals = solve_cuda(A, y, l2, l1, w, with_evals=True, **kw)
            n_evals = int(evals.sum())
        else:
            # the plain version's evaluations: the initial one per lane,
            # then per iteration one and the search's lower bound
            res = solve_plain(A, y, l2, l1, w, **kw)
            n_evals = (l2.shape[0] + int(res.n_iters.sum())
                       * (1 + linesearch_phi_evals(vmapped=False)))
    with costs.kernel_cost(*solve_cost(A, y, l2, l1, w, n_evals)):
        pass
    return res
