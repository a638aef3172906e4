"""Split-real complex arithmetic on float32 (..., 2) tensors
(counterpart of smartcal_tpu/cal/creal.py).

The port keeps the JAX package's split-real layout (last axis = [re, im])
at every public function, so the parity tests compare like with like and
the operands of later kernels match the JAX ones one to one.  ``split``
and ``fuse`` are the host edge (numpy complex <-> float32 pairs), as in
the JAX package; the rest take and return tensors.
"""

import numpy as np
import torch

from smartcal_tpu_torch.cal import precision as prec


def split(x):
    """numpy complex -> float32 (..., 2) numpy.  Host-side."""
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-1).astype(np.float32)


def fuse(x):
    """float32 (..., 2) (numpy or tensor) -> numpy complex64.  Host-side."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    x = np.asarray(x)
    return (x[..., 0] + 1j * x[..., 1]).astype(np.complex64)


def conj(a):
    return torch.stack([a[..., 0], -a[..., 1]], dim=-1)


def mul(a, b):
    """Elementwise complex multiply (broadcasting)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar * br - ai * bi, ar * bi + ai * br], dim=-1)


def mul_i(a):
    """Multiply by the imaginary unit: (re, im) -> (-im, re)."""
    return torch.stack([-a[..., 1], a[..., 0]], dim=-1)


def abs2(a):
    """|z|^2, real output (drops the pair axis)."""
    return a[..., 0] ** 2 + a[..., 1] ** 2


def einsum(spec, a, b, compute_dtype=None):
    """Complex einsum over split operands: four real einsums.  ``spec`` is
    a two-operand spec over the NON-pair axes.

    ``compute_dtype`` (``cal/precision``): the operands are rounded to it
    and contracted in f32, with an f32 result (``precision.narrow``); None
    or f32 leaves them as they are."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    if compute_dtype is not None:
        ar, ai, br, bi = (prec.narrow(x, compute_dtype)
                          for x in (ar, ai, br, bi))
    rr = torch.einsum(spec, ar, br)
    ii = torch.einsum(spec, ai, bi)
    ri = torch.einsum(spec, ar, bi)
    ir = torch.einsum(spec, ai, br)
    return torch.stack([rr - ii, ri + ir], dim=-1)


def matmul(a, b):
    """Complex matmul over the last two non-pair axes: a (..., M, K, 2) @
    b (..., K, N, 2) -> (..., M, N, 2)."""
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    return torch.stack([ar @ br - ai @ bi, ar @ bi + ai @ br], dim=-1)


def solve(a, b):
    """Solve complex A x = b in split form through the real 2Nx2N block
    system [[Ar, -Ai], [Ai, Ar]] [xr; xi] = [br; bi] — one batched
    ``torch.linalg.solve`` in f32 (the JAX package leaves the same dense
    solve to XLA).

    a: (..., N, N, 2), b: (..., N, M, 2) -> (..., N, M, 2).
    """
    ar, ai = a[..., 0], a[..., 1]
    br, bi = b[..., 0], b[..., 1]
    n = a.shape[-3]
    top = torch.cat([ar, -ai], dim=-1)
    bot = torch.cat([ai, ar], dim=-1)
    abig = torch.cat([top, bot], dim=-2)                 # (..., 2N, 2N)
    bbig = torch.cat([br, bi], dim=-2)                   # (..., 2N, M)
    if abig.device.type == "cpu" and abig.dim() > 2:
        # one matrix at a time on the CPU: the batched multi-threaded MKL
        # getrf of some PyTorch CPU builds stalls for 2N >= 160
        x = torch.stack([torch.linalg.solve(a_, b_) for a_, b_ in
                         zip(abig.reshape(-1, 2 * n, 2 * n),
                             bbig.reshape(-1, 2 * n, bbig.shape[-1]))])
        x = x.reshape(bbig.shape)
    else:
        x = torch.linalg.solve(abig, bbig)
    return torch.stack([x[..., :n, :], x[..., n:, :]], dim=-1)


def scale(a, s):
    """Multiply split-complex ``a`` by a real scalar or array ``s``."""
    return a * torch.as_tensor(s, dtype=a.dtype, device=a.device)[..., None]
