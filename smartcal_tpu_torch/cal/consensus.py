"""Consensus-ADMM polynomial constraint cores (counterpart of
smartcal_tpu/cal/consensus.py): the frequency basis and the small
Ne-dimensional cores the solver and the influence chain use.
"""

import math

import torch

F32 = torch.float32


def bernstein_basis(x, n):
    """Bernstein basis of order ``n`` at points ``x`` in [0, 1]:
    (len(x), n+1), column r = C(n,r) x^r (1-x)^(n-r)."""
    x = torch.as_tensor(x, dtype=F32)
    r = torch.arange(n + 1, dtype=F32, device=x.device)
    logc = (math.lgamma(n + 1.0) - torch.lgamma(r + 1.0)
            - torch.lgamma(n - r + 1.0))
    xx = x[:, None]
    px = torch.where(r == 0, torch.ones_like(xx), xx ** r)
    p1x = torch.where(r == n, torch.ones_like(xx), (1.0 - xx) ** (n - r))
    return torch.exp(logc)[None, :] * px * p1x


def poly_basis(freqs, f0, n_terms, polytype=0, frange=None):
    """Frequency basis B (Nf, Ne): ordinary ((f-f0)/f0)^j or Bernstein."""
    freqs = torch.as_tensor(freqs, dtype=F32)
    if polytype == 0:
        ff = (freqs - f0) / f0
        j = torch.arange(n_terms, dtype=F32, device=freqs.device)
        return ff[:, None] ** j[None, :]
    fmin, fmax = frange if frange is not None else (freqs.min(), freqs.max())
    ff = (freqs - fmin) / (fmax - fmin)
    return bernstein_basis(ff, n_terms - 1)


def consensus_cores(freqs, f0, n_terms, polytype=0, rho=0.0, alpha=0.0):
    """(Bfull (Nf, Ne), Bi (..., Ne, Ne), fscale (..., Nf)) with
    Bi = pinv(rho sum_f b_f b_f^T + alpha I) and fscale[f] =
    1 - rho b_f Bi b_f^T.  ``rho``/``alpha`` may be (K,) tensors: the
    cores then carry a leading direction axis."""
    bfull = poly_basis(freqs, f0, n_terms, polytype)
    rho = torch.as_tensor(rho, dtype=F32, device=bfull.device)
    alpha = torch.as_tensor(alpha, dtype=F32, device=bfull.device)
    eye = torch.eye(n_terms, dtype=F32, device=bfull.device)
    btb = bfull.T @ bfull
    bi_raw = rho[..., None, None] * btb + alpha[..., None, None] * eye
    bi = torch.linalg.pinv(bi_raw)
    fscale = 1.0 - rho[..., None] * torch.einsum("fi,...ij,fj->...f",
                                                 bfull, bi, bfull)
    return bfull, bi, fscale


def consensus_poly(n_terms, n_stations, freqs, f0, fidx, polytype=0,
                   rho=0.0, alpha=0.0):
    """Dense (F, P) with the reference's shapes, for golden tests and API
    parity (reference calibration_tools.py:551-585): F (2N, 2N) =
    (1 - rho b_f Bi b_f^T) I_2N and P (2N*Ne, 2N) = kron(Bi b_f^T, I_2N)."""
    bfull, bi, fscale = consensus_cores(freqs, f0, n_terms, polytype, rho,
                                        alpha)
    eye2n = torch.eye(2 * n_stations, dtype=F32, device=bfull.device)
    return (fscale[fidx] * eye2n,
            torch.kron(bi @ bfull[fidx][:, None], eye2n))
