"""Shapelet (Gauss-Hermite) diffuse-sky models (counterpart of
smartcal_tpu/cal/shapelets.py).

The shapelet basis is, up to i^n, its own Fourier transform, so the
uv-plane coherency of a diffuse component is a closed-form sum over modes:
no gridding.  Conventions (those of ``cal/coherency``'s e^{+i phase}
prediction):

  image basis   phi_n(x; b) = H_n(x/b) exp(-x^2/(2 b^2))
                              / sqrt(2^n n! sqrt(pi) b)
  visibility    V(u, v) = 2 pi sum_{n1, n2} a_{n1 n2} i^{n1+n2}
                          phi_{n1}(2 pi u_l; 1/b) phi_{n2}(2 pi v_l; 1/b)

with u_l, v_l in wavelengths.  All device math is float32; the random
modes are host numpy draws, as in the JAX package.
"""

import math
from typing import NamedTuple

import numpy as np
import torch

C_LIGHT = 299792458.0


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def basis_1d(n_max: int, x, beta):
    """phi_0..phi_{n_max-1} at ``x``: (n_max, ...) orthonormal basis, by the
    recurrence on the normalized Hermite functions
    psi_{n+1} = t sqrt(2/(n+1)) psi_n - sqrt(n/(n+1)) psi_{n-1} with the
    Gaussian envelope folded in from the start (the raw H_n(t) recurrence
    overflows float32 at resolved-out baselines, psi_n underflows to 0)."""
    x = _f32(x)
    t = x / beta
    env = torch.exp(-0.5 * t * t)
    psi = [env * (math.pi ** -0.25)]
    if n_max > 1:
        psi.append(t * math.sqrt(2.0) * psi[0])
    for n in range(1, n_max - 1):
        psi.append(t * math.sqrt(2.0 / (n + 1)) * psi[n]
                   - math.sqrt(n / (n + 1.0)) * psi[n - 1])
    return torch.stack(psi[:n_max]) / torch.sqrt(_f32(beta, x.device))


def shapelet_image(coeff, l, m, beta, l0=0.0, m0=0.0):
    """I(l, m) = sum a_{n1 n2} phi_{n1}(l - l0) phi_{n2}(m - m0)."""
    l, m = _f32(l), _f32(m)
    coeff = _f32(coeff, l.device)
    n0 = coeff.shape[0]
    bl = basis_1d(n0, l - l0, beta)                      # (n0, ...)
    bm = basis_1d(n0, m - m0, beta)
    return torch.einsum("ab,a...,b...->...", coeff, bl, bm)


def _mode_weights(n0, device):
    """The i^(n1+n2) routing of each mode: (re_w, im_w), each (n0, n0), with
    n1+n2 = 0, 1, 2, 3 (mod 4) going to +Re, +Im, -Re, -Im."""
    n_sum = np.add.outer(np.arange(n0), np.arange(n0)) % 4
    re_w = (n_sum == 0).astype(np.float32) - (n_sum == 2)
    im_w = (n_sum == 1).astype(np.float32) - (n_sum == 3)
    return _f32(re_w, device), _f32(im_w, device)


def shapelet_uv_sr(coeff, u_l, v_l, beta, l0=0.0, m0=0.0):
    """Split-real visibilities (..., R, 2) of the shapelet at baseline
    coordinates ``u_l, v_l`` (wavelengths, (..., R)).  Leading axes (the
    sub-bands) are batched: each is one pair of (n0, n0) x (n0, R)
    contractions.  An off-centre component picks up the
    e^{+2 pi i (u l0 + v m0)} phase ramp."""
    u_l, v_l = _f32(u_l), _f32(v_l)
    coeff = _f32(coeff, u_l.device)
    n0 = coeff.shape[0]
    bu = basis_1d(n0, 2.0 * math.pi * u_l, 1.0 / beta)  # (n0, ..., R)
    bv = basis_1d(n0, 2.0 * math.pi * v_l, 1.0 / beta)
    bu, bv = bu.movedim(0, -2), bv.movedim(0, -2)        # (..., n0, R)
    re_w, im_w = _mode_weights(n0, u_l.device)
    sp = 2.0 * math.pi
    re = sp * torch.sum(bu * ((re_w * coeff) @ bv), dim=-2)
    im = sp * torch.sum(bu * ((im_w * coeff) @ bv), dim=-2)
    if l0 == 0.0 and m0 == 0.0:
        return torch.stack([re, im], dim=-1)
    phase = 2.0 * math.pi * (u_l * l0 + v_l * m0)
    c, s = torch.cos(phase), torch.sin(phase)
    return torch.stack([re * c - im * s, re * s + im * c], dim=-1)


def _coherency(vis):
    """(..., R, 2) Stokes-I visibilities -> (..., R, 4, 2) coherencies with
    V in XX and YY (the cluster convention of cal/coherency)."""
    z = torch.zeros_like(vis)
    return torch.stack([vis, z, z, vis], dim=-2)


def shapelet_coherency_sr(coeff, uu, vv, freq, beta, flux=1.0,
                          l0=0.0, m0=0.0):
    """(R, 4, 2) coherency contribution of a Stokes-I shapelet component at
    one frequency, scaled by the sky-table flux.  ``uu, vv`` in meters."""
    scale = float(freq) / C_LIGHT
    vis = flux * shapelet_uv_sr(coeff, _f32(uu) * scale, _f32(vv) * scale,
                                beta, l0=l0, m0=m0)
    return _coherency(vis)


def shapelet_coherency_multi_sr(coeff, uu, vv, freqs, beta, flux=1.0,
                                l0=0.0, m0=0.0):
    """(Nf, R, 4, 2) shapelet coherencies of all sub-bands as one batched
    expression; the per-band wavelength scales are rounded on the host as
    in :func:`shapelet_coherency_sr`, so the two agree to round-off."""
    uu, vv = _f32(uu), _f32(vv)
    f = freqs.cpu().numpy() if isinstance(freqs, torch.Tensor) else freqs
    scales = _f32(np.asarray(f, np.float64) / C_LIGHT, uu.device)[:, None]
    vis = flux * shapelet_uv_sr(coeff, uu[None] * scales, vv[None] * scales,
                                beta, l0=l0, m0=m0)
    return _coherency(vis)


class ShapeletModel(NamedTuple):
    """A random diffuse component and its perturbed calibration twin."""

    coeff: np.ndarray         # (n0, n0)
    beta: float
    coeff_cal: np.ndarray
    beta_cal: float
    l0: float = 0.0
    m0: float = 0.0
    flux: float = 250.0       # sky-table Stokes I


def random_shapelet(rng, perturb: bool = True) -> ShapeletModel:
    """Random modes with the reference's statistics: n0 in [10, 20), beta =
    U + 0.1 capped so n0*beta ~ 2, N(0,1) coefficients attenuated by
    (outer(1..n0, 1..n0))^1.2; the perturbed twin adds 10% beta noise and
    10%-norm coefficient noise."""
    n0 = int(rng.integers(10, 20))
    beta = float(rng.random() + 0.1)
    if beta * n0 > 2:
        beta = float((2 + rng.random() * 0.001) / n0)
    x = np.arange(1, n0 + 1)
    coeff = rng.standard_normal((n0, n0)) / np.outer(x, x) ** 1.2
    if perturb:
        beta_cal = beta + 0.1 * beta * rng.random()
        noise = rng.standard_normal((n0, n0))
        noise = noise / np.linalg.norm(noise) * 0.1 * np.linalg.norm(coeff)
        coeff_cal = coeff + noise
    else:
        beta_cal, coeff_cal = beta, coeff.copy()
    return ShapeletModel(coeff=coeff.astype(np.float32), beta=beta,
                         coeff_cal=coeff_cal.astype(np.float32),
                         beta_cal=float(beta_cal))


def write_modes(path, coeff, beta, radec=(0, 0, 0.0, 0, 0, 0.0)):
    """SAGECal ``.modes`` text writer: sexagesimal position line, 'n0 beta',
    n0^2 'idx value' lines, linear-transform line."""
    coeff = np.asarray(coeff)
    n0 = coeff.shape[0]
    flat = coeff.reshape(-1)
    with open(path, "w") as fh:
        fh.write(" ".join(str(v) for v in radec) + "\n")
        fh.write(f"{n0} {beta}\n")
        for ci in range(n0 * n0):
            fh.write(f"{ci} {flat[ci]}\n")
        fh.write(f"L 1.0 1.0 {math.pi / 2}\n")
        fh.write("#model created by smartcal_tpu\n")


def read_modes(path):
    """Inverse of :func:`write_modes` -> (coeff (n0, n0), beta)."""
    with open(path) as fh:
        lines = [ln.strip() for ln in fh if ln.strip()
                 and not ln.startswith("#")]
    n0, beta = lines[1].split()
    n0, beta = int(n0), float(beta)
    vals = np.zeros(n0 * n0, np.float32)
    for ln in lines[2:2 + n0 * n0]:
        idx, v = ln.split()
        vals[int(idx)] = float(v)
    return vals.reshape(n0, n0), beta


def rescale_modes(coeff):
    """Old -> new SAGECal mode convention:
    value * ci!/(ci+1)! * cj!/(cj+1)! = value / ((ci+1)(cj+1))."""
    coeff = np.asarray(coeff)
    n0 = coeff.shape[0]
    i = np.arange(n0) + 1.0
    return coeff / np.outer(i, i)
