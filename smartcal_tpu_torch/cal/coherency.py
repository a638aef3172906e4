"""Sky -> visibility coherency prediction (counterpart of
smartcal_tpu/cal/coherency.py): point and Gaussian sources, with the
optional bandwidth smearing |sinc(phase fdelta / (2 f))| (``smear``,
``fdelta``).  The diffuse shapelet component is ``cal/shapelets.py``.

Per band the sky is a struct-of-arrays over S sources and the prediction
is one (S, R) phase/amplitude pass followed by a per-cluster sum, done as
a one-hot (K, S) @ (S, R) matmul so the reduction order is fixed (a
scatter-add would use atomics on the GPU).
"""

import math

import numpy as np
import torch

from smartcal_tpu_torch.cal import creal

C_LIGHT = 2.99792458e8
F32 = torch.float32


class SkyArrays:
    """Struct-of-arrays sky model (host-built, float32 CPU tensors).

      lmn       (S, 3) direction cosines (l, m, n-1) about the phase center
      flux_coef (S, 4) [log sI at f0, sp1, sp2, sp3] spectral log-polynomial
      f0        (S,)   reference frequency per source
      gauss     (S, 3) [major, minor, pa]; zeros for point sources
      is_gauss  (S,)   bool
      cluster   (S,)   cluster id in [0, K)
    """

    def __init__(self, lmn, flux_coef, f0, gauss, is_gauss, cluster,
                 n_clusters):
        self.lmn = torch.as_tensor(np.asarray(lmn), dtype=F32)
        self.flux_coef = torch.as_tensor(np.asarray(flux_coef), dtype=F32)
        self.f0 = torch.as_tensor(np.asarray(f0), dtype=F32)
        self.gauss = torch.as_tensor(np.asarray(gauss), dtype=F32)
        self.is_gauss = torch.as_tensor(np.asarray(is_gauss), dtype=torch.bool)
        self.cluster = torch.as_tensor(np.asarray(cluster), dtype=torch.long)
        self.n_clusters = int(n_clusters)

    def to(self, device):
        """The same sky with every array on ``device``."""
        out = object.__new__(SkyArrays)
        for name in ("lmn", "flux_coef", "f0", "gauss", "is_gauss",
                     "cluster"):
            setattr(out, name, getattr(self, name).to(device))
        out.n_clusters = self.n_clusters
        return out


def _predict(uvw_scaled, sky: SkyArrays, freq, smear=False,
             fdelta_over_freq=None):
    """One band: uvw_scaled (R, 3) already multiplied by 2 pi f / c; freq a
    0-d float32 tensor; ``fdelta_over_freq`` a 0-d float32 tensor when
    ``smear``.  Returns split-real C (K, R, 4, 2)."""
    uu, vv, ww = uvw_scaled[:, 0], uvw_scaled[:, 1], uvw_scaled[:, 2]
    lmn, fc, gauss = sky.lmn, sky.flux_coef, sky.gauss
    l, m, n = lmn[:, 0], lmn[:, 1], lmn[:, 2]

    # spectral power law: sI = exp(log sI0 + sp1*fr + sp2*fr^2 + sp3*fr^3)
    fr = torch.log(freq / sky.f0)                          # (S,)
    log_si = (fc[:, 0] + fc[:, 1] * fr + fc[:, 2] * fr ** 2
              + fc[:, 3] * fr ** 3)
    si = torch.exp(log_si)

    phase = (l[:, None] * uu[None, :] + m[:, None] * vv[None, :]
             + n[:, None] * ww[None, :])                   # (S, R)
    amp = si[:, None]

    if smear:
        # bandwidth smearing, numpy's normalization sinc(x) =
        # sin(pi x) / (pi x), as in the JAX package
        amp = amp * torch.abs(torch.sinc(
            phase * 0.5 * fdelta_over_freq / math.pi))

    # Gaussian envelope, with the reference's quirk of taking acos of the
    # n-EXCESS (see the JAX twin) kept for parity
    phi = -torch.arccos(torch.clamp(n, -1.0, 1.0))
    xi = -torch.atan2(-l, m)
    cxi, sxi = torch.cos(xi), torch.sin(xi)
    cphi, sphi = torch.cos(phi), torch.sin(phi)
    eX = 2.0 * gauss[:, 0]
    eY = 2.0 * gauss[:, 1]
    cpa, spa = torch.cos(gauss[:, 2]), torch.sin(gauss[:, 2])
    uup = (cxi[:, None] * uu[None, :] - (cphi * sxi)[:, None] * vv[None, :]
           + (sphi * sxi)[:, None] * ww[None, :])
    vvp = (sxi[:, None] * uu[None, :] + (cphi * cxi)[:, None] * vv[None, :]
           - (sphi * cxi)[:, None] * ww[None, :])
    uut = eX[:, None] * (cpa[:, None] * uup - spa[:, None] * vvp)
    vvt = eY[:, None] * (spa[:, None] * uup + cpa[:, None] * vvp)
    envelope = 0.5 * math.pi * torch.exp(-(uut * uut + vvt * vvt))
    amp = amp * torch.where(sky.is_gauss[:, None], envelope,
                            torch.ones_like(envelope))

    onehot = (sky.cluster[None, :] == torch.arange(
        sky.n_clusters, device=l.device)[:, None]).to(F32)  # (K, S)
    re = onehot @ (amp * torch.cos(phase))                 # (K, R)
    im = onehot @ (amp * torch.sin(phase))
    per_cluster = torch.stack([re, im], dim=-1)            # (K, R, 2)
    zero = torch.zeros_like(per_cluster)
    return torch.stack([per_cluster, zero, zero, per_cluster], dim=2)


def _host_freq(freq):
    """A frequency as a host scalar: a tensor becomes a numpy scalar of its
    dtype, anything else is left as it is."""
    if torch.is_tensor(freq):
        return freq.detach().cpu().numpy()[()]
    return freq


def predict_coherencies_multi_sr(uu, vv, ww, sky: SkyArrays, freqs,
                                 smear=False, fdelta=180e3):
    """Split-real coherencies for every sub-band: (Nf, K, R, 4, 2) on the
    device of ``uu``.  XX = YY = sum over cluster sources of
    sI(f) exp(i(ul + vm + wn)) [* smearing * Gaussian envelope]; XY = YX
    = 0.

    The per-band uvw scale factors are computed on the host in float32,
    as the JAX package computes them, so the (large, f32-wrapped) DFT
    phases agree with the reference's; fdelta / f is taken in float64 and
    rounded once (JAX ``predict_coherencies_multi_sr``)."""
    freqs = _host_freq(freqs)
    freqs32 = np.asarray(freqs, np.float32)
    scales = 2.0 * np.pi * freqs32 / C_LIGHT               # float32
    fofs = (fdelta / np.asarray(freqs, np.float64)).astype(np.float32)
    dev = uu.device
    sky = sky.to(dev)
    uvw = torch.stack([uu, vv, ww], dim=-1).to(F32)
    out = []
    for f, s, fof in zip(freqs32, scales, fofs):
        us = uvw * torch.tensor(s, dtype=F32, device=dev)
        fof = torch.tensor(fof, dtype=F32, device=dev) if smear else None
        out.append(_predict(us, sky, torch.tensor(f, dtype=F32, device=dev),
                            smear=smear, fdelta_over_freq=fof))
    return torch.stack(out)


def predict_coherencies_sr(uu, vv, ww, sky: SkyArrays, freq, smear=False,
                           fdelta=180e3):
    """Split-real coherencies (K, R, 4, 2) of one band at ``freq`` (Hz),
    on the device of ``uu``: the JAX package's single-band wrapper.  Its
    uvw scale 2 pi f / c is numpy arithmetic on ``freq`` as given: a Python
    float is taken in float64 and rounded to float32 once, a numpy
    float32 (a band of ``obs.freqs``) in float32, which is the multi-band
    form's value (the large A-team phases see the difference)."""
    dev = uu.device
    freq = _host_freq(freq)
    scale = np.float32(2.0 * np.pi * freq / C_LIGHT)
    uvw = torch.stack([uu, vv, ww], dim=-1).to(F32)
    us = uvw * torch.tensor(scale, dtype=F32, device=dev)
    # fdelta / f with the JAX wrapper's host arithmetic on ``freq``
    fof = (torch.tensor(np.float32(fdelta / freq), dtype=F32, device=dev)
           if smear else None)
    return _predict(us, sky.to(dev),
                    torch.tensor(np.float32(freq), dtype=F32, device=dev),
                    smear=smear, fdelta_over_freq=fof)


def predict_coherencies(uu, vv, ww, sky: SkyArrays, freq, smear=False,
                        fdelta=180e3):
    """Complex host-edge wrapper: C (K, R, 4) numpy complex64."""
    return creal.fuse(predict_coherencies_sr(uu, vv, ww, sky, freq,
                                             smear=smear, fdelta=fdelta))
