"""Synthetic sky models + systematic-error Jones solutions (counterpart of
smartcal_tpu/cal/simulate.py): the calibration sky (with its optional
diffuse shapelet component) and the demixing sky (A-team outliers, the
target field, a weak background).

All draws are host numpy from Generators seeded like the JAX package's
(``observation.host_rng`` with the same salts), so the same key gives
bit-identical skies and solutions.  The coordinate math of the demixing
sky is float32 (``cal/coords``), as in the JAX package.  The noise is
drawn on the host too: ``add_noise_device`` scales and adds it on the
device (the vectorized episode build), ``add_noise`` in host numpy (the
host-loop build, ``RadioBackend(vectorized=False)``), from the same
stream.  ``write_dp3_parsets`` writes the JAX package's DP3 parsets byte
for byte.
"""

import math
import os
from typing import NamedTuple

import numpy as np
import torch

from smartcal_tpu_torch.cal import coords
from smartcal_tpu_torch.cal import observation as obs_mod
from smartcal_tpu_torch.cal.coherency import SkyArrays
from smartcal_tpu_torch.cal.shapelets import random_shapelet

TWO_PI = 2.0 * math.pi


def _rng_of(key, salt=0):
    return obs_mod.host_rng(key, salt)


def _powerlaw_flux(rng, n, a, b, alpha=-2.0):
    """Fluxes with dN/dS ~ S^alpha in [a, b]."""
    nn = rng.random(n)
    ap, bp = a ** (alpha + 1), b ** (alpha + 1)
    return (ap + nn * (bp - ap)) ** (1.0 / (alpha + 1))


class SkyDraw:
    """Accumulator for struct-of-arrays sky construction."""

    def __init__(self):
        self.l, self.m, self.flux, self.sp = [], [], [], []
        self.gauss, self.is_gauss, self.cluster = [], [], []

    def add(self, l, m, flux, sp, cluster, gauss=None):
        l, m, flux = map(np.atleast_1d, (l, m, flux))
        n = l.shape[0]
        sp = np.broadcast_to(np.atleast_1d(sp), (n,))
        self.l.append(l)
        self.m.append(m)
        self.flux.append(flux)
        self.sp.append(sp)
        if gauss is None:
            self.gauss.append(np.zeros((n, 3)))
            self.is_gauss.append(np.zeros(n, bool))
        else:
            self.gauss.append(np.broadcast_to(gauss, (n, 3)))
            self.is_gauss.append(np.ones(n, bool))
        self.cluster.append(np.full(n, cluster, np.int32))

    def build(self, n_clusters, f0):
        l = np.concatenate(self.l)
        m = np.concatenate(self.m)
        n = np.sqrt(np.maximum(1.0 - l * l - m * m, 0.0)) - 1.0
        flux = np.concatenate(self.flux)
        sp = np.concatenate(self.sp)
        fc = np.stack([np.log(np.maximum(flux, 1e-12)), sp,
                       np.zeros_like(sp), np.zeros_like(sp)], axis=-1)
        return SkyArrays(
            lmn=np.stack([l, m, n], axis=-1), flux_coef=fc,
            f0=np.full_like(flux, f0), gauss=np.concatenate(self.gauss),
            is_gauss=np.concatenate(self.is_gauss),
            cluster=np.concatenate(self.cluster), n_clusters=n_clusters)


class CalibModels(NamedTuple):
    """Output of :func:`simulate_models`.

    sky_sim   : SkyArrays, K+1 clusters (K calibrated + weak background)
    sky_cal   : SkyArrays, K clusters (outlier fluxes /100)
    sky_table : (K, 5) float32 rows [cluster_id, l, m, sI, sP]
    rho       : (K,) spectral ADMM rho (analytic, flux-proportional)
    rho_spatial : (K,) spatial ADMM rho
    lm_dirs   : (K, 2) cluster-center direction cosines
    f0        : reference frequency (Hz)
    shapelet  : the diffuse component of cluster 0 (a
                ``shapelets.ShapeletModel``), or None
    """

    sky_sim: SkyArrays
    sky_cal: SkyArrays
    sky_table: np.ndarray
    rho: np.ndarray
    rho_spatial: np.ndarray
    lm_dirs: np.ndarray
    f0: float
    shapelet: object = None


def simulate_models(key, K=4, f0=150e6, Kc=80, M_weak=350, M_gauss=120,
                    M2=40, diffuse=False) -> CalibModels:
    """Random calibration sky: Kc-source center cluster, K-1 compact outlier
    clusters of M2 sources, M_weak point + M_gauss Gaussian background
    sources (reference calibration/simulate.py:61-379).  ``diffuse=True``
    draws a random shapelet component for the phase centre last: its exact
    modes enter the simulated data, its perturbed twin the calibration
    model (``RadioBackend._add_shapelet``)."""
    rng = _rng_of(key, salt=1)
    sim, cal = SkyDraw(), SkyDraw()
    table, lm_dirs = [], []

    # center cluster (id 0 here; the reference writes id 1)
    lmin = 0.9
    l = (rng.random(Kc) - 0.5) * lmin
    m = (rng.random(Kc) - 0.5) * lmin
    sI = ((rng.random(Kc) * 90) + 10) / 10
    sI = sI / sI.min() * 0.03
    sP = rng.standard_normal(Kc)
    sim.add(l, m, sI, sP, 0)
    cal.add(l, m, sI, sP, 0)
    table.append([1, l.mean(), m.mean(), sI.mean(), sP.mean()])
    lm_dirs.append([l.mean(), m.mean()])
    rho = [sI.sum() * 100.0]

    # outlier clusters: compact (1e-3 rad) M2-source clumps; the
    # calibration sky divides fluxes by 100 (beam attenuation stand-in)
    lo = (rng.random(K - 1) - 0.5) * 0.7
    mo = (rng.random(K - 1) - 0.5) * 0.7
    sIo = ((rng.random(K - 1) * 900) + 100) / 10
    sIo = sIo / sIo.min() * 250.0
    sPo = rng.standard_normal(K - 1)
    for cj in range(K - 1):
        l2 = lo[cj] + (rng.random(M2) - 0.5) * 1e-3
        m2 = mo[cj] + (rng.random(M2) - 0.5) * 1e-3
        sI2 = rng.random(M2)
        sI2 = sI2 / sI2.sum() * sIo[cj]
        sim.add(l2, m2, sI2, sPo[cj], cj + 1)
        cal.add(l2, m2, sI2 / 100.0, sPo[cj], cj + 1)
        table.append([cj + 2, lo[cj], mo[cj], (sI2 / 100).mean(), sPo[cj]])
        lm_dirs.append([lo[cj], mo[cj]])
        rho.append(sI2.sum() / 1000.0 * 100.0)

    # weak background point sources, FOV ~16 deg (sim sky only, cluster K)
    sII = _powerlaw_flux(rng, M_weak, 0.01, 0.5)
    l0 = (rng.random(M_weak) - 0.5) * 15.5 * math.pi / 180
    m0 = (rng.random(M_weak) - 0.5) * 15.5 * math.pi / 180
    sim.add(l0, m0, sII, 0.0, K)

    # extended (Gaussian) background sources
    sI1 = _powerlaw_flux(rng, M_gauss, 0.01, 0.5)
    l1 = (rng.random(M_gauss) - 0.5) * 15.5 * math.pi / 180
    m1 = (rng.random(M_gauss) - 0.5) * 15.5 * math.pi / 180
    for i in range(M_gauss):
        g = np.asarray([(rng.random() - 0.5) * 0.5 * math.pi / 180,
                        (rng.random() - 0.5) * 0.5 * math.pi / 180,
                        (rng.random() - 0.5) * math.pi])
        sim.add(l1[i], m1[i], sI1[i], 0.0, K, gauss=g)

    return CalibModels(
        sky_sim=sim.build(K + 1, f0), sky_cal=cal.build(K, f0),
        sky_table=np.asarray(table, np.float32),
        rho=np.asarray(rho, np.float32),
        rho_spatial=np.full(K, 0.1, np.float32),
        lm_dirs=np.asarray(lm_dirs, np.float32), f0=float(f0),
        shapelet=random_shapelet(rng) if diffuse else None)


class DemixModels(NamedTuple):
    """Output of :func:`simulate_demixing_sky`.  Cluster order: 0..K-2 the
    A-team outliers, K-1 the target; the sim-only weak and Gaussian
    background is cluster K.

    separations / azimuth / elevation: per calibrated cluster, in degrees
    (float32 math, as in the JAX package)
    fluxes: apparent flux sum per calibrated cluster
    """

    sky_sim: SkyArrays
    sky_cal: SkyArrays
    rho: np.ndarray
    separations: np.ndarray
    azimuth: np.ndarray
    elevation: np.ndarray
    fluxes: np.ndarray
    lm_dirs: np.ndarray
    f0: float


def ateam_components(key, ra0, dec0, f0, n_comp=30):
    """Synthetic A-team clusters: for each of the 5 sources, ``n_comp``
    components scattered within ~0.3 deg of the true position, total flux
    at the catalog scale (a stand-in for the reference's checked-in
    base.sky/base.cluster models)."""
    rng = _rng_of(key, salt=2)
    comp = SkyDraw()
    for i, (ra, dec) in enumerate(obs_mod.ATEAM_DIRS):
        l, m, _ = coords.radectolm(ra, dec, ra0, dec0)
        l, m = float(l), float(m)
        dl = (rng.random(n_comp) - 0.5) * 0.01
        dm = (rng.random(n_comp) - 0.5) * 0.01
        w = rng.random(n_comp)
        flux = w / w.sum() * obs_mod.ATEAM_FLUX[i]
        sp = np.full(n_comp, -0.7) + 0.1 * rng.standard_normal(n_comp)
        comp.add(l + dl, m + dm, flux, sp, i)
    return comp


def simulate_demixing_sky(key, ra0, dec0, t0, f0, K=6, Kc=40, M_weak=350,
                          M_gauss=120) -> DemixModels:
    """Target field + A-team sky of the demixing episodes (reference
    generate_data.py:1004-1140): Kc target sources (power-law fluxes in
    [0.1, 200]), a weak + Gaussian background in a 25.5-deg FOV, and the
    A-team clusters.  The A-team apparent fluxes (sim and cal skies, and
    the analytic rho) are scaled by a smooth function of elevation, the
    role of the reference's beam.  (The JAX function's ``beam_atten=False``
    arm, catalog fluxes, has no caller and is not ported.)"""
    rng = _rng_of(key, salt=3)
    n_ateam = K - 1
    lst0 = obs_mod.OMEGA_EARTH * t0 % TWO_PI

    # A-team outlier clusters 0..K-2
    at = ateam_components(key, ra0, dec0, f0)
    sim, cal = SkyDraw(), SkyDraw()
    sep, azl, ell, fluxes, lm_dirs = [], [], [], [], []
    atten = []
    for i in range(n_ateam):
        ra, dec = obs_mod.ATEAM_DIRS[i]
        s = float(coords.angular_separation(ra0, dec0, ra, dec))
        az, el = coords.azel_from_radec(ra, dec, lst0, obs_mod.LOFAR_LAT)
        sep.append(math.degrees(s))
        azl.append(math.degrees(float(az)))
        ell.append(math.degrees(float(el)))
        # sources below the horizon are strongly suppressed
        a = 0.05 + 0.95 * max(0.0, math.sin(max(float(el), 0.0))) ** 2
        atten.append(a)
        l_i, m_i = at.l[i], at.m[i]
        f_i = at.flux[i] * a
        sim.add(l_i, m_i, f_i, at.sp[i], i)
        cal.add(l_i, m_i, f_i, at.sp[i], i)
        fluxes.append(float(np.sum(f_i)))
        lm_dirs.append([float(np.mean(l_i)), float(np.mean(m_i))])

    # target cluster K-1 at the phase centre
    l = (rng.random(Kc) - 0.5) * 0.2
    m = (rng.random(Kc) - 0.5) * 0.2
    sI = _powerlaw_flux(rng, Kc, 0.1, 200.0)
    sP = rng.standard_normal(Kc)
    sim.add(l, m, sI, sP, K - 1)
    cal.add(l, m, sI, sP, K - 1)
    az0, el0 = coords.azel_from_radec(ra0, dec0, lst0, obs_mod.LOFAR_LAT)
    sep.append(0.0)
    azl.append(math.degrees(float(az0)))
    ell.append(math.degrees(float(el0)))
    fluxes.append(float(sI.sum()))
    lm_dirs.append([float(l.mean()), float(m.mean())])

    # weak + Gaussian background (sim only, cluster K), 25.5-deg FOV
    sII = _powerlaw_flux(rng, M_weak, 0.01, 0.5)
    l0 = (rng.random(M_weak) - 0.5) * 25.5 * math.pi / 180
    m0 = (rng.random(M_weak) - 0.5) * 25.5 * math.pi / 180
    sim.add(l0, m0, sII, 0.0, K)
    sI1 = _powerlaw_flux(rng, M_gauss, 0.01, 0.5)
    l1 = (rng.random(M_gauss) - 0.5) * 25.5 * math.pi / 180
    m1 = (rng.random(M_gauss) - 0.5) * 25.5 * math.pi / 180
    for i in range(M_gauss):
        g = np.asarray([(rng.random() - 0.5) * 0.5 * math.pi / 180,
                        (rng.random() - 0.5) * 0.5 * math.pi / 180,
                        (rng.random() - 0.5) * math.pi])
        sim.add(l1[i], m1[i], sI1[i], 0.0, K, gauss=g)

    # analytic rho: A-team at catalog scale x attenuation, target
    # sum(sI)*10/Kc (generate_data.py:1077)
    rho = np.asarray(
        [obs_mod.ATEAM_FLUX[i] * atten[i] * 0.1 for i in range(n_ateam)]
        + [sI.sum() * 10.0 / Kc], np.float32)

    return DemixModels(
        sky_sim=sim.build(K + 1, f0), sky_cal=cal.build(K, f0),
        rho=rho, separations=np.asarray(sep, np.float32),
        azimuth=np.asarray(azl, np.float32),
        elevation=np.asarray(ell, np.float32),
        fluxes=np.asarray(fluxes, np.float32),
        lm_dirs=np.asarray(lm_dirs, np.float32), f0=float(f0))


def write_dp3_parsets(outdir, sourcedb="sky_bbs.txt", tdelta=10):
    """DP3 parsets for external cross-checks of the same data (reference
    simulate.py:142-188: demix / ddecal / predict-subtract steps, L-BFGS
    settings matching the in-framework solver's).  Text only: DP3 is an
    external tool.  Returns the three paths."""
    def w(name, step, opts):
        with open(os.path.join(outdir, name), "w") as fh:
            fh.write(f"steps=[{step}]\n")
            for k, v in opts.items():
                fh.write(f"{step}.{k}={v}\n")

    w("test_demix.parset", "demix", {
        "type": "demixer", "blrange": "[60,100000]",
        "demixtimestep": tdelta, "demixfreqstep": 16, "ntimechunk": 4,
        "uselbfgssolver": "true", "lbfgs.historysize": 10, "maxiter": 30,
        "lbfgs.robustdof": 200})
    w("test_ddecal.parset", "ddecal", {
        "type": "ddecal", "h5parm": "./solutions.h5",
        "sourcedb": sourcedb, "mode": "fulljones", "uvlambdamin": 30,
        "usebeammodel": "true", "beamproximitylimit": 0.1,
        "solveralgorithm": "lbfgs", "solverlbfgs.dof": 200.0,
        "solverlbfgs.iter": 4, "solverlbfgs.minibatches": 3,
        "solverlbfgs.history": 10, "maxiter": 50,
        "smoothnessconstraint": 1e6, "nchan": 16, "stepsize": 1e-3,
        "solint": tdelta})
    w("test_predict.parset", "predict", {
        "type": "h5parmpredict", "sourcedb": sourcedb,
        "usebeammodel": "true", "applycal.correction": "fulljones",
        "applycal.parmdb": "./solutions.h5", "operation": "subtract"})
    return [os.path.join(outdir, n) for n in
            ("test_demix.parset", "test_ddecal.parset",
             "test_predict.parset")]


def synth_solutions(key, K, n_stations, Ts, freqs, f0, amp=1.0,
                    spatial_term=False, spalpha=0.95, lm_dirs=None):
    """Synthetic per-direction systematic errors J: (Nf, Ts, K, 2N, 2, 2)
    split-real float32 numpy (reference simulate.py:386-435)."""
    rng = _rng_of(key, salt=4)
    N8 = 8 * n_stations
    freqs = np.asarray(freqs, np.float64)
    ff = (freqs - f0) / f0                                  # (Nf,)
    Nf = ff.shape[0]

    if spatial_term:
        a0, a1, a2 = rng.standard_normal((3, N8))
        a0, a1, a2 = (v / np.linalg.norm(v) for v in (a0, a1, a2))
        lm = np.asarray(lm_dirs)                            # (K, 2)
        base = np.empty((K, N8))
        for ck in range(K):
            rp = rng.standard_normal(N8)
            b = ((1 - spalpha) * rp / np.linalg.norm(rp)
                 + spalpha * (a0 * lm[ck, 0] + a1 * lm[ck, 1] + a2))
            base[ck] = b / np.linalg.norm(b)
    else:
        base = rng.standard_normal((K, N8)) * amp
    base[:, 0::8] += 1.0
    base[:, 6::8] += 1.0

    # random quadratic frequency polynomial per (k, value)
    beta = rng.standard_normal((K, N8, 3))
    freqpol = (beta[..., 0:1] + beta[..., 1:2] * ff[None, None, :]
               + beta[..., 2:3] * ff[None, None, :] ** 2)   # (K, N8, Nf)
    gs = base[:, :, None] * freqpol

    # random cosine time modulation per (k, value), shared across freq
    tr = np.arange(Ts) / Ts
    tb = rng.standard_normal((K, N8, 4))
    tb = tb / np.linalg.norm(tb, axis=-1, keepdims=True)
    timepol = (1.0 + tb[..., 0:1]
               + tb[..., 1:2] * np.cos(tr[None, None, :] * tb[..., 2:3]
                                       + tb[..., 3:4]))     # (K, N8, Ts)

    full = gs[:, :, None, :] * timepol[..., None]           # (K, N8, Ts, Nf)
    full = full.reshape(K, n_stations, 2, 2, 2, Ts, Nf)
    J = np.transpose(full, (6, 5, 0, 1, 2, 3, 4))           # (Nf,Ts,K,N,2,2,2)
    J = J.reshape(Nf, Ts, K, 2 * n_stations, 2, 2)
    return J.astype(np.float32)


def identity_solutions(K, n_stations, Ts, Nf):
    """J = I for every direction/station."""
    J = np.zeros((Nf, Ts, K, 2 * n_stations, 2, 2), np.float32)
    eye = np.eye(2, dtype=np.float32)
    for p in range(n_stations):
        J[:, :, :, 2 * p:2 * p + 2, :, 0] = eye
    return J


def add_noise(key, V, snr):
    """AWGN scaled so ||noise|| = snr * ||signal|| (reference
    addnoise.py:7-17), in host numpy on a split-real numpy ``V``: the JAX
    package's ``add_noise``, the same stream as :func:`add_noise_device`.
    Returns (V + scaled noise, scale)."""
    rng = _rng_of(key, salt=5)
    noise = rng.standard_normal(V.shape).astype(np.float32)
    noise -= noise.mean()
    scale = snr * np.linalg.norm(V) / max(np.linalg.norm(noise), 1e-30)
    return V + noise * scale, float(scale)


def add_noise_device(key, V, snr):
    """AWGN scaled so ||noise|| = snr * ||signal|| (reference
    addnoise.py:7-17).  The draw is the host Generator's (the JAX
    package's byte-identical stream); norms, scale and add run on V's
    device.  Returns (V + scaled noise, scale)."""
    rng = _rng_of(key, salt=5)
    noise = rng.standard_normal(tuple(V.shape)).astype(np.float32)
    noise -= noise.mean()
    noise = torch.as_tensor(noise, device=V.device)
    nv = torch.sqrt(torch.sum(V * V))
    nn = torch.sqrt(torch.sum(noise * noise))
    scale = snr * nv / torch.clamp(nn, min=1e-30)
    return V + noise * scale, scale
