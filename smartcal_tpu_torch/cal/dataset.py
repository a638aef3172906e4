"""Real-observation featurization: MS files -> transformer input vector
(counterpart of smartcal_tpu/cal/dataset.py; reference
``calibration/generate_data.py:696-873``, get_info_from_dataset): extract a
time slice of an observation, calibrate it against the A-team + target
sky, compute per-direction influence, and assemble the K x (Ninf^2 + 8)
feature vector the transformer was trained on.

  extract_dataset      -> cal.ms_io.extract_dataset   (host numpy)
  sagecal-mpi          -> cal.solver.solve_admm        (device)
  analysis_uvw_perdir  -> cal.influence (perdir=True)  (device)
  excon imaging        -> cal.imager.dirty_image_sr    (kernel 1, one
                          launch per direction on the card)
  LINC target download -> a unit point source at the phase centre, or a
                          user sky/cluster file parsed by cal.skyio

:func:`assemble_features` is the single feature assembly, shared with the
synthetic training-data generator (``train.supervised``), so train-time
and eval-time features cannot drift apart.  The arithmetic after each
image is the JAX package's host numpy (Fortran-order flattening, float32
L2 normalization, the eight scalars with ``log f_0`` from the float64
frequencies).
"""

from __future__ import annotations

import math
import os
import time
from contextlib import contextmanager
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from smartcal_tpu_torch import prng, resolve_device
from smartcal_tpu_torch.cal import (coherency, coords, imager,
                                    influence as influence_mod, ms_io,
                                    observation as obs_mod, simulate, skyio,
                                    solver)

# The raw likelihood-ratio statistic is unnormalized and under strong
# sky-model mismatch reaches |LLR| ~ 1e8, enough to overflow a float32
# transformer forward; well-matched models give |LLR| <~ 1e3 (the training
# distribution), so saturating at 1e4 only affects the pathological tail.
LLR_CLIP = 1e4


@contextmanager
def timed(stage_seconds, name, device):
    """Add the seconds of the block, ended by a synchronize of the
    calling thread's stream on a CUDA ``device``, to
    ``stage_seconds[name]`` (nothing when ``stage_seconds`` is None)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if stage_seconds is not None:
            dev = torch.device(device)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            stage_seconds[name] = (stage_seconds.get(name, 0.0)
                                   + time.perf_counter() - t0)


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assemble_features(inf_vis, summary, uvw, freqs, sep, az, el, npix):
    """K x (npix^2 + 8) float32 feature vector (generate_data.py:835-858).

    Per direction ck: the Stokes-I influence visibilities ``inf_vis[ck]``
    ((K, R, 4, 2) tensor) imaged to npix^2 by the direct-DFT imager at the
    lowest frequency (the CUDA kernel for a tensor on the card),
    Fortran-flattened and L2-normalized, then [separation, azimuth,
    elevation, log||J||, log||C||, log|Inf|, LLR (clipped at
    ``LLR_CLIP``), log f_0]."""
    freqs = np.asarray(freqs)
    dev = inf_vis.device
    uvw = torch.as_tensor(_host(uvw), dtype=torch.float32,
                          device=dev).reshape(-1, 3)
    cell = imager.default_cell(uvw[None], float(freqs[0]))
    summary = type(summary)(*(_host(v) for v in summary))
    K = inf_vis.shape[0]
    nout = npix * npix + 8
    x = np.zeros(K * nout, np.float32)
    for ck in range(K):
        ivis = influence_mod.stokes_i_influence(inf_vis[ck]).contiguous()
        img = _host(imager.dirty_image_sr(uvw, ivis, float(freqs[0]), cell,
                                          npix=npix))
        flat = img.reshape(-1, order="F")
        flat = flat / max(np.linalg.norm(flat), 1e-12)
        o = ck * nout
        x[o:o + npix * npix] = flat
        x[o + npix * npix + 0] = sep[ck]
        x[o + npix * npix + 1] = az[ck]
        x[o + npix * npix + 2] = el[ck]
        x[o + npix * npix + 3] = np.log(max(float(summary.j_norm[ck]), 1e-12))
        x[o + npix * npix + 4] = np.log(max(float(summary.c_norm[ck]), 1e-12))
        x[o + npix * npix + 5] = np.log(max(float(summary.inf_mean[ck]),
                                            1e-12))
        x[o + npix * npix + 6] = float(np.clip(summary.llr_mean[ck],
                                               -LLR_CLIP, LLR_CLIP))
        x[o + npix * npix + 7] = np.log(freqs[0])
    return x


def perdir_features(residual, C, J, rho, freqs, f0, uvw, n_stations,
                    n_chunks, sep, az, el, npix, n_poly=2, polytype=0,
                    stage_seconds=None):
    """Features of one solved band-0 interval set: the consensus scalars,
    the perdir influence visibilities, their summary and
    :func:`assemble_features`.  residual (T, B, 2, 2, 2), C (K, T*B, 4,
    2) and J (Ts, K, 2N, 2, 2) of band 0; ``rho`` (K,) host; ``freqs``
    host (Nf,) float64.  ``stage_seconds`` collects "perdir_influence" and
    "features" seconds."""
    dev = C.device
    K = C.shape[0]
    with timed(stage_seconds, "perdir_influence", dev):
        hadd = influence_mod.consensus_hadd_scalars(
            np.asarray(rho, np.float32), np.full(K, 0.001, np.float32),
            freqs, f0, 0, n_poly=n_poly, polytype=polytype).to(dev)
        Rk = solver.residual_to_kernel(residual)
        inf = influence_mod.influence_visibilities(
            Rk, C, J, hadd, n_stations, n_chunks, perdir=True)
        summary = influence_mod.perdir_summary(inf.vis, inf.llr, C, J)
    with timed(stage_seconds, "features", dev):
        return assemble_features(inf.vis, summary, uvw, freqs, sep, az, el,
                                 npix=npix)


class CalSky(NamedTuple):
    """Calibration sky + per-cluster metadata for a pointing."""

    sky: object               # coherency.SkyArrays
    separations: np.ndarray   # deg, per cluster
    azimuth: np.ndarray
    elevation: np.ndarray
    rho: np.ndarray


DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data")


def ateam_paths():
    """The port's copy of the A-team catalogue (CasA/CygA/HerA/TauA/VirA,
    533 sources in 5 clusters; the reference's ``demixing/base.{sky,
    cluster,rho}`` converted through skyio)."""
    return (os.path.join(DATA_DIR, "ateam.sky"),
            os.path.join(DATA_DIR, "ateam.cluster"),
            os.path.join(DATA_DIR, "ateam.rho"))


_ATEAM_CENTER_CACHE: list = []


def _ateam_cluster_centers(K):
    """Per-cluster (ra, dec) centres of the first K-1 fixture clusters,
    from the unit-vector mean of the member directions (the role of the
    reference's ``get_cluster_centers``, generate_data.py:789).  Cached:
    the fixture is immutable."""
    if not _ATEAM_CENTER_CACHE:
        sky_p, clus_p, _ = ateam_paths()
        S = skyio.parse_sky_model(sky_p)
        clusters = skyio.parse_cluster_file(clus_p)
        for _, names in clusters:
            info = np.stack([S[nm] for nm in names])
            ra = np.asarray(coords.hms_to_rad(info[:, 0], info[:, 1],
                                              info[:, 2]))
            dec = np.asarray([coords.dms_to_rad(*row[3:6]) for row in info])
            x = np.mean(np.cos(dec) * np.cos(ra))
            y = np.mean(np.cos(dec) * np.sin(ra))
            z = np.mean(np.sin(dec))
            _ATEAM_CENTER_CACHE.append(
                (math.atan2(y, x) % (2 * math.pi),
                 math.atan2(z, math.hypot(x, y))))
    return _ATEAM_CENTER_CACHE[:K - 1]


def _direction_meta(ra, dec, ra0, dec0, lst0):
    """(separation, azimuth, elevation) in degrees of one direction."""
    sep = math.degrees(float(coords.angular_separation(ra0, dec0, ra, dec)))
    az, el = coords.azel_from_radec(ra, dec, lst0, obs_mod.LOFAR_LAT)
    return sep, math.degrees(float(az)), math.degrees(float(el))


def _ateam_fixture_sky(ra0, dec0, lst0, f0, K, rho_path=None) -> CalSky:
    """The fixture's first K-1 clusters plus a unit point source at the
    phase centre standing in for the LINC target download
    (generate_data.py:760-776)."""
    sky_p, clus_p, rho_p = ateam_paths()
    full = skyio.build_sky_arrays(sky_p, clus_p, ra0, dec0)
    keep = np.asarray(full.cluster) < K - 1
    lmn = np.concatenate([np.asarray(full.lmn)[keep], [[0.0, 0.0, 0.0]]])
    flux_coef = np.concatenate([np.asarray(full.flux_coef)[keep],
                                [[0.0, 0.0, 0.0, 0.0]]])   # log(1.0) target
    f0s = np.concatenate([np.asarray(full.f0)[keep], [f0]])
    gauss = np.concatenate([np.asarray(full.gauss)[keep], [[0.0, 0.0, 0.0]]])
    is_gauss = np.concatenate([np.asarray(full.is_gauss)[keep], [False]])
    cluster = np.concatenate([np.asarray(full.cluster)[keep], [K - 1]])
    sky = coherency.SkyArrays(lmn=lmn, flux_coef=flux_coef, f0=f0s,
                              gauss=gauss, is_gauss=is_gauss,
                              cluster=cluster, n_clusters=K)

    meta = [_direction_meta(ra, dec, ra0, dec0, lst0)
            for ra, dec in _ateam_cluster_centers(K)]
    az0, el0 = coords.azel_from_radec(ra0, dec0, lst0, obs_mod.LOFAR_LAT)
    meta.append((0.0, math.degrees(float(az0)), math.degrees(float(el0))))
    sep, azl, ell = (list(v) for v in zip(*meta))

    if rho_path is None:
        rho_spec, _ = skyio.read_rho(rho_p, 5)
        rho = np.concatenate([np.asarray(rho_spec)[:K - 1], [10.0]])
    else:
        # a user rho file may carry K rows (incl. target) or K-1
        # outlier-only rows (fixture style: target rho defaults to 10.0)
        rows = len(skyio._data_lines(rho_path))
        if rows == K:
            rho = np.asarray(skyio.read_rho(rho_path, K)[0])
        elif rows == K - 1:
            rho_spec, _ = skyio.read_rho(rho_path, K - 1)
            rho = np.concatenate([np.asarray(rho_spec), [10.0]])
        else:
            raise ValueError(
                f"rho file {rho_path} has {rows} rows; expected K={K} "
                f"(incl. target) or K-1={K - 1} (outliers only)")
    return CalSky(sky, np.asarray(sep, np.float32),
                  np.asarray(azl, np.float32),
                  np.asarray(ell, np.float32),
                  np.asarray(rho, np.float32))


def assemble_real_sky(target_skymodel, outdir, num_patches=1):
    """The reference's real-data sky assembly (generate_data.py:760-776):
    convert a user-supplied DP3/makesourcedb TARGET model and concatenate
    it after the A-team fixture, target cluster(s) last.  Returns
    ``(sky_path, cluster_path, rho_path, K)`` for
    :func:`get_info_from_dataset`, K = 5 A-team clusters + the target
    patches."""
    at_sky, at_clus, at_rho = ateam_paths()
    tmp_sky = os.path.join(outdir, "target.sky")
    tmp_clus = os.path.join(outdir, "target.cluster")
    tmp_rho = os.path.join(outdir, "target.rho")
    n_target = skyio.convert_dp3_skymodel(
        target_skymodel, tmp_sky, tmp_clus, tmp_rho, start_cluster=6,
        num_patches=num_patches)
    out = []
    for base, tmp, name in ((at_sky, tmp_sky, "sky.txt"),
                            (at_clus, tmp_clus, "cluster.txt"),
                            (at_rho, tmp_rho, "admm_rho.txt")):
        dst = os.path.join(outdir, name)
        with open(dst, "w") as fh:
            for src in (base, tmp):
                with open(src) as sf:
                    fh.write(sf.read())
        out.append(dst)
    return out[0], out[1], out[2], 5 + n_target


def calibration_sky(ra0, dec0, t0, f0, K=6, sky_path=None,
                    cluster_path=None, rho_path=None, seed=0,
                    synthetic=False) -> CalSky:
    """The calibration sky of a real pointing: the user's full model with
    ``sky_path``/``cluster_path``, else the real A-team fixture with a unit
    point source standing in for the target; ``synthetic=True`` selects
    the synthesized stand-in (K-1 random A-team-like clusters, also for
    K > 6)."""
    lst0 = obs_mod.OMEGA_EARTH * t0 % (2 * math.pi)
    if (sky_path is None) != (cluster_path is None):
        raise ValueError(
            "sky_path and cluster_path must be given together — with only "
            "one, the synthetic stand-in sky would silently replace the "
            "user's model")
    if sky_path is not None and cluster_path is not None:
        sky = skyio.build_sky_arrays(sky_path, cluster_path, ra0, dec0)
        Kf = sky.n_clusters
        lmn, cl = np.asarray(sky.lmn), np.asarray(sky.cluster)
        fc = np.asarray(sky.flux_coef)
        meta, flux = [], []
        for ci in range(Kf):
            sel = cl == ci
            l = float(np.mean(lmn[sel, 0]))
            m = float(np.mean(lmn[sel, 1]))
            ra, dec = (float(v) for v in coords.lmtoradec(l, m, ra0, dec0))
            meta.append(_direction_meta(ra, dec, ra0, dec0, lst0))
            flux.append(float(np.sum(np.exp(fc[sel, 0]))))
        sep, azl, ell = (list(v) for v in zip(*meta))
        if rho_path is not None:
            rho = skyio.read_rho(rho_path, Kf)[0]    # spectral column
        else:
            rho = 0.1 * np.asarray(flux, np.float32)
        return CalSky(sky, np.asarray(sep, np.float32),
                      np.asarray(azl, np.float32),
                      np.asarray(ell, np.float32),
                      np.asarray(rho, np.float32))

    n_ateam = K - 1
    if (not synthetic and n_ateam <= 5
            and os.path.exists(ateam_paths()[0])):
        return _ateam_fixture_sky(ra0, dec0, lst0, f0, K, rho_path=rho_path)

    if n_ateam > len(obs_mod.ATEAM_DIRS):
        raise ValueError(f"K={K} exceeds the {len(obs_mod.ATEAM_DIRS)}"
                         " A-team clusters of the fallback sky")
    at = simulate.ateam_components(prng.PRNGKey(seed), ra0, dec0, f0)
    draw = simulate.SkyDraw()
    meta, rho = [], []
    for i in range(n_ateam):
        ra, dec = obs_mod.ATEAM_DIRS[i]
        meta.append(_direction_meta(ra, dec, ra0, dec0, lst0))
        el = float(coords.azel_from_radec(ra, dec, lst0,
                                          obs_mod.LOFAR_LAT)[1])
        atten = 0.05 + 0.95 * max(0.0, math.sin(max(el, 0.0))) ** 2
        draw.add(at.l[i], at.m[i], at.flux[i] * atten, at.sp[i], i)
        rho.append(obs_mod.ATEAM_FLUX[i] * atten * 0.1)
    # target: single point source at the phase center, unit apparent flux
    draw.add(np.zeros(1), np.zeros(1), np.ones(1), np.zeros(1), K - 1)
    az0, el0 = coords.azel_from_radec(ra0, dec0, lst0, obs_mod.LOFAR_LAT)
    meta.append((0.0, math.degrees(float(az0)), math.degrees(float(el0))))
    rho.append(10.0)
    sep, azl, ell = (list(v) for v in zip(*meta))
    return CalSky(draw.build(K, f0), np.asarray(sep, np.float32),
                  np.asarray(azl, np.float32), np.asarray(ell, np.float32),
                  np.asarray(rho, np.float32))


def _read_vis_sr(path, colname, B, n_times):
    """MS column -> ((T, B, 2, 2, 2) split-real, (T, B, 3) uvw)."""
    uu, vv, ww, xx, xy, yx, yy = ms_io.read_corr(path, colname)
    V = np.stack([xx, xy, yx, yy], axis=-1).reshape(-1, B, 2, 2)
    uvw = np.stack([uu, vv, ww], axis=-1).reshape(-1, B, 3)
    V_sr = np.stack([V.real, V.imag], axis=-1).astype(np.float32)
    return V_sr[:n_times], uvw[:n_times]


def get_info_from_dataset(mslist: List[str], timesec: float, Ninf: int = 64,
                          K: int = 6, Nf: int = 3, tdelta: int = 10,
                          sky_path: Optional[str] = None,
                          cluster_path: Optional[str] = None,
                          rho_path: Optional[str] = None,
                          n_poly: int = 2, admm_iters: int = 10,
                          lbfgs_iters: int = 8, init_iters: int = 30,
                          rng=None, workdir: str = ".",
                          synthetic: bool = False, device="cuda",
                          stage_seconds: Optional[dict] = None):
    """Featurize a ``timesec``-second slice of a real (or MS-shaped
    synthetic) observation for the demixing recommender: the K x (Ninf^2 +
    8) float32 vector of generate_data.py:835-858.  The MSs may be
    casacore MSs (with python-casacore) or sct/npz stores.  The solve,
    influence and images run on ``device`` (default "cuda": raises
    without a GPU).  ``stage_seconds`` collects "extract", "sky",
    "solve", "perdir_influence" and "features" seconds."""
    dev = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    with timed(stage_seconds, "extract", dev):
        sub = ms_io.extract_dataset(mslist, timesec, Nf=Nf, rng=rng,
                                    outdir=workdir)
        # normalize the data to unit RMS (generate_data.py:710-721 scales
        # by sqrt(norm/size), which is not scale-free; norm/sqrt(size) is)
        _, _, _, xx, xy, yx, yy = ms_io.read_corr(sub[0], "DATA")
        d = np.stack([xx, xy, yx, yy])
        scalefac = float(np.linalg.norm(d) / np.sqrt(d.size))
        for ms in sub:
            u1, v1, w1, *corr = ms_io.read_corr(ms, "DATA")
            ms_io.write_corr(ms, *(c / scalefac for c in corr),
                             colname="DATA")

        info = ms_io.ms_info(sub[0])
        N, B = info.n_stations, info.n_baselines
        Ts = max(1, info.n_times // tdelta)
        n_times = Ts * tdelta
        if info.n_times < tdelta:
            # fewer slots than one solution interval: shrink the interval
            tdelta, Ts, n_times = info.n_times, 1, info.n_times
        freqs = np.asarray([ms_io.ms_info(ms).freqs[0] for ms in sub],
                           np.float64)
        f0 = float(freqs.mean())
        V_list, uvw = [], None
        for ms in sub:
            V_sr, uvw_ms = _read_vis_sr(ms, "DATA", B, n_times)
            V_list.append(V_sr)
            uvw = uvw_ms if uvw is None else uvw

    with timed(stage_seconds, "sky", dev):
        cal = calibration_sky(info.ra0, info.dec0, info.t0, f0, K=K,
                              sky_path=sky_path, cluster_path=cluster_path,
                              rho_path=rho_path, synthetic=synthetic)
        if cal.sky.n_clusters != K:
            # a user cluster file must match the trained model's K
            raise ValueError(
                f"cluster file defines {cal.sky.n_clusters} directions but "
                f"the model/featurization expects K={K}")
        V = torch.as_tensor(np.stack(V_list), device=dev)  # (Nf,T,B,2,2,2)
        uvw_t = torch.as_tensor(uvw.reshape(-1, 3).astype(np.float32),
                                device=dev)
        Ccal = torch.stack([
            coherency.predict_coherencies_sr(
                uvw_t[:, 0], uvw_t[:, 1], uvw_t[:, 2], cal.sky, float(f))
            for f in freqs])

        # match the model scale to the (unit-RMS) data before solving: the
        # catalogue fluxes predict ~1e3-1e4 against O(1) data, and the
        # chi2-init L-BFGS from J=I would overflow float32; one global
        # factor keeps the relative fluxes, and rho (flux-proportional)
        # rides along
        m_rms = float(torch.sqrt(torch.mean(torch.sum(
            Ccal.sum(dim=1) ** 2, dim=-1))))
        v_rms = float(torch.sqrt(torch.mean(torch.sum(V ** 2, dim=-1))))
        scale = v_rms / max(m_rms, 1e-12)
        Ccal = Ccal * scale
        rho = cal.rho * scale

    with timed(stage_seconds, "solve", dev):
        cfg = solver.SolverConfig(n_stations=N, n_dirs=K, n_poly=n_poly,
                                  admm_iters=admm_iters,
                                  lbfgs_iters=lbfgs_iters,
                                  init_iters=init_iters, polytype=0)
        res = solver.solve_admm(
            V, Ccal, torch.as_tensor(freqs, dtype=torch.float32, device=dev),
            f0, torch.as_tensor(np.asarray(rho, np.float32), device=dev),
            cfg, n_chunks=Ts)
    return perdir_features(res.residual[0], Ccal[0], res.J[0], rho, freqs,
                           f0, uvw, N, Ts, cal.separations, cal.azimuth,
                           cal.elevation, npix=Ninf, n_poly=n_poly,
                           polytype=0, stage_seconds=stage_seconds)
