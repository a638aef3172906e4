"""Episode backend of the calibration environment (counterpart of
smartcal_tpu/envs/radio.py): simulate an observation, calibrate it, map
its influence, and image the data and the residual.

Direction selection is a MASK over a fixed M-direction coherency tensor,
as in the JAX package.  Routes: the JAX backend picks among sharded,
host-segmented, fused and vectorized routes by device count and problem
size (radio.py:508-566, 745-795).  On one GPU this port keeps one route
each, with the same math:

* ``calibrate``       -> ``solver.solve_admm`` (the fused solve's math;
  the host-segmented solve computes the same thing for TPU watchdogs),
  wrapped in the rho-boost retry of ``solve_admm_safe``;
* ``influence_image`` -> ``influence.influence_image_single_sr`` per
  sub-band, averaged (the JAX host-segmented route's unit), with the
  SKA-tier statics of :meth:`RadioBackend._influence_statics`: the blocked
  Hessian from B >= 8128 (N >= 128) and the large-tier factored imager
  from npix >= 512, each a hand-written CUDA kernel on the card;
* ``data_image`` / ``residual_image`` -> ``imager.multifreq_image_sr``,
  one direct-DFT kernel launch per sub-band.

``stage_seconds`` accumulates host-clock seconds per stage (simulate,
solve, influence, images), each ended by a device synchronize.
"""

import time
from collections import defaultdict
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.cal import (coherency, imager, influence, observation,
                                    simulate, solver)

# SKA-tier thresholds (the JAX backend's, smartcal_tpu/envs/radio.py:69-72):
# from _BLOCK_MIN_B baselines (N=128 -> B=8128) the influence chain's
# per-chunk (K, Td, B) einsum temporaries are the memory wall, so the
# blocked Hessian takes over; from npix >= _IMAGER_BLOCK_MIN_NPIX the
# factored imager's (npix, R) planes reach GB scale, so its large tier
# (R-blocked on the CPU, the tiled kernel on the card) takes over.
_BLOCK_MIN_B = 8128
_BLOCK_BASELINES = 2048
_IMAGER_BLOCK_MIN_NPIX = 512
_IMAGER_BLOCK_R = 4096


class Episode(NamedTuple):
    """Device-resident state of one simulated observation."""

    obs: observation.Observation
    V: torch.Tensor          # (Nf, T, B, 2, 2, 2) observed (corrupted+noise)
    Ccal: torch.Tensor       # (Nf, K, T*B, 4, 2) calibration-model coherencies
    f0: float
    n_dirs: int
    snr: float


class RadioBackend:
    """Hermetic observation + calibration service for the envs.

    n_times = Ts * tdelta integration slots; every ``tdelta`` slots share
    one solution interval.  ``device`` defaults to "cuda" and raises when
    no GPU is present.  ``block_baselines`` / ``imager_block_r`` override
    the SKA-tier block sizes: None picks them by threshold, 0 forces the
    unblocked path."""

    def __init__(self, n_stations=14, n_freqs=3, n_times=20, tdelta=10,
                 n_poly=2, admm_iters=10, lbfgs_iters=8, init_iters=30,
                 polytype=0, npix=128, device="cuda", block_baselines=None,
                 imager_block_r=None):
        if n_times <= 0 or n_times % tdelta != 0:
            raise ValueError(
                f"n_times={n_times} must be a positive multiple of "
                f"tdelta={tdelta}: every solution interval needs the same "
                "number of slots")
        self.device = resolve_device(device)
        self.n_stations = n_stations
        self.n_freqs = n_freqs
        self.n_times = n_times
        self.tdelta = tdelta
        self.n_chunks = n_times // tdelta
        self.n_poly = n_poly
        self.admm_iters = admm_iters
        self.lbfgs_iters = lbfgs_iters
        self.init_iters = init_iters
        self.polytype = polytype
        self.npix = npix
        self.block_baselines = block_baselines
        self.imager_block_r = imager_block_r
        self.stage_seconds = defaultdict(float)

    @contextmanager
    def _stage(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.stage_seconds[name] += time.perf_counter() - t0

    @property
    def n_baselines(self):
        return self.n_stations * (self.n_stations - 1) // 2

    # -- episode construction ------------------------------------------------

    def _coherencies(self, obs, sky):
        uvw = obs.uvw.reshape(-1, 3)
        return coherency.predict_coherencies_multi_sr(
            uvw[:, 0], uvw[:, 1], uvw[:, 2], sky, obs.freqs)

    def _corrupt_and_noise(self, key, obs, Csim, J_extra_dirs, snr, amp,
                           spatial_term, lm_dirs):
        """DATA: the sim sky corrupted by synthetic systematics, plus noise
        (the roles of sagecal -p sim + addnoise.py)."""
        K_sim = Csim.shape[1]
        freqs = obs.freqs.cpu().numpy()
        Jerr = simulate.synth_solutions(
            key, K_sim - J_extra_dirs, self.n_stations, self.n_chunks, freqs,
            float(freqs.mean()), amp=amp, spatial_term=spatial_term,
            lm_dirs=lm_dirs)
        Jid = simulate.identity_solutions(J_extra_dirs, self.n_stations,
                                          self.n_chunks, self.n_freqs)
        Jsim = torch.as_tensor(np.concatenate([Jerr, Jid], axis=2),
                               device=self.device)
        V = solver.simulate_vis_multi_sr(Jsim, Csim, self.n_stations,
                                         self.n_chunks)
        Vn, _ = simulate.add_noise_device(key, V, snr=snr)
        return Vn

    def new_calib_episode(self, key, K, M, diffuse=False):
        """CalibEnv episode: K drawn clusters padded to M directions.
        Returns (episode, models).  ``diffuse=True`` (the shapelet sky) is
        still to be ported."""
        if diffuse:
            raise NotImplementedError("diffuse (shapelet) skies are not "
                                      "ported yet")
        with self._stage("simulate"):
            obs = observation.make_observation(
                key, n_stations=self.n_stations, n_freqs=self.n_freqs,
                n_times=self.n_times, device=self.device)
            f0 = float(obs.freqs.cpu().numpy().mean())
            mdl = simulate.simulate_models(key, K=K, f0=f0)
            Csim = self._coherencies(obs, mdl.sky_sim)
            V = self._corrupt_and_noise(key, obs, Csim, J_extra_dirs=1,
                                        snr=0.05, amp=1.0, spatial_term=True,
                                        lm_dirs=mdl.lm_dirs)
            Ck = self._coherencies(obs, mdl.sky_cal)
            Ccal = torch.nn.functional.pad(Ck, (0, 0, 0, 0, 0, 0, 0, M - K))
        return Episode(obs=obs, V=V, Ccal=Ccal, f0=mdl.f0, n_dirs=M,
                       snr=0.05), mdl

    # -- calibration + influence --------------------------------------------

    def _solver_cfg(self, K):
        return solver.SolverConfig(
            n_stations=self.n_stations, n_dirs=K, n_poly=self.n_poly,
            admm_iters=self.admm_iters, lbfgs_iters=self.lbfgs_iters,
            init_iters=self.init_iters, polytype=self.polytype)

    def calibrate(self, ep: Episode, rho, mask=None, admm_iters=None):
        """Solve with per-direction rho; ``mask`` (K,) in {0, 1} excludes
        directions by zeroing their model (one solver for every subset)."""
        with self._stage("solve"):
            C = ep.Ccal
            if mask is not None:
                m = torch.as_tensor(np.asarray(mask, np.float32),
                                    device=self.device)
                C = C * m[None, :, None, None, None]
            rho_t = torch.as_tensor(np.asarray(rho, np.float32),
                                    device=self.device)
            cfg = self._solver_cfg(ep.n_dirs)

            def solve(r):
                return solver.solve_admm(ep.V, C, ep.obs.freqs, ep.f0, r, cfg,
                                         n_chunks=self.n_chunks,
                                         admm_iters=admm_iters)

            res, _ = solver.solve_admm_safe(solve, rho_t)
            return res

    def _cell(self, ep):
        return imager.default_cell(ep.obs.uvw, float(ep.obs.freqs[-1]))

    def _influence_statics(self, npix):
        """The SKA-tier block sizes of the influence chain, decided on the
        host from the episode geometry: the blocked Hessian from the
        baseline threshold, the large-tier imager from the npix
        threshold.  The precision policy stays f32 (the bf16 rows are not
        ported)."""
        bb = self.block_baselines
        if bb is None:
            bb = _BLOCK_BASELINES if self.n_baselines >= _BLOCK_MIN_B else 0
        ibr = self.imager_block_r
        if ibr is None:
            ibr = _IMAGER_BLOCK_R if npix >= _IMAGER_BLOCK_MIN_NPIX else 0
        return {"block_baselines": bb, "imager_block_r": ibr}

    def influence_image(self, ep: Episode, result: solver.SolveResult, rho,
                        rho_spatial, npix=None):
        """Mean Stokes-I influence dirty image over sub-bands."""
        npix = npix or self.npix
        statics = self._influence_statics(npix)
        with self._stage("influence"):
            uvw = ep.obs.uvw.reshape(-1, 3)
            cell = self._cell(ep)
            hadd_all = influence.consensus_hadd_all(
                np.asarray(rho, np.float32),
                np.asarray(rho_spatial, np.float32), ep.obs.freqs, ep.f0,
                n_poly=self.n_poly, polytype=self.polytype)   # (Nf, K)
            freqs = ep.obs.freqs.tolist()
            acc = None
            for fi in range(self.n_freqs):
                img = influence.influence_image_single_sr(
                    result.residual[fi], ep.Ccal[fi], result.J[fi],
                    hadd_all[fi], freqs[fi], uvw, cell,
                    n_stations=self.n_stations, n_chunks=self.n_chunks,
                    npix=npix, **statics)
                acc = img if acc is None else acc + img
            return acc / self.n_freqs

    def data_image(self, ep: Episode, npix=None):
        with self._stage("images"):
            return imager.multifreq_image_sr(ep.obs.uvw, ep.V, ep.obs.freqs,
                                             self._cell(ep),
                                             npix=npix or self.npix)

    def residual_image(self, ep: Episode, result: solver.SolveResult,
                       npix=None):
        with self._stage("images"):
            return imager.multifreq_image_sr(ep.obs.uvw, result.residual,
                                             ep.obs.freqs, self._cell(ep),
                                             npix=npix or self.npix)

    def noise_std(self, V):
        """sqrt(mean_f std(Stokes I)^2) over sub-bands."""
        stds = torch.stack([solver.stokes_i_std(v) for v in V])
        return torch.sqrt(torch.mean(stds ** 2))
