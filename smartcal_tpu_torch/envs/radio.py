"""Episode backend of the calibration environment (counterpart of
smartcal_tpu/envs/radio.py): simulate an observation, calibrate it, map
its influence, and image the data and the residual.

Direction selection is a MASK over a fixed M-direction coherency tensor,
as in the JAX package.  Routes, chosen as the JAX backend chooses them
(smartcal_tpu/envs/radio.py:417-465, 508-566, 744-979, 1082-1290), by the
number of mesh positions the backend sees (:meth:`RadioBackend.
_mesh_devices`: ``parallel/mesh.default_devices`` of the backend's device,
every local GPU; with one device no route shards; in a job of several
processes, ``parallel/multihost``, one position per rank, and a route
shards over all of them or none) and the problem size:

* ``calibrate`` -> ``parallel/sharded_cal.solve_admm_sharded`` (route
  ``sharded``) when the sub-bands divide over >= 2 positions
  (:meth:`_shard_size`: the largest divisor of Nf the positions hold; under
  ``shard="auto"`` only from 1e6 calibration units, ``_SHARD_MIN_WORK``)
  and each shard's work stays under the JAX backend's watchdog limit
  (``_WATCHDOG_WORK``, 1e7 units of :meth:`_fused_work` per shard, so the
  routes match JAX's: at the SKA tier neither shards the solve); else
  ``solver.solve_admm`` (``fused``).  Either sits in ``solve_admm_safe``'s
  ladder: rho-boosted retries, then the host-segmented route
  ``solver.solve_admm_host``.  The JAX backend picks the host-segmented
  route itself above 1e7 units; the port's solve is a host-driven loop
  with no fused XLA program to guard, so only ``SMARTCAL_HOST_SOLVER=1``
  picks it (``=0`` the fused one), and it beats the mesh route;
  ``SMARTCAL_SHARD=0/1`` overrides ``shard``; ``SMARTCAL_ROBUST_SOLVER=0/1``
  overrides ``robust_solver``.  The fused and host-segmented routes give
  the same bits, so the host rung repeats a non-finite fused solve (one
  more solve before ``SolverDegradedError``) rather than rescuing it;
* ``influence_image`` -> at B >= 8128 with a baseline divisor,
  ``baseline_sharded`` (``sharded_cal.influence_baseline_sharded`` band by
  band: the axis that makes an N >= 256 influence chain fit, each
  position's Hessian sums one kernel-3 launch per interval, the gathered
  visibilities imaged by kernel 2 at npix >= 512); else ``freq_sharded``
  (``sharded_cal.influence_images_sharded``); else ``chunk_sharded``
  (``sharded_cal.influence_sharded`` band by band); else ``per_band``:
  ``influence.influence_image_single_sr`` per sub-band, averaged (the JAX
  host-segmented route's unit).  Every route takes the SKA-tier statics of
  :meth:`RadioBackend._influence_statics`: the blocked Hessian from B >=
  8128 (N >= 128) and the large-tier factored imager from npix >= 512,
  each a hand-written CUDA kernel on the card, and the backend's
  ``precision`` (``"bf16"``: the bf16 column means and kernel 2's bf16
  mode).  Each position runs the single-device route's kernels at its
  local shapes;
* ``data_image`` / ``residual_image`` -> ``imager.multifreq_image_sr``,
  one direct-DFT kernel launch per sub-band;
* ``vectorized=False`` is the JAX backend's host-loop route (the parity
  oracle and the pre-pipeline baseline, smartcal_tpu/envs/radio.py:
  216-275, 981-1000): the episode is built band by band (coherencies,
  shapelet, corruption) with the noise added in host numpy
  (``simulate.add_noise``), and ``influence_image`` runs the oracle chain
  band by band (``influence.influence_images_multi(optimized=False)``),
  each band imaged by the direct DFT (kernel 1 on the card).  The solve,
  the hint, the images and the batched routes are the same as
  ``vectorized=True``;
* ``hint_sweep`` (the demixing env's exhaustive hint) ->
  ``solver.solve_admm_batched`` with one lane-episode per mask, ``batch``
  masks per solve (the JAX package vmaps the masks, ``lax.map`` over
  batches).

Episodes: ``new_calib_episode`` (with the optional diffuse shapelet
component of cluster 0, ``_add_shapelet``) and ``new_demixing_episode``
(A-team outliers and the target field, ``simulate.simulate_demixing_sky``).

Batched episodes (:class:`BatchedEpisode`, the batched envs' operands),
routed as the JAX backend routes a batch: the lanes divide over the
positions (:meth:`_batch_shard_size`), and positions left over go to a
baseline axis at B >= 8128 or under ``SMARTCAL_COMPOSE=1``
(:meth:`_compose_sizes`; ``compose=`` forces a shape):

* ``calibrate_batched``        -> ``solver.solve_admm_batched``: the
  E*Nf*Ts inner solves as lanes of one L-BFGS, the rest per episode
  (``batched_vmap``); with a lane axis, the lanes split over the positions
  in one ``shard_map`` (``batched_sharded``; on the composed mesh the
  baseline axis holds copies).  Like the JAX route it has no rho-boost
  retry;
* ``influence_images_batched`` -> with a baseline axis,
  ``sharded_cal.influence_images_batched_sharded`` on the composed lane x
  baseline mesh (``batched_lane_bshard``); else
  ``influence.influence_images_lanes``: the episodes' bands as leading lane
  axes of the plain chain and of the factored imager's matmuls; the
  SKA-tier CUDA kernels, which take one lane per launch, in a loop over
  lanes (the JAX package vmaps the ``pallas_call``);
* ``image_sigmas_batched``     -> the factored imager over all lanes, as in
  the JAX package (not the DFT kernel: the fused reward differs from the
  sequential env's by round-off only).

Serving (``serve/``): ``serve_signature`` is the JAX backend's signature
dict (the program cache's key), and ``batched_solve_callable`` /
``batched_influence_callable`` are the batched solve and influence chain as
callables of ``batched_solve_operands`` / ``batched_influence_operands``;
the solve callable owns one line search per lane count, whose CUDA graph
is captured by its first call and replayed by every later one.

Prefetch: ``prefetch_episode`` / ``take_prefetched`` and ``run_pipelined``
build episodes on one worker thread; on the card it works on a stream of
its own, and the caller's stream waits on an event recorded at the end of
the build.

``stage_seconds`` accumulates host-clock seconds per stage (simulate,
solve, hint, influence, images, sigmas), each ended by a synchronize of the
calling thread's stream (a prefetch build's simulate seconds overlap the
caller's stages).  While a RunLog is active each stage is also an obs
span, under the JAX package's span names (the hint stage is
``hint_sweep``, the sigmas stage ``reward``; ``images`` has no JAX twin)
and tagged ``synced=True``: its duration includes the device's time.
``calibrate`` then also collects the solver's telemetry and logs it as a
``solver`` event with its route, and each step down the ladder as a
``solver_degraded`` event, as the JAX backend does.  With ``obs.costs``
armed (``--diag``), the solve, simulate and influence stages and the
SKA-tier kernels log deferred ``cost`` events at the JAX sites.  The
prefetch records the JAX package's ``prefetch_hit`` /
``prefetch_stall`` / ``prefetch_miss``
counters, the ``prefetch_pending`` gauge and ``prefetch_wait`` spans.
"""

import os
import threading
import time
from collections import defaultdict
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from smartcal_tpu_torch import obs, resolve_device
from smartcal_tpu_torch.cal import (coherency, imager, influence, observation,
                                    shapelets, simulate, solver)
from smartcal_tpu_torch.cal import precision as prec
from smartcal_tpu_torch.obs import costs as obs_costs
from smartcal_tpu_torch.parallel import mesh as mesh_mod
from smartcal_tpu_torch.parallel.mesh import (AXIS_BASELINE, AXIS_CHUNK,
                                              AXIS_FREQ, AXIS_LANE,
                                              largest_divisor)

# calibration units (RadioBackend._fused_work) of the JAX backend's routing:
# one fused program above _WATCHDOG_WORK risks a TPU watchdog there, and a
# shard of the solve must stay below it; below _SHARD_MIN_WORK sharding
# costs more in collectives than it returns, so "auto" leaves tiny
# configurations alone
_WATCHDOG_WORK = 1e7
_SHARD_MIN_WORK = 1e6

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


class BatchedEpisode(NamedTuple):
    """E stacked episodes (the JAX package's ``BatchedEpisode``): the lane
    form of :class:`Episode` that the batched calibrate -> influence ->
    reward chain takes.  Construction stays per lane, so stacking is the
    batching boundary.  ``V``, ``Ccal`` and ``uvw`` live on the device (a
    masked reset copies a lane in place); the small per-lane values stay
    host numpy."""

    V: torch.Tensor         # (E, Nf, T, B, 2, 2, 2)
    Ccal: torch.Tensor      # (E, Nf, K, T*B, 4, 2)
    freqs: np.ndarray       # (E, Nf) Hz
    f0: np.ndarray          # (E,) float32
    uvw: torch.Tensor       # (E, T*B, 3) meters
    cell: np.ndarray        # (E,) float32 imaging pixel size (rad)
    n_dirs: int             # K = M, equal across lanes

    @property
    def n_envs(self) -> int:
        return self.V.shape[0]


def _tensors(x):
    """The tensors inside nested tuples, lists and dicts."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


class RadioBackend:
    """Hermetic observation + calibration service for the envs.

    n_times = Ts * tdelta integration slots; every ``tdelta`` slots share
    one solution interval.  ``device`` defaults to "cuda" and raises when
    no GPU is present.  ``hint_batch`` is the number of masks per solve of
    the hint sweep (1: one mask at a time).  ``block_baselines`` /
    ``imager_block_r`` override the SKA-tier block sizes: None picks them
    by threshold, 0 forces the unblocked path.  ``precision`` ("f32" or
    "bf16", ``cal/precision``) is the policy of the influence chain: "bf16"
    narrows the column means' final contraction and the factored imager's
    matmuls (kernel 2's bf16 mode on the card) with f32 accumulation; the
    solve, the Hessian, the hint and the data and residual images stay f32
    under either.  ``robust_solver``, ``solver_max_retries`` and
    ``solver_rho_boost`` are the solve's degradation ladder (the JAX
    backend's): non-finite iterates re-solve at boosted rho, then on the
    host-segmented route, before ``SolverDegradedError``.

    ``vectorized`` (default True) builds each episode with all sub-bands
    in one expression and maps the influence with the optimized chain;
    False is the host-loop route (module docstring): band by band, the
    noise in host numpy, the influence on the oracle chain imaged by
    kernel 1.  ``shard`` is the JAX backend's mesh switch: "auto" shards
    over the positions of :meth:`_mesh_devices` when there are >= 2 and the
    episode is big enough (``_SHARD_MIN_WORK``), True whenever a divisible
    mesh exists, False or None never; ``SMARTCAL_SHARD=0/1`` overrides.
    With one device no mesh divides, and every value runs the
    single-device route, as the JAX backend does on one device."""

    def __init__(self, n_stations=14, n_freqs=3, n_times=20, tdelta=10,
                 n_poly=2, admm_iters=10, lbfgs_iters=8, init_iters=30,
                 polytype=0, npix=128, hint_batch=8, device="cuda",
                 block_baselines=None, imager_block_r=None, precision="f32",
                 robust_solver=True, solver_max_retries=2,
                 solver_rho_boost=10.0, vectorized=True, shard="auto"):
        if n_times <= 0 or n_times % tdelta != 0:
            raise ValueError(
                f"n_times={n_times} must be a positive multiple of "
                f"tdelta={tdelta}: every solution interval needs the same "
                "number of slots")
        if shard not in ("auto", True, False, None):
            raise ValueError(f"shard={shard!r}: expected 'auto', True, False "
                             "or None")
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
        self.hint_batch = hint_batch
        self.vectorized = bool(vectorized)
        self.shard = shard
        self.robust_solver = robust_solver
        self.solver_max_retries = solver_max_retries
        self.solver_rho_boost = solver_rho_boost
        self.precision = prec.check(precision)
        self.block_baselines = block_baselines
        self.imager_block_r = imager_block_r
        self.stage_seconds = defaultdict(float)
        self._stage_lock = threading.Lock()
        self._prefetched = {}
        self._prefetch_lock = threading.Lock()
        self._prefetch_ex = None
        self._prefetch_stream = None
        self.prefetch_counts = {"hit": 0, "stall": 0, "miss": 0}
        self._meshes = {}

    @contextmanager
    def _stage(self, name, span=None, **tags):
        """Time stage ``name`` into ``stage_seconds``, ended by a
        synchronize of this thread's stream; while a RunLog is active also
        an obs span ``span`` (default ``name``), tagged ``synced=True``.
        Yields the span (its ``tag`` adds tags)."""
        with obs.span(span or name, synced=True, **tags) as sp:
            t0 = time.perf_counter()
            try:
                yield sp
            finally:
                if self.device.type == "cuda":
                    # this thread's stream only: a device-wide synchronize
                    # from the prefetch thread would break the caller's
                    # graph capture
                    torch.cuda.current_stream(self.device).synchronize()
                dt = time.perf_counter() - t0
                with self._stage_lock:
                    self.stage_seconds[name] += dt

    @property
    def n_baselines(self):
        return self.n_stations * (self.n_stations - 1) // 2

    # -- episode construction ------------------------------------------------

    def _coherencies(self, obs, sky):
        uvw = obs.uvw.reshape(-1, 3)
        if self.vectorized:
            return coherency.predict_coherencies_multi_sr(
                uvw[:, 0], uvw[:, 1], uvw[:, 2], sky, obs.freqs)
        return torch.stack([
            coherency.predict_coherencies_sr(uvw[:, 0], uvw[:, 1], uvw[:, 2],
                                             sky, f)
            for f in obs.freqs.cpu().numpy()])

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
        if not self.vectorized:
            V = torch.stack([
                solver.simulate_vis_sr(Jsim[f], Csim[f], self.n_stations,
                                       self.n_chunks)
                for f in range(self.n_freqs)])
            Vn, _ = simulate.add_noise(key, V.cpu().numpy(), snr=snr)
            return torch.as_tensor(Vn, device=self.device)
        V = solver.simulate_vis_multi_sr(Jsim, Csim, self.n_stations,
                                         self.n_chunks)
        # inside the simulate span: counted between episodes
        obs_costs.record_stage_cost(
            "simulate", solver.simulate_vis_multi_sr, Jsim, Csim,
            self.n_stations, self.n_chunks, defer=True)
        Vn, _ = simulate.add_noise_device(key, V, snr=snr)
        return Vn

    def _add_shapelet(self, obs, C, coeff, beta, flux):
        """C with a diffuse shapelet component added to cluster 0
        (cal/shapelets.py): all sub-bands in one expression, or band by
        band on the host-loop route."""
        uvw = obs.uvw.reshape(-1, 3)
        if self.vectorized:
            add = shapelets.shapelet_coherency_multi_sr(
                coeff, uvw[:, 0], uvw[:, 1], obs.freqs, beta, flux=flux)
        else:
            add = torch.stack([
                shapelets.shapelet_coherency_sr(coeff, uvw[:, 0], uvw[:, 1],
                                                float(f), beta, flux=flux)
                for f in obs.freqs.cpu().numpy()])
        C = C.clone()
        C[:, 0] += add
        return C

    def new_calib_episode(self, key, K, M, diffuse=False):
        """CalibEnv episode: K drawn clusters padded to M directions.
        Returns (episode, models).  ``diffuse=True`` adds the random
        shapelet component to cluster 0: exact modes to the data, the
        perturbed twin to the calibration model."""
        with self._stage("simulate", kind="calib", K=K):
            obs = observation.make_observation(
                key, n_stations=self.n_stations, n_freqs=self.n_freqs,
                n_times=self.n_times, device=self.device)
            f0 = float(obs.freqs.cpu().numpy().mean())
            mdl = simulate.simulate_models(key, K=K, f0=f0, diffuse=diffuse)
            shp = mdl.shapelet
            Csim = self._coherencies(obs, mdl.sky_sim)
            if shp is not None:
                Csim = self._add_shapelet(obs, Csim, shp.coeff, shp.beta,
                                          shp.flux)
            V = self._corrupt_and_noise(key, obs, Csim, J_extra_dirs=1,
                                        snr=0.05, amp=1.0, spatial_term=True,
                                        lm_dirs=mdl.lm_dirs)
            Ck = self._coherencies(obs, mdl.sky_cal)
            if shp is not None:
                Ck = self._add_shapelet(obs, Ck, shp.coeff_cal, shp.beta_cal,
                                        shp.flux)
            Ccal = torch.nn.functional.pad(Ck, (0, 0, 0, 0, 0, 0, 0, M - K))
        return Episode(obs=obs, V=V, Ccal=Ccal, f0=mdl.f0, n_dirs=M,
                       snr=0.05), mdl

    def new_demixing_episode(self, key, K):
        """DemixingEnv episode: K-1 A-team outliers + the target (cluster
        K-1), Ccal not padded (``n_dirs=K``).  The host draws follow the
        JAX order: strategy (salt 20), target (11), band, observation (12,
        10), sky (2, 3), then the snr, the systematics (4) and the noise
        (5).  Returns (episode, models)."""
        with self._stage("simulate", kind="demix", K=K):
            rng = observation.host_rng(key, salt=20)
            strategy = int(rng.integers(0, 3))
            ra0, dec0, t0 = observation.find_valid_target(
                key, strategy=1 if strategy == 1 else 0)
            hba = bool(rng.integers(0, 2))
            obs = observation.make_observation(
                key, n_stations=self.n_stations, n_freqs=self.n_freqs,
                n_times=self.n_times, hba=hba, ra0=ra0, dec0=dec0, t0=t0,
                device=self.device)
            f0 = float(obs.freqs.cpu().numpy().mean())
            mdl = simulate.simulate_demixing_sky(key, ra0, dec0, t0, f0, K=K)
            Csim = self._coherencies(obs, mdl.sky_sim)
            snr = float(0.05 + rng.random() * 0.45)
            V = self._corrupt_and_noise(key, obs, Csim, J_extra_dirs=1,
                                        snr=snr, amp=0.01,
                                        spatial_term=False,
                                        lm_dirs=mdl.lm_dirs)
            Ccal = self._coherencies(obs, mdl.sky_cal)
        return Episode(obs=obs, V=V, Ccal=Ccal, f0=f0, n_dirs=K,
                       snr=snr), mdl

    # -- calibration + influence --------------------------------------------

    def _solver_cfg(self, K):
        return solver.SolverConfig(
            n_stations=self.n_stations, n_dirs=K, n_poly=self.n_poly,
            admm_iters=self.admm_iters, lbfgs_iters=self.lbfgs_iters,
            init_iters=self.init_iters, polytype=self.polytype)

    def _fused_work(self, admm_iters=None):
        """Calibration units of one solve (the JAX backend's measure):
        total L-BFGS iterations x N^2 x Nf x T, with the per-call ADMM
        override counted.  Telemetry only here: a tag of the solve span
        (the JAX backend routes on it; see :meth:`_use_host_solver`)."""
        admm = self.admm_iters if admm_iters is None else int(admm_iters)
        total_iters = self.init_iters + admm * self.lbfgs_iters
        return total_iters * (self.n_stations ** 2) * self.n_freqs \
            * self.n_times

    def _use_host_solver(self) -> bool:
        """Run the solve on the host-segmented route?  The JAX backend does
        above 1e7 units of :meth:`_fused_work`, to keep one fused XLA program
        under a TPU watchdog; the port has no such program, so only
        ``SMARTCAL_HOST_SOLVER=1`` says yes (``=0`` and unset: no)."""
        return os.environ.get("SMARTCAL_HOST_SOLVER", "").strip() == "1"

    def _mesh_devices(self):
        """The positions the routes lay meshes over:
        ``parallel/mesh.default_devices`` of the backend's device (read at
        each call, so a run can replace it)."""
        return mesh_mod.default_devices(self.device)

    def _shard_size(self, n_items, work):
        """Mesh axis size for sharding ``n_items`` (0: do not shard): the
        largest divisor >= 2 of n_items that the positions hold, subject to
        the shard mode (JAX radio.py:417-438).  In a job of several
        processes the positions are the ranks, and a mesh takes all of
        them or none."""
        mode = self.shard
        override = os.environ.get("SMARTCAL_SHARD", "").strip()
        if override in ("0", "1"):
            mode = override == "1"
        if mode is False or mode is None:
            return 0
        if mode == "auto" and work < _SHARD_MIN_WORK:
            return 0
        devs = self._mesh_devices()
        ndev = len(devs)
        if ndev < 2:
            return 0
        if isinstance(devs[0], mesh_mod.RankDevice):
            # a mesh of processes spans every rank of the job
            return ndev if n_items % ndev == 0 else 0
        for size in range(min(ndev, n_items), 1, -1):
            if n_items % size == 0:
                return size
        return 0

    def _mesh(self, size, axis=AXIS_FREQ):
        """Cached 1-D mesh of ``size`` positions whose axis carries the
        registry name of the role it plays."""
        key = (size, axis, tuple(self._mesh_devices()[:size]))
        mesh = self._meshes.get(key)
        if mesh is None:
            mesh = self._meshes[key] = mesh_mod.make_mesh(
                (size,), (axis,), devices=list(key[2]))
        return mesh

    def _mesh2(self, n_lane, n_baseline):
        """Cached composed lane x baseline mesh: the batched solve (lanes
        split, the baseline axis holding copies) and the composed influence
        program share it."""
        devs = tuple(self._mesh_devices())
        key = (n_lane, n_baseline, devs)
        mesh = self._meshes.get(key)
        if mesh is None:
            mesh = self._meshes[key] = mesh_mod.compose_mesh(
                {AXIS_LANE: n_lane, AXIS_BASELINE: n_baseline},
                devices=list(devs))
        return mesh

    def calibrate(self, ep: Episode, rho, mask=None, admm_iters=None):
        """Solve with per-direction rho; ``mask`` (K,) in {0, 1} excludes
        directions by zeroing their model (one solver for every subset).
        The route (module docstring) is the frequency-sharded solve over a
        mesh, the fused solve, or the host-segmented one under
        ``SMARTCAL_HOST_SOLVER=1``, inside the degradation ladder
        (:meth:`_robustify`).  While a RunLog is active the solve collects
        its telemetry and logs a ``solver`` event with the route (JAX
        radio.py:495-607); the result is the same bits either way."""
        collect = obs.active() is not None
        stats = []
        cfg = self._solver_cfg(ep.n_dirs)
        C = ep.Ccal

        def collecting(fn):
            def call(r):
                out = fn(r)
                if collect:
                    out, st = out
                    stats.append(st)
                return out
            return call

        @collecting
        def host_route(r):
            return solver.solve_admm_host(
                ep.V, C, ep.obs.freqs, ep.f0, r, cfg, n_chunks=self.n_chunks,
                admm_iters=admm_iters, collect_stats=collect)

        @collecting
        def fused_route(r):
            out = solver.solve_admm(ep.V, C, ep.obs.freqs, ep.f0, r, cfg,
                                    n_chunks=self.n_chunks,
                                    admm_iters=admm_iters,
                                    collect_stats=collect)
            # inside the solve span: counted between episodes; the ADMM
            # count rides as a 0-d tensor, a value of the signature (as in
            # JAX, where it is traced), not a key of it
            obs_costs.record_stage_cost(
                "solve", solver.solve_admm, ep.V, C, ep.obs.freqs, ep.f0, r,
                cfg, defer=True, n_chunks=self.n_chunks,
                admm_iters=None if admm_iters is None
                else torch.tensor(int(admm_iters)))
            return out

        @collecting
        def sharded_route(r):
            from smartcal_tpu_torch.parallel import sharded_cal

            return sharded_cal.solve_admm_sharded(
                self._mesh(nfp, AXIS_FREQ), ep.V, C, ep.obs.freqs, ep.f0, r,
                cfg, axis=AXIS_FREQ, n_chunks=self.n_chunks,
                admm_iters=admm_iters, collect_stats=collect)

        work = self._fused_work(admm_iters)
        host = self._use_host_solver()
        nfp = 0 if host else self._shard_size(self.n_freqs, work)
        if nfp and work / nfp <= _WATCHDOG_WORK:
            route, route_fn, tags = "sharded", sharded_route, {"shards": nfp}
        else:
            route = "host_segmented" if host else "fused"
            route_fn = host_route if host else fused_route
            tags = {}
        with self._stage("solve", route=route, work=work, **tags) as sp:
            if mask is not None:
                m = torch.as_tensor(np.asarray(mask, np.float32),
                                    device=self.device)
                C = C * m[None, :, None, None, None]
            rho_t = torch.as_tensor(np.asarray(rho, np.float32),
                                    device=self.device)
            res, final = self._robustify(route_fn(rho_t), route_fn,
                                         None if host else host_route,
                                         rho_t, route)
            if final != route:
                sp.tag(final_route=final)
        if collect:
            obs.log_solver_stats(stats[-1], route=final,
                                 n_freqs=self.n_freqs,
                                 n_stations=self.n_stations)
        return res

    def _robustify(self, res, route_fn, host_fn, rho, route):
        """The solve's degradation ladder (JAX radio.py:573-599): non-finite
        iterates re-solve at boosted rho, then on ``host_fn`` (None when
        the route already is the host-segmented one), then raise
        ``SolverDegradedError``.  Each step logs a ``solver_degraded``
        event.  ``SMARTCAL_ROBUST_SOLVER=0/1`` overrides the constructor's
        ``robust_solver``; off, the result is returned as it is.  Returns
        (result, the route that produced it)."""
        override = os.environ.get("SMARTCAL_ROBUST_SOLVER", "").strip()
        enabled = (override == "1" if override in ("0", "1")
                   else self.robust_solver)
        if not enabled:
            return res, route
        final = [route]

        def on_event(**info):
            if info.get("route") == "host_segmented":
                final[0] = "host_segmented"
            rl = obs.active()
            if rl is not None:
                rl.log("solver_degraded", primary_route=route, **info)
            obs.echo(f"solver degraded ({route}): {info}", event=None)

        res, _ = solver.solve_admm_safe(
            route_fn, rho, initial_result=res, host_fallback=host_fn,
            max_retries=self.solver_max_retries,
            rho_boost=self.solver_rho_boost, on_event=on_event)
        return res, final[0]

    def hint_sweep(self, ep: Episode, rho, masks, admm_iters=None,
                   batch=None):
        """Masked calibrations of one episode (the demixing env's exhaustive
        AIC hint): the (n, K) ``masks`` run ``batch`` at a time (default
        ``hint_batch``) as the lane-episodes of one batched solve (the same
        V, C·mask per lane), the last batch with the masks left over;
        ``batch=1`` solves one mask at a time.  No rho-boost retry, as in
        the JAX sweep.  Returns (n,) the Stokes-I residual statistic
        sqrt(mean_f std_f²) per mask, the quantity of the env's reward."""
        masks = torch.as_tensor(np.asarray(masks, np.float32),
                                device=self.device)
        n, K = masks.shape
        batch = max(1, min(self.hint_batch if batch is None else batch, n))
        iters = self.admm_iters if admm_iters is None else int(admm_iters)
        rho_t = torch.as_tensor(np.asarray(rho, np.float32),
                                device=self.device)
        freqs = ep.obs.freqs
        out = []
        with self._stage("hint", span="hint_sweep", n_masks=n):
            for i in range(0, n, batch):
                m = masks[i:i + batch]
                E = m.shape[0]
                res = solver.solve_admm_batched(
                    ep.V.expand((E,) + tuple(ep.V.shape)),
                    ep.Ccal[None] * m[:, None, :, None, None, None],
                    freqs.expand(E, -1), np.full(E, ep.f0), rho_t.expand(E, K),
                    self._solver_cfg(K), n_chunks=self.n_chunks,
                    admm_iters=iters)
                out.append(self.noise_std_batched(res.residual))
                del res
            return torch.cat(out)

    def _cell(self, ep):
        return imager.default_cell(ep.obs.uvw, float(ep.obs.freqs[-1]))

    def _influence_statics(self, npix):
        """The SKA-tier statics of the influence chain, decided on the host
        from the episode geometry: the blocked Hessian from the baseline
        threshold, the large-tier imager from the npix threshold, and the
        backend's precision policy."""
        bb = self.block_baselines
        if bb is None:
            bb = _BLOCK_BASELINES if self.n_baselines >= _BLOCK_MIN_B else 0
        ibr = self.imager_block_r
        if ibr is None:
            ibr = _IMAGER_BLOCK_R if npix >= _IMAGER_BLOCK_MIN_NPIX else 0
        return {"block_baselines": bb, "imager_block_r": ibr,
                "precision": self.precision}

    def influence_image(self, ep: Episode, result: solver.SolveResult, rho,
                        rho_spatial, npix=None):
        """Mean Stokes-I influence dirty image over sub-bands, on the route
        the module docstring gives (JAX radio.py:744-795): baseline-,
        frequency- or chunk-sharded with a mesh, else the optimized chain
        band by band; with ``vectorized=False`` the host loop on the oracle
        chain (:meth:`_influence_image_loop`).  The stage span carries the
        route and its shards."""
        npix = npix or self.npix
        if not self.vectorized:
            with self._stage("influence", route="host_loop",
                             bands=self.n_freqs):
                return self._influence_image_loop(ep, result, rho,
                                                  rho_spatial, npix)
        statics = self._influence_statics(npix)
        work = self._fused_work()
        route, shards = "per_band", 0
        # the baseline axis first at the SKA tier: partitioning B is what
        # makes an N >= 256 chain fit; the frequency fan-out only speeds up
        if self.n_baselines >= _BLOCK_MIN_B:
            shards = self._shard_size(self.n_baselines, work)
            route = "baseline_sharded" if shards else route
        if not shards:
            shards = self._shard_size(self.n_freqs, work)
            route = "freq_sharded" if shards else route
        if not shards:
            shards = self._shard_size(self.n_chunks, work)
            route = "chunk_sharded" if shards else route
        tags = {"shards": shards} if shards else {"bands": self.n_freqs}
        with self._stage("influence", route=route, precision=self.precision,
                         **tags):
            uvw = ep.obs.uvw.reshape(-1, 3)
            cell = self._cell(ep)
            hadd_all = influence.consensus_hadd_all(
                np.asarray(rho, np.float32),
                np.asarray(rho_spatial, np.float32), ep.obs.freqs, ep.f0,
                n_poly=self.n_poly, polytype=self.polytype)   # (Nf, K)
            if route == "freq_sharded":
                from smartcal_tpu_torch.parallel import sharded_cal

                out = sharded_cal.influence_images_sharded(
                    self._mesh(shards, AXIS_FREQ), result.residual, ep.Ccal,
                    result.J, hadd_all, ep.obs.freqs, uvw, cell,
                    self.n_stations, self.n_chunks, npix, axis=AXIS_FREQ,
                    **statics)
            elif route == "per_band":
                out = self._influence_bands(ep, result, hadd_all, uvw, cell,
                                            npix, statics)
            else:
                out = self._influence_bands(
                    ep, result, hadd_all, uvw, cell, npix, statics,
                    route=route, shards=shards)
            # one band's chain, inside the span: counted between episodes;
            # a sharded route counts its single-device equivalent, its
            # footprint divided by the shards (JAX radio.py:798-820)
            axis = {"baseline_sharded": AXIS_BASELINE,
                    "freq_sharded": AXIS_FREQ,
                    "chunk_sharded": AXIS_CHUNK}.get(route)
            obs_costs.record_stage_cost(
                "influence", influence.influence_image_single_sr,
                result.residual[0], ep.Ccal[0], result.J[0], hadd_all[0],
                float(ep.obs.freqs[0]), uvw, cell, defer=True,
                compute_dtype=self._imager_dtype(),
                shards={axis: shards} if axis else 1,
                n_stations=self.n_stations, n_chunks=self.n_chunks,
                npix=npix, **statics)
            self._record_kernel_costs(ep.n_dirs, npix, cell, statics)
            return out

    def _influence_bands(self, ep, result, hadd_all, uvw, cell, npix,
                         statics, route="per_band", shards=0):
        """Mean over the sub-bands of one band's influence image each: the
        optimized chain (``per_band``), or the band's influence
        visibilities over a baseline or chunk mesh (``baseline_sharded`` /
        ``chunk_sharded``, JAX radio.py:915-979) imaged on the mesh's first
        device by the factored imager (its large tier, kernel 2 on the
        card, from npix >= 512)."""
        freqs = ep.obs.freqs.tolist()
        acc = None
        for fi in range(self.n_freqs):
            if route == "per_band":
                img = influence.influence_image_single_sr(
                    result.residual[fi], ep.Ccal[fi], result.J[fi],
                    hadd_all[fi], freqs[fi], uvw, cell,
                    n_stations=self.n_stations, n_chunks=self.n_chunks,
                    npix=npix, **statics)
            else:
                img = self._image_ivis(uvw, influence.stokes_i_influence(
                    self._sharded_vis(ep, result, hadd_all, fi, route,
                                      shards, statics).vis),
                    freqs[fi], cell, npix, statics)
            acc = img if acc is None else acc + img
        return acc / self.n_freqs

    def _sharded_vis(self, ep, result, hadd_all, fi, route, shards, statics):
        """Band ``fi``'s influence visibilities over a baseline or chunk
        mesh of ``shards`` positions."""
        from smartcal_tpu_torch.parallel import sharded_cal

        Rk = solver.residual_to_kernel(result.residual[fi])
        if route == "baseline_sharded":
            return sharded_cal.influence_baseline_sharded(
                self._mesh(shards, AXIS_BASELINE), Rk, ep.Ccal[fi],
                result.J[fi], hadd_all[fi], self.n_stations, self.n_chunks,
                axis=AXIS_BASELINE, precision=statics["precision"])
        return sharded_cal.influence_sharded(
            self._mesh(shards, AXIS_CHUNK), Rk, ep.Ccal[fi], result.J[fi],
            hadd_all[fi], self.n_stations, self.n_chunks, axis=AXIS_CHUNK,
            block_baselines=statics["block_baselines"],
            precision=statics["precision"])

    def _image_ivis(self, uvw, ivis, freq, cell, npix, statics):
        """Factored DFT image of one band's gathered influence visibilities
        under the SKA-tier statics: the large tier (kernel 2 on the card)
        when ``imager_block_r`` is set, else the plain factored imager."""
        if statics["imager_block_r"]:
            return imager.dirty_image_factored_large_sr(
                uvw, ivis, freq, cell, npix=npix,
                block_r=statics["imager_block_r"],
                precision=statics["precision"])
        return imager.dirty_image_factored_sr(
            uvw, ivis, freq, cell, npix=npix,
            precision=statics["precision"])

    def _influence_image_loop(self, ep, result, rho, rho_spatial, npix):
        """The JAX backend's host loop (pre-pipeline path): per sub-band the
        oracle influence chain, f32 and unblocked, imaged by the direct DFT
        (kernel 1 on the card), then the mean over bands."""
        hadd_all = influence.consensus_hadd_all(
            np.asarray(rho, np.float32), np.asarray(rho_spatial, np.float32),
            ep.obs.freqs, ep.f0, n_poly=self.n_poly, polytype=self.polytype)
        imgs = influence.influence_images_multi(
            result.residual, ep.Ccal, result.J, hadd_all,
            ep.obs.freqs.cpu().numpy(), ep.obs.uvw.reshape(-1, 3),
            self._cell(ep), self.n_stations, self.n_chunks, npix,
            optimized=False)
        return torch.mean(imgs, dim=0)

    def _imager_dtype(self):
        """The influence imager's contraction dtype under the backend's
        precision, as a cost event's ``compute_dtype``."""
        return prec.dtype_name(prec.contraction_dtype("imager_matmul",
                                                      self.precision))

    def _record_kernel_costs(self, n_dirs, npix, cell, statics):
        """``kernel:<name>`` cost events of the SKA-tier kernels the
        influence chain engages (JAX radio.py:824-880): one call of the
        blocked Hessian and of the large-tier factored imager on zero
        operands of the episode's shapes, made when the deferred count
        runs.  Counted by the wrappers' analytic work."""
        if statics.get("block_baselines"):
            obs_costs.record_stage_cost(
                "kernel:hessian_blocks", self._hessian_probe, n_dirs,
                max(self.n_times // self.n_chunks, 1), defer=True)
        if statics.get("imager_block_r"):
            obs_costs.record_stage_cost(
                "kernel:factored_imager", self._imager_probe,
                self.n_times * self.n_baselines, npix, float(cell),
                statics.get("precision", "f32"),
                compute_dtype=self._imager_dtype(), defer=True)

    def _hessian_probe(self, K, Td):
        from smartcal_tpu_torch.ops import hessian_blocks

        N, B, dev = self.n_stations, self.n_baselines, self.device
        sched, p_idx, q_idx = hessian_blocks.full_schedule(N, dev)
        jb = torch.zeros((K, B, 2, 2, 2), device=dev)
        return hessian_blocks.hessian_block_sums(
            torch.zeros((Td, B, 2, 2, 2), device=dev),
            torch.zeros((K, Td, B, 2, 2, 2), device=dev), jb, jb, p_idx,
            q_idx, N, sched=sched)

    def _imager_probe(self, R, npix, cell, precision):
        dev = self.device
        return imager.dirty_image_factored_large_sr(
            torch.zeros((R, 3), device=dev), torch.zeros((R, 2), device=dev),
            150e6, cell, npix=npix, precision=precision)

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
        """sqrt(mean_f std(Stokes I)^2) over sub-bands: the one-lane form of
        :meth:`noise_std_batched`, so a batched lane and a single episode
        give the same bits."""
        return self.noise_std_batched(V[None])[0]

    # -- episode prefetch ----------------------------------------------------

    def _worker(self):
        with self._prefetch_lock:
            if self._prefetch_ex is None:
                self._prefetch_ex = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="smartcal-episode")
            return self._prefetch_ex

    def _submit(self, build, *args):
        """``build(*args)`` on the worker thread.  On the card it runs on
        the worker's own stream and returns an event recorded at its end
        beside the result (None elsewhere)."""
        dev = self.device

        def run():
            if dev.type != "cuda":
                return build(*args), None
            if self._prefetch_stream is None:
                self._prefetch_stream = torch.cuda.Stream(dev)
            with torch.cuda.stream(self._prefetch_stream):
                out = build(*args)
                done = torch.cuda.Event()
                done.record()
            return out, done

        return self._worker().submit(run)

    def _collect(self, fut):
        """The result of a :meth:`_submit` future, handed to the caller's
        stream: the stream waits on the build's event, and every device
        tensor of the result is marked as used there, so the allocator
        does not give its memory back to the worker's stream while the
        caller's kernels may still read it.  Raises what the build
        raised."""
        out, done = fut.result()
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in _tensors(out):
                if t.device.type == "cuda":
                    t.record_stream(cur)
        return out

    def prefetch_episode(self, tag, build):
        """Schedule ``build()`` (an episode constructor) on the backend's
        worker thread, keyed by ``tag``.  Every draw is keyed, so the
        construction overlaps the caller's device work without changing any
        result.  Callers sharing one backend namespace their tags (the envs
        prefix theirs with the env instance)."""
        self._prefetched[tag] = self._submit(build)
        obs.gauge_set("prefetch_pending", len(self._prefetched))

    def take_prefetched(self, tag):
        """Collect a prefetched episode (None if none was scheduled under
        ``tag``); waits for the build, and raises what it raised.
        ``prefetch_counts`` counts misses, builds done when taken (hits)
        and builds waited on (stalls), the JAX package's counters."""
        fut = self._prefetched.pop(tag, None)
        if fut is None:
            self.prefetch_counts["miss"] += 1
            obs.counter_add("prefetch_miss")
            return None
        ready = fut.done()
        self.prefetch_counts["hit" if ready else "stall"] += 1
        obs.counter_add("prefetch_hit" if ready else "prefetch_stall")
        # the wait is the build time the prefetch did not hide
        with obs.span("prefetch_wait", ready=ready):
            return self._collect(fut)

    def discard_prefetched(self, tag):
        """Drop a pending prefetch without taking it (env close)."""
        fut = self._prefetched.pop(tag, None)
        if fut is not None:
            fut.cancel()

    def run_pipelined(self, keys, make_episode, process):
        """Double-buffered episode pipeline: yields ``process(ep, mdl)`` per
        key while the next key's ``make_episode(key)`` runs on the worker
        thread.  The outputs are a function of the keys alone."""
        keys = list(keys)
        if not keys:
            return
        fut = self._submit(make_episode, keys[0])
        for i in range(len(keys)):
            with obs.span("prefetch_wait", pipelined=True):
                ep, mdl = self._collect(fut)
            if i + 1 < len(keys):
                fut = self._submit(make_episode, keys[i + 1])
            yield process(ep, mdl)

    # -- batched episodes ----------------------------------------------------

    def stack_episodes(self, eps) -> BatchedEpisode:
        """Stack per-lane :class:`Episode`s into a :class:`BatchedEpisode`."""
        n_dirs = eps[0].n_dirs
        if any(e.n_dirs != n_dirs for e in eps):
            raise ValueError("batched lanes must share a (padded) direction "
                             "count")
        freqs = np.stack([e.obs.freqs.cpu().numpy() for e in eps])
        return BatchedEpisode(
            V=torch.stack([e.V for e in eps]),
            Ccal=torch.stack([e.Ccal for e in eps]),
            freqs=freqs,
            f0=np.asarray([e.f0 for e in eps], np.float32),
            uvw=torch.stack([e.obs.uvw.reshape(-1, 3) for e in eps]),
            cell=np.asarray([imager.default_cell(e.obs.uvw,
                                                 float(freqs[i][-1]))
                             for i, e in enumerate(eps)], np.float32),
            n_dirs=n_dirs)

    def splice_episode(self, bep: BatchedEpisode, lane: int,
                       ep: Episode) -> BatchedEpisode:
        """Replace lane ``lane`` of ``bep`` with a fresh episode (masked
        reset): the device fields are copied into the lane's slot in place
        (``bep``'s tensors change), the host fields are copied."""
        if ep.n_dirs != bep.n_dirs:
            raise ValueError(f"episode has {ep.n_dirs} directions, the "
                             f"batch {bep.n_dirs}")
        freqs = ep.obs.freqs.cpu().numpy()
        bep.V[lane].copy_(ep.V)
        bep.Ccal[lane].copy_(ep.Ccal)
        bep.uvw[lane].copy_(ep.obs.uvw.reshape(-1, 3))
        f0, freqs_b, cell = bep.f0.copy(), bep.freqs.copy(), bep.cell.copy()
        f0[lane] = ep.f0
        freqs_b[lane] = freqs
        cell[lane] = imager.default_cell(ep.obs.uvw, float(freqs[-1]))
        return bep._replace(freqs=freqs_b, f0=f0, cell=cell)

    def batched_solve_operands(self, bep: BatchedEpisode, rho, mask=None,
                               admm_iters=None) -> tuple:
        """The operands of the batched solve: (V, masked Ccal, freqs (E, Nf),
        f0 (E,), rho (E, K), per-lane ADMM counts (E,) on the host).
        ``admm_iters`` is None (the constructor's), a scalar or (E,)."""
        E, K, dev = bep.n_envs, bep.n_dirs, self.device
        rho = torch.as_tensor(np.asarray(rho, np.float32).reshape(E, K),
                              device=dev)
        C = bep.Ccal
        if mask is not None:
            m = torch.as_tensor(np.asarray(mask, np.float32).reshape(E, K),
                                device=dev)
            C = C * m[:, None, :, None, None, None]
        iters = np.broadcast_to(np.asarray(
            self.admm_iters if admm_iters is None else admm_iters,
            np.int64).reshape(-1), (E,))
        return (bep.V, C, torch.as_tensor(bep.freqs, device=dev), bep.f0,
                rho, iters)

    def batched_solve_callable(self, n_dirs):
        """The batched masked-ADMM solve over a leading lane axis as a
        callable of the positional operands of :meth:`batched_solve_operands`
        (the JAX backend's ``batched_solve_callable``, the serving layer's
        solve program).  It owns one quartic line search per lane count
        (``solver._QuarticLineSearch``): on the card the search's CUDA
        graph is captured by the first call at a lane count and replayed by
        every later one, so a warmed program captures nothing.  The bits are
        :meth:`calibrate_batched`'s."""
        cfg = self._solver_cfg(n_dirs)
        n_chunks = self.n_chunks
        searches = {}
        lock = threading.Lock()

        def solve(V, C, freqs, f0, rho, iters):
            lanes = V.shape[0] * V.shape[1] * n_chunks
            with lock:
                search = searches.get(lanes)
                if search is None:
                    search = searches[lanes] = solver._QuarticLineSearch(
                        lanes, V.dtype, V.device)
                return solver.solve_admm_batched(
                    V, C, freqs, f0, rho, cfg, n_chunks=n_chunks,
                    admm_iters=iters, search=search)

        return solve

    def _batch_shard_size(self, n_lanes):
        """Lane-axis mesh size of the batched routes (0: no lane axis): the
        per-episode policy of :meth:`_shard_size`, its work gate on the
        whole batch's calibration units."""
        return self._shard_size(n_lanes, self._fused_work() * n_lanes)

    def _compose_sizes(self, n_lanes):
        """(n_lane, n_baseline) of the composed batched mesh (JAX
        radio.py:1090-1109): lanes fill the positions first (no
        collectives), and the positions left over go to a baseline axis only
        at B >= ``_BLOCK_MIN_B``, where partitioning B makes the program fit.
        ``SMARTCAL_COMPOSE=1`` forces the baseline axis below that, ``=0``
        turns it off.  ``n_baseline`` is 0 when it would be lane-only."""
        nl = self._batch_shard_size(n_lanes)
        env = os.environ.get("SMARTCAL_COMPOSE", "").strip().lower()
        if env in ("0", "false", "no", "off"):
            return nl, 0
        spare = len(self._mesh_devices()) // max(nl, 1)
        want_b = env in ("1", "true", "yes", "on") or \
            self.n_baselines >= _BLOCK_MIN_B
        if not want_b or spare < 2:
            return nl, 0
        nb = largest_divisor(self.n_baselines, spare)
        return nl, (nb if nb >= 2 else 0)

    def calibrate_batched(self, bep: BatchedEpisode, rho, mask=None,
                          admm_iters=None,
                          compose=None) -> solver.SolveResult:
        """Batched :meth:`calibrate`: the E masked ADMM solves as one
        (``solver.solve_admm_batched``).  ``rho`` and ``mask`` are (E, K);
        ``admm_iters`` a scalar, (E,) per-lane counts, or None.  No
        rho-boost retry, as on the JAX package's batched route.
        ``compose`` forces the (n_lane, n_baseline) mesh shape (None: the
        :meth:`_compose_sizes` policy); with a lane axis the lanes split
        over its positions (``batched_sharded``), on the composed mesh
        when the baseline size is >= 2 (its positions hold copies)."""
        E = bep.n_envs
        nl, nb = self._compose_sizes(E) if compose is None \
            else (int(compose[0]), int(compose[1]))
        nb = nb if nl else 0
        route = "batched_sharded" if nl else "batched_vmap"
        tags = {"shards": nl} if nl else {}
        if nl and nb:
            tags["baseline_shards"] = nb
        with self._stage("solve", route=route, lanes=E, **tags):
            obs.gauge_set("batched_lanes", E)
            V, C, freqs, f0, rho, iters = self.batched_solve_operands(
                bep, rho, mask, admm_iters)
            cfg, n_chunks = self._solver_cfg(bep.n_dirs), self.n_chunks
            if not nl:
                return solver.solve_admm_batched(
                    V, C, freqs, f0, rho, cfg, n_chunks=n_chunks,
                    admm_iters=iters)
            from smartcal_tpu_torch.parallel import sharded_cal

            mesh_mod.check_axis_divides(E, nl, axis=AXIS_LANE,
                                        what="calibrate_batched E")
            mesh = self._mesh2(nl, nb) if nb else self._mesh(nl, AXIS_LANE)
            lane = mesh_mod.P(AXIS_LANE)

            def local(v, c, f, f0_, r, it):
                return solver.solve_admm_batched(v, c, f, f0_, r, cfg,
                                                 n_chunks=n_chunks,
                                                 admm_iters=it)

            return sharded_cal.shard_map(
                local, mesh, (lane,) * 6,
                solver.SolveResult(*(lane,) * 6))(V, C, freqs, f0, rho,
                                                  iters)

    def batched_influence_operands(self, bep: BatchedEpisode,
                                   result: solver.SolveResult, rho,
                                   rho_spatial) -> tuple:
        """(residual, Ccal, J, hadd (E, Nf, K), freqs (E, Nf), uvw
        (E, T*B, 3), cell (E,)): the per-episode consensus scalars beside
        the solve's outputs and the imaging geometry, the positional
        operands of :meth:`batched_influence_callable`."""
        E, K = bep.n_envs, bep.n_dirs
        rho = np.asarray(rho, np.float32).reshape(E, K)
        alpha = np.asarray(rho_spatial, np.float32).reshape(E, K)
        freqs = torch.as_tensor(bep.freqs, device=self.device)
        hadd = torch.stack([influence.consensus_hadd_all(
            rho[e], alpha[e], freqs[e], float(bep.f0[e]),
            n_poly=self.n_poly, polytype=self.polytype) for e in range(E)])
        return (result.residual, bep.Ccal, result.J, hadd, bep.freqs,
                bep.uvw, bep.cell)

    def batched_influence_callable(self, n_dirs, npix):
        """The batched influence chain (consensus Hessian-add, the bands'
        influence images, their mean) as a callable of the positional
        operands of :meth:`batched_influence_operands` (the JAX backend's
        ``batched_influence_callable``, the serving layer's influence
        program); the statics are the single-episode route's.  Returns
        (E, npix, npix), the bits of :meth:`influence_images_batched`."""
        statics = self._influence_statics(npix)
        n_stations, n_chunks = self.n_stations, self.n_chunks

        def influence_program(residual, C, J, hadd, freqs, uvw, cell):
            imgs = influence.influence_images_lanes(
                residual, C, J, hadd, freqs, uvw[:, None],
                np.asarray(cell)[:, None], n_stations=n_stations,
                n_chunks=n_chunks, npix=npix, **statics)
            return torch.mean(imgs, dim=1)

        return influence_program

    def influence_images_batched(self, bep: BatchedEpisode,
                                 result: solver.SolveResult, rho,
                                 rho_spatial, npix=None, compose=None):
        """Batched :meth:`influence_image`: (E, npix, npix) mean influence
        images; ``rho``/``rho_spatial`` are (E, K).  The SKA-tier statics
        are those of the single-episode route.  ``compose`` forces the
        (n_lane, n_baseline) mesh shape (None: the :meth:`_compose_sizes`
        policy); a baseline size >= 2 runs the composed lane x baseline
        program (``sharded_cal.influence_images_batched_sharded``, route
        ``batched_lane_bshard``), else the lanes go through the chain
        together (``batched_vmap``)."""
        npix = npix or self.npix
        E = bep.n_envs
        statics = self._influence_statics(npix)
        nl, nb = self._compose_sizes(E) if compose is None \
            else (int(compose[0]), int(compose[1]))
        if nb >= 2:
            from smartcal_tpu_torch.parallel import sharded_cal

            nl = max(int(nl), 1)
            K = bep.n_dirs
            with self._stage("influence", route="batched_lane_bshard",
                             lanes=E, lane_shards=nl, baseline_shards=nb,
                             precision=self.precision):
                out = sharded_cal.influence_images_batched_sharded(
                    self._mesh2(nl, nb), result.residual, bep.Ccal, result.J,
                    np.asarray(rho, np.float32).reshape(E, K),
                    np.asarray(rho_spatial, np.float32).reshape(E, K),
                    bep.freqs, bep.f0, bep.uvw, bep.cell, self.n_stations,
                    self.n_chunks, npix, n_poly=self.n_poly,
                    polytype=self.polytype,
                    imager_block_r=statics["imager_block_r"],
                    precision=self.precision)
                self._record_batched_influence_cost(
                    bep, result, rho, rho_spatial, npix, statics,
                    shards={AXIS_LANE: nl, AXIS_BASELINE: nb})
                return out
        with self._stage("influence", route="batched_vmap",
                         lanes=bep.n_envs, precision=self.precision):
            ops = self.batched_influence_operands(bep, result, rho,
                                                  rho_spatial)
            imgs = self.batched_influence_callable(bep.n_dirs, npix)(*ops)
            self._record_batched_influence_cost(bep, result, rho,
                                                rho_spatial, npix, statics,
                                                ops=ops)
            return imgs

    def _record_batched_influence_cost(self, bep, result, rho, rho_spatial,
                                       npix, statics, ops=None, shards=1):
        """Deferred cost event of the batched influence stage: the lanes'
        chain on one device (the composed route counts that single-device
        equivalent, its footprint divided by ``shards``), and the SKA-tier
        kernels' events."""
        if ops is None:
            ops = self.batched_influence_operands(bep, result, rho,
                                                  rho_spatial)
        residual, C, J, hadd = ops[:4]
        obs_costs.record_stage_cost(
            "influence", influence.influence_images_lanes, residual, C,
            J, hadd, bep.freqs, bep.uvw[:, None], bep.cell[:, None],
            defer=True, compute_dtype=self._imager_dtype(), shards=shards,
            n_stations=self.n_stations, n_chunks=self.n_chunks,
            npix=npix, **statics)
        self._record_kernel_costs(bep.n_dirs, npix, float(bep.cell[0]),
                                  statics)

    def image_sigmas_batched(self, bep: BatchedEpisode,
                             result: solver.SolveResult, npix=None):
        """Per-lane (sigma_data_img, sigma_res_img), each (E,): the std of
        the band-mean data and residual dirty images (the reward inputs),
        through the factored imager's matmuls over all lanes."""
        npix = npix or self.npix

        def img_std(V):
            imgs = imager.dirty_image_factored_sr(
                bep.uvw[:, None], imager.stokes_i_vis(V), bep.freqs,
                bep.cell[:, None], npix=npix)
            return torch.std(torch.mean(imgs, dim=1), dim=(-2, -1),
                             correction=0)

        with self._stage("sigmas", span="reward", route="batched_vmap"):
            return img_std(bep.V), img_std(result.residual)

    def noise_std_batched(self, V):
        """Per-lane :meth:`noise_std` of an (E, Nf, T, B, 2, 2, 2) batch."""
        sI = 0.5 * (V[..., 0, 0, :] + V[..., 1, 1, :])
        stds = torch.std(sI, dim=(-3, -2, -1), correction=0)
        return torch.sqrt(torch.mean(stds ** 2, dim=-1))

    def serve_signature(self, n_dirs, n_lanes, npix=None) -> dict:
        """The static signature of the batched solve and influence programs
        (the JAX backend's ``serve_signature``, same keys and values, so one
        backend gives one ``serve.export.sig_digest`` in both packages):
        every constructor knob that selects a different program, plus the
        lane, direction and image geometry.  The serving layer keys its
        program cache on it."""
        return {
            "n_stations": self.n_stations, "n_freqs": self.n_freqs,
            "n_times": self.n_times, "tdelta": self.tdelta,
            "n_poly": self.n_poly, "polytype": self.polytype,
            "lbfgs_iters": self.lbfgs_iters, "init_iters": self.init_iters,
            "K": int(n_dirs), "lanes": int(n_lanes),
            "npix": int(npix or self.npix), "precision": self.precision,
            "block_baselines": self.block_baselines,
            "imager_block_r": self.imager_block_r,
        }
