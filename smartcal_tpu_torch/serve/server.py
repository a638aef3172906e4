"""CalibServer: calibration as a service over the batched substrate (the
port's counterpart of smartcal_tpu/serve/server.py, same API, events,
spans and counters).

One persistent ``BatchedEpisode`` of ``lanes`` lanes is the serving buffer:
each micro-batch splices its jobs' episodes into lanes
(``RadioBackend.splice_episode``, in place on the device), then runs the
(policy ->) solve -> influence -> sigma programs warmed at ``warmup``.
Per-request K, rho and maxiter are operands of those programs, so every
request mix rides them: the policy is one ``torch.export`` program with the
weights as an operand, and the solve program owns one quartic line search
per lane count whose CUDA graph is captured at warmup and replayed by every
batch after it (``serve/export.py``).  A warmed server's batch path records
no compile event: no nvcc build, no graph capture.

Supervision is the port's ``runtime/supervisor.Fleet`` as the circuit
breaker:

* the batch worker runs as a 1-slot supervised Fleet: a crash fails the
  in-flight jobs' futures with a structured ``serve_batch_failed`` event
  and restarts the worker with backoff;
* a slot past ``max_restarts`` opens the circuit: ``submit`` sheds with
  ``ShedError("circuit_open")``;
* overload sheds at the bounded admission queue (``router.MicroBatcher``).

A non-finite batched lane is re-routed through the sequential robust
``calibrate`` (``solve_admm_safe``'s ladder) and marked ``degraded``
instead of failing the batch.

Threads on one card: the batch worker and the breaker loop each launch on
a CUDA stream of their own (as the fleet's thread actors do), so the
sentinel's replay on the breaker thread, which captures its own line-search
graph (under ``cal/solver._CAPTURE_LOCK``), never meets the worker's
launches on a shared legacy stream.  The sentinel's and the degraded-lane
rescue's solves are per-episode solves that capture per solve, as every
route but the serving one does; their compile events are also counted
apart, as ``serve_oracle_compile_events``.

Telemetry is the obs stack: spans ``serve_batch`` / ``serve_pack`` /
``serve_policy`` / ``serve_solve`` / ``serve_influence`` / ``serve_sigma``,
a ``serve_request`` event per job (queue wait / service / total),
queue-depth and batch-fill gauges, shed / admit / compile counters.

Numerics sentinel (``sentinel_every`` > 0): every Nth batch snapshots one
sampled non-warm lane (latest wins) and the breaker loop replays it through
the sequential oracle (``_oracle_result``: ``calibrate``, ``influence_image``
and the DFT-kernel images) off the hot path, emitting a ``numerics_drift``
event with per-stage relative errors against the bf16 band.  Drift beyond
the band feeds a :class:`~smartcal_tpu_torch.obs.slo.SloBurnDetector`
(stages as "replicas"), so numeric drift gets the same burn-rate alerting
and flight-recorder dump as latency.
"""

import contextlib
import hashlib
import threading
import time
from typing import Optional

import numpy as np
import torch

from smartcal_tpu_torch import obs, prng
from smartcal_tpu_torch.envs import calib as calib_env
from smartcal_tpu_torch.obs import tracectx
from smartcal_tpu_torch.runtime import faults as rt_faults
from smartcal_tpu_torch.runtime import supervisor

from .export import ExportCache, enable_compile_cache, prime_backend_kernels
from .router import Job, JobResult, MicroBatcher, ShedError


def _event(name: str, **fields) -> None:
    rl = obs.active()
    if rl is not None:
        rl.log(name, **fields)


def _np(x) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


#: Sentinel-checked stages, in the SloBurnDetector "replica" index order
#: used to localize which stage is drifting.
SENTINEL_STAGES = ("solve", "influence", "sigma")

#: compile-event counters read around the oracle route
_COMPILE_KEYS = ("compile_events", "compile_events:nvcc",
                 "compile_events:cuda_graph", "compile_secs")


class _PolicyHeads(torch.nn.Module):
    """The exported policy program: ``rl/sac.policy_heads`` of a weightless
    template of the actor, the weights an operand (a tuple in ``names``
    order, ``torch.func.functional_call``)."""

    def __init__(self, cfg, names):
        super().__init__()
        from smartcal_tpu_torch.rl import sac

        # not a registered submodule: the program owns no weights
        object.__setattr__(self, "_actor",
                           sac.build_nets(cfg, device="meta")[0])
        self.cfg = cfg
        self.names = tuple(names)

    def forward(self, params, obs_vec):
        from smartcal_tpu_torch.rl import sac

        p = dict(zip(self.names, params))
        return sac.policy_heads(
            self.cfg, lambda o: torch.func.functional_call(self._actor, p,
                                                           (o,)),
            obs_vec)


class CalibServer:
    """See module doc.  Lifecycle::

        srv = CalibServer(backend, M=5, lanes=8, cache_dir=...)
        srv.warmup(seed=0)      # programs from the cache (or built) + a batch
        srv.start()             # supervised batch worker + breaker loop
        fut = srv.submit(Job(episode=ep, k=3, maxiter=12))
        res = fut.result(timeout=...)   # JobResult
        srv.stop()

    ``policy`` (optional) is ``(SACConfig, actor_params)``, ``actor_params``
    the actor's weights by name (its ``state_dict``, tensors or host
    arrays): jobs with ``rho=None`` get their regularization from the
    exported deterministic actor forward on their ``obs_vec``.
    ``compile_cache`` points the nvcc build directory at
    ``<cache_dir>/nvcc`` (process-wide)."""

    def __init__(self, backend, M: int, lanes: int, cache_dir: str,
                 policy: Optional[tuple] = None, npix: Optional[int] = None,
                 max_wait_s: float = 0.05, max_queue: int = 64,
                 heartbeat_timeout: float = 300.0, max_restarts: int = 3,
                 backoff: Optional[supervisor.BackoffPolicy] = None,
                 poll_s: float = 0.05, idle_tick_s: float = 0.2,
                 compile_cache: bool = True, sentinel_every: int = 0,
                 sentinel_band: Optional[float] = None,
                 sentinel_slo: Optional[obs.SloBurnDetector] = None,
                 transition_sink=None):
        self.backend = backend
        self.M = int(M)
        self.lanes = int(lanes)
        self.npix = int(npix or backend.npix)
        self.cache_dir = cache_dir
        self.cache = ExportCache(f"{cache_dir}/programs")
        if compile_cache:
            # the nvcc half of the warm restart: the kernels built by the
            # first boot are loaded, not built, by the next
            enable_compile_cache(f"{cache_dir}/nvcc")
        self.batcher = MicroBatcher(lanes, max_wait_s=max_wait_s,
                                    max_queue=max_queue)
        self._policy = None if policy is None else (
            policy[0], self._device_params(policy[1]))
        # monotone policy snapshot version: 0 = the warmup program;
        # swap_policy bumps it with the params/program under _lock, so the
        # batch worker's per-batch snapshot is consistent
        self._policy_version = 0
        # optional lifecycle tee: callable(list[transition dict]) invoked
        # per batch (batch-worker thread, after the futures resolve) with
        # the one-step transitions of every non-warm obs_vec-bearing job
        self._transition_sink = transition_sink
        self._base_sig = None           # serve_signature, set at warmup
        self._lock = threading.Lock()
        self._programs: dict = {}       # latest-program table
        self._circuit_open = False
        self._stats = {"batches": 0, "served": 0, "degraded": 0,
                       "failed": 0, "deadline_miss": 0, "swaps": 0}
        self._bep = None                # worker-owned serving buffer
        self._batch_id = 0
        self._fleet: Optional[supervisor.Fleet] = None
        self._sup: Optional[threading.Thread] = None
        self._stop_ev = threading.Event()
        self._hb = float(heartbeat_timeout)
        self._max_restarts = int(max_restarts)
        self._backoff = backoff
        self._poll_s = float(poll_s)
        self._idle_tick_s = float(idle_tick_s)
        self._local = threading.local()     # per-thread CUDA stream
        # numerics sentinel: 0 disables sampling entirely
        self.sentinel_every = int(sentinel_every)
        self.sentinel_band = float(obs.BF16_REL_BAND
                                   if sentinel_band is None
                                   else sentinel_band)
        self._sentinel_pending: Optional[dict] = None  # latest-wins
        self._sentinel_stats = {"sampled": 0, "replayed": 0, "drift": 0}
        # stages observe as "replicas" so a burn localizes to the drifting
        # stage; the band is the p99 target, so burn = rel_err / band and
        # one out-of-band replay can fire
        self._sentinel_slo = sentinel_slo or obs.SloBurnDetector(
            p99_target_s=self.sentinel_band, shed_target=1.0,
            fast_window_s=30.0, slow_window_s=120.0,
            burn_threshold=1.0, clear_threshold=1.0, sustain_s=0.0,
            clear_sustain_s=30.0, min_samples=len(SENTINEL_STAGES))

    # -- device helpers -----------------------------------------------------
    @property
    def device(self) -> torch.device:
        return torch.device(getattr(self.backend, "device", "cpu"))

    def _device_params(self, params) -> dict:
        """A copy of the weights by name as tensors on the backend's device
        (fleet weight frames carry host numpy; a learner updates its own
        tensors in place), complete when this returns: the batch worker
        reads it from its own stream."""
        dev = self.device
        out = {k: (v.detach() if isinstance(v, torch.Tensor)
                   else torch.as_tensor(np.asarray(v))).to(dev).clone()
               for k, v in params.items()}
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return out

    def _thread_stream(self):
        """This thread's own CUDA stream as a context (none on the CPU):
        the worker and the breaker thread never share the legacy stream."""
        dev = self.device
        if dev.type != "cuda":
            return contextlib.nullcontext()
        st = getattr(self._local, "stream", None)
        if st is None:
            st = self._local.stream = torch.cuda.Stream(dev)
        return torch.cuda.stream(st)

    def _kernels(self) -> list:
        """The CUDA kernels the server's routes run: the DFT imager of the
        oracle's images, and at the SKA tier the blocked Hessian and the
        large-tier factored imager of the influence chain."""
        names = ["dft_imager"]
        statics = self.backend._influence_statics(self.npix)
        if statics.get("block_baselines"):
            names.append("hessian_blocks")
        if statics.get("imager_block_r"):
            names.append("factored_imager")
        return names

    # -- warmup ---------------------------------------------------------------
    def warmup(self, seed: int = 0) -> dict:
        """Load (or build) the program triple, build the kernels of the
        server's routes and run one full warmup batch through the request
        path; after this returns, the batch path compiles nothing.  Returns
        the timing/counter summary that the restart measurement compares
        cold vs warm."""
        t0 = time.time()
        c0 = obs.counters_snapshot()
        dev = self.device
        with obs.span("serve_warmup", lanes=self.lanes):
            prime_backend_kernels(dev)
            if dev.type == "cuda":
                from smartcal_tpu_torch.ops import build
                for name in self._kernels():
                    build.load(name)
            key = prng.PRNGKey(seed)
            eps = []
            for _ in range(self.lanes):
                key, k = prng.split(key)
                ep, _ = self.backend.new_calib_episode(k, self.M, self.M)
                eps.append(ep)
            self._bep = self.backend.stack_episodes(eps)
            E, M = self.lanes, self.M
            rho = np.ones((E, M), np.float32)
            alpha = np.zeros((E, M), np.float32)
            base = self.backend.serve_signature(M, E, self.npix)
            self._base_sig = dict(base)   # swap_policy's re-export key

            solve = self.cache.prepare(
                dict(base, kind="solve"),
                self.backend.batched_solve_callable(M))
            res = solve(*self.backend.batched_solve_operands(self._bep, rho))
            influence = self.cache.prepare(
                dict(base, kind="influence"),
                self.backend.batched_influence_callable(M, self.npix))
            imgs = influence(*self.backend.batched_influence_operands(
                self._bep, res, rho, alpha))
            progs = {"solve": solve, "influence": influence}
            if self._policy is not None:
                progs["policy"] = self._export_policy(base)
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()
            del res, imgs
            with self._lock:
                self._programs = progs
            # one full batch through the request path (splice, lane
            # params, sigmas) so steady state compiles nothing; the warm
            # jobs are tagged out of the SLO stats
            warm_jobs = [
                Job(episode=ep, k=self.M,
                    rho=np.ones(self.M, np.float32),
                    maxiter=int(self.backend.admm_iters), warm=True)
                for ep in eps]
            self._process_batch(warm_jobs)
            for job in warm_jobs:
                job.future.result()
        c1 = obs.counters_snapshot()
        summary = {
            "wall_s": round(time.time() - t0, 3),
            "sources": {k: p.source for k, p in progs.items()},
            **{k: c1.get(k, 0.0) - c0.get(k, 0.0)
               for k in ("export_cache_hit", "export_cache_miss",
                         "export_cache_prepared_hit",
                         "export_cache_prepared_miss") + _COMPILE_KEYS},
        }
        _event("serve_warmup", **summary)
        return summary

    def _obs_dim(self) -> int:
        return self.npix * self.npix + (self.M + 1) * 7

    def _policy_sig(self, base_sig: dict, version: int) -> dict:
        """The policy program's cache signature, keyed on (version,
        serve_signature): every published version is a distinct,
        restartable ExportCache entry."""
        cfg, _ = self._policy
        return dict(base_sig, kind="policy", obs_dim=self._obs_dim(),
                    act_dim=2 * self.M, heads=True, version=int(version),
                    cfg_digest=hashlib.sha256(
                        repr(cfg).encode()).hexdigest()[:12])

    def _export_policy(self, base_sig: dict):
        cfg, actor_params = self._policy
        names = sorted(actor_params)
        sig = self._policy_sig(base_sig, self._policy_version)
        zeros = torch.zeros((self.lanes, self._obs_dim()),
                            device=self.device)
        prog = self.cache.get_or_build(
            sig, _PolicyHeads(cfg, names),
            (tuple(actor_params[n] for n in names), zeros))
        self._policy_forward(prog, actor_params, zeros)   # first dispatch
        return prog

    def _policy_forward(self, prog, actor_params, ovec):
        """(act, mu, logsigma) of the policy program as host arrays."""
        names = sorted(actor_params)
        o = torch.as_tensor(np.asarray(ovec, np.float32)
                            if not isinstance(ovec, torch.Tensor) else ovec,
                            device=self.device)
        out = prog(tuple(actor_params[n] for n in names), o)
        return tuple(_np(a) for a in out)

    def _program(self, kind: str):
        with self._lock:
            prog = self._programs.get(kind)
        if prog is None:
            raise RuntimeError(f"no {kind!r} program — call warmup() first")
        return prog

    # -- zero-downtime policy hot-swap --------------------------------------
    @property
    def policy_version(self) -> int:
        with self._lock:
            return self._policy_version

    def swap_policy(self, actor_params, version: int, program=None) -> dict:
        """Install a new policy snapshot between micro-batch flushes.

        The batch worker reads ONE consistent (params, program, version)
        snapshot per batch under ``_lock``, so this swap (a few assignments
        under the same lock) never tears a batch; requests admitted under
        version V that execute after the swap report both versions in their
        ``serve_request`` event.  ``program=None`` keeps the installed
        program: it takes the weights as an operand, so one program serves
        every version; the swap costs one forward with the new weights
        (paid here, not on the serving path) plus the locked pointer flip.
        Publication through the ExportCache is the publisher's job
        (:class:`~smartcal_tpu_torch.serve.lifecycle.PolicyPublisher`)."""
        if self._policy is None:
            raise RuntimeError("swap_policy on a server with no policy "
                               "armed")
        t0 = time.monotonic()
        cfg, _ = self._policy
        if program is None:
            with self._lock:
                program = self._programs.get("policy")
            if program is None:
                raise RuntimeError("no policy program — call warmup() "
                                   "first")
        params = self._device_params(actor_params)
        with self._thread_stream():
            self._policy_forward(program, params,
                                 np.zeros((self.lanes, self._obs_dim()),
                                          np.float32))
        with self._lock:
            old = self._policy_version
            self._policy = (cfg, params)
            self._policy_version = int(version)
            self._programs["policy"] = program
            self._stats["swaps"] += 1
        swap_s = time.monotonic() - t0
        obs.counter_add("policy_swaps")
        obs.gauge_set("policy_version", int(version))
        _event("policy_swap", version=int(version), version_prev=old,
               swap_s=round(swap_s, 6))
        return {"version": int(version), "version_prev": old,
                "swap_s": swap_s}

    # -- request path ---------------------------------------------------------
    @property
    def circuit_open(self) -> bool:
        with self._lock:
            return self._circuit_open

    def submit(self, job: Job):
        """Admit a job (returns its future) or shed: circuit open / stopped
        server / queue full raise :class:`ShedError` with a structured
        event."""
        if self._stop_ev.is_set() and self._fleet is None:
            # a stopped server has no worker: admitting would strand the
            # job in the batcher forever (start() re-opens)
            obs.counter_add("serve_shed")
            _event("serve_shed", job_id=job.job_id, reason="shutdown")
            raise ShedError("shutdown")
        if self.circuit_open:
            obs.counter_add("serve_shed")
            obs.note_shed()
            _event("serve_shed", job_id=job.job_id, reason="circuit_open")
            raise ShedError("circuit_open")
        if job.episode.n_dirs != self.M:
            raise ValueError(f"job episode padded to {job.episode.n_dirs} "
                             f"directions, server expects M={self.M}")
        if not 1 <= job.k <= self.M:
            raise ValueError(f"job.k={job.k} outside [1, M={self.M}]")
        if self._policy is not None and job.version_admitted is None:
            # remember which snapshot was live at admission: a hot-swap can
            # land before execution
            job.version_admitted = self.policy_version
        return self.batcher.submit(job)

    # -- batch execution ------------------------------------------------------
    def _lane_params(self, batch, batch_id: int = 0, policy=None,
                     policy_prog=None):
        """(rho, mask, alpha, iters, heads) lane arrays for this batch.
        Idle lanes re-run their stale (valid) episode under the default rho
        (the program's lane count is fixed).  Jobs with rho=None and an
        armed policy get theirs from the exported actor forward.

        ``policy``/``policy_prog`` are the per-batch acting snapshot taken
        under ``_lock`` by ``_process_batch``.  ``heads`` is the host
        ``(act, mu, logsigma)`` triple of the forward (None when it did not
        run): the behavior-logp source of the replay tee.  With a
        transition sink armed, the forward also runs for pinned-rho lanes
        carrying an obs_vec so their off-policy actions are scored under
        the same snapshot."""
        E, M = self.lanes, self.M
        rho = np.ones((E, M), np.float32)
        mask = np.zeros((E, M), np.float32)
        alpha = np.zeros((E, M), np.float32)
        iters = np.full((E,), self.backend.admm_iters, np.int32)
        mask[:, :2] = 1.0               # idle lanes: 2 live dirs, rho=1
        want_policy = []
        want_heads = []
        for lane, job in enumerate(batch):
            mask[lane] = 0.0
            mask[lane, :job.k] = 1.0
            if job.maxiter is not None:
                iters[lane] = int(job.maxiter)
            if job.rho is not None:
                rho[lane, :job.k] = np.asarray(job.rho,
                                               np.float32)[:job.k]
                if job.rho_spatial is not None:
                    alpha[lane, :job.k] = np.asarray(job.rho_spatial,
                                                     np.float32)[:job.k]
                if (policy is not None and self._transition_sink is not None
                        and not job.warm and job.obs_vec is not None):
                    want_heads.append(lane)
            elif policy is not None:
                want_policy.append(lane)
        heads = None
        if want_policy or want_heads:
            with obs.span("serve_policy", lanes=len(want_policy),
                          batch=batch_id):
                ovec = np.zeros((E, self._obs_dim()), np.float32)
                for lane in want_policy + want_heads:
                    if batch[lane].obs_vec is not None:
                        ovec[lane] = np.asarray(batch[lane].obs_vec,
                                                np.float32)
                _, actor_params = policy
                prog = (policy_prog if policy_prog is not None
                        else self._program("policy"))
                act, mu, logsigma = self._policy_forward(prog, actor_params,
                                                         ovec)
                heads = (act, mu, logsigma)
                lo, hi = calib_env.LOW, calib_env.HIGH
                mapped = act * (hi - lo) / 2 + (hi + lo) / 2
                for lane in want_policy:
                    k = batch[lane].k
                    rho[lane, :k] = np.clip(mapped[lane, :k], lo, hi)
                    alpha[lane, :k] = np.clip(
                        mapped[lane, M:M + k], lo, hi)
        return rho, mask, alpha, iters, heads

    def _behavior_logp(self, job, lane, rho, alpha, heads):
        """(log pi(a|s), action) of the action actually served on ``lane``,
        under the acting snapshot's distribution heads.  Policy lanes score
        their own action; pinned-rho lanes score the pinned values mapped
        back to unit coordinates (``envs/calib._to_unit``), the off-policy
        data the learner's IMPACT ratio corrects for.  Entries beyond
        ``job.k`` keep the policy's own output (ratio-neutral padding)."""
        from smartcal_tpu_torch.rl.networks import tanh_gaussian_log_prob_np

        act_row, mu_row, ls_row = (h[lane] for h in heads)
        action = np.asarray(act_row, np.float32).copy()
        if job.rho is not None:
            k, M = job.k, self.M
            action[:k] = calib_env._to_unit(rho[lane, :k])
            action[M:M + k] = calib_env._to_unit(alpha[lane, :k])
            np.clip(action, -1.0, 1.0, out=action)
        lp = float(tanh_gaussian_log_prob_np(mu_row, ls_row, action))
        return lp, action

    def _oracle_result(self, episode, rho_row, mask_row, alpha_row, it):
        """Sequential re-solve of one lane: the ``solve_admm_safe`` ladder
        behind the per-episode ``calibrate`` route, then ``influence_image``
        and the DFT-kernel data and residual images.  Both the degraded-lane
        rescue and the numerics sentinel run through here.  Its compile
        events (the per-solve line-search captures, lever g) are counted
        apart, as ``serve_oracle_compile_events`` / ``serve_oracle_captures``
        / ``serve_oracle_capture_secs``."""
        c0 = obs.counters_snapshot()
        be = self.backend
        r = be.calibrate(episode, rho_row, mask=mask_row,
                         admm_iters=int(it))
        img = _np(be.influence_image(episode, r, rho_row, alpha_row,
                                     npix=self.npix))
        sig_d = float(np.std(_np(be.data_image(episode, npix=self.npix))))
        sig_r = float(np.std(_np(be.residual_image(episode, r,
                                                   npix=self.npix))))
        c1 = obs.counters_snapshot()
        d = {k: c1.get(k, 0.0) - c0.get(k, 0.0) for k in _COMPILE_KEYS}
        if d["compile_events"]:
            obs.counter_add("serve_oracle_compile_events",
                            d["compile_events"])
            obs.counter_add("serve_oracle_captures",
                            d["compile_events:cuda_graph"])
            obs.counter_add("serve_oracle_capture_secs", d["compile_secs"])
        return (float(_np(r.sigma_res)), sig_d, sig_r, float(np.std(img)))

    def _process_batch(self, batch) -> int:
        t_start = time.monotonic()
        E = self.lanes
        be = self.backend
        with self._lock:
            self._batch_id += 1
            batch_id = self._batch_id
            # ONE consistent acting snapshot per batch: params, program and
            # version move together under the lock
            policy = self._policy
            ver_acted = self._policy_version
            policy_prog = self._programs.get("policy")
        with obs.span("serve_batch", jobs=len(batch), batch=batch_id):
            # chaos hook: a planned serve_batch delay (runtime/faults)
            rt_faults.maybe_delay("serve_batch", batch_id)
            with obs.span("serve_pack", jobs=len(batch), batch=batch_id):
                for lane, job in enumerate(batch):
                    self._bep = be.splice_episode(self._bep, lane,
                                                  job.episode)
                rho, mask, alpha, iters, heads = self._lane_params(
                    batch, batch_id, policy, policy_prog)
            ops = be.batched_solve_operands(self._bep, rho, mask, iters)
            with obs.span("serve_solve", lanes=E, batch=batch_id):
                res = self._program("solve")(*ops)
                sig = _np(res.sigma_res)
            with obs.span("serve_influence", lanes=E, batch=batch_id):
                imgs = _np(self._program("influence")(
                    *be.batched_influence_operands(self._bep, res, rho,
                                                   alpha)))
            with obs.span("serve_sigma", batch=batch_id):
                sig_d, sig_r = (_np(a) for a in be.image_sigmas_batched(
                    self._bep, res, npix=self.npix))
        t_done = time.monotonic()
        service = t_done - t_start
        self.batcher.note_service_time(service)
        obs.gauge_set("serve_batch_fill", len(batch) / E)
        n_degraded = 0
        n_missed = 0
        sentinel_due = (self.sentinel_every > 0
                        and batch_id % self.sentinel_every == 0)
        sent_candidates = []
        transitions = []
        for lane, job in enumerate(batch):
            degraded = not np.isfinite(sig[lane])
            if degraded:
                n_degraded += 1
                obs.counter_add("serve_degraded")
                _event("serve_degraded", job_id=job.job_id, lane=lane,
                       batch=batch_id)
                vals = self._oracle_result(job.episode, rho[lane],
                                           mask[lane], alpha[lane],
                                           iters[lane])
            else:
                vals = (float(sig[lane]), float(sig_d[lane]),
                        float(sig_r[lane]), float(np.std(imgs[lane])))
                if sentinel_due and not job.warm:
                    sent_candidates.append((lane, job, vals))
            total = time.monotonic() - job.t_submit
            missed = (job.deadline_s is not None and total > job.deadline_s)
            if missed:
                n_missed += 1
                obs.counter_add("serve_deadline_miss")
            version_fields = {}
            behavior_logp = None
            if policy is not None:
                # both the admission-time and the acting versions ride the
                # event: a swap between them is visible
                version_fields = {
                    "version": ver_acted,
                    "version_admitted": (job.version_admitted
                                         if job.version_admitted is not None
                                         else ver_acted)}
                if heads is not None and job.obs_vec is not None \
                        and not job.warm:
                    behavior_logp = self._behavior_logp(
                        job, lane, rho, alpha, heads)
                    version_fields["behavior_logp"] = round(
                        behavior_logp[0], 6)
            result = JobResult(
                job_id=job.job_id, lane=lane, batch_id=batch_id,
                sigma_res=vals[0], sigma_data_img=vals[1],
                sigma_res_img=vals[2], img_std=vals[3], degraded=degraded,
                queue_wait_s=round(t_start - job.t_submit, 6),
                service_s=round(service, 6), total_s=round(total, 6),
                deadline_miss=missed)
            _event("serve_request", job_id=job.job_id, lane=lane,
                   batch=batch_id, k=job.k, maxiter=job.maxiter,
                   degraded=degraded, deadline_miss=missed,
                   queue_wait_s=result.queue_wait_s,
                   service_s=result.service_s, total_s=result.total_s,
                   sigma_res=vals[0], **version_fields,
                   **tracectx.child_fields(job.trace),
                   **({"warm": True} if job.warm else {}))
            obs.counter_add("serve_jobs_warm" if job.warm
                            else "serve_jobs")
            if (behavior_logp is not None
                    and self._transition_sink is not None):
                lp, action = behavior_logp
                ov = np.asarray(job.obs_vec, np.float32)
                reward = (vals[1] / max(vals[2], 1e-12)
                          + 1e-4 / (vals[3] + calib_env.EPS))
                transitions.append({
                    "state": ov, "action": action,
                    "reward": np.float32(reward), "new_state": ov,
                    "done": True,
                    "hint": np.zeros(2 * self.M, np.float32),
                    "version": np.int32(ver_acted),
                    "behavior_logp": np.float32(lp)})
            job.future.set_result(result)
        if transitions:
            try:
                self._transition_sink(transitions)
                obs.counter_add("serve_teed", len(transitions))
            except Exception as e:   # the tee must never fail the batch
                obs.counter_add("serve_tee_errors")
                _event("serve_tee_error", batch=batch_id, error=repr(e))
        snap = None
        if sent_candidates:
            # deterministic pick, latest-wins: the breaker loop replays at
            # its own pace; an unpolled snapshot is simply replaced
            lane, job, vals = sent_candidates[
                batch_id % len(sent_candidates)]
            snap = {"batch": batch_id, "lane": lane,
                    "job_id": job.job_id, "episode": job.episode,
                    "rho": rho[lane].copy(), "mask": mask[lane].copy(),
                    "alpha": alpha[lane].copy(),
                    "iters": int(iters[lane]),
                    # fused outputs in SENTINEL_STAGES order
                    "fused": {"solve": vals[0], "influence": vals[3],
                              "sigma": vals[2]}}
        with self._lock:
            self._stats["batches"] += 1
            self._stats["served"] += len(batch)
            self._stats["degraded"] += n_degraded
            self._stats["deadline_miss"] += n_missed
            if snap is not None:
                self._sentinel_pending = snap
                self._sentinel_stats["sampled"] += 1
        return len(batch)

    # -- numerics sentinel ----------------------------------------------------
    def sentinel_poll(self) -> Optional[dict]:
        """Replay the pending sampled lane through the sequential oracle and
        judge the fused outputs against the band.  Runs on the breaker
        thread (or a test's thread), never on the batch worker.  Returns
        the ``numerics_drift`` event dict when a replay happened, else None
        (still advancing the burn detector's hysteresis)."""
        with self._lock:
            snap = self._sentinel_pending
            self._sentinel_pending = None
            seq = self._sentinel_stats["replayed"]
        if snap is None:
            ev = self._sentinel_slo.evaluate()
            if ev is not None:
                self._emit_sentinel_burn(ev)
            return None
        with obs.span("serve_sentinel", batch=snap["batch"]), \
                self._thread_stream():
            oracle = self._oracle_result(
                snap["episode"], snap["rho"], snap["mask"],
                snap["alpha"], snap["iters"])
        oracle_by = {"solve": oracle[0], "influence": oracle[3],
                     "sigma": oracle[2]}
        rels = {}
        n_drift = 0
        for idx, stage in enumerate(SENTINEL_STAGES):
            # chaos hook: a planned perturbation (runtime/faults) shifts
            # the fused value, rehearsing out-of-band drift
            fused = rt_faults.maybe_perturb(
                f"sentinel_{stage}", seq, snap["fused"][stage])
            ref = oracle_by[stage]
            rel = abs(fused - ref) / max(abs(ref), 1e-12)
            rels[stage] = rel
            if rel > self.sentinel_band:
                n_drift += 1
            self._sentinel_slo.observe(rel, replica=idx)
        worst = max(rels, key=lambda s: rels[s])
        event = {"batch": snap["batch"], "lane": snap["lane"],
                 "job_id": snap["job_id"], "seq": seq,
                 "band": self.sentinel_band,
                 "worst_stage": worst, "drift": n_drift > 0,
                 **{f"rel_err_{s}": round(r, 9)
                    for s, r in rels.items()}}
        _event("numerics_drift", **event)
        obs.counter_add("sentinel_replays")
        if n_drift:
            obs.counter_add("sentinel_drift")
        with self._lock:
            self._sentinel_stats["replayed"] += 1
            self._sentinel_stats["drift"] += (1 if n_drift else 0)
        ev = self._sentinel_slo.evaluate()
        if ev is not None:
            self._emit_sentinel_burn(ev)
        return event

    def _emit_sentinel_burn(self, ev: dict) -> None:
        """A sentinel burn transition as a latency burn is surfaced: a
        structured ``slo_burn`` event (kind="numerics", the drifting stage
        named) plus a flight-recorder dump on firing."""
        worst = ev.get("worst_replica")
        stage = (SENTINEL_STAGES[int(worst)]
                 if worst is not None else None)
        _event("slo_burn", kind="numerics", stage=stage, **ev)
        obs.counter_add("sentinel_burn_transitions")
        if ev.get("state") == "firing":
            obs.flush_flight_recorder(
                "numerics_drift",
                {"stage": stage, "burn_fast": ev.get("burn_fast"),
                 "band": self.sentinel_band})

    def process_once(self, jobs, timeout: float = 0.0) -> int:
        """Synchronously pack and serve up to ``lanes`` queued/given jobs on
        the caller's thread (tests, warmup probes).  Only valid while the
        supervised worker is not running."""
        if self._fleet is not None:
            raise RuntimeError("process_once with a running fleet would "
                               "race the batch worker")
        for job in jobs:
            if self._policy is not None and job.version_admitted is None:
                job.version_admitted = self.policy_version
            self.batcher.submit(job)
        batch = self.batcher.next_batch(timeout=max(timeout, 0.001))
        return self._process_batch(batch) if batch else 0

    # -- supervised worker + breaker loop -------------------------------------
    def _work(self, actor_id, iteration, weights):
        batch = self.batcher.next_batch(timeout=self._idle_tick_s)
        if not batch:
            return {"served": 0}
        try:
            with self._thread_stream():
                n = self._process_batch(batch)
        except BaseException as e:    # noqa: BLE001 — death IS the signal
            _event("serve_batch_failed", jobs=[j.job_id for j in batch],
                   error=repr(e))
            with self._lock:
                self._stats["failed"] += len(batch)
            for job in batch:
                if not job.future.done():
                    job.future.set_exception(e)
            raise
        return {"served": n}

    def start(self) -> None:
        """Start the supervised batch worker and the breaker loop."""
        if self._fleet is not None:
            raise RuntimeError("server already started")
        self._stop_ev.clear()
        kw = {"name": "serve", "heartbeat_timeout": self._hb,
              "max_restarts": self._max_restarts, "queue_depth": 4}
        if self._backoff is not None:
            kw["backoff"] = self._backoff
        fleet = supervisor.Fleet(1, self._work, **kw)
        fleet.start(None)
        sup = threading.Thread(target=self._supervise, name="serve-breaker",
                               daemon=True)
        with self._lock:
            self._fleet = fleet
            self._sup = sup
        sup.start()

    def _supervise(self) -> None:
        """The breaker loop: poll the fleet (death detection, backoff
        restarts), drain its summary queue, open/close the circuit on slot
        failure, emit the queue-depth gauge, and run the sentinel."""
        while not self._stop_ev.wait(self._poll_s):
            fleet = self._fleet
            if fleet is None:
                return
            try:
                fleet.poll()
                # drain the worker's summary queue: an undrained bounded
                # queue back-pressures the batch worker to a halt
                fleet.collect(max_items=64, timeout=0.0)
                open_now = bool(fleet.failed_slots)
                with self._lock:
                    changed = open_now != self._circuit_open
                    self._circuit_open = open_now
                if changed:
                    obs.counter_add("serve_circuit_transitions")
                    _event("serve_circuit", open=open_now,
                           restarts=fleet.restarts_total())
                    if open_now:
                        obs.flush_flight_recorder(
                            "circuit_open",
                            {"restarts": fleet.restarts_total()})
                obs.gauge_set("serve_queue_depth", self.batcher.depth())
                if self.sentinel_every > 0:
                    self.sentinel_poll()
            except Exception as e:   # the breaker must outlive a bad pass
                obs.counter_add("serve_breaker_errors")
                _event("serve_breaker_error", error=repr(e))

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            sent = dict(self._sentinel_stats)
            ver = self._policy_version
        out.update(self.batcher.stats())
        out["circuit_open"] = self.circuit_open
        if self._policy is not None:
            out["policy_version"] = ver
        if self.sentinel_every > 0:
            out["sentinel"] = dict(sent,
                                   firing=self._sentinel_slo.firing)
        return out

    def stop(self, timeout: float = 10.0) -> None:
        """Stop the worker, fail any stranded queued jobs explicitly."""
        self._stop_ev.set()
        with self._lock:
            fleet, sup = self._fleet, self._sup
            self._fleet, self._sup = None, None
        if sup is not None:
            sup.join(timeout=timeout)
        if fleet is not None:
            fleet.stop(join=True, timeout=timeout)
        for job in self.batcher.drain():
            if not job.future.done():
                job.future.set_exception(ShedError("shutdown"))
