"""Synthetic open-loop load generator for the calibration service (the
port's copy of smartcal_tpu/serve/loadgen.py: the same tiers, pool draws
and accounting; the pool's episodes come from the port's
``new_calib_episode`` with ``prng`` keys, the JAX package's key stream).

OPEN loop: arrivals are a Poisson process at the offered rate,
independent of service progress — the generator never waits for a
response before submitting the next job, so queueing/shedding behavior
under overload is actually exercised (a closed loop self-throttles and
can never drive the server past saturation).

Episodes are pre-built (host-side sky draws are not the thing under
test) and cycled with a mixed direction-count/maxiter/rho profile, so
every batch the router packs is heterogeneous — the one-compile-serves-
every-mix property is load-tested, not just unit-tested.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import numpy as np

from smartcal_tpu_torch import prng
from smartcal_tpu_torch.obs import tracectx

from .router import Job, ShedError

# Serving backend scale presets (the "tier" kwargs a RadioBackend takes),
# the JAX package's; shared by the serve_calib, serve_fleet and
# serve_learn tools.
SERVE_TIERS = {
    # n_stations, n_freqs, n_times, tdelta, admm, lbfgs, init, npix
    "tiny": dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2,
                 admm_iters=2, lbfgs_iters=3, init_iters=5, npix=32),
    "small": dict(n_stations=10, n_freqs=2, n_times=8, tdelta=4,
                  admm_iters=5, lbfgs_iters=5, init_iters=10, npix=64),
    "medium": dict(n_stations=14, n_freqs=3, n_times=20, tdelta=10,
                   admm_iters=10, lbfgs_iters=8, init_iters=30, npix=128),
}


def build_job_pool(backend, M: int, n: int, seed: int = 0,
                   key0=None, heterogeneous: bool = True,
                   diffuse_frac: float = 0.25, mixed=None
                   ) -> List[Tuple[int, object]]:
    """``n`` pre-built (k, episode) pairs padded to M directions (the
    server's contract).

    ``heterogeneous`` (the default) draws a mixed pool: K uniform over
    [2, M] and a ``diffuse_frac`` fraction of diffuse-sky episodes;
    ``heterogeneous=False`` keeps a deterministic K cycle over point-source
    skies.  ``mixed`` is the older name of the same knob; when given it
    wins.  ``key0`` is a ``prng`` key (default ``PRNGKey(seed)``)."""
    if mixed is not None:
        heterogeneous = bool(mixed)
    key = prng.PRNGKey(seed) if key0 is None else key0
    rng = np.random.default_rng(seed)
    pool = []
    for i in range(n):
        key, k = prng.split(key)
        if heterogeneous:
            kdirs = int(rng.integers(2, M + 1))
            diffuse = bool(rng.random() < diffuse_frac)
        else:
            kdirs = 2 + i % max(1, M - 1)
            diffuse = False
        ep, _ = backend.new_calib_episode(k, kdirs, M, diffuse=diffuse)
        pool.append((kdirs, ep))
    return pool


class OpenLoopLoadGen:
    """Submit Poisson arrivals at ``rate`` jobs/s for ``duration_s``,
    then wait for the tail and summarize.  Shed jobs count against the
    offered rate (they are the overload signal, not an error).

    Every submitted job lands in EXACTLY one bucket of the summary —
    ``completed`` (of which ``deadline_missed`` is the served-late
    subset), ``shed`` (sync at submit OR async: a fleet router losing a
    job's replica post-admission sheds it through the future with the
    same structured :class:`ShedError`), or ``failed`` (any other
    exception / drain timeout) — and the per-reason ``shed_reasons``
    sum to ``shed``.

    ``pick="random"`` (default) draws pool entries uniformly; ``"cycle"``
    walks the pool in order."""

    def __init__(self, server, pool, rate: float, duration_s: float,
                 seed: int = 0, deadline_s: Optional[float] = None,
                 maxiter_choices=(None,), pick: str = "random"):
        if pick not in ("random", "cycle"):
            raise ValueError(f"pick must be 'random' or 'cycle', "
                             f"got {pick!r}")
        self.server = server
        self.pool = pool
        self.rate = float(rate)
        self.duration_s = float(duration_s)
        self.deadline_s = deadline_s
        self.maxiter_choices = tuple(maxiter_choices)
        self.pick = pick
        self._rng = np.random.default_rng(seed)

    def run(self, drain_timeout_s: float = 120.0) -> dict:
        rng = self._rng
        t_end = time.monotonic() + self.duration_s
        futures, submitted = [], 0
        shed_reasons: dict = {}
        i = 0
        next_t = time.monotonic()
        while True:
            next_t += rng.exponential(1.0 / self.rate)
            if next_t > t_end:
                break
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            if self.pick == "random":
                idx = int(rng.integers(len(self.pool)))
                mi = self.maxiter_choices[
                    int(rng.integers(len(self.maxiter_choices)))]
            else:
                idx = i % len(self.pool)
                mi = self.maxiter_choices[i % len(self.maxiter_choices)]
            entry = self.pool[idx]
            # lifecycle pools carry a third element: the pre-computed
            # flattened observation (serve.lifecycle.build_obs_pool) the
            # policy forward / replay tee consume
            kdirs, ep = entry[0], entry[1]
            obs_vec = entry[2] if len(entry) > 2 else None
            rho = None
            if rng.random() < 0.5:       # half pinned-rho, half default/policy
                rho = np.exp(rng.uniform(np.log(0.1), np.log(10.0),
                                         kdirs)).astype(np.float32)
            job = Job(episode=ep, k=kdirs, rho=rho, maxiter=mi,
                      deadline_s=self.deadline_s, obs_vec=obs_vec,
                      trace=tracectx.new_root_carrier())
            submitted += 1
            i += 1
            try:
                futures.append(self.server.submit(job))
            except ShedError as e:
                shed_reasons[e.reason] = shed_reasons.get(e.reason, 0) + 1
        t0_wall = time.monotonic()
        results = []
        failed = 0
        for fut in futures:
            remaining = drain_timeout_s - (time.monotonic() - t0_wall)
            try:
                results.append(fut.result(timeout=max(0.1, remaining)))
            except ShedError as e:       # async shed (post-admission loss)
                shed_reasons[e.reason] = shed_reasons.get(e.reason, 0) + 1
            except Exception:            # failed / drain-timed-out job
                failed += 1
        return self.summarize(submitted, sum(shed_reasons.values()),
                              results, shed_reasons=shed_reasons,
                              failed=failed)

    def summarize(self, submitted: int, shed: int, results,
                  shed_reasons: Optional[dict] = None,
                  failed: int = 0) -> dict:
        # deadline misses are the served-LATE subset of completed jobs:
        # disjoint from sheds by construction (a shed job never serves)
        deadline_missed = int(sum(1 for r in results
                                  if getattr(r, "deadline_miss", False)))
        out = {"offered_rate": self.rate, "duration_s": self.duration_s,
               "submitted": submitted, "shed": shed,
               "shed_reasons": dict(shed_reasons or {}),
               "failed": int(failed),
               "completed": len(results),
               "deadline_missed": deadline_missed,
               "accounted": shed + int(failed) + len(results),
               "shed_rate": round(shed / max(1, submitted), 4)}
        if results:
            totals = np.asarray([r.total_s for r in results])
            waits = np.asarray([r.queue_wait_s for r in results])
            span = self.duration_s + float(totals.max())
            out.update({
                "achieved_jobs_s": round(len(results) / span, 3),
                "latency_p50_s": round(float(np.percentile(totals, 50)), 4),
                "latency_p99_s": round(float(np.percentile(totals, 99)), 4),
                "queue_wait_p50_s": round(float(np.percentile(waits, 50)),
                                          4),
                "queue_wait_p99_s": round(float(np.percentile(waits, 99)),
                                          4),
                "degraded": int(sum(1 for r in results if r.degraded)),
            })
        return out
