"""Request router: bounded admission + deadline-aware micro-batching (the
port's copy of smartcal_tpu/serve/router.py, same semantics).

Incoming calibration jobs are heterogeneous — different direction
counts K, per-direction rho, ADMM iteration budgets — but every one of
those is an operand of the batched solve, not a property of the program,
so any mix packs into the same warmed program.  The router's job is
purely temporal: admit or shed (bounded queue — the overload half of the
circuit breaker), then gather admitted jobs into lane-sized batches
under a flush policy:

* FULL LANES — a batch of ``lanes`` jobs dispatches immediately;
* MAX WAIT — the first job of a batch never waits longer than
  ``max_wait_s`` for company;
* DEADLINE PULL — a job with an SLO deadline pulls the flush earlier,
  leaving (estimated) service time before its deadline.  The estimate
  is an EWMA of observed batch service times, fed back by the server.

Shed decisions are STRUCTURED: a ``serve_shed`` event (+ counter) with
the reason, never a silent drop — load generators and the SLO report
count them against the offered rate.
"""

from __future__ import annotations

import dataclasses
import itertools
import queue
import threading
import time
from concurrent.futures import Future
from typing import Any, List, Optional

import numpy as np

from smartcal_tpu_torch import obs

_ids = itertools.count()


class ShedError(RuntimeError):
    """A job the server refused to admit (queue full / circuit open)."""

    def __init__(self, reason: str, depth: Optional[int] = None):
        super().__init__(f"job shed: {reason}"
                         + (f" (queue depth {depth})"
                            if depth is not None else ""))
        self.reason = reason
        self.depth = depth


@dataclasses.dataclass
class Job:
    """One calibration request.

    ``episode`` is a port ``envs.radio.Episode`` padded to the server's M
    directions; ``k`` is the live direction count (the mask length).
    ``rho``/``rho_spatial`` are (k,) or None — None asks the policy (or
    the server default) to pick.  ``maxiter`` overrides the ADMM
    iteration budget (an operand, so any mix shares the program).
    ``deadline_s`` is the SLO budget from submission.  ``obs_vec`` is an
    optional flattened observation for the policy forward."""

    episode: Any
    k: int
    rho: Optional[np.ndarray] = None
    rho_spatial: Optional[np.ndarray] = None
    maxiter: Optional[int] = None
    deadline_s: Optional[float] = None
    obs_vec: Optional[np.ndarray] = None
    warm: bool = False              # warmup probe: excluded from SLO stats
    job_id: int = dataclasses.field(default_factory=lambda: next(_ids))
    t_submit: float = dataclasses.field(default_factory=time.monotonic)
    future: Future = dataclasses.field(default_factory=Future)
    # times the fleet router re-dispatched this job after losing its
    # replica mid-flight (serve.fleet; bounded by max_requeues)
    requeues: int = 0
    # W3C-style trace carrier ({"trace": ..., "span": ...}) minted at
    # fleet admission (obs/tracectx.py): crosses the process boundary
    # in the job payload so replica-side events join the request's tree
    trace: Optional[dict] = None
    # policy version the server held when this job was ADMITTED
    # (stamped in CalibServer.submit).  A hot-swap can land between
    # admission and execution, so the serve_request event reports this
    # alongside the version that actually acted — never silently just
    # the new one.  None until a versioned server stamps it.
    version_admitted: Optional[int] = None


@dataclasses.dataclass
class JobResult:
    """What a resolved job future carries back to the client."""

    job_id: int
    lane: int
    batch_id: int
    sigma_res: float
    sigma_data_img: float
    sigma_res_img: float
    img_std: float
    degraded: bool
    queue_wait_s: float
    service_s: float
    total_s: float
    # served past its SLO deadline (completed anyway — deadline misses
    # and sheds are DISJOINT populations in the load-gen accounting)
    deadline_miss: bool = False


class MicroBatcher:
    """Bounded admission queue + the flush policy above.  Thread-safe:
    any number of submitter threads, one batch-worker consumer."""

    def __init__(self, lanes: int, max_wait_s: float = 0.05,
                 max_queue: int = 64, service_est_s: float = 0.5):
        self.lanes = int(lanes)
        self.max_wait_s = float(max_wait_s)
        self._jobs: "queue.Queue[Job]" = queue.Queue(
            maxsize=max(1, int(max_queue)))
        self._lock = threading.Lock()
        self._accepted = 0
        self._shed = 0
        self._service_est_s = float(service_est_s)

    # -- submitter side ----------------------------------------------------
    def submit(self, job: Job) -> Future:
        """Admit ``job`` (returns its future) or raise :class:`ShedError`
        with a structured reject event when the bounded queue is full."""
        try:
            self._jobs.put_nowait(job)
        except queue.Full:
            depth = self._jobs.qsize()
            with self._lock:
                self._shed += 1
            obs.counter_add("serve_shed")
            obs.note_shed()             # flight recorder: burst detection
            rl = obs.active()
            if rl is not None:
                rl.log("serve_shed", job_id=job.job_id, reason="queue_full",
                       depth=depth)
            raise ShedError("queue_full", depth=depth) from None
        with self._lock:
            self._accepted += 1
        obs.counter_add("serve_admitted")
        obs.gauge_set("serve_queue_depth", self._jobs.qsize())
        return job.future

    # -- worker side -------------------------------------------------------
    def next_batch(self, timeout: float = 0.2) -> List[Job]:
        """Block up to ``timeout`` for a first job, then gather until the
        flush policy fires.  Returns [] on an idle tick."""
        try:
            first = self._jobs.get(timeout=timeout)
        except queue.Empty:
            return []
        batch = [first]
        t0 = time.monotonic()
        while len(batch) < self.lanes:
            wait = self._flush_at(batch, t0) - time.monotonic()
            if wait <= 0:
                break
            try:
                batch.append(self._jobs.get(timeout=wait))
            except queue.Empty:
                break
        obs.gauge_set("serve_batch_lanes", len(batch))
        obs.gauge_set("serve_queue_depth", self._jobs.qsize())
        return batch

    def _flush_at(self, batch: List[Job], t0: float) -> float:
        """Monotonic instant this batch must dispatch: first-job max-wait,
        pulled earlier by any member's deadline minus the service
        estimate (never hold a job past the slack its SLO leaves)."""
        flush = t0 + self.max_wait_s
        est = self.service_estimate_s()
        for j in batch:
            if j.deadline_s is not None:
                flush = min(flush, j.t_submit + j.deadline_s - est)
        return flush

    def note_service_time(self, seconds: float) -> None:
        """Feed one observed batch service time into the EWMA the
        deadline pull reads (called by the server per batch)."""
        with self._lock:
            self._service_est_s += 0.3 * (float(seconds)
                                          - self._service_est_s)

    def service_estimate_s(self) -> float:
        with self._lock:
            return self._service_est_s

    def depth(self) -> int:
        return self._jobs.qsize()

    def stats(self) -> dict:
        with self._lock:
            return {"accepted": self._accepted, "shed": self._shed,
                    "service_est_s": round(self._service_est_s, 4)}

    def drain(self) -> List[Job]:
        """Remove and return every queued job (shutdown: fail them
        explicitly rather than stranding their futures)."""
        out = []
        while True:
            try:
                out.append(self._jobs.get_nowait())
            except queue.Empty:
                return out
