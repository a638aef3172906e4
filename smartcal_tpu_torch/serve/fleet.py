"""Replicated CalibServer fleet behind a deadline-aware front door (the
port's counterpart of smartcal_tpu/serve/fleet.py, same router, replica
protocol, events and counters).

One :class:`~smartcal_tpu_torch.serve.server.CalibServer` is one batch
worker.  This module scales the service horizontally: N replicas, each a
spawned OS process running its own ``CalibServer`` on the card (an H100
serves several processes; the ``spawn`` context, as a CUDA context must
never be forked), supervised with the process-actor machinery of
``runtime/supervisor`` transferred from actors to replicas: the framed
CRC-checked transport of :mod:`smartcal_tpu_torch.runtime.ipc` (byte for
byte the JAX package's frames), heartbeat supervision and backoff-restart
accounting through :class:`~smartcal_tpu_torch.runtime.supervisor.
RestartTracker`, behind a :class:`FleetRouter` front door doing
deadline-aware least-loaded dispatch on each replica's streamed queue-depth
and batch-fill gauges.

Every replica shares ONE on-disk program cache and nvcc build directory,
so replica N's cold start is every replica's warm start: it loads the
programs and kernel libraries replica 0 built (its line-search graph is
captured again at its own warmup).  :class:`AutoscalePolicy` spawns a
replica on sustained queue pressure and reaps one on sustained idle.

Failure domains are per replica, never fleet-wide:

* a replica crash costs only its in-flight jobs: the router reclaims that
  replica's pending table and re-dispatches each job (at most
  ``max_requeues`` times) to a survivor, shedding with a structured
  ``replica_lost`` reason only when no survivor can take it;
* a replica past ``max_restarts`` is marked failed (its circuit opens); the
  fleet sheds ``fleet_down`` only when no live replica remains, and
  ``fleet_saturated`` when every live replica's dispatch outbox is full.

Message vocabulary (framed via :mod:`~smartcal_tpu_torch.runtime.ipc`;
tuples, kind first):

* router -> replica: ``("job", payload_dict)``, ``("weights", {"version",
  "params"})`` (policy hot-swap publication, latest-wins per replica, see
  :meth:`FleetRouter.publish_policy`), ``("stop",)``
* replica -> router: ``("ready", warmup_summary)``, ``("beat", gauges)``,
  ``("result", job_id, result_dict)``, ``("job_shed", job_id, reason)``,
  ``("job_failed", job_id, repr)``, ``("error", repr)``

Job payloads carry the episode as host numpy (:func:`_episode_to_host`),
rebuilt on the replica's device; weight frames carry host numpy too.  One
machine: :meth:`FleetRouter.replica_host` maps every replica to host 0
(the replicas are processes of one host, not a ``parallel/multihost``
job).

The module imports nothing of the backend at import time: stub-server
replicas (tests) pay only the package and obs import, and the real server
factory (:func:`make_calib_server`) imports the backend, the agent and the
server inside the worker.
"""

import collections
import dataclasses
import json
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from smartcal_tpu_torch import obs
from smartcal_tpu_torch.obs import tracectx
from smartcal_tpu_torch.runtime import faults as rt_faults
from smartcal_tpu_torch.runtime import ipc
from smartcal_tpu_torch.runtime.backoff import BackoffPolicy
from smartcal_tpu_torch.runtime.supervisor import RestartTracker, _to_host

from .router import Job, JobResult, ShedError

# Job fields that cross the process boundary (future/warm stay local:
# the future is the parent-side handle, and warmup probes never route).
# ``trace`` is the W3C carrier minted at fleet admission — it crosses
# so replica-side events join the request's span tree.
_JOB_FIELDS = ("k", "rho", "rho_spatial", "maxiter", "deadline_s",
               "obs_vec", "job_id", "t_submit", "requeues", "trace")


def _event(name: str, **fields) -> None:
    rl = obs.active()
    if rl is not None:
        rl.log(name, **fields)


# ---------------------------------------------------------------------------
# worker side (runs inside each spawned replica process)
# ---------------------------------------------------------------------------

def make_calib_server(tier: dict, M: int, lanes: int, cache_dir: str,
                      policy_seed: Optional[int] = None,
                      max_wait_s: float = 0.05, max_queue: int = 64,
                      deadline_default_s: Optional[float] = None,
                      device: str = "cuda", **server_kw):
    """Picklable server factory for real replicas: builds a
    ``RadioBackend`` on ``device`` + ``CalibServer`` against the SHARED
    ``cache_dir`` (programs under ``programs/``, kernel libraries under
    ``nvcc/``, armed here before the process's first kernel load).
    ``tier`` is the backend kwargs dict (``SERVE_TIERS`` in
    :mod:`~smartcal_tpu_torch.serve.loadgen`)."""
    del deadline_default_s               # reserved for router-side SLOs
    from .export import enable_compile_cache

    enable_compile_cache(f"{cache_dir}/nvcc")
    from smartcal_tpu_torch.envs import radio

    backend = radio.RadioBackend(device=device, **tier)
    policy = None
    if policy_seed is not None:
        from smartcal_tpu_torch.rl import sac

        obs_dim = backend.npix * backend.npix + (M + 1) * 7
        agent = sac.SACAgent(
            sac.SACConfig(obs_dim=obs_dim, n_actions=2 * M),
            seed=policy_seed, name_prefix="fleet", device=backend.device)
        policy = (agent.cfg, dict(agent.state.actor.state_dict()))
    from .server import CalibServer

    return CalibServer(backend, M=M, lanes=lanes, cache_dir=cache_dir,
                       policy=policy, max_wait_s=max_wait_s,
                       max_queue=max_queue, **server_kw)


class SleepServer:
    """Stdlib-only replica server whose service is a timed sleep:
    ``lanes`` worker threads each hold one job for ``service_s``.

    This is the ROUTER-CAPACITY harness, not a solver: sleeps overlap
    perfectly across processes even on a one-core host, so a fleet of
    these measures the front door itself — dispatch + IPC + pending
    bookkeeping per job — as a jobs/s ceiling that real replicas can
    approach but never beat.  ``tools/serve_fleet.py --stub`` sweeps it
    next to the real-CalibServer fleet for exactly that comparison."""

    def __init__(self, lanes: int = 2, service_s: float = 0.05,
                 max_queue: int = 128):
        import queue as _queue

        self.lanes = int(lanes)
        self.service_s = float(service_s)
        self._q: "queue.Queue" = _queue.Queue(
            maxsize=max(1, int(max_queue)))
        self._stop = threading.Event()
        self._served = 0
        self._slock = threading.Lock()
        self._workers: List[threading.Thread] = []

        outer = self

        class _Batcher:
            def depth(self):
                return outer._q.qsize()

            def service_estimate_s(self):
                return outer.service_s

        self.batcher = _Batcher()

    def warmup(self, seed: int = 0) -> dict:
        return {"wall_s": 0.0, "sources": {"solve": "sleep"},
                "export_cache_hit": 0, "export_cache_miss": 0}

    def start(self) -> None:
        for i in range(self.lanes):
            t = threading.Thread(target=self._loop, daemon=True,
                                 name=f"sleep-lane{i}")
            t.start()
            self._workers.append(t)

    def submit(self, job: Job):
        try:
            self._q.put_nowait(job)
        except queue.Full:
            raise ShedError("queue_full",
                            depth=self._q.qsize()) from None
        return job.future

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                job = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            with self._slock:
                self._served += 1
                n = self._served
            # minimal serve instrumentation mirroring CalibServer: the
            # stub fleet must exercise the SAME trace-stitching path
            # (serve_request + a batch-tagged stage span) so loadgen
            # demonstrations don't need a real solver; the fault hook
            # makes one replica's injected slowdown visible here too
            t0 = time.monotonic()
            with obs.span("serve_solve", batch=n):
                rt_faults.maybe_delay("serve_batch", n)
                time.sleep(self.service_s)
            service = time.monotonic() - t0
            total = time.monotonic() - job.t_submit
            _event("serve_request", job_id=job.job_id, lane=0,
                   batch=n, k=job.k,
                   queue_wait_s=round(max(0.0, total - service), 6),
                   service_s=round(service, 6),
                   total_s=round(total, 6),
                   **tracectx.child_fields(job.trace))
            job.future.set_result(JobResult(
                job_id=job.job_id, lane=0, batch_id=n,
                sigma_res=float(job.k), sigma_data_img=0.0,
                sigma_res_img=0.0, img_std=0.0, degraded=False,
                queue_wait_s=round(max(0.0, total - service), 6),
                service_s=round(service, 6), total_s=round(total, 6),
                deadline_miss=(job.deadline_s is not None
                               and total > job.deadline_s)))

    def stop(self) -> None:
        self._stop.set()
        for t in self._workers:
            t.join(timeout=1.0)

    def stats(self) -> dict:
        with self._slock:
            served = self._served
        return {"batches": served, "served": served, "degraded": 0,
                "failed": 0, "deadline_miss": 0,
                "service_est_s": self.service_s, "circuit_open": False}


def make_sleep_server(**kw) -> SleepServer:
    """Picklable factory for the router-capacity stub fleet."""
    return SleepServer(**kw)


def sleep_worker_spec(lanes: int = 2, service_s: float = 0.05,
                      beat_s: float = 0.05) -> dict:
    return {"factory": "smartcal_tpu_torch.serve.fleet:make_sleep_server",
            "kwargs": {"lanes": int(lanes), "service_s": float(service_s)},
            "lanes": int(lanes), "beat_s": float(beat_s)}


def calib_worker_spec(tier: dict, M: int, lanes: int, cache_dir: str,
                      device: str = "cuda", **factory_kw) -> dict:
    """The picklable ``worker_spec`` for a real-CalibServer fleet; every
    replica serves on ``device`` (default the card)."""
    return {
        "factory": "smartcal_tpu_torch.serve.fleet:make_calib_server",
        "kwargs": dict(tier=dict(tier), M=int(M), lanes=int(lanes),
                       cache_dir=cache_dir, device=str(device),
                       **factory_kw),
        "lanes": int(lanes),
        "device": str(device),
    }


def _server_gauges(server) -> dict:
    """The load signals a replica streams in every beat frame.  The
    compile counter (nvcc builds and CUDA-graph captures) rides along so
    the fleet tool can assert zero steady-state compiles fleet-wide, not just
    in the parent."""
    st = server.stats()
    batches = st.get("batches", 0)
    c = obs.counters_snapshot()
    return {
        "queue_depth": int(server.batcher.depth()),
        "service_est_s": float(st.get("service_est_s",
                               server.batcher.service_estimate_s())),
        "batch_fill": round(st.get("served", 0)
                            / max(1, batches * server.lanes), 4),
        "circuit_open": bool(st.get("circuit_open", False)),
        "served": int(st.get("served", 0)),
        "failed": int(st.get("failed", 0)),
        "degraded": int(st.get("degraded", 0)),
        "deadline_miss": int(st.get("deadline_miss", 0)),
        "compile_events": float(c.get("compile_events", 0.0)),
        # which policy version this replica is serving (-1: no policy /
        # stub server) — the lifecycle tool's convergence signal that
        # a fleet-wide publication actually landed everywhere
        "policy_version": int(getattr(server, "policy_version", -1)),
    }


def _submit_remote(server, payload: dict, send,
                   replica_id: int = 0) -> None:
    """Rebuild the parent's Job (same job_id, same t_submit — monotonic
    clocks are system-wide on Linux, so queue-wait/deadline accounting
    spans the process boundary) and route its eventual outcome back as
    a result / job_shed / job_failed frame."""
    jid = payload["job_id"]
    job = Job(episode=_episode_from_host(payload["episode"],
                                         getattr(server, "device", None)),
              **{f: payload[f] for f in _JOB_FIELDS
                 if f in payload})
    # the admission hop gets its own span: serve_admit's wall t minus
    # fleet_dispatch's wall t (offset-corrected by the collector) is
    # the request's IPC + outbox time; the request's later events
    # chain under the admit span, not the remote root
    tf = tracectx.child_fields(job.trace)
    if tf:
        _event("serve_admit", job_id=jid, replica=replica_id,
               requeues=job.requeues, **tf)
        job.trace = {"trace": str(tf["trace"]), "span": str(tf["span"])}
    try:
        fut = server.submit(job)
    except ShedError as e:
        send(("job_shed", jid, e.reason), trace=job.trace)
        return
    except Exception as e:
        send(("job_failed", jid, repr(e)), trace=job.trace)
        return

    def _done(f, jid=jid):
        try:
            r = f.result()
        except ShedError as e:
            send(("job_shed", jid, e.reason), trace=job.trace)
            return
        except BaseException as e:      # noqa: BLE001 — relayed, not raised
            send(("job_failed", jid, repr(e)), trace=job.trace)
            return
        send(("result", jid, dataclasses.asdict(r)), trace=job.trace)

    fut.add_done_callback(_done)


class _WeightsPublisher(threading.Thread):
    """Replica-side policy-swap worker: weight frames land LATEST-WINS
    in a single slot and the swap (warm forward + locked pointer flip
    via ``CalibServer.swap_policy``) runs on this thread — never on the
    replica's frame-dispatch loop, so a beat or a job frame is never
    delayed because a snapshot arrived.  A burst of publications
    collapses to the newest version; each replica swaps independently
    (the fleet is never barriered on a publication)."""

    def __init__(self, server, replica_id: int):
        super().__init__(name=f"replica{replica_id}-weights", daemon=True)
        self.server = server
        self.replica_id = int(replica_id)
        self._lock = threading.Lock()
        self._slot = None                # latest-wins (version, params)
        self._wake = threading.Event()
        # NOT "_stop": threading.Thread.join(timeout=...) calls its own
        # private _stop() and an Event there makes any timed join raise
        self._stop_ev = threading.Event()
        self.swaps = 0

    def offer(self, version: int, params) -> None:
        with self._lock:
            self._slot = (int(version), params)
        self._wake.set()

    def request_stop(self) -> None:
        self._stop_ev.set()
        self._wake.set()

    def run(self) -> None:
        while not self._stop_ev.is_set():
            self._wake.wait(timeout=0.2)
            self._wake.clear()
            with self._lock:
                item, self._slot = self._slot, None
            if item is None:
                continue
            version, params = item
            try:
                self.server.swap_policy(params, version)
                self.swaps += 1
            except Exception as e:       # a bad frame must not kill the
                obs.counter_add("fleet_weights_swap_errors")  # replica
                _event("fleet_weights_swap_error",
                       replica=self.replica_id, version=version,
                       error=repr(e))


def replica_worker_main(conn, replica_id: int, spec: dict) -> None:
    """Entry point of a spawned replica process: make the spec's CUDA
    device current, attach the simulated host, build the server from its
    picklable factory spec, warm up against the shared cache, then loop —
    drain job/stop frames, stream gauge beats."""
    device = spec.get("device")
    if device is not None and str(device).startswith("cuda"):
        import torch

        dev = torch.device(device)
        torch.cuda.set_device(0 if dev.index is None else dev.index)
    if int(spec.get("n_hosts", 1)) > 1:
        # only a multi-host topology needs the simulated attach
        from smartcal_tpu_torch.parallel import multihost

        multihost.attach_simulated(spec.get("host_id", 0),
                                   spec.get("n_hosts", 1))
    rl = None
    if spec.get("metrics"):
        rl = obs.RunLog(spec["metrics"], run_id=f"replica{replica_id}")
        obs.activate(rl)
        # fleet workers fly with the recorder armed by default: a
        # crash/circuit-open/shed-burst dumps the last events next to
        # the replica's own JSONL stream
        if spec.get("flight_recorder", True):
            obs.arm_flight_recorder(
                os.path.dirname(spec["metrics"]) or ".")
    obs.install_compile_listener()
    if spec.get("faults"):
        # per-replica deterministic fault plan (the injected-slowdown
        # demonstration targets exactly one replica of the fleet)
        rt_faults.install(rt_faults.FaultPlan(**dict(spec["faults"])))

    send_lock = threading.Lock()

    def send(msg, trace=None) -> bool:
        env = dict(trace) if trace else {}
        env["t"] = round(time.time(), 6)  # clock-offset handshake
        try:
            with send_lock:              # done-callbacks run on the
                ipc.send_msg(conn, msg, trace=env)  # batch worker;
            return True                  # beats on main
        except (OSError, BrokenPipeError, ValueError, EOFError):
            return False

    server = None
    try:
        factory = ipc.resolve_factory(spec["factory"])
        server = factory(**(spec.get("kwargs") or {}))
        summary = server.warmup(seed=int(spec.get("seed", 0)))
        server.start()
        send(("ready", summary))
    except BaseException as e:          # noqa: BLE001 — death IS the signal
        _event("replica_fatal", replica=replica_id, error=repr(e))
        obs.flush_flight_recorder("crash", {"error": repr(e)})
        send(("error", repr(e)))
        return
    beat_s = float(spec.get("beat_s", 0.1))
    last_beat = 0.0
    weights_pub: Optional[_WeightsPublisher] = None
    try:
        while True:
            if conn.poll(beat_s):
                try:
                    msg, _mtrace = ipc.recv_msg_traced(conn)
                except ipc.CorruptPayloadError as e:
                    # router->replica corruption: skip the one frame,
                    # but name its trace if the prelude survived
                    _event("ipc_corrupt_payload", side="replica",
                           replica=replica_id, error=repr(e),
                           **tracectx.fields_of(e.trace))
                    continue
                if msg[0] == "stop":
                    break
                if msg[0] == "job":
                    _submit_remote(server, msg[1], send, replica_id)
                elif msg[0] == "weights":
                    # policy hot-swap publication: hand the snapshot to
                    # the latest-wins swap worker (servers without a
                    # policy — stubs — ignore the frame, counted)
                    if weights_pub is None \
                            and hasattr(server, "swap_policy"):
                        weights_pub = _WeightsPublisher(server,
                                                        replica_id)
                        weights_pub.start()
                    if weights_pub is not None:
                        weights_pub.offer(msg[1]["version"],
                                          msg[1]["params"])
                    else:
                        obs.counter_add("fleet_weights_ignored")
            now = time.monotonic()
            if now - last_beat >= beat_s:
                last_beat = now
                send(("beat", _server_gauges(server)))
    except (EOFError, OSError, BrokenPipeError):
        pass                             # router gone: nothing to report
    finally:
        if weights_pub is not None:
            weights_pub.request_stop()
        try:
            server.stop()
        except Exception:
            pass
        if rl is not None:
            try:
                obs.flush_counters()
                while obs.active() is not None:
                    obs.deactivate()
                rl.close()           # flush the buffered tail — a short
            except Exception:        # run otherwise fits entirely in the
                pass                 # RunLog buffer and leaves no stream


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------

class _Replica(threading.Thread):
    """Parent-side replica slot: the spawned worker process, this pump
    thread (sole reader of the duplex pipe), and a FIFO sender thread
    (sole writer — jobs are NOT latest-wins like weights snapshots, so
    the outbox is a bounded queue, not the `_ProcessActor` single
    slot).  Duck-types the supervision surface the router polls
    (``last_beat`` / ``error`` / ``healthy``) plus the dispatch surface
    it ranks on (``gauges`` / ``dispatch`` / ``take_pending``)."""

    def __init__(self, router: "FleetRouter", replica_id: int, spec: dict):
        super().__init__(name=f"{router.name}-r{replica_id}-pump",
                         daemon=True)
        self.router = router
        self.replica_id = int(replica_id)
        self.spec = dict(spec)
        self.lanes = int(spec.get("lanes", 1))
        self._lock = threading.Lock()
        self._pending: Dict[int, Job] = {}   # job_id -> parent-side Job
        self._gauges = {
            "queue_depth": 0, "batch_fill": 0.0, "circuit_open": False,
            "service_est_s": float(spec.get("service_est_s", 0.5)),
        }
        # last-received-frame summaries: the PARENT-side black box for
        # this replica.  A SIGKILLed worker can never flush its own
        # ring, so the crashed replica's final observable events are
        # what the parent saw — dumped by the router on death detection.
        self._frames: "collections.deque" = collections.deque(
            maxlen=int(spec.get("frame_ring", 64)))
        # clock-offset handshake state (pump thread only): minimum of
        # (parent recv wall - peer send wall) over received envelopes
        self._offset_min: Optional[float] = None
        self._offset_logged: Optional[float] = None
        self._offset_last_log = 0.0
        self.t_spawn = time.monotonic()
        self.last_beat = time.monotonic()
        self.ready = threading.Event()
        self.ready_summary: Optional[dict] = None
        self.stop_event = threading.Event()
        self.error: Optional[BaseException] = None
        self._outbox: "queue.Queue[bytes]" = queue.Queue(
            maxsize=max(1, int(spec.get("dispatch_cap", 64))))
        self._sender: Optional[threading.Thread] = None
        self.proc = None
        self.conn = None

    # -- lifecycle ---------------------------------------------------------
    def _launch(self) -> None:
        import multiprocessing as mp

        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=True)
        self.proc = ctx.Process(
            target=replica_worker_main,
            args=(child, self.replica_id, self.spec),
            name=f"{self.router.name}-r{self.replica_id}", daemon=True)
        self.proc.start()
        child.close()                    # parent keeps one end only

    def start(self) -> None:
        self._launch()
        self._sender = threading.Thread(
            target=self._send_loop,
            name=f"{self.router.name}-r{self.replica_id}-send", daemon=True)
        self._sender.start()
        super().start()

    def healthy(self) -> bool:
        """Pump alive and no terminal error — the slot can still speak."""
        return self.is_alive() and self.error is None

    def request_stop(self) -> None:
        try:
            self._outbox.put(ipc.frame_payload(("stop",)), timeout=0.2)
        except queue.Full:
            pass                         # sender drains; EOF stops worker
        self.stop_event.set()

    def hard_kill(self) -> None:
        try:
            if self.proc is not None and self.proc.is_alive():
                self.proc.kill()
        except Exception:
            pass

    def finalize(self, timeout: float = 2.0) -> None:
        if self.proc is None:
            return
        try:
            self.proc.join(timeout=timeout)
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join(timeout=1.0)
        except Exception:
            pass

    def shutdown(self, timeout: float = 5.0) -> None:
        self.request_stop()
        if self.ident is not None:
            self.join(timeout=timeout)
        self.finalize(timeout=max(1.0, timeout / 2))

    # -- dispatch surface --------------------------------------------------
    def gauges(self) -> dict:
        with self._lock:
            g = dict(self._gauges)
            g["pending"] = len(self._pending)
        return g

    def pending_count(self) -> int:
        with self._lock:
            return len(self._pending)

    def dispatch(self, job: Job) -> bool:
        """Stage ``job`` toward the worker; False when this replica's
        bounded dispatch outbox is full (the router tries the next
        candidate — per-replica back-pressure must never block the
        front door)."""
        blob = ipc.frame_payload(("job", _job_payload(job)),
                                 trace=job.trace)
        with self._lock:
            self._pending[job.job_id] = job
        try:
            self._outbox.put_nowait(blob)
        except queue.Full:
            with self._lock:
                self._pending.pop(job.job_id, None)
            return False
        return True

    def publish(self, blob: bytes) -> bool:
        """Stage a pre-framed weights frame toward the worker; False
        when the outbox is full — the frame is DROPPED, never retried:
        the next publication supersedes it, and a weight frame must
        never occupy outbox capacity a job dispatch needs."""
        try:
            self._outbox.put_nowait(blob)
        except queue.Full:
            return False
        return True

    def take_pending(self) -> List[Job]:
        """Remove and return every in-flight job (crash reclaim)."""
        with self._lock:
            jobs = list(self._pending.values())
            self._pending.clear()
        return jobs

    def _pop_pending(self, job_id: int) -> Optional[Job]:
        with self._lock:
            return self._pending.pop(job_id, None)

    # -- threads -----------------------------------------------------------
    def _send_loop(self) -> None:
        while True:
            try:
                blob = self._outbox.get(timeout=0.2)
            except queue.Empty:
                if self.stop_event.is_set():
                    return
                continue
            try:
                ipc.send_blob(self.conn, blob)
            except (OSError, BrokenPipeError, ValueError):
                return

    def _note_frame(self, kind: str, detail: dict) -> None:
        rec = {"t": round(time.time(), 3), "kind": kind,
               "replica": self.replica_id}
        rec.update(detail)
        with self._lock:
            self._frames.append(rec)

    def _note_envelope(self, trace: Optional[dict]) -> None:
        """Feed one received envelope into the clock-offset estimate:
        min over frames of (recv wall - send wall) bounds the peer's
        clock ahead-ness by the one-way delay.  Logged periodically as
        a ``clock_offset`` event (the collector's skew correction)."""
        if not trace or "t" not in trace:
            return
        try:
            delta = time.time() - float(trace["t"])
        except (TypeError, ValueError):
            return
        if self._offset_min is None or delta < self._offset_min:
            self._offset_min = delta
        now = time.monotonic()
        if (self._offset_logged != self._offset_min
                and now - self._offset_last_log >= 1.0):
            self._offset_last_log = now
            self._offset_logged = self._offset_min
            # offset_s: ADD to the peer's wall timestamps to land on
            # the parent's clock (<= one-way delay of the best frame)
            self.router._log("clock_offset",
                             peer=f"replica{self.replica_id}",
                             replica=self.replica_id,
                             offset_s=round(-self._offset_min, 6))

    def blackbox(self, reason: str, directory: str) -> Optional[str]:
        """Dump this slot's received-frame ring (the parent-side black
        box) to ``blackbox_replica<rid>.jsonl`` in ``directory``."""
        with self._lock:
            frames = list(self._frames)
        if not frames:
            return None
        try:
            os.makedirs(directory, exist_ok=True)
            path = os.path.join(
                directory, f"blackbox_replica{self.replica_id}.jsonl")
            header = {"t": round(time.time(), 3),
                      "event": "blackbox_flush", "reason": reason,
                      "side": "parent", "replica": self.replica_id,
                      "n_events": len(frames)}
            with open(path, "a") as fh:
                fh.write(json.dumps(header) + "\n")
                for rec in frames:
                    fh.write(json.dumps(obs.sanitize(rec)) + "\n")
            return path
        except OSError:
            return None

    def run(self) -> None:
        r = self.router
        while not self.stop_event.is_set():
            try:
                if not self.conn.poll(0.2):
                    if self.proc is not None and not self.proc.is_alive() \
                            and not self.conn.poll(0):
                        if self.error is None:
                            self.error = RuntimeError(
                                f"replica process exited (code "
                                f"{self.proc.exitcode})")
                        return
                    continue
                msg, mtrace = ipc.recv_msg_traced(self.conn)
            except ipc.CorruptPayloadError as e:
                # a replica died mid-send (or shipped garbage): drop the
                # one broken frame, log it — WITH the trace the frame's
                # surviving prelude names, so the merged timeline shows
                # which request's frame was lost instead of a bare drop
                r._log("ipc_corrupt_payload", replica=self.replica_id,
                       error=repr(e), **tracectx.fields_of(e.trace))
                self._note_frame("corrupt", {"error": repr(e),
                                             **tracectx.fields_of(e.trace)})
                obs.counter_add("ipc_corrupt_payloads")
                continue
            except (EOFError, OSError):
                if not self.stop_event.is_set() and self.error is None:
                    code = (self.proc.exitcode if self.proc is not None
                            else None)
                    self.error = RuntimeError(
                        f"replica channel closed (exit code {code})")
                return
            self.last_beat = time.monotonic()
            self._note_envelope(mtrace)
            kind = msg[0]
            if kind == "ready":
                self.ready_summary = msg[1]
                self.ready.set()
                self._note_frame("ready", {})
            elif kind == "beat":
                with self._lock:
                    self._gauges.update(msg[1])
                self._note_frame("beat", {k: msg[1].get(k) for k in
                                          ("queue_depth", "served",
                                           "circuit_open")})
            elif kind == "result":
                job = self._pop_pending(msg[1])
                if job is not None and not job.future.done():
                    job.future.set_result(JobResult(**msg[2]))
                self._note_frame("result", {
                    "job_id": msg[1],
                    "total_s": msg[2].get("total_s"),
                    **tracectx.fields_of(mtrace)})
                r._note_result(self.replica_id, job, msg[2])
            elif kind == "job_shed":
                job = self._pop_pending(msg[1])
                self._note_frame("job_shed", {"job_id": msg[1],
                                              "reason": msg[2]})
                if job is not None:
                    r._reclaim(job, self.replica_id, msg[2])
            elif kind == "job_failed":
                job = self._pop_pending(msg[1])
                if job is not None and not job.future.done():
                    job.future.set_exception(RuntimeError(msg[2]))
                self._note_frame("job_failed", {"job_id": msg[1],
                                                "error": msg[2]})
                r._note_failed(self.replica_id, msg[1], msg[2])
            elif kind == "error":
                self.error = RuntimeError(msg[1])
                self._note_frame("error", {"error": msg[1]})
                return


def _episode_to_host(ep):
    """An episode (nested NamedTuples of tensors and scalars) with every
    tensor as a host numpy array: what crosses the process boundary."""
    if ep is None:
        return None
    if isinstance(ep, tuple) and hasattr(ep, "_fields"):
        return type(ep)(*(_episode_to_host(v) for v in ep))
    return _to_host(ep)


def _episode_from_host(ep, device):
    """:func:`_episode_to_host`'s inverse on ``device`` (None: the arrays
    stay host numpy, as a stub server takes them)."""
    if ep is None or device is None:
        return ep
    if isinstance(ep, tuple) and hasattr(ep, "_fields"):
        return type(ep)(*(_episode_from_host(v, device) for v in ep))
    import numpy as np
    import torch

    if isinstance(ep, np.ndarray):
        return torch.as_tensor(ep, device=device)
    return ep


def _job_payload(job: Job) -> dict:
    """The picklable half of a Job (the episode's tensors as host numpy)."""
    d = {f: getattr(job, f) for f in _JOB_FIELDS}
    d["episode"] = _episode_to_host(job.episode)
    return d


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """Load-driven scale knobs: spawn a replica when the fleet-mean
    backlog per live replica stays at/above ``spawn_depth`` jobs for
    ``spawn_sustain_s``; reap the newest idle replica after
    ``reap_idle_s`` of a drained fleet.  ``cooldown_s`` separates
    consecutive scale events so one burst cannot thrash the fleet."""

    min_replicas: int = 1
    max_replicas: int = 8
    spawn_depth: float = 2.0
    spawn_sustain_s: float = 2.0
    reap_idle_s: float = 10.0
    cooldown_s: float = 5.0


class FleetRouter:
    """The front door (see module doc).  Lifecycle::

        router = FleetRouter(calib_worker_spec(...), replicas=4)
        router.start()                  # replica 0 builds the shared
        fut = router.submit(Job(...))   # cache; 1..N warm-start off it
        fut.result(timeout=...)
        router.stop()

    Dispatch ranks live replicas by load score ``(pending + queue_depth)
    / lanes`` with batch-fill as the tiebreak; a job with a deadline
    first narrows to replicas whose ETA fits its remaining slack,
    falling back to plain least-loaded when none does (degrade to a
    late answer, never shed a servable job).  ``replica_factory`` and
    ``clock`` are injectable for tests (scripted gauges, fake time).
    """

    def __init__(self, worker_spec: dict, replicas: int = 1, *,
                 hosts: int = 1, name: str = "calib-fleet",
                 heartbeat_timeout: float = 10.0, max_restarts: int = 3,
                 backoff: Optional[BackoffPolicy] = None, seed: int = 0,
                 max_requeues: int = 1,
                 autoscale: Optional[AutoscalePolicy] = None,
                 poll_s: float = 0.05, metrics_dir: Optional[str] = None,
                 replica_factory: Optional[Callable] = None,
                 slo: Optional["obs.SloBurnDetector"] = None,
                 clock: Callable[[], float] = time.monotonic):
        import random

        self.worker_spec = dict(worker_spec)
        self.name = name
        self.hosts = max(1, int(hosts))
        self.n_initial = int(replicas)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.max_requeues = int(max_requeues)
        self.autoscale = autoscale
        self.metrics_dir = metrics_dir
        self.slo = slo
        self._clock = clock
        self._poll_s = float(poll_s)
        self._factory = replica_factory or _Replica
        self._tracker = RestartTracker(
            max_restarts,
            backoff or BackoffPolicy(base_s=0.25, factor=2.0, max_s=10.0,
                                     jitter=0.25),
            rng=random.Random(seed))
        self._lock = threading.Lock()
        self._replicas: Dict[int, Any] = {}  # rid -> _Replica (current)
        self._next_rid = 0
        self._stats = {"submitted": 0, "dispatched": 0, "completed": 0,
                       "failed": 0, "requeued": 0, "shed": 0,
                       "shed_reasons": {}, "replica_restarts": 0,
                       "scale_ups": 0, "scale_downs": 0}
        self._rr = 0                     # dispatch tiebreak rotation
        self._reclaim_q: "queue.Queue" = queue.Queue()
        self._retired: List[Any] = []    # reaped replicas awaiting join
        self._stop_ev = threading.Event()
        self._sup: Optional[threading.Thread] = None
        self._over_since: Optional[float] = None
        self._idle_since: Optional[float] = None
        self._depth_ewma: Optional[float] = None
        self._last_scale = -1e18

    # -- topology ----------------------------------------------------------
    def replica_host(self, rid: int) -> int:
        """Host of replica ``rid``: 0 for every replica.  The fleet's
        replicas are processes of one machine (not a ``parallel/multihost``
        job), so ``hosts`` is recorded, not spread over."""
        del rid
        return 0

    def _replica_spec(self, rid: int) -> dict:
        """The per-process worker spec for slot ``rid``: base spec +
        host pinning + this generation's metrics path + any
        ``per_replica`` overrides ({rid: {...}} in the base spec — the
        injected-slowdown demonstration targets one replica's fault
        plan without touching the rest of the fleet)."""
        spec = dict(self.worker_spec, host_id=self.replica_host(rid),
                    n_hosts=1)
        over = spec.pop("per_replica", None) or {}
        ov = over.get(rid, over.get(str(rid)))
        if ov:
            spec.update(dict(ov))
        if self.metrics_dir:
            spec["metrics"] = os.path.join(
                self.metrics_dir,
                f"replica{rid}-g{self._tracker.attempts(rid)}.jsonl")
        return spec

    def _spawn_replica(self):
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
        r = self._factory(self, rid, self._replica_spec(rid))
        r.start()
        with self._lock:
            self._replicas[rid] = r
        obs.gauge_set("fleet_replicas_alive", len(self._live()))
        return r

    def _respawn(self, rid: int):
        """Fresh process in an existing slot (same rid: restart
        accounting and the per-slot circuit stay attached)."""
        r = self._factory(self, rid, self._replica_spec(rid))
        r.start()
        with self._lock:
            self._replicas[rid] = r
        return r

    def _live(self) -> list:
        with self._lock:
            reps = list(self._replicas.values())
        return [r for r in reps if r.healthy()]

    # -- lifecycle ---------------------------------------------------------
    def start(self, warm_timeout_s: float = 300.0,
              stagger: bool = True) -> dict:
        """Spawn the initial replicas and wait until every one is warm.
        ``stagger`` (default) brings replica 0 up ALONE first so a cold
        shared cache is built exactly once; the rest then warm-start
        off it concurrently.  Returns {rid: warmup_summary}."""
        if self._sup is not None:
            raise RuntimeError("router already started")
        first = self._spawn_replica()
        if stagger:
            self._wait_ready([first], warm_timeout_s)
        rest = [self._spawn_replica() for _ in range(self.n_initial - 1)]
        self._wait_ready(rest + ([] if stagger else [first]),
                         warm_timeout_s)
        sup = threading.Thread(target=self._supervise,
                               name=f"{self.name}-router", daemon=True)
        self._sup = sup
        sup.start()
        return self.warmups()

    def _wait_ready(self, replicas: list, timeout_s: float) -> None:
        deadline = time.monotonic() + timeout_s
        for r in replicas:
            while not r.ready.wait(timeout=0.1):
                if not r.healthy():
                    raise RuntimeError(
                        f"replica {r.replica_id} died during warmup: "
                        f"{r.error!r}")
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"replica {r.replica_id} not ready after "
                        f"{timeout_s}s")

    def warmups(self) -> dict:
        with self._lock:
            reps = dict(self._replicas)
        return {rid: r.ready_summary for rid, r in reps.items()
                if r.ready_summary is not None}

    def stop(self, timeout: float = 10.0) -> None:
        """Stop every replica, then fail whatever is still pending with
        a structured ``shutdown`` shed."""
        self._stop_ev.set()
        if self._sup is not None:
            self._sup.join(timeout=timeout)
        with self._lock:
            reps = list(self._replicas.values())
            retired = list(self._retired)
        for r in reps:
            r.request_stop()
        for r in reps + retired:
            r.shutdown(timeout=timeout)
        for r in reps:
            for job in r.take_pending():
                self._shed_async(job, "shutdown")
        while True:
            try:
                job, _reason = self._reclaim_q.get_nowait()
            except queue.Empty:
                break
            self._shed_async(job, "shutdown")

    # -- request path ------------------------------------------------------
    def submit(self, job: Job):
        """Admit ``job`` (returns its future) or shed synchronously:
        ``shutdown`` / ``fleet_down`` (no live replica) /
        ``fleet_saturated`` (every live replica's outbox full)."""
        if self._stop_ev.is_set():
            self._shed_sync(job, "shutdown")
        with self._lock:
            self._stats["submitted"] += 1
        return self._dispatch(job)

    def _candidates(self) -> list:
        """Live, warm replicas whose per-slot circuit is closed."""
        out = []
        for r in self._live():
            if not r.ready.is_set():
                continue
            if self._tracker.tracked(r.replica_id):
                continue
            if r.gauges().get("circuit_open"):
                continue
            out.append(r)
        return out

    def _rank(self, cands: list, job: Job) -> list:
        """Deadline-aware least-loaded order.  ETA per replica is
        (backlog batches + 1) * service estimate; a deadline narrows to
        replicas that fit the job's remaining slack, falling back to
        everyone when none does."""
        now = self._clock()
        scored = []
        for r in cands:
            g = r.gauges()
            backlog = (g["pending"] + g["queue_depth"]) / max(1, r.lanes)
            eta = (backlog + 1.0) * max(1e-3, g["service_est_s"])
            scored.append((r, backlog, g.get("batch_fill", 0.0), eta))
        if job.deadline_s is not None:
            slack = job.deadline_s - (now - job.t_submit)
            fits = [s for s in scored if s[3] <= slack]
            if fits:
                scored = fits
        rr = self._rr
        self._rr = rr + 1
        scored.sort(key=lambda s: (s[1], s[2],
                                   (s[0].replica_id - rr) % 997))
        return [s[0] for s in scored]

    def _dispatch(self, job: Job, requeue: bool = False):
        if job.trace is None and obs.active() is not None:
            # mint the request's trace root at fleet admission — every
            # later event (serve_admit / serve_request / fleet_result,
            # on either side of the pipe) joins this tree.  A requeue
            # keeps the ORIGINAL carrier: same trace_id, annotated hop.
            job.trace = tracectx.new_root_carrier()
        cands = self._candidates()
        if not cands:
            if requeue:
                return self._shed_async(job, "fleet_down")
            self._shed_sync(job, "fleet_down")
        for r in self._rank(cands, job):
            if r.dispatch(job):
                with self._lock:
                    self._stats["dispatched"] += 1
                    if requeue:
                        self._stats["requeued"] += 1
                obs.counter_add("fleet_dispatch")
                _event("fleet_dispatch", job_id=job.job_id,
                       replica=r.replica_id, requeue=bool(requeue),
                       **tracectx.fields_of(job.trace))
                return job.future
        if requeue:
            return self._shed_async(job, "fleet_saturated")
        self._shed_sync(job, "fleet_saturated")

    def _requeue(self, job: Job, reason: str) -> None:
        """A replica lost/refused ``job`` after admission: re-dispatch
        to a survivor (bounded), else shed with the structured reason
        on the future the client already holds."""
        if job.future.done():
            return
        job.requeues += 1
        if job.requeues > self.max_requeues:
            self._shed_async(job, reason)
            return
        self._dispatch(job, requeue=True)

    def _shed_record(self, job: Job, reason: str) -> None:
        with self._lock:
            self._stats["shed"] += 1
            reasons = self._stats["shed_reasons"]
            reasons[reason] = reasons.get(reason, 0) + 1
        obs.counter_add("serve_shed")
        obs.note_shed()                 # flight recorder burst detection
        if self.slo is not None:
            self.slo.observe(shed=True, now=self._clock())
        _event("serve_shed", job_id=job.job_id, reason=reason,
               scope="fleet", **tracectx.fields_of(job.trace))

    def _shed_sync(self, job: Job, reason: str) -> None:
        self._shed_record(job, reason)
        raise ShedError(reason)

    def _shed_async(self, job: Job, reason: str) -> None:
        """Shed a job whose future the client already holds (post-
        admission loss): the reason travels as the future's exception."""
        self._shed_record(job, reason)
        if not job.future.done():
            job.future.set_exception(ShedError(reason))

    # -- policy publication ------------------------------------------------
    def publish_policy(self, actor_params, version: int) -> int:
        """Fan one versioned weight frame out to every live warm
        replica (the fleet half of a policy hot-swap publication).

        The pytree is pulled to host and framed ONCE; each replica's
        swap then proceeds independently on its own ``_WeightsPublisher``
        thread — no fleet-wide barrier, and a replica mid-restart just
        misses this version and catches the next.  A full dispatch
        outbox drops the FRAME (counted, superseded by the next
        publication), never a job.  Returns the number of replicas
        reached."""
        blob = ipc.frame_payload(("weights",
                                  {"version": int(version),
                                   "params": _to_host(actor_params)}))
        reached = dropped = 0
        for r in self._live():
            if not r.ready.is_set():
                continue
            if r.publish(blob):
                reached += 1
            else:
                dropped += 1
        obs.counter_add("fleet_policy_publishes")
        if dropped:
            obs.counter_add("fleet_weights_dropped", dropped)
        _event("fleet_publish_policy", version=int(version),
               reached=reached, dropped=dropped)
        return reached

    # -- pump-thread callbacks ---------------------------------------------
    def _note_result(self, rid: int, job: Optional[Job], d: dict) -> None:
        with self._lock:
            self._stats["completed"] += 1
        if self.slo is not None:
            try:
                lat = float(d.get("total_s") or 0.0)
            except (TypeError, ValueError):
                lat = 0.0
            self.slo.observe(latency_s=lat, replica=rid,
                             now=self._clock())
        _event("fleet_result", replica=rid,
               job_id=d.get("job_id"), total_s=d.get("total_s"),
               degraded=d.get("degraded"),
               deadline_miss=d.get("deadline_miss"),
               requeues=getattr(job, "requeues", 0),
               **tracectx.fields_of(getattr(job, "trace", None)))

    def _note_failed(self, rid: int, job_id: int, err: str) -> None:
        with self._lock:
            self._stats["failed"] += 1
        _event("fleet_job_failed", replica=rid, job_id=job_id, error=err)

    def _reclaim(self, job: Job, rid: int, reason: str) -> None:
        """A remote shed (replica queue_full / circuit_open / shutdown)
        arrived on the pump thread: queue it for the supervision loop
        to re-dispatch (dispatching from the pump would deadlock a
        full-outbox retry against the very thread draining results)."""
        _event("fleet_reclaim", replica=rid, job_id=job.job_id,
               reason=reason)
        self._reclaim_q.put((job, reason))

    # -- supervision -------------------------------------------------------
    def _supervise(self) -> None:
        while not self._stop_ev.wait(self._poll_s):
            try:
                self.poll()
            except Exception as e:      # the front door must outlive a
                obs.counter_add("fleet_router_errors")   # bad pass
                _event("fleet_router_error", error=repr(e))

    def poll(self) -> list:
        """One supervision pass (public: tests drive it with an
        injected clock): detect dead/hung replicas, reclaim + requeue
        their in-flight jobs, perform due backoff respawns, drain the
        remote-shed reclaim queue, evaluate autoscale.  Returns the
        events emitted this pass."""
        now = self._clock()
        events = []
        with self._lock:
            replicas = dict(self._replicas)
        for rid, r in replicas.items():
            if self._tracker.tracked(rid):
                continue
            dead = not r.healthy()
            hung = (not dead and r.ready.is_set()
                    and now - r.last_beat > self.heartbeat_timeout)
            if not dead and not hung:
                continue
            if hung:
                r.hard_kill()
            r.stop_event.set()
            r.finalize(timeout=1.0)
            lost = r.take_pending()
            reason = (f"error:{r.error!r}" if r.error is not None
                      else ("exited" if dead else "hung"))
            if self.metrics_dir and hasattr(r, "blackbox"):
                # a SIGKILLed worker never flushes its own flight
                # recorder; the parent-side frame ring is the crashed
                # replica's black box
                r.blackbox(reason, self.metrics_dir)
            n = self._tracker.attempts(rid)
            delay = self._tracker.note_down(rid, now=now)
            with self._lock:
                self._replicas.pop(rid, None)
            if delay is None:
                ev = {"event": "fleet_replica_failed", "replica": rid,
                      "reason": reason, "restarts": n,
                      "lost_jobs": len(lost)}
            else:
                ev = {"event": "fleet_replica_down", "replica": rid,
                      "reason": reason, "restart_in_s": round(delay, 3),
                      "attempt": n + 1, "lost_jobs": len(lost)}
            events.append(ev)
            self._log(**ev)
            for job in lost:
                self._requeue(job, "replica_lost")
        if not self._stop_ev.is_set():
            for rid, _tok in self._tracker.due(now):
                self._respawn(rid)
                with self._lock:
                    self._stats["replica_restarts"] += 1
                ev = {"event": "fleet_replica_restart", "replica": rid,
                      "attempt": self._tracker.attempts(rid)}
                events.append(ev)
                self._log(**ev)
                obs.counter_add("fleet_replica_restarts")
        while True:
            try:
                job, reason = self._reclaim_q.get_nowait()
            except queue.Empty:
                break
            self._requeue(job, reason)
        events.extend(self._autoscale_pass(now))
        if self.slo is not None:
            ev = self.slo.evaluate(now=now)
            if ev is not None:
                ev = dict(ev, event="slo_burn")
                events.append(ev)
                self._log(**ev)
                obs.counter_add("fleet_slo_transitions")
            snap_fast = self.slo.snapshot(now=now)["fast"]
            obs.gauge_set("fleet_slo_burn", float(snap_fast["burn"]))
        self._gauge_tick()
        return events

    def _autoscale_pass(self, now: float) -> list:
        pol = self.autoscale
        if pol is None or self._stop_ev.is_set():
            return []
        live = self._live()
        if not live:
            return []
        gauges = [r.gauges() for r in live]
        depth = sum(g["pending"] + g["queue_depth"] for g in gauges)
        per = depth / len(live)
        # the SPAWN signal is an EWMA with hysteresis: micro-batches
        # drain the instantaneous depth to 0 between flushes, so the
        # raw gauge oscillates through the threshold many times a
        # second and a sustain clock keyed on it never runs out
        ew = self._depth_ewma
        ew = per if ew is None else ew + 0.3 * (per - ew)
        self._depth_ewma = ew
        events = []
        if ew >= pol.spawn_depth:
            if self._over_since is None:
                self._over_since = now
            if (now - self._over_since >= pol.spawn_sustain_s
                    and len(live) < pol.max_replicas
                    and now - self._last_scale >= pol.cooldown_s):
                r = self._spawn_replica()
                self._over_since = None
                self._last_scale = now
                with self._lock:
                    self._stats["scale_ups"] += 1
                ev = {"event": "fleet_scale_up", "replica": r.replica_id,
                      "depth_per_replica": round(ew, 2),
                      "replicas": len(live) + 1}
                events.append(ev)
                self._log(**ev)
                obs.counter_add("fleet_scale_ups")
        elif ew < 0.5 * pol.spawn_depth:
            self._over_since = None
        # the REAP signal stays instantaneous: a fleet is only safe to
        # shrink once it has been LITERALLY empty for reap_idle_s
        if depth == 0:
            if self._idle_since is None:
                self._idle_since = now
            if (now - self._idle_since >= pol.reap_idle_s
                    and len(live) > pol.min_replicas
                    and now - self._last_scale >= pol.cooldown_s):
                victim = max(live, key=lambda r: r.t_spawn)
                if victim.pending_count() == 0:
                    with self._lock:
                        self._replicas.pop(victim.replica_id, None)
                        self._retired.append(victim)
                        self._stats["scale_downs"] += 1
                    victim.request_stop()
                    self._idle_since = None
                    self._last_scale = now
                    ev = {"event": "fleet_scale_down",
                          "replica": victim.replica_id,
                          "replicas": len(live) - 1}
                    events.append(ev)
                    self._log(**ev)
                    obs.counter_add("fleet_scale_downs")
        else:
            self._idle_since = None
        return events

    def _gauge_tick(self) -> None:
        live = self._live()
        obs.gauge_set("fleet_replicas_alive", len(live))
        depth = 0
        for r in live:
            g = r.gauges()
            depth += g["pending"] + g["queue_depth"]
            obs.gauge_set("fleet_replica_depth",
                          g["pending"] + g["queue_depth"],
                          replica=r.replica_id)
        obs.gauge_set("fleet_queue_depth", depth)

    # -- chaos / introspection ---------------------------------------------
    def kill_replica(self, rid: int) -> bool:
        """SIGKILL replica ``rid``'s worker process (chaos hook for the
        kill-and-recover measurement); supervision handles the rest."""
        with self._lock:
            r = self._replicas.get(rid)
        if r is None:
            return False
        r.hard_kill()
        return True

    def replicas_alive(self) -> int:
        return len(self._live())

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
            out["shed_reasons"] = dict(self._stats["shed_reasons"])
            reps = dict(self._replicas)
        out["replicas_alive"] = sum(1 for r in reps.values()
                                    if r.healthy())
        out["failed_replicas"] = sorted(self._tracker.failed)
        out["per_replica"] = {
            rid: dict(r.gauges(), healthy=r.healthy(),
                      restarts=self._tracker.attempts(rid))
            for rid, r in reps.items()}
        return out

    # -- telemetry ---------------------------------------------------------
    def _log(self, event: str = "fleet_event", **fields) -> None:
        _event(fields.pop("event", event), **fields)
