"""Heartbeat-supervised actor fleet, threads or processes (counterpart of
smartcal_tpu/runtime/supervisor.py).

Each actor is an independent host execution unit that rolls out against a
possibly stale weights snapshot while the learner consumes whatever
arrives; this module is the part that survives faults:

* each actor beats a heartbeat before every rollout and pushes its result
  onto an ingest queue;
* :meth:`Fleet.poll` (from the learner loop) detects dead actors (the work
  function raised, e.g. an injected ``FaultInjected``) and hung ones
  (heartbeat older than ``heartbeat_timeout``) and restarts them after an
  exponential backoff with jitter, at most ``max_restarts`` times per
  slot; a replacement resumes at the iteration after the one that killed
  its predecessor, so a poison iteration cannot crash-loop the slot;
* ``Fleet.stop(join=True)`` leaves no actor running against a dead
  learner.

Two backends share the supervision contract (``actor_mode``):

* ``"thread"``: each slot is an :class:`_Actor` thread calling
  ``work_fn`` in this process, pushing onto one bounded queue.  The
  weights it reads are the snapshot the learner published (the learner
  updates its own tensors in place, so it publishes copies);
* ``"process"``: each slot is a :class:`_ProcessActor`, a worker process
  started with the ``spawn`` context (a CUDA context must never be
  forked) running :func:`smartcal_tpu_torch.runtime.ipc.worker_main` with
  a picklable ``worker_spec`` factory, exchanging framed batches, weight
  snapshots and heartbeats over a duplex pipe, and a pump thread relaying
  the worker's frames into the slot's own bounded ingest queue.  Weights
  cross as host numpy (:func:`_to_host`), never as CUDA tensors.  A frame
  that fails validation is dropped and logged (``ipc_corrupt_payload``).
  ``hosts > 1`` tags contiguous slot blocks with simulated host ids.

Telemetry: ``actor_down`` / ``actor_restart`` / ``actor_failed`` /
``ipc_corrupt_payload`` RunLog events, the ``actors_alive`` gauge and the
``actor_restarts`` / ``ipc_corrupt_payloads`` counters.
"""

import queue
import sys
import threading
import time
from typing import Any, Callable, Optional

from . import ipc
from .backoff import BackoffPolicy
from .faults import FaultInjected  # noqa: F401  (re-export for callers)

# work_fn(actor_id, iteration, weights) -> host result pushed to the queue
WorkFn = Callable[[int, int, Any], Any]


class _Actor(threading.Thread):
    def __init__(self, fleet: "Fleet", actor_id: int, start_iteration: int):
        super().__init__(name=f"{fleet.name}-{actor_id}", daemon=True)
        self.fleet = fleet
        self.actor_id = actor_id
        self.iteration = start_iteration
        self.last_beat = time.monotonic()
        self.stop_event = threading.Event()
        self.error: Optional[BaseException] = None

    def run(self):
        f = self.fleet
        while not self.stop_event.is_set():
            self.last_beat = time.monotonic()
            weights, version = f.get_weights()
            try:
                out = f.work_fn(self.actor_id, self.iteration, weights)
            except BaseException as e:   # noqa: BLE001 — death IS the signal
                self.error = e
                return
            # bounded ingest queue: when the learner falls behind, the
            # put blocks (back-pressure — actors must not free-run
            # arbitrarily far ahead of the policy they feed).  Re-beat
            # the heartbeat while waiting so back-pressure is never
            # mistaken for a hung rollout.
            item = (self.actor_id, self.iteration, version, out)
            while not self.stop_event.is_set():
                try:
                    # short tick: re-beat the heartbeat and re-check the
                    # stop flag while waiting, so shutdown never stalls
                    # behind a full queue
                    f._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    self.last_beat = time.monotonic()
            self.iteration += 1


def _to_host(weights: Any) -> Any:
    """``weights`` with every torch tensor as a numpy array (``.detach()
    .cpu()``), through dicts, lists and tuples: what a worker process may
    be sent.  Identity when torch was never imported."""
    torch_mod = sys.modules.get("torch")
    if torch_mod is None:
        return weights
    if isinstance(weights, torch_mod.Tensor):
        return weights.detach().cpu().numpy()
    if isinstance(weights, dict):
        return {k: _to_host(v) for k, v in weights.items()}
    if isinstance(weights, (list, tuple)):
        return type(weights)(_to_host(v) for v in weights)
    return weights


class _ProcessActor(threading.Thread):
    """A process-backed actor slot: a spawned worker process plus this
    parent-side pump thread relaying the worker's framed messages into
    the slot's ingest shard.  Duck-types :class:`_Actor`'s supervision
    surface (``iteration`` / ``last_beat`` / ``stop_event`` / ``error``
    / ``is_alive``) so :class:`Fleet` supervises both backends through
    one contract."""

    def __init__(self, fleet: "Fleet", actor_id: int, start_iteration: int):
        super().__init__(name=f"{fleet.name}-{actor_id}-pump", daemon=True)
        self.fleet = fleet
        self.actor_id = actor_id
        self.iteration = start_iteration
        self.last_beat = time.monotonic()
        self.stop_event = threading.Event()
        self.error: Optional[BaseException] = None
        self.proc = None
        self.conn = None
        # latest-wins outbox: the learner's publish() NEVER blocks on
        # the pipe (a full pipe toward a busy worker must not stall the
        # learner — that closes a learner->worker->pump->learner
        # deadlock cycle); a dedicated sender thread drains it
        self._outbox: Optional[bytes] = None
        self._outbox_lock = threading.Lock()
        self._outbox_ev = threading.Event()
        self._sender: Optional[threading.Thread] = None

    def _launch(self) -> None:
        """Spawn the worker process and its duplex channel (spawn context:
        never fork a process that holds a CUDA context)."""
        import multiprocessing as mp

        f = self.fleet
        ctx = mp.get_context("spawn")
        self.conn, child = ctx.Pipe(duplex=True)
        self.proc = ctx.Process(
            target=ipc.worker_main,
            args=(child, self.actor_id, self.iteration,
                  f.worker_spec["factory"],
                  f.worker_spec.get("kwargs", {}),
                  f.slot_host(self.actor_id), f.hosts,
                  f.worker_spec.get("device")),
            name=f"{f.name}-{self.actor_id}", daemon=True)
        self.proc.start()
        child.close()                    # parent keeps one end only
        # stage the current snapshot for the fresh worker so a
        # restarted slot never rolls out against nothing (the sender
        # thread ships it once the worker starts draining)
        weights, version = f.get_weights()
        self.publish(ipc.frame_payload(("weights", version,
                                        _to_host(weights))))

    def start(self) -> None:
        self._launch()
        self._sender = threading.Thread(
            target=self._send_loop,
            name=f"{self.fleet.name}-{self.actor_id}-send", daemon=True)
        self._sender.start()
        super().start()

    def publish(self, blob: bytes) -> None:
        """Stage an already-framed message for the worker — latest
        wins, never blocks (only the NEWEST weights snapshot matters)."""
        with self._outbox_lock:
            self._outbox = blob
        self._outbox_ev.set()

    def _take_outbox(self) -> Optional[bytes]:
        with self._outbox_lock:
            blob, self._outbox = self._outbox, None
            self._outbox_ev.clear()
        return blob

    def _send_loop(self):
        """Sole WRITER of the parent-side connection (the pump is the
        sole reader, so the duplex pipe never sees two concurrent users
        of one direction)."""
        while not self.stop_event.is_set():
            if not self._outbox_ev.wait(timeout=0.2):
                continue
            blob = self._take_outbox()
            if blob is None:
                continue
            try:
                ipc.send_blob(self.conn, blob)
            except (OSError, BrokenPipeError, ValueError):
                return
        blob = self._take_outbox()       # final frame (the stop message)
        if blob is not None:
            try:
                ipc.send_blob(self.conn, blob)
            except (OSError, BrokenPipeError, ValueError):
                pass

    def request_stop(self) -> None:
        self.publish(ipc.frame_payload(("stop",)))
        self.stop_event.set()

    def hard_kill(self) -> None:
        """Unlike a hung thread, a hung PROCESS can be killed."""
        try:
            if self.proc is not None and self.proc.is_alive():
                self.proc.terminate()
        except Exception:
            pass

    def finalize(self, timeout: float = 2.0) -> None:
        """Reap the worker process after the pump thread is done."""
        if self.proc is None:
            return
        try:
            self.proc.join(timeout=timeout)
            if self.proc.is_alive():
                self.proc.terminate()
                self.proc.join(timeout=1.0)
        except Exception:
            pass

    def run(self):
        f = self.fleet
        shard = f.shard_queue(self.actor_id)
        while not self.stop_event.is_set():
            try:
                if not self.conn.poll(0.2):
                    if self.proc is not None and not self.proc.is_alive() \
                            and not self.conn.poll(0):
                        # silently-dead worker (SIGKILL'd mid-rollout):
                        # nothing buffered, channel will never speak —
                        # the last beat frame named the killing iteration
                        if self.error is None:
                            self.error = RuntimeError(
                                f"actor process exited (code "
                                f"{self.proc.exitcode})")
                        return
                    continue
                msg = ipc.recv_msg(self.conn)
            except ipc.CorruptPayloadError as e:
                # a worker died mid-send (or shipped garbage): drop the
                # one broken frame, log it, keep pumping — the learner
                # iteration is never poisoned by a truncated payload
                f._log("ipc_corrupt_payload", actor=self.actor_id,
                       error=repr(e))
                f._counter("ipc_corrupt_payloads")
                continue
            except (EOFError, OSError):
                if not self.stop_event.is_set() and self.error is None:
                    code = (self.proc.exitcode if self.proc is not None
                            else None)
                    self.error = RuntimeError(
                        f"actor process channel closed (exit code {code})")
                return
            kind = msg[0]
            if kind == "beat":
                self.iteration = int(msg[1])
                self.last_beat = time.monotonic()
            elif kind == "result":
                it, version, out = int(msg[1]), int(msg[2]), msg[3]
                self.last_beat = time.monotonic()
                item = (self.actor_id, it, version, out)
                while not self.stop_event.is_set():
                    try:
                        # bounded shard: back-pressure blocks HERE (and
                        # transitively the worker, once the pipe buffer
                        # fills); re-beat so back-pressure is never
                        # mistaken for a hung worker
                        shard.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        self.last_beat = time.monotonic()
                self.iteration = it + 1
            elif kind == "error":
                self.iteration = int(msg[1])
                self.error = RuntimeError(msg[2])
                return

    def join(self, timeout: Optional[float] = None) -> None:
        if self.ident is not None:       # pump thread actually started
            super().join(timeout=timeout)
        if not self.is_alive():
            self.finalize()


class RestartTracker:
    """Per-slot backoff-restart accounting of :meth:`Fleet.poll`, in a
    class of its own so a replica fleet can share the actor semantics:

    * :meth:`note_down` schedules a backoff-delayed respawn for a slot
      (carrying an opaque resume ``token`` — the actor fleet's next
      iteration, the serve fleet's replica spec) or, when the slot has
      exhausted ``max_restarts``, moves it to :attr:`failed`
      permanently;
    * :meth:`due` pops the respawns whose backoff has elapsed,
      incrementing each slot's restart count.

    Time is always an explicit ``now`` (monotonic seconds) so callers
    with an injected clock — the router's autoscale tests — drive the
    schedule deterministically.  NOT thread-safe by itself: callers
    serialize access (Fleet polls from one loop; the router holds its
    supervision to one thread)."""

    def __init__(self, max_restarts: int, backoff: BackoffPolicy,
                 rng=None):
        import random

        self.max_restarts = int(max_restarts)
        self.backoff = backoff
        self._rng = rng if rng is not None else random.Random(0)
        self.pending: dict = {}        # slot -> (due_monotonic, token)
        self.failed: set = set()       # slots past max_restarts
        self.restarts: dict = {}       # slot -> completed restart count

    def tracked(self, slot) -> bool:
        """True while the slot is awaiting respawn or permanently down
        (a supervision pass must not re-handle it)."""
        return slot in self.pending or slot in self.failed

    def attempts(self, slot) -> int:
        return int(self.restarts.get(slot, 0))

    def restarts_total(self) -> int:
        return sum(self.restarts.values())

    def note_down(self, slot, token=None,
                  now: Optional[float] = None) -> Optional[float]:
        """Record a down slot.  Returns the backoff delay (seconds)
        until its scheduled respawn, or None when the slot just
        exhausted ``max_restarts`` and joined :attr:`failed`."""
        now = time.monotonic() if now is None else now
        n = self.attempts(slot)
        if n >= self.max_restarts:
            self.failed.add(slot)
            return None
        delay = self.backoff.delay(n, self._rng)
        self.pending[slot] = (now + delay, token)
        return delay

    def due(self, now: Optional[float] = None) -> list:
        """Pop and return ``[(slot, token), ...]`` whose backoff has
        elapsed, counting each as one completed restart."""
        now = time.monotonic() if now is None else now
        out = []
        for slot in list(self.pending):
            due_t, token = self.pending[slot]
            if now >= due_t:
                del self.pending[slot]
                self.restarts[slot] = self.attempts(slot) + 1
                out.append((slot, token))
        return out


class Fleet:
    """A supervised set of ``n_actors`` worker threads or processes
    (see module doc).

    ``actor_mode="process"`` requires ``worker_spec``, a picklable
    ``{"factory": "module:callable", "kwargs": {...}}`` that each spawned
    worker resolves into its work function (closures cannot cross a
    process boundary); ``work_fn`` may then be None.  An optional
    ``worker_spec["device"]`` is the worker's device (a CUDA device
    becomes its current device; the learners pass their own device, and
    tests pass "cpu").  ``hosts > 1`` splits the slots into contiguous
    simulated-host blocks (``slot_host``)."""

    def __init__(self, n_actors: int, work_fn: Optional[WorkFn], *,
                 name: str = "actor", heartbeat_timeout: float = 60.0,
                 max_restarts: int = 3,
                 backoff: Optional[BackoffPolicy] = None, seed: int = 0,
                 queue_depth: int = 2, actor_mode: str = "thread",
                 worker_spec: Optional[dict] = None, hosts: int = 1):
        if actor_mode not in ("thread", "process"):
            raise ValueError(f"actor_mode must be 'thread' or 'process', "
                             f"got {actor_mode!r}")
        if actor_mode == "process" and not worker_spec:
            raise ValueError("actor_mode='process' requires worker_spec "
                             "({'factory': 'module:callable', 'kwargs': "
                             "{...}}) — closures cannot cross a process "
                             "boundary")
        if actor_mode == "thread" and hosts != 1:
            raise ValueError("multi-host (simulated) fleets require "
                             "actor_mode='process'")
        self.n_actors = int(n_actors)
        self.work_fn = work_fn
        self.name = name
        self.actor_mode = actor_mode
        self.worker_spec = worker_spec
        self.hosts = max(1, int(hosts))
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.max_restarts = int(max_restarts)
        self.backoff = backoff or BackoffPolicy(base_s=0.25, factor=2.0,
                                                max_s=30.0, jitter=0.25)
        self._seed = seed
        if actor_mode == "process":
            # per-slot ingest shards: each slot owns a bounded queue, so
            # one hot producer cannot occupy the whole ingest budget and
            # per-slot depth is observable (the obs gauges); the shard
            # directory and slot->shard map are built once here and
            # never rewritten
            self._q = None
            self._shard_qs = [queue.Queue(maxsize=max(1, int(queue_depth)))
                              for _ in range(self.n_actors)]
            self._slot_shard = {i: i for i in range(self.n_actors)}
        else:
            # bounded to queue_depth results per actor slot: actors
            # block (with heartbeat) when the learner lags — staleness
            # stays bounded by the queue depth plus the publication
            # cadence instead of growing with every learner hiccup
            self._q = queue.Queue(
                maxsize=max(1, int(queue_depth)) * self.n_actors)
            self._shard_qs = None
            self._slot_shard = None
        self._rr = 0                         # collect()'s round-robin cursor
        self._weights: Any = None
        self._version = 0
        self._wlock = threading.Lock()
        self._actors: dict = {}              # slot -> _Actor (current)
        self._stopped = False
        import random
        self._rng = random.Random(seed)
        # restart schedule + failed set + counts live in the tracker
        # (shared with the serving replica fleet); the pending token is
        # the resume iteration
        self._tracker = RestartTracker(self.max_restarts, self.backoff,
                                       rng=self._rng)

    # -- sharded ingest ----------------------------------------------------
    def slot_host(self, slot: int) -> int:
        """Simulated host id of ``slot`` — contiguous blocks, so a
        2-host 8-actor fleet is slots 0-3 on host 0, 4-7 on host 1."""
        return (slot * self.hosts) // self.n_actors

    def shard_queue(self, slot: int) -> "queue.Queue":
        """The bounded ingest queue slot ``slot`` produces into (the
        global queue in thread mode)."""
        if self._shard_qs is None:
            return self._q
        return self._shard_qs[self._slot_shard[slot]]

    def queue_depths(self) -> dict:
        """Current ingest depth per shard plus the aggregate — the
        single-slow-shard visibility the global-queue gauge lacked.
        Thread mode reports only the aggregate (one global queue)."""
        if self._shard_qs is None:
            return {"aggregate": self._q.qsize()}
        depths = {i: q.qsize() for i, q in enumerate(self._shard_qs)}
        return {"aggregate": sum(depths.values()), "per_slot": depths}

    # -- weights snapshot --------------------------------------------------
    def set_weights(self, weights: Any, version: Optional[int] = None
                    ) -> int:
        """Publish a fresh snapshot.  ``version`` pins the snapshot's
        version explicitly (the async learner stamps its own
        learner-round counter so staleness-in-versions is measured in
        learner rounds, and a resumed run continues its predecessor's
        version stream); default keeps the auto-increment."""
        with self._wlock:
            self._weights = weights
            if version is not None:
                self._version = int(version)
            else:
                self._version += 1
            v = self._version
        if self.actor_mode == "process":
            # serialize ONCE, fan the framed snapshot out to every live
            # worker (a dead worker's publish is a no-op; its
            # replacement receives the current snapshot at spawn)
            blob = ipc.frame_payload(("weights", v, _to_host(weights)))
            for a in self._actors.values():
                if isinstance(a, _ProcessActor) and a.is_alive():
                    a.publish(blob)
        return v

    def get_weights(self):
        with self._wlock:
            return self._weights, self._version

    @property
    def version(self) -> int:
        with self._wlock:
            return self._version

    # -- lifecycle ---------------------------------------------------------
    def start(self, weights: Any, start_iterations: Optional[dict] = None,
              version: Optional[int] = None) -> None:
        """Spawn every actor slot.  ``start_iterations`` (slot -> first
        rollout iteration; default 0) lets a resumed run continue each
        slot's deterministic key stream where its predecessor stopped —
        the fleet half of the checkpoint payload (``slot_iterations``)."""
        self.set_weights(weights, version=version)
        start_iterations = start_iterations or {}
        for i in range(self.n_actors):
            self._spawn(i, start_iteration=int(start_iterations.get(i, 0)))
        self._gauge()

    def slot_iterations(self) -> dict:
        """slot -> the next rollout iteration that slot would run — what
        a checkpoint must record so a resumed fleet continues every
        per-(actor, iteration) key stream instead of replaying it.
        Pending restarts report their scheduled resume iteration; a DEAD
        actor reports the iteration AFTER the one that killed it (the
        same poison-pill skip the live restart path applies — resuming
        at the killing iteration would crash-loop the slot on every
        resume)."""
        out = {}
        for slot in range(self.n_actors):
            if slot in self._tracker.pending:
                out[slot] = int(self._tracker.pending[slot][1])
            elif slot in self._actors:
                a = self._actors[slot]
                it = int(a.iteration)
                if not a.is_alive() and a.error is not None:
                    it += 1
                out[slot] = it
            else:
                out[slot] = 0
        return out

    def _spawn(self, slot: int, start_iteration: int) -> None:
        cls = _ProcessActor if self.actor_mode == "process" else _Actor
        a = cls(self, slot, start_iteration)
        self._actors[slot] = a
        a.start()

    def stop(self, join: bool = True, timeout: float = 10.0) -> int:
        """Signal every actor to stop; with ``join`` wait for each thread
        (hung threads are daemons and are abandoned after ``timeout``).
        Returns the number of threads that actually joined.  Idempotent —
        a second call (trip path, then the loop's finally) is a no-op."""
        if self._stopped:
            return 0
        self._stopped = True
        for a in self._actors.values():
            if isinstance(a, _ProcessActor):
                a.request_stop()
            else:
                a.stop_event.set()
        joined = 0
        if join:
            deadline = time.monotonic() + timeout
            for a in self._actors.values():
                a.join(timeout=max(0.0, deadline - time.monotonic()))
                joined += 0 if a.is_alive() else 1
        self._log("actors_stopped", joined=joined,
                  total=len(self._actors))
        self._gauge()
        return joined

    # -- collection --------------------------------------------------------
    def collect(self, max_items: int, timeout: float) -> list:
        """Up to ``max_items`` queued results, waiting at most ``timeout``
        seconds TOTAL for the first one (later ones are taken only if
        already queued).  Returns [(actor_id, iteration, weights_version,
        result), ...] — possibly empty when the whole fleet is down.

        Process mode drains the per-slot ingest shards round-robin
        (rotating the starting shard every call) so one hot slot can
        never monopolize a collection round while another shard backs
        up unseen."""
        deadline = time.monotonic() + timeout
        if self._shard_qs is None:
            out = []
            while len(out) < max_items:
                remaining = deadline - time.monotonic()
                try:
                    if not out and remaining > 0:
                        out.append(self._q.get(timeout=remaining))
                    else:
                        out.append(self._q.get_nowait())
                except queue.Empty:
                    break
            return out
        out: list = []
        n = len(self._shard_qs)
        start = self._rr
        self._rr = (self._rr + 1) % n
        while len(out) < max_items:
            got = False
            for k in range(n):
                if len(out) >= max_items:
                    break
                try:
                    out.append(
                        self._shard_qs[(start + k) % n].get_nowait())
                    got = True
                except queue.Empty:
                    continue
            if got:
                continue
            if out or time.monotonic() >= deadline:
                break
            time.sleep(0.01)
        return out

    # -- supervision -------------------------------------------------------
    @property
    def alive_count(self) -> int:
        return sum(1 for a in self._actors.values() if a.is_alive())

    @property
    def failed_slots(self) -> set:
        return set(self._tracker.failed)

    def restarts_total(self) -> int:
        return self._tracker.restarts_total()

    def poll(self) -> list:
        """One supervision pass: detect dead/hung actors, schedule and
        perform backoff-delayed restarts.  Returns the list of event
        dicts emitted this pass (also logged to the RunLog)."""
        if self._stopped:
            return []
        now = time.monotonic()
        events = []
        for slot in range(self.n_actors):
            if self._tracker.tracked(slot):
                continue
            a = self._actors.get(slot)
            if a is None:
                continue
            dead = not a.is_alive()
            hung = (not dead and not a.stop_event.is_set()
                    and now - a.last_beat > self.heartbeat_timeout)
            if not dead and not hung:
                continue
            if hung:
                # can't kill a python thread: abandon it (daemon) and
                # make sure it exits if it ever wakes up.  A hung
                # PROCESS, unlike a thread, can actually be killed.
                a.stop_event.set()
                if isinstance(a, _ProcessActor):
                    a.hard_kill()
            if isinstance(a, _ProcessActor):
                # reap the dead/killed worker NOW — _spawn() replaces
                # the slot entry, and a slot past max_restarts never
                # respawns, so without this the zombie (and its pipe
                # fds) would linger until interpreter exit
                a.finalize(timeout=1.0)
            reason = (f"error:{a.error!r}" if dead and a.error is not None
                      else ("exited" if dead else "hung"))
            n = self._tracker.attempts(slot)
            # the replacement skips the iteration that killed its
            # predecessor (poison-pill protection)
            delay = self._tracker.note_down(slot, token=a.iteration + 1,
                                            now=now)
            if delay is None:
                ev = {"event": "actor_failed", "actor": slot,
                      "reason": reason, "restarts": n}
            else:
                ev = {"event": "actor_down", "actor": slot,
                      "reason": reason, "iteration": a.iteration,
                      "restart_in_s": round(delay, 3), "attempt": n + 1}
            events.append(ev)
            self._log(**ev)
        for slot, it in self._tracker.due(now):
            self._spawn(slot, start_iteration=int(it))
            ev = {"event": "actor_restart", "actor": slot,
                  "iteration": int(it),
                  "attempt": self._tracker.attempts(slot)}
            events.append(ev)
            self._log(**ev)
            self._counter("actor_restarts")
        if events:
            self._gauge()
        return events

    def wait_pending(self, timeout: float = 30.0) -> None:
        """Block until no restart is pending (tests; bounded)."""
        deadline = time.monotonic() + timeout
        while self._tracker.pending and time.monotonic() < deadline:
            time.sleep(0.01)
            self.poll()

    # -- telemetry ---------------------------------------------------------
    def _log(self, event: str = "actor_event", **fields) -> None:
        try:
            from smartcal_tpu_torch import obs
            rl = obs.active()
            if rl is not None:
                rl.log(fields.pop("event", event), **fields)
        except Exception:
            pass

    def _gauge(self) -> None:
        try:
            from smartcal_tpu_torch import obs
            obs.gauge_set("actors_alive", self.alive_count)
        except Exception:
            pass

    def _counter(self, name: str) -> None:
        try:
            from smartcal_tpu_torch import obs
            obs.counter_add(name)
        except Exception:
            pass
