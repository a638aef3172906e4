"""The port's replicated serving fleet (``smartcal_tpu_torch/serve/
fleet.py``, ``serve/loadgen.py``): case for case the JAX package's
tests/test_serve_fleet.py (RestartTracker schedule units, FleetRouter
dispatch against scripted in-process fake replicas, load-gen accounting,
spawn end to end on stdlib stub servers), the same scripted scenarios
through the JAX router and the port's (equal decisions and events), and a
real two-replica CalibServer fleet on the CPU sharing one program cache:
the second replica warm-starts from it.

The spawned stub replicas are the package's own ``SleepServer``
(``sleep_worker_spec``), which stands in for the JAX tests' StubServer:
both echo a job's ``k`` as its ``sigma_res``."""

import threading
import time

import pytest

from smartcal_tpu.serve import fleet as jax_fleet
from smartcal_tpu.serve import loadgen as jax_loadgen
from smartcal_tpu_torch.runtime.backoff import BackoffPolicy
from smartcal_tpu_torch.runtime.supervisor import RestartTracker
from smartcal_tpu_torch.serve import fleet as serve_fleet
from smartcal_tpu_torch.serve import loadgen
from smartcal_tpu_torch.serve.fleet import AutoscalePolicy, FleetRouter
from smartcal_tpu_torch.serve.router import Job, JobResult, ShedError

STUB = serve_fleet.sleep_worker_spec(lanes=2, service_s=0.01, beat_s=0.05)


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _fast_backoff():
    return BackoffPolicy(base_s=0.01, factor=2.0, max_s=0.05, jitter=0.0)


# ---------------------------------------------------------------------------
# RestartTracker schedule
# ---------------------------------------------------------------------------

def test_restart_tracker_schedule_and_exhaustion():
    tr = RestartTracker(max_restarts=2, backoff=_fast_backoff())
    assert not tr.tracked(0)
    d = tr.note_down(0, token="spec", now=100.0)
    assert d == pytest.approx(0.01)
    assert tr.tracked(0)
    assert tr.due(now=100.005) == []          # backoff not yet elapsed
    assert tr.due(now=100.02) == [(0, "spec")]
    assert not tr.tracked(0)
    assert tr.attempts(0) == 1
    assert tr.note_down(0, now=101.0) == pytest.approx(0.02)
    assert tr.due(now=102.0) == [(0, None)]
    assert tr.attempts(0) == 2
    # third death exhausts max_restarts=2: permanently failed
    assert tr.note_down(0, now=103.0) is None
    assert 0 in tr.failed and tr.tracked(0)
    assert tr.restarts_total() == 2
    # independent slots don't interact
    assert tr.note_down(1, now=103.0) == pytest.approx(0.01)
    assert 1 not in tr.failed


# ---------------------------------------------------------------------------
# router logic against scripted fakes (no processes)
# ---------------------------------------------------------------------------

class FakeReplica:
    """In-process stand-in for ``_Replica``: scripted gauges, records
    dispatches, dies on command.  ``t_spawn`` is the replica id so the
    reap-newest-victim choice is deterministic."""

    def __init__(self, router, replica_id, spec):
        self.router = router
        self.replica_id = replica_id
        self.spec = dict(spec)
        self.lanes = int(spec.get("lanes", 2))
        self.t_spawn = float(replica_id)
        self.last_beat = router._clock()
        self.ready = threading.Event()
        self.ready.set()
        self.ready_summary = {"wall_s": 0.0, "sources": {}}
        self.stop_event = threading.Event()
        self.error = None
        self.accept = True
        self.dispatched = []
        self._alive = True
        self._g = {"queue_depth": 0, "batch_fill": 0.0,
                   "circuit_open": False, "service_est_s": 0.05}
        self._pending = {}

    def start(self):
        pass

    def healthy(self):
        return self._alive and self.error is None

    def request_stop(self):
        self.stop_event.set()

    def hard_kill(self):
        self._alive = False

    def finalize(self, timeout=2.0):
        pass

    def shutdown(self, timeout=5.0):
        self.stop_event.set()

    def gauges(self):
        g = dict(self._g)
        g["pending"] = len(self._pending)
        return g

    def pending_count(self):
        return len(self._pending)

    def dispatch(self, job):
        if not self.accept:
            return False
        self._pending[job.job_id] = job
        self.dispatched.append(job)
        return True

    def take_pending(self):
        jobs = list(self._pending.values())
        self._pending.clear()
        return jobs


def _fake_router(clk, **kw):
    kw.setdefault("backoff", _fast_backoff())
    kw.setdefault("max_restarts", 3)
    kw.setdefault("heartbeat_timeout", 1e9)  # fake-clock jumps are not hangs
    return FleetRouter({"lanes": 2}, replicas=0,
                       replica_factory=FakeReplica,
                       clock=lambda: clk[0], **kw)


def test_router_dispatch_least_loaded():
    clk = [0.0]
    router = _fake_router(clk)
    r0, r1, r2 = (router._spawn_replica() for _ in range(3))
    r0._g["queue_depth"] = 4
    r1._g["queue_depth"] = 0
    r2._g["queue_depth"] = 2
    job = Job(episode=None, k=1, t_submit=0.0)
    fut = router.submit(job)
    assert r1.dispatched == [job] and not r0.dispatched
    assert fut is job.future
    assert router.stats()["dispatched"] == 1
    # r1 now carries 1 pending; next job still lands on the emptiest
    job2 = Job(episode=None, k=2, t_submit=0.0)
    router.submit(job2)
    assert r1.dispatched == [job, job2]      # backlog 0.5 still < r2's 1.0


def test_router_batch_fill_tiebreak():
    clk = [0.0]
    router = _fake_router(clk)
    r0, r1 = (router._spawn_replica() for _ in range(2))
    r0._g["batch_fill"] = 0.9
    r1._g["batch_fill"] = 0.3
    job = Job(episode=None, k=1, t_submit=0.0)
    router.submit(job)
    assert r1.dispatched == [job]            # equal backlog: lower fill


def test_router_deadline_narrows_then_falls_back():
    clk = [0.0]
    router = _fake_router(clk)
    slow, fast = (router._spawn_replica() for _ in range(2))
    slow._g["service_est_s"] = 5.0           # eta 5s: misses the SLO
    fast._g["service_est_s"] = 0.1
    fast._g["queue_depth"] = 2               # more loaded, but fits slack
    job = Job(episode=None, k=1, deadline_s=1.0, t_submit=0.0)
    router.submit(job)
    assert fast.dispatched == [job]
    # when NO replica fits the slack, fall back to least-loaded rather
    # than shedding a servable job (late answer beats no answer)
    fast._g["service_est_s"] = 9.0
    job2 = Job(episode=None, k=1, deadline_s=1.0, t_submit=0.0)
    router.submit(job2)
    assert slow.dispatched == [job2]         # backlog 0 < fast's 1


def test_router_sheds_fleet_down_and_saturated():
    clk = [0.0]
    router = _fake_router(clk)
    with pytest.raises(ShedError) as ei:
        router.submit(Job(episode=None, k=1, t_submit=0.0))
    assert ei.value.reason == "fleet_down"
    r0 = router._spawn_replica()
    r0.accept = False                        # outbox full on every try
    with pytest.raises(ShedError) as ei:
        router.submit(Job(episode=None, k=1, t_submit=0.0))
    assert ei.value.reason == "fleet_saturated"
    st = router.stats()
    assert st["shed"] == 2
    assert st["shed_reasons"] == {"fleet_down": 1, "fleet_saturated": 1}


def test_router_requeues_lost_jobs_then_respawns():
    clk = [0.0]
    router = _fake_router(clk, max_requeues=1)
    r0, r1 = (router._spawn_replica() for _ in range(2))
    jobs = [Job(episode=None, k=i, t_submit=0.0) for i in range(4)]
    for j in jobs:
        router.submit(j)
    lost = list(r0._pending.values())
    assert lost and r1._pending               # dispatch spread both ways
    r0.hard_kill()
    events = router.poll()
    kinds = [e["event"] for e in events]
    assert "fleet_replica_down" in kinds
    # every job r0 held moved to the survivor, marked as a requeue
    for j in lost:
        assert j.job_id in r1._pending
        assert j.requeues == 1
    st = router.stats()
    assert st["requeued"] == len(lost)
    assert st["shed"] == 0                    # nothing shed unnecessarily
    # backoff elapses on the injected clock -> same-slot respawn
    clk[0] = 1.0
    events = router.poll()
    assert [e["event"] for e in events] == ["fleet_replica_restart"]
    assert router.replicas_alive() == 2
    assert router.stats()["replica_restarts"] == 1


def test_router_bounded_requeues_shed_replica_lost():
    clk = [0.0]
    router = _fake_router(clk, max_requeues=0)
    r0 = router._spawn_replica()
    job = Job(episode=None, k=1, t_submit=0.0)
    fut = router.submit(job)
    r0.hard_kill()
    router.poll()
    with pytest.raises(ShedError) as ei:
        fut.result(timeout=1.0)
    assert ei.value.reason == "replica_lost"
    assert router.stats()["shed_reasons"] == {"replica_lost": 1}


def test_router_replica_exhaustion_opens_its_circuit_only():
    clk = [0.0]
    router = _fake_router(clk, max_restarts=0)
    r0, r1 = (router._spawn_replica() for _ in range(2))
    r0.hard_kill()
    events = router.poll()
    assert [e["event"] for e in events] == ["fleet_replica_failed"]
    assert events[0]["replica"] == 0 and events[0]["reason"] == "exited"
    assert router.stats()["failed_replicas"] == [0]
    # the fleet stays up on the survivor: no fleet_down
    job = Job(episode=None, k=1, t_submit=0.0)
    router.submit(job)
    assert r1.dispatched == [job]


def test_router_hung_replica_killed_by_heartbeat():
    clk = [100.0]
    router = _fake_router(clk, heartbeat_timeout=2.0)
    r0 = router._spawn_replica()
    r0.last_beat = 100.0
    assert router.poll() == []               # fresh beat: healthy
    clk[0] = 103.0                           # beat 3s stale > 2s timeout
    events = router.poll()
    assert events[0]["event"] == "fleet_replica_down"
    assert events[0]["reason"] == "hung"
    assert not r0._alive                     # hard-killed


def test_router_autoscale_spawns_and_reaps():
    clk = [0.0]
    pol = AutoscalePolicy(min_replicas=1, max_replicas=4,
                          spawn_depth=2.0, spawn_sustain_s=1.0,
                          reap_idle_s=1.0, cooldown_s=0.0)
    router = _fake_router(clk, autoscale=pol)
    r0 = router._spawn_replica()
    r0._g["queue_depth"] = 4                 # 4 jobs over 1 replica
    assert router.poll() == []               # pressure noted, not sustained
    clk[0] = 1.5
    events = router.poll()
    assert [e["event"] for e in events] == ["fleet_scale_up"]
    assert router.replicas_alive() == 2
    assert router.stats()["scale_ups"] == 1
    # drain the fleet -> sustained idle reaps the NEWEST replica back
    # down to min_replicas
    r0._g["queue_depth"] = 0
    clk[0] = 2.0
    assert router.poll() == []               # idle noted, not sustained
    clk[0] = 3.5
    events = router.poll()
    assert [e["event"] for e in events] == ["fleet_scale_down"]
    assert events[0]["replica"] == 1         # newest (t_spawn = rid)
    assert router.replicas_alive() == 1
    assert router.stats()["scale_downs"] == 1
    # at min_replicas, idle never reaps the last replica
    clk[0] = 10.0
    assert router.poll() == []               # idle clock restarts
    clk[0] = 20.0
    assert router.poll() == []               # sustained, but at the floor
    assert router.replicas_alive() == 1


# ---------------------------------------------------------------------------
# load-gen accounting
# ---------------------------------------------------------------------------

def _result(i, miss=False):
    return JobResult(job_id=i, lane=0, batch_id=0, sigma_res=0.1,
                     sigma_data_img=0.0, sigma_res_img=0.0, img_std=0.0,
                     degraded=False, queue_wait_s=0.0, service_s=0.1,
                     total_s=0.2, deadline_miss=miss)


def test_summarize_buckets_are_disjoint_and_sum():
    gen = loadgen.OpenLoopLoadGen(None, [(1, None)], rate=2.0,
                                  duration_s=1.0)
    results = [_result(i, miss=(i % 2 == 0)) for i in range(4)]
    out = gen.summarize(9, 3, results,
                        shed_reasons={"queue_full": 2, "replica_lost": 1},
                        failed=2)
    assert out["shed"] == 3
    assert sum(out["shed_reasons"].values()) == out["shed"]
    assert out["completed"] == 4 and out["failed"] == 2
    assert out["accounted"] == out["shed"] + out["failed"] \
        + out["completed"] == 9
    # deadline misses are the served-late SUBSET of completed, never
    # double-counted against sheds
    assert out["deadline_missed"] == 2 <= out["completed"]


def test_loadgen_pick_validation():
    with pytest.raises(ValueError, match="pick"):
        loadgen.OpenLoopLoadGen(None, [], rate=1.0, duration_s=1.0,
                                pick="fifo")


class _PoolBackend:
    """Records what build_job_pool asked for (no jax episode build)."""

    def new_calib_episode(self, key, kdirs, M, diffuse=False):
        return ("ep", kdirs, diffuse), None


def test_build_job_pool_mixed_vs_uniform():
    pool = loadgen.build_job_pool(_PoolBackend(), 4, 32, seed=0)
    ks = sorted({k for k, _ in pool})
    assert set(ks) <= {2, 3, 4} and len(ks) >= 2   # heterogeneous K
    diffuse = [ep[2] for _, ep in pool]
    assert any(diffuse) and not all(diffuse)       # mixed sky types
    # the uniform flag reproduces the deterministic K cycle exactly
    pool_u = loadgen.build_job_pool(_PoolBackend(), 4, 6, seed=0,
                                    mixed=False)
    assert [k for k, _ in pool_u] == [2, 3, 4, 2, 3, 4]
    assert not any(ep[2] for _, ep in pool_u)


# ---------------------------------------------------------------------------
# spawn e2e on jax-free stub servers
# ---------------------------------------------------------------------------

def _drain(futures, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    out = []
    for f in futures:
        out.append(f.result(timeout=max(0.1,
                                        deadline - time.monotonic())))
    return out


def test_fleet_stub_round_trip_two_replicas():
    router = FleetRouter(STUB, replicas=2, heartbeat_timeout=10.0,
                         poll_s=0.02, backoff=_fast_backoff())
    try:
        warm = router.start(warm_timeout_s=60.0, stagger=False)
        assert sorted(warm) == [0, 1]
        assert all(w["sources"] == {"solve": "sleep"}
                   for w in warm.values())
        jobs = [Job(episode=None, k=i % 5) for i in range(8)]
        futs = [router.submit(j) for j in jobs]
        results = _drain(futs)
        # sigma_res round-trips the job's k: payloads reached a real
        # worker process and came back matched to the right future
        assert [r.sigma_res for r in results] == \
            [float(j.k) for j in jobs]
        assert all(r.job_id == j.job_id for r, j in zip(results, jobs))
        st = router.stats()
        assert st["completed"] == 8 and st["shed"] == 0
        assert st["replicas_alive"] == 2
    finally:
        router.stop()


def test_fleet_stub_kill_costs_only_in_flight_batch():
    """SIGKILL one of two replicas mid-run: every admitted job still
    completes (requeued to the survivor), nothing is shed, and the
    killed slot respawns."""
    router = FleetRouter(STUB, replicas=2, heartbeat_timeout=10.0,
                         poll_s=0.02, backoff=_fast_backoff(),
                         max_requeues=2)
    try:
        router.start(warm_timeout_s=60.0, stagger=False)
        jobs = [Job(episode=None, k=i % 5) for i in range(12)]
        futs = [router.submit(j) for j in jobs]
        assert router.kill_replica(0)
        results = _drain(futs)
        assert len(results) == 12
        assert [r.sigma_res for r in results] == \
            [float(j.k) for j in jobs]
        st = router.stats()
        assert st["completed"] == 12 and st["shed"] == 0
        deadline = time.monotonic() + 30.0
        while (router.stats()["replica_restarts"] < 1
               or router.replicas_alive() < 2):
            assert time.monotonic() < deadline, router.stats()
            time.sleep(0.05)
    finally:
        router.stop()


def test_fleet_stub_stop_sheds_shutdown():
    """Jobs still in flight at stop() shed with the structured
    ``shutdown`` reason on the future the client holds."""
    spec = serve_fleet.sleep_worker_spec(lanes=2, service_s=5.0,
                                         beat_s=0.05)
    router = FleetRouter(spec, replicas=1, poll_s=0.02,
                         backoff=_fast_backoff())
    try:
        router.start(warm_timeout_s=60.0)
        futs = [router.submit(Job(episode=None, k=1)) for _ in range(3)]
    finally:
        router.stop(timeout=3.0)
    reasons = set()
    for f in futs:
        try:
            f.result(timeout=1.0)
        except ShedError as e:
            reasons.add(e.reason)
    assert reasons <= {"shutdown"}
    st = router.stats()
    assert st["shed"] == st["shed_reasons"].get("shutdown", 0) > 0


# ---------------------------------------------------------------------------
# the same scripted scenarios through the JAX router and the port's
# ---------------------------------------------------------------------------

def _scenario(Router, Autoscale, JobCls):
    """Dispatch, a kill with requeue, a respawn and an autoscale cycle on
    scripted fakes and an injected clock; returns the decisions."""
    clk = [0.0]
    router = Router({"lanes": 2}, replicas=0, replica_factory=FakeReplica,
                    clock=lambda: clk[0], backoff=_fast_backoff(),
                    max_restarts=3, heartbeat_timeout=1e9, max_requeues=1,
                    autoscale=Autoscale(min_replicas=1, max_replicas=4,
                                        spawn_depth=2.0,
                                        spawn_sustain_s=1.0,
                                        reap_idle_s=1.0, cooldown_s=0.0))
    r0, r1, r2 = (router._spawn_replica() for _ in range(3))
    r0._g.update(queue_depth=4, batch_fill=0.2)
    r2._g.update(queue_depth=1, batch_fill=0.9, service_est_s=5.0)
    out = []
    for i in range(6):
        job = JobCls(episode=None, k=i, t_submit=0.0,
                     deadline_s=1.0 if i % 2 else None)
        router.submit(job)
        out.append(("dispatch", i, [r.replica_id for r in (r0, r1, r2)
                                    if job in r.dispatched]))
    r1.hard_kill()
    for t in (0.0, 1.0, 2.5, 4.0):
        clk[0] = t
        out.append(("poll", t, [{k: v for k, v in e.items()}
                                for e in router.poll()]))
    st = router.stats()
    out.append(("stats", {k: st[k] for k in (
        "submitted", "dispatched", "requeued", "shed", "shed_reasons",
        "replica_restarts", "scale_ups", "scale_downs",
        "replicas_alive")}))
    return out


def test_router_decisions_equal_the_jax_router():
    from smartcal_tpu.serve.router import Job as JaxJob

    got = _scenario(FleetRouter, AutoscalePolicy, Job)
    want = _scenario(jax_fleet.FleetRouter, jax_fleet.AutoscalePolicy,
                     JaxJob)
    assert got == want
    assert any(e[0] == "poll" and e[2] for e in got)


def test_loadgen_tiers_summary_and_pool_equal_jax():
    """The tiers, the summary of the same results and the pool's draws
    (K, sky type and the episode keys, ``prng`` against ``jax.random``)
    are the JAX package's."""
    import numpy as np

    from smartcal_tpu.serve.router import JobResult as JaxResult

    assert loadgen.SERVE_TIERS == jax_loadgen.SERVE_TIERS
    for Res, lg in ((JobResult, loadgen), (JaxResult, jax_loadgen)):
        res = [Res(job_id=i, lane=0, batch_id=0, sigma_res=0.1,
                   sigma_data_img=0.0, sigma_res_img=0.0, img_std=0.0,
                   degraded=False, queue_wait_s=0.01 * i, service_s=0.1,
                   total_s=0.2 + 0.05 * i, deadline_miss=(i % 3 == 0))
               for i in range(7)]
        gen = lg.OpenLoopLoadGen(None, [(1, None)], rate=3.0,
                                 duration_s=2.0)
        out = gen.summarize(11, 3, res, shed_reasons={"queue_full": 3},
                            failed=1)
        if Res is JobResult:
            port_summary = out
    assert port_summary == out

    class _KeyBackend:
        def __init__(self):
            self.calls = []

        def new_calib_episode(self, key, kdirs, M, diffuse=False):
            self.calls.append((np.asarray(key).tolist(), kdirs, diffuse))
            return ("ep", kdirs, diffuse), None

    for mixed in (True, False):
        tb, jb = _KeyBackend(), _KeyBackend()
        tp = loadgen.build_job_pool(tb, 5, 12, seed=3, mixed=mixed)
        jp = jax_loadgen.build_job_pool(jb, 5, 12, seed=3, mixed=mixed)
        assert tb.calls == jb.calls
        assert [k for k, _ in tp] == [k for k, _ in jp]


def test_replicas_all_on_host_zero():
    """One machine: every replica's host is 0 and its spec says one host,
    whatever ``hosts`` the router was given."""
    router = FleetRouter({"lanes": 2}, replicas=0, hosts=2,
                         replica_factory=FakeReplica,
                         backoff=_fast_backoff())
    for rid in range(4):
        assert router.replica_host(rid) == 0
        spec = router._replica_spec(rid)
        assert spec["host_id"] == 0 and spec["n_hosts"] == 1


def test_episode_payload_round_trip():
    """A job's episode crosses the process boundary as host numpy and is
    rebuilt on the replica's device, field for field."""
    import numpy as np
    import torch

    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.envs.radio import RadioBackend

    be = RadioBackend(device="cpu", **loadgen.SERVE_TIERS["tiny"])
    ep, _ = be.new_calib_episode(prng.PRNGKey(2), 2, 3)
    job = Job(episode=ep, k=2, rho=np.ones(2, np.float32))
    payload = serve_fleet._job_payload(job)
    host = payload["episode"]
    assert isinstance(host.V, np.ndarray)
    assert isinstance(host.obs.uvw, np.ndarray)
    back = serve_fleet._episode_from_host(host, torch.device("cpu"))
    for a, b in ((back.V, ep.V), (back.Ccal, ep.Ccal),
                 (back.obs.uvw, ep.obs.uvw), (back.obs.freqs, ep.obs.freqs)):
        assert isinstance(a, torch.Tensor) and torch.equal(a, b)
    assert (back.f0, back.n_dirs, back.snr) == (ep.f0, ep.n_dirs, ep.snr)
    assert payload["k"] == 2 and payload["job_id"] == job.job_id


# ---------------------------------------------------------------------------
# real CalibServer fleet: shared-cache warm start
# ---------------------------------------------------------------------------

def test_fleet_shared_cache_second_replica_compiles_nothing(tmp_path):
    """Replica 0 builds the shared program cache cold (staggered start);
    replica 1 then warms up entirely from it (every program from the
    cache, no miss, no nvcc build) and real jobs round-trip through both;
    the replicas' run logs count no steady-state compile event."""
    from smartcal_tpu_torch.envs import radio
    from smartcal_tpu_torch.serve.fleet import calib_worker_spec

    cache = str(tmp_path / "cache")
    spec = calib_worker_spec(loadgen.SERVE_TIERS["tiny"], M=3, lanes=2,
                             cache_dir=cache, device="cpu", max_wait_s=0.02,
                             max_queue=16)
    spec["beat_s"] = 0.1
    router = FleetRouter(spec, replicas=2, poll_s=0.05,
                         backoff=_fast_backoff(),
                         metrics_dir=str(tmp_path / "procs"))
    try:
        warm = router.start(warm_timeout_s=300.0, stagger=True)
        w0, w1 = warm[0], warm[1]
        assert w0["export_cache_prepared_miss"] == 2 \
            and w1["export_cache_prepared_miss"] == 0
        assert w1["export_cache_prepared_hit"] == 2
        assert all(src == "cache" for src in w1["sources"].values())
        assert w1["compile_events:nvcc"] == 0
        backend = radio.RadioBackend(device="cpu",
                                     **loadgen.SERVE_TIERS["tiny"])
        pool = loadgen.build_job_pool(backend, 3, 2, seed=1)
        time.sleep(0.3)
        c0 = {rid: g["compile_events"]
              for rid, g in router.stats()["per_replica"].items()}
        jobs = [Job(episode=ep, k=k) for k, ep in pool * 2]
        results = _drain([router.submit(j) for j in jobs], timeout_s=300.0)
        assert len(results) == 4
        assert all(r.sigma_res > 0 for r in results)
        time.sleep(0.3)
        st = router.stats()
        assert st["completed"] == 4 and st["shed"] == 0
        assert {rid: g["compile_events"] for rid, g in
                st["per_replica"].items()} == c0
    finally:
        router.stop(timeout=20.0)
