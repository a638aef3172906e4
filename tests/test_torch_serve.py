"""The port's serving layer (``smartcal_tpu_torch/serve``): the program
cache, heterogeneous-lane micro-batching, the circuit breaker, the
numerics sentinel and the SLO telemetry, case for case the JAX package's
tests/test_serve.py, and against the JAX ``CalibServer`` on the same
handed-over episodes (``interop.job_from_jax``).

The JAX server and the port's are module fixtures (one warmup each).  The
served lanes are held at tests/test_torch_batched_radio.py's tolerances:
sigma_res and the image std at the relative 1e-3, the reward's image
sigmas at rtol 2e-3 / atol 1e-4.  On the CPU no CUDA graph is captured,
so the line search's capture is emulated: every line search records one
``cuda_graph`` compile event at its first call, as on the card, and a
warmed server's batch must record none.
"""

import json
import time

import numpy as np
import pytest

import jax

from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu.serve import CalibServer as JaxServer
from smartcal_tpu.serve import Job as JaxJob
from smartcal_tpu.serve import sig_digest as jax_sig_digest
from smartcal_tpu_torch import interop, obs
from smartcal_tpu_torch.cal import solver
from smartcal_tpu_torch.envs import calib as calib_env
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.runtime.backoff import BackoffPolicy
from smartcal_tpu_torch.serve import (CalibServer, Job, MicroBatcher,
                                      ShedError, sig_digest)

M = 3
LANES = 3
SEED = 7
TINY = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=32)
TOL = 1e-3                                 # tests/test_torch_batched_radio.py
IMG = dict(rtol=2e-3, atol=2e-5)
REWARD = dict(rtol=2e-3, atol=1e-4)


def tiny_backend(**kw):
    return RadioBackend(device="cpu", **dict(TINY, **kw))


class _Captures:
    """Emulates the card's capture-once line search on the CPU: each
    ``_QuarticLineSearch`` records one ``cuda_graph`` compile event at its
    first call; ``built`` counts the searches made."""

    def __init__(self, mp):
        self.built = 0
        init, call = solver._QuarticLineSearch.__init__, \
            solver._QuarticLineSearch.__call__
        outer = self

        def counted_init(s, *a, **kw):
            outer.built += 1
            init(s, *a, **kw)

        def capturing_call(s, coeffs):
            if not getattr(s, "_emulated", False):
                s._emulated = True
                obs.record_compile("cuda_graph:quartic_line_search", 0.0,
                                   lanes=s.n_lanes)
            return call(s, coeffs)

        mp.setattr(solver._QuarticLineSearch, "__init__", counted_init)
        mp.setattr(solver._QuarticLineSearch, "__call__", capturing_call)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """One warmed (never started) port server with an active RunLog, the
    emulated captures, and one warmed JAX server on the same tier."""
    mp = pytest.MonkeyPatch()
    caps = _Captures(mp)
    obs.install_compile_listener()
    path = tmp_path_factory.mktemp("serve") / "run.jsonl"
    rl = obs.RunLog(str(path), run_id="serve-test", flush_lines=1)
    obs.activate(rl)
    be = tiny_backend()
    cache = str(tmp_path_factory.mktemp("serve_cache"))
    srv = CalibServer(be, M=M, lanes=LANES, cache_dir=cache,
                      compile_cache=False, max_wait_s=0.02)
    warm = srv.warmup(seed=SEED)
    jbe = JaxBackend(**TINY)
    jsrv = JaxServer(jbe, M=M, lanes=LANES,
                     cache_dir=str(tmp_path_factory.mktemp("jax_cache")),
                     compile_cache=False, max_wait_s=0.02)
    jsrv.warmup(seed=SEED)
    yield dict(be=be, srv=srv, warm=warm, cache=cache, path=str(path),
               jbe=jbe, jsrv=jsrv, caps=caps)
    while obs.active() is not None:
        obs.deactivate()
    mp.undo()


def _jax_jobs(jbe, specs, seed=SEED + 1):
    """(k, maxiter) specs -> JAX jobs with distinct pinned rho per job (the
    JAX test's jobs)."""
    key = jax.random.PRNGKey(seed)
    jobs = []
    for i, (k, maxiter) in enumerate(specs):
        key, sub = jax.random.split(key)
        ep, _ = jbe.new_calib_episode(sub, k, M)
        rho = np.linspace(0.5 + i, 1.5 + i, k).astype(np.float32)
        jobs.append(JaxJob(episode=ep, k=k, rho=rho, maxiter=maxiter))
    return jobs


def _jobs(served, specs, seed=SEED + 1):
    return [interop.job_from_jax(j) for j in _jax_jobs(served["jbe"], specs,
                                                       seed)]


def _compiles():
    return obs.counters_snapshot().get("compile_events", 0.0)


def test_serve_signature_digest_equals_jax():
    """One backend, one program-cache key in both packages."""
    for tier in (TINY, dict(n_stations=62, n_freqs=3, n_times=20,
                            tdelta=10, n_poly=2, admm_iters=10,
                            lbfgs_iters=8, init_iters=30, npix=128)):
        for kw in ({}, {"precision": "bf16", "block_baselines": 4}):
            t = RadioBackend(device="cpu", **tier, **kw)
            j = JaxBackend(**tier, **kw)
            for K, lanes, npix in ((3, 3, None), (10, 4, 64)):
                assert t.serve_signature(K, lanes, npix) == \
                    j.serve_signature(K, lanes, npix)
                assert sig_digest(t.serve_signature(K, lanes, npix)) == \
                    jax_sig_digest(j.serve_signature(K, lanes, npix))


class TestHeterogeneousBatch:
    SPECS = [(2, 2), (3, 3), (2, 4)]     # (k, maxiter) per lane — all mixed

    @pytest.fixture(scope="class")
    def batch_run(self, served):
        srv, caps = served["srv"], served["caps"]
        jjobs = _jax_jobs(served["jbe"], self.SPECS)
        jobs = [interop.job_from_jax(j) for j in jjobs]
        c0, built0 = _compiles(), caps.built
        n = srv.process_once(jobs, timeout=0.01)
        delta = (_compiles() - c0, caps.built - built0)
        served["jsrv"].process_once(jjobs, timeout=0.01)
        return jobs, jjobs, n, delta

    def test_mixed_k_rho_maxiter_share_one_warm_program(self, batch_run,
                                                        served):
        jobs, _, n, (compile_delta, built) = batch_run
        assert n == len(self.SPECS)
        # warmup captured the line search once; the batch captures nothing
        assert served["warm"]["compile_events:cuda_graph"] == 1
        assert compile_delta == 0 and built == 0, (
            f"{compile_delta} compile events and {built} new line searches "
            "for a heterogeneous batch after warmup")
        lanes = {j.future.result(timeout=1).lane for j in jobs}
        assert lanes == set(range(len(self.SPECS)))

    def test_each_lane_matches_sequential_oracle(self, batch_run, served):
        be = served["be"]
        for j in batch_run[0]:
            got = j.future.result(timeout=1)
            rho = np.ones(M, np.float32)
            rho[:j.k] = j.rho
            mask = np.zeros(M, np.float32)
            mask[:j.k] = 1.0
            want = be.calibrate(j.episode, rho, mask=mask,
                                admm_iters=j.maxiter)
            np.testing.assert_allclose(got.sigma_res,
                                       float(want.sigma_res), rtol=TOL)
            assert not got.degraded

    def test_each_lane_matches_the_jax_server(self, batch_run):
        """sigma_res and the reward's image sigmas end to end.  The lanes'
        influence images part with the solve's round-off (lane 0 here: the
        solves agree to 1e-4, its image std by 1.1e-2, queue 3), so the
        influence is held on the JAX server's own solve
        (:func:`test_batch_stages_held_on_the_jax_solve`)."""
        jobs, jjobs, _, _ = batch_run
        for t, j in zip(jobs, jjobs):
            got = interop.job_result_from_jax(t.future.result(timeout=1))
            want = interop.job_result_from_jax(j.future.result(timeout=1))
            assert got["lane"] == want["lane"] and not got["degraded"]
            np.testing.assert_allclose(got["sigma_res"], want["sigma_res"],
                                       rtol=TOL)
            for k in ("sigma_data_img", "sigma_res_img"):
                np.testing.assert_allclose(got[k], want[k], **REWARD)

    def test_request_events_carry_slo_fields(self, batch_run, served):
        evs = [json.loads(ln) for ln in
               open(served["path"]).read().splitlines()]
        reqs = [e for e in evs if e.get("event") == "serve_request"
                and not e.get("warm")]
        assert len(reqs) >= len(self.SPECS)
        for e in reqs:
            assert e["queue_wait_s"] >= 0
            assert e["service_s"] > 0
            assert e["total_s"] >= e["service_s"]
        warm = [e for e in evs if e.get("event") == "serve_request"
                and e.get("warm")]
        assert len(warm) == LANES
        spans = {e["name"] for e in evs if e.get("event") == "span"}
        assert {"serve_batch", "serve_pack", "serve_solve",
                "serve_influence", "serve_sigma"} <= spans


def test_batch_stages_held_on_the_jax_solve(served):
    """The influence and sigma programs on the JAX server's own solve of a
    batch (the stage held where a solve parts by round-off)."""
    import jax.numpy as jnp

    jbe, jsrv, be = served["jbe"], served["jsrv"], served["be"]
    jjobs = _jax_jobs(jbe, [(2, 3), (3, 2), (3, 3)], seed=SEED + 5)
    jsrv.process_once(jjobs, timeout=0.01)
    rho, mask, alpha, iters, _ = jsrv._lane_params(jjobs)
    jres = jsrv._program("solve")(*jbe.batched_solve_operands(
        jsrv._bep, rho, mask, iters))
    jimgs = np.asarray(jsrv._program("influence")(
        *jbe.batched_influence_operands(jsrv._bep, jres, rho, alpha)))
    jsd, jsr = (np.asarray(a) for a in jbe.image_sigmas_batched(
        jsrv._bep, jres))
    bep = interop.batched_episode_from_numpy(jsrv._bep)
    tres = interop.solve_result_from_numpy(
        jax.tree_util.tree_map(jnp.asarray, jres))
    prog = be.batched_influence_callable(M, be.npix)
    imgs = prog(*be.batched_influence_operands(bep, tres, rho, alpha))
    sd, sr = be.image_sigmas_batched(bep, tres)
    # IMG is the JAX package's tolerance of the observation's image,
    # the influence image x INF_SCALE (tests/test_batched_radio.py)
    scale = calib_env.INF_SCALE
    np.testing.assert_allclose(imgs.numpy() * scale, jimgs * scale, **IMG)
    np.testing.assert_allclose(sd.numpy(), jsd, **REWARD)
    np.testing.assert_allclose(sr.numpy(), jsr, **REWARD)


def test_warm_restart_deserializes_every_program(served):
    """Second server, same cache dir: every program comes back
    ``source == "cache"`` with zero cache misses.  The solve and influence
    programs are prepared ones: their sidecars count as prepared hits, not
    as loaded programs."""
    warm0, cache = served["warm"], served["cache"]
    assert warm0["sources"] == {"solve": "export", "influence": "export"}
    c0 = obs.counters_snapshot()
    srv2 = CalibServer(tiny_backend(), M=M, lanes=LANES, cache_dir=cache,
                       compile_cache=False)
    warm = srv2.warmup(seed=SEED)
    assert warm["sources"] == {"solve": "cache", "influence": "cache"}
    assert warm["export_cache_miss"] == 0
    assert warm["export_cache_prepared_miss"] == 0
    c1 = obs.counters_snapshot()
    assert c1.get("export_cache_prepared_hit", 0) \
        - c0.get("export_cache_prepared_hit", 0) == 2
    assert c1.get("export_cache_hit", 0) == c0.get("export_cache_hit", 0)
    # a JAX job pool, handed over, serves on the restarted server
    from smartcal_tpu.serve import loadgen as jax_loadgen

    pool = interop.job_pool_from_jax(jax_loadgen.build_job_pool(
        served["jbe"], M, 3, seed=SEED + 2, heterogeneous=False))
    assert [k for k, _ in pool] == [2, 3, 2]
    jobs = [Job(episode=ep, k=k, maxiter=2) for k, ep in pool]
    assert srv2.process_once(jobs, timeout=0.01) == 3
    for j in jobs:
        assert np.isfinite(j.future.result(timeout=1).sigma_res)


def test_degraded_lane_reroutes_through_sequential_solve(served):
    """A non-finite batched lane result comes back ``degraded`` through the
    sequential ``solve_admm_safe`` route, not as a failed batch; its
    compile events are counted apart (``serve_oracle_compile_events``)."""
    srv = served["srv"]
    real = srv._program("solve")

    class NaNLane0:
        source = "test"

        def __call__(self, *args):
            res = real(*args)
            sig = res.sigma_res.clone()
            sig[0] = float("nan")
            return res._replace(sigma_res=sig)

    with srv._lock:
        srv._programs = dict(srv._programs, solve=NaNLane0())
    c0 = obs.counters_snapshot()
    try:
        jobs = _jobs(served, [(2, 2), (2, 2)])
        assert srv.process_once(jobs, timeout=0.01) == 2
        r0 = jobs[0].future.result(timeout=1)
        r1 = jobs[1].future.result(timeout=1)
    finally:
        with srv._lock:
            srv._programs = dict(srv._programs, solve=real)
    c1 = obs.counters_snapshot()
    assert r0.degraded and np.isfinite(r0.sigma_res)
    assert not r1.degraded
    assert srv.stats()["degraded"] >= 1
    # the rescue's own solve captured its line search, counted apart
    oracle = c1.get("serve_oracle_compile_events", 0.0) \
        - c0.get("serve_oracle_compile_events", 0.0)
    assert oracle >= 1
    assert c1["compile_events"] - c0["compile_events"] == oracle


def test_submit_validates_job_shape(served):
    be, srv = served["be"], served["srv"]
    from smartcal_tpu_torch import prng

    ep, _ = be.new_calib_episode(prng.PRNGKey(0), 2, M)
    with pytest.raises(ValueError, match="outside"):
        srv.submit(Job(episode=ep, k=M + 1))
    ep2, _ = be.new_calib_episode(prng.PRNGKey(0), 2, 2)
    with pytest.raises(ValueError, match="padded"):
        srv.submit(Job(episode=ep2, k=2))


# ---------------------------------------------------------------------------
# MicroBatcher (no backend)
# ---------------------------------------------------------------------------

def _stub_job(deadline_s=None):
    return Job(episode=None, k=1, deadline_s=deadline_s)


class TestMicroBatcher:
    def test_full_lanes_flush_immediately(self):
        b = MicroBatcher(lanes=3, max_wait_s=5.0)
        for _ in range(3):
            b.submit(_stub_job())
        t0 = time.monotonic()
        batch = b.next_batch(timeout=0.1)
        assert len(batch) == 3
        assert time.monotonic() - t0 < 1.0

    def test_max_wait_flushes_partial_batch(self):
        b = MicroBatcher(lanes=4, max_wait_s=0.05)
        b.submit(_stub_job())
        t0 = time.monotonic()
        batch = b.next_batch(timeout=0.1)
        dt = time.monotonic() - t0
        assert len(batch) == 1
        assert 0.03 <= dt < 1.0

    def test_deadline_pulls_flush_earlier_than_max_wait(self):
        b = MicroBatcher(lanes=4, max_wait_s=10.0, service_est_s=1.0)
        b.submit(_stub_job(deadline_s=1.0))
        t0 = time.monotonic()
        batch = b.next_batch(timeout=0.1)
        assert len(batch) == 1
        assert time.monotonic() - t0 < 1.0
        b.note_service_time(2.0)
        assert b.service_estimate_s() > 1.0

    def test_bounded_queue_sheds_structured(self):
        b = MicroBatcher(lanes=2, max_queue=2)
        b.submit(_stub_job())
        b.submit(_stub_job())
        with pytest.raises(ShedError) as ei:
            b.submit(_stub_job())
        assert ei.value.reason == "queue_full"
        assert b.stats() == {"accepted": 2, "shed": 1,
                             "service_est_s": 0.5}
        assert len(b.drain()) == 2 and b.depth() == 0


# ---------------------------------------------------------------------------
# Circuit breaker (stubbed batch execution: no programs, no warmup)
# ---------------------------------------------------------------------------

def test_stopped_server_sheds_submits(tmp_path):
    srv = CalibServer(object(), M=M, lanes=2, cache_dir=str(tmp_path),
                      npix=32, compile_cache=False,
                      poll_s=0.01, idle_tick_s=0.02)
    srv.start()
    srv.stop()
    with pytest.raises(ShedError) as ei:
        srv.submit(Job(episode=None, k=1))
    assert ei.value.reason == "shutdown"


def test_worker_crash_fails_futures_then_opens_circuit(monkeypatch,
                                                       tmp_path):
    srv = CalibServer(object(), M=M, lanes=2, cache_dir=str(tmp_path),
                      npix=32, compile_cache=False, max_restarts=1,
                      backoff=BackoffPolicy(base_s=0.01, factor=1.0,
                                            max_s=0.01, jitter=0.0),
                      poll_s=0.01, idle_tick_s=0.02, heartbeat_timeout=5.0)
    monkeypatch.setattr(
        srv, "_process_batch",
        lambda batch: (_ for _ in ()).throw(RuntimeError("poison")))
    srv.start()
    try:
        fut = srv.batcher.submit(Job(episode=None, k=1))
        with pytest.raises(RuntimeError, match="poison"):
            fut.result(timeout=10)
        deadline = time.monotonic() + 10
        while not srv.circuit_open and time.monotonic() < deadline:
            try:
                srv.batcher.submit(Job(episode=None, k=1))
            except ShedError:
                pass
            time.sleep(0.05)
        assert srv.circuit_open, "slot past max_restarts must open circuit"
        with pytest.raises(ShedError) as ei:
            srv.submit(Job(episode=None, k=1))
        assert ei.value.reason == "circuit_open"
        assert srv.stats()["failed"] >= 1
    finally:
        srv.stop()


class TestNumericsSentinel:
    """Every Nth batch snapshots one sampled lane; the breaker (here the
    test's thread) replays it through the sequential oracle off the hot
    path and judges the fused outputs against the bf16 band; out-of-band
    drift feeds the SLO burn detector, which names the drifting stage."""

    def _events(self, path, start):
        lines = open(path).read().splitlines()[start:]
        return [json.loads(ln) for ln in lines]

    def test_clean_replay_is_in_band(self, served):
        srv, path = served["srv"], served["path"]
        n0 = len(open(path).read().splitlines())
        srv.sentinel_every = 1
        try:
            jobs = _jobs(served, [(2, 2), (3, 3)], seed=SEED + 11)
            assert srv.process_once(jobs, timeout=0.01) == 2
            ev = srv.sentinel_poll()
        finally:
            srv.sentinel_every = 0
        assert ev is not None and ev["drift"] is False
        for stage in ("solve", "influence", "sigma"):
            assert ev[f"rel_err_{stage}"] <= obs.BF16_REL_BAND
        assert ev["worst_stage"] in ("solve", "influence", "sigma")
        drift_evs = [e for e in self._events(path, n0)
                     if e.get("event") == "numerics_drift"]
        assert len(drift_evs) == 1 and drift_evs[0]["drift"] is False
        srv.sentinel_every = 1
        try:
            assert srv.sentinel_poll() is None
        finally:
            srv.sentinel_every = 0

    def test_injected_drift_trips_burn_detector_naming_stage(self, served):
        from smartcal_tpu_torch.runtime import faults as rt_faults

        be, cache, path = served["be"], served["cache"], served["path"]
        n0 = len(open(path).read().splitlines())
        srv = CalibServer(be, M=M, lanes=LANES, cache_dir=cache,
                          compile_cache=False, max_wait_s=0.02,
                          sentinel_every=1)
        warm = srv.warmup(seed=SEED)
        assert warm["sources"]["solve"] == "cache"
        rt_faults.install(rt_faults.FaultPlan(
            perturb_stage="sentinel_solve", perturb_at=0,
            perturb_rel=0.5, perturb_span=100))
        try:
            drifted = 0
            for i in range(4):
                jobs = _jobs(served, [(2, 2), (3, 2)], seed=SEED + 20 + i)
                srv.process_once(jobs, timeout=0.01)
                ev = srv.sentinel_poll()
                assert ev is not None
                assert ev["drift"] is True, ev
                assert ev["worst_stage"] == "solve"
                assert ev["rel_err_solve"] == pytest.approx(0.5, rel=1e-6)
                drifted += 1
                if srv.stats()["sentinel"]["firing"]:
                    break
        finally:
            rt_faults.clear()
        sent = srv.stats()["sentinel"]
        assert sent["firing"], sent
        assert sent["drift"] == drifted == sent["replayed"]
        assert sent["sampled"] >= drifted
        burns = [e for e in self._events(path, n0)
                 if e.get("event") == "slo_burn"
                 and e.get("kind") == "numerics"]
        assert burns and burns[0]["stage"] == "solve"
        assert burns[0]["state"] == "firing"
