"""The port's online lifecycle (``smartcal_tpu_torch/serve/lifecycle.py``):
the replay tee, behavior-logp scoring, hot-swap publication through the
program cache and the fleet's weight frames, case for case the JAX
package's tests/test_lifecycle.py, and against the JAX package on the
same weights and observations: the policy heads and the host logp at rtol
1e-5, and the teed transitions' actions and logps field for field against
the JAX ``CalibServer``'s own lane parameters and scorer
(``interop.served_policy_from_jax``).

On the CPU no CUDA graph is captured: the zero-compile publication is
counted on the port's compile events (nvcc builds, graph captures), which a
publication must leave at zero, and on the program cache (a publication
stores, it never exports)."""

import threading

import numpy as np
import pytest
import torch

import jax

from smartcal_tpu.rl import sac as jsac
from smartcal_tpu.serve import CalibServer as JaxServer
from smartcal_tpu.serve import Job as JaxJob
from smartcal_tpu_torch import interop, obs
from smartcal_tpu_torch.envs import calib as calib_env
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.rl import sac
from smartcal_tpu_torch.serve import (CalibServer, Job, PolicyPublisher,
                                      ServingLearner, TransitionStage,
                                      build_obs_pool)

M = 3
LANES = 3
SEED = 7
NPIX = 32
OBS_DIM = NPIX * NPIX + (M + 1) * 7
TINY = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=NPIX)
RTOL = 1e-5


@pytest.fixture(scope="module")
def lifecycle(tmp_path_factory):
    """One warmed policy-armed port server with the replay tee, its learner
    and publisher, a small obs-bearing pool, and a JAX SAC state on the
    same config (the policy the parity cases hand over)."""
    obs.install_compile_listener()
    path = tmp_path_factory.mktemp("lifecycle") / "run.jsonl"
    rl = obs.RunLog(str(path), run_id="lifecycle-test", flush_lines=1)
    obs.activate(rl)
    be = RadioBackend(device="cpu", **TINY)
    cfg = sac.SACConfig(obs_dim=OBS_DIM, n_actions=2 * M, mem_size=64,
                        batch_size=16, is_clip=2.0, ere_eta=0.996)
    learner = ServingLearner(cfg, seed=SEED, n_shards=4, publish_every=2,
                             ingest_chunk=4, device="cpu")
    stage = TransitionStage(cap=256)
    cache = str(tmp_path_factory.mktemp("lifecycle_cache"))
    srv = CalibServer(be, M=M, lanes=LANES, cache_dir=cache,
                      compile_cache=False,
                      policy=(cfg, learner.actor_params),
                      transition_sink=stage, max_wait_s=0.02)
    srv.warmup(seed=SEED)
    learner.publisher = PolicyPublisher(srv, keep_versions=4)
    learner.warm()                       # includes the warm publish
    pool = build_obs_pool(be, M, 3, seed=SEED + 1)
    jcfg = jsac.SACConfig(obs_dim=OBS_DIM, n_actions=2 * M)
    jst = jax.jit(lambda k: jsac.sac_init(k, jcfg))(jax.random.PRNGKey(3))
    yield dict(be=be, srv=srv, learner=learner, stage=stage, pool=pool,
               path=str(path), cfg=cfg, jcfg=jcfg, jst=jst)
    while obs.active() is not None:
        obs.deactivate()


def _events(path, name, start=0):
    import json

    out = []
    with open(path) as fh:
        for line in fh.readlines()[start:]:
            ev = json.loads(line)
            if ev.get("event") == name:
                out.append(ev)
    return out


def _lines(path):
    with open(path) as fh:
        return len(fh.readlines())


# ---------------------------------------------------------------------------
# behavior_logp and the policy heads against JAX
# ---------------------------------------------------------------------------

def test_behavior_logp_np_matches_jax_density():
    from smartcal_tpu.rl.networks import tanh_gaussian_log_prob
    from smartcal_tpu_torch.rl.networks import (
        tanh_gaussian_log_prob as torch_density, tanh_gaussian_log_prob_np)

    rng = np.random.default_rng(3)
    mu = rng.normal(size=(8, 2 * M)).astype(np.float32)
    logsigma = rng.uniform(-2.0, 0.5, (8, 2 * M)).astype(np.float32)
    act = np.tanh(rng.normal(size=(8, 2 * M))).astype(np.float32)
    want = np.asarray(tanh_gaussian_log_prob(mu, logsigma, act))
    got = np.array([tanh_gaussian_log_prob_np(mu[i], logsigma[i], act[i])
                    for i in range(len(mu))])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)
    dens = torch_density(torch.as_tensor(mu), torch.as_tensor(logsigma),
                         torch.as_tensor(act)).numpy()
    np.testing.assert_allclose(dens.reshape(-1), got, rtol=RTOL, atol=RTOL)
    edge = np.full((1, 2 * M), 1.0, np.float32)
    assert np.isfinite(tanh_gaussian_log_prob_np(mu[0], logsigma[0],
                                                 edge[0]))


def test_policy_program_heads_match_jax(lifecycle):
    """The served policy program (``torch.export`` with the weights as an
    operand) on the JAX actor's weights gives JAX's ``policy_heads``."""
    srv, cfg, jcfg, jst = (lifecycle[k] for k in ("srv", "cfg", "jcfg",
                                                   "jst"))
    _, params = interop.served_policy_from_jax(jst, cfg)
    rng = np.random.default_rng(5)
    ovec = (1e-3 * rng.standard_normal((LANES, OBS_DIM))).astype(np.float32)
    got = srv._policy_forward(srv._program("policy"), params, ovec)
    want = [np.asarray(a) for a in jsac.policy_heads(jcfg, jst.actor_params,
                                                     ovec)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL)


# ---------------------------------------------------------------------------
# the tee: fidelity of served transitions
# ---------------------------------------------------------------------------

def test_teed_transitions_derivable_from_their_requests(lifecycle):
    srv, stage, pool = (lifecycle[k] for k in ("srv", "stage", "pool"))
    stage.drain()
    ver = srv.policy_version
    jobs = []
    for i, (k, ep, ov) in enumerate(pool):
        rho = np.linspace(0.5 + i, 1.5 + i, k).astype(np.float32)
        jobs.append(Job(episode=ep, k=k, rho=rho, obs_vec=ov))
    srv.process_once(jobs, timeout=0.05)
    results = [j.future.result(timeout=60) for j in jobs]
    trs = stage.drain()
    assert len(trs) == len(jobs)
    spec_keys = {"state", "new_state", "action", "reward", "done",
                 "hint", "version", "behavior_logp"}
    for job, r, tr in zip(jobs, results, trs):
        assert set(tr) == spec_keys
        np.testing.assert_array_equal(tr["state"],
                                      np.asarray(job.obs_vec, np.float32))
        np.testing.assert_array_equal(tr["state"], tr["new_state"])
        np.testing.assert_allclose(
            tr["action"][:job.k],
            np.clip(calib_env._to_unit(job.rho), -1.0, 1.0), rtol=1e-6)
        want_reward = (r.sigma_data_img / max(r.sigma_res_img, 1e-12)
                       + 1e-4 / (r.img_std + calib_env.EPS))
        np.testing.assert_allclose(float(tr["reward"]), want_reward,
                                   rtol=1e-5)
        assert bool(tr["done"]) is True
        assert int(tr["version"]) == ver
        assert np.isfinite(float(tr["behavior_logp"]))


def test_teed_transitions_match_the_jax_server(lifecycle):
    """Pinned-rho and policy jobs on the JAX actor's weights: the port's
    lane parameters and teed (action, behavior_logp, state, hint, done,
    version) against the JAX server's ``_lane_params`` and
    ``_behavior_logp`` on the same weights and observations."""
    srv, stage, pool, cfg, jcfg, jst = (lifecycle[k] for k in (
        "srv", "stage", "pool", "cfg", "jcfg", "jst"))
    _, params = interop.served_policy_from_jax(jst, cfg)
    v = srv.policy_version
    srv.swap_policy(params, v + 1)
    jsrv = JaxServer(None, M=M, lanes=LANES, cache_dir=str(
        lifecycle["path"]) + "_jax", npix=NPIX, compile_cache=False,
        policy=(jcfg, jst.actor_params), transition_sink=lambda t: None)
    heads = jax.jit(lambda p, o: jsac.policy_heads(jcfg, p, o))
    jsrv.backend = type("B", (), {"admm_iters": TINY["admm_iters"]})()
    stage.drain()
    jobs, jjobs = [], []
    for i, (k, ep, ov) in enumerate(pool):
        rho = (np.linspace(0.5 + i, 2.0 + i, k).astype(np.float32)
               if i % 2 else None)
        jobs.append(Job(episode=ep, k=k, rho=rho, obs_vec=ov))
        jjobs.append(JaxJob(episode=None, k=k, rho=rho, obs_vec=ov))
    srv.process_once(jobs, timeout=0.05)
    for j in jobs:
        j.future.result(timeout=60)
    trs = stage.drain()
    rho, mask, alpha, iters, jheads = jsrv._lane_params(
        jjobs, 0, (jcfg, jst.actor_params), heads)
    t_rho, t_mask, t_alpha, t_iters, _ = srv._lane_params(
        jobs, 0, srv._policy, srv._program("policy"))
    np.testing.assert_allclose(t_rho, rho, rtol=RTOL)
    np.testing.assert_allclose(t_alpha, alpha, rtol=RTOL, atol=RTOL)
    np.testing.assert_array_equal(t_mask, mask)
    np.testing.assert_array_equal(t_iters, iters)
    assert len(trs) == len(jobs)
    for lane, (jj, tr) in enumerate(zip(jjobs, trs)):
        lp, action = jsrv._behavior_logp(jj, lane, rho, alpha, jheads)
        np.testing.assert_allclose(tr["action"], action, rtol=RTOL,
                                   atol=RTOL)
        np.testing.assert_allclose(float(tr["behavior_logp"]), lp,
                                   rtol=RTOL)
        np.testing.assert_array_equal(tr["state"], jj.obs_vec)
        np.testing.assert_array_equal(tr["hint"], np.zeros(2 * M))
        assert bool(tr["done"]) and int(tr["version"]) == v + 1


def test_tee_ingest_matches_offline_filled_buffer():
    """Storing the same transitions through ``ServingLearner.ingest`` and
    through a direct ``replay_add_batch`` yields identical rings."""
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.rl import replay_sharded as rps

    cfg = sac.SACConfig(obs_dim=6, n_actions=4, mem_size=32, batch_size=8)
    rng = np.random.default_rng(11)
    trs = [{"state": rng.normal(size=6).astype(np.float32),
            "new_state": rng.normal(size=6).astype(np.float32),
            "action": rng.uniform(-1, 1, 4).astype(np.float32),
            "reward": np.float32(rng.normal()),
            "done": True,
            "hint": np.zeros(4, np.float32),
            "version": np.int32(i % 3),
            "behavior_logp": np.float32(-abs(rng.normal()))}
           for i in range(8)]
    ln = ServingLearner(cfg, seed=1, n_shards=4, ingest_chunk=4,
                        device="cpu")
    assert ln.ingest(list(trs)) == len(trs)
    spec = rp.versioned_spec(rp.transition_spec(cfg.obs_dim,
                                                cfg.n_actions))
    buf = rps.place_on_mesh(rps.replay_init(cfg.mem_size, spec, 4,
                                            device="cpu"))
    for lo in range(0, len(trs), 4):
        flat = {k: np.stack([np.asarray(t[k]) for t in trs[lo:lo + 4]])
                for k in trs[0]}
        rps.replay_add_batch(buf, flat)
    for k in spec:
        assert torch.equal(ln.buffer.data[k], buf.data[k]), k
    assert ln.buffer.cntr == buf.cntr == len(trs)


def test_learner_learns_from_the_tee_and_publishes(lifecycle):
    """The loop closed: served transitions teed, ingested, learned from
    under IMPACT weighting, and a new version published and served."""
    srv, stage, pool, learner = (lifecycle[k] for k in (
        "srv", "stage", "pool", "learner"))
    stage.drain()
    for _ in range(6):
        jobs = [Job(episode=ep, k=k, rho=None, obs_vec=ov)
                for k, ep, ov in pool]
        srv.process_once(jobs, timeout=0.05)
        for j in jobs:
            j.future.result(timeout=60)
    assert learner.ingest(stage.drain()) >= learner.cfg.batch_size
    v0 = learner.version
    pubs = []
    for _ in range(2 * learner.publish_every):
        m = learner.step(pull_metrics=True)
        pubs.append(learner.maybe_publish())
    assert learner.learns >= 2 and np.isfinite(m["critic_loss"])
    assert learner.version > v0 and srv.policy_version == learner.version
    assert any(p is not None for p in pubs)
    assert learner.staleness()["filled"] == int(learner.buffer.cntr)


# ---------------------------------------------------------------------------
# hot-swap: parity, stale-version contract, zero-compile publication
# ---------------------------------------------------------------------------

def test_swap_identical_params_is_bit_identical(lifecycle):
    srv, stage, pool = (lifecycle[k] for k in ("srv", "stage", "pool"))
    stage.drain()
    _, params0 = srv._policy

    def wave():
        jobs = [Job(episode=ep, k=k, rho=None, obs_vec=ov)
                for k, ep, ov in pool]
        srv.process_once(jobs, timeout=0.05)
        return [j.future.result(timeout=60) for j in jobs]

    r0 = wave()
    v = srv.policy_version
    swap = srv.swap_policy(params0, v + 1)
    assert swap["version"] == v + 1 and swap["version_prev"] == v
    r1 = wave()
    for a, b in zip(r0, r1):
        assert (a.sigma_res, a.sigma_data_img, a.sigma_res_img,
                a.img_std) == (b.sigma_res, b.sigma_data_img,
                               b.sigma_res_img, b.img_std)
    trs = stage.drain()
    half = len(trs) // 2
    for t0, t1 in zip(trs[:half], trs[half:]):
        np.testing.assert_array_equal(t0["action"], t1["action"])
        assert int(t1["version"]) == int(t0["version"]) + 1


def test_jobs_admitted_before_swap_carry_both_versions(lifecycle):
    srv, stage, pool, path = (lifecycle[k] for k in ("srv", "stage", "pool",
                                                      "path"))
    stage.drain()
    start = _lines(path)
    v = srv.policy_version
    k, ep, ov = pool[0]
    futs = [srv.submit(Job(episode=ep, k=k, rho=None, obs_vec=ov))
            for _ in range(2)]
    _, params0 = srv._policy
    srv.swap_policy(params0, v + 1)
    srv.process_once([], timeout=0.05)
    for f in futs:
        f.result(timeout=60)
    evs = [e for e in _events(path, "serve_request", start)
           if not e.get("warm")]
    assert len(evs) >= 2
    for e in evs[:2]:
        assert e["version_admitted"] == v
        assert e["version"] == v + 1
        assert "behavior_logp" in e


def test_republish_stream_compiles_nothing(lifecycle):
    """After the warm publish, further publications (versioned cache entry
    + swap + one forward) export nothing and compile nothing, and the cache
    keeps ``keep_versions`` policy entries."""
    import glob
    import os

    srv, learner, pool = (lifecycle[k] for k in ("srv", "learner", "pool"))
    pub = learner.publisher
    v = srv.policy_version
    c0 = obs.counters_snapshot()
    recs = [pub.publish(learner.actor_params, v + 1 + i) for i in range(5)]
    c1 = obs.counters_snapshot()
    for key in ("compile_events", "export_cache_miss"):
        assert c1.get(key, 0.0) - c0.get(key, 0.0) == 0.0, key
    assert c1.get("export_cache_store", 0.0) \
        - c0.get("export_cache_store", 0.0) == 5
    assert [r["version"] for r in recs] == [v + 1 + i for i in range(5)]
    assert srv.policy_version == v + 5
    assert all(r["publish_s"] < 30.0 for r in recs)
    assert len(glob.glob(os.path.join(srv.cache.dir, "policy-*.pt2"))) == 4
    k, ep, ov = pool[0]
    job = Job(episode=ep, k=k, rho=None, obs_vec=ov)
    srv.process_once([job], timeout=0.05)
    assert np.isfinite(job.future.result(timeout=60).sigma_res)


# ---------------------------------------------------------------------------
# fleet: weight frames, replica independence
# ---------------------------------------------------------------------------

class _SwapRecorder:
    def __init__(self):
        self.swaps = []
        self.seen = threading.Event()

    def swap_policy(self, params, version, program=None):
        self.swaps.append(int(version))
        self.seen.set()
        return {"version": int(version), "version_prev": 0,
                "swap_s": 0.0}


def test_weights_publisher_collapses_burst_latest_wins():
    from smartcal_tpu_torch.serve.fleet import _WeightsPublisher

    rec = _SwapRecorder()
    wp = _WeightsPublisher(rec, replica_id=0)
    for v in (1, 2, 3):
        wp.offer(v, {"w": np.zeros(2)})
    wp.start()
    assert rec.seen.wait(timeout=5.0)
    wp.request_stop()
    wp.join(timeout=5.0)
    assert rec.swaps == [3]
    assert wp.swaps == 1


def test_publish_policy_reaches_ready_replicas_independently():
    """One frame for every ready replica, readable by the JAX package's
    transport too (the frames are byte for byte the JAX package's)."""
    from smartcal_tpu.runtime import ipc as jipc
    from smartcal_tpu_torch.runtime import ipc
    from smartcal_tpu_torch.serve import fleet as serve_fleet

    class _PubReplica:
        def __init__(self, ready=True):
            self.ready = threading.Event()
            if ready:
                self.ready.set()
            self.frames = []

        def publish(self, blob):
            self.frames.append(blob)
            return True

    router = serve_fleet.FleetRouter.__new__(serve_fleet.FleetRouter)
    reps = [_PubReplica(), _PubReplica(ready=False), _PubReplica()]
    router._live = lambda: reps
    w = torch.arange(3, dtype=torch.float32)
    reached = serve_fleet.FleetRouter.publish_policy(router, {"w": w},
                                                     version=4)
    assert reached == 2 and not reps[1].frames
    assert reps[0].frames == reps[2].frames
    for unframe in (ipc.unframe_payload, jipc.unframe_payload):
        kind, payload = unframe(reps[0].frames[0])
        assert (kind, payload["version"]) == ("weights", 4)
        np.testing.assert_array_equal(payload["params"]["w"],
                                      np.arange(3, dtype=np.float32))


def test_server_gauges_carry_policy_version():
    from smartcal_tpu_torch.serve.fleet import _server_gauges

    class _Srv:
        policy_version = 5
        lanes = 2

        def stats(self):
            return {}

        class batcher:
            @staticmethod
            def depth():
                return 0

            @staticmethod
            def service_estimate_s():
                return 0.0

    g = _server_gauges(_Srv())
    assert g["policy_version"] == 5
    assert g["queue_depth"] == 0
