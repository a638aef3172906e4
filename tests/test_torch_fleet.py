"""The fleet's weighting and sampling in the port against the JAX
package, and the port's supervised thread fleet.

Against JAX, on the same parameters, batches and draws:

* ``replay.staleness_clip_weights``, ``sac.impact_weights``,
  ``sac_discrete.impact_weights`` and ``td3.staleness_weights`` (weights
  and aux) at rtol 1e-5;
* ERE alone and composed with PER on the same uniforms: the same indices,
  the IS weights at rtol 1e-6;
* 12 IS-clipped learn steps (``learner_version`` 4 on a ring of versions
  1-4, so most transitions are stale and many weights clipped) from an
  Adam-warm state, at the SAC parity tolerance of tests/test_torch_sac.py
  (losses rtol 1e-4, state rtol 1e-4 / atol 1e-5).

In the port alone: the staleness-0 identity bit for bit (every
transition at the learner's version: the IS-clipped learn equals the
unweighted one, state and priorities), a thread fleet that keeps learning
after ``runtime/faults`` kills actor 1, a checkpoint/resume that carries
``actor_iterations``, and ``publish_every`` forcing staleness.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.rl import replay as jr
from smartcal_tpu.rl import sac as jsac
from smartcal_tpu.rl import sac_discrete as jdsac
from smartcal_tpu.rl import td3 as jtd3
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.rl import replay as tr
from smartcal_tpu_torch.rl import sac as tsac
from smartcal_tpu_torch.rl import sac_discrete as tdsac
from smartcal_tpu_torch.rl import td3 as ttd3
from smartcal_tpu_torch.runtime import (BackoffPolicy, FaultPlan,
                                        clear_faults, install_faults)

OBS, NA, B, MEM = 6, 2, 8, 32
# the learn parity runs tests/test_torch_sac.py's configuration (a 16^2
# image and 11 metadata, 4 actions, batch 4, ring 16)
H = W = 16
L_OBS, L_NA, L_B, L_MEM = H * W + 11, 4, 4, 16
L_BASE = dict(obs_dim=L_OBS, n_actions=L_NA, batch_size=L_B, mem_size=L_MEM,
              img_shape=(H, W))
RTOL, ATOL = 1e-4, 1e-5
W_RTOL = 1e-5
LV = 4
ENV_KW = {"M": 4, "N": 4, "lbfgs_iters": 10}
AGENT_KW = {"batch_size": 8, "mem_size": 64}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops on small batches: one intra-op thread for the module, its
    fixtures included (the suite runs six workers on the host's cores, and
    their oversubscribed thread pools slowed this file's trainers several
    times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    yield
    clear_faults()


def t(x):
    return torch.from_numpy(np.array(x))


def fast_backoff():
    return BackoffPolicy(base_s=0.01, factor=2.0, max_s=0.05, jitter=0.0)


@functools.lru_cache(maxsize=None)
def behavior_policy(jcfg):
    """One jit per network shape of the behavior policy's actions and
    log-probs (the learn knobs do not change the networks)."""
    jcfg = dataclasses.replace(jcfg, is_clip=0.0, prioritized=False,
                               ere_eta=1.0)
    return _behavior_policy(jcfg)


@functools.lru_cache(maxsize=None)
def _behavior_policy(jcfg):
    return jax.jit(lambda k, x: jsac.choose_action_logp(
        jcfg, jsac.sac_init(k, jcfg), x, jax.random.PRNGKey(10)))


def versioned_rings(jcfg, n=24, seed=3, mem=MEM):
    """A JAX ring and a port ring holding the same ``n`` versioned
    transitions: versions 1..4, actions drawn from a policy other than the
    learner's, and behavior log-probs of that policy moved by up to +-1.5
    (so the clipped ratios reach both bounds)."""
    rng = np.random.default_rng(seed)
    obs_dim, na = jcfg.obs_dim, jcfg.n_actions
    spec_j = jr.versioned_spec(jr.transition_spec(obs_dim, na))
    jb = jr.replay_init(mem, spec_j)
    tb = tr.replay_init(mem, tr.versioned_spec(tr.transition_spec(obs_dim,
                                                                  na)),
                        device="cpu")
    s = rng.standard_normal((n, obs_dim)).astype(np.float32)
    a, lp = behavior_policy(jcfg)(jax.random.PRNGKey(9), jnp.asarray(s))
    trs = {"state": s, "new_state": s + 0.1, "action": np.asarray(a),
           "reward": rng.uniform(0, 3, n).astype(np.float32),
           "done": rng.uniform(size=n) < 0.2,
           "hint": np.zeros((n, na), np.float32),
           "version": rng.integers(1, LV + 1, n).astype(np.int32),
           # log-probs of a behavior policy that drifted from the snapshot
           "behavior_logp": (np.asarray(lp) + rng.uniform(-1.5, 1.5, n))
           .astype(np.float32)}
    pri = (1.0 + 0.1 * np.arange(n)).astype(np.float32)
    jb = jr.replay_add_batch(jb, {k: jnp.asarray(v) for k, v in trs.items()},
                             priority=jnp.asarray(pri))
    tr.replay_add_batch(tb, trs, priority=t(pri))
    return jb, tb, trs


def test_staleness_clip_weights_match():
    rng = np.random.default_rng(0)
    raw = np.exp(rng.uniform(-2.5, 2.5, 64)).astype(np.float32)
    ver = rng.integers(0, 6, 64).astype(np.int32)
    for clip in (1.0, 2.0, 5.0):
        jw, jaux = jr.staleness_clip_weights(jnp.asarray(raw),
                                             jnp.asarray(ver), 4, clip)
        tw, taux = tr.staleness_clip_weights(t(raw), t(ver), 4, clip)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=W_RTOL)
        for k in jaux:
            np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                       rtol=W_RTOL, err_msg=k)
    # a callable raw weight (TD3's decay) and the zero aux
    jw, _ = jr.staleness_clip_weights(lambda s: 0.9 ** s, jnp.asarray(ver),
                                      4, 2.0)
    tw, _ = tr.staleness_clip_weights(lambda s: 0.9 ** s, t(ver), 4, 2.0)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=W_RTOL)
    assert {k: float(v) for k, v in tr.zero_clip_aux().items()} == \
        {k: float(v) for k, v in jr.zero_clip_aux().items()}


def test_impact_and_staleness_weights_match():
    jcfg = jsac.SACConfig(obs_dim=OBS, n_actions=NA, is_clip=2.0)
    tcfg = tsac.SACConfig(obs_dim=OBS, n_actions=NA, is_clip=2.0)
    jb, tb, trs = versioned_rings(jcfg)
    st = jax.jit(lambda k: jsac.sac_init(k, jcfg))(jax.random.PRNGKey(2))
    tst = interop.sac_state_from_jax(st, tcfg)
    jbatch = {k: jnp.asarray(v) for k, v in trs.items()}
    tbatch = {k: t(v) for k, v in trs.items()}
    jw, jaux = jax.jit(lambda p, b: jsac.impact_weights(jcfg, p, b, LV))(
        st.actor_params, jbatch)
    tw, taux = tsac.impact_weights(tcfg, tst.actor, tbatch, LV)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=W_RTOL)
    assert 0.0 < float(taux["is_clip_saturation"]) < 1.0
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=W_RTOL, err_msg=k)
    # TD3's staleness decay
    j3 = jtd3.TD3Config(obs_dim=OBS, n_actions=NA, is_clip=2.0, is_decay=0.7)
    t3 = ttd3.TD3Config(obs_dim=OBS, n_actions=NA, is_clip=2.0, is_decay=0.7)
    jw, jaux = jtd3.staleness_weights(j3, jbatch, LV)
    tw, taux = ttd3.staleness_weights(t3, tbatch, LV)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=W_RTOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=W_RTOL, err_msg=k)


def test_discrete_impact_weights_match():
    H = W = 8
    kw = dict(obs_dim=H * W + 5, n_actions=4, img_shape=(H, W), is_clip=2.0)
    jcfg, tcfg = jdsac.DSACConfig(**kw), tdsac.DSACConfig(**kw)
    init = jax.jit(lambda k: jdsac.dsac_init(k, jcfg))
    st, behav = init(jax.random.PRNGKey(1)), init(jax.random.PRNGKey(5))
    tst = interop.dsac_state_from_jax(st, tcfg)
    rng = np.random.default_rng(1)
    s = rng.standard_normal((16, kw["obs_dim"])).astype(np.float32)
    a, lp = jax.jit(lambda b, x: jdsac.choose_action_logp(
        jcfg, b, x, jax.random.PRNGKey(2)))(behav, jnp.asarray(s))
    ver = rng.integers(2, 5, 16).astype(np.int32)
    jbatch = {"state": jnp.asarray(s), "action": a, "behavior_logp": lp,
              "version": jnp.asarray(ver)}
    tbatch = {"state": t(s), "action": t(a), "behavior_logp": t(lp),
              "version": t(ver)}
    jw, jaux = jax.jit(lambda p, b: jdsac.impact_weights(jcfg, p, b, LV))(
        st.actor_params, jbatch)
    tw, taux = tdsac.impact_weights(tcfg, tst.actor, tbatch, LV)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=W_RTOL)
    for k in jaux:
        np.testing.assert_allclose(float(taux[k]), float(jaux[k]),
                                   rtol=W_RTOL, err_msg=k)


def ere_rings(n=40, size=32):
    spec_j, spec_t = {"x": ((), jnp.float32)}, {"x": ((), torch.float32)}
    jb, tb = jr.replay_init(size, spec_j), tr.replay_init(size, spec_t,
                                                          device="cpu")
    pri = (1.0 + (np.arange(n) % 7)).astype(np.float32)
    for i in range(n):
        jb = jr.replay_add(jb, {"x": jnp.asarray(float(i))},
                           priority=jnp.asarray(pri[i]))
        tr.replay_add(tb, {"x": float(i)}, priority=float(pri[i]))
    return jb, tb


@pytest.mark.parametrize("eta", [0.9, 0.98])
def test_ere_and_per_ere_same_indices(eta):
    jb, tb = ere_rings()
    np.testing.assert_allclose(tr.ere_weights(tb, eta).numpy(),
                               np.asarray(jr.ere_weights(jb, eta)),
                               rtol=1e-6)
    for i in range(5):
        key = jax.random.PRNGKey(i)
        u = t(jax.random.uniform(key, (B,)))
        _, jidx = jr.replay_sample_ere(jb, key, B, eta)
        _, tidx = tr.replay_sample_ere(tb, B, eta, u=u)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        _, jidx, jw, jb = jr.replay_sample_per(jb, key, B, recency_eta=eta)
        _, tidx, tw = tr.replay_sample_per(tb, B, u=u, recency_eta=eta)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        assert tb.beta == np.float32(jb.beta)


def jax_draws(jcfg, key):
    """The draws ``smartcal_tpu.rl.sac.learn`` makes from ``key``."""
    k_samp, k_core = jax.random.split(key)
    if jcfg.prioritized or jcfg.ere_eta < 1.0:
        sample = jax.random.uniform(k_samp, (jcfg.batch_size,))
    else:
        sample = jax.random.gumbel(k_samp, (jcfg.mem_size,))
    noise = tuple(t(jax.random.normal(k, (jcfg.batch_size, jcfg.n_actions)))
                  for k in jax.random.split(k_core, 3))
    return t(sample), noise


def _leaves(d, path=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


@pytest.fixture(scope="module")
def warm_state():
    """JAX's agent after 8 plain learn steps, counter set back to 0 (see
    tests/test_torch_sac.py on Adam's first step)."""
    jcfg = jsac.SACConfig(**L_BASE)
    st = jax.jit(lambda k: jsac.sac_init(k, jcfg))(jax.random.PRNGKey(0))
    jb, _, _ = versioned_rings(jcfg, n=13, seed=8, mem=L_MEM)
    step = jax.jit(lambda s, b, k: jsac.learn(jcfg, s, b, k))
    for i in range(8):
        st, jb, _ = step(st, jb, jax.random.PRNGKey(40 + i))
    return st._replace(learn_counter=jnp.asarray(0, jnp.int32))


def test_twelve_is_clip_learn_steps_match(warm_state):
    """PER with ERE and the IS-clip: the fleet learner's step."""
    kw = dict(L_BASE, is_clip=2.0, prioritized=True, ere_eta=0.98)
    jcfg, tcfg = jsac.SACConfig(**kw), tsac.SACConfig(**kw)
    jst, tst = warm_state, interop.sac_state_from_jax(warm_state, tcfg)
    jb, tb, _ = versioned_rings(jcfg, n=13, mem=L_MEM)
    step = jax.jit(lambda s, b, k: jsac.learn(jcfg, s, b, k,
                                              learner_version=LV))
    sat = 0.0
    for i in range(12):
        key = jax.random.PRNGKey(100 + i)
        jst, jb, jm = step(jst, jb, key)
        sample, noise = jax_draws(jcfg, key)
        tm = tsac.learn(tcfg, tst, tb, sample_noise=sample, noise=noise,
                        learner_version=LV)
        for k in ("critic_loss", "actor_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL, err_msg=f"step {i} {k}")
        for k in ("staleness_mean", "is_clip_mean", "is_clip_saturation"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {k}")
        sat = max(sat, float(tm["is_clip_saturation"]))
    assert sat > 0.0                      # the clip did real work
    want = dict(_leaves(interop.sac_state_from_jax(jst, tcfg).to_host()))
    got = dict(_leaves(tst.to_host()))
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL,
                                   err_msg=k)
    if tcfg.prioritized:
        np.testing.assert_allclose(tb.priority.numpy(),
                                   np.asarray(jb.priority), rtol=RTOL)


@pytest.mark.parametrize("prioritized", [False, True])
def test_staleness0_bit_identical_to_unweighted(prioritized, warm_state):
    """is_clip armed with every transition at the learner's version equals
    is_clip off, bit for bit (state, priorities), on the port's own
    learn."""
    kw = dict(L_BASE, prioritized=prioritized)
    cfg_on, cfg_off = tsac.SACConfig(is_clip=2.0, **kw), tsac.SACConfig(**kw)
    _, tb, _ = versioned_rings(jsac.SACConfig(**kw), n=13, mem=L_MEM)
    tb.data["version"][:] = LV
    st_on = interop.sac_state_from_jax(warm_state, cfg_on)
    st_off = interop.sac_state_from_jax(warm_state, cfg_off)
    b_on = tr.ReplayState(dict(tb.data), tb.priority.clone(), tb.cntr,
                          tb.beta)
    b_off = tr.ReplayState(dict(tb.data), tb.priority.clone(), tb.cntr,
                           tb.beta)
    for i in range(2):
        g1 = torch.Generator().manual_seed(i)
        g2 = torch.Generator().manual_seed(i)
        m_on = tsac.learn(cfg_on, st_on, b_on, g1, learner_version=LV)
        tsac.learn(cfg_off, st_off, b_off, g2)
        assert float(m_on["is_clip_mean"]) == 1.0
        assert float(m_on["is_clip_saturation"]) == 0.0
    for (k, a), (_, b) in zip(_leaves(st_on.to_host()),
                              _leaves(st_off.to_host())):
        np.testing.assert_array_equal(a, b, k)
    np.testing.assert_array_equal(b_on.priority.numpy(),
                                  b_off.priority.numpy())


def events_of(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def test_fleet_kill_one_actor_keeps_learning(tmp_path):
    from smartcal_tpu_torch.parallel import learner

    install_faults(FaultPlan(kill_actor=1, kill_at=1))
    run = str(tmp_path / "fleet.jsonl")
    (st, buf), scores, summary = learner.train_supervised(
        seed=0, episodes=6, n_actors=2, env_kwargs=ENV_KW,
        agent_kwargs=AGENT_KW, rollout_epochs=1, rollout_steps=4,
        batch_envs=2, is_clip=2.0, quiet=True, metrics=run,
        restart_backoff=fast_backoff(), device="cpu")
    clear_faults()
    assert len(scores) == 6 and np.all(np.isfinite(scores))
    assert summary["restarts"] >= 1
    assert st.learn_counter > 0 and buf.cntr > 0
    assert "version" in buf.data and "behavior_logp" in buf.data
    events = events_of(run)
    kinds = {e["event"] for e in events}
    assert {"fault_injected", "actor_down", "actor_restart"} <= kinds
    gauges = {e["name"] for e in events if e["event"] == "gauge"}
    assert {"weight_staleness_versions", "is_clip_saturation",
            "per_actor_transitions_per_s"} <= gauges
    # learning went on after the kill: episodes after the restart event
    restart_at = min(i for i, e in enumerate(events)
                     if e["event"] == "actor_restart")
    assert any(e["event"] == "episode" for e in events[restart_at:])


def test_fleet_checkpoint_resume_carries_actor_iterations(tmp_path):
    from smartcal_tpu_torch.parallel import learner
    from smartcal_tpu_torch.runtime.checkpoint import load_latest

    kw = dict(seed=0, n_actors=2, env_kwargs=ENV_KW, agent_kwargs=AGENT_KW,
              rollout_epochs=1, rollout_steps=3, batch_envs=2, is_clip=2.0,
              quiet=True, ckpt_dir=str(tmp_path / "ck"), ckpt_every=2,
              restart_backoff=fast_backoff(), device="cpu",
              replay_shards=2)
    _, s1, _ = learner.train_supervised(episodes=4, **kw)
    assert len(s1) == 4
    payload, step = load_latest(str(tmp_path / "ck"))
    assert payload["kind"] == "fleet"
    assert set(payload["actor_iterations"]) == {0, 1}
    assert all(v >= 1 for v in payload["actor_iterations"].values())
    assert payload["learner_version"] >= step
    assert payload["replay"]["kind"] == "device_sharded"
    saved = dict(payload["actor_iterations"])
    (_, buf2), s2, _ = learner.train_supervised(episodes=6, resume=True,
                                                **kw)
    assert len(s2) == 6
    assert s2[:step] == pytest.approx(payload["scores"][:step])
    assert buf2.cntr > payload["replay"]["state"]["cntr"]
    payload2, step2 = load_latest(str(tmp_path / "ck"))
    assert step2 > step
    assert all(payload2["actor_iterations"][k] >= saved[k] for k in saved)
    assert payload2["learner_version"] > payload["learner_version"]


def test_publish_every_forces_staleness(tmp_path):
    from smartcal_tpu_torch.parallel import learner

    run = str(tmp_path / "stale.jsonl")
    _, _, summary = learner.train_supervised(
        seed=0, episodes=7, n_actors=2, env_kwargs=ENV_KW,
        agent_kwargs=AGENT_KW, rollout_epochs=1, rollout_steps=4,
        is_clip=2.0, publish_every=4, quiet=True, metrics=run,
        restart_backoff=fast_backoff(), device="cpu")
    events = events_of(run)
    stale = [e["value"] for e in events if e.get("event") == "gauge"
             and e["name"] == "weight_staleness_versions"]
    assert max(stale) >= 2, stale
    tr_stale = [e["value"] for e in events if e.get("event") == "gauge"
                and e["name"] == "transition_staleness_mean"]
    assert tr_stale and max(tr_stale) > 0.0
    assert summary["transition_staleness_mean"] > 0.0


def test_fleet_clis_exit_non_zero_when_every_actor_failed(monkeypatch):
    from smartcal_tpu_torch.parallel import demix_learner, learner

    install_faults(FaultPlan(kill_actor=0, kill_at=0))
    _, scores, summary = learner.train_supervised(
        seed=0, episodes=2, n_actors=1, env_kwargs=ENV_KW,
        agent_kwargs=AGENT_KW, rollout_epochs=1, rollout_steps=2,
        max_restarts=0, queue_timeout=0.2, quiet=True,
        restart_backoff=fast_backoff(), device="cpu")
    clear_faults()
    assert summary["stopped"] == "actors_failed" and scores == []
    assert summary["failed_slots"] == [0]
    # both CLIs end with a non-zero status on such a fleet
    for mod, fn, extra in ((learner, "train_supervised", []),
                           (demix_learner, "train_supervised_demix",
                            ["--small"])):
        monkeypatch.setattr(mod, fn, lambda **kw: (None, [], summary))
        with pytest.raises(SystemExit) as exc:
            mod.main(["--supervised", "--device", "cpu", "--episodes", "2"]
                     + extra)
        assert exc.value.code not in (0, None)
        assert "actors_failed" in str(exc.value.code)
