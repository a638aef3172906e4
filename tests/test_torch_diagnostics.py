"""Update diagnostics of the PyTorch port against the JAX package's.

* The ``UpdateDiag`` of a SAC (KLD hint), a TD3 (PER + the hint's ADMM)
  and a DDPG learn step equals JAX's on the same state, batch and noise,
  at the learn-step tolerance (rtol 1e-4 / atol 1e-5), from a state with
  Adam history (JAX's agent after 10 warm-up learn steps, as in
  tests/test_torch_sac.py).
* ``collect_diag`` on or off gives bit-identical agent states.
* The no-learn step reports the all-zero diag.
* ``rl.replay.replay_health`` equals JAX's on the same ring.
* The watchdog trips as the JAX package's does (its unit tests, ported),
  and ``TrainObs`` streams diags and halts on a trip.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu import obs as jobs
from smartcal_tpu.rl import ddpg as jddpg
from smartcal_tpu.rl import replay as jr
from smartcal_tpu.rl import sac as jsac
from smartcal_tpu.rl import td3 as jtd3
from smartcal_tpu_torch import interop, obs
from smartcal_tpu_torch.rl import ddpg as tddpg
from smartcal_tpu_torch.rl import replay as tr
from smartcal_tpu_torch.rl import sac as tsac
from smartcal_tpu_torch.rl import td3 as ttd3
from smartcal_tpu_torch.train import blocks

OBS, NA, B, MEM = 6, 2, 4, 16
RTOL, ATOL = 1e-4, 1e-5
BASE = dict(obs_dim=OBS, n_actions=NA, batch_size=B, mem_size=MEM)
AGENTS = {
    "sac_kld_hint": (jsac.SACConfig, tsac.SACConfig,
                     dict(use_hint=True, hint_distance="kld",
                          hint_threshold=0.01, admm_rho=1.0)),
    "td3_per_hint_admm": (jtd3.TD3Config, ttd3.TD3Config,
                          dict(prioritized=True, use_hint=True)),
    "ddpg": (jddpg.DDPGConfig, tddpg.DDPGConfig, dict()),
}


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
def clean_obs_state():
    while obs.active() is not None:
        obs.deactivate()
    obs.reset_counters()
    yield
    while obs.active() is not None:
        obs.deactivate()
    obs.reset_counters()


def t(x):
    return torch.from_numpy(np.array(x))


def fill(name, jcfg, n, seed=1):
    """A JAX ring and a port ring holding the same ``n`` transitions."""
    rng = np.random.default_rng(seed)
    jb = jr.replay_init(MEM, jr.transition_spec(OBS, NA))
    tb = tr.replay_init(MEM, tr.transition_spec(OBS, NA), device="cpu")
    for _ in range(n):
        x = {"state": rng.standard_normal(OBS).astype(np.float32),
             "action": rng.uniform(-1, 1, NA).astype(np.float32),
             "reward": np.float32(rng.uniform(-1, 3)),
             "new_state": rng.standard_normal(OBS).astype(np.float32),
             "done": bool(rng.uniform() < 0.2),
             "hint": rng.uniform(-1, 1, NA).astype(np.float32)}
        if name.startswith("td3"):
            jp = jtd3.store_priority(jcfg, jnp.asarray(x["reward"]))
            tp = t(jp)
        else:
            jp, tp = 1.0, 1.0
        jb = jr.replay_add(jb, x, priority=jp)
        tr.replay_add(tb, x, priority=tp)
    return jb, tb


def draws(name, jcfg, key):
    """The draws the JAX learn step makes from ``key``, as the port's
    ``learn`` keyword arguments."""
    if name == "ddpg":
        return {"sample_noise": t(jax.random.gumbel(key, (MEM,)))}
    k_samp, k_core = jax.random.split(key)
    if jcfg.prioritized:
        sample = t(jax.random.uniform(k_samp, (B,)))
    else:
        sample = t(jax.random.gumbel(k_samp, (MEM,)))
    if name.startswith("td3"):
        return {"sample_noise": sample,
                "smooth_noise": t(jax.random.normal(k_core, ()))}
    return {"sample_noise": sample,
            "noise": tuple(t(jax.random.normal(k, (B, NA)))
                           for k in jax.random.split(k_core, 3))}


def carry(name, jst, tcfg):
    return {"sac_kld_hint": interop.sac_state_from_jax,
            "td3_per_hint_admm": interop.td3_state_from_jax,
            "ddpg": interop.ddpg_state_from_jax}[name](jst, tcfg)


JMOD = {"sac_kld_hint": jsac, "td3_per_hint_admm": jtd3, "ddpg": jddpg}
TMOD = {"sac_kld_hint": tsac, "td3_per_hint_admm": ttd3, "ddpg": tddpg}
JINIT = {"sac_kld_hint": jsac.sac_init, "td3_per_hint_admm": jtd3.td3_init,
         "ddpg": jddpg.ddpg_init}


def _warm(name):
    jc, _, kw = AGENTS[name]
    jcfg = jc(**BASE, **kw)
    mod = JMOD[name]
    st = jax.jit(lambda k: JINIT[name](k, jcfg))(jax.random.PRNGKey(0))
    buf, _ = fill(name, jcfg, 13, seed=2)
    plain = jax.jit(lambda s, b, k: mod.learn(jcfg, s, b, k))
    for i in range(10):
        st, buf, _ = plain(st, buf, jax.random.PRNGKey(50 + i))
    if name != "ddpg":
        st = st._replace(learn_counter=jnp.asarray(0, jnp.int32))
    if name == "sac_kld_hint":
        st = st._replace(rho=jnp.asarray(0.0, jnp.float32))
    return st, jax.jit(lambda s, b, k: mod.learn(jcfg, s, b, k,
                                                  collect_diag=True))


@pytest.fixture(scope="module")
def warm():
    """Per agent: JAX's agent after 10 learn steps (Adam history), its
    counters set back to 0, and its diag-collecting learn step."""
    return {name: _warm(name) for name in AGENTS}


@pytest.mark.parametrize("name", list(AGENTS))
def test_diag_matches_jax(name, warm):
    jc, tc, kw = AGENTS[name]
    jcfg, tcfg = jc(**BASE, **kw), tc(**BASE, **kw)
    jst, jlearn = warm[name]
    tst = carry(name, jst, tcfg)
    jb, tb = fill(name, jcfg, 13)
    worst = 0.0
    # two steps: TD3's first is a delayed-actor skip step, its second
    # runs the hint's ADMM actor update
    for i in range(2):
        key = jax.random.PRNGKey(100 + i)
        jst, jb, jm = jlearn(jst, jb, key)
        tm = TMOD[name].learn(tcfg, tst, tb, **draws(name, jcfg, key),
                              collect_diag=True)
        want = jobs.diag_to_host(jm["diag"])
        got = obs.diag_to_host(tm["diag"])
        assert set(got) == set(want) == set(obs.UpdateDiag._fields)
        for k in obs.UpdateDiag._fields:
            np.testing.assert_allclose(got[k], want[k], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {i} {k}")
            worst = max(worst, abs(got[k] - want[k]))
    nonzero = [k for k in obs.UpdateDiag._fields if got[k] != 0.0]
    assert {"critic_loss", "critic_grad_norm", "critic_update_ratio",
            "actor_grad_norm", "actor_update_ratio", "q_mean",
            "target_drift"} <= set(nonzero)
    print(f"{name}: diag max abs err {worst:.3e}")


@pytest.mark.parametrize("name", list(AGENTS))
def test_collect_diag_changes_nothing(name, warm):
    """Three learn steps with and without diagnostics: the agent states
    and the rings are the same bits."""
    jc, tc, kw = AGENTS[name]
    jcfg, tcfg = jc(**BASE, **kw), tc(**BASE, **kw)
    jst = warm[name][0]
    states, rings = [], []
    for collect in (False, True):
        tst = carry(name, jst, tcfg)
        _, tb = fill(name, jcfg, 13)
        for i in range(3):
            m = TMOD[name].learn(tcfg, tst, tb,
                                 **draws(name, jcfg, jax.random.PRNGKey(i)),
                                 collect_diag=collect)
            assert ("diag" in m) == collect
        states.append(tst.to_host())
        rings.append((tb.priority.clone(), tb.beta))

    def walk(a, b, path=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert np.array_equal(np.asarray(a), np.asarray(b)), path

    walk(*states)
    assert torch.equal(rings[0][0], rings[1][0])
    assert rings[0][1] == rings[1][1]


@pytest.mark.parametrize("name", list(AGENTS))
def test_no_learn_step_reports_zero_diag(name):
    _, tc, kw = AGENTS[name]
    tcfg = tc(**BASE, **kw)
    agent = {"sac_kld_hint": tsac.SACAgent, "td3_per_hint_admm":
             ttd3.TD3Agent, "ddpg": tddpg.DDPGAgent}[name](
        tcfg, seed=0, device="cpu", collect_diag=True)
    s = np.zeros(OBS, np.float32)
    agent.store_transition(s, np.zeros(NA, np.float32), 1.0, s, False,
                           np.zeros(NA, np.float32))
    agent.learn()                           # 1 < batch_size: no learn
    host = obs.diag_to_host(agent.last_diag)
    assert all(v == 0.0 for v in host.values())
    assert "diag" not in agent.last_metrics


@pytest.mark.parametrize("prioritized", [False, True])
def test_replay_health_matches_jax(prioritized):
    name = "td3_per_hint_admm" if prioritized else "ddpg"
    jc, _, kw = AGENTS[name]
    jb, tb = fill(name, jc(**BASE, **kw), 21)        # wraps the ring
    want, got = jr.replay_health(jb), tr.replay_health(tb)
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-7,
                                   err_msg=k)


# -- the watchdog (the JAX package's unit tests, ported) -------------------

def _diag(closs=0.1, aloss=0.1, cgrad=1.0, agrad=1.0, q=0.5):
    return {"critic_loss": closs, "actor_loss": aloss,
            "critic_grad_norm": cgrad, "actor_grad_norm": agrad,
            "q_mean": q, "q_min": q - 1, "q_max": q + 1}


def read_jsonl(path):
    return [json.loads(ln) for ln in open(path).read().splitlines()]


def test_watchdog_defaults_match_jax():
    assert obs.WatchdogConfig() == obs.WatchdogConfig(
        **vars(jobs.WatchdogConfig()))
    assert vars(obs.WatchdogConfig()) == vars(jobs.WatchdogConfig())


def test_watchdog_nan_trip_with_ring(tmp_path):
    path = str(tmp_path / "w.jsonl")
    with obs.recording(path):
        wd = obs.Watchdog(obs.WatchdogConfig(ring=4))
        for i in range(6):
            assert not wd.observe(_diag(), step=i)
        assert wd.observe(_diag(closs=float("nan")), step=6)
    assert wd.tripped and wd.trip_reason == "non_finite:critic_loss"
    trips = [e for e in read_jsonl(path) if e["event"] == "watchdog_trip"]
    assert len(trips) == 1
    tr_ = trips[0]
    assert tr_["reason"] == "non_finite:critic_loss" and tr_["step"] == 6
    assert len(tr_["ring"]) == 4 and tr_["ring"][-1]["step"] == 6
    assert tr_["ring"][-1]["critic_loss"] is None
    assert wd.observe(_diag(), step=7)         # latched


def test_watchdog_sanitized_null_counts_as_non_finite():
    wd = obs.Watchdog()
    d = _diag()
    d["critic_grad_norm"] = None
    assert wd.observe(d, step=0)
    assert wd.trip_reason == "non_finite:critic_grad_norm"


def test_watchdog_exploding_grad_within_k_steps():
    wd = obs.Watchdog(obs.WatchdogConfig(grad_mult=10.0, warmup=5,
                                         ewma_alpha=0.1))
    rng = np.random.default_rng(5)
    for i in range(20):
        assert not wd.observe(_diag(cgrad=1.0 + 0.1
                                    * rng.standard_normal()), step=i)
    assert wd.observe(_diag(cgrad=1e4), step=20)
    assert wd.trip_reason.startswith("exploding_grad:critic_grad_norm")


def test_watchdog_skips_zero_grads_and_warmup():
    wd = obs.Watchdog(obs.WatchdogConfig(grad_mult=5.0, warmup=3))
    for i in range(50):
        assert not wd.observe(_diag(cgrad=0.0, agrad=0.0), step=i)
    assert not wd.observe(_diag(cgrad=2.0), step=50)
    for i in range(10):
        assert not wd.observe(_diag(cgrad=2.0), step=51 + i)
    assert not wd.tripped


def test_watchdog_q_blowup_and_replay():
    wd = obs.Watchdog(obs.WatchdogConfig(q_limit=100.0))
    assert not wd.observe(_diag(q=50.0), step=0)
    assert wd.observe(_diag(q=500.0), step=1)
    assert wd.trip_reason.startswith("q_blowup:")
    wd = obs.Watchdog()
    assert not wd.observe_replay({"priority_entropy": 0.9,
                                  "priority_total": 10.0})
    assert wd.observe_replay({"priority_entropy": float("nan"),
                              "priority_total": 10.0})
    assert wd.trip_reason == "replay_non_finite:priority_entropy"


def test_watchdog_reasons_match_jax():
    """The same stream trips both packages' watchdogs for the same
    reason at the same step."""
    stream = ([_diag(cgrad=1.0 + 0.01 * i) for i in range(25)]
              + [_diag(cgrad=1e5)])
    for make in (obs, jobs):
        wd = make.Watchdog()
        steps = [i for i, d in enumerate(stream) if wd.observe(d, step=i)]
        assert steps[0] == 25
        assert wd.trip_reason.startswith("exploding_grad:critic_grad_norm")


def test_train_obs_streams_diag_and_halts(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tob = blocks.train_obs("unit", metrics=path, quiet=True, diag=True,
                           watchdog=True)
    try:
        clean = obs.stack_diags([obs.make_diag(critic_loss=0.1,
                                               q_mean=0.2)] * 3)
        assert tob.record_diag(clean, episode=0) is False
        bad = {k: [0.1, float("nan"), 0.1] for k in obs.UpdateDiag._fields}
        assert tob.record_diag(bad, episode=1) is True
        assert tob.tripped
        assert tob.record_diag(clean, episode=2) is True
        _, tb = fill("ddpg", None, 5)
        tob.log_replay_health(tb, episode=2)
    finally:
        tob.close()
    recs = read_jsonl(path)
    diags = [e for e in recs if e["event"] == "diag"]
    assert [d["step"] for d in diags[:4]] == [0, 1, 2, 3]
    assert diags[0]["q_mean"] == pytest.approx(0.2)
    assert any(e["event"] == "watchdog_trip" for e in recs)
    assert any(e["event"] == "replay_health" for e in recs)
    assert recs[-1]["event"] == "run_end"
    assert recs[-1]["watchdog_tripped"] is True


def test_train_obs_record_diag_noop_without_diag(tmp_path):
    path = str(tmp_path / "t.jsonl")
    tob = blocks.train_obs("unit", metrics=path, quiet=True)
    try:
        assert tob.record_diag(None) is False
        assert tob.record_diag({"critic_loss": float("nan")}) is False
        _, tb = fill("ddpg", None, 3)
        assert tob.log_replay_health(tb) is False
    finally:
        tob.close()
    assert not [e for e in read_jsonl(path)
                if e["event"] in ("diag", "replay_health", "watchdog_trip")]
