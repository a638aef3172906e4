"""The port's deterministic heads, TD3 and DDPG against the JAX package's.

The heads (MLP and image+meta, one observation and a batch) run on carried
weights (``interop.params_from_flax``) and are held at rtol 1e-5 /
atol 1e-6.  TD3 (plain, PER, PER with the hint's adaptive-rho ADMM) and
DDPG each run 12 learn steps from a carried JAX state
(``interop.td3_state_from_jax`` / ``ddpg_state_from_jax``) on the draws JAX
made from its keys (replay Gumbel noise or uniforms, the smoothing
normal).  The carried state has Adam history: JAX's agent after 10 warm-up
learn steps, its counter set back to 0 (from fresh moments, round-off in
a gradient near 1e-9 becomes a 1e-4 parameter difference:
tests/test_torch_sac.py).  Losses are held at rtol 1e-4; every parameter,
target, Adam moment and count, and the PER priorities, at rtol 1e-4 /
atol 1e-5.  ``choose_action`` (TD3's warmup switch, DDPG's OU state) is
held at rtol 1e-5 / atol 1e-6.  Run with ``-s`` to see the measured
maxima.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.rl import ddpg as jddpg
from smartcal_tpu.rl import networks as jn
from smartcal_tpu.rl import replay as jr
from smartcal_tpu.rl import td3 as jtd3
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.rl import ddpg as tddpg
from smartcal_tpu_torch.rl import networks as tn
from smartcal_tpu_torch.rl import replay as tr
from smartcal_tpu_torch.rl import td3 as ttd3

OBS, NA, B, MEM = 24, 2, 4, 16
RTOL, ATOL = 1e-4, 1e-5
NET_RTOL, NET_ATOL = 1e-5, 1e-6
BASE = dict(obs_dim=OBS, n_actions=NA, batch_size=B, mem_size=MEM)
TD3_VARIANTS = {
    "plain": dict(),
    "per": dict(prioritized=True),
    "per_hint_admm": dict(prioritized=True, use_hint=True),
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


def _leaves(d, path=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def same_state(got_host, want_host, tag):
    got, want = dict(_leaves(got_host)), dict(_leaves(want_host))
    assert set(got) == set(want)
    worst = 0.0
    for k, w in want.items():
        g = got[k]
        if isinstance(w, int):
            assert g == w, (tag, k)
            continue
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag} {k}")
        worst = max(worst, float(np.max(np.abs(np.asarray(g) - w))))
    return worst


def fill(prioritized, n, seed=1, td3_cfg=None):
    """A JAX ring and a port ring holding the same ``n`` transitions (TD3's
    PER stores the reward's priority, the others priority 1)."""
    rng = np.random.default_rng(seed)
    jb = jr.replay_init(MEM, jr.transition_spec(OBS, NA))
    tb = tr.replay_init(MEM, tr.transition_spec(OBS, NA), device="cpu")
    for _ in range(n):
        t = {"state": rng.standard_normal(OBS).astype(np.float32),
             "action": rng.uniform(-1, 1, NA).astype(np.float32),
             "reward": np.float32(rng.uniform(-1, 3)),
             "new_state": rng.standard_normal(OBS).astype(np.float32),
             "done": bool(rng.uniform() < 0.2),
             "hint": rng.uniform(-1, 1, NA).astype(np.float32)}
        if prioritized:
            jp = jtd3.store_priority(td3_cfg, jnp.asarray(t["reward"]))
            tp = ttd3.store_priority(td3_cfg, t["reward"])
            np.testing.assert_allclose(tp.numpy(), np.asarray(jp),
                                       rtol=1e-6)
        else:
            jp = tp = 1.0
        jb = jr.replay_add(jb, t, priority=jp)
        tr.replay_add(tb, t, priority=tp)
    return jb, tb


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("kind, side", [("mlp", None), ("cnn", 16),
                                        ("cnn", 15)])
def test_deterministic_actor_matches(kind, side):
    rng = np.random.default_rng(0)
    if kind == "mlp":
        obs_dim = OBS
        fa = jn.MLPDeterministicActor(NA)
        ta = tn.MLPDeterministicActor(obs_dim, NA)
    else:
        obs_dim = side * side + 11
        fa = jn.SplitImageMetaDeterministicActor(img_shape=(side, side),
                                                 n_actions=NA)
        ta = tn.SplitImageMetaDeterministicActor((side, side), obs_dim, NA)
    params = jax.jit(fa.init)(jax.random.PRNGKey(3),
                              jnp.zeros((1, obs_dim)))["params"]
    ta.load_state_dict(interop.params_from_flax(params, ta))
    for n in (None, 5):                        # one observation, a batch
        obs = rng.standard_normal((obs_dim,) if n is None
                                  else (n, obs_dim)).astype(np.float32)
        want = np.asarray(fa.apply({"params": params}, obs))
        got = ta(t(obs)).detach().numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=NET_RTOL, atol=NET_ATOL)


def test_cnn_actor_keeps_the_unused_head_unchanged():
    """The logsigma head of the CNN deterministic actor gets no gradient:
    after TD3 learn steps its parameters and Adam moments are unchanged,
    as optax leaves them."""
    cfg = ttd3.TD3Config(obs_dim=16 * 16 + 11, n_actions=NA, batch_size=B,
                         mem_size=MEM, img_shape=(16, 16), warmup=0)
    agent = ttd3.TD3Agent(cfg, seed=0, device="cpu")
    head = agent.state.actor.ImageMetaActor_0.logsigma
    before = {k: v.clone() for k, v in agent.state.actor.state_dict().items()}
    rng = np.random.default_rng(0)
    for _ in range(B + 2):
        s = rng.standard_normal(cfg.obs_dim).astype(np.float32)
        agent.store_transition(s, agent.choose_action(s), 1.0, s, False,
                               np.zeros(NA, np.float32))
        agent.learn()
    assert agent.state.learn_counter == 3
    after = agent.state.actor.state_dict()
    for k, v in before.items():
        moved = not torch.equal(after[k], v)
        assert moved == (not k.startswith(f"ImageMetaActor_0.{head}.")), k
        if not moved:
            assert not agent.state.actor_opt.mu[k].any()


# -- TD3 ------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_td3_learn(jcfg):
    return jax.jit(lambda st, buf, key: jtd3.learn(jcfg, st, buf, key))


def td3_draws(jcfg, key):
    """The draws ``smartcal_tpu.rl.td3.learn`` makes from ``key``."""
    k_samp, k_noise = jax.random.split(key)
    if jcfg.prioritized:
        sample = jax.random.uniform(k_samp, (B,))
    else:
        sample = jax.random.gumbel(k_samp, (MEM,))
    return t(sample), t(jax.random.normal(k_noise, ()))


@pytest.fixture(scope="module")
def td3_warm():
    """JAX's TD3 agent after 10 learn steps of the hint variant (so the
    actor has Adam history too), counter set back to 0."""
    jcfg = jtd3.TD3Config(**BASE, **TD3_VARIANTS["per_hint_admm"])
    st = jax.jit(lambda k: jtd3.td3_init(k, jcfg))(jax.random.PRNGKey(0))
    buf, _ = fill(True, 13, seed=2, td3_cfg=jcfg)
    for i in range(10):
        st, buf, _ = jax_td3_learn(jcfg)(st, buf, jax.random.PRNGKey(50 + i))
    return st._replace(learn_counter=jnp.asarray(0, jnp.int32))


@pytest.mark.parametrize("variant", list(TD3_VARIANTS))
def test_td3_twelve_learn_steps_match(variant, td3_warm):
    kw = {**BASE, **TD3_VARIANTS[variant]}
    jcfg, tcfg = jtd3.TD3Config(**kw), ttd3.TD3Config(**kw)
    jst = td3_warm
    tst = interop.td3_state_from_jax(jst, tcfg)
    jb, tb = fill(jcfg.prioritized, 13, td3_cfg=jcfg)
    step = jax_td3_learn(jcfg)
    loss_err, worst = 0.0, 0.0
    for i in range(12):
        key = jax.random.PRNGKey(100 + i)
        jst, jb, jm = step(jst, jb, key)
        sample, smooth = td3_draws(jcfg, key)
        tm = ttd3.learn(tcfg, tst, tb, sample_noise=sample,
                        smooth_noise=smooth)
        np.testing.assert_allclose(float(tm["critic_loss"]),
                                   float(jm["critic_loss"]), rtol=RTOL,
                                   err_msg=f"{variant} step {i}")
        loss_err = max(loss_err, abs(float(tm["critic_loss"])
                                     / float(jm["critic_loss"]) - 1))
        if i in (0, 1, 11):
            worst = max(worst, same_state(
                tst.to_host(), interop.td3_state_from_jax(jst, tcfg)
                .to_host(), f"{variant} step {i}"))
    assert tst.learn_counter == int(jst.learn_counter) == 12
    if jcfg.prioritized:
        np.testing.assert_allclose(tb.priority.numpy(),
                                   np.asarray(jb.priority), rtol=RTOL)
        assert tb.beta == np.float32(jb.beta)
    print(f"td3 {variant}: 12 steps, max rel loss err {loss_err:.3e}, max "
          f"abs state err {worst:.3e}")


def test_td3_admm_adapts_rho(td3_warm):
    """The hint's ADMM loop fires its adaptive-rho rule on these inputs:
    with ``adaptive_admm`` off the actor ends elsewhere, and each package's
    result matches the other's (from the carried state with Adam
    history)."""
    rng = np.random.default_rng(1)
    s = rng.standard_normal((B, OBS)).astype(np.float32)
    hint = rng.uniform(-1, 1, (B, NA)).astype(np.float32)
    is_w = np.ones(B, np.float32)
    out = {}
    for adaptive in (True, False):
        # a large actor step moves the actions enough for the spectral
        # estimate to land inside the (0.1, 10) x admm_rho gate
        kw = {**BASE, "use_hint": True, "adaptive_admm": adaptive,
              "admm_rho": 1.0, "lr_a": 0.05}
        jcfg, tcfg = jtd3.TD3Config(**kw), ttd3.TD3Config(**kw)
        jst = td3_warm
        tst = interop.td3_state_from_jax(jst, tcfg)
        params, opt = jax.jit(lambda st: jtd3._actor_admm_update(
            jcfg, st, st.c1_params, s, hint, is_w))(jst)
        ttd3._actor_admm_update(tcfg, tst, t(s), t(hint), t(is_w))
        want = interop.td3_state_from_jax(
            jst._replace(actor_params=params, actor_opt=opt), tcfg)
        same_state(tst.to_host(), want.to_host(), f"adaptive={adaptive}")
        out[adaptive] = tst.actor.state_dict()
    assert any(not torch.equal(out[True][k], out[False][k])
               for k in out[True])


def test_td3_choose_action_warmup_and_actor(td3_warm):
    kw = {**BASE, "warmup": 2}
    jcfg, tcfg = jtd3.TD3Config(**kw), ttd3.TD3Config(**kw)
    jst = td3_warm._replace(time_step=jnp.asarray(0, jnp.int32))
    tst = interop.td3_state_from_jax(jst, tcfg)
    obs = np.random.default_rng(4).standard_normal(OBS).astype(np.float32)
    choose = jax.jit(lambda st, o, k: jtd3.choose_action(jcfg, st, o, k))
    for i in range(4):                      # two warmup calls, two actor
        key = jax.random.PRNGKey(20 + i)
        want, jst = choose(jst, obs, key)
        k_random, k_explore = jax.random.split(key)
        noise = (t(jax.random.normal(k_random, (NA,))),
                 t(jax.random.normal(k_explore, (NA,))))
        got = ttd3.choose_action(tcfg, tst, t(obs), noise)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=NET_RTOL, atol=NET_ATOL)
        assert tst.time_step == int(jst.time_step) == i + 1
    assert np.all(np.abs(got.numpy()) <= 1.0)


def test_td3_no_learn_below_batch_size(td3_warm):
    tcfg = ttd3.TD3Config(**BASE)
    tst = interop.td3_state_from_jax(td3_warm, tcfg)
    before = tst.to_host()
    _, tb = fill(False, B - 1)
    m = ttd3.learn(tcfg, tst, tb)
    assert float(m["critic_loss"]) == 0.0 and tst.learn_counter == 0
    same_state(tst.to_host(), before, "no learn")


# -- DDPG -----------------------------------------------------------------

@pytest.fixture(scope="module")
def ddpg_warm():
    jcfg = jddpg.DDPGConfig(**BASE)
    st = jax.jit(lambda k: jddpg.ddpg_init(k, jcfg))(jax.random.PRNGKey(0))
    buf, _ = fill(False, 13, seed=2)
    learn = jax.jit(lambda st, buf, key: jddpg.learn(jcfg, st, buf, key))
    for i in range(10):
        st, buf, _ = learn(st, buf, jax.random.PRNGKey(50 + i))
    return st


def test_ddpg_twelve_learn_steps_match(ddpg_warm):
    jcfg, tcfg = jddpg.DDPGConfig(**BASE), tddpg.DDPGConfig(**BASE)
    jst = ddpg_warm
    tst = interop.ddpg_state_from_jax(jst, tcfg)
    jb, tb = fill(False, 13)
    learn = jax.jit(lambda st, buf, key: jddpg.learn(jcfg, st, buf, key))
    worst = 0.0
    for i in range(12):
        key = jax.random.PRNGKey(100 + i)
        jst, jb, jm = learn(jst, jb, key)
        tm = tddpg.learn(tcfg, tst, tb,
                         sample_noise=t(jax.random.gumbel(key, (MEM,))))
        for k in ("critic_loss", "actor_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL, err_msg=f"step {i} {k}")
        if i in (0, 11):
            worst = max(worst, same_state(
                tst.to_host(), interop.ddpg_state_from_jax(jst, tcfg)
                .to_host(), f"ddpg step {i}"))
    print(f"ddpg: 12 steps, max abs state err {worst:.3e}")


def test_ddpg_choose_action_carries_ou_state(ddpg_warm):
    jcfg, tcfg = jddpg.DDPGConfig(**BASE), tddpg.DDPGConfig(**BASE)
    jst = ddpg_warm
    tst = interop.ddpg_state_from_jax(jst, tcfg)
    obs = np.random.default_rng(4).standard_normal(OBS).astype(np.float32)
    choose = jax.jit(lambda st, o, k: jddpg.choose_action(jcfg, st, o, k))
    for i in range(3):
        key = jax.random.PRNGKey(30 + i)
        want, jst = choose(jst, obs, key)
        got = tddpg.choose_action(tcfg, tst, t(obs),
                                  t(jax.random.normal(key, (NA,))))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=NET_RTOL, atol=NET_ATOL)
        np.testing.assert_allclose(tst.noise.numpy(),
                                   np.asarray(jst.noise.x_prev),
                                   rtol=NET_RTOL, atol=NET_ATOL)


def test_agents_save_and_load(tmp_path):
    for mod, agent_cls, cfg, name in (
            (ttd3, ttd3.TD3Agent, ttd3.TD3Config(**BASE, prioritized=True),
             "td3"),
            (tddpg, tddpg.DDPGAgent, tddpg.DDPGConfig(**BASE), "ddpg")):
        agent = agent_cls(cfg, seed=3, name_prefix=str(tmp_path / "a_"),
                          device="cpu")
        rng = np.random.default_rng(0)
        for _ in range(B + 1):
            s = rng.standard_normal(OBS).astype(np.float32)
            agent.store_transition(s, agent.choose_action(s), 1.5, s, False,
                                   np.zeros(NA, np.float32))
            agent.learn()
        agent.save_models()
        assert (tmp_path / f"a_{name}_state.pkl").exists()
        other = agent_cls(cfg, seed=4, name_prefix=str(tmp_path / "a_"),
                          device="cpu")
        assert other.load_models()
        assert other.buffer.cntr == B + 1
        same_state(other.state.to_host(), agent.state.to_host(), name)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no GPU"):
        ttd3.TD3Agent(ttd3.TD3Config(**BASE))
    with pytest.raises(RuntimeError, match="no GPU"):
        tddpg.DDPGAgent(tddpg.DDPGConfig(**BASE))
    # the fleet's staleness weighting is ported: the config is accepted
    assert ttd3.TD3Config(**BASE, is_clip=2.0).is_clip == 2.0
