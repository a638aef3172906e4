"""The port's SAC learn step against the JAX package's, from the same
carried ``SACState`` (``interop.sac_state_from_jax``) at a 16² image.

Each variant runs 12 learn steps, which cross the dual/temperature update
at counters 0 and 10; the port is fed the draws JAX made from its keys
(replay Gumbel noise or uniforms, and the three unit normal draws of each
step).

The carried state has Adam history: JAX's agent after 10 warm-up steps,
its learn counter set back to 0.  From fresh moments a parameter's first
Adam step is ``lr * g / (|g| + 1e-8)``, which turns the round-off of a
gradient near 1e-9 into a parameter difference of up to 1e-4 (one of
~37k weights per network; measured g = -9.25e-10 in JAX against
-3.15e-10 in the port).

Losses are held at rtol 1e-4; alpha, rho, every parameter and Adam moment
(and the PER priorities) at rtol 1e-4 / atol 1e-5.  Run with ``-s`` to
see the measured maxima.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.rl import replay as jr
from smartcal_tpu.rl import sac as jsac
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.rl import replay as tr
from smartcal_tpu_torch.rl import sac as tsac

H = W = 16
META, NA, B, MEM = 11, 4, 4, 16
OBS = H * W + META
RTOL, ATOL = 1e-4, 1e-5
BASE = dict(obs_dim=OBS, n_actions=NA, batch_size=B, mem_size=MEM,
            img_shape=(H, W), hint_threshold=0.01, admm_rho=1.0,
            alpha_lr=1e-2)
VARIANTS = {
    "kld_hint": dict(use_hint=True, hint_distance="kld"),
    "mse_hint": dict(use_hint=True, hint_distance="mse"),
    "alpha_reference": dict(learn_alpha=True),
    "alpha_sac_v2": dict(learn_alpha=True, alpha_rule="sac_v2"),
    "per_kld_hint": dict(prioritized=True, use_hint=True,
                         hint_distance="kld"),
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


def fill(jcfg, n, seed=1):
    """A JAX ring and a port ring holding the same ``n`` transitions."""
    rng = np.random.default_rng(seed)
    jb = jr.replay_init(MEM, jr.transition_spec(OBS, NA))
    tb = tr.replay_init(MEM, tr.transition_spec(OBS, NA), device="cpu")
    p = None if jcfg.prioritized else 1.0
    for _ in range(n):
        t = {"state": rng.standard_normal(OBS).astype(np.float32),
             "action": rng.uniform(-1, 1, NA).astype(np.float32),
             "reward": np.float32(rng.uniform(0, 3)),
             "new_state": rng.standard_normal(OBS).astype(np.float32),
             "done": bool(rng.uniform() < 0.2),
             "hint": rng.uniform(-1, 1, NA).astype(np.float32)}
        jb = jr.replay_add(jb, t, priority=p)
        tr.replay_add(tb, t, priority=p)
    return jb, tb


def jax_draws(jcfg, key):
    """The draws ``smartcal_tpu.rl.sac.learn`` makes from ``key``: the
    replay draw of k_samp and the three normals of k_core's split."""
    k_samp, k_core = jax.random.split(key)
    if jcfg.prioritized:
        sample = jax.random.uniform(k_samp, (B,))
    else:
        sample = jax.random.gumbel(k_samp, (MEM,))
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (B, NA))))
                  for k in jax.random.split(k_core, 3))
    return torch.from_numpy(np.array(sample)), noise


def _leaves(d, path=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def same_state(tst, jst, tcfg, tag):
    """Every parameter, target, Adam moment and count, alpha, rho and the
    counter; returns the max abs error over the arrays."""
    want = dict(_leaves(interop.sac_state_from_jax(jst, tcfg).to_host()))
    got = dict(_leaves(tst.to_host()))
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


@functools.lru_cache(maxsize=None)
def jax_learn(jcfg):
    return jax.jit(lambda st, buf, key: jsac.learn(jcfg, st, buf, key))


@pytest.fixture(scope="module")
def jax_init():
    """JAX's fresh agent after 10 learn steps of the kld_hint variant, its
    counter and rho set back to 0 (see the module docstring)."""
    jcfg = jsac.SACConfig(**BASE, **VARIANTS["kld_hint"])
    st = jax.jit(lambda k: jsac.sac_init(k, jcfg))(jax.random.PRNGKey(0))
    buf, _ = fill(jcfg, 13, seed=2)
    for i in range(10):
        st, buf, _ = jax_learn(jcfg)(st, buf, jax.random.PRNGKey(50 + i))
    return st._replace(learn_counter=jnp.asarray(0, jnp.int32),
                       rho=jnp.asarray(0.0, jnp.float32))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_twelve_learn_steps_match(variant, jax_init):
    kw = {**BASE, **VARIANTS[variant]}
    jcfg, tcfg = jsac.SACConfig(**kw), tsac.SACConfig(**kw)
    jst = jax_init
    if jcfg.learn_alpha and jcfg.alpha_rule == "sac_v2":
        jst = jst._replace(alpha=jnp.asarray(1.0, jnp.float32))
    tst = interop.sac_state_from_jax(jst, tcfg)
    jb, tb = fill(jcfg, 13)
    step = jax_learn(jcfg)
    loss_err, scal_err = 0.0, 0.0
    for i in range(12):
        key = jax.random.PRNGKey(100 + i)
        jst, jb, jm = step(jst, jb, key)
        sample, noise = jax_draws(jcfg, key)
        tm = tsac.learn(tcfg, tst, tb, sample_noise=sample, noise=noise)
        for k in ("critic_loss", "actor_loss"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                       err_msg=f"{variant} step {i} {k}")
            loss_err = max(loss_err, abs(float(tm[k]) / float(jm[k]) - 1))
        for k in ("alpha", "rho"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL,
                                       atol=ATOL,
                                       err_msg=f"{variant} step {i} {k}")
            scal_err = max(scal_err, abs(float(tm[k]) - float(jm[k])))
        if i in (0, 11):
            worst = same_state(tst, jst, tcfg, f"{variant} step {i}")
    assert tst.learn_counter == int(jst.learn_counter) == 12
    if jcfg.use_hint:
        assert float(tst.rho) > 0.0           # both dual updates ran
    if jcfg.learn_alpha:
        assert float(tst.alpha) != float(jax_init.alpha)
    if jcfg.prioritized:
        np.testing.assert_allclose(tb.priority.numpy(),
                                   np.asarray(jb.priority), rtol=RTOL)
        assert tb.beta == np.float32(jb.beta)
    print(f"{variant}: 12 steps, max rel loss err {loss_err:.3e}, max abs "
          f"alpha/rho err {scal_err:.3e}, max abs state err {worst:.3e}")


def test_no_learn_below_batch_size(jax_init):
    kw = {**BASE, **VARIANTS["kld_hint"]}
    jcfg, tcfg = jsac.SACConfig(**kw), tsac.SACConfig(**kw)
    tst = interop.sac_state_from_jax(jax_init, tcfg)
    before = tst.to_host()
    jb, tb = fill(jcfg, B - 1)
    jst, _, jm = jax_learn(jcfg)(jax_init, jb, jax.random.PRNGKey(1))
    tm = tsac.learn(tcfg, tst, tb)
    for k in ("critic_loss", "actor_loss", "alpha", "rho"):
        assert float(tm[k]) == float(jm[k]), k
    assert tst.learn_counter == int(jst.learn_counter) == 0
    after = dict(_leaves(tst.to_host()))
    for k, v in _leaves(before):
        np.testing.assert_array_equal(after[k], v, k)


def test_config_refuses_what_is_not_ported():
    # the fleet's staleness weighting is ported: the config is accepted
    assert tsac.SACConfig(obs_dim=4, n_actions=2, is_clip=2.0).is_clip == 2.0
    # the native sum-tree replay is ported (tests/test_torch_replay_native)
    cfg = tsac.SACConfig(obs_dim=4, n_actions=2, prioritized=True,
                         replay_backend="native")
    assert cfg.replay_backend == "native"
    with pytest.raises(ValueError):      # fleet knobs stay hbm-only
        tsac.SACConfig(obs_dim=4, n_actions=2, prioritized=True,
                       replay_backend="native", ere_eta=0.5)
    with pytest.raises(ValueError):
        tsac.SACConfig(obs_dim=4, n_actions=2, alpha_rule="v3")
    with pytest.raises(ValueError):
        tsac.SACConfig(obs_dim=4, n_actions=2, ere_eta=0.0)


def test_choose_action_and_policy_heads_match(jax_init):
    tcfg = tsac.SACConfig(**BASE)
    jcfg = jsac.SACConfig(**BASE)
    tst = interop.sac_state_from_jax(jax_init, tcfg)
    obs = np.random.default_rng(4).standard_normal(OBS).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = jax.jit(lambda st, o, k: jsac.choose_action(jcfg, st, o, k))(
        jax_init, obs, key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (NA,))))
    got = tsac.choose_action(tcfg, tst, torch.from_numpy(obs), noise)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    heads = tsac.policy_heads(tcfg, tst.actor, torch.from_numpy(obs))
    for g, w in zip(heads, jax.jit(lambda p, o: jsac.policy_heads(
            jcfg, p, o))(jax_init.actor_params, obs)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_array_equal(
        tsac.policy_apply(tcfg, tst.actor, torch.from_numpy(obs)).numpy(),
        heads[0].numpy())


def test_agent_saves_and_loads_its_state_and_ring(tmp_path):
    cfg = tsac.SACConfig(**{**BASE, "batch_size": 2})
    agent = tsac.SACAgent(cfg, seed=3, name_prefix=str(tmp_path / "a_"),
                          device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        s = rng.standard_normal(OBS).astype(np.float32)
        a = agent.choose_action(s)
        assert a.shape == (NA,) and np.all(np.abs(a) <= 1)
        agent.store_transition(s, a, 1.5, s, False, np.zeros(NA, np.float32))
        agent.learn()
    assert agent.state.learn_counter == 2
    agent.save_models()
    other = tsac.SACAgent(cfg, seed=4, name_prefix=str(tmp_path / "a_"),
                          device="cpu")
    assert other.load_models()
    assert other.buffer.cntr == 3 and other.buffer.size == MEM
    want = dict(_leaves(agent.state.to_host()))
    for k, v in _leaves(other.state.to_host()):
        np.testing.assert_array_equal(v, want[k], k)
    assert not tsac.SACAgent(cfg, name_prefix=str(tmp_path / "none_"),
                             device="cpu").load_models()


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    cfg = tsac.SACConfig(obs_dim=6, n_actions=2)
    with pytest.raises(RuntimeError, match="no GPU"):
        tsac.sac_init(cfg)
    with pytest.raises(RuntimeError, match="no GPU"):
        tsac.SACAgent(cfg)
