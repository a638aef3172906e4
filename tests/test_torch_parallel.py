"""The port's batched enet program (``envs/enet``'s lane form behind
``parallel/trainer.make_parallel_sac``) against the JAX package's vmapped
``envs/enet`` on JAX's own draws, stage by stage, at M = N = 6 with 3
lanes; and the port's one-program learner ``train_distributed``.

Held, as tests/test_torch_enet.py holds the single env: the lanes' reset
(x0 bit for bit, A to 2 float32 ulps); their solves' first 5 L-BFGS
iterations (rtol 1e-4 / atol 1e-6, the same iteration counts) and the
hint's first 2 (same); the lane step around JAX's vmapped solve and
influence state (obs and reward rtol 1e-5, x bit for bit); the noisy
draw rtol 1e-6.  Past ~10 iterations the float32 solves part in both
packages (ROADMAP queue 3), so nothing is held end to end.

``make_parallel_sac``'s train step and ``run_block`` and
``train_distributed`` (2 episodes, with and without
``learn_per_transition``) run on the CPU: finite scores, the transitions
stored and the learn steps counted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.envs import enet as je
from smartcal_tpu.ops import lbfgs as jl
from smartcal_tpu_torch.envs import enet as te
from smartcal_tpu_torch.parallel import (make_mesh, make_parallel_sac,
                                         learner, trainer)
from smartcal_tpu_torch.rl import sac as tsac

M = N = 6
E = 3
JCFG = je.EnetConfig(M=M, N=N)
TCFG = te.EnetConfig(M=M, N=N)


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


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def lanes():
    """JAX's vmapped reset + noise draw of 3 envs, the port's lanes on
    JAX's raw draws, and 3 actions."""
    keys = jax.random.split(jax.random.PRNGKey(3), E)

    def draws(key):
        kA, kMo, kz, kidx = jax.random.split(key, 4)
        return (jax.random.normal(kA, (N, M)),
                jax.random.randint(kMo, (), 3, M),
                jax.random.normal(kz, (M,)),
                jax.random.randint(kidx, (M,), 0, M))

    jst, jobs = jax.vmap(lambda k: je.reset(JCFG, k))(keys)
    nkeys = jax.random.split(jax.random.PRNGKey(4), E)
    jst = jax.vmap(lambda s, k: je.draw_noise(JCFG, s, k))(jst, nkeys)
    noise = jax.vmap(lambda k: jax.random.normal(k, (N,)))(nkeys)
    tst, tobs = te.reset_lanes(TCFG, *(t(d) for d in jax.vmap(draws)(keys)))
    tst = te.draw_noise(TCFG, tst, t(noise))
    actions = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (E, 2),
                                            minval=-1, maxval=1))
    return jst, jobs, tst, tobs, actions


def test_reset_and_noise_lanes_match(lanes):
    jst, jobs, tst, tobs, _ = lanes
    np.testing.assert_array_equal(tst.x0.numpy(), np.asarray(jst.x0))
    np.testing.assert_allclose(tst.A.numpy(), np.asarray(jst.A),
                               rtol=2.5e-7)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=2.5e-7)
    np.testing.assert_allclose(tst.y.numpy(), np.asarray(jst.y), rtol=1e-6,
                               atol=1e-7)


def jax_lane_solves(jst, rho, iters):
    def one(A, y, r):
        def fun(x):
            err = y - A @ x
            return (jnp.sum(err ** 2) + r[0] * jnp.sum(x ** 2)
                    + r[1] * jnp.sum(jnp.abs(x)))
        return jl.lbfgs_solve(fun, jnp.zeros((M,), jnp.float32),
                              max_iters=iters, history_size=7)
    return jax.jit(jax.vmap(one))(jst.A, jst.y, rho)


def test_lane_step_stages_match(lanes, monkeypatch):
    jst, _, tst, _, actions = lanes
    rho_j, _ = jax.vmap(je.action_to_rho)(jnp.asarray(actions))
    short = jax_lane_solves(jst, rho_j, 5)
    tst_a, tst_y = t(jst.A), t(jst.y)
    got = te._solve_lanes(te.EnetConfig(M=M, N=N, lbfgs_iters=5), tst_a,
                          tst_y, t(rho_j))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(short.x),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(got.n_iters.numpy(),
                                  np.asarray(short.n_iters))
    # the lane step around JAX's vmapped solve and influence state (the
    # solutions and eigen-states JAX's step carries in its state and obs)
    jst2, jobs2, jrew, _ = jax.jit(jax.vmap(
        lambda s, a: je.step(JCFG, s, a, jax.random.PRNGKey(0),
                             keepnoise=True)))(jst, jnp.asarray(actions))
    jx, jE = jst2.x, jobs2[:, :N]
    monkeypatch.setattr(te, "_solve_and_influence_lanes",
                        lambda cfg, A, y, rho: (t(jx), t(jE), None))
    tst2, tobs2, trew, tdone = te.step_lanes(TCFG, tst, t(actions), None,
                                             keepnoise=True)
    assert tdone.dtype == torch.bool and not tdone.any()
    np.testing.assert_allclose(tobs2.numpy(), np.asarray(jobs2), rtol=1e-5)
    np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=1e-5)
    np.testing.assert_array_equal(tst2.x.numpy(), np.asarray(jst2.x))


def test_hint_lanes_first_iterations_match(lanes, monkeypatch):
    jst, _, tst, _, _ = lanes
    monkeypatch.setattr(te, "HINT_ITERS", 2)
    _, res = te.hint_solve_lanes(TCFG, tst)
    lams = np.asarray([(a, b) for a in je.HINT_GRID for b in je.HINT_GRID],
                      np.float32)
    first = np.arange(N) < N // 2

    def one(A, y, lam, test):
        def fun(x):
            err = (y - A @ x) * jnp.where(test, 0.0, 1.0)
            return (jnp.sum(err ** 2) + lam[1] * jnp.sum(x ** 2)
                    + lam[0] * jnp.sum(jnp.abs(x)))
        return jl.lbfgs_solve(fun, jnp.zeros((M,), jnp.float32),
                              max_iters=2, history_size=7).x

    for e in range(E):
        for g in (0, 7, 24):
            for f, test in enumerate((first, ~first)):
                want = jax.jit(one)(jst.A[e], jst.y[e], lams[g], test)
                np.testing.assert_allclose(
                    res.x[e * 50 + 2 * g + f].numpy(), np.asarray(want),
                    rtol=1e-4, atol=1e-6)


def test_parallel_sac_train_step_and_block(monkeypatch):
    # the hint's solves at 5 iterations: their depth is held elsewhere
    monkeypatch.setattr(te, "HINT_ITERS", 5)
    ecfg = te.EnetConfig(M=4, N=4, lbfgs_iters=10)
    acfg = tsac.SACConfig(obs_dim=ecfg.obs_dim, n_actions=2, batch_size=8,
                          mem_size=64, prioritized=True)
    mesh = make_mesh(devices=[torch.device("cpu")])
    init, step, reset, block = make_parallel_sac(ecfg, acfg, mesh, 4,
                                                 use_hint=True,
                                                 episode_block=(2, 2))
    gen = torch.Generator().manual_seed(0)
    st = init(gen)
    st, m = step(st, gen)
    assert st.buf.cntr == 4 and st.step_in_episode == 1
    assert np.isfinite(float(m["mean_reward"]))
    st, scores = block(st, gen)
    assert scores.shape == (2,) and torch.isfinite(scores).all()
    assert st.buf.cntr == 20 and st.agent.learn_counter > 0
    assert trainer.episode_scores([{"mean_reward": 1.0},
                                   {"mean_reward": 3.0}], 2) == [2.0]
    with pytest.raises(ValueError, match="divide"):
        learner.make_sharded_fleet_buffer(10, {}, 3)


@pytest.mark.parametrize("per_transition", [False, True])
def test_train_distributed_two_episodes(per_transition, tmp_path):
    st, scores = learner.train_distributed(
        seed=0, episodes=2, n_actors=2, env_kwargs={"M": 4, "N": 4,
                                                    "lbfgs_iters": 10},
        agent_kwargs={"batch_size": 8, "mem_size": 64},
        learn_per_transition=per_transition, quiet=True, rollout_epochs=2,
        rollout_steps=3, device="cpu", ckpt_dir=str(tmp_path / "ck"),
        ckpt_every=1)
    assert len(scores) == 2 and np.all(np.isfinite(scores))
    assert st.buf.cntr == 24 and st.episode == 2
    # one learn per stored transition from the batch size on, else one per
    # episode (the first episode's 12 transitions fill a batch of 8)
    assert st.agent.learn_counter == (24 - 8 + 1 if per_transition else 2)


def test_fold_in_and_lane_keys_match_jax():
    """``prng.fold_in`` is ``jax.random.fold_in`` (the fleets' per-(actor,
    iteration) keys), and the lane keys and the lane flattening are the
    JAX learner's."""
    from smartcal_tpu.parallel import learner as jlearner
    from smartcal_tpu_torch import prng

    for seed, data in ((0, 0), (5, 3), (0x0AC7035, 1 << 20),
                       (123, 0xFFFFFFFF)):
        want = jax.random.key_data(jax.random.fold_in(
            jax.random.PRNGKey(seed), data))
        np.testing.assert_array_equal(
            prng.fold_in(prng.PRNGKey(seed), data), np.asarray(want))
    key = prng.split(prng.PRNGKey(2))[1]
    np.testing.assert_array_equal(
        learner.lane_keys(key, 4),
        np.asarray(jax.random.key_data(jlearner.lane_keys(
            jax.random.split(jax.random.PRNGKey(2))[1], 4))))
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(
        learner.flatten_lanes({"s": t(x)}, 6)["s"].numpy(),
        np.asarray(jlearner.flatten_lanes({"s": jnp.asarray(x)}, 6)["s"]))
