"""The fuzzy controller and FuzzyDemixingEnv of the PyTorch port against
the JAX package.

Memberships are held at atol 1e-6, the crisp priorities at atol 1e-3 on
the 0-100 scale (float32 centroids of two libraries), the action <->
limits maps at rtol 1e-6.  A selection (priority >= cutoff) can flip on
round-off, so selections are compared only where the priority clears the
cutoff by more than the priority tolerance.  The env's priorities are held
against the JAX env's own ``step`` on the same episode values, with its
calibration stubbed (nothing of the solve is compared here).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.envs.demixing_fuzzy import \
    FuzzyDemixingEnv as JaxFuzzyEnv
from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu.models import fuzzy as jfz
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.envs.demixing_fuzzy import FuzzyDemixingEnv
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.models import fuzzy as tfz

SMALL = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
             lbfgs_iters=3, init_iters=5, npix=32)
K = 3
PRIORITY_ATOL = 1e-3


def controller():
    return tfz.DemixController(device="cpu")


def _abcd(seed, n):
    rng = np.random.default_rng(seed)
    abcd = np.sort(rng.uniform(-10, 10, (n, 4)), axis=1).astype(np.float32)
    abcd[: n // 4, 1] = abcd[: n // 4, 0]          # degenerate rising edge
    abcd[n // 4: n // 2, 3] = abcd[n // 4: n // 2, 2]
    return abcd


def test_trapmf_matches_jax():
    abcd = _abcd(0, 64)
    x = np.random.default_rng(1).uniform(-12, 12, (64, 50)).astype(
        np.float32)
    for xs in (x, abcd[:, :1], abcd[:, 1:2], abcd[:, 3:]):   # edges too
        got = tfz.trapmf(torch.from_numpy(xs), torch.from_numpy(abcd)[:, None])
        ref = jfz.trapmf(jnp.asarray(xs), jnp.asarray(abcd)[:, None])
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)


def test_default_config_matches_jax():
    assert tfz.default_config() == jfz.default_config()
    assert tfz.VAR_ORDER == jfz.VAR_ORDER
    assert tfz.ACTION_ORDER == jfz.ACTION_ORDER


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_update_limits_and_action_match_jax(seed):
    a = np.random.default_rng(seed).uniform(0.02, 0.98, tfz.N_ACTION)
    t, j = controller(), jfz.DemixController()
    t.update_limits(a)
    j.update_limits(a)
    np.testing.assert_allclose(t.membership_arrays()[0],
                               np.asarray(j.membership_stack()[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(t.update_action(), j.update_action(),
                               rtol=1e-6)
    np.testing.assert_allclose(t.update_action(), a, rtol=1e-6)  # inverse
    assert t.get_high_priority() == j.get_high_priority()


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(-180, 180, n), rng.uniform(-180, 180, n),
                     rng.uniform(-90, 90, n), rng.uniform(-90, 90, n),
                     rng.uniform(0, 180, n), rng.uniform(0, 12, n),
                     rng.uniform(0, 100, n)], -1).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1])
def test_priorities_match_jax(seed):
    """Random limits per direction, evaluated one by one in JAX and as one
    batch here; the default limits through ``evaluate``."""
    rng = np.random.default_rng(seed + 10)
    x = _inputs(seed, 24)
    mfs, pmfs, ref = [], [], []
    for i in range(len(x)):
        j = jfz.DemixController()
        j.update_limits(rng.uniform(0.02, 0.98, tfz.N_ACTION))
        mf, pmf = j.membership_stack()
        mfs.append(np.asarray(mf))
        pmfs.append(np.asarray(pmf))
        ref.append(float(jfz.mamdani_priority(mf, pmf, jnp.asarray(x[i]))))
    got = controller().evaluate_batch(np.stack(mfs), np.stack(pmfs), x)
    np.testing.assert_allclose(got, ref, atol=PRIORITY_ATOL)
    t, j = controller(), jfz.DemixController()
    for row in x[:6]:
        np.testing.assert_allclose(t.evaluate(*row), j.evaluate(*row),
                                   atol=PRIORITY_ATOL)


def test_all_zero_aggregate_falls_back_to_50():
    mf = np.zeros((1, 7, 3, 4), np.float32)
    mf[..., :] = [1.0, 2.0, 3.0, 4.0]              # nothing fires at 0
    pmf = np.tile(np.asarray([[0, 0, 40, 50], [40, 50, 70, 75],
                              [70, 75, 100, 100]], np.float32), (1, 1, 1))
    got = controller().evaluate_batch(mf, pmf, np.zeros((1, 7)))
    ref = jfz.mamdani_priority(jnp.asarray(mf[0]), jnp.asarray(pmf[0]),
                               jnp.zeros(7))
    assert got[0] == float(ref) == 50.0


@pytest.fixture(scope="module")
def env_pair():
    """The port's env after a reset, and the JAX env holding the same
    episode values with its calibration stubbed."""
    env = FuzzyDemixingEnv(K=K, provide_hint=True,
                           backend=RadioBackend(device="cpu", **SMALL),
                           seed=0, device="cpu")
    obs0 = env.reset()
    jenv = JaxFuzzyEnv(K=K, backend=JaxBackend(shard=False, **SMALL),
                       seed=0)
    jenv.mdl = env.mdl
    jenv.ep = env.ep._replace(obs=env.ep.obs._replace(
        freqs=env.ep.obs.freqs.numpy()))
    jenv.log_fluxes = np.log(np.maximum(env.mdl.fluxes, 1e-12))
    jenv.target_flux = float(max(env.mdl.fluxes[-1], 1e-12))
    jenv.std_data, jenv.reward0 = env.std_data, env.reward0
    masks = []

    def stub_calibrate(mask):
        masks.append(mask)
        return types.SimpleNamespace(residual=None)

    jenv._calibrate = stub_calibrate
    jenv._influence_map = lambda res, mask: np.zeros((32, 32), np.float32)
    jenv.backend.noise_std = lambda r: env.std_data * 0.5
    return env, obs0, jenv, masks


def _actions(n_actions):
    rng = np.random.default_rng(7)
    return [rng.uniform(-1, 1, n_actions).astype(np.float32)
            for _ in range(4)]


def test_env_priorities_match_jax(env_pair):
    env, _, jenv, masks = env_pair
    assert env.n_actions == jenv.n_actions == 24 * (K - 1) + 8
    np.testing.assert_array_equal(env.get_hint(), jenv.get_hint())
    for a in _actions(env.n_actions) + [env.get_hint()]:
        jinfo = jenv.step(a)[-1]
        pri, cut = env.priorities(a)
        np.testing.assert_allclose(pri, jinfo["priority"],
                                   atol=PRIORITY_ATOL)
        clear = np.abs(pri - cut) > PRIORITY_ATOL
        np.testing.assert_array_equal((pri >= cut)[clear],
                                      np.isin(np.arange(K - 1),
                                              jinfo["selected"])[clear])


def test_env_reset_and_step(env_pair):
    env, obs0, jenv, _ = env_pair
    md = obs0["metadata"] / 1e-3
    assert md.shape == (5 * K + 2,) and obs0["infmap"].shape == (32, 32)
    np.testing.assert_array_equal(md[4 * K:5 * K], [0, 0, 1])
    np.testing.assert_allclose(md[3 * K:4 * K],
                               np.log(np.maximum(env.mdl.fluxes, 1e-12)),
                               rtol=1e-6)
    assert env.maxiter == 15
    obs, r, done, hint, info = env.step(env.get_hint())
    assert env.maxiter == 15 and np.isfinite(r) and not done
    np.testing.assert_array_equal(hint, env.get_hint())
    flags = (obs["metadata"] / 1e-3)[4 * K:5 * K]
    assert flags[-1] == 1 and sorted(info["selected"]) == \
        sorted(np.where(flags[:-1] > 0)[0].tolist())
    # the fuzzy reward adds the maxiter penalty back
    env.std_residual = jenv.std_residual = 0.5 * env.std_data
    env.maxiter = jenv.maxiter = 15
    np.testing.assert_allclose(env.calculate_reward_(2),
                               jenv.calculate_reward_(2), rtol=1e-6)


def test_controller_config_carries_over():
    j = jfz.DemixController()
    j.update_limits(np.full(tfz.N_ACTION, 0.3))
    t = controller()
    t.config = interop.fuzzy_config_from_jax(j)
    np.testing.assert_allclose(t.update_action(), j.update_action(),
                               rtol=1e-6)
    with pytest.raises(ValueError, match="action"):
        t.update_limits(np.zeros(5))
