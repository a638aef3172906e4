"""The demixing slice of the PyTorch port against the JAX package: the
A-team targets and caller-fixed observations, the demixing sky and
episode, ``RadioBackend.hint_sweep``, ``DemixingEnv`` (reward, metadata,
hint) and ``BatchedDemixingEnv``.

Backend: the demixing trainers' ``--small`` tier (N=6, Nf=2, T=4,
tdelta=2, npix=32), K=3.  Tolerances:

* host numpy draws (targets, the target field, the background, rho's
  catalogue part) bit-identical; the float32 coordinate math (A-team
  positions, separations, azimuths, elevations, the attenuated fluxes and
  rho) rtol 1e-5 / atol 1e-7, two libraries' float32 trig;
* the episode's target-cluster coherencies and V (on shared coherencies)
  relative 5e-4 (tests/test_torch_episode.py); the A-team clusters'
  coherencies no further from a float64 prediction than the JAX
  package's (x 1.25): their float32 phases reach ~1e4 rad in both;
* ``hint_sweep`` against the JAX sweep at admm_iters=2 rtol 1e-3 (on the
  JAX episode), and against the port's own ``calibrate`` rtol 1e-4 (JAX
  tests/test_radio_envs.py::test_hint_sweep_uses_stokes_i_statistic).  At
  the full iteration counts the solve is chaotic in float32 (ROADMAP
  queue 3), so nothing is held end to end there;
* the reward and the hint computed from the JAX package's own sigmas
  rtol 1e-5;
* ``BatchedDemixingEnv`` at E=1 against ``DemixingEnv``: sigmas and
  observations bit for bit on the CPU, rewards rtol 1e-6 (float32 lanes
  against the sequential env's python floats); at E=2 stage by stage on
  the batched solve (rtol 1e-4, the batched-solve tolerance of
  tests/test_torch_batched_radio.py).
"""

import jax
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import observation as jobs
from smartcal_tpu.cal import simulate as jsim
from smartcal_tpu.envs.demixing import DemixingEnv as JaxDemixingEnv
from smartcal_tpu.envs.demixing import scalar_to_kvec as jax_kvec
from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu_torch import interop, prng
from smartcal_tpu_torch.cal import coherency as tcoh
from smartcal_tpu_torch.cal import observation as tobs
from smartcal_tpu_torch.cal import simulate as tsim
from smartcal_tpu_torch.cal import solver
from smartcal_tpu_torch.envs.demixing import (BatchedDemixingEnv,
                                              DemixingEnv, scalar_to_kvec)
from smartcal_tpu_torch.envs.radio import RadioBackend

SMALL = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=30,
             lbfgs_iters=3, init_iters=5, npix=32)
K, SEED = 3, 0
COORD = dict(rtol=1e-5, atol=1e-7)
SWEEP_ITERS = 2
F64 = torch.float64


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


def backend(**kw):
    return RadioBackend(device="cpu", **dict(SMALL, **kw))


def keys(seed):
    return (jax.random.split(jax.random.PRNGKey(seed))[1],
            prng.split(prng.PRNGKey(seed))[1])


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def pair():
    """The JAX and the port's demixing episode of one key; the JAX sweep of
    every selection at admm_iters=2, and the JAX env's hint from it."""
    jk, tk = keys(SEED)
    jb = JaxBackend(shard=False, **SMALL)
    jep, jm = jb.new_demixing_episode(jk, K)
    tep, tm = backend().new_demixing_episode(tk, K)
    jenv = JaxDemixingEnv(K=K, backend=jb, seed=SEED)
    jenv.ep, jenv.mdl = jep, jm
    jenv.elevation = jm.elevation
    jenv.rho = jm.rho.astype(np.float32)
    jenv.std_data = float(jb.noise_std(jep.V))
    jenv.maxiter = SWEEP_ITERS
    masks = np.stack([jenv._mask(np.where(jax_kvec(i, K - 1) > 0)[0])
                      for i in range(2 ** (K - 1))])
    jsig = np.asarray(jb.hint_sweep(jep, jenv.rho, masks,
                                    admm_iters=SWEEP_ITERS))
    return dict(jep=jep, jm=jm, tep=tep, tm=tm, jenv=jenv, masks=masks,
                jsig=jsig, jhint=jenv.get_hint(), tk=tk,
                jCsim=np.array(jb._coherencies(jep.obs, jm.sky_sim)))


# -- targets, observations, sky ------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_find_valid_target_matches_jax(seed):
    jk, tk = keys(seed)
    np.testing.assert_array_equal(tobs.ATEAM_DIRS, jobs.ATEAM_DIRS)
    np.testing.assert_array_equal(tobs.ATEAM_FLUX, jobs.ATEAM_FLUX)
    for strategy in (0, 1, 2):
        assert tobs.find_valid_target(tk, strategy=strategy) \
            == jobs.find_valid_target(jk, strategy=strategy)


@pytest.mark.parametrize("fixed", [dict(ra0=1.0), dict(t0=1234.5),
                                   dict(ra0=2.0, dec0=0.7),
                                   dict(ra0=2.0, dec0=0.7, t0=99.0),
                                   dict(hba=False)])
def test_make_observation_fixed_pointing_matches_jax(fixed):
    jk, tk = keys(4)
    jo = jobs.make_observation(jk, n_stations=6, n_freqs=2, n_times=4,
                               **fixed)
    to = tobs.make_observation(tk, n_stations=6, n_freqs=2, n_times=4,
                               device="cpu", **fixed)
    assert (jo.ra0, jo.dec0, jo.lst0) == (to.ra0, to.dec0, to.lst0)
    np.testing.assert_array_equal(np.asarray(jo.freqs), to.freqs.numpy())
    np.testing.assert_allclose(to.uvw.numpy(), np.asarray(jo.uvw), rtol=0,
                               atol=4 * np.spacing(np.float32(
                                   np.abs(np.asarray(jo.uvw)).max())))


def test_make_observation_refuses_a_declination_that_never_rises():
    jk, tk = keys(4)
    for mod, k, extra in ((jobs, jk, {}), (tobs, tk, {"device": "cpu"})):
        with pytest.raises(ValueError, match="never rises"):
            mod.make_observation(k, n_stations=6, n_freqs=2, n_times=4,
                                 dec0=-1.2, **extra)


def _sky_fields(sky):
    return {f: np.asarray(getattr(sky, f)) for f in
            ("lmn", "flux_coef", "f0", "gauss", "is_gauss", "cluster")}


@pytest.mark.parametrize("seed", [0, 5])
def test_demixing_sky_matches_jax(seed):
    jk, tk = keys(seed)
    ra0, dec0, t0 = jobs.find_valid_target(jk, strategy=1)
    jm = jsim.simulate_demixing_sky(jk, ra0, dec0, t0, 150e6, K=4)
    tm = tsim.simulate_demixing_sky(tk, ra0, dec0, t0, 150e6, K=4)
    for f in ("separations", "azimuth", "elevation", "fluxes", "rho",
              "lm_dirs"):
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f), **COORD)
    # the target's separation and the target cluster's draws are host numpy
    assert tm.separations[-1] == jm.separations[-1] == 0.0
    np.testing.assert_array_equal(tm.rho[-1], jm.rho[-1])
    np.testing.assert_array_equal(tm.fluxes[-1], jm.fluxes[-1])
    for sky in ("sky_sim", "sky_cal"):
        js = _sky_fields(getattr(jm, sky))
        ts = _sky_fields(getattr(tm, sky))
        for f in ("gauss", "is_gauss", "cluster", "f0"):
            np.testing.assert_array_equal(ts[f], js[f])
        for f in ("lmn", "flux_coef"):
            np.testing.assert_allclose(ts[f], js[f], **COORD)
        host = js["cluster"] >= 3               # target + background
        np.testing.assert_array_equal(ts["lmn"][host], js["lmn"][host])
    a_j = jsim.ateam_components(jk, ra0, dec0, 150e6)
    a_t = tsim.ateam_components(tk, ra0, dec0, 150e6)
    for f in ("l", "m", "flux", "sp"):
        np.testing.assert_allclose(np.concatenate(getattr(a_t, f)),
                                   np.concatenate(getattr(a_j, f)), **COORD)


def _f64_coherencies(sky, obs, monkeypatch):
    """The prediction of ``sky`` on ``obs`` in float64 (the port's
    ``_predict`` with its float type raised)."""
    monkeypatch.setattr(tcoh, "F32", torch.float64)
    s64 = interop.sky_from_numpy(sky)
    uvw = torch.as_tensor(np.array(obs.uvw).reshape(-1, 3), dtype=F64)
    out = torch.stack([tcoh._predict(
        uvw * (2 * np.pi * float(f) / tcoh.C_LIGHT), s64,
        torch.tensor(float(f), dtype=F64)) for f in np.asarray(obs.freqs)])
    monkeypatch.undo()
    return out.numpy()


def test_demixing_episode_matches_jax(pair, monkeypatch):
    """Host values equal; the target cluster's coherencies within the
    episode tolerance.  The A-team clusters sit 30-80 degrees off the
    phase centre, where float32 DFT phases reach ~1e4 rad: there both
    packages' coherencies are ~1e-3 off a float64 prediction (ROADMAP
    queue 3, "Observed"), so the port's are held to be no further from it
    than the JAX package's; V is held on the JAX coherencies (the
    corruption and the noise)."""
    jep, tep, jm, tm = pair["jep"], pair["tep"], pair["jm"], pair["tm"]
    assert (tep.obs.ra0, tep.obs.dec0, tep.obs.lst0) == \
        (jep.obs.ra0, jep.obs.dec0, jep.obs.lst0)
    assert tep.f0 == jep.f0 and tep.snr == jep.snr
    assert tep.n_dirs == jep.n_dirs == K
    np.testing.assert_array_equal(tep.obs.freqs.numpy(),
                                  np.asarray(jep.obs.freqs))
    assert tep.Ccal.shape == jep.Ccal.shape and tep.V.shape == jep.V.shape
    jC, tC = np.asarray(jep.Ccal), tep.Ccal.numpy()
    assert rel(tC[:, K - 1], jC[:, K - 1]) < 5e-4
    truth = _f64_coherencies(jm.sky_cal, jep.obs, monkeypatch)
    err_jax = rel(jC[:, :K - 1], truth[:, :K - 1])
    err_port = rel(tC[:, :K - 1], truth[:, :K - 1])
    assert err_port <= 1.25 * err_jax, (err_port, err_jax)
    obs = interop.episode_from_numpy(jep).obs
    V = backend()._corrupt_and_noise(
        pair["tk"], obs, torch.from_numpy(pair["jCsim"]), J_extra_dirs=1,
        snr=tep.snr, amp=0.01, spatial_term=False, lm_dirs=tm.lm_dirs)
    assert rel(V.numpy(), jep.V) < 5e-4
    for f in ("separations", "azimuth", "elevation", "rho"):
        np.testing.assert_allclose(getattr(tm, f), getattr(jm, f), **COORD)


# -- the hint sweep --------------------------------------------------------


def test_hint_sweep_matches_jax(pair):
    """The port's sweep on the JAX episode, every selection, at a small
    admm_iters where the solve is not chaotic; batch 1, the default 8 and
    a ragged 3 give the same sigmas."""
    tb = backend()
    ep = interop.episode_from_numpy(pair["jep"])
    rho = pair["jenv"].rho
    sig = {b: tb.hint_sweep(ep, rho, pair["masks"], admm_iters=SWEEP_ITERS,
                            batch=b).numpy() for b in (None, 1, 3)}
    np.testing.assert_allclose(sig[None], pair["jsig"], rtol=1e-3)
    for b in (1, 3):
        np.testing.assert_allclose(sig[b], sig[None], rtol=1e-4)
    assert tb.stage_seconds["hint"] > 0


def test_hint_sweep_uses_stokes_i_statistic(pair):
    tb = backend()
    ep = pair["tep"]
    rho = pair["tm"].rho
    for mask in pair["masks"][[0, -1]]:
        swept = tb.hint_sweep(ep, rho, mask[None], admm_iters=SWEEP_ITERS)
        res = tb.calibrate(ep, rho, mask=mask, admm_iters=SWEEP_ITERS)
        np.testing.assert_allclose(swept.numpy()[0],
                                   float(tb.noise_std(res.residual)),
                                   rtol=1e-4)


def _port_env_on_jax_episode(pair, **kw):
    env = DemixingEnv(K=K, backend=backend(), seed=SEED, device="cpu", **kw)
    env.ep = interop.episode_from_numpy(pair["jep"])
    env.mdl = interop.demix_models_from_numpy(pair["jm"])
    env.elevation = env.mdl.elevation
    env.rho = env.mdl.rho.astype(np.float32)
    env.std_data = pair["jenv"].std_data
    env.maxiter = SWEEP_ITERS
    return env


def test_reward_and_hint_on_jax_sigmas(pair):
    env, jenv = _port_env_on_jax_episode(pair), pair["jenv"]
    masks, valid = env.hint_masks()
    np.testing.assert_array_equal(masks, pair["masks"])
    assert valid.all()
    np.testing.assert_allclose(env.hint_from_sigmas(masks, valid,
                                                    pair["jsig"]),
                               pair["jhint"], rtol=1e-5, atol=1e-7)
    for ksel in (1, 2, 3):
        for maxiter in (5, 17, 30):
            env.std_residual = jenv.std_residual = float(pair["jsig"][ksel])
            env.maxiter = jenv.maxiter = maxiter
            np.testing.assert_allclose(env.calculate_reward_(ksel),
                                       jenv.calculate_reward_(ksel),
                                       rtol=1e-5)


def test_low_elevation_selections_run_as_target_only_lanes(pair,
                                                           monkeypatch):
    """An outlier below 1 degree: its selections keep AIC 1e5 and run as
    target-only lanes of the fixed-size sweep; the hint avoids it."""
    env, jenv = _port_env_on_jax_episode(pair), pair["jenv"]
    low = pair["jm"].elevation.copy()
    low[1] = 0.5
    env.elevation, jenv.elevation = low, low
    env.maxiter = jenv.maxiter = SWEEP_ITERS
    seen = {}
    sig = np.asarray([0.9, 0.8, 0.7, 0.6], np.float32) * env.std_data

    def fake_sweep(name):
        def sweep(ep, rho, masks, admm_iters=None, batch=None):
            seen[name] = np.asarray(masks)
            return torch.as_tensor(sig) if name == "port" else sig
        return sweep

    monkeypatch.setattr(env.backend, "hint_sweep", fake_sweep("port"))
    monkeypatch.setattr(jenv.backend, "hint_sweep", fake_sweep("jax"))
    hint, jhint = env.get_hint(), jenv.get_hint()
    np.testing.assert_array_equal(seen["port"], seen["jax"])
    assert seen["port"].shape == (4, K)
    for idx in (1, 3):         # the selections of outlier 1: dummy lanes
        np.testing.assert_array_equal(seen["port"][idx], [0, 0, 1])
    np.testing.assert_allclose(hint, jhint, rtol=1e-5, atol=1e-7)
    assert hint[1] < -0.45


@pytest.mark.parametrize("n", [0, 1, 5, 13, 31])
def test_scalar_to_kvec_matches_jax(n):
    np.testing.assert_array_equal(scalar_to_kvec(n, 5), jax_kvec(n, 5))


# -- the port's env ----------------------------------------------------------


@pytest.fixture(scope="module")
def env_run():
    env = DemixingEnv(K=K, provide_hint=True, provide_influence=True,
                      backend=backend(), seed=SEED, device="cpu")
    obs0 = env.reset()
    a = np.zeros(K, np.float32)
    a[0] = 0.9                  # select outlier 0
    a[-1] = -1.0                # maxiter -> 5
    out = env.step(a)
    return env, obs0, out


def test_env_reset_and_step(env_run, pair):
    env, obs0, (obs, r, done, hint, info) = env_run
    md0 = obs0["metadata"] / 1e-3
    assert obs0["infmap"].shape == (32, 32) and md0.shape == (3 * K + 2,)
    np.testing.assert_allclose(md0[:K], pair["jm"].separations, **COORD)
    np.testing.assert_allclose(md0[2 * K:3 * K], pair["jm"].elevation,
                               **COORD)
    assert md0[-1] == 6 and md0[K - 1] == 0.0
    np.testing.assert_allclose(md0[-2], np.log(
        np.asarray(pair["jep"].obs.freqs)[0] / 1e6), rtol=1e-6)
    assert env.maxiter == 5 and not done
    md = obs["metadata"] / 1e-3
    assert md[0] == 0.0 and md[K - 1] == 0.0 and md[1] == md0[1]
    assert np.isfinite(r) and np.isfinite(obs["infmap"]).all()
    assert hint.shape == (K,) and np.isfinite(hint).all()
    assert np.all(np.abs(hint) <= 1.0)
    np.testing.assert_allclose(hint[-1], (5 - 17.5) * (2 / 25))
    assert info["sigma_res"] == env.std_residual < env.std_data


@pytest.mark.parametrize("a", [-1.0, -0.52, -0.04, 0.0, 0.04, 0.36, 0.999,
                               1.0])
def test_maxiter_truncates_the_float32_map(a):
    env = DemixingEnv(K=K, backend=backend(), device="cpu")
    benv = BatchedDemixingEnv(K=K, n_envs=1, backend=env.backend,
                              device="cpu")
    act = np.asarray([0.0, 0.0, a], np.float32)
    _, maxiter = env._selection(act)
    want = int(np.float32(a) * np.float32(12.5) + np.float32(17.5))
    assert maxiter == want
    benv.maxiter = (act[None, K - 1] * 25 / 2 + 35 / 2).astype(np.int32)
    assert benv.maxiter[0] == maxiter


def test_prefetch_gives_the_same_episodes():
    obs = {}
    for pf in (False, True):
        env = DemixingEnv(K=K, backend=backend(), seed=2, device="cpu",
                          prefetch=pf)
        obs[pf] = [env.reset(), env.reset()]
        env.close()
    for a, b in zip(obs[False], obs[True]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


def test_envs_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cls in (DemixingEnv, BatchedDemixingEnv):
        with pytest.raises(RuntimeError, match="no GPU"):
            cls(K=K)
        with pytest.raises(ValueError, match="backend on"):
            cls(K=K, backend=backend(), device="meta")
    with pytest.raises(ValueError, match="hint"):
        BatchedDemixingEnv(K=K, provide_hint=True, backend=backend(),
                           device="cpu")


# -- batched -----------------------------------------------------------------


def _actions(E):
    a = np.linspace(-0.9, 0.9, E * K).reshape(E, K).astype(np.float32)
    a[:, -1] = np.linspace(-1.0, -0.6, E)       # maxiter 5..10
    return a


def test_batched_one_lane_is_the_sequential_env():
    env = DemixingEnv(K=K, backend=backend(), seed=SEED, device="cpu")
    benv = BatchedDemixingEnv(K=K, n_envs=1, backend=backend(), seed=SEED,
                              device="cpu")
    o, bo = env.reset(), benv.reset()
    for k in o:
        np.testing.assert_array_equal(bo[k][0], o[k])
    assert benv.std_data[0] == np.float32(env.std_data)
    assert benv.std_residual[0] == np.float32(env.std_residual)
    np.testing.assert_allclose(benv.reward0[0], env.reward0, rtol=1e-6)
    a = _actions(1)
    o2, r, _, info = env.step(a[0])
    bo2, br, bd, binfo = benv.step(a)
    for k in o2:
        np.testing.assert_array_equal(bo2[k][0], o2[k])
    assert binfo["sigma_res"][0] == np.float32(info["sigma_res"])
    np.testing.assert_allclose(br[0], r, rtol=1e-6, atol=1e-7)
    assert not bd.any()


@pytest.fixture(scope="module")
def two_lanes():
    out = {}
    for fused in (True, False):
        env = BatchedDemixingEnv(K=K, n_envs=2, provide_influence=True,
                                 backend=backend(), seed=SEED, fused=fused,
                                 device="cpu")
        o = env.reset()
        out[fused] = (env, o, env.step(_actions(2)))
    return out


def test_batched_two_lanes_stage_by_stage(two_lanes):
    env, o, (o2, r, _, info) = two_lanes[True]
    oenv, oo, (oo2, orw, _, oinfo) = two_lanes[False]
    np.testing.assert_array_equal(o["metadata"], oo["metadata"])
    np.testing.assert_array_equal(o2["metadata"], oo2["metadata"])
    np.testing.assert_array_equal(env.maxiter, [5, 10])
    b = env.backend
    masks = env._masks([np.where(s > 0.5)[0].tolist() for s in
                        _actions(2)[:, :K - 1] * 0.5 + 0.5])
    res = b.calibrate_batched(env.bep, env.rho, mask=masks,
                              admm_iters=env.maxiter)
    lanes = []
    for e in range(2):
        one = b.calibrate(env.eps[e], env.rho[e], mask=masks[e],
                          admm_iters=int(env.maxiter[e]))
        np.testing.assert_allclose(res.J[e], one.J, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(res.residual[e], one.residual, rtol=1e-4,
                                   atol=1e-6)
        lanes.append(one)
    sig = b.noise_std_batched(res.residual).numpy()
    np.testing.assert_allclose(info["sigma_res"], sig, rtol=0)
    np.testing.assert_allclose(sig, oinfo["sigma_res"], rtol=1e-4)
    # the influence and the reward on the oracle's own solves
    stacked = solver.SolveResult(*(torch.stack([getattr(r_, f) for r_ in
                                                lanes])
                                   for f in solver.SolveResult._fields))
    rho_eff = env.rho * masks + (1 - masks)
    imgs = b.influence_images_batched(env.bep, stacked, rho_eff,
                                      np.zeros_like(rho_eff)).numpy()
    np.testing.assert_allclose(imgs * 1e-3, oo2["infmap"], rtol=2e-3,
                               atol=2e-5 * np.abs(oo2["infmap"]).max())
    env.std_residual = oinfo["sigma_res"]
    np.testing.assert_allclose(env.calculate_rewards(masks.sum(1))
                               - env.reward0, orw, rtol=1e-5, atol=1e-6)


def test_batched_masked_reset_and_state_round_trip():
    env = BatchedDemixingEnv(K=K, n_envs=2, backend=backend(), seed=SEED,
                             device="cpu")
    env.reset()
    obs, *_ = env.step(_actions(2))
    prev = {k: v.copy() for k, v in obs.items()}
    obs2 = env.reset_lanes(np.array([False, True]))
    for k in prev:
        np.testing.assert_array_equal(obs2[k][0], prev[k][0])
    np.testing.assert_array_equal(env.lane_episode, [1, 2])
    np.testing.assert_array_equal(env.lane_step, [1, 0])
    seq = DemixingEnv(K=K, backend=backend(), seed=SEED + 1, device="cpu")
    seq.reset()
    o = seq.reset()                         # the lane's second episode
    np.testing.assert_array_equal(obs2["metadata"][1], o["metadata"])
    np.testing.assert_array_equal(env.bep.V[1], seq.ep.V)
    state = env.state_dict()
    env2 = BatchedDemixingEnv(K=K, n_envs=2, backend=backend(), seed=99,
                              device="cpu")
    env2.load_state_dict(state)
    env.reset()
    env2.reset()
    np.testing.assert_array_equal(env.bep.V, env2.bep.V)
    with pytest.raises(ValueError, match="lanes"):
        BatchedDemixingEnv(K=K, n_envs=3, backend=backend(),
                           device="cpu").load_state_dict(state)
