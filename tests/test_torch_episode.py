"""Episode construction of the PyTorch port vs the JAX package.

Every draw is a host numpy Generator seeded from the key words plus a
salt, so the draws must be BIT-identical.  The geometry is float32 in both
packages: the uvw tracks come out identical here, and every array is
checked at least within f32 round-off.  The coherencies are sums of
exp(i phase) with |phase| up to ~1e4 rad in f32, where one ulp of the phase
is ~1e-3 rad and XLA may fuse a multiply-add the port does not, so they
and the visibilities built from them are held at a relative 5e-4.
"""

import jax
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import coherency as jcoh
from smartcal_tpu.cal import observation as jobs
from smartcal_tpu.cal import simulate as jsim
from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu_torch import prng
from smartcal_tpu_torch.cal import coherency as tcoh
from smartcal_tpu_torch.cal import observation as tobs
from smartcal_tpu_torch.cal import simulate as tsim
from smartcal_tpu_torch.envs.radio import RadioBackend as TorchBackend

TINY = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=32)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _keys(seed):
    return jax.random.split(jax.random.PRNGKey(seed))[1], \
        prng.split(prng.PRNGKey(seed))[1]


@pytest.mark.parametrize("seed", [0, 1, 7, 12345, 2 ** 31 + 3])
def test_threefry_split_matches_jax(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk), tk)
    for num in (2, 3):
        got = jax.random.split(jk, num)  # graftlint: disable=rng-key-reuse -- the same key split twice on purpose: the test compares split(key, num) for several num
        np.testing.assert_array_equal(np.asarray(got), prng.split(tk, num))
    # a chain of splits, the CalibEnv key walk
    for _ in range(3):
        jk, _ = jax.random.split(jk)  # graftlint: disable=rng-key-reuse -- re-split walk of the test key, compared word by word
        tk, _ = prng.split(tk)
    np.testing.assert_array_equal(np.asarray(jk), tk)


@pytest.mark.parametrize("salt", [0, 1, 5, 10, 21])
def test_host_rng_bit_identical(salt):
    jk, tk = _keys(3)
    a = jobs.host_rng(jk, salt).standard_normal(64)
    b = tobs.host_rng(tk, salt).standard_normal(64)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 4])
def test_make_observation_matches(seed):
    jk, tk = _keys(seed)
    jo = jobs.make_observation(jk, n_stations=8, n_freqs=3, n_times=6)
    to = tobs.make_observation(tk, n_stations=8, n_freqs=3, n_times=6,
                               device="cpu")
    assert (jo.ra0, jo.dec0, jo.lst0) == (to.ra0, to.dec0, to.lst0)
    np.testing.assert_array_equal(np.asarray(jo.freqs), to.freqs.numpy())
    np.testing.assert_array_equal(np.asarray(jo.times), to.times.numpy())
    np.testing.assert_array_equal(
        np.asarray(jobs.station_layout(jk, 8)),
        tobs.station_layout(tk, 8).numpy())
    # f32 trig of two libraries: within a few ulp of the largest baseline
    np.testing.assert_allclose(to.uvw.numpy(), np.asarray(jo.uvw), rtol=0,
                               atol=4 * np.spacing(np.float32(
                                   np.abs(np.asarray(jo.uvw)).max())))


def test_sky_models_and_solutions_bit_identical():
    jk, tk = _keys(2)
    jm = jsim.simulate_models(jk, K=4, f0=150e6)
    tm = tsim.simulate_models(tk, K=4, f0=150e6)
    for name in ("sky_table", "rho", "rho_spatial", "lm_dirs"):
        np.testing.assert_array_equal(getattr(jm, name), getattr(tm, name))
    for sky in ("sky_sim", "sky_cal"):
        js, ts = getattr(jm, sky), getattr(tm, sky)
        for f in ("lmn", "flux_coef", "f0", "gauss", "is_gauss", "cluster"):
            np.testing.assert_array_equal(np.asarray(getattr(js, f)),
                                          getattr(ts, f).numpy())
    freqs = np.asarray([120e6, 150e6, 170e6], np.float32)
    a = jsim.synth_solutions(jk, 4, 6, 2, freqs, 150e6, spatial_term=True,
                             lm_dirs=jm.lm_dirs)
    b = tsim.synth_solutions(tk, 4, 6, 2, freqs, 150e6, spatial_term=True,
                             lm_dirs=tm.lm_dirs)
    np.testing.assert_array_equal(a, b)


def test_coherencies_match():
    jk, tk = _keys(5)
    jo = jobs.make_observation(jk, n_stations=6, n_freqs=2, n_times=4)
    jm = jsim.simulate_models(jk, K=3, f0=float(np.asarray(jo.freqs).mean()))
    tm = tsim.simulate_models(tk, K=3, f0=float(np.asarray(jo.freqs).mean()))
    uvw = np.array(jo.uvw).reshape(-1, 3)
    ref = np.asarray(jcoh.predict_coherencies_multi_sr(
        uvw[:, 0], uvw[:, 1], uvw[:, 2], jm.sky_sim, jo.freqs))
    tu = torch.from_numpy(uvw)
    out = tcoh.predict_coherencies_multi_sr(
        tu[:, 0], tu[:, 1], tu[:, 2], tm.sky_sim,
        torch.from_numpy(np.array(jo.freqs)))
    assert out.shape == ref.shape
    assert rel(out.numpy(), ref) < 5e-4


def test_new_calib_episode_matches():
    jk, tk = _keys(0)
    jep, jm = JaxBackend(shard=False, **TINY).new_calib_episode(jk, 3, 4)
    tep, tm = TorchBackend(device="cpu", **TINY).new_calib_episode(tk, 3, 4)
    np.testing.assert_array_equal(jm.sky_table, tm.sky_table)
    assert jep.f0 == tep.f0 and jep.n_dirs == tep.n_dirs == 4
    np.testing.assert_array_equal(np.asarray(jep.obs.uvw),
                                  tep.obs.uvw.numpy())
    assert tep.Ccal.shape == jep.Ccal.shape
    assert tep.V.shape == jep.V.shape
    assert np.all(tep.Ccal[:, 3:].numpy() == 0)        # padded direction
    assert rel(tep.Ccal.numpy(), jep.Ccal) < 5e-4
    assert rel(tep.V.numpy(), jep.V) < 5e-4
    tnoise = float(TorchBackend(device="cpu", **TINY).noise_std(tep.V))
    jnoise = float(JaxBackend(shard=False, **TINY).noise_std(jep.V))
    np.testing.assert_allclose(tnoise, jnoise, rtol=5e-4)
