"""Coordinates, shapelets and the diffuse calibration episode of the
PyTorch port against the JAX package.

Inputs are numpy draws from fixed seeds; the same arrays go through both
packages.  The coordinate and shapelet functions are float32 in both and
are held at rtol 1e-4 with atol 1e-6 * max|ref| (two libraries' float32
trig and a different summation order of the mode sums).  Host draws
(random shapelets, mode files) are bit-identical.  The diffuse episode's
V and Ccal are held at the relative 5e-4 of tests/test_torch_episode.py.
"""

import jax
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import coords as jcoords
from smartcal_tpu.cal import shapelets as jshp
from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu_torch import prng
from smartcal_tpu_torch.cal import coords as tcoords
from smartcal_tpu_torch.cal import shapelets as tshp
from smartcal_tpu_torch.cal.observation import ATEAM_DIRS
from smartcal_tpu_torch.envs.radio import RadioBackend as TorchBackend

SMALL = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
             lbfgs_iters=3, init_iters=5, npix=32)
RTOL = 1e-4


def close(got, ref, rtol=RTOL, atol_rel=1e-6):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol,
                               atol=atol_rel * max(np.abs(ref).max(), 1e-30))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _radec(seed, n=64):
    rng = np.random.default_rng(seed)
    ra = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    dec = rng.uniform(-np.pi / 2, np.pi / 2, n).astype(np.float32)
    return ra, dec


def _coord_case(name):
    ra, dec = _radec(0)
    ra0, dec0 = 1.3, -0.4
    if name == "radectolm":
        return (ra, dec, ra0, dec0), {}
    if name == "lmtoradec":
        l, m, _ = jcoords.radectolm(ra, dec, ra0, dec0)
        keep = np.asarray(l * l + m * m) < 0.5
        return (np.asarray(l)[keep], np.asarray(m)[keep], ra0, dec0), {}
    if name == "angular_separation":
        ra2, dec2 = _radec(1)
        return (ra, dec, ra2, dec2), {}
    return (ra, dec, 2.1, 0.923717), {}         # azel_from_radec


@pytest.mark.parametrize("name", ["radectolm", "lmtoradec",
                                  "angular_separation", "azel_from_radec"])
def test_coords_match_jax(name):
    args, _ = _coord_case(name)
    ref = getattr(jcoords, name)(*args)
    got = getattr(tcoords, name)(*args)
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for g, r in zip(got, ref):
        close(g, r)


def test_coords_on_host_scalars_match_jax():
    """The demixing sky's calls: python/numpy float scalars, where the JAX
    functions do their first differences in float64."""
    for ra, dec in ATEAM_DIRS:
        close(tcoords.angular_separation(1.1, 0.6, ra, dec),
              jcoords.angular_separation(1.1, 0.6, ra, dec))
        for g, r in zip(tcoords.azel_from_radec(ra, dec, 4.4, 0.923717),
                        jcoords.azel_from_radec(ra, dec, 4.4, 0.923717)):
            close(g, r)
        for g, r in zip(tcoords.radectolm(ra, dec, 1.1, 0.6),
                        jcoords.radectolm(ra, dec, 1.1, 0.6)):
            close(g, r)


@pytest.mark.parametrize("rad", [0.0, 1.234, -0.0123, -1.2, 6.2])
def test_sexagesimal_helpers_match_jax(rad):
    assert tcoords.rad_to_ra(rad) == jcoords.rad_to_ra(rad)
    assert tcoords.rad_to_dec(rad) == jcoords.rad_to_dec(rad)
    d = jcoords.rad_to_dec(rad)
    assert tcoords.dms_to_rad(*d) == jcoords.dms_to_rad(*d)
    h = jcoords.rad_to_ra(rad)
    assert tcoords.hms_to_rad(*h) == jcoords.hms_to_rad(*h)


@pytest.mark.parametrize("n_max,beta", [(1, 0.3), (2, 1.0), (19, 0.12),
                                         (14, 2.5)])
def test_basis_matches_jax(n_max, beta):
    x = np.random.default_rng(n_max).uniform(-3, 3, 257).astype(np.float32)
    close(tshp.basis_1d(n_max, x, beta), jshp.basis_1d(n_max, x, beta))


def _modes(seed):
    return jshp.random_shapelet(np.random.default_rng(seed))


def _uv(seed, R=300, scale=4.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, R).astype(np.float32),
            rng.uniform(-scale, scale, R).astype(np.float32))


@pytest.mark.parametrize("seed,l0,m0", [(0, 0.0, 0.0), (1, 0.01, -0.02),
                                        (2, 0.0, 0.0)])
def test_shapelet_image_and_uv_match_jax(seed, l0, m0):
    mdl = _modes(seed)
    lm = np.random.default_rng(seed + 10).uniform(-0.3, 0.3, (2, 200)) \
        .astype(np.float32)
    close(tshp.shapelet_image(mdl.coeff, lm[0], lm[1], mdl.beta, l0, m0),
          jshp.shapelet_image(mdl.coeff, lm[0], lm[1], mdl.beta, l0, m0))
    u, v = _uv(seed)
    ref = jshp.shapelet_uv_sr(mdl.coeff, u, v, mdl.beta, l0=l0, m0=m0)
    assert np.abs(np.asarray(ref)).max() > 1e-2       # not resolved out
    close(tshp.shapelet_uv_sr(mdl.coeff, u, v, mdl.beta, l0=l0, m0=m0), ref)


def test_shapelet_coherencies_match_jax():
    mdl = _modes(3)
    uu, vv = _uv(3, scale=8.0)      # meters: a few wavelengths
    freqs = np.asarray([115e6, 140e6, 171e6], np.float32)
    multi = tshp.shapelet_coherency_multi_sr(
        mdl.coeff, uu, vv, torch.from_numpy(freqs), mdl.beta, flux=250.0)
    ref = jshp.shapelet_coherency_multi_sr(mdl.coeff, uu, vv, freqs,
                                           mdl.beta, flux=250.0)
    assert np.abs(np.asarray(ref)).max() > 1.0
    close(multi, ref)
    for f in range(3):
        one = tshp.shapelet_coherency_sr(mdl.coeff, uu, vv, float(freqs[f]),
                                         mdl.beta, flux=250.0)
        close(one, jshp.shapelet_coherency_sr(mdl.coeff, uu, vv,
                                              float(freqs[f]), mdl.beta,
                                              flux=250.0))
        close(one, multi[f])
    assert torch.all(multi[..., 1:3, :] == 0)


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_random_shapelet_bit_identical(seed, tmp_path):
    for perturb in (True, False):
        j = jshp.random_shapelet(np.random.default_rng(seed), perturb)
        t = tshp.random_shapelet(np.random.default_rng(seed), perturb)
        for f in j._fields:
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f))
    tshp.write_modes(tmp_path / "t.modes", t.coeff, t.beta)
    jshp.write_modes(tmp_path / "j.modes", j.coeff, j.beta)
    assert (tmp_path / "t.modes").read_text() \
        == (tmp_path / "j.modes").read_text()
    coeff, beta = tshp.read_modes(tmp_path / "j.modes")
    np.testing.assert_array_equal(coeff, t.coeff)
    assert beta == t.beta
    np.testing.assert_array_equal(tshp.rescale_modes(coeff),
                                  jshp.rescale_modes(coeff))


@pytest.fixture(scope="module")
def diffuse_episodes():
    jk = jax.random.split(jax.random.PRNGKey(3))[1]
    tk = prng.split(prng.PRNGKey(3))[1]
    jb = JaxBackend(shard=False, **SMALL)
    tb = TorchBackend(device="cpu", **SMALL)
    return (jb, tb) + jb.new_calib_episode(jk, 3, 4, diffuse=True) \
        + tb.new_calib_episode(tk, 3, 4, diffuse=True)


def test_diffuse_episode_matches_jax(diffuse_episodes):
    _, _, jep, jm, tep, tm = diffuse_episodes
    for f in jm.shapelet._fields:
        np.testing.assert_array_equal(getattr(tm.shapelet, f),
                                      getattr(jm.shapelet, f))
    np.testing.assert_array_equal(tm.sky_table, jm.sky_table)
    assert tep.Ccal.shape == jep.Ccal.shape and tep.V.shape == jep.V.shape
    assert rel(tep.Ccal.numpy(), jep.Ccal) < 5e-4
    assert rel(tep.V.numpy(), jep.V) < 5e-4
    assert np.all(tep.Ccal[:, 3:].numpy() == 0)        # padded direction


def test_add_shapelet_matches_jax(diffuse_episodes):
    """On the episode's uvw scaled by 1e-3: a degree-scale component
    (beta ~ 0.1 rad) is resolved out on every baseline of the array, so
    the add is only seen at a few wavelengths."""
    jb, tb, jep, jm, tep, tm = diffuse_episodes
    jep = jep._replace(obs=jep.obs._replace(uvw=jep.obs.uvw * 1e-3))
    shp = jm.shapelet
    C = np.random.default_rng(4).standard_normal(
        tuple(tep.Ccal.shape)).astype(np.float32)
    ref = np.asarray(jb._add_shapelet(jep.obs, jax.numpy.asarray(C),
                                      shp.coeff_cal, shp.beta_cal, shp.flux))
    obs = tep.obs._replace(uvw=torch.from_numpy(np.array(jep.obs.uvw)))
    got = tb._add_shapelet(obs, torch.from_numpy(C), shp.coeff_cal,
                           shp.beta_cal, shp.flux)
    assert np.abs(ref[:, 0] - C[:, 0]).max() > 1.0
    close(got, ref)
    np.testing.assert_array_equal(got[:, 1:].numpy(), C[:, 1:])
