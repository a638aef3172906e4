"""``RadioBackend(vectorized=False)``, the host-loop route of the PyTorch
port, against the port's vectorized build and against the JAX package's
host loop; and the host-side pieces it needs (bandwidth smearing, the
host-numpy noise, the DP3 parsets).

Bounds: the two builds of the port give the same Ccal bits and V within
1e-5 relative (tests/test_calib_pipeline.py's bound for the JAX package's
two builds: the noise scale's norms reduce in another order).  Against
the JAX package the episode tolerances of tests/test_torch_episode.py
hold on that file's key (5e-4 relative: f32 DFT phases of up to ~1e4
rad), and on other keys the port's coherencies are held no further from
float64 than JAX's.  The host-loop influence image is held to JAX's on
one solve at the 1e-4 of tests/test_torch_influence.py, and to the
port's optimized route at tests/test_calib_pipeline.py's 5e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import coherency as jcoh
from smartcal_tpu.cal import observation as jobs
from smartcal_tpu.cal import simulate as jsim
from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu_torch import interop, prng
from smartcal_tpu_torch.cal import coherency as tcoh
from smartcal_tpu_torch.cal import simulate as tsim
from smartcal_tpu_torch.envs.calib import CalibEnv
from smartcal_tpu_torch.envs.radio import RadioBackend as TorchBackend

TINY = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=32)
KINDS = ["calib", "diffuse", "demix"]


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def build(backend, kind, key):
    if kind == "demix":
        return backend.new_demixing_episode(key, 3)[0]
    return backend.new_calib_episode(key, 2, 3, diffuse=kind == "diffuse")[0]


@pytest.fixture(scope="module")
def loop():
    return TorchBackend(device="cpu", vectorized=False, **TINY)


@pytest.mark.parametrize("kind", KINDS)
def test_episode_matches_vectorized_build(loop, kind):
    vec = build(TorchBackend(device="cpu", **TINY), kind, prng.PRNGKey(11))
    host = build(loop, kind, prng.PRNGKey(11))
    assert torch.equal(host.Ccal, vec.Ccal)
    assert rel(host.V, vec.V) < 1e-5
    assert host.snr == vec.snr and host.f0 == vec.f0


def _corruption(kind, ep, mdl):
    """The corruption arguments of the kind's episode build."""
    if kind == "demix":
        return dict(snr=ep.snr, amp=0.01, spatial_term=False,
                    lm_dirs=mdl.lm_dirs)
    return dict(snr=0.05, amp=1.0, spatial_term=True, lm_dirs=mdl.lm_dirs)


@pytest.mark.parametrize("kind", KINDS)
def test_episode_matches_jax_host_loop(loop, kind):
    """tests/test_torch_episode.py's key and bound; V is held on the JAX
    build's own sim coherencies (the corruption, then the host noise),
    as tests/test_torch_demixing.py holds it."""
    jk = jax.random.split(jax.random.PRNGKey(0))[1]
    tk = prng.split(prng.PRNGKey(0))[1]
    jb = JaxBackend(shard=False, vectorized=False, **TINY)
    if kind == "demix":
        jep, jm = jb.new_demixing_episode(jk, 3)
        tep, _ = loop.new_demixing_episode(tk, 3)
    else:
        jep, jm = jb.new_calib_episode(jk, 2, 3, diffuse=kind == "diffuse")
        tep, _ = loop.new_calib_episode(tk, 2, 3, diffuse=kind == "diffuse")
    assert tep.Ccal.shape == jep.Ccal.shape and tep.V.shape == jep.V.shape
    assert rel(tep.Ccal, jep.Ccal) < 5e-4
    jCsim = jb._coherencies(jep.obs, jm.sky_sim)
    if getattr(jm, "shapelet", None) is not None:
        jCsim = jb._add_shapelet(jep.obs, jCsim, jm.shapelet.coeff,
                                 jm.shapelet.beta, jm.shapelet.flux)
    V = loop._corrupt_and_noise(
        tk, interop.episode_from_numpy(jep).obs,
        torch.from_numpy(np.array(jCsim)), J_extra_dirs=1,
        **_corruption(kind, jep, jm))
    assert rel(V.numpy(), jep.V) < 5e-4


@pytest.mark.parametrize("seed", [0, 13])
def test_host_loop_coherencies_no_further_from_f64_than_jax(
        loop, seed, monkeypatch):
    """On these keys the calibration sky's f32 coherencies of the two
    packages part by 6e-4-9e-4, over the episode bound, in either route:
    both are ~1e-3 off a float64 prediction (the f32 DFT phases).  The
    port's host loop is held no further from float64 than JAX's."""
    jep, jm = JaxBackend(shard=False, vectorized=False, **TINY) \
        .new_calib_episode(jax.random.PRNGKey(seed), 2, 3)
    tep, _ = loop.new_calib_episode(prng.PRNGKey(seed), 2, 3)
    monkeypatch.setattr(tcoh, "F32", torch.float64)
    sky = interop.sky_from_numpy(jm.sky_cal)
    uvw = torch.as_tensor(np.array(jep.obs.uvw).reshape(-1, 3),
                          dtype=torch.float64)
    truth = torch.stack([tcoh._predict(
        uvw * (2 * np.pi * float(f) / tcoh.C_LIGHT), sky,
        torch.tensor(float(f), dtype=torch.float64))
        for f in np.asarray(jep.obs.freqs)]).numpy()
    monkeypatch.undo()
    K = truth.shape[1]
    err_jax = rel(np.asarray(jep.Ccal)[:, :K], truth)
    err_port = rel(tep.Ccal.numpy()[:, :K], truth)
    assert err_port <= 1.25 * err_jax, (err_port, err_jax)


def test_influence_image_matches_jax_and_the_optimized_route(loop):
    """One solve (the port's, on the JAX episode) handed to both packages'
    host loops."""
    jb = JaxBackend(shard=False, vectorized=False, **TINY)
    ep, mdl = jb.new_calib_episode(jax.random.PRNGKey(7), 3, 4)
    rho = np.ones(4, np.float32)
    rho[:3] = mdl.rho
    alpha = np.zeros(4, np.float32)
    alpha[:3] = mdl.rho_spatial
    tep = interop.episode_from_numpy(ep)
    tres = loop.calibrate(tep, rho, mask=np.asarray([1, 1, 1, 0], np.float32))
    jres = jsolver.SolveResult(*(jnp.asarray(x.numpy()) for x in tres))
    ref = np.asarray(jb.influence_image(ep, jres, rho, alpha))
    before = loop.stage_seconds["influence"]
    img = loop.influence_image(tep, tres, rho, alpha)
    assert loop.stage_seconds["influence"] > before
    assert img.shape == (32, 32) and torch.isfinite(img).all()
    assert rel(img.numpy(), ref) < 1e-4
    opt = TorchBackend(device="cpu", **TINY).influence_image(tep, tres, rho,
                                                             alpha)
    assert rel(opt.numpy(), img.numpy()) < 5e-3
    assert torch.equal(loop.influence_image(tep, tres, rho, alpha), img)


def test_calib_env_reset_and_step_on_the_host_loop(loop):
    env = CalibEnv(M=4, backend=loop, seed=3, device="cpu")
    vec_env = CalibEnv(M=4, backend=TorchBackend(device="cpu", **TINY),
                       seed=3, device="cpu")
    obs0, vec0 = env.reset(), vec_env.reset()
    action = np.linspace(-0.5, 0.5, 2 * env.M).astype(np.float32)
    obs1, reward, done, info = env.step(action)
    vobs1 = vec_env.step(action)[0]
    for o in (obs0, obs1):
        assert o["img"].shape == (32, 32) and np.all(np.isfinite(o["img"]))
    assert np.isfinite(reward) and not done
    assert np.isfinite(info["sigma_res"]) and np.isfinite(info["sigma_data"])
    assert rel(obs0["img"], vec0["img"]) < 5e-3
    assert rel(obs1["img"], vobs1["img"]) < 5e-3


# -- host-side pieces -------------------------------------------------------

@pytest.fixture(scope="module")
def sky():
    """An observation and its sky, made by each package from key 5."""
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    jo = jobs.make_observation(jk, n_stations=6, n_freqs=2, n_times=4)
    f0 = float(np.asarray(jo.freqs).mean())
    return (np.array(jo.uvw).reshape(-1, 3), np.asarray(jo.freqs),
            jsim.simulate_models(jk, K=3, f0=f0).sky_sim,
            tsim.simulate_models(tk, K=3, f0=f0).sky_sim)


@pytest.mark.parametrize("smear", [False, True])
def test_coherencies_smear_match_jax(sky, smear):
    """Both wrappers with and without bandwidth smearing against JAX; the
    single-band form on a band of ``obs.freqs`` is the multi-band form's
    bits; the complex wrapper is the split one fused."""
    uvw, freqs, jsky, tsky = sky
    tu = torch.from_numpy(uvw)
    kw = dict(smear=smear, fdelta=195e3)
    multi = tcoh.predict_coherencies_multi_sr(tu[:, 0], tu[:, 1], tu[:, 2],
                                              tsky, freqs, **kw)
    ref = np.asarray(jcoh.predict_coherencies_multi_sr(
        uvw[:, 0], uvw[:, 1], uvw[:, 2], jsky, freqs, **kw))
    assert rel(multi.numpy(), ref) < 5e-4
    for f, fr in enumerate(freqs):
        one = tcoh.predict_coherencies_sr(tu[:, 0], tu[:, 1], tu[:, 2], tsky,
                                          fr, **kw)
        assert torch.equal(one, multi[f])
        c = tcoh.predict_coherencies(tu[:, 0], tu[:, 1], tu[:, 2], tsky, fr,
                                     **kw)
        assert c.dtype == np.complex64
        assert rel(c, jcoh.predict_coherencies(uvw[:, 0], uvw[:, 1],
                                               uvw[:, 2], jsky, fr,
                                               **kw)) < 5e-4
    if smear:
        plain = tcoh.predict_coherencies_multi_sr(tu[:, 0], tu[:, 1],
                                                  tu[:, 2], tsky, freqs)
        assert rel(multi.numpy(), plain.numpy()) > 1e-3   # smearing acts


def test_add_noise_bit_equal_to_jax_and_the_device_form():
    V = np.random.default_rng(2).standard_normal((2, 4, 15, 2, 2, 2)) \
        .astype(np.float32)
    got, scale = tsim.add_noise(prng.PRNGKey(9), V, snr=0.05)
    want, jscale = jsim.add_noise(jax.random.PRNGKey(9), V, snr=0.05)
    np.testing.assert_array_equal(got, want)
    assert scale == jscale
    dev, _ = tsim.add_noise_device(prng.PRNGKey(9), torch.from_numpy(V), 0.05)
    assert rel(dev.numpy(), got) < 1e-7


def test_dp3_parsets_byte_equal(tmp_path):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    mine = tsim.write_dp3_parsets(str(tmp_path / "port"), tdelta=5)
    theirs = jsim.write_dp3_parsets(str(tmp_path / "jax"), tdelta=5)
    assert len(mine) == len(theirs) == 3
    for a, b in zip(mine, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


@pytest.mark.parametrize("shard", ["auto", True, False, None, "mesh"])
def test_shard_values(shard):
    """Every JAX shard mode is accepted (one GPU: the single-device route);
    anything else raises."""
    if shard == "mesh":
        with pytest.raises(ValueError):
            TorchBackend(device="cpu", shard=shard, **TINY)
    else:
        assert TorchBackend(device="cpu", shard=shard, **TINY).shard is shard
