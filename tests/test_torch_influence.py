"""Influence chain of the PyTorch port vs the JAX package, on one solved
tiny episode carried across by ``smartcal_tpu_torch.interop``.

Tolerances: the consensus scalars are a handful of f32 operations
(rtol 1e-5); the Hessian, the 4-RHS transpose solve and the column means
reassociate f32 sums and solve a (2*4N)-square system whose condition
number reaches ~1e2 here, so the influence visibilities, the LLR and the
images are held at 1e-4 relative-norm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import imager as jimager
from smartcal_tpu.cal import influence as jinf
from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu.envs.radio import RadioBackend
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.cal import influence as tinf
from smartcal_tpu_torch.cal import solver as tsolver

N_ST, NCH = 6, 2


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def solved():
    be = RadioBackend(n_stations=N_ST, n_freqs=2, n_times=4, tdelta=2,
                      admm_iters=2, lbfgs_iters=3, init_iters=5, npix=32,
                      shard=False)
    ep, mdl = be.new_calib_episode(jax.random.PRNGKey(5), 3, 4)
    rho = np.ones(4, np.float32)
    rho[:3] = mdl.rho
    alpha = np.zeros(4, np.float32)
    alpha[:3] = mdl.rho_spatial
    res = be.calibrate(ep, rho, mask=np.asarray([1, 1, 1, 0], np.float32))
    return be, ep, res, rho, alpha


def test_consensus_scalars_match(solved):
    _, ep, _, rho, alpha = solved
    ref = np.asarray(jinf.consensus_hadd_all(rho, alpha, ep.obs.freqs, ep.f0,
                                             n_poly=2, polytype=0))
    out = tinf.consensus_hadd_all(rho, alpha,
                                  torch.from_numpy(np.array(ep.obs.freqs)),
                                  ep.f0, n_poly=2, polytype=0)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)


def test_influence_visibilities_match(solved):
    _, ep, res, rho, alpha = solved
    hadd = jinf.consensus_hadd_all(rho, alpha, ep.obs.freqs, ep.f0,
                                   n_poly=2, polytype=0)
    Rk = jsolver.residual_to_kernel(res.residual[0])
    ref = jinf.influence_visibilities(Rk, ep.Ccal[0], res.J[0], hadd[0],
                                      N_ST, NCH)
    tep = interop.episode_from_numpy(ep)
    tres = interop.solve_result_from_numpy(res)
    out = tinf.influence_visibilities(
        tsolver.residual_to_kernel(tres.residual[0]), tep.Ccal[0], tres.J[0],
        torch.from_numpy(np.array(hadd[0])), N_ST, NCH)
    assert out.vis.shape == ref.vis.shape
    assert rel(out.vis.numpy(), ref.vis) < 1e-4
    assert rel(out.llr.numpy(), ref.llr) < 1e-4


def test_influence_image_single_band_matches(solved):
    be, ep, res, rho, alpha = solved
    hadd = jinf.consensus_hadd_all(rho, alpha, ep.obs.freqs, ep.f0,
                                   n_poly=2, polytype=0)
    uvw = np.array(ep.obs.uvw).reshape(-1, 3)
    freqs = np.asarray(ep.obs.freqs)
    cell = jimager.default_cell(ep.obs.uvw, float(freqs[-1]))
    tep = interop.episode_from_numpy(ep)
    tres = interop.solve_result_from_numpy(res)
    for fi in range(2):
        ref = np.asarray(jinf.influence_image_single_sr(
            res.residual[fi], ep.Ccal[fi], res.J[fi], hadd[fi],
            jnp.float32(freqs[fi]), jnp.asarray(uvw), cell,
            n_stations=N_ST, n_chunks=NCH, npix=32))
        out = tinf.influence_image_single_sr(
            tres.residual[fi], tep.Ccal[fi], tres.J[fi],
            torch.from_numpy(np.array(hadd[fi])), float(freqs[fi]),
            torch.from_numpy(uvw), cell, n_stations=N_ST, n_chunks=NCH,
            npix=32)
        assert out.shape == (32, 32)
        assert rel(out.numpy(), ref) < 1e-4


def test_backend_influence_image_matches(solved):
    be, ep, res, rho, alpha = solved
    from smartcal_tpu_torch.envs.radio import RadioBackend as TorchBackend

    tbe = TorchBackend(n_stations=N_ST, n_freqs=2, n_times=4, tdelta=2,
                       admm_iters=2, lbfgs_iters=3, init_iters=5, npix=32,
                       device="cpu")
    ref = np.asarray(be.influence_image(ep, res, rho, alpha))
    out = tbe.influence_image(interop.episode_from_numpy(ep),
                              interop.solve_result_from_numpy(res), rho,
                              alpha)
    assert rel(out.numpy(), ref) < 1e-4


# -- SKA-tier statics: blocked Hessian and the large-tier factored imager --
# (B=15 at N=6: block_baselines=4 leaves a ragged block; R=T*B=60 with
# imager_block_r=256 is one padded R block).  The second band of the
# PRNGKey(5) episode sits at the 1e-4 round-off floor in the blocked and
# the unblocked form alike (its transpose solve amplifies f32 round-off;
# ROADMAP queue 3), so the per-band cases take band 0, as the cases above
# do, and the backend case (a mean over both bands) takes a well-conditioned
# episode of its own.

SKA_STATICS = {"block_baselines": 4, "imager_block_r": 256}
TINY = dict(n_stations=N_ST, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=32)


@pytest.fixture(scope="module")
def solved_wellcond():
    be = RadioBackend(shard=False, **TINY)
    ep, mdl = be.new_calib_episode(jax.random.PRNGKey(7), 3, 4)
    rho = np.ones(4, np.float32)
    rho[:3] = mdl.rho
    alpha = np.zeros(4, np.float32)
    alpha[:3] = mdl.rho_spatial
    res = be.calibrate(ep, rho, mask=np.asarray([1, 1, 1, 0], np.float32))
    return ep, res, rho, alpha


def test_influence_visibilities_blocked_match(solved):
    _, ep, res, rho, alpha = solved
    hadd = jinf.consensus_hadd_all(rho, alpha, ep.obs.freqs, ep.f0,
                                   n_poly=2, polytype=0)
    Rk = jsolver.residual_to_kernel(res.residual[0])
    ref = jinf.influence_visibilities(Rk, ep.Ccal[0], res.J[0], hadd[0],
                                      N_ST, NCH, block_baselines=4)
    tep = interop.episode_from_numpy(ep)
    tres = interop.solve_result_from_numpy(res)
    out = tinf.influence_visibilities(
        tsolver.residual_to_kernel(tres.residual[0]), tep.Ccal[0], tres.J[0],
        torch.from_numpy(np.array(hadd[0])), N_ST, NCH, block_baselines=4)
    assert rel(out.vis.numpy(), ref.vis) < 1e-4
    assert rel(out.llr.numpy(), ref.llr) < 1e-4


def test_influence_image_single_band_blocked_matches(solved):
    _, ep, res, rho, alpha = solved
    hadd = jinf.consensus_hadd_all(rho, alpha, ep.obs.freqs, ep.f0,
                                   n_poly=2, polytype=0)
    uvw = np.array(ep.obs.uvw).reshape(-1, 3)
    freqs = np.asarray(ep.obs.freqs)
    cell = jimager.default_cell(ep.obs.uvw, float(freqs[-1]))
    tep = interop.episode_from_numpy(ep)
    tres = interop.solve_result_from_numpy(res)
    ref = np.asarray(jinf.influence_image_single_sr(
        res.residual[0], ep.Ccal[0], res.J[0], hadd[0],
        jnp.float32(freqs[0]), jnp.asarray(uvw), cell, n_stations=N_ST,
        n_chunks=NCH, npix=32, **SKA_STATICS))
    out = tinf.influence_image_single_sr(
        tres.residual[0], tep.Ccal[0], tres.J[0],
        torch.from_numpy(np.array(hadd[0])), float(freqs[0]),
        torch.from_numpy(uvw), cell, n_stations=N_ST, n_chunks=NCH, npix=32,
        **SKA_STATICS)
    assert out.shape == (32, 32)
    assert rel(out.numpy(), ref) < 1e-4


def test_backend_influence_image_blocked_matches(solved_wellcond):
    ep, res, rho, alpha = solved_wellcond
    from smartcal_tpu_torch.envs.radio import RadioBackend as TorchBackend

    jbe = RadioBackend(shard=False, **TINY, **SKA_STATICS)
    tbe = TorchBackend(device="cpu", **TINY, **SKA_STATICS)
    assert tbe._influence_statics(32) == dict(SKA_STATICS, precision="f32")
    ref = np.asarray(jbe.influence_image(ep, res, rho, alpha))
    out = tbe.influence_image(interop.episode_from_numpy(ep),
                              interop.solve_result_from_numpy(res), rho,
                              alpha)
    assert rel(out.numpy(), ref) < 1e-4


@pytest.mark.parametrize("n_stations,npix",
                         [(62, 128), (128, 512), (256, 1024)])
@pytest.mark.parametrize("override", [None, 0])
def test_influence_statics_match_jax(n_stations, npix, override):
    """The thresholds pick the JAX block sizes (None: automatic; 0: the
    unblocked path forced), and the statics carry the backend's precision
    policy (the default, f32), as the JAX backend's do."""
    from smartcal_tpu_torch.envs.radio import RadioBackend as TorchBackend

    kw = dict(n_stations=n_stations, npix=npix, block_baselines=override,
              imager_block_r=override)
    ref = RadioBackend(shard=False, **kw)._influence_statics(npix)
    out = TorchBackend(device="cpu", **kw)._influence_statics(npix)
    assert ref["precision"] == "f32"
    assert out == ref
    if override is None and n_stations == 256:
        assert out == {"block_baselines": 2048, "imager_block_r": 4096,
                       "precision": "f32"}
