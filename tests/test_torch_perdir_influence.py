"""The per-direction influence of the PyTorch port against the JAX
package, on one solved demixing episode (N=6, K=3) carried across by
``smartcal_tpu_torch.interop``: the perdir arm of the adjoint column
means, ``influence_visibilities(perdir=True)``, ``perdir_summary`` and
``consensus_hadd_scalars``.

Tolerances (tests/test_torch_influence.py's): the consensus scalars rtol
1e-5 (plus 1e-6 of the largest, for a direction whose alpha = 0 scalar
is ~1e-12: f32 round-off of a near-cancellation); the column means and
the influence visibilities, which reassociate f32 sums and solve the
(2*4N)-square transpose system, 1e-4 relative norm; the summary's norms
rtol 1e-5 and its influence means and LLRs 1e-4 relative.  The perdir means summed over the directions are the
plain means to f32 round-off (1e-5 relative norm).
"""

import jax
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import influence as jinf
from smartcal_tpu.cal import kernels as jkern
from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu.envs.radio import RadioBackend
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.cal import creal
from smartcal_tpu_torch.cal import influence as tinf
from smartcal_tpu_torch.cal import kernels as tkern
from smartcal_tpu_torch.cal import solver as tsolver

N_ST, NCH, K = 6, 2, 3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def solved():
    be = RadioBackend(n_stations=N_ST, n_freqs=2, n_times=4, tdelta=2,
                      admm_iters=2, lbfgs_iters=3, init_iters=5, npix=16,
                      shard=False)
    ep, mdl = be.new_demixing_episode(jax.random.PRNGKey(5), K)
    res = be.calibrate(ep, mdl.rho, mask=np.ones(K, np.float32))
    hadd = jinf.consensus_hadd_scalars(
        mdl.rho, np.full(K, 0.001, np.float32), np.asarray(ep.obs.freqs),
        ep.f0, 0, n_poly=2, polytype=0)
    return ep, mdl, res, hadd


@pytest.mark.parametrize("fidx", [0, 1])
def test_consensus_hadd_scalars_match(solved, fidx):
    ep, mdl, _, _ = solved
    freqs = np.asarray(ep.obs.freqs)
    alpha = np.asarray([0.0, 0.5, 0.001], np.float32)
    ref = jinf.consensus_hadd_scalars(mdl.rho, alpha, freqs, ep.f0, fidx,
                                      n_poly=2, polytype=0)
    out = tinf.consensus_hadd_scalars(mdl.rho, alpha, freqs, ep.f0, fidx,
                                      n_poly=2, polytype=0)
    ref = np.asarray(ref)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5,
                               atol=1e-6 * np.abs(ref).max())


def _operands(solved):
    """Chunk-0 hoisted operands of band 0, built by the port's own chain
    from the JAX solve (both packages take these same numbers)."""
    ep, _, res, hadd = solved
    tep = interop.episode_from_numpy(ep)
    tres = interop.solve_result_from_numpy(res)
    B = N_ST * (N_ST - 1) // 2
    C = tep.Ccal[0]
    Td = C.shape[1] // B // NCH
    C5 = C.reshape(K, NCH, Td, B, 2, 2, 2).transpose(-3, -2)[:, 0]
    p_idx, q_idx = tkern.baseline_indices(N_ST)
    J4 = tres.J[0][0].reshape(K, N_ST, 2, 2, 2)
    Jq = J4[:, q_idx]
    lhs = creal.einsum("kbuv,kbwv->kbuw", Jq,
                       creal.conj(torch.sum(C5, dim=1)))
    R3 = tres.residual[0].reshape(NCH, Td, B, 2, 2, 2)[0]
    H = tkern._hessian_res_core_sr(R3, C5, J4[:, p_idx], Jq, N_ST)
    diag = torch.arange(H.shape[-2])
    H[:, diag, diag, 0] += torch.as_tensor(np.asarray(hadd))[:, None]
    return lhs, H, Td, p_idx


def test_perdir_colmeans_match(solved):
    lhs, H, Td, p_idx = _operands(solved)
    ref = jkern._colmeans_adjoint_core_sr(
        lhs.numpy(), H.numpy(), p_idx.numpy(), N_ST, Td, addself=False,
        perdir=True)
    out = tkern._colmeans_adjoint_core_sr(lhs, H, N_ST, Td, perdir=True)
    assert tuple(out.shape) == ref.shape == (8, K, 4, lhs.shape[1], 2)
    assert rel(out.numpy(), ref) < 1e-4
    plain = tkern._colmeans_adjoint_core_sr(lhs, H, N_ST, Td)
    assert rel(out.sum(dim=1).numpy(), plain.numpy()) < 1e-5


def test_perdir_influence_visibilities_and_summary_match(solved):
    ep, _, res, hadd = solved
    Rk = jsolver.residual_to_kernel(res.residual[0])
    ref = jinf.influence_visibilities(Rk, ep.Ccal[0], res.J[0], hadd, N_ST,
                                      NCH, perdir=True)
    ref_sum = jinf.perdir_summary(ref.vis, ref.llr, ep.Ccal[0], res.J[0])
    tep = interop.episode_from_numpy(ep)
    tres = interop.solve_result_from_numpy(res)
    out = tinf.influence_visibilities(
        tsolver.residual_to_kernel(tres.residual[0]), tep.Ccal[0],
        tres.J[0], torch.as_tensor(np.asarray(hadd)), N_ST, NCH,
        perdir=True)
    assert tuple(out.vis.shape) == ref.vis.shape
    assert out.vis.shape[0] == K
    assert rel(out.vis.numpy(), ref.vis) < 1e-4
    assert rel(out.llr.numpy(), ref.llr) < 1e-4
    # the directions sum to the plain (summed) influence
    plain = tinf.influence_visibilities(
        tsolver.residual_to_kernel(tres.residual[0]), tep.Ccal[0],
        tres.J[0], torch.as_tensor(np.asarray(hadd)), N_ST, NCH)
    assert rel(out.vis.sum(dim=0).numpy(), plain.vis.numpy()) < 1e-5

    summary = tinf.perdir_summary(out.vis, out.llr, tep.Ccal[0], tres.J[0])
    for f in ("j_norm", "c_norm"):
        np.testing.assert_allclose(getattr(summary, f).numpy(),
                                   np.asarray(getattr(ref_sum, f)),
                                   rtol=1e-5)
    for f in ("inf_mean", "llr_mean"):
        assert rel(getattr(summary, f).numpy(),
                   getattr(ref_sum, f)) < 1e-4


def test_perdir_blocked_lanes_match_unblocked(solved):
    """The blocked (SKA-tier) route keeps the directions apart too."""
    ep, _, res, hadd = solved
    tep = interop.episode_from_numpy(ep)
    tres = interop.solve_result_from_numpy(res)
    args = (tsolver.residual_to_kernel(tres.residual[0]), tep.Ccal[0],
            tres.J[0], torch.as_tensor(np.asarray(hadd)), N_ST, NCH)
    a = tinf.influence_visibilities(*args, perdir=True)
    b = tinf.influence_visibilities(*args, block_baselines=4, perdir=True)
    assert b.vis.shape == a.vis.shape
    assert rel(b.vis.numpy(), a.vis.numpy()) < 1e-4
    assert rel(b.llr.numpy(), a.llr.numpy()) < 1e-5
