"""Influence-map engine: residual sensitivity to data perturbations
(counterpart of smartcal_tpu/cal/influence.py), optimized chain only.

Per calibration interval (chunk of Tdelta timeslots):
  H  = Hessianres(R, C, J) + Hadd(consensus)   (scatter-free core)
  column means of dR through the adjoint 4-RHS transpose solve
  influence per baseline, replicated over the interval, scaled 8*B*Td.
The consensus Hessian addition is a scalar per direction
(:func:`consensus_hadd_all`).  The SKA tier's statics select the blocked
Hessian (``block_baselines`` > 0: the CUDA kernel of
``ops/hessian_blocks.py`` on the card, the blocked plain core on the CPU)
and the factored imager's large tier (``imager_block_r`` > 0).  The oracle
chain, the per-direction variant and the sharded tiers are still to be
ported.
"""

from typing import NamedTuple

import torch

from smartcal_tpu_torch.cal import consensus, creal, imager, kernels
from smartcal_tpu_torch.cal import precision as prec
from smartcal_tpu_torch.ops import hessian_blocks


def consensus_hadd_all(rho_spectral, rho_spatial, freqs, f0, n_poly=2,
                       polytype=1):
    """(Nf, K) consensus scalars h with Hadd_k = h_k I_4N for every band:
      alpha > 0:  h = H11 - H12^2 / H22 (Schur complement) with
        H11 = rho/2 fs^2 + alpha rho^2 pp / 2, H12 = fs^2/2 + alpha rho pp/2,
        H22 = -(1 - fs^2)/(2 rho) + alpha pp / 2
      alpha == 0: h = rho/2 fs^2 (1 + fs^2 / (1 - fs^2))."""
    freqs = torch.as_tensor(freqs, dtype=prec.F32)
    dev = freqs.device
    r = torch.as_tensor(rho_spectral, dtype=prec.F32, device=dev)   # (K,)
    a = torch.as_tensor(rho_spatial, dtype=prec.F32, device=dev)
    bfull, bi, fscale = consensus.consensus_cores(freqs, f0, n_poly,
                                                  polytype, rho=r, alpha=a)
    fs2 = (fscale ** 2).T                                  # (Nf, K)
    # P = kron(Bi b_f, I); P'P = ||Bi b_f||^2 I
    pp = torch.sum(torch.einsum("kij,fj->fki", bi, bfull) ** 2, dim=-1)
    r, a = r[None, :], a[None, :]
    h11 = 0.5 * r * fs2 + 0.5 * a * r * r * pp
    h12 = 0.5 * fs2 + 0.5 * a * r * pp
    h22 = -0.5 / r * (1.0 - fs2) + 0.5 * a * pp
    h_spatial = h11 - h12 * h12 / torch.where(h22 == 0,
                                              torch.ones_like(h22), h22)
    denom = torch.where(torch.abs(1.0 - fs2) < 1e-12,
                        torch.ones_like(fs2), 1.0 - fs2)
    h_plain = 0.5 * r * fs2 * (1.0 + fs2 / denom)
    return torch.where(a > 0.0, h_spatial, h_plain)


class InfluenceResult(NamedTuple):
    vis: torch.Tensor   # (T*B, 4, 2) influence visibilities [XX, XY, YX, YY]
    llr: torch.Tensor   # (Ts, K) per-chunk log-likelihood ratios


def _chunk_influence_opt(R3, C5, Jp, Jq, lhs, hadd, n_stations,
                         block_baselines=0):
    """One calibration interval on hoisted operands: R3 (Td, B, 2, 2, 2);
    C5 (K, Td, B, 2, 2, 2); Jp/Jq (K, B, 2, 2, 2); lhs (K, B, 2, 2, 2);
    hadd (K,).  Returns ((B, 4, 2) Stokes-I-only vis, (K,) llr).

    ``block_baselines`` > 0 selects the blocked Hessian: the CUDA kernel
    for tensors on the card, the blocked plain core for CPU tensors."""
    Td = C5.shape[1]
    if not block_baselines:
        H = kernels._hessian_res_core_sr(R3, C5, Jp, Jq, n_stations)
    elif C5.device.type == "cpu":
        H = kernels._hessian_res_core_blocked_sr(R3, C5, Jp, Jq, n_stations,
                                                 block_baselines)
    else:
        H = hessian_blocks.hessian_res_core_sr(R3, C5, Jp, Jq, n_stations)
    N4 = H.shape[1]
    diag = torch.arange(N4, device=H.device)
    H[:, diag, diag, 0] += hadd[:, None]
    pol_means = kernels._colmeans_adjoint_core_sr(lhs, H, n_stations, Td)
    vis = torch.sum(pol_means, dim=0).transpose(0, 1).clone()  # (B, 4, 2)
    vis[:, 1:3, :] = 0.0                # fullpol=False: XY, YX dropped
    return vis, kernels._llr_core_sr(R3, C5, Jp, Jq)


def influence_visibilities(R, C, J, hadd, n_stations, n_chunks,
                           block_baselines=0):
    """Influence visibilities over all calibration intervals.

    R : (2*B*T, 2, 2) kernel-convention residuals of one sub-band
    C : (K, T*B, 4, 2) coherencies;  J : (Ts, K, 2N, 2, 2);  hadd : (K,)
    ``block_baselines`` > 0 runs the blocked Hessian (SKA tier).
    Returns vis (T*B, 4, 2) scaled by 8*B*Tdelta, and llr (Ts, K)."""
    B = n_stations * (n_stations - 1) // 2
    K = C.shape[0]
    T = C.shape[1] // B
    Td = T // n_chunks
    R3 = R.reshape(n_chunks, Td, B, 2, 2, 2)
    C5 = C.reshape(K, n_chunks, Td, B, 2, 2, 2).transpose(-3, -2) \
        .movedim(1, 0).contiguous()                      # (Ts, K, Td, B, ..)
    p_idx, q_idx = kernels.baseline_indices(n_stations, R.device)
    J4 = J.reshape(n_chunks, K, n_stations, 2, 2, 2)
    Jp, Jq = J4[:, :, p_idx], J4[:, :, q_idx]            # (Ts, K, B, ...)
    Csum = torch.sum(C5, dim=2)                          # (Ts, K, B, ...)
    lhs = creal.einsum("skbuv,skbwv->skbuw", Jq, creal.conj(Csum))
    outs = [_chunk_influence_opt(R3[s], C5[s], Jp[s], Jq[s], lhs[s], hadd,
                                 n_stations, block_baselines)
            for s in range(n_chunks)]
    vis_b = torch.stack([o[0] for o in outs])            # (Ts, B, 4, 2)
    llr = torch.stack([o[1] for o in outs])
    vis = vis_b[:, None].expand(n_chunks, Td, B, 4, 2).reshape(T * B, 4, 2)
    return InfluenceResult(vis=vis * (8.0 * B * Td), llr=llr)


def stokes_i_influence(vis):
    """(..., 4, 2) influence visibilities -> (..., 2) Stokes I."""
    return 0.5 * (vis[..., 0, :] + vis[..., 3, :])


def influence_image_single_sr(residual_f, C_f, J_f, hadd_f, freq, uvw,
                              cell, n_stations, n_chunks, npix,
                              block_baselines=0, imager_block_r=0):
    """One sub-band's Stokes-I influence dirty image: the optimized
    influence chain, then the rank-factored imager.  residual_f
    (T, B, 2, 2, 2), C_f (K, T*B, 4, 2), J_f (Ts, K, 2N, 2, 2), hadd_f
    (K,), uvw (T*B, 3) meters.  The SKA-tier statics select the blocked
    Hessian (``block_baselines``) and the large-tier factored imager
    (``imager_block_r``)."""
    from smartcal_tpu_torch.cal import solver

    Rk = solver.residual_to_kernel(residual_f)
    inf = influence_visibilities(Rk, C_f, J_f, hadd_f, n_stations, n_chunks,
                                 block_baselines=block_baselines)
    ivis = stokes_i_influence(inf.vis)
    if imager_block_r:
        return imager.dirty_image_factored_large_sr(
            uvw, ivis, freq, cell, npix=npix, block_r=imager_block_r)
    return imager.dirty_image_factored_sr(uvw, ivis, freq, cell, npix=npix)
