"""Influence-map engine: residual sensitivity to data perturbations
(counterpart of smartcal_tpu/cal/influence.py).

Per calibration interval (chunk of Tdelta timeslots):
  H  = Hessianres(R, C, J) + Hadd(consensus)
  column means of dR = d(residual)/d(data)
  influence per baseline, replicated over the interval, scaled 8*B*Td.
The consensus Hessian addition is a scalar per direction
(:func:`consensus_hadd_all`, :func:`consensus_hadd_scalars`).  ``perdir``
keeps the K directions' influence apart (the featurization of the
demixing recommender, with :func:`perdir_summary`).

Two formulations, as in the JAX package (``optimized``):

* the optimized chain (default): the scatter-free Hessian core, the
  column means through the adjoint 4-RHS transpose solve, the chunk
  invariants hoisted, and the rank-factored imager.  The SKA tier's
  statics select the blocked Hessian (``block_baselines`` > 0: the CUDA
  kernel of ``ops/hessian_blocks.py`` on the card, the blocked plain core
  on the CPU) and the factored imager's large tier (``imager_block_r`` >
  0).  ``precision="bf16"`` (``cal/precision``) narrows the column means'
  final contraction and the imager's matmuls, with f32 accumulation; the
  Hessian, the solve and the LLR stay f32;
* the oracle chain (``optimized=False``, :func:`_chunk_influence`): the
  reference formulation of ``cal/kernels.py`` (scatter-based Hessian, the
  8B-column solve of dJ, its column means) interval by interval, f32 and
  unblocked, imaged by the direct DFT (kernel 1 on the card).  It is the
  plain reference the optimized chain is held to, and the
  ``RadioBackend(vectorized=False)`` host-loop route.

The sharded tiers are not ported: on one card they map to the
single-device route.
"""

from typing import NamedTuple

import numpy as np
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


def consensus_hadd_scalars(rho_spectral, rho_spatial, freqs, f0, fidx,
                           n_poly=2, polytype=1):
    """(K,) consensus scalars of sub-band ``fidx``: row ``fidx`` of
    :func:`consensus_hadd_all`."""
    return consensus_hadd_all(rho_spectral, rho_spatial, freqs, f0,
                              n_poly=n_poly, polytype=polytype)[fidx]


class InfluenceResult(NamedTuple):
    vis: torch.Tensor   # (T*B, 4, 2) [XX, XY, YX, YY], (K, T*B, 4, 2) perdir
    llr: torch.Tensor   # (Ts, K) per-chunk log-likelihood ratios


def _chunk_influence_opt(R3, C5, Jp, Jq, lhs, hadd, n_stations,
                         block_baselines=0, perdir=False, precision="f32"):
    """One calibration interval on hoisted operands: R3 (Td, B, 2, 2, 2);
    C5 (K, Td, B, 2, 2, 2); Jp/Jq (K, B, 2, 2, 2); lhs (K, B, 2, 2, 2);
    hadd (K,).  Returns ((B, 4, 2) Stokes-I-only vis, or (K, B, 4, 2)
    with ``perdir``, and (K,) llr).

    Unblocked, every operand may carry the same leading lane axes (the
    intervals of a band, the bands and episodes of a batch): one pass of
    the plain chain for all of them.  ``block_baselines`` > 0 selects the
    blocked Hessian on ONE interval: the CUDA kernel for tensors on the
    card, the blocked plain core for CPU tensors.  ``precision``
    (``cal/precision``) narrows the column means' final contraction (row
    ``colmeans_contract``); the Hessian, the solve and the LLR stay f32."""
    Td = C5.shape[-5]
    if not block_baselines:
        H = kernels._hessian_res_core_sr(R3, C5, Jp, Jq, n_stations)
    elif C5.device.type == "cpu":
        H = kernels._hessian_res_core_blocked_sr(R3, C5, Jp, Jq, n_stations,
                                                 block_baselines)
    else:
        H = hessian_blocks.hessian_res_core_sr(R3, C5, Jp, Jq, n_stations)
    N4 = H.shape[-2]
    diag = torch.arange(N4, device=H.device)
    H[..., diag, diag, 0] += hadd[..., None]
    pol_means = kernels._colmeans_adjoint_core_sr(
        lhs, H, n_stations, Td, perdir=perdir,
        contract_dtype=prec.contraction_dtype("colmeans_contract", precision))
    vis = torch.sum(pol_means, dim=-5 if perdir else -4) \
        .transpose(-3, -2).clone()      # ([K,] B, 4, 2)
    vis[..., 1:3, :] = 0.0              # fullpol=False: XY, YX dropped
    return vis, kernels._llr_core_sr(R3, C5, Jp, Jq)


def _chunk_influence(R, C, J, hadd, n_stations, perdir=False):
    """One calibration interval, the oracle formulation: R (2*B*Td, 2, 2);
    C (K, B*Td, 4, 2); J (K, 2N, 2, 2); hadd (K,).  Returns ((B, 4, 2)
    Stokes-I-only vis, or (K, B, 4, 2) with ``perdir``, and (K,) llr):
    the scatter-based Hessian, the 8B-column solve of dJ and its column
    means (``cal/kernels.py``), each rebuilding its split-real operands."""
    H = kernels.hessian_res_sr(R, C, J, n_stations)
    diag = torch.arange(H.shape[1], device=H.device)
    H[:, diag, diag, 0] += hadd[:, None]
    dJ = kernels.dsolutions_all_sr(C, J, n_stations, H)
    pol_means = kernels.dresiduals_colmeans_sr(C, J, n_stations, dJ,
                                               addself=False, perdir=perdir)
    vis = torch.sum(pol_means, dim=0).transpose(-3, -2).clone()
    vis[..., 1:3, :] = 0.0              # fullpol=False: XY, YX dropped
    return vis, kernels.log_likelihood_ratio_sr(R, C, J, n_stations)


def _per_interval(fn, ops, lead, n_chunks, *args, **kw):
    """``fn`` on one interval at a time: ``ops`` carry the lane axes
    ``lead`` and the interval axis in front; returns (vis, llr) with them
    restored."""
    flat = [t.reshape((-1,) + tuple(t.shape[len(lead) + 1:])) for t in ops]
    outs = [fn(*(t[g] for t in flat), *args, **kw)
            for g in range(flat[0].shape[0])]
    vis_b = torch.stack([o[0] for o in outs]).reshape(
        lead + (n_chunks,) + tuple(outs[0][0].shape))
    llr = torch.stack([o[1] for o in outs]).reshape(
        lead + (n_chunks,) + tuple(outs[0][1].shape))
    return vis_b, llr


def influence_visibilities(R, C, J, hadd, n_stations, n_chunks,
                           block_baselines=0, perdir=False, precision="f32",
                           optimized=True):
    """Influence visibilities over all calibration intervals.

    R : (2*B*T, 2, 2) kernel-convention residuals of one sub-band
    C : (K, T*B, 4, 2) coherencies;  J : (Ts, K, 2N, 2, 2);  hadd : (K,)
    All four may carry the same leading lane axes (bands, episodes).
    Unblocked, the intervals of every lane go through the chain in one
    pass; ``block_baselines`` > 0 runs the blocked Hessian (SKA tier)
    interval by interval, lane by lane: its CUDA kernel takes one.
    ``precision`` as in :func:`_chunk_influence_opt`.  ``optimized=False``
    runs the oracle chain (:func:`_chunk_influence`) interval by interval
    instead, f32 and unblocked (``block_baselines`` and ``precision`` do
    not apply).  Returns vis (T*B, 4, 2), or (K, T*B, 4, 2) with
    ``perdir``, scaled by 8*B*Tdelta, and llr (Ts, K), under the lane
    axes."""
    B = n_stations * (n_stations - 1) // 2
    lead, K = C.shape[:-4], C.shape[-4]
    T = C.shape[-3] // B
    Td = T // n_chunks
    hadd_s = hadd[..., None, :].expand(lead + (n_chunks, K))
    if not optimized:
        R4 = R.reshape(lead + (n_chunks, 2 * B * Td, 2, 2))
        C4 = C.reshape(lead + (K, n_chunks, B * Td, 4, 2)).movedim(-4, -5)
        vis_b, llr = _per_interval(_chunk_influence, (R4, C4, J, hadd_s),
                                   lead, n_chunks, n_stations, perdir=perdir)
    else:
        R3 = R.reshape(lead + (n_chunks, Td, B, 2, 2, 2))
        C5 = C.reshape(lead + (K, n_chunks, Td, B, 2, 2, 2)) \
            .transpose(-3, -2).movedim(-6, -7).contiguous()
        p_idx, q_idx = kernels.baseline_indices(n_stations, R.device)
        J4 = J.reshape(lead + (n_chunks, K, n_stations, 2, 2, 2))
        Jp = J4[..., p_idx, :, :, :]                     # (.., Ts, K, B, ..)
        Jq = J4[..., q_idx, :, :, :]
        Csum = torch.sum(C5, dim=-5)                     # (.., Ts, K, B, ..)
        lhs = creal.einsum("...skbuv,...skbwv->...skbuw", Jq,
                           creal.conj(Csum))
        if block_baselines:
            vis_b, llr = _per_interval(
                _chunk_influence_opt, (R3, C5, Jp, Jq, lhs, hadd_s), lead,
                n_chunks, n_stations, block_baselines, perdir=perdir,
                precision=precision)
        else:
            vis_b, llr = _chunk_influence_opt(R3, C5, Jp, Jq, lhs, hadd_s,
                                              n_stations, perdir=perdir,
                                              precision=precision)
    if perdir:         # (.., Ts, K, B, ..) -> (.., K, Ts*Td*B, ..)
        vis = vis_b.unsqueeze(-4).expand(
            lead + (n_chunks, K, Td, B, 4, 2)).transpose(-6, -5) \
            .reshape(lead + (K, T * B, 4, 2))
    else:
        vis = vis_b.unsqueeze(-4).expand(lead + (n_chunks, Td, B, 4, 2)) \
            .reshape(lead + (T * B, 4, 2))
    return InfluenceResult(vis=vis * (8.0 * B * Td), llr=llr)


class PerdirSummary(NamedTuple):
    """Per-direction scalars of the perdir influence (reference
    analysis_uvw_perdir, influence_tools.py:346-358)."""

    j_norm: torch.Tensor     # (K,)
    c_norm: torch.Tensor     # (K,)
    inf_mean: torch.Tensor   # (K,) |mean XX + mean YY|
    llr_mean: torch.Tensor   # (K,)


def perdir_summary(vis_k, llr, C, J) -> PerdirSummary:
    """Per-direction scalars from perdir influence visibilities
    (K, T*B, 4, 2), llr (Ts, K), C (K, T*B, 4, 2) and J (Ts, K, 2N, 2, 2)."""
    s = (torch.mean(vis_k[:, :, 0, :], dim=1)
         + torch.mean(vis_k[:, :, 3, :], dim=1))
    return PerdirSummary(
        j_norm=torch.sqrt(torch.sum(J * J, dim=(0, 2, 3, 4))),
        c_norm=torch.sqrt(torch.sum(C * C, dim=(1, 2, 3))),
        inf_mean=torch.sqrt(s[:, 0] ** 2 + s[:, 1] ** 2),
        llr_mean=torch.mean(llr, dim=0))


def stokes_i_influence(vis):
    """(..., 4, 2) influence visibilities -> (..., 2) Stokes I."""
    return 0.5 * (vis[..., 0, :] + vis[..., 3, :])


def influence_image_single_sr(residual_f, C_f, J_f, hadd_f, freq, uvw,
                              cell, n_stations, n_chunks, npix,
                              block_baselines=0, imager_block_r=0,
                              precision="f32"):
    """One sub-band's Stokes-I influence dirty image: the optimized
    influence chain, then the rank-factored imager.  residual_f
    (T, B, 2, 2, 2), C_f (K, T*B, 4, 2), J_f (Ts, K, 2N, 2, 2), hadd_f
    (K,), uvw (T*B, 3) meters: :func:`influence_images_lanes` without lane
    axes."""
    return influence_images_lanes(
        residual_f, C_f, J_f, hadd_f, freq, uvw, cell, n_stations, n_chunks,
        npix, block_baselines=block_baselines, imager_block_r=imager_block_r,
        precision=precision)


def influence_images_lanes(residual, C, J, hadd, freqs, uvw, cell,
                           n_stations, n_chunks, npix, block_baselines=0,
                           imager_block_r=0, precision="f32"):
    """Stokes-I influence dirty images of many (episode, band) lanes: the
    body of the JAX package's ``influence_images_multi`` (optimized chain)
    under its batched route's ``vmap``.

    residual (..., T, B, 2, 2, 2); C (..., K, T*B, 4, 2); J (..., Ts, K,
    2N, 2, 2); hadd (..., K); ``freqs`` a host array of the lane axes;
    uvw (..., T*B, 3) meters and host ``cell`` broadcast against them.
    Returns (..., npix, npix).  The lanes go through the plain chain and
    the factored imager's matmuls together; the SKA-tier statics
    (``block_baselines``, ``imager_block_r``) run the blocked Hessian and
    the large-tier imager lane by lane, as their CUDA kernels take one.
    ``precision`` (``cal/precision``): "bf16" narrows the column means'
    final contraction and the imager's matmuls (kernel 2's bf16 mode on
    the card), with f32 accumulation; the solve-side chain stays f32."""
    lead = residual.shape[:-5]
    T, B = residual.shape[-5], residual.shape[-4]
    Rk = residual.reshape(lead + (2 * T * B, 2, 2))
    inf = influence_visibilities(Rk, C, J, hadd, n_stations, n_chunks,
                                 block_baselines=block_baselines,
                                 precision=precision)
    ivis = stokes_i_influence(inf.vis)                   # (..., T*B, 2)
    if not imager_block_r:
        return imager.dirty_image_factored_sr(uvw, ivis, freqs, cell,
                                              npix=npix, precision=precision)
    uvw = uvw.expand(lead + tuple(uvw.shape[-2:]))
    freqs = np.broadcast_to(np.asarray(freqs), lead)
    cell = np.broadcast_to(np.asarray(cell), lead)
    imgs = [imager.dirty_image_factored_large_sr(
        uvw[i], ivis[i], float(freqs[i]), float(cell[i]), npix=npix,
        block_r=imager_block_r, precision=precision)
        for i in np.ndindex(lead)]
    return torch.stack(imgs).reshape(lead + (npix, npix))


def influence_images_multi(residual, C, J, hadd_all, freqs, uvw, cell,
                           n_stations, n_chunks, npix, use_pallas=True,
                           optimized=True, block_baselines=0,
                           imager_block_r=0, precision="f32"):
    """Per-sub-band Stokes-I influence dirty images (Nf, npix, npix).

    residual (Nf, T, B, 2, 2, 2) solver residuals; C (Nf, K, T*B, 4, 2);
    J (Nf, Ts, K, 2N, 2, 2); hadd_all (Nf, K) (:func:`consensus_hadd_all`);
    ``freqs`` (Nf,) a host array; uvw (T*B, 3) meters; ``cell`` the pixel
    size.

    ``optimized`` (default) runs the bands as lanes of
    :func:`influence_images_lanes` (the optimized chain and the factored
    imager, with the SKA-tier statics and ``precision``).
    ``optimized=False`` loops over the bands on the oracle chain, f32 and
    unblocked, and images each with the direct DFT: kernel 1 on the card
    (``imager.dirty_image_sr``), or its plain formulation
    ``imager.dirty_image_sr_xla`` when ``use_pallas=False`` (the JAX
    package's switch away from its TPU kernel, kept under its name)."""
    if optimized:
        return influence_images_lanes(
            residual, C, J, hadd_all, np.asarray(freqs), uvw, cell,
            n_stations, n_chunks, npix, block_baselines=block_baselines,
            imager_block_r=imager_block_r, precision=precision)
    from smartcal_tpu_torch.cal import solver  # lazy: solver is a consumer

    image = imager.dirty_image_sr if use_pallas else imager.dirty_image_sr_xla
    imgs = []
    for f, f_hz in enumerate(np.asarray(freqs).tolist()):
        inf = influence_visibilities(
            solver.residual_to_kernel(residual[f]), C[f], J[f], hadd_all[f],
            n_stations, n_chunks, optimized=False)
        imgs.append(image(uvw, stokes_i_influence(inf.vis), f_hz, cell,
                          npix=npix))
    return torch.stack(imgs)
