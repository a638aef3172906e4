"""Direction-dependent calibration: per-direction Jones solve + consensus
ADMM across frequency (counterpart of smartcal_tpu/cal/solver.py).

One solve route: the fused math of ``solve_admm``.  The (Nf, Ts)
independent inner L-BFGS solves are ONE batched ``lbfgs_solve`` over a lane
axis of size L = Nf*Ts (the JAX package's ``vmap(vmap(...))``), the ADMM
loop is a Python loop, and the consensus polynomial update is a small
reduction over frequency.  ``solve_admm_batched`` is the JAX package's
``vmap(solve_admm)`` over E episodes: E*Nf*Ts lanes of one ``lbfgs_solve``
per inner solve, everything else per episode.  ``solve_admm_host`` is the
JAX package's host-segmented solve: ``solve_admm`` with its inner solves
cut into bounded segments (``lbfgs_resume``), which JAX runs to stay under
a TPU watchdog.  Here it gives the fused route's bits; it is the last rung
of ``solve_admm_safe``'s ladder, as in JAX, but on the port that rung
repeats a non-finite fused solve rather than rescuing it.  With
``axis_name`` the frequency axis is sharded over that mesh axis
(``parallel/sharded_cal.solve_admm_sharded``): Nf is the local band count
and the cross-frequency sums (the data scale, ``btb``, the Z update, the
residual norms, the telemetry) are the collectives of
``ops/collectives.py``.  ``collect_stats=True`` returns the solver's telemetry
(:class:`SolverStats`) beside the result; ``cost_eval_flops`` is the
analytic flop model of the inner evaluations beside counted ones
(``obs.costs``).

All math is split-real float32; samples are time-major ck = t*B + b and
baselines enumerate p < q row-major.
"""

import threading
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from smartcal_tpu_torch import obs
from smartcal_tpu_torch.cal import consensus, creal
from smartcal_tpu_torch.cal.kernels import baseline_indices, baseline_onehots
from smartcal_tpu_torch.obs import costs
from smartcal_tpu_torch.ops import collectives, lbfgs
from smartcal_tpu_torch.ops.autodiff import lane_value_and_grad


class SolverConfig(NamedTuple):
    """Static configuration (see the JAX twin): consensus polynomial terms,
    outer ADMM iterations, L-BFGS iterations per outer iteration, chi2-only
    init iterations, and the basis type (0 ordinary / 1 Bernstein)."""

    n_stations: int
    n_dirs: int
    n_poly: int = 3
    admm_iters: int = 10
    lbfgs_iters: int = 8
    init_iters: int = 40
    polytype: int = 0


class SolveResult(NamedTuple):
    J: torch.Tensor          # (Nf, Ts, K, 2N, 2, 2) per-subband solutions
    Z: torch.Tensor          # (Ts, K, Ne, 2N, 2, 2) global poly solutions
    residual: torch.Tensor   # (Nf, T, B, 2, 2, 2) V - sum_k Jp C Jq^H
    sigma_res: torch.Tensor  # () std of residual (all subbands)
    sigma_data: torch.Tensor # () std of data
    final_cost: torch.Tensor # (Nf, Ts) inner cost at the last ADMM
                             # iteration, in DATA units


class SolverStats(NamedTuple):
    """Telemetry of one solve (``collect_stats=True``; the JAX package's
    ``SolverStats`` plus the line search's own counts).  Additional
    outputs only: the solution is the same bits with or without them.
    Tensors on the solve's device; ``solve_admm_batched`` gives each a
    leading episode axis (the JAX package's vmapped solve)."""

    admm_iters: torch.Tensor    # () int32 outer iterations run
    primal_resid: torch.Tensor  # (admm_iters,) consensus RMS ||J - BZ||
    inner_iters: torch.Tensor   # (admm_iters,) int32 L-BFGS iterations
                                # per outer iteration, summed over lanes
    init_iters: torch.Tensor    # () int32 chi2-only init iterations, summed
    n_segments: torch.Tensor    # () int32 solve dispatches (1: one solve)
    phi_evals: int              # quartic evaluations of every line search
    linesearches: int           # line searches run (each over all lanes)


class SolverDegradedError(RuntimeError):
    """Every rung of the ladder (rho-boosted retries, the host-segmented
    fallback) still produced non-finite iterates."""


def predict_vis_sr(J, C5, n_stations):
    """Model visibilities sum_k Jp C Jq^H: J (..., K, 2N, 2, 2),
    C5 (..., K, Tc, B, 2, 2, 2) -> (..., Tc, B, 2, 2, 2)."""
    p_idx, q_idx = baseline_indices(n_stations, J.device)
    J4 = J.reshape(J.shape[:-3] + (n_stations, 2, 2, 2))
    Jp = J4.index_select(-4, p_idx)
    Jq = J4.index_select(-4, q_idx)
    JpC = creal.einsum("...kbij,...ktbjl->...ktbil", Jp, C5)
    return creal.einsum("...ktbil,...kbml->...tbim", JpC, creal.conj(Jq))


def coherency_to_chunks(C, B, Ts):
    """Kernel-convention C (..., K, T*B, 4, 2) -> solver chunks
    (..., Ts, K, Tdelta, B, 2, 2, 2) (order='F' 2x2 blocks)."""
    lead, K = C.shape[:-4], C.shape[-4]
    C5 = C.reshape(lead + (K, -1, B, 2, 2, 2)).transpose(-3, -2)
    T = C5.shape[-5]
    C6 = C5.reshape(lead + (K, Ts, T // Ts, B, 2, 2, 2))
    return C6.movedim(-7, -6)


def vis_to_chunks(V, Ts):
    """(..., T, B, 2, 2, 2) -> (..., Ts, Tdelta, B, 2, 2, 2)."""
    lead, T = V.shape[:-5], V.shape[-5]
    return V.reshape(lead + (Ts, T // Ts) + tuple(V.shape[-4:]))


def _model_bilinear(Ja, Jb, Cp, onehot_p, onehot_q, cfg: SolverConfig):
    """K-summed model planes of F(Ja, Jb) = sum_k Ja_p C_k Jb_q^H per lane.

    Ja/Jb (L, K, 2N, 2, 2); Cp (L, K, j, l, c, Tc, B).  Returns
    ``planes[i][m] = (re, im)``, each (L, Tc, B).  F is linear in each Jones
    argument, which makes the line-search objective an exact quartic.  The
    2x2 complex algebra is unrolled over planes whose minor axis is
    baselines; the station->baseline expansion is a one-hot matmul."""
    L, K, N = Ja.shape[0], cfg.n_dirs, cfg.n_stations
    Ja5 = Ja.reshape(L, K, N, 2, 2, 2).permute(0, 1, 3, 4, 5, 2)
    Jb5 = Jb.reshape(L, K, N, 2, 2, 2).permute(0, 1, 3, 4, 5, 2)
    Jp = Ja5 @ onehot_p                                  # (L, K, i, j, c, B)
    Jq = Jb5 @ onehot_q

    jpc = [[None] * 2 for _ in range(2)]
    for i in range(2):
        for l in range(2):
            tr = ti = 0.0
            for j in range(2):
                ar = Jp[:, :, i, j, 0][:, :, None, :]    # (L, K, 1, B)
                ai = Jp[:, :, i, j, 1][:, :, None, :]
                br = Cp[:, :, j, l, 0]                   # (L, K, Tc, B)
                bi = Cp[:, :, j, l, 1]
                tr = tr + ar * br - ai * bi
                ti = ti + ar * bi + ai * br
            jpc[i][l] = (tr, ti)

    planes = [[None] * 2 for _ in range(2)]
    for i in range(2):
        for m in range(2):
            mr = mi = 0.0
            for l in range(2):
                tr, ti = jpc[i][l]
                cr = Jq[:, :, m, l, 0][:, :, None, :]
                ci = Jq[:, :, m, l, 1][:, :, None, :]    # conj: -ci below
                mr = mr + tr * cr + ti * ci
                mi = mi - tr * ci + ti * cr
            planes[i][m] = (mr.sum(dim=1), mi.sum(dim=1))  # sum over k
    return planes


def _cost_fn_onehot(x, Vp, Cp, onehots, prior, half_rho, cfg: SolverConfig):
    """Per-lane chi^2 + sum_k rho_k/2 ||J_k - prior_k||^2: x (L, n),
    Vp (L, i, m, c, Tc, B), Cp (L, K, j, l, c, Tc, B), prior
    (L, K, 2N, 2, 2).  Returns (L,)."""
    L = x.shape[0]
    J = x.reshape(L, cfg.n_dirs, 2 * cfg.n_stations, 2, 2)
    planes = _model_bilinear(J, J, Cp, onehots[0], onehots[1], cfg)
    chi2 = 0.0
    for i in range(2):
        for m in range(2):
            mr, mi = planes[i][m]
            dr = Vp[:, i, m, 0] - mr
            di = Vp[:, i, m, 1] - mi
            chi2 = (chi2 + torch.sum(dr * dr, dim=(-2, -1))
                    + torch.sum(di * di, dim=(-2, -1)))
    pr = torch.sum((J - prior) ** 2, dim=(2, 3, 4))      # (L, K)
    return chi2 + torch.sum(half_rho * pr, dim=-1)


def _quartic_coeffs(x, d, Vp, Cp, onehots, prior, half_rho,
                    cfg: SolverConfig):
    """(L, 5) coefficients c0..c4 of the exact line-search quartic
    phi(alpha) = cost(x + alpha d): the residual along d is
    R0 - alpha P1 - alpha^2 P2 with R0 = V - F(J,J), P1 = F(D,J) + F(J,D)
    and P2 = F(D,D).  P1 comes from the two mixed evaluations directly
    (the polarization form cancels catastrophically in f32 once |D| << |J|,
    see the JAX twin)."""
    L = x.shape[0]
    J = x.reshape(L, cfg.n_dirs, 2 * cfg.n_stations, 2, 2)
    D = d.reshape(J.shape)
    oh_p, oh_q = onehots
    m0 = _model_bilinear(J, J, Cp, oh_p, oh_q, cfg)
    m2 = _model_bilinear(D, D, Cp, oh_p, oh_q, cfg)
    mdj = _model_bilinear(D, J, Cp, oh_p, oh_q, cfg)
    mjd = _model_bilinear(J, D, Cp, oh_p, oh_q, cfg)
    c0 = c1 = c2 = c3 = c4 = torch.zeros(L, dtype=x.dtype, device=x.device)

    def tot(a):
        return torch.sum(a, dim=(-2, -1))

    for i in range(2):
        for m in range(2):
            for comp in range(2):
                r0 = Vp[:, i, m, comp] - m0[i][m][comp]
                p2 = m2[i][m][comp]
                p1 = mdj[i][m][comp] + mjd[i][m][comp]
                c0 = c0 + tot(r0 * r0)
                c1 = c1 - 2.0 * tot(r0 * p1)
                c2 = c2 + tot(p1 * p1) - 2.0 * tot(r0 * p2)
                c3 = c3 + 2.0 * tot(p1 * p2)
                c4 = c4 + tot(p2 * p2)
    e = J - prior
    c0 = c0 + torch.sum(half_rho * torch.sum(e * e, dim=(2, 3, 4)), dim=-1)
    c1 = c1 + 2.0 * torch.sum(half_rho * torch.sum(e * D, dim=(2, 3, 4)),
                              dim=-1)
    c2 = c2 + torch.sum(half_rho * torch.sum(D * D, dim=(2, 3, 4)), dim=-1)
    return torch.stack([c0, c1, c2, c3, c4], dim=-1)


def _quartic_phi(coeffs):
    """phi(alpha) -> (value, slope) of the quartic, per lane."""
    c0, c1, c2, c3, c4 = coeffs.unbind(-1)

    def phi(a):
        val = c0 + a * (c1 + a * (c2 + a * (c3 + a * c4)))
        der = c1 + a * (2.0 * c2 + a * (3.0 * c3 + a * 4.0 * c4))
        return val, der

    return phi


# One capture at a time in the process: two threads capturing at once
# (the demixing fleet's actor threads) break each other's captures
# ("operation not permitted when stream is capturing").
_CAPTURE_LOCK = threading.Lock()


class _QuarticLineSearch:
    """``lbfgs.strong_wolfe_cubic`` on the quartic's (L, 5) coefficients.

    The search is ~700 lane-masked ops on (L,) tensors.  Launched one by
    one on a GPU they cost the host more than the whole search costs the
    device, so on CUDA they are captured once into a CUDA graph and each
    call is one replay; the warm-up and capture hold ``_CAPTURE_LOCK``.
    Elsewhere, and while ``obs.costs`` counts the solve (a replay is no op
    it can see), the search runs eagerly."""

    def __init__(self, n_lanes, dtype, device):
        self.n_lanes, self.dtype, self.device = n_lanes, dtype, device
        self.graph = None
        # telemetry: searches run and quartic evaluations they made (a
        # graph replay makes the evaluations of its capture: every branch)
        self.calls = self.phi_evals = self._evals = 0

    def _search(self, coeffs):
        phi = _quartic_phi(coeffs)

        def counted(a):
            self._evals += 1
            return phi(a)

        self._evals = 0
        return lbfgs.strong_wolfe_cubic(counted, self.n_lanes,
                                        dtype=self.dtype, device=self.device)

    def _capture(self, coeffs):
        self.coeffs = coeffs.clone()
        side = torch.cuda.Stream(self.device)     # warm-up, then capture
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._search(self.coeffs)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # thread-local: the episode-prefetch thread may allocate and
        # launch on its own stream while this thread captures
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.step = self._search(self.coeffs)
        self._graph_evals = self._evals
        self.graph = graph

    def __call__(self, coeffs):
        self.calls += 1
        if self.device.type != "cuda" or costs.counting():
            out = self._search(coeffs)
            self.phi_evals += self._evals
            return out
        if self.graph is None:
            with _CAPTURE_LOCK:
                t0 = time.perf_counter()
                self._capture(coeffs)
                obs.record_compile("cuda_graph:quartic_line_search",
                                   time.perf_counter() - t0,
                                   lanes=self.n_lanes)
        self.phi_evals += self._graph_evals
        self.coeffs.copy_(coeffs)
        self.graph.replay()
        return self.step.clone()


def _eval_operands(V6, C7):
    """Planes-major inner-evaluation operands, flattened to lanes, built once
    per solve: V6 (Nf, Ts, td, B, 2, 2, 2) -> Vp (L, i, m, c, td, B);
    C7 (Nf, Ts, K, td, B, 2, 2, 2) -> Cp (L, K, j, l, c, td, B)."""
    Vp = V6.permute(0, 1, 4, 5, 6, 2, 3)
    Cp = C7.permute(0, 1, 2, 5, 6, 7, 3, 4)
    return (Vp.reshape((-1,) + tuple(Vp.shape[2:])).contiguous(),
            Cp.reshape((-1,) + tuple(Cp.shape[2:])).contiguous())


def _inner_solver(Vp, Cp, cfg: SolverConfig, search=None):
    """``inner_solve(x0, prior, half_rho, iters, resume=None)``: one
    lane-batched ``lbfgs_solve`` of the per-lane cost on the lanes of
    ``Vp``/``Cp`` (with ``resume``, an ``LBFGSResult``: ``lbfgs_resume`` of
    it for ``iters`` more iterations), the quartic line search captured
    once for that lane count and reused by every call.  ``half_rho`` is
    (K,) or per lane (L, K).  ``search`` is a prebuilt
    ``_QuarticLineSearch`` of that lane count, None builds one.
    ``inner_solve.search`` is the line search (its counts are the solver
    telemetry's)."""
    onehots = baseline_onehots(cfg.n_stations, Vp.dtype, Vp.device)
    if search is None:
        search = _QuarticLineSearch(Vp.shape[0], Vp.dtype, Vp.device)
    elif (search.n_lanes, search.dtype) != (Vp.shape[0], Vp.dtype):
        raise ValueError(
            f"prebuilt line search is for {search.n_lanes} {search.dtype} "
            f"lanes, the solve has {Vp.shape[0]} {Vp.dtype} lanes")

    def inner_solve(x0, prior, half_rho, iters, resume=None):
        def cost(x):
            return _cost_fn_onehot(x, Vp, Cp, onehots, prior, half_rho, cfg)

        def line_search(x, d):
            return search(_quartic_coeffs(x, d, Vp, Cp, onehots, prior,
                                          half_rho, cfg))

        vag = lane_value_and_grad(cost)
        if resume is not None:
            return lbfgs.lbfgs_resume(vag, resume, iters,
                                      line_search=line_search)
        return lbfgs.lbfgs_solve(vag, x0, max_iters=iters,
                                 line_search=line_search)

    inner_solve.search = search
    return inner_solve


def _stats(admm_iters, resid, inner, init_iters, search, lead=(),
           n_segments=1):
    """:class:`SolverStats` of a solve from its per-iteration tensors (lists
    of ``lead``-shaped tensors)."""
    dev = search.device

    def hist(xs, dtype):
        if not xs:
            return torch.zeros(lead + (0,), dtype=dtype, device=dev)
        return torch.stack(xs, dim=-1).to(dtype)

    return SolverStats(
        admm_iters=torch.as_tensor(admm_iters, dtype=torch.int32,
                                   device=dev),
        primal_resid=hist(resid, torch.float32),
        inner_iters=hist(inner, torch.int32),
        init_iters=torch.as_tensor(init_iters, device=dev).to(torch.int32),
        n_segments=torch.full(lead, n_segments, dtype=torch.int32,
                              device=dev),
        phi_evals=search.phi_evals, linesearches=search.calls)


def _prep(V, C, freqs, f0, rho, cfg: SolverConfig, Ts, freq_range=None,
          axis_name=None):
    """Scale normalization + chunking + consensus operators.  Data and model
    are divided by the data scale and rho by its square (the minimizer is
    unchanged, the f32 arithmetic stays O(1)); _finalize undoes it.  With
    ``axis_name`` the data scale is the mean over every shard's bands and
    ``btb`` the global sum."""
    B = V.shape[2]
    vmean = torch.mean(V * V)
    if axis_name is not None:
        vmean = collectives.pmean(vmean, axis_name)
    data_scale = torch.sqrt(vmean) + 1e-20
    V = V / data_scale
    C = C / data_scale
    rho = rho / (data_scale * data_scale)
    V6 = vis_to_chunks(V, Ts)                            # (Nf,Ts,td,B,...)
    C7 = coherency_to_chunks(C, B, Ts)                   # (Nf,Ts,K,td,B,...)
    bfull = consensus.poly_basis(freqs, f0, cfg.n_poly, cfg.polytype,
                                 frange=freq_range)
    btb = bfull.T @ bfull
    if axis_name is not None:
        btb = collectives.psum(btb, axis_name)
    tr = torch.trace(btb) / cfg.n_poly
    eye = torch.eye(cfg.n_poly, dtype=btb.dtype, device=btb.device)
    A = (rho[:, None, None] * btb
         + (1e-6 * rho * tr + 1e-30)[:, None, None] * eye)
    try:
        Bi = torch.linalg.pinv(A)
    except torch.linalg.LinAlgError:
        # non-finite data (a NaN visibility makes the scale NaN): carried
        # on as NaN, as JAX's pinv does, so the solve comes out non-finite
        # and the caller's ladder sees it
        Bi = torch.full_like(A, float("nan"))
    return V6, C7, rho, data_scale, bfull, Bi


def _bz(bfull, Z):
    """B_f Z: (Nf, Ts, K, 2N, 2, 2) from Z (Ts, K, Ne, 2N, 2, 2)."""
    return torch.einsum("fe,tkenij->ftknij", bfull, Z)


def _z_update(bfull, Bi, rho, J, Y, axis_name=None):
    """Z = Bi_k sum_f b_f (rho_k J_fk + Y_fk), the sum over every shard's
    bands with ``axis_name``."""
    w = rho[None, None, :, None, None, None] * J + Y
    S = torch.einsum("fe,ftknij->tkenij", bfull, w)
    if axis_name is not None:
        S = collectives.psum(S, axis_name)
    return torch.einsum("kem,tkmnij->tkenij", Bi, S)


def _finalize(J, V6, C7, data_scale, cost, cfg: SolverConfig, T,
              axis_name=None):
    """Residual over the full data + noise statistics, in DATA units (the
    statistics over every shard's bands with ``axis_name``)."""
    Nf, B = V6.shape[0], V6.shape[3]
    r = V6 - predict_vis_sr(J, C7, cfg.n_stations)
    residual = r.reshape(Nf, T, B, 2, 2, 2) * data_scale
    n_res = torch.sum(residual * residual)
    n_dat = torch.sum(V6 * V6) * data_scale * data_scale
    count = float(residual.numel())
    if axis_name is not None:
        n_res = collectives.psum(n_res, axis_name)
        n_dat = collectives.psum(n_dat, axis_name)
        count = collectives.psum(count, axis_name)
    return (residual, torch.sqrt(n_res / count), torch.sqrt(n_dat / count),
            cost * data_scale * data_scale)


def _identity_jones(Nf, Ts, cfg: SolverConfig, dtype, dev):
    """(Nf, Ts, K, 2N, 2, 2) identity Jones: the cold start."""
    eye = torch.zeros((2, 2, 2), dtype=dtype, device=dev)
    eye[:, :, 0] = torch.eye(2, dtype=dtype, device=dev)
    K, N = cfg.n_dirs, cfg.n_stations
    return eye.expand(Nf, Ts, K, N, 2, 2, 2).reshape(Nf, Ts, K, 2 * N, 2, 2)


def solve_admm(V, C, freqs, f0, rho, cfg: SolverConfig,
               n_chunks: Optional[int] = None,
               admm_iters: Optional[int] = None,
               collect_stats: bool = False, J0=None,
               seg_iters: Optional[int] = None,
               axis_name: Optional[str] = None,
               freq_range=None) -> SolveResult:
    """Consensus-ADMM calibration over frequency sub-bands.

    V     : (Nf, T, B, 2, 2, 2) observed visibilities (split-real 2x2)
    C     : (Nf, K, T*B, 4, 2) model coherencies (kernel convention)
    freqs : (Nf,) Hz; f0 reference frequency
    rho   : (K,) per-direction ADMM regularization
    n_chunks : solution intervals Ts; None takes Ts from ``J0`` (or 1).
            Without ``J0`` the chi2-only init phase runs first
    admm_iters : optional override of ``cfg.admm_iters``
    collect_stats : return ``(result, SolverStats)``: per outer iteration
            the consensus RMS and the L-BFGS iterations of all lanes, the
            init iterations and the line search's counts (no extra sync;
            the same result bits)
    J0    : optional warm start (Nf, Ts, K, 2N, 2, 2): the init phase is
            skipped and the ADMM loop starts from ``J0`` (JAX
            solver.py:522-534)
    seg_iters : None runs each inner solve as one ``lbfgs_solve``; an int
            splits it into segments of at most ``seg_iters`` iterations
            (``lbfgs_resume`` after the first), the same trajectory and
            bits (:func:`solve_admm_host`); ``SolverStats.n_segments``
            counts them
    axis_name : mesh axis of the sharded frequency axis (inside
            ``parallel/sharded_cal.shard_map``): V, C, freqs (and J0) are
            this position's bands, the cross-frequency sums are psums over
            it, and the statistics and telemetry come out global
    freq_range : (fmin, fmax) band edges of the Bernstein basis; required
            with ``axis_name`` and ``polytype=1`` (every shard must build
            the global band's basis, not its own)
    """
    if axis_name is not None and cfg.polytype == 1 and freq_range is None:
        raise ValueError(
            "sharded frequency axis with Bernstein polytype needs explicit "
            "freq_range=(fmin, fmax): local shard min/max would build "
            "incompatible bases across shards")
    dev = V.device
    Nf, T = V.shape[0], V.shape[1]
    K, N = cfg.n_dirs, cfg.n_stations
    if n_chunks is not None:
        Ts = n_chunks
        if J0 is not None and J0.shape[1] != Ts:
            raise ValueError(f"J0 has {J0.shape[1]} solution intervals, "
                             f"n_chunks={Ts}")
    else:
        Ts = 1 if J0 is None else J0.shape[1]
    niter = cfg.admm_iters if admm_iters is None else int(admm_iters)
    rho = torch.as_tensor(rho, dtype=V.dtype, device=dev)
    V6, C7, rho, data_scale, bfull, Bi = _prep(V, C, freqs, f0, rho, cfg,
                                               Ts, freq_range, axis_name)
    warm = J0 is not None
    if warm:
        J = torch.as_tensor(J0, dtype=V.dtype, device=dev).reshape(
            Nf, Ts, K, 2 * N, 2, 2)
    else:
        J = _identity_jones(Nf, Ts, cfg, V.dtype, dev)

    Vp, Cp = _eval_operands(V6, C7)
    L = Nf * Ts
    x_shape = (L, K * 2 * N * 2 * 2)
    p_shape = (L, K, 2 * N, 2, 2)
    inner_solve = _inner_solver(Vp, Cp, cfg)
    search = inner_solve.search
    n_segments = 1
    if seg_iters is not None:
        one_solve, n_segments = inner_solve, 0

        def inner_solve(x0, prior, half_rho, total):
            nonlocal n_segments
            done = min(seg_iters, total)
            res = one_solve(x0, prior, half_rho, done)
            n_segments += 1
            while done < total:
                step = min(seg_iters, total - done)
                res = one_solve(None, prior, half_rho, step, resume=res)
                n_segments += 1
                done += step
            return res

    init_iters = 0
    if not warm and cfg.init_iters > 0:
        # chi2-only initialization at the per-subband data optimum
        res = inner_solve(J.reshape(x_shape), J.reshape(p_shape),
                          torch.zeros_like(rho), cfg.init_iters)
        J = res.x.reshape(J.shape)
        if collect_stats:
            init_iters = res.n_iters.sum()
            if axis_name is not None:
                init_iters = collectives.psum(init_iters, axis_name)

    half_rho = 0.5 * rho
    rho6 = rho[None, None, :, None, None, None]
    Y = torch.zeros_like(J)
    Z = _z_update(bfull, Bi, rho, J, Y, axis_name)
    cost = torch.zeros((Nf, Ts), dtype=V.dtype, device=dev)
    resid, inner = [], []
    for _ in range(niter):
        prior = _bz(bfull, Z) - Y / rho6
        res = inner_solve(J.reshape(x_shape), prior.reshape(p_shape),
                          half_rho, cfg.lbfgs_iters)
        J = res.x.reshape(J.shape)
        cost = res.loss.reshape(Nf, Ts)
        Z = _z_update(bfull, Bi, rho, J, Y, axis_name)
        r = J - _bz(bfull, Z)
        Y = Y + rho6 * r
        if collect_stats:
            rss, nel, nit = torch.sum(r * r), r.numel(), res.n_iters.sum()
            if axis_name is not None:
                rss = collectives.psum(rss, axis_name)
                nel = collectives.psum(nel, axis_name)
                nit = collectives.psum(nit, axis_name)
            resid.append(torch.sqrt(rss / nel))
            inner.append(nit)

    residual, sigma_res, sigma_data, fcost = _finalize(
        J, V6, C7, data_scale, cost, cfg, T, axis_name)
    result = SolveResult(J=J, Z=Z, residual=residual, sigma_res=sigma_res,
                         sigma_data=sigma_data, final_cost=fcost)
    if collect_stats:
        return result, _stats(niter, resid, inner, init_iters, search,
                              n_segments=n_segments)
    return result


def solve_admm_batched(V, C, freqs, f0, rho, cfg: SolverConfig,
                       n_chunks: int = 1, admm_iters=None,
                       collect_stats: bool = False,
                       search=None) -> SolveResult:
    """:func:`solve_admm` of E episodes at once: the JAX package's
    ``vmap(solve_admm)`` (smartcal_tpu/envs/radio.py batched_solve_callable).

    V (E, Nf, T, B, 2, 2, 2); C (E, Nf, K, T*B, 4, 2); freqs (E, Nf);
    f0 (E,); rho (E, K); ``admm_iters`` None (the config's), an int, or
    (E,) per-episode counts.  Every inner solve is ONE ``lbfgs_solve`` over
    E*Nf*Ts lanes, ordered (episode, band, interval), and runs until its
    slowest lane stops.  Data scale, rho, the consensus cores, Z, Y and the
    statistics are per episode.  The ADMM loop runs to the largest count;
    an episode past its own count keeps its J, Y, Z and cost, as a lane of
    the vmapped ``fori_loop`` does.  Returns a :class:`SolveResult` whose
    fields carry a leading episode axis; ``collect_stats`` returns
    ``(result, SolverStats)`` with a leading episode axis on the tensors
    (an episode past its own count records 0 there, as the JAX package's
    fixed-size histories do).  ``search`` is an optional prebuilt line
    search (``_QuarticLineSearch``) for the E*Nf*Ts lanes, whose graph is then
    captured once and replayed by every solve that is given it (the serving
    route's programs, ``envs/radio.batched_solve_callable``)."""
    dev, dt = V.device, V.dtype
    E, Nf, T = V.shape[0], V.shape[1], V.shape[2]
    K, N = cfg.n_dirs, cfg.n_stations
    Ts = n_chunks
    if admm_iters is None:
        admm_iters = cfg.admm_iters
    iters = np.broadcast_to(np.asarray(admm_iters, np.int64).reshape(-1),
                            (E,))
    rho = torch.as_tensor(rho, dtype=dt, device=dev).reshape(E, K)
    freqs = torch.as_tensor(freqs, dtype=dt, device=dev).reshape(E, Nf)
    f0 = np.asarray(f0, np.float64).reshape(E)
    # per-episode preparation, exactly the single solve's
    preps = [_prep(V[e], C[e], freqs[e], float(f0[e]), rho[e], cfg, Ts)
             for e in range(E)]
    V6, C7, rho, data_scale, bfull, Bi = (torch.stack(t) for t in
                                          zip(*preps))
    del preps
    eye = torch.zeros((2, 2, 2), dtype=dt, device=dev)
    eye[:, :, 0] = torch.eye(2, dtype=dt, device=dev)
    J = eye.expand(E, Nf, Ts, K, N, 2, 2, 2).reshape(E, Nf, Ts, K, 2 * N,
                                                     2, 2)
    Vp, Cp = _eval_operands(V6.flatten(0, 1), C7.flatten(0, 1))
    L = E * Nf * Ts
    x_shape = (L, K * 2 * N * 2 * 2)
    p_shape = (L, K, 2 * N, 2, 2)
    inner_solve = _inner_solver(Vp, Cp, cfg, search)

    init_iters = torch.zeros(E, dtype=torch.int32, device=dev)
    if cfg.init_iters > 0:
        res = inner_solve(J.reshape(x_shape), J.reshape(p_shape),
                          torch.zeros((L, K), dtype=dt, device=dev),
                          cfg.init_iters)
        J = res.x.reshape(J.shape)
        if collect_stats:
            init_iters = res.n_iters.reshape(E, -1).sum(dim=1)

    half_rho = (0.5 * rho).repeat_interleave(Nf * Ts, dim=0)   # (L, K)
    rho7 = rho[:, None, None, :, None, None, None]

    def bz(Z):
        return torch.einsum("xfe,xtkenij->xftknij", bfull, Z)

    def z_update(J, Y):
        S = torch.einsum("xfe,xftknij->xtkenij", bfull, rho7 * J + Y)
        return torch.einsum("xkem,xtkmnij->xtkenij", Bi, S)

    Y = torch.zeros_like(J)
    Z = z_update(J, Y)
    cost = torch.zeros((E, Nf, Ts), dtype=dt, device=dev)
    resid, inner = [], []
    for i in range(int(iters.max(initial=0))):
        prior = bz(Z) - Y / rho7
        res = inner_solve(J.reshape(x_shape), prior.reshape(p_shape),
                          half_rho, cfg.lbfgs_iters)
        J_new = res.x.reshape(J.shape)
        cost_new = res.loss.reshape(E, Nf, Ts)
        Z_new = z_update(J_new, Y)
        r = J_new - bz(Z_new)
        Y_new = Y + rho7 * r
        live = iters > i
        if collect_stats:
            on_t = torch.as_tensor(live, device=dev)
            rr = torch.sqrt(torch.sum(r * r, dim=tuple(range(1, r.dim())))
                            / r[0].numel())
            resid.append(torch.where(on_t, rr, 0.0))
            inner.append(torch.where(
                on_t, res.n_iters.reshape(E, -1).sum(dim=1), 0))
        if live.all():
            J, Y, Z, cost = J_new, Y_new, Z_new, cost_new
            continue
        on = torch.as_tensor(live, device=dev)

        def keep(new, old):
            return torch.where(on.reshape((E,) + (1,) * (new.dim() - 1)),
                               new, old)

        J, Y, Z, cost = (keep(J_new, J), keep(Y_new, Y), keep(Z_new, Z),
                         keep(cost_new, cost))

    # residual and statistics in DATA units, per episode
    B = V6.shape[4]
    ds = data_scale.reshape(E, 1, 1, 1, 1, 1, 1)
    r = V6 - predict_vis_sr(J, C7, N)
    residual = r.reshape(E, Nf, T, B, 2, 2, 2) * ds
    count = float(residual[0].numel())
    n_res = torch.sum(residual * residual, dim=(1, 2, 3, 4, 5, 6))
    n_dat = (torch.sum(V6 * V6, dim=(1, 2, 3, 4, 5, 6, 7)) * data_scale
             * data_scale)
    ds3 = data_scale[:, None, None]
    result = SolveResult(
        J=J, Z=Z, residual=residual, sigma_res=torch.sqrt(n_res / count),
        sigma_data=torch.sqrt(n_dat / count), final_cost=cost * ds3 * ds3)
    if collect_stats:
        return result, _stats(torch.as_tensor(np.array(iters)), resid, inner,
                              init_iters, inner_solve.search, lead=(E,))
    return result


def solve_admm_host(V, C, freqs, f0, rho, cfg: SolverConfig,
                    n_chunks: int = 1, admm_iters: Optional[int] = None,
                    seg_iters: int = 8,
                    collect_stats: bool = False) -> SolveResult:
    """:func:`solve_admm` as bounded host-driven segments (the JAX
    package's ``solve_admm_host``, smartcal_tpu/cal/solver.py:735-818):
    the chi2-only init as ``ceil(init_iters / seg_iters)`` segments, then
    per ADMM outer iteration the inner solve segmented the same way.  A
    segment is one ``lbfgs_solve`` or ``lbfgs_resume`` of at most
    ``seg_iters`` iterations and one quartic line search (one CUDA graph on
    the card) serves every segment, so the result is the fused route's,
    bit for bit.  JAX segments to stay under a TPU watchdog; the port's
    solve is a host-driven loop already, so on the card this route takes
    the fused one's time and cannot turn a non-finite fused solve finite.
    Cold start."""
    return solve_admm(V, C, freqs, f0, rho, cfg, n_chunks=n_chunks,
                      admm_iters=admm_iters, collect_stats=collect_stats,
                      seg_iters=seg_iters)


def result_finite(res: SolveResult) -> bool:
    """Are the solutions, residuals and costs all finite?  One sync."""
    ok = (torch.isfinite(res.J).all() & torch.isfinite(res.residual).all()
          & torch.isfinite(res.final_cost).all())
    return bool(ok)


def solve_admm_safe(solve_fn, rho, *, initial_result=None,
                    host_fallback=None, max_retries: int = 2,
                    rho_boost: float = 10.0, on_event=None):
    """Graceful degradation around a solve route (the JAX package's
    ladder, smartcal_tpu/cal/solver.py:829-878):

    1. ``solve_fn(rho)`` (or the caller's ``initial_result``);
    2. up to ``max_retries`` re-solves at ``rho * rho_boost**attempt``;
    3. ``host_fallback(rho)``, the host-segmented route, when given;
    4. :class:`SolverDegradedError`.

    Returns ``(result, info)``, ``info`` = {"degraded", "attempts",
    "route", "rho_scale"}; ``on_event(**info)`` is called at each step
    down the ladder (the caller's run-log hook)."""
    info = {"degraded": False, "attempts": 0, "route": "primary",
            "rho_scale": 1.0}
    res = initial_result if initial_result is not None else solve_fn(rho)
    if result_finite(res):
        return res, info
    info["degraded"] = True
    for attempt in range(1, max_retries + 1):
        scale = float(rho_boost) ** attempt
        info.update(attempts=attempt, route="retry_rho", rho_scale=scale)
        if on_event is not None:
            on_event(**info)
        res = solve_fn(rho * scale)
        if result_finite(res):
            return res, info
    if host_fallback is not None:
        info.update(route="host_segmented", rho_scale=1.0)
        if on_event is not None:
            on_event(**info)
        res = host_fallback(rho)
        if result_finite(res):
            return res, info
    tail = (" and the host-segmented fallback"
            if host_fallback is not None else "")
    raise SolverDegradedError(
        f"non-finite ADMM iterates survived {info['attempts']} rho-boosted "
        f"retries (x{rho_boost}){tail}")


def simulate_vis_sr(J, C, n_stations, Ts):
    """Corrupt model coherencies of one sub-band with per-interval Jones
    (the role of ``sagecal_gpu -O DATA -p``): J (Ts, K, 2N, 2, 2), C (K,
    T*B, 4, 2) -> (T, B, 2, 2, 2)."""
    B = n_stations * (n_stations - 1) // 2
    V = predict_vis_sr(J, coherency_to_chunks(C, B, Ts), n_stations)
    return V.reshape(-1, B, 2, 2, 2)


def simulate_vis_multi_sr(J, C, n_stations, Ts):
    """Corrupt model coherencies with per-interval Jones for every sub-band:
    J (Nf, Ts, K, 2N, 2, 2), C (Nf, K, T*B, 4, 2) -> (Nf, T, B, 2, 2, 2)."""
    B = n_stations * (n_stations - 1) // 2
    C7 = coherency_to_chunks(C, B, Ts)                   # (Nf,Ts,K,td,B,..)
    V = predict_vis_sr(J, C7, n_stations)                # (Nf,Ts,td,B,..)
    return V.reshape(V.shape[0], -1, B, 2, 2, 2)


def residual_to_kernel(residual):
    """(T, B, 2, 2, 2) solver residual -> kernel-convention R (2BT, 2, 2)."""
    T, B = residual.shape[0], residual.shape[1]
    return residual.reshape(2 * T * B, 2, 2)


def stokes_i_std(V):
    """Noise proxy: the population std of the Stokes I = (XX + YY)/2 real
    and imaginary planes (demixingenv.py:233-252)."""
    return torch.std(0.5 * (V[..., 0, 0, :] + V[..., 1, 1, :]), correction=0)


def cost_eval_flops(cfg: SolverConfig, Nf: int, Ts: int, td: int, B: int,
                    device="cuda") -> dict:
    """Flops of the solver's inner evaluation units (the JAX package's
    ``cost_eval_flops``, smartcal_tpu/cal/solver.py:920): the analytic
    model that ``bench.py`` quotes MFU from (``model_*``: 112 flops per
    sample and direction forward, x3 for the value and gradient, x4 for
    the quartic's four bilinear model evaluations; the same values as
    JAX's) beside the port's counts of one lane-batched value-and-grad of
    the cost and one quartic build with one probe (``counted_*``,
    ``obs.costs.stage_cost`` on zero operands of the shapes on
    ``device``), and the model-over-counted ratios."""
    K, N = cfg.n_dirs, cfg.n_stations
    dev = torch.device(device)
    L = Nf * Ts
    n = K * 2 * N * 2 * 2

    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    x, d = z(L, n), z(L, n)
    Vp, Cp = z(L, 2, 2, 2, td, B), z(L, K, 2, 2, 2, td, B)
    prior, half_rho = z(L, K, 2 * N, 2, 2), z(K)
    onehots = baseline_onehots(N, torch.float32, dev)

    def vag(x):
        return lane_value_and_grad(lambda q: _cost_fn_onehot(
            q, Vp, Cp, onehots, prior, half_rho, cfg))(x)

    def setup(x, d):
        coeffs = _quartic_coeffs(x, d, Vp, Cp, onehots, prior, half_rho,
                                 cfg)
        return _quartic_phi(coeffs)(torch.ones(L, device=dev))

    counted_vag = costs.stage_cost(vag, x)["flops"]
    counted_setup = costs.stage_cost(setup, x, d)["flops"]
    model_cost = 112.0 * K * Nf * Ts * td * B
    out = {"counted_value_and_grad_flops": counted_vag,
           "counted_linesearch_setup_flops": counted_setup,
           "model_value_and_grad_flops": 3.0 * model_cost,
           "model_linesearch_setup_flops": 4.0 * model_cost,
           "counted_on": f"torch dispatch count on {dev.type}"}
    if counted_vag > 0:
        out["vag_model_over_counted"] = round(3.0 * model_cost / counted_vag,
                                              3)
    if counted_setup > 0:
        out["setup_model_over_counted"] = round(
            4.0 * model_cost / counted_setup, 3)
    return out
