"""Residual Hessian, solution and residual derivatives, and the LLR
detector (counterpart of smartcal_tpu/cal/kernels.py): the optimized chain
and the oracle chain.

Shapes follow the JAX package (and the reference calibration_tools.py):
N stations, B = N(N-1)/2 baselines (p < q row-major), T timeslots of one
interval, K directions, split-real (..., 2) complex.

* The optimized chain (the influence map's default route): the
  scatter-free moves are kept, station sums are one-hot matmuls and the
  off-diagonal block placement is a gather of a zero-padded table, so
  every reduction has a fixed order on the GPU; the column means of dR go
  through the adjoint 4-RHS transpose solve.  The blocked (SKA-scale)
  Hessian core is here too: its per-subset block sums are the plain
  version of the CUDA kernel in ``ops/hessian_blocks.py``.
* The oracle chain (reference Hessianres, Dsolutions_r, Dresiduals_r,
  Dresiduals_rk, log_likelihood_ratio): ``hessian_res_sr``,
  ``dsolutions_all_sr`` (the 8B-column solve of dJ), ``dresiduals_all_sr``
  / ``_perdir_sr`` (the dense dR), ``dresiduals_colmeans_sr`` and
  ``log_likelihood_ratio_sr``.  It keeps the scatter formulation (segment
  sums and scatter-add placement), which makes it independent of the
  optimized one: the scatter-adds are ``index_put_(..., accumulate=True)``
  (:func:`_scatter_add`), a fixed-order reduction on the card, never
  ``index_add_`` / ``scatter_add_`` atomics.  The plain-named wrappers
  (``hessian_res``, ``dsolutions_all``, ...) take and return numpy complex
  at the host edge, on ``device`` (default "cuda").
"""

import numpy as np
import torch

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.cal import creal
from smartcal_tpu_torch.cal import precision as prec
from smartcal_tpu_torch.ops import collectives

EPS_SINGULAR = 1e-12   # reference: EPS in Dsolutions (calibration_tools.py:696)
EPS_DIV = 1e-12        # reference: EPS in log_likelihood_ratio (:1203)

_J_OF_R = np.asarray([0, 0, 0, 0, 1, 1, 1, 1])
_V_OF_R = np.asarray([0, 0, 1, 1, 0, 0, 1, 1])
_ODD_R = np.asarray([False, True] * 4)


def baseline_indices(n_stations, device="cpu"):
    """(p, q) station indices per baseline, p < q row-major, as long
    tensors on ``device``."""
    p, q = np.triu_indices(n_stations, 1)
    return (torch.as_tensor(p, device=device),
            torch.as_tensor(q, device=device))


def baseline_onehots(n_stations, dtype=torch.float32, device="cpu"):
    """One-hot (N, B) selection matrices of the p and q station of each
    baseline: a gather becomes a matmul whose transpose is a matmul too."""
    p_idx, q_idx = np.triu_indices(n_stations, 1)
    eye = torch.eye(n_stations, dtype=dtype, device=device)
    return (eye[:, torch.as_tensor(p_idx, device=device)],
            eye[:, torch.as_tensor(q_idx, device=device)])


def offdiag_index_map(n_stations):
    """(N, N) map [p, q] -> baseline index b for p < q, else B (the index of
    a zero-pad slot).  Host numpy."""
    p_idx, q_idx = np.triu_indices(n_stations, 1)
    B = p_idx.size
    m = np.full((n_stations, n_stations), B, np.int64)
    m[p_idx, q_idx] = np.arange(B)
    return m


_offdiag_on_device = {}


def _offdiag_index(n_stations, device):
    """:func:`offdiag_index_map` as a tensor on ``device``, built once per
    (N, device): no host-to-device copy per call."""
    key = (int(n_stations), torch.device(device))
    if key not in _offdiag_on_device:
        _offdiag_on_device[key] = torch.as_tensor(offdiag_index_map(key[0]),
                                                  device=key[1])
    return _offdiag_on_device[key]


def _block_onehot(idx, n_stations, dtype):
    """(N, nb) one-hot from a station-index vector.  Sentinel indices >= N
    (pad slots) give all-zero columns, so padded baselines contribute
    nothing."""
    stations = torch.arange(n_stations, device=idx.device)
    return (idx[None, :] == stations[:, None]).to(dtype)


def _hessian_block_sums(R3, C5, Jp, Jq, p_idx, q_idx, n_stations):
    """Off-diagonal blocks + station-summed diagonal contributions of ONE
    baseline subset: R3 (T, nb, 2, 2, 2); C5 (K, T, nb, 2, 2, 2); Jp/Jq
    (K, nb, 2, 2, 2); p_idx/q_idx (nb,) station indices (N = pad slot).
    Returns (off (K, nb, 4, 4, 2), Dsum (K, N, 2, 2, 2)), unnormalized.
    Every operand may carry the same leading lane axes."""
    K, nb = C5.shape[-6], C5.shape[-4]
    off = -creal.einsum("...ktbij,...tbuv->...kbiujv", creal.conj(C5), R3)
    off = off.reshape(off.shape[:-7] + (K, nb, 4, 4, 2))

    A1 = creal.einsum("...ktbuv,...kbwv->...ktbuw", C5, creal.conj(Jq))
    Sp = creal.einsum("...ktbuw,...ktbvw->...kbuv", A1, creal.conj(A1))
    A2 = creal.einsum("...kbuv,...ktbvw->...ktbuw", Jp, C5)
    Sq = creal.einsum("...ktbuv,...ktbuw->...kbvw", creal.conj(A2), A2)

    ohp = _block_onehot(p_idx, n_stations, R3.dtype)
    ohq = _block_onehot(q_idx, n_stations, R3.dtype)
    Dsum = (torch.einsum("nb,...kbuvz->...knuvz", ohp, Sp)
            + torch.einsum("nb,...kbuvz->...knuvz", ohq, Sq))
    return off, Dsum


def _hessian_assemble(off, Dsum, n_stations, B, T):
    """Placement of the off-diagonal table (gather of the zero-padded
    table, each (p, q) slot holds one baseline) and the diagonal krons.
    Returns (K, 4N, 4N, 2) normalized by B*T, under any leading lane axes
    of ``off``/``Dsum``."""
    lead = off.shape[:-4]
    dev = off.device
    eye2 = torch.eye(2, dtype=off.dtype, device=dev)
    diag_blocks = torch.einsum("...knjiz,uv->...kniujvz", Dsum,
                               eye2).reshape(lead + (n_stations, 4, 4, 2))

    idx = _offdiag_index(n_stations, dev)
    off_pad = torch.cat(
        [off, off.new_zeros(lead + (1, 4, 4, 2))], dim=-4)
    herm_pad = creal.conj(off_pad.transpose(-3, -2))
    Hup = off_pad[..., idx, :, :, :]
    Hlow = herm_pad[..., idx.T, :, :, :]
    eyeN = torch.eye(n_stations, dtype=off.dtype, device=dev)
    Hd = torch.einsum("nm,...knijz->...knmijz", eyeN, diag_blocks)
    H = (Hup + Hlow + Hd).transpose(-4, -3)
    N4 = 4 * n_stations
    return H.reshape(lead + (N4, N4, 2)) / (B * T)


def _hessian_res_core_sr(R3, C5, Jp, Jq, n_stations):
    """Scatter-free residual Hessian (K, 4N, 4N, 2), averaged over
    baselines*time (reference Hessianres, calibration_tools.py:590-631),
    under any leading lane axes of the operands."""
    T, B = C5.shape[-5], C5.shape[-4]
    p_idx, q_idx = baseline_indices(n_stations, R3.device)
    off, Dsum = _hessian_block_sums(R3, C5, Jp, Jq, p_idx, q_idx, n_stations)
    return _hessian_assemble(off, Dsum, n_stations, B, T)


def _hessian_res_core_blocked_sr(R3, C5, Jp, Jq, n_stations,
                                 block_baselines):
    """Blocked :func:`_hessian_res_core_sr` on the same operands: a loop
    over baseline blocks bounds the einsum temporaries to the block.  The
    ragged tail is zero-padded with sentinel station indices.  Same math
    to float round-off (the station sums are reassociated per block)."""
    K, T, B = C5.shape[0], C5.shape[1], C5.shape[2]
    dev = R3.device
    p_idx, q_idx = baseline_indices(n_stations, dev)
    blk = min(int(block_baselines), B)
    nblk = -(-B // blk)
    padb = nblk * blk - B

    def pad_b(x, axis):
        shape = list(x.shape)
        shape[axis] = padb
        return torch.cat([x, x.new_zeros(shape)], dim=axis)

    pi = torch.cat([p_idx, p_idx.new_full((padb,), n_stations)])
    qi = torch.cat([q_idx, q_idx.new_full((padb,), n_stations)])
    R3p, C5p = pad_b(R3, 1), pad_b(C5, 2)
    Jpp, Jqp = pad_b(Jp, 1), pad_b(Jq, 1)
    Dsum = torch.zeros((K, n_stations, 2, 2, 2), dtype=R3.dtype, device=dev)
    offs = []
    for i in range(nblk):
        s = slice(i * blk, (i + 1) * blk)
        off_b, dsum_b = _hessian_block_sums(
            R3p[:, s], C5p[:, :, s], Jpp[:, s], Jqp[:, s], pi[s], qi[s],
            n_stations)
        Dsum = Dsum + dsum_b
        offs.append(off_b)
    off = torch.cat(offs, dim=1)[:, :B]
    return _hessian_assemble(off, Dsum, n_stations, B, T)


def _colmeans_adjoint_core_sr(lhs, Dgs, n_stations, T, perdir=False,
                              contract_dtype=None):
    """Adjoint-form Dsolutions -> Dresiduals column means (8, 4, B, 2) on
    the pre-built lhs blocks ``lhs = Jq Csum^H`` (K, B, 2, 2, 2) and the
    consensus-augmented Hessian ``Dgs`` (K, 4N, 4N, 2); ``perdir`` keeps
    the directions apart: (8, K, 4, B, 2).

    Solves the transpose system A^T y_k = w_k (4 right-hand sides per
    direction, batched over directions) instead of the 8B-column forward
    solve, and contracts y against the closed form of AdV (see the JAX twin
    for the derivation).  The influence chain's ``addself=False`` form: the
    identity term of dR is not added.  Both operands may carry the same
    leading lane axes (then so does the result).

    ``contract_dtype`` (``cal/precision`` row ``colmeans_contract``)
    narrows the operands of the final Yr x Lr gather-contraction, with f32
    accumulation; the transpose solve stays f32.  None or f32 gives the
    f32 bits.
    """
    N = n_stations
    B = lhs.shape[-4]
    dev, dt = lhs.device, lhs.dtype
    onehot_p = baseline_onehots(N, dt, dev)[0]
    # G[k, n, i, j] = sum over baselines with p(b) = n of -conj(lhs)
    G = torch.einsum("nb,...kbijz->...knijz", onehot_p, -creal.conj(lhs))
    return _colmeans_from_g(G, lhs, Dgs, baseline_indices(N, dev)[0], N, T,
                            B, perdir, contract_dtype)


def _colmeans_from_g(G, lhs, Dgs, p_idx, n_stations, T, B, perdir,
                     contract_dtype):
    """The column means from the per-station sum G (K, N, 2, 2, 2): the W
    build, the regularized 4-RHS transpose solve and the Yr x Lr gather
    tail, shared by the single-device core and the baseline-sharded path
    (they differ only in how G was formed, locally or psummed).
    ``lhs``/``p_idx`` may cover a subset of the baselines; ``B`` is always
    the global count (the normalization)."""
    N = n_stations
    lead, K = lhs.shape[:-5], lhs.shape[-5]
    dev, dt = lhs.device, lhs.dtype
    eye2 = torch.eye(2, dtype=dt, device=dev)
    W = torch.einsum("...knijz,vu->...kjnviuz", G, eye2).reshape(
        lead + (K, 4 * N, 4, 2))
    A = Dgs.clone()
    A[..., 0] += EPS_SINGULAR * torch.eye(4 * N, dtype=dt, device=dev)
    Y = creal.solve(A.transpose(-3, -2), W)              # A^T y = w

    # gather y at each baseline's p station, contract against lhs
    bbt = float(B) * B * T      # float: the int product overflows at N>=256
    Y6 = Y.reshape(lead + (K, 2, N, 2, 4, 2))            # (k,j,n,u',c,2)
    Yr = Y6[..., p_idx, :, :, :][
        ..., torch.as_tensor(_V_OF_R, device=dev), :, :]
    Lr = lhs[..., torch.as_tensor(_J_OF_R, device=dev), :, :]  # (k,b,r,j,2)
    odd = torch.as_tensor(_ODD_R, device=dev)[:, None, None, None]
    if perdir:
        out = creal.einsum("...kjbrc,...kbrj->...krcb", Yr, Lr,
                           compute_dtype=contract_dtype)
        out = out.transpose(-5, -4)                      # (8, K, 4, B, 2)
        odd = odd[..., None]
    else:
        out = creal.einsum("...kjbrc,...kbrj->...rcb", Yr, Lr,  # (8,4,B,2)
                           compute_dtype=contract_dtype)
    return torch.where(odd, creal.mul_i(out), out) / bbt


def _colmeans_adjoint_bshard_sr(lhs_l, Dgs, p_idx_l, n_stations, T, b_total,
                                perdir, axis_name, contract_dtype=None):
    """Baseline-sharded adjoint column means: ``lhs_l``/``p_idx_l`` are
    this position's baseline slice, ``Dgs`` the psummed (replicated)
    consensus-augmented Hessian.  The per-station sum G is the one
    collective; the transpose solve runs on every position; the gather
    tail covers the local baselines only."""
    onehot_p = _block_onehot(p_idx_l, n_stations, lhs_l.dtype)
    G = torch.einsum("nb,kbijz->knijz", onehot_p, -creal.conj(lhs_l))
    G = collectives.psum(G, axis_name)
    return _colmeans_from_g(G, lhs_l, Dgs, p_idx_l, n_stations, T, b_total,
                            perdir, contract_dtype)


def _llr_core_sr(R3, C5, Jp, Jq):
    """Per-direction log-likelihood ratio (K,): (||r+mu||^2 - ||r||^2) /
    sigma^2 with mu = Jp C Jq^H per sample and sigma^2 from Stokes V of
    the residual (reference calibration_tools.py:1181-1223).  The operands
    may carry the same leading lane axes (then (..., K))."""
    tmp = creal.einsum("...kbuv,...ktbvw->...ktbuw", Jp, C5)
    mu = creal.einsum("...ktbuw,...kbxw->...ktbux", tmp, creal.conj(Jq))
    sV = 0.5 * (R3[..., 0, 1, :] - R3[..., 1, 0, :])
    sigma2 = torch.sum(creal.abs2(sV), dim=(-2, -1))[..., None]
    rn2 = torch.sum(creal.abs2(R3), dim=(-4, -3, -2, -1))[..., None]
    rpmu2 = torch.sum(creal.abs2(R3.unsqueeze(-6) + mu),
                      dim=(-4, -3, -2, -1))
    return (rpmu2 - rn2) / (sigma2 + EPS_DIV)


def _llr_bshard_sr(R3l, C5l, Jpl, Jql, axis_name):
    """Baseline-sharded :func:`_llr_core_sr` on one interval: the three
    norms are this position's partial sums, psummed over ``axis_name``."""
    tmp = creal.einsum("kbuv,ktbvw->ktbuw", Jpl, C5l)
    mu = creal.einsum("ktbuw,kbxw->ktbux", tmp, creal.conj(Jql))
    sV = 0.5 * (R3l[..., 0, 1, :] - R3l[..., 1, 0, :])
    sigma2 = collectives.psum(torch.sum(creal.abs2(sV)), axis_name)
    rn2 = collectives.psum(torch.sum(creal.abs2(R3l)), axis_name)
    rpmu2 = collectives.psum(
        torch.sum(creal.abs2(R3l[None] + mu), dim=(1, 2, 3, 4)), axis_name)
    return (rpmu2 - rn2) / (sigma2 + EPS_DIV)


# ---------------------------------------------------------------------------
# The oracle chain: the reference formulation, scatter-based
# ---------------------------------------------------------------------------

def _split_samples_sr(Rs, Cs, n_stations):
    """Split-real (2BT, 2, 2) / (K, BT, 4, 2) -> time/baseline block form
    (R3 (T, B, 2, 2, 2), C5 (K, T, B, 2, 2, 2), B, T, K)."""
    B = n_stations * (n_stations - 1) // 2
    K = Cs.shape[0]
    T = Cs.shape[1] // B
    R3 = Rs.reshape(T, B, 2, 2, 2)
    # order='F' 2x2: swap the matrix axes (pair axis stays last)
    C5 = Cs.reshape(K, T, B, 2, 2, 2).transpose(-3, -2)
    return R3, C5, B, T, K


def _jones_blocks_sr(Js, n_stations):
    """(K, 2N, 2, 2) -> (K, N, 2, 2, 2) with [k, p] = J[k, 2p:2p+2]."""
    return Js.reshape(Js.shape[0], n_stations, 2, 2, 2)


def _scatter_add(out, axes, index, values):
    """``out`` with ``values`` added at ``index`` (a tuple of index
    tensors) along ``axes``, in place: the JAX ``.at[...].add`` with the
    indexed axes moved first, as numpy orders a result whose advanced
    indices are not adjacent.  ``index_put_(accumulate=True)`` sums
    repeated indices in a fixed order on either device."""
    rest = [a for a in range(out.dim()) if a not in axes]
    out.permute(list(axes) + rest).index_put_(index, values,
                                              accumulate=True)
    return out


def _segment_sum(x, idx, n):
    """(n, ...) sums of the rows of ``x`` (B, ...) per segment ``idx``."""
    return _scatter_add(x.new_zeros((n,) + tuple(x.shape[1:])), (0,),
                        (idx,), x)


def hessian_res_sr(Rs, Cs, Js, n_stations):
    """Residual Hessian H (K, 4N, 4N, 2), averaged over baselines*time,
    the oracle formulation.  Per baseline (p, q):
      off-diag  (p,q): -conj(C) (x) Res          (and its hermitian at (q,p))
      diag      (p,p): ((C Jq^H)(C Jq^H)^H)^T (x) I2
      diag      (q,q): ((Jp C)^H (Jp C))^T (x) I2
    with the station sums as segment sums and the blocks placed by
    scatter-add.  Reference: Hessianres, calibration_tools.py:590-631."""
    R3, C5, B, T, K = _split_samples_sr(Rs, Cs, n_stations)
    J4 = _jones_blocks_sr(Js, n_stations)
    p_idx, q_idx = baseline_indices(n_stations, Rs.device)
    Jp, Jq = J4[:, p_idx], J4[:, q_idx]                 # (K, B, 2, 2, 2)

    # off-diagonal: sum_t kron(-conj(Ci), Res) -> (K, B, 4, 4, 2)
    off = -creal.einsum("ktbij,tbuv->kbiujv", creal.conj(C5), R3)
    off = off.reshape(K, B, 4, 4, 2)
    # diag at p: A1 = Ci Jq^H, S = sum_t A1 A1^H; at q: A2 = Jp Ci,
    # S = sum_t A2^H A2
    A1 = creal.einsum("ktbuv,kbwv->ktbuw", C5, creal.conj(Jq))
    Sp = creal.einsum("ktbuw,ktbvw->kbuv", A1, creal.conj(A1))
    A2 = creal.einsum("kbuv,ktbvw->ktbuw", Jp, C5)
    Sq = creal.einsum("ktbuv,ktbuw->kbvw", creal.conj(A2), A2)

    Dsum = (_segment_sum(Sp.transpose(0, 1), p_idx, n_stations)
            + _segment_sum(Sq.transpose(0, 1), q_idx, n_stations))
    # kron(S.T, I2)[2i+u, 2j+v] = S[j, i] * delta_uv
    eye2 = torch.eye(2, dtype=Rs.dtype, device=Rs.device)
    diag_blocks = torch.einsum("nkjiz,uv->nkiujvz", Dsum, eye2).reshape(
        n_stations, K, 4, 4, 2)

    H = Rs.new_zeros((K, n_stations, 4, n_stations, 4, 2))
    off_t = off.transpose(0, 1)                         # (B, K, 4, 4, 2)
    _scatter_add(H, (1, 3), (p_idx, q_idx), off_t)
    _scatter_add(H, (1, 3), (q_idx, p_idx),
                 creal.conj(off_t.transpose(-3, -2)))
    sidx = torch.arange(n_stations, device=Rs.device)
    _scatter_add(H, (1, 3), (sidx, sidx), diag_blocks)
    N4 = 4 * n_stations
    return H.reshape(K, N4, N4, 2) / (B * T)


def _complex_in(device, *xs):
    """Host numpy complex arrays -> split-real float32 tensors on
    ``device``."""
    dev = resolve_device(device)
    return [torch.as_tensor(creal.split(x), device=dev) for x in xs]


def hessian_res(R, C, J, n_stations, device="cuda"):
    """Complex host-edge wrapper (reference Hessianres signature):
    (K, 4N, 4N) numpy complex64."""
    return creal.fuse(hessian_res_sr(*_complex_in(device, R, C, J),
                                     n_stations))


def hessian_res_opt_sr(Rs, Cs, Js, n_stations):
    """:func:`hessian_res_sr` through the scatter-free core (one-hot
    station sums, gathered placement): the optimized chain's Hessian,
    equal to the oracle to float round-off."""
    R3, C5, B, T, K = _split_samples_sr(Rs, Cs, n_stations)
    J4 = _jones_blocks_sr(Js, n_stations)
    p_idx, q_idx = baseline_indices(n_stations, Rs.device)
    return _hessian_res_core_sr(R3, C5, J4[:, p_idx], J4[:, q_idx],
                                n_stations)


def dsolutions_all_sr(Cs, Js, n_stations, Dgs):
    """dJ/dx for all 8 real perturbation directions r: (8, K, 4N, B, 2).

    Baseline column b (stations p < q) of the right-hand side AdV_r holds
    kron(lhs^T, I2)[:, r//2] * phase_r (phase 1 for even r, i for odd r),
    lhs = Jq (sum_t C)^H, in rows {2p, 2p+1} and {2N+2p, 2N+2p+1}, placed
    by scatter-add; then dJ_r = (Dgs + eps I)^{-1} AdV_r, the 8B columns
    of a direction against one factorization, every direction in one
    batched solve.  Reference: Dsolutions_r, calibration_tools.py:778-823.
    """
    N = n_stations
    B = N * (N - 1) // 2
    K = Cs.shape[0]
    dev, dt = Cs.device, Cs.dtype
    C5 = Cs.reshape(K, -1, B, 2, 2, 2).transpose(-3, -2)
    Csum = torch.sum(C5, dim=1)                         # (K, B, 2, 2, 2)
    J4 = _jones_blocks_sr(Js, N)
    p_idx, q_idx = baseline_indices(N, dev)
    lhs = creal.einsum("kbuv,kbwv->kbuw", J4[:, q_idx], creal.conj(Csum))

    # fillvex: M = kron(lhs^T, I2); column m = r//2 has entries
    # M[2i+u, m] = lhs[m//2, i] * delta_{u, m%2}; odd r multiplies by i
    lhs_g = lhs[:, :, torch.as_tensor(_J_OF_R, device=dev)]  # (K,B,8,i,2)
    delta = torch.eye(2, dtype=dt, device=dev)[
        torch.as_tensor(_V_OF_R, device=dev)]           # (8, u)
    fv = lhs_g[:, :, :, None, :, :] * delta[None, None, :, :, None, None]
    odd = torch.as_tensor(_ODD_R, device=dev)[None, None, :, None, None,
                                              None]
    fv = torch.where(odd, creal.mul_i(fv), fv)          # (K, B, 8, u, i, 2)
    vals = fv.permute(1, 2, 0, 4, 3, 5)                 # (B, 8, K, i, u, 2)

    AdV = Cs.new_zeros((8, K, 2, N, 2, B, 2))
    _scatter_add(AdV, (3, 5), (p_idx, torch.arange(B, device=dev)), vals)
    rhs = AdV.reshape(8, K, 4 * N, B, 2).permute(1, 2, 0, 3, 4).reshape(
        K, 4 * N, 8 * B, 2)
    A = Dgs.clone()
    A[..., 0] += EPS_SINGULAR * torch.eye(4 * N, dtype=dt, device=dev)
    dJ = creal.solve(A, rhs)                            # (K, 4N, 8B, 2)
    return dJ.reshape(K, 4 * N, 8, B, 2).permute(2, 0, 1, 3, 4)


def dsolutions_all(C, J, n_stations, Dgrad, device="cuda"):
    """Complex host-edge wrapper: (8, K, 4N, B) numpy complex64."""
    Cs, Js, Dgs = _complex_in(device, C, J, Dgrad)
    return creal.fuse(dsolutions_all_sr(Cs, Js, n_stations, Dgs))


def dsolutions(C, J, n_stations, Dgrad, r, device="cuda"):
    """Single-r variant (reference Dsolutions, calibration_tools.py:680-725):
    (K, 4N, B) numpy complex64."""
    return dsolutions_all(C, J, n_stations, Dgrad, device=device)[r]


def _dresiduals_lhs_sr(Cs, Js, n_stations):
    """Shared lhs blocks -(C_sum Jq^H)^T per (k, b): ((K, B, 2, 2, 2),
    p_idx)."""
    B = n_stations * (n_stations - 1) // 2
    K = Cs.shape[0]
    C5 = Cs.reshape(K, -1, B, 2, 2, 2).transpose(-3, -2)
    Csum = torch.sum(C5, dim=1)
    J4 = _jones_blocks_sr(Js, n_stations)
    p_idx, q_idx = baseline_indices(n_stations, Cs.device)
    inner = creal.einsum("kbuv,kbwv->kbuw", Csum, creal.conj(J4[:, q_idx]))
    return -inner.transpose(-3, -2), p_idx


def _dresiduals_blocks_sr(Cs, Js, n_stations, dJs):
    """Per-direction fillvex blocks (8, K, B, 2, 2, B, 2)."""
    B = dJs.shape[3]
    K = Cs.shape[0]
    lhs, p_idx = _dresiduals_lhs_sr(Cs, Js, n_stations)
    # dJ rows {2p, 2p+1} and {2N+2p, 2N+2p+1}: (8, K, 2, N, 2, B, 2)
    rhs = dJs.reshape(8, K, 2, n_stations, 2, B, 2)[:, :, :, p_idx]
    # fillvex[2i+u, c] = sum_j lhs[i,j] rhs[j, u, c]
    return creal.einsum("kbij,rkjbuc->rkbiuc", lhs, rhs)


def _selfterm(device="cpu"):
    """addself: dVpq_r at rows 4b + r//2, phase by parity: (8, 4, 2) f32."""
    sel = np.zeros((8, 4, 2), dtype=np.float32)
    for r in range(8):
        sel[r, r // 2, r % 2] = 1.0
    return torch.as_tensor(sel, device=device)


def _add_selfterm(dR, sel, B):
    """dR (..., 4B, B, 2) with ``sel`` (..., 4, 2) scatter-added at rows
    4b + pol of column b, in place."""
    bidx = torch.arange(B, device=dR.device)
    rows = 4 * bidx[:, None] + torch.arange(4, device=dR.device)[None, :]
    lead = dR.dim() - 3
    vals = sel.movedim(-2, 0).unsqueeze(0).expand((B,) + (4,)
                                                  + tuple(sel.shape[:-2])
                                                  + (2,))
    return _scatter_add(dR, (lead, lead + 1), (rows, bidx[:, None]), vals)


def dresiduals_all_sr(Cs, Js, n_stations, dJs, addself=True):
    """dR (8, 4B, B, 2): residual derivatives summed over directions k,
    averaged over B*T.  Reference: Dresiduals_r,
    calibration_tools.py:1028-1075."""
    B = n_stations * (n_stations - 1) // 2
    K = Cs.shape[0]
    T = Cs.shape[1] // B
    fv = _dresiduals_blocks_sr(Cs, Js, n_stations, dJs).sum(dim=1)
    dR = fv.reshape(8, 4 * B, B, 2)
    if addself:
        _add_selfterm(dR, _selfterm(Cs.device) * (K * T), B)
    return dR / (B * T)


def dresiduals_all(C, J, n_stations, dJ, addself=True, device="cuda"):
    """Complex host-edge wrapper: (8, 4B, B) numpy complex64."""
    Cs, Js, dJs = _complex_in(device, C, J, dJ)
    return creal.fuse(dresiduals_all_sr(Cs, Js, n_stations, dJs,
                                        addself=addself))


def dresiduals_colmeans_sr(Cs, Js, n_stations, dJs, addself=True,
                           perdir=False):
    """Column means over the row-baseline axis of dR without building it:
    (8, 4, B, 2), or (8, K, 4, B, 2) with ``perdir``.  dR's row baseline b
    enters only through its station p(b), so the mean over rows is a
    segment sum of the lhs blocks onto stations, then one einsum against
    dJ."""
    B = n_stations * (n_stations - 1) // 2
    K = Cs.shape[0]
    T = Cs.shape[1] // B
    lhs, p_idx = _dresiduals_lhs_sr(Cs, Js, n_stations)  # (K, B, i, j, 2)
    # G[k, n, i, j] = sum over baselines b with p(b) = n of lhs[k, b, i, j]
    G = _segment_sum(lhs.transpose(0, 1), p_idx, n_stations).transpose(0, 1)
    dJ6 = dJs.reshape(8, K, 2, n_stations, 2, B, 2)    # (r,k,j,n,u,c,2)
    # float normalizers: B^2 T overflows int32 at N >= 256
    bbt = float(B) * B * T
    bb = float(B) * B
    sel = _selfterm(Cs.device)
    if perdir:
        out = creal.einsum("knij,rkjnuc->rkiuc", G, dJ6)
        out = out.reshape(8, K, 4, B, 2) / bbt
        if addself:
            # each column of dR has one contributing row: the mean adds
            # 1/B^2
            out = out + (sel / bb)[:, None, :, None, :]
    else:
        out = creal.einsum("knij,rkjnuc->riuc", G, dJ6)
        out = out.reshape(8, 4, B, 2) / bbt
        if addself:
            out = out + (sel * K / bb)[:, :, None, :]
    return out


def influence_colmeans_opt_sr(Cs, Js, n_stations, Dgs, addself=False,
                              perdir=False, precision="f32"):
    """Dsolutions -> Dresiduals column means (8, 4, B, 2), or
    (8, K, 4, B, 2) with ``perdir``, straight from the coherencies, the
    Jones solutions and the consensus-augmented Hessian ``Dgs``: the
    optimized chain's adjoint 4-RHS transpose solve
    (:func:`_colmeans_adjoint_core_sr`), equal to
    ``dsolutions_all_sr`` -> ``dresiduals_colmeans_sr`` to round-off.
    ``precision`` narrows the final contraction (row
    ``colmeans_contract``)."""
    B = n_stations * (n_stations - 1) // 2
    K = Cs.shape[0]
    T = Cs.shape[1] // B
    C5 = Cs.reshape(K, -1, B, 2, 2, 2).transpose(-3, -2)
    J4 = _jones_blocks_sr(Js, n_stations)
    q_idx = baseline_indices(n_stations, Cs.device)[1]
    lhs = creal.einsum("kbuv,kbwv->kbuw", J4[:, q_idx],
                       creal.conj(torch.sum(C5, dim=1)))
    out = _colmeans_adjoint_core_sr(
        lhs, Dgs, n_stations, T, perdir=perdir,
        contract_dtype=prec.contraction_dtype("colmeans_contract",
                                              precision))
    if addself:
        sel, bb = _selfterm(Cs.device), float(B) * B
        out = out + ((sel / bb)[:, None, :, None, :] if perdir
                     else (sel * K / bb)[:, :, None, :])
    return out


def dresiduals_all_perdir_sr(Cs, Js, n_stations, dJs, addself=True):
    """dR (8, K, 4B, B, 2), the per-direction variant.  Reference:
    Dresiduals_rk, calibration_tools.py:1129-1176."""
    B = n_stations * (n_stations - 1) // 2
    T = Cs.shape[1] // B
    fv = _dresiduals_blocks_sr(Cs, Js, n_stations, dJs)
    K = fv.shape[1]
    dR = fv.reshape(8, K, 4 * B, B, 2)
    if addself:
        sel = (_selfterm(Cs.device) * T)[:, None].expand(8, K, 4, 2)
        _add_selfterm(dR, sel, B)
    return dR / (B * T)


def dresiduals_all_perdir(C, J, n_stations, dJ, addself=True,
                          device="cuda"):
    """Complex host-edge wrapper: (8, K, 4B, B) numpy complex64."""
    Cs, Js, dJs = _complex_in(device, C, J, dJ)
    return creal.fuse(dresiduals_all_perdir_sr(Cs, Js, n_stations, dJs,
                                               addself=addself))


def dresiduals(C, J, n_stations, dJ_r, addself, r, device="cuda"):
    """Single-r variant (reference Dresiduals, calibration_tools.py:879-925).
    ``dJ_r`` is the (K, 4N, B) complex slice of this r.  Returns (4B, B)
    numpy complex64."""
    dJ_full = np.zeros((8,) + dJ_r.shape, dJ_r.dtype)
    dJ_full[r] = dJ_r
    full = dresiduals_all(C, J, n_stations, dJ_full, addself=False,
                          device=device)[r]
    if addself:
        B = n_stations * (n_stations - 1) // 2
        K = C.shape[0]
        T = C.shape[1] // B
        sel = creal.fuse(_selfterm())[r] * (K * T) / (B * T)
        for b in range(B):
            full[4 * b:4 * b + 4, b] += sel
    return full


def log_likelihood_ratio_sr(Rs, Cs, Js, n_stations):
    """Per-direction LLR (K,) on the kernel-convention operands.
    Reference: calibration_tools.py:1181-1223."""
    R3, C5, B, T, K = _split_samples_sr(Rs, Cs, n_stations)
    J4 = _jones_blocks_sr(Js, n_stations)
    p_idx, q_idx = baseline_indices(n_stations, Rs.device)
    return _llr_core_sr(R3, C5, J4[:, p_idx], J4[:, q_idx])


def log_likelihood_ratio(R, C, J, n_stations, device="cuda"):
    """Complex host-edge wrapper: (K,) numpy float32."""
    return log_likelihood_ratio_sr(*_complex_in(device, R, C, J),
                                   n_stations).cpu().numpy()
