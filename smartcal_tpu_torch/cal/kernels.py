"""Residual Hessian, adjoint influence column means and the LLR detector:
the unblocked, formulation-optimized chain of smartcal_tpu/cal/kernels.py.

Shapes follow the JAX package (and the reference calibration_tools.py):
N stations, B = N(N-1)/2 baselines (p < q row-major), T timeslots of one
interval, K directions, split-real (..., 2) complex.  The scatter-free
moves are kept: station sums are one-hot matmuls and the off-diagonal
block placement is a gather of a zero-padded table, so every reduction
has a fixed order on the GPU.  The blocked (SKA-scale) Hessian core is
here too: its per-subset block sums are the plain version of the CUDA
kernel in ``ops/hessian_blocks.py``.
"""

import numpy as np
import torch

from smartcal_tpu_torch.cal import creal

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
    lead, K, B = lhs.shape[:-5], lhs.shape[-5], lhs.shape[-4]
    dev, dt = lhs.device, lhs.dtype
    onehot_p = baseline_onehots(N, dt, dev)[0]
    # G[k, n, i, j] = sum over baselines with p(b) = n of -conj(lhs)
    G = torch.einsum("nb,...kbijz->...knijz", onehot_p, -creal.conj(lhs))
    eye2 = torch.eye(2, dtype=dt, device=dev)
    W = torch.einsum("...knijz,vu->...kjnviuz", G, eye2).reshape(
        lead + (K, 4 * N, 4, 2))
    A = Dgs.clone()
    A[..., 0] += EPS_SINGULAR * torch.eye(4 * N, dtype=dt, device=dev)
    Y = creal.solve(A.transpose(-3, -2), W)              # A^T y = w

    # gather y at each baseline's p station, contract against lhs
    bbt = float(B) * B * T      # float: the int product overflows at N>=256
    p_idx = baseline_indices(N, dev)[0]
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
