"""Blocked residual-Hessian pieces of the PyTorch port vs the JAX package.

The port's ``_hessian_block_sums`` (subset indices with sentinels) and its
blocked core ``_hessian_res_core_blocked_sr`` are the plain versions of the
CUDA kernel ``ops/hessian_blocks``; they are held against JAX
``kernels._hessian_block_sums``, the Pallas kernel in interpret mode
(``pallas_hessian.hessian_block_sums_pallas``), and the JAX blocked and
unblocked cores.  Inputs come from numpy with a seed.

Tolerance rtol 2e-4 / atol 2e-5, the Pallas Hessian gate's
(tests/test_pallas_hessian.py): the block and station sums are
reassociated float32 sums of unit-scale operands.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import kernels as jkernels
from smartcal_tpu.ops import pallas_hessian
from smartcal_tpu_torch.cal import kernels as tkernels
from smartcal_tpu_torch.ops import hessian_blocks

RTOL, ATOL = 2e-4, 2e-5


def _operands(n_stations, K=3, Td=4, seed=0):
    rng = np.random.default_rng(seed)
    B = n_stations * (n_stations - 1) // 2
    R3 = rng.standard_normal((Td, B, 2, 2, 2)).astype(np.float32)
    C5 = rng.standard_normal((K, Td, B, 2, 2, 2)).astype(np.float32)
    p, q = np.triu_indices(n_stations, 1)
    J4 = rng.standard_normal((K, n_stations, 2, 2, 2)).astype(np.float32)
    return R3, C5, J4[:, p], J4[:, q], p, q


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("n_stations", [6, 20])
def test_block_sums_match_jax_and_pallas_interpret(n_stations):
    """N=6: one ragged 128-baseline Pallas tile; N=20: two tiles with 66 pad
    slots."""
    R3, C5, Jp, Jq, p, q = _operands(n_stations)
    off_ref, dsum_ref = jkernels._hessian_block_sums(
        R3, C5, Jp, Jq, jnp.asarray(p), jnp.asarray(q), n_stations)
    off_pl, dsum_pl = pallas_hessian.hessian_block_sums_pallas(
        R3, C5, Jp, Jq, p, q, n_stations, interpret=True)
    off, dsum = tkernels._hessian_block_sums(*_t(R3, C5, Jp, Jq, p, q),
                                             n_stations)
    for ref in (off_ref, off_pl):
        np.testing.assert_allclose(off.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
    for ref in (dsum_ref, dsum_pl):
        np.testing.assert_allclose(dsum.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


@pytest.mark.parametrize("n_stations", [6, 20])
def test_block_sums_subset_with_sentinels(n_stations):
    """A baseline subset padded with sentinel station N (zero operands)
    gives the JAX subset sums, and the sentinels add nothing."""
    R3, C5, Jp, Jq, p, q = _operands(n_stations, seed=3)
    sel = np.arange(1, p.size, 3)
    pad = 5
    p_s = np.concatenate([p[sel], np.full(pad, n_stations)])
    q_s = np.concatenate([q[sel], np.full(pad, n_stations)])

    def sub(x, axis):
        x = np.take(x, sel, axis=axis)
        shape = list(x.shape)
        shape[axis] = pad
        return np.concatenate([x, np.zeros(shape, np.float32)], axis=axis)

    args = (sub(R3, 1), sub(C5, 2), sub(Jp, 1), sub(Jq, 1))
    off_ref, dsum_ref = jkernels._hessian_block_sums(
        *args, jnp.asarray(p_s), jnp.asarray(q_s), n_stations)
    off, dsum = tkernels._hessian_block_sums(*_t(*args, p_s, q_s),
                                             n_stations)
    np.testing.assert_allclose(off.numpy(), np.asarray(off_ref), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(dsum.numpy(), np.asarray(dsum_ref), rtol=RTOL,
                               atol=ATOL)
    onehot = tkernels._block_onehot(torch.from_numpy(p_s), n_stations,
                                    torch.float32)
    assert onehot.shape == (n_stations, p_s.size)
    assert torch.all(onehot[:, -pad:] == 0)


@pytest.mark.parametrize("block", [5, 8, 64])
def test_blocked_core_matches_jax_cores(block):
    """Ragged blocks (B=28 at N=8: 5 and 8 leave a tail; 64 > B is one
    block) against the JAX blocked and unblocked cores."""
    N = 8
    R3, C5, Jp, Jq, _, _ = _operands(N, K=2, Td=3, seed=1)
    ref_blk = jkernels._hessian_res_core_blocked_sr(R3, C5, Jp, Jq, N, block)
    ref_unb = jkernels._hessian_res_core_sr(R3, C5, Jp, Jq, N)
    out = tkernels._hessian_res_core_blocked_sr(*_t(R3, C5, Jp, Jq), N, block)
    assert out.shape == (2, 4 * N, 4 * N, 2)
    for ref in (ref_blk, ref_unb):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)


def test_kernel_module_cpu_path_is_plain_version():
    """On CPU tensors ``ops.hessian_blocks`` runs the plain version and
    launches nothing; its core equals the JAX Pallas-fronted core."""
    N = 8
    R3, C5, Jp, Jq, _, _ = _operands(N, K=2, Td=3, seed=2)
    before = hessian_blocks.launches
    out = hessian_blocks.hessian_res_core_sr(*_t(R3, C5, Jp, Jq), N)
    assert hessian_blocks.launches == before
    ref = pallas_hessian.hessian_res_core_pallas_sr(R3, C5, Jp, Jq, N,
                                                    interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_station_csr_orders_and_skips_sentinels():
    """The kernel's CSR lists: each station's baselines in ascending order,
    sentinel slots past the last offset."""
    p, q = np.triu_indices(5, 1)
    q_s = torch.from_numpy(np.concatenate([q, [5, 5]]))
    perm, offsets = hessian_blocks.station_csr(q_s, 5)
    assert offsets.tolist() == [0, 0, 1, 3, 6, 10]
    for n in range(5):
        got = perm[offsets[n]:offsets[n + 1]].tolist()
        assert got == sorted(np.flatnonzero(q == n).tolist())
    assert sorted(perm[10:].tolist()) == [10, 11]


@pytest.mark.parametrize("n_stations", [6, 20])
def test_full_csr_matches_station_csr(n_stations):
    """The host-built lists of the full baseline set are the ones the
    wrapper would build from the indices."""
    p, q = (torch.from_numpy(i) for i in np.triu_indices(n_stations, 1))
    want = hessian_blocks.station_csr(p, n_stations) \
        + hessian_blocks.station_csr(q, n_stations)
    got = hessian_blocks.full_csr(n_stations, "cpu")
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        assert torch.equal(g, w)
