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
from smartcal_tpu_torch.cal import creal
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


def _per_baseline_sp_sq(C5, Jp, Jq):
    """Per-baseline Sp, Sq (K, B, 8): the einsums of the plain version
    before its one-hot station sums."""
    A1 = creal.einsum("ktbuv,kbwv->ktbuw", C5, creal.conj(Jq))
    Sp = creal.einsum("ktbuw,ktbvw->kbuv", A1, creal.conj(A1))
    A2 = creal.einsum("kbuv,ktbvw->ktbuw", Jp, C5)
    Sq = creal.einsum("ktbuv,ktbuw->kbvw", creal.conj(A2), A2)
    K, B = Sp.shape[0], Sp.shape[1]
    return Sp.reshape(K, B, 8), Sq.reshape(K, B, 8)


def _subset_indices(n_stations):
    """Every third baseline of the full set, then 5 sentinel slots."""
    p, q = np.triu_indices(n_stations, 1)
    sel = np.arange(1, p.size, 3)
    pad = np.full(5, n_stations)
    return np.concatenate([p[sel], pad]), np.concatenate([q[sel], pad])


@pytest.mark.parametrize("case", ["full-6", "full-20", "full-256",
                                  "subset-6", "subset-20"])
def test_schedule_reproduces_plain_dsum(case):
    """The kernel's station reduction, applied in PyTorch to per-baseline
    Sp/Sq (cell rows and columns, then each station's partial rows in
    ``st_off`` order), gives the plain version's Dsum.  N=256 is the SKA
    tier's full set (K=1, Td=1 keeps it small); the subsets carry sentinel
    stations, which must add nothing."""
    kind, n = case.split("-")
    N = int(n)
    if kind == "full":
        p, q = np.triu_indices(N, 1)
        sched = hessian_blocks.full_schedule(N, "cpu")[0]
    else:
        p, q = _subset_indices(N)
        sched = hessian_blocks.subset_schedule(torch.from_numpy(p),
                                               torch.from_numpy(q), N, "cpu")
    K, Td = (1, 1) if N == 256 else (3, 2)
    rng = np.random.default_rng(N)
    C5, R3, Jp, Jq = _t(*(rng.standard_normal(s).astype(np.float32)
                          for s in ((K, Td, p.size, 2, 2, 2),
                                    (Td, p.size, 2, 2, 2),
                                    (K, p.size, 2, 2, 2),
                                    (K, p.size, 2, 2, 2))))
    _, dsum_ref = tkernels._hessian_block_sums(
        R3, C5, Jp, Jq, torch.from_numpy(p), torch.from_numpy(q), N)
    Sp, Sq = _per_baseline_sp_sq(C5, Jp, Jq)
    dsum = hessian_blocks.combine(Sp, Sq, sched, N)
    np.testing.assert_allclose(dsum.numpy(), dsum_ref.reshape(K, N, 8),
                               rtol=RTOL, atol=ATOL * float(
                                   dsum_ref.abs().max()))


@pytest.mark.parametrize("n_stations", [6, 20, 21])
def test_full_schedule_tables(n_stations):
    """Full-set tiles: every baseline in exactly one cell, a cell row is
    one p-station and a column one q-station, and each station's partial
    rows run p side first, then q side, each in tile order (N=21 leaves a
    partial block on both station axes)."""
    N = n_stations
    R, C = hessian_blocks.ROWS, hessian_blocks.COLS
    p, q = np.triu_indices(N, 1)
    cells = hessian_blocks.full_cells(N)
    assert cells.shape[1] == R * C == 64
    live = cells[cells >= 0]
    assert np.array_equal(np.sort(live), np.arange(p.size))
    slot_dst, st_off, n_rows = hessian_blocks.schedule(cells, p, q, N)
    assert slot_dst.shape == (cells.shape[0], R + C)
    assert st_off[0] == 0 and st_off[-1] == n_rows
    assert np.all(np.diff(st_off) > 0)
    assert np.array_equal(np.sort(slot_dst[slot_dst >= 0]),
                          np.arange(n_rows))

    def line(t, s):     # the live baselines of slot s of tile t
        c = cells[t].reshape(R, C)
        x = c[s, :] if s < R else c[:, s - R]
        return x[x >= 0]

    station = {(t, s): int((p if s < R else q)[line(t, s)[0]])
               for t in range(cells.shape[0]) for s in range(R + C)
               if slot_dst[t, s] >= 0}
    for (t, s), n in station.items():
        assert np.all((p if s < R else q)[line(t, s)] == n)
    for n in range(N):
        mine = sorted((s >= R, t, int(slot_dst[t, s]))
                      for (t, s), m in station.items() if m == n)
        assert [r[2] for r in mine] == list(range(st_off[n], st_off[n + 1]))


def test_subset_schedule_skips_sentinels():
    """Subset layout: one baseline per row and column; the sentinel
    baselines (station N) own cells but write no partial row."""
    N = 7
    p, q = _subset_indices(N)
    cells = hessian_blocks.subset_cells(p.size)
    slot_dst, st_off, n_rows = hessian_blocks.schedule(cells, p, q, N)
    assert n_rows == 2 * (p.size - 5)
    assert st_off[-1] == n_rows
    flat = cells.reshape(-1, 8, 8)
    for b in range(p.size):
        t, i = divmod(b, 8)
        assert flat[t, i, i] == b
        assert (slot_dst[t, i] >= 0) == (p[b] < N)
        assert (slot_dst[t, 8 + i] >= 0) == (q[b] < N)
    with pytest.raises(ValueError):
        hessian_blocks.schedule(hessian_blocks.full_cells(8),
                                np.zeros(28, np.int64),
                                np.arange(28), 8)


def test_schedules_built_once_per_stations_and_device():
    """The full set's schedule and indices, and the placement tail's
    off-diagonal map, are built once per (N, device) and reused."""
    a = hessian_blocks.full_schedule(12, "cpu")
    assert hessian_blocks.full_schedule(12, torch.device("cpu")) is a
    assert hessian_blocks.full_schedule(13, "cpu") is not a
    sched, p, q = a
    assert sched.cell_b.dtype == sched.slot_dst.dtype == torch.int32
    assert torch.equal(p, torch.from_numpy(np.triu_indices(12, 1)[0]))
    m = tkernels._offdiag_index(12, "cpu")
    assert tkernels._offdiag_index(12, torch.device("cpu")) is m
    assert torch.equal(m, torch.from_numpy(tkernels.offdiag_index_map(12)))
