"""CPU tests of kernel 2's bf16 launch geometry (``ops/factored_imager.
bf16_plan``) and of the walk its operand producer uses, in plain numpy.
The kernel itself runs only on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest

from smartcal_tpu_torch.ops import dft_imager, factored_imager

N_SM = 132                                   # an H100 SXM
CASES = [(1024, 652800), (1000, 100003), (640, 5003), (200, 1001),
         (100, 5003), (100, 5), (128, 37820), (1, 1)]


@pytest.mark.parametrize("npix,R", CASES)
def test_bf16_plan_grid_covers_every_tile_once(npix, R):
    plan = factored_imager.bf16_plan(npix, R, N_SM)
    cols, rows, z = plan.grid
    assert (cols - 1) * factored_imager.BF16_TILE_COLS < npix \
        <= cols * factored_imager.BF16_TILE_COLS
    assert (rows - 1) * factored_imager.BF16_TILE_ROWS < npix \
        <= rows * factored_imager.BF16_TILE_ROWS
    assert z == plan.n_split
    # one block per SM: the tiles times the splits fill the card once
    assert plan.n_split == 1 or cols * rows * plan.n_split <= N_SM


@pytest.mark.parametrize("npix,R", CASES)
def test_bf16_plan_chunks_cover_r_once_in_whole_stages(npix, R):
    plan = factored_imager.bf16_plan(npix, R, N_SM)
    assert plan.chunk % factored_imager.BF16_STAGE_SAMPLES == 0
    # chunk z is [z chunk, min(R, (z + 1) chunk)): every sample once, and
    # no chunk empty (each block writes its slice of the partial images)
    assert (plan.n_split - 1) * plan.chunk < R <= plan.n_split * plan.chunk
    assert factored_imager._bf16_split(npix, R, N_SM) == (plan.n_split,
                                                          plan.chunk)


def test_bf16_plan_at_the_ska_shapes():
    """4 x 8 tiles of 128 x 256 pixels times 4 chunks: 128 blocks on 132
    SMs, 5,100 stages each."""
    assert factored_imager.bf16_plan(1024, 652800, N_SM) == (
        (4, 8, 4), 4, 163200)


@pytest.mark.parametrize("npix,R,want", [
    (1024, 652800, (2, 326400)),
    (128, 37820, (132, 288)),
    (640, 5003, (5, 1008)),
    (100, 5, (1, 16)),
])
def test_split_plan_of_the_f32_engine_is_unchanged(npix, R, want):
    """The f32 engine keeps its own geometry (and so its bits)."""
    assert dft_imager.split_plan(npix, R, N_SM) == want
    assert factored_imager.split_plan is dft_imager.split_plan


def _walk(z0, theta, sign, n):
    """The producer's walk in float32: z_1 = z_0 e^{sign i theta}, then
    z_{j+1} = 2 cos(theta) z_j - z_{j-1} per part."""
    f32 = np.float32
    c, s = np.cos(theta).astype(f32), (sign * np.sin(theta)).astype(f32)
    ar, ai = z0.real.astype(f32), z0.imag.astype(f32)
    br, bi = ar * c - ai * s, ar * s + ai * c
    tc = f32(2) * c
    out = []
    for _ in range(n):
        out.append(ar + 1j * ai.astype(np.float64))
        ar, ai, br, bi = br, bi, tc * br - ar, tc * bi - ai
    return np.stack(out)


@pytest.mark.parametrize("n_walk", [8, 16])
def test_bf16_walk_stays_at_f32_round_off(n_walk):
    """The three-term walk that makes the bf16 kernel's operands stays
    within 2e-5 of the exact phasors over a walk of 8 (rows) or 16
    (columns) steps of 8 cells, at steps from ~0 to pi (its round-off grows
    at most as j^2 2^-24), and moves a small share of the bf16 roundings
    of p1, p2 against the directly computed f32 values."""
    rng = np.random.default_rng(0)
    n = 4096
    theta = np.concatenate([rng.uniform(0, 1e-3, n // 4),
                            rng.uniform(0, np.pi, 3 * n // 4)])
    phase0 = rng.uniform(-500.0, 500.0, n)            # SKA-like l u
    v = rng.standard_normal(n) + 1j * rng.standard_normal(n)
    z0 = (np.exp(-1j * phase0) * v).astype(np.complex64)   # rows: conj . v
    got = _walk(z0, theta.astype(np.float32), -1.0, n_walk)
    j = np.arange(n_walk)[:, None]
    exact = z0.astype(np.complex128) * np.exp(-1j * j * theta)
    rel = np.abs(got - exact) / np.abs(v)
    assert rel.max() < 2e-5, rel.max()
    # the bf16 roundings: the walk's against the f32 phasors'
    direct = exact.astype(np.complex64)

    def bf16(x):
        b = np.asarray(x, np.float32).view(np.uint32)
        b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
        return b.view(np.float32)

    flips = np.mean(bf16(got.real) != bf16(direct.real))
    assert flips < 0.02, flips
