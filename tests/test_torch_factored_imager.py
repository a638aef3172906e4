"""Large-tier factored imager of the PyTorch port vs the JAX package.

The port's ``dirty_image_factored_blocked_sr`` is the plain version of the
CUDA kernel ``ops/factored_imager``; ``dirty_image_factored_large_sr`` runs
it for CPU tensors.  Both are held against JAX
``dirty_image_factored_blocked_sr``, ``dirty_image_factored_sr`` and the
Pallas kernel in interpret mode (``dirty_image_factored_pallas``) at
npix=128 with a ragged R (700 samples: not a multiple of the 256-sample
block nor of the Pallas R tile).  Inputs come from numpy with a seed.

Tolerance rtol 2e-4 / atol 2e-4 * max|ref|, the factored Pallas gate's
(tests/test_nscale_kernels.py): the Pallas kernel reduces the phase mod
2 pi before the trig and the plain versions do not, so the trig differs
at f32 round-off of ~1e2-rad phases, and the R sum is reassociated.
"""

import numpy as np
import pytest
import torch

from smartcal_tpu.cal import imager as jimager
from smartcal_tpu.ops import pallas_imager
from smartcal_tpu_torch.cal import imager as timager
from smartcal_tpu_torch.ops import dft_imager, factored_imager

NPIX, R = 128, 700
RTOL, ATOL_SCALE = 2e-4, 2e-4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    uvw = rng.uniform(-2e3, 2e3, size=(R, 3)).astype(np.float32)
    vis = rng.standard_normal((R, 2)).astype(np.float32)
    freq = 150e6
    cell = jimager.default_cell(uvw, freq)
    refs = {
        "jax_blocked": np.asarray(jimager.dirty_image_factored_blocked_sr(
            uvw, vis, freq, cell, npix=NPIX, block_r=256)),
        "jax_factored": np.asarray(jimager.dirty_image_factored_sr(
            uvw, vis, freq, cell, npix=NPIX)),
        "pallas_interpret": np.asarray(
            pallas_imager.dirty_image_factored_pallas(
                uvw, vis, freq, cell, npix=NPIX, interpret=True)),
    }
    return uvw, vis, freq, cell, refs


def _close(out, ref):
    np.testing.assert_allclose(out, ref, rtol=RTOL,
                               atol=ATOL_SCALE * np.max(np.abs(ref)))


@pytest.mark.parametrize("ref_name",
                         ["jax_blocked", "jax_factored", "pallas_interpret"])
def test_blocked_plain_matches_jax(case, ref_name):
    uvw, vis, freq, cell, refs = case
    out = timager.dirty_image_factored_blocked_sr(
        torch.from_numpy(uvw), torch.from_numpy(vis), freq, cell, npix=NPIX,
        block_r=256)
    assert out.shape == (NPIX, NPIX)
    _close(out.numpy(), refs[ref_name])


@pytest.mark.parametrize("ref_name",
                         ["jax_blocked", "jax_factored", "pallas_interpret"])
def test_large_dispatch_on_cpu_runs_plain(case, ref_name):
    """CPU tensors take the blocked plain version; no kernel launch."""
    uvw, vis, freq, cell, refs = case
    before = factored_imager.launches
    out = timager.dirty_image_factored_large_sr(
        torch.from_numpy(uvw), torch.from_numpy(vis), freq, cell, npix=NPIX,
        block_r=256)
    assert factored_imager.launches == before
    _close(out.numpy(), refs[ref_name])


def test_split_plan_covers_r_in_whole_tiles():
    """The kernel's split of R (the engine's, shared with dft_imager):
    whole 16-sample stages, every sample in one chunk, one block per SM."""
    for npix, r in ((1024, 652800), (128, 700), (1000, 17), (32, 5000)):
        n_split, chunk = factored_imager.split_plan(npix, r, 132)
        assert chunk % dft_imager.STAGE_SAMPLES == 0
        assert (n_split - 1) * chunk < r <= n_split * chunk
        assert (-(-npix // dft_imager.TILE)) ** 2 * n_split <= 132
    assert factored_imager.split_plan(1024, 652800, 132) == (2, 326400)
