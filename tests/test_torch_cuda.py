"""Tests of the port that need an NVIDIA GPU (``cuda`` marker).  They skip
without one.  This file imports nothing of JAX, so it also runs on a
machine with the GPU and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import numpy as np
import pytest
import torch

from smartcal_tpu_torch.ops import dft_imager

RTOL, ATOL = 2e-4, 2e-5      # tests/test_pallas_imager.py


def _case(seed, R, freq=150e6):
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-2e3, 2e3, size=(R, 3)).astype(np.float32)
    vis = rng.standard_normal((R, 2)).astype(np.float32)
    uv = np.abs(uvw[:, :2] * np.float32(freq / 2.99792458e8)).max()
    return uvw, vis, np.float32(freq), 1.0 / (6.0 * max(float(uv), 1.0))


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for npix, R in ((32, 700), (128, 5000)):
        uvw, vis, freq, cell = _case(npix, R)
        u = torch.from_numpy(uvw).cuda()
        v = torch.from_numpy(vis).cuda()
        before = dft_imager.launches
        out = dft_imager.dirty_image(u, v, freq, cell, npix=npix)
        assert dft_imager.launches == before + 1
        scale = torch.tensor(dft_imager.uv_scale(freq), device="cuda")
        ref = dft_imager.dirty_image_reference(
            (u[:, :2] * scale).contiguous(),
            dft_imager.pixel_grid(npix, cell, "cuda"), v)
        np.testing.assert_allclose(out.reshape(-1).cpu().numpy(),
                                   ref.cpu().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_graphed_line_search_matches_eager_on_gpu():
    """The solver's CUDA-graph replay of the quartic line search gives the
    eager search's steps, call after call (the graph's input is refilled)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from smartcal_tpu_torch.cal import solver
    from smartcal_tpu_torch.ops import lbfgs
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    search = solver._QuarticLineSearch(6, torch.float32, dev)
    for _ in range(3):
        c = rng.standard_normal((6, 5)).astype(np.float32)
        c[:, 0] = np.abs(c[:, 0]) + 1.0          # phi(0) > 0
        c[:, 1] = -np.abs(c[:, 1]) - 0.1         # descent: phi'(0) < 0
        c[:, 4] = np.abs(c[:, 4]) + 0.1          # bounded below
        coeffs = torch.from_numpy(c).to(dev)
        want = lbfgs.strong_wolfe_cubic(solver._quartic_phi(coeffs), 6,
                                        device=dev)
        got = search(coeffs)
        assert torch.equal(got, want)
