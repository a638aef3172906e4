"""Direct-DFT imager of the PyTorch port vs the JAX package.

The port's plain version (the CPU path of ``ops/dft_imager.dirty_image``)
is held against the Pallas kernel in interpret mode and against the XLA
oracle, at the tolerance tests/test_pallas_imager.py uses for the Pallas
kernel (rtol 2e-4, atol 2e-5: f32 trig and summation order differ).  The
CUDA kernel itself runs only on a GPU (tests/test_torch_cuda.py);
chip_smoke.py holds it against the plain version on the card, and
tests/test_torch_separable_imager.py holds its arithmetic here.
"""

import math

import numpy as np
import pytest
import torch

from smartcal_tpu.cal import imager as jimager
from smartcal_tpu.ops import pallas_imager
from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.cal import imager as timager
from smartcal_tpu_torch.ops import dft_imager

RTOL, ATOL = 2e-4, 2e-5


def _case(seed, R, freq=150e6):
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-2e3, 2e3, size=(R, 3)).astype(np.float32)
    vis = rng.standard_normal((R, 2)).astype(np.float32)
    return uvw, vis, np.float32(freq), jimager.default_cell(uvw, freq)


@pytest.mark.parametrize("npix,R", [(32, 700), (64, 512)],
                         ids=["npix32-padded-R", "npix64-exact-R"])
@pytest.mark.parametrize("oracle", ["pallas_interpret", "xla"])
def test_plain_imager_matches_jax(npix, R, oracle):
    uvw, vis, freq, cell = _case(npix + R, R)
    if oracle == "xla":
        ref = np.asarray(jimager.dirty_image_sr_xla(uvw, vis, freq, cell,
                                                    npix=npix))
    else:
        ref = np.asarray(pallas_imager.dirty_image_pallas(
            uvw, vis, freq, cell, npix=npix, interpret=True))
    out = dft_imager.dirty_image(torch.from_numpy(uvw), torch.from_numpy(vis),
                                 freq, cell, npix=npix)
    assert out.shape == (npix, npix)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_cpu_tensors_take_the_plain_path(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("CPU tensors must not reach the CUDA kernel")

    monkeypatch.setattr(dft_imager, "dirty_image_cuda", no_kernel)
    uvw, vis, freq, cell = _case(3, 300)
    before = dft_imager.launches
    out = timager.dirty_image_sr(torch.from_numpy(uvw),
                                 torch.from_numpy(vis), freq, cell, npix=16)
    scale = torch.tensor(dft_imager.uv_scale(freq))
    ref = dft_imager.dirty_image_reference(
        torch.from_numpy(uvw)[:, :2] * scale,
        dft_imager.pixel_grid(16, cell), torch.from_numpy(vis))
    assert dft_imager.launches == before
    np.testing.assert_array_equal(out.reshape(-1).numpy(), ref.numpy())


def test_kernel_wrapper_rejects_non_cuda_tensors():
    t = torch.zeros((8, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        dft_imager.dirty_image_cuda(t, t, 16, 1e-3)


def test_cuda_device_without_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_pixel_grid_matches_jax():
    cell = 1.3e-4
    np.testing.assert_array_equal(
        dft_imager.pixel_grid(32, cell).numpy(),
        np.asarray(jimager.pixel_grid(32, cell)))


@pytest.mark.parametrize("P,R", [(16384, 37820), (1024, 700), (1024, 10),
                                 (4096, 512)])
def test_split_plan_covers_r_in_whole_tiles(P, R):
    """The engine's split of R for an npix^2 = P image: whole 16-sample
    stages, every sample in one chunk, no more blocks than the card has
    SMs."""
    npix = math.isqrt(P)
    n_split, chunk = dft_imager.split_plan(npix, R, 132)
    assert chunk % dft_imager.STAGE_SAMPLES == 0
    assert n_split * chunk >= R > (n_split - 1) * chunk
    tiles = (-(-npix // dft_imager.TILE)) ** 2
    assert n_split == 1 or tiles * n_split <= 132


def test_factored_imager_matches_jax():
    uvw, vis, freq, cell = _case(5, 600)
    ref = np.asarray(jimager.dirty_image_factored_sr(uvw, vis, freq, cell,
                                                     npix=32))
    out = timager.dirty_image_factored_sr(torch.from_numpy(uvw),
                                          torch.from_numpy(vis), freq, cell,
                                          npix=32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
