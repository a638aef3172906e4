"""Arithmetic of the port's separable-grid imaging engine
(``csrc/separable_imager.cuh``), which both ``ops/dft_imager`` and
``ops/factored_imager`` launch.  The engine runs only on a GPU; these tests
hold what it computes on the CPU, with inputs from numpy with a seed:

* the separable evaluation (``cal/imager.dirty_image_factored_sr``) against
  the direct DFT at the DFT's tolerance (rtol 2e-4, atol 2e-5 mean|vis|,
  tests/test_pallas_imager.py): against the JAX Pallas kernel in interpret
  mode at npix=64, and against the port's plain version on 4096 pixels of a
  1024^2 image whose phases reach ~1e3 rad (LOFAR-scale uvw, default cell);
* a torch emulation of the engine's 3xTF32 product (operands split by
  Veltkamp's method as the kernel splits them, the small part read by the
  tensor cores as its top 11 bits) against the f32 plain image, at the DFT
  and the factored tolerances, and a plain 1xTF32 product (cvt.rna of
  each operand) at least 10x further off: why the split is there;
* the split of R over the card and the build's hash of the shared header.
"""

import numpy as np
import pytest
import torch

from smartcal_tpu.cal import imager as jimager
from smartcal_tpu.ops import pallas_imager
from smartcal_tpu_torch.cal import imager as timager
from smartcal_tpu_torch.ops import build, dft_imager, factored_imager

RTOL, ATOL_VIS = 2e-4, 2e-5          # DFT: atol = ATOL_VIS * mean|vis|
ATOL_MAX = 2e-4                      # factored: atol = ATOL_MAX * max|ref|


def _case(seed, R, freq=150e6):
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-2e3, 2e3, size=(R, 3)).astype(np.float32)
    vis = rng.standard_normal((R, 2)).astype(np.float32)
    return uvw, vis, freq, jimager.default_cell(uvw, freq)


def _dft_close(out, ref, vis):
    np.testing.assert_allclose(out, ref, rtol=RTOL,
                               atol=ATOL_VIS * np.abs(vis).mean())


def test_separable_matches_pallas_dft_interpret():
    uvw, vis, freq, cell = _case(21, 700)
    ref = np.asarray(pallas_imager.dirty_image_pallas(
        uvw, vis, freq, cell, npix=64, interpret=True))
    out = timager.dirty_image_factored_sr(torch.from_numpy(uvw),
                                          torch.from_numpy(vis), freq, cell,
                                          npix=64)
    _dft_close(out.numpy(), ref, vis)


def test_separable_matches_direct_dft_at_ska_phases():
    """npix=1024 with +-2 km baselines: |phase| reaches ~1e3 rad, where the
    separable form reduces a and b apart and the direct DFT their sum."""
    npix, R = 1024, 3000
    uvw, vis, freq, cell = _case(22, R)
    u, v = torch.from_numpy(uvw), torch.from_numpy(vis)
    uv = u[:, :2] * torch.tensor(dft_imager.uv_scale(freq))
    half_width = (npix // 2) * cell
    assert float(uv.abs().max()) * half_width > 500.0
    img = timager.dirty_image_factored_sr(u, v, freq, cell, npix=npix)
    sub = torch.from_numpy(np.random.default_rng(0).permutation(
        npix * npix)[:4096])
    ref = dft_imager.dirty_image_reference(
        uv, dft_imager.pixel_grid(npix, cell)[sub], v)
    _dft_close(img.reshape(-1)[sub].numpy(), ref.numpy(), vis)


def _bits(x):
    return x.view(torch.int32)


def split_big(x):
    """The kernel's split_tf32: Veltkamp's splitting at 2^13 + 1."""
    t = x * 8193.0
    return t - (t - x)


def tensor_core_read(x):
    """What a TF32 tensor core reads of an f32 operand: its top 11
    significant bits (the low 13 mantissa bits dropped)."""
    return (_bits(x) & ~0x1FFF).view(torch.float32)


def rna_tf32(x):
    """cvt.rna.tf32.f32 by mantissa mask: round to nearest, ties away."""
    return ((_bits(x) + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.fixture(scope="module")
def tf32_images():
    npix, R = 64, 2000
    uvw, vis, freq, cell = _case(23, R)
    p1, p2, cb, sb = timager._factored_planes(
        torch.from_numpy(uvw), torch.from_numpy(vis), freq, cell, npix)
    A, B = torch.cat([p1, p2], 1), torch.cat([cb, sb], 1)
    a_big, b_big = split_big(A), split_big(B)
    a_small, b_small = tensor_core_read(A - a_big), tensor_core_read(B - b_big)

    def gemm(x, y):          # products exact, accumulated in float64
        return x.double() @ y.double().T

    three = ((gemm(a_small, b_big) + gemm(a_big, b_small)
              + gemm(a_big, b_big)) / R).float().numpy()
    one = (gemm(rna_tf32(A), rna_tf32(B)) / R).float().numpy()
    plain = ((p1 @ cb.T + p2 @ sb.T) / R).numpy()
    return dict(three=three, one=one, plain=plain, vis=vis)


def test_split_big_is_tf32_and_exact():
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        100000).astype(np.float32))
    big = split_big(x)
    assert bool(((_bits(big) & 0x1FFF) == 0).all())
    assert torch.equal(big + (x - big), x)
    # round to nearest: cvt.rna's value but at exact ties
    assert float((big == rna_tf32(x)).float().mean()) > 0.999


@pytest.mark.parametrize("tolerance", ["dft", "factored"])
def test_3xtf32_holds_tolerances_and_1xtf32_does_not(tf32_images, tolerance):
    three, one, plain = (tf32_images[k] for k in ("three", "one", "plain"))
    if tolerance == "dft":
        _dft_close(three, plain, tf32_images["vis"])
    else:
        np.testing.assert_allclose(three, plain, rtol=RTOL,
                                   atol=ATOL_MAX * np.abs(plain).max())
    err3 = np.abs(three - plain).max()
    err1 = np.abs(one - plain).max()
    assert err1 >= 10.0 * err3, (err1, err3)


@pytest.mark.parametrize("npix,R,want", [
    (1024, 652800, (2, 326400)),     # SKA tier: 64 tiles x 2 splits
    (128, 37820, (132, 288)),        # N=62 tier: 1 tile x 132 splits
    (1000, 17, (2, 16)),
    (200, 5, (1, 16)),
])
def test_engine_split_fills_the_card_once(npix, R, want):
    n_split, chunk = dft_imager.split_plan(npix, R, 132)
    assert (n_split, chunk) == want
    assert factored_imager.split_plan(npix, R, 132) == want
    tiles = (-(-npix // dft_imager.TILE)) ** 2
    assert n_split == 1 or tiles * n_split <= 132
    assert chunk % dft_imager.STAGE_SAMPLES == 0
    assert (n_split - 1) * chunk < R <= n_split * chunk


def test_library_path_hashes_shared_headers(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "engine.cuh"\n')
    (tmp_path / "engine.cuh").write_text("// v1\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    (tmp_path / "engine.cuh").write_text("// v2\n")
    assert build.library_path("k") != first
    (tmp_path / "engine.cuh").write_text("// v1\n")
    assert build.library_path("k") == first
    (tmp_path / "k.cu").write_text('#include "engine.cuh"\n// edited\n')
    assert build.library_path("k") != first
