"""Rank-factored imager: the CUDA kernel ``csrc/factored_imager.cu`` and its
wrapper.

Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_imager.py
``_factored_kernel`` (wrapper ``dirty_image_factored_pallas``):

    img = [(cos a Vr + sin a Vi) @ cos(b)^T + (cos a Vi - sin a Vr) @ sin(b)^T]
          / R,   a = l u, b = m v,   both reduced mod 2 pi before the trig.

It is the influence-map imager from npix >= 512, where the (npix, R) trig
planes of the unblocked form reach GB scale.  The kernel is an entry point
of the separable-grid engine it shares with ``ops/dft_imager``
(``csrc/separable_imager.cuh``): the planes are made stage by stage on chip
(rows in registers, columns in shared memory) beside a 3xTF32 tensor-core
GEMM and never reach device memory.  It is bound by its 4 npix^2 R flops:
>= 16.6 ms per band at npix=1024, R=652800 as 3xTF32 at the H100 SXM's
495 TFLOP/s dense TF32 rate (>= 41 ms in FP32 on the CUDA cores), from the
data sheet.

:func:`dirty_image_factored_cuda` launches the kernel and raises if the
build or the launch fails.  Its plain version is
``cal/imager.dirty_image_factored_blocked_sr`` (this module sits below
``cal/imager``, which imports it); ``cal/imager.dirty_image_factored_large_sr``
picks between the two by the tensors' device.  ``launches`` counts kernel
launches.
"""

import torch

from smartcal_tpu_torch.ops import dft_imager
from smartcal_tpu_torch.ops.dft_imager import axis_grid, split_plan  # noqa: F401

F32 = torch.float32

#: kernel launches so far (one per image); only the CUDA path counts
launches = 0

_argtypes_set = False


def _lib():
    global _argtypes_set
    from smartcal_tpu_torch.ops import build

    lib = build.load("factored_imager")
    if not _argtypes_set:
        dft_imager.bind(lib, "factored_image")
        _argtypes_set = True
    return lib


def dirty_image_factored_cuda(uvw, vis, freq, cell, npix=1024):
    """Factored dirty image (npix, npix) of CUDA float32 tensors uvw (R, 3)
    meters and vis (R, 2), launched on the current stream.  Any npix and
    R: the ragged edges are masked in the kernel."""
    global launches
    for name, t, w in (("uvw", uvw, 3), ("vis", vis, 2)):
        if t.device.type != "cuda" or t.dtype != F32 or t.dim() != 2 \
                or t.shape[1] != w:
            raise ValueError(f"factored_imager: {name} must be an (R, {w}) "
                             f"float32 CUDA tensor, got {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}")
    if uvw.device != vis.device or uvw.shape[0] != vis.shape[0]:
        raise ValueError("factored_imager: uvw/vis length or device mismatch")
    if uvw.shape[0] == 0 or npix <= 0:
        raise ValueError("factored_imager: no visibilities or no pixels")
    scale = float(dft_imager.uv_scale(freq))
    uv = uvw[:, :2] * scale
    out = dft_imager.engine_image(_lib(), "factored_image", uv, vis, npix,
                                  cell)
    launches += 1
    return out
