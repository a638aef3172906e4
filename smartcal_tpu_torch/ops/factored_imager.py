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

The TPU kernel's bf16 mode (``precision="bf16"``, policy row
``imager_matmul`` of ``cal/precision``) rounds p1, p2, cos b and sin b to
bf16 and accumulates in f32.  Its counterpart is the entry point
``factored_image_bf16_launch`` of the same source: the same trig and
phase reduction, the four operands rounded to nearest even, one bf16
``wgmma`` per 16-deep k-step where 3xTF32 takes three.  It is bound by
operations too: >= 2.77 ms for the 4 npix^2 R flops at the 989 TFLOP/s
dense BF16 rate at those shapes.  The engine remakes, in each of the
(npix/128)^2 output tiles, the trig of its 128 rows and 128 columns for
every sample (~5 ms on the SFUs at those shapes), so the trig, not the
tensor cores, sets its time (see the source).

:func:`dirty_image_factored_cuda` launches the kernel of the mode that
``precision`` names and raises if the build or the launch fails.  Its
plain version is ``cal/imager.dirty_image_factored_blocked_sr`` with the
same ``precision`` (this module sits below ``cal/imager``, which imports
it); ``cal/imager.dirty_image_factored_large_sr`` picks between the two by
the tensors' device.  ``launches`` counts the f32 mode's launches and
``launches_bf16`` the bf16 mode's.
"""

import torch

from smartcal_tpu_torch.cal import precision as prec
from smartcal_tpu_torch.ops import dft_imager
from smartcal_tpu_torch.ops.dft_imager import axis_grid, split_plan  # noqa: F401

F32 = torch.float32

#: kernel launches so far (one per image) of the f32 mode and of the bf16
#: mode; only the CUDA path counts
launches = 0
launches_bf16 = 0

#: the C entry point of each mode (``<prefix>_launch``)
ENTRY = {"f32": "factored_image", "bf16": "factored_image_bf16"}

_argtypes_set = False


def _lib():
    global _argtypes_set
    from smartcal_tpu_torch.ops import build

    lib = build.load("factored_imager")
    if not _argtypes_set:
        for prefix in ENTRY.values():
            dft_imager.bind(lib, prefix)
        _argtypes_set = True
    return lib


def dirty_image_factored_cuda(uvw, vis, freq, cell, npix=1024,
                              precision="f32"):
    """Factored dirty image (npix, npix) of CUDA float32 tensors uvw (R, 3)
    meters and vis (R, 2), launched on the current stream, in the mode
    ``precision`` names ("f32" or "bf16").  Any npix and R: the ragged
    edges are masked in the kernel."""
    global launches, launches_bf16
    mode = prec.check(precision)
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
    out = dft_imager.engine_image(_lib(), ENTRY[mode], uv, vis, npix, cell)
    if mode == "bf16":
        launches_bf16 += 1
    else:
        launches += 1
    return out
