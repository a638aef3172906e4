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
``imager_matmul`` of ``cal/precision``; ``_factored_kernel`` with ``dt`` =
bf16, pallas_imager.py:159 and :176-178) rounds p1, p2, cos b and sin b to
bf16 and accumulates in f32.  Its counterpart is the entry point
``factored_image_bf16_launch`` of the same source, a kernel of its own: the
four operands rounded to nearest even, one bf16 ``wgmma`` per 16-deep
k-step with both operands in shared memory.  It is bound by operations:
>= 2.77 ms for the 4 npix^2 R flops at the 989 TFLOP/s dense BF16 rate at
those shapes.  Remaking the trig of a tile's rows and columns for every
sample would cost the SFUs twice the tensor cores' time, so the kernel
walks the uniform grid instead: per sample and run of 8 rows (16 columns)
two reduced sine/cosine pairs start a three-term recurrence of two FFMAs
per element.  A producer warpgroup makes the operands into a ring of
stages while two consumer warpgroups only issue the products, so the trig
and the FP32 work run beside the tensor cores; the 128 x 256 output tile
keeps the shared-memory traffic per flop low (see the source).  Its launch
geometry is :func:`bf16_plan`.

:func:`dirty_image_factored_cuda` launches the kernel of the mode that
``precision`` names and raises if the build or the launch fails.  Its
plain version is ``cal/imager.dirty_image_factored_blocked_sr`` with the
same ``precision`` (this module sits below ``cal/imager``, which imports
it); ``cal/imager.dirty_image_factored_large_sr`` picks between the two by
the tensors' device.  ``launches`` counts the f32 mode's launches and
``launches_bf16`` the bf16 mode's.
"""

from typing import NamedTuple

import torch

from smartcal_tpu_torch.cal import precision as prec
from smartcal_tpu_torch.ops import dft_imager
from smartcal_tpu_torch.ops.dft_imager import (  # noqa: F401
    axis_grid, split_plan)

F32 = torch.float32
# the bf16 kernel's output tile (kRows x kCols) and stage (kSamples)
BF16_TILE_ROWS, BF16_TILE_COLS, BF16_STAGE_SAMPLES = 128, 256, 32

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


class Bf16Plan(NamedTuple):
    """Launch geometry of the bf16 kernel's first pass."""
    grid: tuple      # (column tiles, row tiles, n_split) blocks
    n_split: int     # R chunks, one per grid z
    chunk: int       # samples per chunk, whole stages


def bf16_plan(npix, R, n_sm):
    """The bf16 kernel's :class:`Bf16Plan`: one block per SM (384 threads,
    ~193 KB of shared memory) for each output tile of BF16_TILE_ROWS x
    BF16_TILE_COLS pixels and chunk of R, R split until the tiles times
    the splits fill the card's ``n_sm`` SMs once, in chunks of whole
    32-sample stages, none of them empty (the f32 engine's
    :func:`split_plan` takes 128 x 128 tiles and 16-sample stages)."""
    tiles = (-(-npix // BF16_TILE_COLS), -(-npix // BF16_TILE_ROWS))
    n_split = max(1, min(n_sm // (tiles[0] * tiles[1]),
                         -(-R // BF16_STAGE_SAMPLES)))
    chunk = -(-(-(-R // n_split)) // BF16_STAGE_SAMPLES) * BF16_STAGE_SAMPLES
    n_split = -(-R // chunk)
    return Bf16Plan((*tiles, n_split), n_split, chunk)


def _bf16_split(npix, R, n_sm):
    plan = bf16_plan(npix, R, n_sm)
    return plan.n_split, plan.chunk


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
    out = dft_imager.engine_image(
        _lib(), ENTRY[mode], uv, vis, npix, cell,
        plan=_bf16_split if mode == "bf16" else split_plan)
    if mode == "bf16":
        launches_bf16 += 1
    else:
        launches += 1
    return out
