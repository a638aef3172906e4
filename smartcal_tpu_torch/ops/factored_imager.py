"""Tiled rank-factored DFT imager: the CUDA kernel ``csrc/factored_imager.cu``
and its wrapper.

Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_imager.py
``_factored_kernel`` (wrapper ``dirty_image_factored_pallas``):

    img = [(cos a Vr + sin a Vi) @ cos(b)^T + (cos a Vi - sin a Vr) @ sin(b)^T]
          / R,   a = l u, b = m v,   both reduced mod 2 pi before the trig.

It is the influence-map imager from npix >= 512, where the (npix, R) trig
planes of the unblocked form reach GB scale.  On the card the kernel is
bound by its 4 npix^2 R FP32 FMA flops (>= 41 ms per band at npix=1024,
R=652800 on an H100 SXM, from the data sheet); the planes are made tile by
tile in shared memory and never reach device memory (see the source).

:func:`dirty_image_factored_cuda` launches the kernel and raises if the
build or the launch fails.  Its plain version is
``cal/imager.dirty_image_factored_blocked_sr`` (this module sits below
``cal/imager``, which imports it); ``cal/imager.dirty_image_factored_large_sr``
picks between the two by the tensors' device.  ``launches`` counts kernel
launches.
"""

import ctypes

import torch

from smartcal_tpu_torch.ops import dft_imager

F32 = torch.float32
TILE = 128               # output tile (csrc/factored_imager.cu kTile)
R_TILE = 16              # samples per shared R tile (kRT)
BLOCKS_PER_SM = 2        # resident 256-thread blocks per SM

#: kernel launches so far (one per image); only the CUDA path counts
launches = 0

_argtypes_set = False


def axis_grid(npix, cell, device="cpu"):
    """(npix,) direction cosines of one image axis, centred: both l (rows)
    and m (columns) of the separable pixel grid."""
    half = npix // 2
    return (torch.arange(npix, device=device) - half).to(F32) * cell


def split_plan(npix, R, n_sm):
    """(n_split, chunk): split R so the grid fills the resident blocks of
    the card once, in chunks that are whole R tiles."""
    tiles = (-(-npix // TILE)) ** 2
    n_split = max(1, min((BLOCKS_PER_SM * n_sm) // tiles, -(-R // R_TILE)))
    chunk = -(-(-(-R // n_split)) // R_TILE) * R_TILE
    return -(-R // chunk), chunk


def _lib():
    global _argtypes_set
    from smartcal_tpu_torch.ops import build

    lib = build.load("factored_imager")
    if not _argtypes_set:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.factored_image_launch.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.factored_image_launch.restype = ctypes.c_int
        lib.factored_image_error_string.argtypes = [ctypes.c_int]
        lib.factored_image_error_string.restype = ctypes.c_char_p
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
    R = uvw.shape[0]
    if R == 0 or npix <= 0:
        raise ValueError("factored_imager: no visibilities or no pixels")
    dev = uvw.device
    scale = float(dft_imager.uv_scale(freq))
    uv = (uvw[:, :2] * scale).contiguous()
    axis = axis_grid(npix, cell, dev)
    vis = vis.contiguous()
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, chunk = split_plan(npix, R, n_sm)
    partial = torch.empty((n_split, npix, npix), dtype=F32, device=dev)
    out = torch.empty((npix, npix), dtype=F32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.factored_image_launch(axis.data_ptr(), uv.data_ptr(),
                                       vis.data_ptr(), partial.data_ptr(),
                                       out.data_ptr(), npix, R, n_split,
                                       chunk, stream)
    if rc != 0:
        raise RuntimeError("factored_imager launch failed: "
                           + lib.factored_image_error_string(rc).decode())
    launches += 1
    return out
