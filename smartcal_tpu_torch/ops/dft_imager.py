"""Dirty imager: the CUDA kernel ``csrc/dft_imager.cu`` and its plain
PyTorch version, and the Python side of the separable-grid engine
(``csrc/separable_imager.cuh``) that this kernel and ``ops/factored_imager``
share.

Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_imager.py
``_imager_kernel`` (wrapper ``dirty_image_pallas``):

    img[p] = (1/R) sum_r [cos(phi_pr) v_re[r] + sin(phi_pr) v_im[r]],
    phi_pr = l_p u_r + m_p v_r,   reduced mod 2 pi before the trig.

The TPU wrapper only images the separable grid l_i = m_i =
(i - npix/2) cell, so the kernel evaluates the image by angle addition as
one GEMM of depth 2R whose trig operands are made on chip, on the TF32
tensor cores in 3xTF32 (see the engine's source).  Evaluated directly the
image needs 2 P R sine/cosine values (>= 327 ms at P = 1024^2, R = 652800
on an H100 SXM, from the data sheet); the GEMM is >= 16.6 ms there.
:func:`dirty_image_reference`, the direct DFT, stays the definition the
kernel is held against.

:func:`dirty_image` launches the kernel for CUDA tensors and raises if the
build or the launch fails; it runs :func:`dirty_image_reference` only for
tensors that lie on the CPU.  ``launches`` counts kernel launches.
:func:`image_cost` is the image's analytic work (the bound of PERF.md's
kernel table), which :func:`dirty_image` adds to an ``obs.costs`` count
on either path.
"""

import ctypes
import math

import numpy as np
import torch

from smartcal_tpu_torch.obs import costs

C_LIGHT = 2.99792458e8
F32 = torch.float32
TILE = 128               # output rows = columns per block (engine kTile)
STAGE_SAMPLES = 16       # samples per pipeline stage (engine kSamples)

#: kernel launches so far (one per image); only the CUDA path counts
launches = 0

_argtypes_set = False


def uv_scale(freq) -> np.float32:
    """2 pi f / c in float32, computed as the JAX package computes it."""
    return np.float32(2.0 * math.pi) * np.float32(freq) / np.float32(C_LIGHT)


def axis_grid(npix, cell, device="cpu"):
    """(npix,) direction cosines of one image axis, centred: both l (rows)
    and m (columns) of the separable pixel grid."""
    half = npix // 2
    return (torch.arange(npix, device=device) - half).to(F32) * cell


def pixel_grid(npix, cell, device="cpu"):
    """(npix^2, 2) direction cosines (l, m) of the image pixels; row-major
    with m varying fastest; centered, north up."""
    idx = axis_grid(npix, cell, device)
    ll, mm = torch.meshgrid(idx, idx, indexing="ij")
    return torch.stack([ll.reshape(-1), mm.reshape(-1)], dim=-1)


def dirty_image_reference(uv, lm, vis, chunk=2048):
    """Plain PyTorch version of the kernel: uv (R, 2) scaled, lm (P, 2),
    vis (R, 2) -> (P,).  The phase is materialised in R-chunks and reduced
    mod 2 pi exactly like the TPU kernel."""
    R = uv.shape[0]
    two_pi = torch.tensor(2.0 * math.pi, dtype=F32, device=uv.device)
    out = torch.zeros(lm.shape[0], dtype=F32, device=uv.device)
    for r0 in range(0, R, chunk):
        u, v = uv[r0:r0 + chunk, 0], uv[r0:r0 + chunk, 1]
        ph = lm[:, 0:1] * u[None, :] + lm[:, 1:2] * v[None, :]
        ph = ph - two_pi * torch.round(ph / two_pi)
        out = out + (torch.cos(ph) @ vis[r0:r0 + chunk, 0]
                     + torch.sin(ph) @ vis[r0:r0 + chunk, 1])
    return out / R


def split_plan(npix, R, n_sm):
    """(n_split, chunk) of the engine: R split so that the output tiles
    times the splits fill the card's SMs once (one block per SM), in chunks
    of whole stages."""
    tiles = (-(-npix // TILE)) ** 2
    n_split = max(1, min(n_sm // tiles, -(-R // STAGE_SAMPLES)))
    chunk = -(-(-(-R // n_split)) // STAGE_SAMPLES) * STAGE_SAMPLES
    return -(-R // chunk), chunk


def bind(lib, prefix):
    """Set the ctypes signatures of an engine entry point ``<prefix>_launch``
    and its ``<prefix>_error_string``; returns the library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = getattr(lib, f"{prefix}_launch")
    launch.argtypes = [p, p, p, p, i, i, i, i, p]
    launch.restype = ctypes.c_int
    err = getattr(lib, f"{prefix}_error_string")
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def engine_image(lib, prefix, uv, vis, npix, cell, plan=split_plan):
    """(npix, npix) image of CUDA float32 uv (R, 2) scaled and vis (R, 2)
    through the engine entry point ``<prefix>_launch`` of ``lib``, on the
    current stream, R split by ``plan(npix, R, n_sm)`` -> (n_split,
    chunk); raises if the launch fails."""
    dev = uv.device
    R = uv.shape[0]
    axis = axis_grid(npix, cell, dev)
    samples = torch.cat([uv, vis], 1).contiguous()   # one float4 per sample
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, chunk = plan(npix, R, n_sm)
    partial = torch.empty((n_split, npix, npix), dtype=F32, device=dev)
    out = torch.empty((npix, npix), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, f"{prefix}_launch")(
            axis.data_ptr(), samples.data_ptr(), partial.data_ptr(),
            out.data_ptr(), npix, R, n_split, chunk, stream)
    if rc != 0:
        raise RuntimeError(f"{prefix} launch failed: " + getattr(
            lib, f"{prefix}_error_string")(rc).decode())
    return out


def _lib():
    global _argtypes_set
    from smartcal_tpu_torch.ops import build

    lib = build.load("dft_imager")
    if not _argtypes_set:
        bind(lib, "dft_image")
        _argtypes_set = True
    return lib


def dirty_image_cuda(uv, vis, npix, cell):
    """Launch the kernel on contiguous float32 CUDA tensors uv (R, 2)
    scaled and vis (R, 2), on the current stream: the (npix, npix) image
    of the grid ``axis_grid(npix, cell)``.  Any npix and R: the ragged
    edges are masked in the kernel."""
    global launches
    for name, t in (("uv", uv), ("vis", vis)):
        if t.device.type != "cuda" or t.dtype != F32 or t.dim() != 2 \
                or t.shape[1] != 2 or not t.is_contiguous():
            raise ValueError(f"dft_imager: {name} must be a contiguous "
                             f"(R, 2) float32 CUDA tensor, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if uv.device != vis.device or uv.shape[0] != vis.shape[0]:
        raise ValueError("dft_imager: uv/vis length or device mismatch")
    if uv.shape[0] == 0 or npix <= 0:
        raise ValueError("dft_imager: no visibilities or no pixels")
    out = engine_image(_lib(), "dft_image", uv, vis, npix, cell)
    launches += 1
    return out


def image_cost(npix, R):
    """(flops, bytes) of one separable-grid image of R samples: the
    4 npix^2 R flops of the GEMM, uvw and vis read once and the image
    written once (shared with ``ops/factored_imager``)."""
    P = npix * npix
    return 4.0 * P * R, R * 3 * 4 + R * 2 * 4 + P * 4


def dirty_image(uvw, vis, freq, cell, npix=128):
    """Dirty image (npix, npix) from uvw (R, 3) meters and split-real
    vis (R, 2): the kernel for CUDA tensors, the plain version for CPU
    tensors.  Any other device raises."""
    if uvw.dim() != 2 or uvw.shape[1] != 3 or vis.dim() != 2 \
            or vis.shape[1] != 2 or uvw.shape[0] != vis.shape[0]:
        raise ValueError(f"dft_imager: uvw (R, 3) and vis (R, 2) expected, "
                         f"got {tuple(uvw.shape)} and {tuple(vis.shape)}")
    if uvw.dtype != F32 or vis.dtype != F32:
        raise ValueError("dft_imager: float32 inputs expected")
    if uvw.device != vis.device:
        raise ValueError("dft_imager: uvw and vis on different devices")
    scale = torch.tensor(uv_scale(freq), dtype=F32, device=uvw.device)
    uv = (uvw[:, :2] * scale).contiguous()
    if uvw.device.type not in ("cuda", "cpu"):
        raise ValueError(f"dft_imager: unsupported device {uvw.device}")
    with costs.kernel_cost(*image_cost(npix, uvw.shape[0])):
        if uvw.device.type == "cuda":
            img = dirty_image_cuda(uv, vis.contiguous(), npix, cell)
        else:
            img = dirty_image_reference(uv, pixel_grid(npix, cell), vis)
    return img.reshape(npix, npix)
