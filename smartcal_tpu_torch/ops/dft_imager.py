"""Direct-DFT dirty imager: the CUDA kernel ``csrc/dft_imager.cu`` and its
plain PyTorch version.

Replaces the Pallas TPU kernel smartcal_tpu/ops/pallas_imager.py
``_imager_kernel`` (wrapper ``dirty_image_pallas``):

    img[p] = (1/R) sum_r [cos(phi_pr) v_re[r] + sin(phi_pr) v_im[r]],
    phi_pr = l_p u_r + m_p v_r,   reduced mod 2 pi before the trig.

On the card the kernel is bound by the SFU sine/cosine rate: at 16 results
per clock per SM on sm_90, the 2 P R ~ 1.24e9 transcendentals of one band
at P = 16384, R = 37820 take >= ~0.3 ms on an H100 SXM (derived from the
data sheet, not measured; memory traffic is ~0.6 MB per band, negligible).
The kernel loops over R inside each block and splits R across the grid,
with a second fixed-order pass over the partial sums (no atomics); see the
source for the design.

:func:`dirty_image` launches the kernel for CUDA tensors and raises if the
build or the launch fails; it runs :func:`dirty_image_reference` only for
tensors that lie on the CPU.  ``launches`` counts kernel launches.
"""

import ctypes
import math

import numpy as np
import torch

C_LIGHT = 2.99792458e8
F32 = torch.float32
THREADS = 256            # threads per block = samples per R tile
PIX_PER_THREAD = 2       # pixels per thread (csrc/dft_imager.cu kPix)
WAVE_BLOCKS_PER_SM = 8   # 256-thread blocks resident per SM (2048 threads)

#: kernel launches so far (one per image); only the CUDA path counts
launches = 0

_argtypes_set = False


def uv_scale(freq) -> np.float32:
    """2 pi f / c in float32, computed as the JAX package computes it."""
    return np.float32(2.0 * math.pi) * np.float32(freq) / np.float32(C_LIGHT)


def pixel_grid(npix, cell, device="cpu"):
    """(npix^2, 2) direction cosines (l, m) of the image pixels; row-major
    with m varying fastest; centered, north up."""
    half = npix // 2
    idx = (torch.arange(npix, device=device) - half).to(F32) * cell
    ll, mm = torch.meshgrid(idx, idx, indexing="ij")
    return torch.stack([ll.reshape(-1), mm.reshape(-1)], dim=-1)


def dirty_image_reference(uv, lm, vis, chunk=2048):
    """Plain PyTorch version of the kernel: uv (R, 2) scaled, lm (P, 2),
    vis (R, 2) -> (P,).  The phase is materialised in R-chunks and reduced
    mod 2 pi exactly like the kernel."""
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


def split_plan(P, R, n_sm):
    """(n_split, chunk): split R so the pass-1 grid fills one wave of
    resident blocks, in chunks that are whole 256-sample tiles."""
    p_blocks = -(-P // (THREADS * PIX_PER_THREAD))
    n_split = max(1, min((WAVE_BLOCKS_PER_SM * n_sm) // p_blocks,
                         -(-R // THREADS)))
    chunk = -(-(-(-R // n_split)) // THREADS) * THREADS
    return -(-R // chunk), chunk


def _lib():
    global _argtypes_set
    from smartcal_tpu_torch.ops import build

    lib = build.load("dft_imager")
    if not _argtypes_set:
        p = ctypes.c_void_p
        lib.dft_image_launch.argtypes = [p, p, p, p, p, ctypes.c_int,
                                         ctypes.c_int, ctypes.c_int,
                                         ctypes.c_int, p]
        lib.dft_image_launch.restype = ctypes.c_int
        lib.dft_image_error_string.argtypes = [ctypes.c_int]
        lib.dft_image_error_string.restype = ctypes.c_char_p
        _argtypes_set = True
    return lib


def dirty_image_cuda(uv, lm, vis):
    """Launch the kernel on CUDA tensors uv (R, 2), lm (P, 2), vis (R, 2),
    all float32 and contiguous, on the current stream.  Returns (P,)."""
    global launches
    for name, t in (("uv", uv), ("lm", lm), ("vis", vis)):
        if t.device.type != "cuda" or t.dtype != F32 or t.dim() != 2 \
                or t.shape[1] != 2 or not t.is_contiguous():
            raise ValueError(f"dft_imager: {name} must be a contiguous "
                             f"(n, 2) float32 CUDA tensor, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    if not (uv.device == lm.device == vis.device) or \
            uv.shape[0] != vis.shape[0]:
        raise ValueError("dft_imager: uv/vis length or device mismatch")
    P, R = lm.shape[0], uv.shape[0]
    if R == 0:
        raise ValueError("dft_imager: no visibilities")
    dev = uv.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n_split, chunk = split_plan(P, R, n_sm)
    partial = torch.empty((n_split, P), dtype=F32, device=dev)
    out = torch.empty(P, dtype=F32, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.dft_image_launch(lm.data_ptr(), uv.data_ptr(),
                                  vis.data_ptr(), partial.data_ptr(),
                                  out.data_ptr(), P, R, n_split, chunk,
                                  stream)
    if rc != 0:
        raise RuntimeError("dft_imager launch failed: "
                           + lib.dft_image_error_string(rc).decode())
    launches += 1
    return out


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
    lm = pixel_grid(npix, cell, uvw.device)
    if uvw.device.type == "cuda":
        img = dirty_image_cuda(uv, lm, vis.contiguous())
    elif uvw.device.type == "cpu":
        img = dirty_image_reference(uv, lm, vis)
    else:
        raise ValueError(f"dft_imager: unsupported device {uvw.device}")
    return img.reshape(npix, npix)
