"""Dirty imaging: visibilities -> sky image (counterpart of
smartcal_tpu/cal/imager.py).

Two formulations, as in the JAX package:

* the direct DFT ``dirty_image_sr`` — img[p] = mean_r Re(V_r exp(-i phi)),
  the data/residual images behind every reward and the oracle chain's
  influence images.  It is the hand-written CUDA kernel of
  ``ops/dft_imager.py`` on a CUDA tensor, and that module's plain version
  on a CPU tensor.  ``dirty_image_sr_xla`` is the plain version on either
  device (the JAX package's XLA formulation, under its name): it runs
  only where a caller asks for it;
* the rank-factored DFT ``dirty_image_factored_sr`` — the influence-map
  imager: per-axis trig planes and two (npix, R) @ (R, npix) matmuls.
  From npix >= 512 its planes reach GB scale, and
  ``dirty_image_factored_large_sr`` takes over: the hand-written CUDA
  kernel of ``ops/factored_imager.py`` on a CUDA tensor, the R-blocked
  plain version ``dirty_image_factored_blocked_sr`` on a CPU tensor.

The factored imager takes ``precision`` (``cal/precision`` row
``imager_matmul``): "bf16" rounds the four planes to bf16 before the
matmuls, which accumulate in f32; the planes' trig stays f32.  The direct
DFT has no precision argument: the data and residual images stay f32.
"""

import numpy as np
import torch

from smartcal_tpu_torch.cal import precision as prec
from smartcal_tpu_torch.obs import costs
from smartcal_tpu_torch.ops import dft_imager, factored_imager

C_LIGHT = 2.99792458e8


def pixel_grid(npix, cell, device="cpu"):
    """(npix^2, 2) direction cosines (l, m), row-major with m fastest."""
    return dft_imager.pixel_grid(npix, cell, device)


def default_cell(uvw, freq, oversample=3.0):
    """Pixel size (rad) from the longest projected baseline:
    cell = 1 / (oversample * 2 * max|uv|_wavelengths)."""
    uv = uvw[..., :2] * (float(freq) / C_LIGHT)
    umax = float(torch.max(torch.abs(uv)))
    return 1.0 / (oversample * 2.0 * max(umax, 1.0))


def dirty_image_sr(uvw, vis, freq, cell, npix=128):
    """Dirty image (npix, npix) from split-real Stokes visibilities:
    uvw (R, 3) meters, vis (R, 2).  Goes through ``ops.dft_imager`` (the
    CUDA kernel for CUDA tensors)."""
    return dft_imager.dirty_image(uvw, vis, freq, cell, npix=npix)


def dirty_image_sr_xla(uvw, vis, freq, cell, npix=128):
    """:func:`dirty_image_sr` in its plain formulation on the device of
    ``uvw``, never the kernel: the direct DFT of
    ``dft_imager.dirty_image_reference``."""
    uv = uvw[:, :2] * torch.tensor(dft_imager.uv_scale(freq),
                                   dtype=uvw.dtype, device=uvw.device)
    return dft_imager.dirty_image_reference(
        uv, pixel_grid(npix, cell, uvw.device), vis).reshape(npix, npix)


def _factored_planes(uvw, vis, freq, cell, npix):
    """(p1, p2, cb, sb) planes of the factored imager, f32 trig.  uvw
    (..., R, 3) and vis (..., R, 2) may carry leading lane axes; ``freq``
    and ``cell`` are then host arrays that broadcast against them (a
    scalar is one value for all).  Planes (..., npix, R)."""
    dev = uvw.device
    scale = torch.as_tensor(dft_imager.uv_scale(np.asarray(freq)),
                            device=dev)[..., None]
    u = uvw[..., 0] * scale
    v = uvw[..., 1] * scale
    cell = torch.as_tensor(np.asarray(cell, np.float32), device=dev)
    idx = factored_imager.axis_grid(npix, 1.0, dev) * cell[..., None]
    a = idx[..., :, None] * u[..., None, :]                # (npix, R) l u
    b = idx[..., :, None] * v[..., None, :]                # (npix, R) m v
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    vr, vi = vis[..., None, :, 0], vis[..., None, :, 1]
    p1 = ca * vr + sa * vi
    p2 = ca * vi - sa * vr
    return p1, p2, cb, sb


def _factored_contract(p1, p2, cb, sb, precision):
    """The two (npix, R) @ (R, npix) matmuls, f32 accumulation.  Under
    ``precision="bf16"`` (policy row ``imager_matmul``) the four planes are
    first rounded to bf16 (``precision.narrow``); under "f32" they are
    contracted as they are."""
    dt = prec.contraction_dtype("imager_matmul", precision)
    p1, p2, cb, sb = (prec.narrow(x, dt) for x in (p1, p2, cb, sb))
    return p1 @ cb.transpose(-1, -2) + p2 @ sb.transpose(-1, -2)


def dirty_image_factored_sr(uvw, vis, freq, cell, npix=128,
                            precision="f32"):
    """Rank-factored DFT image: the pixel grid is separable, so
    cos/sin(l u + m v) expand by the angle-addition identity and the image
    is img = [(cos a Vr + sin a Vi) @ cos(b)^T
              + (cos a Vi - sin a Vr) @ sin(b)^T] / R,  a = l u, b = m v.
    Same math as the direct DFT to float round-off; the matmuls run in
    full f32 (TF32 is off).  ``precision="bf16"`` narrows the matmuls'
    operands (the planes' trig stays f32).  Leading lane axes as in
    :func:`_factored_planes`: (..., npix, npix), batched matmuls."""
    p1, p2, cb, sb = _factored_planes(uvw, vis, freq, cell, npix)
    return _factored_contract(p1, p2, cb, sb, precision) / vis.shape[-2]


def dirty_image_factored_blocked_sr(uvw, vis, freq, cell, npix=1024,
                                    block_r=4096, precision="f32"):
    """R-blocked :func:`dirty_image_factored_sr` (the npix >= 512 tier): a
    loop over blocks of ``block_r`` samples accumulates the image in f32,
    so the largest live buffer is one (npix, block_r) plane.  R is
    zero-padded to the block (pad vis rows are 0 and add nothing).  Same
    math to float round-off; the plain version of the kernel in
    ``ops/factored_imager.py``, of its bf16 mode with
    ``precision="bf16"``."""
    R = uvw.shape[0]
    nblk = -(-R // block_r)
    padr = nblk * block_r - R
    uvp = torch.cat([uvw, uvw.new_zeros((padr, uvw.shape[1]))])
    visp = torch.cat([vis, vis.new_zeros((padr, 2))])
    img = torch.zeros((npix, npix), dtype=prec.F32, device=uvw.device)
    for i in range(nblk):
        s = slice(i * block_r, (i + 1) * block_r)
        p1, p2, cb, sb = _factored_planes(uvp[s], visp[s], freq, cell, npix)
        img = img + _factored_contract(p1, p2, cb, sb, precision)
    return img / R


def dirty_image_factored_large_sr(uvw, vis, freq, cell, npix=1024,
                                  block_r=4096, precision="f32"):
    """The npix >= 512 factored imager: the CUDA kernel for CUDA tensors
    (any npix and R; its bf16 mode with ``precision="bf16"``),
    :func:`dirty_image_factored_blocked_sr` for CPU tensors.  Any other
    device raises.  Either path adds the image's analytic work to an
    ``obs.costs`` count (``dft_imager.image_cost``)."""
    if uvw.device.type not in ("cuda", "cpu"):
        raise ValueError(f"factored_imager: unsupported device "
                         f"{uvw.device}")
    with costs.kernel_cost(*dft_imager.image_cost(npix, uvw.shape[0])):
        if uvw.device.type == "cuda":
            return factored_imager.dirty_image_factored_cuda(
                uvw, vis, freq, cell, npix=npix, precision=precision)
        return dirty_image_factored_blocked_sr(uvw, vis, freq, cell,
                                               npix=npix, block_r=block_r,
                                               precision=precision)


def stokes_i_vis(V):
    """(..., T, B, 2, 2, 2) full-pol solver visibilities -> (..., T*B, 2)
    Stokes I."""
    sI = 0.5 * (V[..., 0, 0, :] + V[..., 1, 1, :])
    return sI.reshape(sI.shape[:-3] + (-1, 2))


def image_observation_sr(uvw, V, freq, cell, npix=128):
    """Dirty Stokes-I image of solver-convention visibilities
    (uvw (T, B, 3), V (T, B, 2, 2, 2))."""
    return dirty_image_sr(uvw.reshape(-1, 3), stokes_i_vis(V).contiguous(),
                          freq, cell, npix=npix)


def multifreq_image_sr(uvw, V_list, freqs, cell, npix=128):
    """Mean dirty image over frequency sub-bands (calmean.sh's role);
    V_list (Nf, T, B, 2, 2, 2), uvw shared across sub-bands (meters).
    One imager launch per band."""
    imgs = [image_observation_sr(uvw, V_list[f], f_hz, cell, npix=npix)
            for f, f_hz in enumerate(torch.as_tensor(freqs).tolist())]
    return torch.mean(torch.stack(imgs), dim=0)


def image_noise_std(img):
    """sigma of an image, the env observation statistic (calibenv.py:148-166
    reads np.std of the FITS data): the population std."""
    return torch.std(img, correction=0)


def image_to_fits(path, img, obs, freq=None, cell=None, **kw):
    """Write an image to a radio FITS file with the observation's WCS
    (``cal/fits_io.write_image``).  ``freq`` defaults to the highest
    sub-band (the one ``default_cell`` sizes pixels for), ``cell`` to
    ``default_cell``."""
    from smartcal_tpu_torch.cal import fits_io

    freqs = np.asarray(torch.as_tensor(obs.freqs).cpu())
    freq = float(freqs[-1]) if freq is None else float(freq)
    cell = (float(default_cell(torch.as_tensor(obs.uvw), freq))
            if cell is None else float(cell))
    return fits_io.write_image(
        path, torch.as_tensor(img).detach().cpu().numpy(),
        ra0=float(obs.ra0), dec0=float(obs.dec0), cell_rad=cell, freq=freq,
        **kw)
