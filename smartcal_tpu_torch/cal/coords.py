"""Spherical-astronomy transforms (the part of smartcal_tpu/cal/coords.py
that the observation module uses).

Computed in float32, as the JAX package computes them (python floats are
weakly typed there and become f32), so the above-horizon rejection test
in ``observation.find_valid_target`` takes the same branches.
"""

import math

import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def azel_from_radec(ra, dec, lst, lat):
    """Azimuth/elevation of (ra, dec) for local sidereal time ``lst`` and
    geodetic latitude ``lat`` (all radians, float32 math)."""
    ra, dec, lst, lat = _f32(ra), _f32(dec), _f32(lst), _f32(lat)
    ha = lst - ra
    sin_el = (torch.sin(dec) * torch.sin(lat)
              + torch.cos(dec) * torch.cos(lat) * torch.cos(ha))
    el = torch.arcsin(torch.clamp(sin_el, -1.0, 1.0))
    az = torch.atan2(
        -torch.cos(dec) * torch.sin(ha),
        torch.sin(dec) * torch.cos(lat)
        - torch.cos(dec) * torch.sin(lat) * torch.cos(ha))
    az = torch.where(az < 0, az + 2 * math.pi, az)
    return az, el
