"""Spherical-astronomy transforms (counterpart of smartcal_tpu/cal/coords.py).

The JAX package computes these in float32 ``jnp``, and so does this module:
the demixing metadata (separations, azimuths, elevations) and the
above-horizon tests read them, and a float64 version would shift the
metadata and could flip the 1-degree elevation test of the demixing hint.
Where the JAX function first does arithmetic on python or numpy floats
(``lst - ra`` before ``jnp.cos``), that arithmetic is float64 there and is
float64 here; every array argument is rounded to float32 where JAX rounds
it.
"""

import math

import numpy as np
import torch


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


def _any_tensor(*xs):
    return any(isinstance(x, torch.Tensor) for x in xs)


def _diff(a, b):
    """``a - b`` as the JAX package evaluates it before its first jnp call:
    float64 for python/numpy operands, float32 when either is a tensor."""
    if _any_tensor(a, b):
        return _f32(a) - _f32(b)
    return np.asarray(a, np.float64) - np.asarray(b, np.float64)


def radectolm(ra, dec, ra0, dec0):
    """Direction cosines (l, m, n-1) of sources (ra, dec) about the phase
    centre (ra0, dec0); n is the excess path sqrt(1-l^2-m^2) - 1."""
    ra, dec = _f32(ra), _f32(dec)
    # the reference wraps dec0 by 2 pi when dec0 < 0 <= dec (a no-op for
    # sin/cos, kept for the branch's parity)
    dec0 = torch.where((dec0 < 0.0) & (dec >= 0.0),
                       _f32(dec0 + 2.0 * math.pi), _f32(dec0))
    dra = ra - _f32(ra0)
    l = torch.sin(dra) * torch.cos(dec)
    m = -(torch.cos(dra) * torch.cos(dec) * torch.sin(dec0)
          - torch.cos(dec0) * torch.sin(dec))
    n = torch.sqrt(torch.clamp(1.0 - l * l - m * m, min=0.0)) - 1.0
    return l, m, n


def lmtoradec(l, m, ra0, dec0):
    """Inverse of :func:`radectolm` (small-field approximation)."""
    l, m = _f32(l), _f32(m)
    sind0, cosd0 = torch.sin(_f32(dec0)), torch.cos(_f32(dec0))
    d0 = m ** 2 * sind0 ** 2 + l ** 2 - 2.0 * m * cosd0 * sind0
    sind = torch.sqrt(torch.abs(sind0 ** 2 - d0))
    cosd = torch.sqrt(torch.abs(cosd0 ** 2 + d0))
    sind = torch.where(sind0 > 0, torch.abs(sind), -torch.abs(sind))
    dec = torch.atan2(sind, cosd)
    den = cosd0 - m * sind0
    ra = torch.where(l != 0.0, torch.atan2(-l, den),
                     torch.atan2(_f32(1e-10).expand_as(den), den)) \
        + _f32(ra0)
    return ra, dec


def rad_to_ra(rad):
    """Radians -> (hr, min, sec); host python floats."""
    rad = float(rad)
    if rad < 0:
        rad += 2 * np.pi
    v = rad * 12.0 / np.pi
    hr = int(np.floor(v))
    v = (v - hr) * 60
    mins = int(np.floor(v))
    sec = (v - mins) * 60
    return hr % 24, mins % 60, sec


def rad_to_dec(rad):
    """Radians -> (deg, min, sec).  For declinations in (-1, 0) deg the sign
    is carried by the first nonzero field, so :func:`dms_to_rad` round-trips
    (the JAX package's deviation from the reference)."""
    rad = float(rad)
    mult = -1 if rad < 0 else 1
    v = abs(rad) * 180.0 / np.pi
    deg = int(np.floor(v))
    v = (v - deg) * 60
    mins = int(np.floor(v))
    sec = (v - mins) * 60
    deg, mins = deg % 180, mins % 60
    if mult < 0 and deg == 0:
        return 0, -mins, -sec if mins == 0 else sec
    return mult * deg, mins, sec


def hms_to_rad(h, m, s):
    """(hr, min, sec) -> radians (RA convention)."""
    return (h + m / 60.0 + s / 3600.0) * np.pi / 12.0


def dms_to_rad(d, m, s):
    """(deg, min, sec) -> radians (Dec convention), sign carried by the
    first nonzero field."""
    neg = (np.signbit(d) or (d == 0 and (np.signbit(m)
                                         or (m == 0 and np.signbit(s)))))
    sign = -1.0 if neg else 1.0
    return sign * (abs(d) + abs(m) / 60.0 + abs(s) / 3600.0) * np.pi / 180.0


def angular_separation(ra1, dec1, ra2, dec2):
    """Great-circle separation (rad), haversine form, float32."""
    sdlat = torch.sin(_f32(0.5 * _diff(dec2, dec1)))
    sdlon = torch.sin(_f32(0.5 * _diff(ra2, ra1)))
    a = sdlat ** 2 + torch.cos(_f32(dec1)) * torch.cos(_f32(dec2)) \
        * sdlon ** 2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))


def azel_from_radec(ra, dec, lst, lat):
    """Azimuth/elevation of (ra, dec) for local sidereal time ``lst`` and
    geodetic latitude ``lat`` (all radians, float32 math)."""
    ha = _f32(_diff(lst, ra))
    dec, lat = _f32(dec), _f32(lat)
    sin_el = (torch.sin(dec) * torch.sin(lat)
              + torch.cos(dec) * torch.cos(lat) * torch.cos(ha))
    el = torch.arcsin(torch.clamp(sin_el, -1.0, 1.0))
    az = torch.atan2(
        -torch.cos(dec) * torch.sin(ha),
        torch.sin(dec) * torch.cos(lat)
        - torch.cos(dec) * torch.sin(lat) * torch.cos(ha))
    az = torch.where(az < 0, az + 2 * math.pi, az)
    return az, el
