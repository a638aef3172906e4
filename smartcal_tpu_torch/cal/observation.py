"""Synthetic interferometer observations: array geometry -> uvw tracks
(counterpart of smartcal_tpu/cal/observation.py).

Every random draw is a host numpy Generator seeded from the key words plus
a per-consumer salt, exactly as in the JAX package, so the same key gives
bit-identical draws.  The geometry is computed in float32 on the CPU (the
arrays are tiny) and the results are moved to the requested device.

Conventions: B = N(N-1)/2 baselines enumerating p < q row-major; samples
are time-major ck = t*B + b.
"""

from typing import NamedTuple

import numpy as np
import torch

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.cal import coords

# LOFAR core reference position (superterp), public ITRF values (m)
LOFAR_X0 = 3826896.235
LOFAR_Y0 = 460979.455
LOFAR_Z0 = 5064658.203
LOFAR_LAT = 0.923717  # rad (~52.92 deg), derived from the ITRF position
OMEGA_EARTH = 7.2921159e-5  # rad/s (sidereal)

# frequency bands (MHz)
LBA_LOW, LBA_HIGH = 30.0, 70.0
HBA_LOW, HBA_HIGH = 110.0, 180.0

# approximate A-team J2000 coordinates (rad): CasA, CygA, HerA, TauA, VirA
ATEAM_DIRS = np.asarray([
    (6.123273, 1.026748),   # CasA
    (5.233838, 0.710912),   # CygA
    (4.412048, 0.087195),   # HerA
    (1.459697, 0.383912),   # TauA
    (3.276019, 0.216299),   # VirA
])
# approximate 150 MHz integrated fluxes (Jy)
ATEAM_FLUX = np.asarray([10690.0, 8247.0, 377.0, 1420.0, 1060.0])

F32 = torch.float32


def host_rng(key, salt=0):
    """Host-side numpy Generator derived from a PRNG key (two uint32 words,
    see ``smartcal_tpu_torch.prng``) plus a per-consumer salt."""
    k = np.asarray(key, np.uint32).ravel()
    return np.random.default_rng(np.concatenate([k, [np.uint32(salt)]]))


class Observation(NamedTuple):
    """Geometry + spectral setup of one synthetic observation.

    uvw    : (T, B, 3) float32 tensor, meters (baseline p - q convention)
    freqs  : (Nf,) float32 tensor, Hz
    ra0, dec0 : phase center (rad)
    lst0   : local sidereal time at the first sample (rad)
    times  : (T,) float32 tensor, seconds from start
    n_stations : int
    """

    uvw: torch.Tensor
    freqs: torch.Tensor
    ra0: float
    dec0: float
    lst0: float
    times: torch.Tensor
    n_stations: int

    @property
    def n_baselines(self) -> int:
        return self.n_stations * (self.n_stations - 1) // 2

    @property
    def n_times(self) -> int:
        return self.uvw.shape[0]


def station_layout(key, n_stations: int, core_radius: float = 1500.0,
                   max_radius: float = 40e3, core_fraction: float = 0.6):
    """LOFAR-like station positions in local ENU meters, (N, 3) float32."""
    rng = host_rng(key, salt=10)
    n_core = max(2, int(core_fraction * n_stations))
    n_rem = n_stations - n_core
    core = rng.normal(scale=core_radius / 2.0, size=(n_core, 2))
    r = np.exp(rng.uniform(np.log(core_radius), np.log(max_radius),
                           size=n_rem))
    th = rng.uniform(0.0, 2 * np.pi, size=n_rem)
    rem = np.stack([r * np.cos(th), r * np.sin(th)], axis=-1)
    enu2 = np.concatenate([core, rem], axis=0)
    up = rng.normal(scale=5.0, size=(n_stations, 1))  # small height scatter
    return torch.as_tensor(np.concatenate([enu2, up], axis=-1), dtype=F32)


def _sc(x):
    """(sin, cos) of a python float, in float32 like the JAX package."""
    t = torch.as_tensor(x, dtype=F32)
    return torch.sin(t), torch.cos(t)


def enu_to_equatorial(enu, lat: float = LOFAR_LAT):
    """ENU -> equatorial (X toward meridian/equator, Y east, Z north)."""
    e, n, u = enu[..., 0], enu[..., 1], enu[..., 2]
    slat, clat = _sc(lat)
    x = -slat * n + clat * u
    y = e
    z = clat * n + slat * u
    return torch.stack([x, y, z], dim=-1)


def uvw_tracks(xyz_eq, times, ra0, dec0, lst0):
    """Earth-rotation-synthesis station uvw: (T, N, 3) meters."""
    lst = lst0 + OMEGA_EARTH * times
    H = lst - ra0
    sh, ch = torch.sin(H)[:, None], torch.cos(H)[:, None]
    sd, cd = _sc(dec0)
    X, Y, Z = xyz_eq[None, :, 0], xyz_eq[None, :, 1], xyz_eq[None, :, 2]
    u = sh * X + ch * Y
    v = -sd * ch * X + sd * sh * Y + cd * Z
    w = cd * ch * X - cd * sh * Y + sd * Z
    return torch.stack([u, v, w], dim=-1)


def baseline_uvw(station_uvw, n_stations: int):
    """(T, N, 3) station uvw -> (T, B, 3) baseline uvw, p < q row-major."""
    p, q = np.triu_indices(n_stations, 1)
    return station_uvw[:, p, :] - station_uvw[:, q, :]


def find_valid_target(key, low_el_deg: float = 3.0, strategy: int = 0):
    """Draw (ra0, dec0, t0) with the target above ``low_el_deg``.
    Strategies: 0/2 uniform sky, 1 near a random A-team source.  t0 is
    seconds within a sidereal day, doubling as the LST seed."""
    rng = host_rng(key, salt=11)
    low_el = np.deg2rad(low_el_deg)
    while True:
        if strategy == 1:
            i = rng.integers(len(ATEAM_DIRS))
            dmax = np.deg2rad(0.5 + 30 * rng.random())
            ra0 = float(ATEAM_DIRS[i, 0] + rng.random() * dmax)
            dec0 = float(ATEAM_DIRS[i, 1] + rng.random() * dmax)
        else:
            ra0 = float(rng.random() * 2 * np.pi)
            dec0 = float(rng.random() * np.pi / 2)
        if dec0 > np.pi / 2:
            continue
        t0 = float(rng.random() * 24 * 3600.0)
        lst0 = OMEGA_EARTH * t0 % (2 * np.pi)
        _, el = coords.azel_from_radec(ra0, dec0, lst0, LOFAR_LAT)
        if float(el) > low_el:
            return ra0, dec0, t0


def make_observation(key, n_stations: int = 14, n_freqs: int = 3,
                     n_times: int = 20, t_int: float = 1.0,
                     hba: bool = True, ra0: float = None, dec0: float = None,
                     t0: float = None, device="cuda") -> Observation:
    """Full synthetic observation: flow uniform in the lower half-band,
    fhigh in the upper, Nf channels linspaced between.

    The pointing and epoch are drawn (``find_valid_target``) unless the
    caller fixes them.  A caller who fixes only part of (ra0, dec0, t0)
    voids the drawn triple's above-horizon guarantee, so the epoch is
    redrawn until the final combination is above 3 degrees; a caller who
    fixes both ra0 and dec0 owns the elevation, and only a missing t0 is
    drawn."""
    dev = resolve_device(device)
    rng = host_rng(key, salt=12)
    if ra0 is None or dec0 is None:
        drawn = find_valid_target(key)
        caller_fixed = ra0 is not None or dec0 is not None or t0 is not None
        ra0 = drawn[0] if ra0 is None else ra0
        dec0 = drawn[1] if dec0 is None else dec0
        t0 = drawn[2] if t0 is None else t0
        if caller_fixed:
            low_el = np.deg2rad(3.0)
            el_max = np.pi / 2 - abs(LOFAR_LAT - dec0)
            if el_max <= low_el:
                raise ValueError(
                    f"dec0={dec0:.4f} rad never rises above 3 deg at the "
                    "LOFAR latitude; supply both ra0 and dec0 (or neither)")
            for _ in range(1000):
                lst0 = OMEGA_EARTH * t0 % (2 * np.pi)
                _, el = coords.azel_from_radec(ra0, dec0, lst0, LOFAR_LAT)
                if float(el) > low_el:
                    break
                t0 = float(rng.random() * 24 * 3600.0)
            else:
                raise ValueError(
                    "could not find an epoch with the target above the "
                    f"horizon for ra0={ra0:.4f} dec0={dec0:.4f}")
    elif t0 is None:
        t0 = float(rng.random() * 24 * 3600.0)
    lo, hi = (HBA_LOW, HBA_HIGH) if hba else (LBA_LOW, LBA_HIGH)
    flow_mhz = lo + rng.random() * (hi - lo) / 2
    fhigh_mhz = lo + (hi - lo) / 2 + rng.random() * (hi - lo) / 2
    freqs = torch.as_tensor(np.linspace(flow_mhz, fhigh_mhz, n_freqs) * 1e6,
                            dtype=F32)
    enu = station_layout(key, n_stations)
    xyz = enu_to_equatorial(enu)
    times = torch.arange(n_times, dtype=F32) * t_int + 0.5 * t_int
    lst0 = float(OMEGA_EARTH * t0 % (2 * np.pi))
    st_uvw = uvw_tracks(xyz, times, ra0, dec0, lst0)
    uvw = baseline_uvw(st_uvw, n_stations)
    return Observation(uvw=uvw.to(dev), freqs=freqs.to(dev), ra0=float(ra0),
                       dec0=float(dec0), lst0=lst0, times=times.to(dev),
                       n_stations=n_stations)
