"""Carry state from the JAX package into the port.

The JAX package's ``Episode`` and ``SolveResult`` (any objects with the same
field names, holding arrays that ``numpy.asarray`` accepts) become the
port's types, so one episode can be fed to both packages.  Nothing here
imports the JAX package: the fields are read by name.
"""

import numpy as np
import torch

from smartcal_tpu_torch.cal import observation, solver
from smartcal_tpu_torch.envs import radio


def _t(x, device):
    return torch.as_tensor(np.array(x), device=device)   # own copy


def episode_from_numpy(ep, device="cpu") -> radio.Episode:
    """The port's :class:`~smartcal_tpu_torch.envs.radio.Episode` of a JAX
    ``Episode`` (arrays copied to ``device``)."""
    o = ep.obs
    obs = observation.Observation(
        uvw=_t(o.uvw, device), freqs=_t(o.freqs, device), ra0=float(o.ra0),
        dec0=float(o.dec0), lst0=float(o.lst0), times=_t(o.times, device),
        n_stations=int(o.n_stations))
    return radio.Episode(obs=obs, V=_t(ep.V, device), Ccal=_t(ep.Ccal, device),
                         f0=float(ep.f0), n_dirs=int(ep.n_dirs),
                         snr=float(ep.snr))


def solve_result_from_numpy(res, device="cpu") -> solver.SolveResult:
    """The port's :class:`~smartcal_tpu_torch.cal.solver.SolveResult` of a
    JAX ``SolveResult`` (telemetry ``stats`` is dropped)."""
    return solver.SolveResult(
        J=_t(res.J, device), Z=_t(res.Z, device),
        residual=_t(res.residual, device),
        sigma_res=_t(res.sigma_res, device),
        sigma_data=_t(res.sigma_data, device),
        final_cost=_t(res.final_cost, device))
