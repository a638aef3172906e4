"""Carry state from the JAX package into the port.

The JAX package's ``Episode``, ``BatchedEpisode``, ``SolveResult``,
``DemixModels``, ``SACState``, ``TD3State`` and ``DDPGState`` (any objects
with the same field names, holding arrays that ``numpy.asarray`` accepts),
a fuzzy controller's limits and flax parameter trees become the port's
types, so one episode, sky, controller or agent can be fed to both
packages.  Nothing here imports the JAX
package: the fields are read by name.
"""

import numpy as np
import torch

import copy

from smartcal_tpu_torch.cal import coherency, observation, simulate, solver
from smartcal_tpu_torch.envs import radio
from smartcal_tpu_torch.rl import ddpg, sac, td3


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


def batched_episode_from_numpy(bep, device="cpu") -> radio.BatchedEpisode:
    """The port's :class:`~smartcal_tpu_torch.envs.radio.BatchedEpisode` of
    a JAX ``BatchedEpisode``: V, Ccal and uvw copied to ``device``, the
    per-lane host values copied as numpy."""
    return radio.BatchedEpisode(
        V=_t(bep.V, device), Ccal=_t(bep.Ccal, device),
        freqs=np.array(bep.freqs, np.float32),
        f0=np.array(bep.f0, np.float32), uvw=_t(bep.uvw, device),
        cell=np.array(bep.cell, np.float32), n_dirs=int(bep.n_dirs))


def sky_from_numpy(sky) -> coherency.SkyArrays:
    """The port's ``SkyArrays`` of a JAX sky (host numpy copies)."""
    return coherency.SkyArrays(
        *(np.array(getattr(sky, f)) for f in (
            "lmn", "flux_coef", "f0", "gauss", "is_gauss", "cluster")),
        n_clusters=int(sky.n_clusters))


def demix_models_from_numpy(mdl) -> simulate.DemixModels:
    """The port's :class:`~smartcal_tpu_torch.cal.simulate.DemixModels` of
    a JAX ``DemixModels``: skies, rho, separations, azimuths, elevations,
    fluxes and cluster centres copied as numpy."""
    out = {}
    for f in simulate.DemixModels._fields:
        v = getattr(mdl, f)
        if f.startswith("sky_"):
            out[f] = sky_from_numpy(v)
        elif f == "f0":
            out[f] = float(v)
        else:
            out[f] = np.array(v)
    return simulate.DemixModels(**out)


def fuzzy_config_from_jax(ctrl) -> dict:
    """A copy of a JAX ``DemixController``'s membership limits, the form
    the port's controller keeps in ``config``."""
    return copy.deepcopy(ctrl.config)


def solve_result_from_numpy(res, device="cpu") -> solver.SolveResult:
    """The port's :class:`~smartcal_tpu_torch.cal.solver.SolveResult` of a
    JAX ``SolveResult`` (telemetry ``stats`` is dropped)."""
    return solver.SolveResult(
        J=_t(res.J, device), Z=_t(res.Z, device),
        residual=_t(res.residual, device),
        sigma_res=_t(res.sigma_res, device),
        sigma_data=_t(res.sigma_data, device),
        final_cost=_t(res.final_cost, device))


# flax leaf name -> torch parameter name
_LEAF = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if hasattr(v, "items"):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def params_from_flax(tree, module: torch.nn.Module) -> dict:
    """The ``state_dict`` of ``module`` (a network of ``rl.networks``) that
    holds the flax ``params`` ``tree`` (nested dicts of arrays): Dense
    kernels (in, out) transposed to (out, in), Conv kernels HWIO to OIHW,
    norm ``scale`` to ``weight``.  Raises unless the tree fills every
    parameter of ``module`` with the right shape."""
    out = {}
    for path, leaf in _leaves(tree):
        try:
            sub = module.get_submodule(".".join(path[:-1]))
        except AttributeError as e:
            raise ValueError(f"flax path {'/'.join(path)}: {e}") from e
        x = torch.as_tensor(np.array(leaf, np.float32))
        if path[-1] == "kernel" and isinstance(sub, torch.nn.Linear):
            x = x.T
        elif path[-1] == "kernel" and isinstance(sub, torch.nn.Conv2d):
            x = x.permute(3, 2, 0, 1)
        out[".".join(path[:-1] + (_LEAF[path[-1]],))] = x.contiguous()
    want = module.state_dict()
    if set(out) != set(want):
        raise ValueError(f"flax tree and module differ: "
                         f"{sorted(set(out) ^ set(want))}")
    for k, v in want.items():
        if tuple(out[k].shape) != tuple(v.shape):
            raise ValueError(f"{k}: flax {tuple(out[k].shape)}, module "
                             f"{tuple(v.shape)}")
    return out


def _adam_from_optax(opt, module):
    """``optax.adam`` state ``(ScaleByAdamState(count, mu, nu), ...)`` ->
    the port's host form {"count", "mu", "nu"}."""
    a = opt[0]
    if module is None:                       # the scalar log_alpha's Adam
        return {"count": int(a.count),
                "mu": {"log_alpha": np.array(a.mu, np.float32)},
                "nu": {"log_alpha": np.array(a.nu, np.float32)}}
    return {"count": int(a.count),
            "mu": {k: v.numpy() for k, v in
                   params_from_flax(a.mu, module).items()},
            "nu": {k: v.numpy() for k, v in
                   params_from_flax(a.nu, module).items()}}


def _nets_from_jax(st, fields, actor, critic):
    """{port name: flax params} of the networks named by ``fields`` (port
    name -> JAX field), in the port's host form."""
    return {k: {n: v.numpy() for n, v in params_from_flax(
        getattr(st, f), actor if k in ("actor", "t_actor") else critic)
        .items()} for k, f in fields.items()}


def sac_state_from_jax(st, cfg, device="cpu"):
    """The port's :class:`~smartcal_tpu_torch.rl.sac.SACState` of a JAX
    ``SACState`` (fields read by name): actor, both critics and targets,
    the three Adam states (moments and count), alpha, rho, learn_counter,
    log_alpha and its Adam state.  ``cfg`` is the port's ``SACConfig``."""
    actor, critic = sac.build_nets(cfg, device="cpu")
    host = _nets_from_jax(st, {"actor": "actor_params", "c1": "c1_params",
                               "c2": "c2_params", "t1": "t1_params",
                               "t2": "t2_params"}, actor, critic)
    host.update(
        actor_opt=_adam_from_optax(st.actor_opt, actor),
        c1_opt=_adam_from_optax(st.c1_opt, critic),
        c2_opt=_adam_from_optax(st.c2_opt, critic),
        alpha=float(st.alpha), rho=float(st.rho),
        learn_counter=int(st.learn_counter),
        log_alpha=float(st.log_alpha),
        alpha_opt=_adam_from_optax(st.alpha_opt, None))
    return sac.SACState.from_host(cfg, host, device)


def td3_state_from_jax(st, cfg, device="cpu"):
    """The port's :class:`~smartcal_tpu_torch.rl.td3.TD3State` of a JAX
    ``TD3State``: actor, critics and targets, the three Adam states and
    the two counters.  ``cfg`` is the port's ``TD3Config``."""
    actor, critic = td3.build_nets(cfg)
    host = _nets_from_jax(st, {"actor": "actor_params", "c1": "c1_params",
                               "c2": "c2_params",
                               "t_actor": "t_actor_params",
                               "t1": "t1_params", "t2": "t2_params"},
                          actor, critic)
    host.update(actor_opt=_adam_from_optax(st.actor_opt, actor),
                c1_opt=_adam_from_optax(st.c1_opt, critic),
                c2_opt=_adam_from_optax(st.c2_opt, critic),
                learn_counter=int(st.learn_counter),
                time_step=int(st.time_step))
    return td3.TD3State.from_host(cfg, host, device)


def ddpg_state_from_jax(st, cfg, device="cpu"):
    """The port's :class:`~smartcal_tpu_torch.rl.ddpg.DDPGState` of a JAX
    ``DDPGState``: actor, critic and targets, the two Adam states and the
    OU noise state.  ``cfg`` is the port's ``DDPGConfig``."""
    actor, critic = td3.build_nets(cfg)
    host = _nets_from_jax(st, {"actor": "actor_params",
                               "critic": "critic_params",
                               "t_actor": "t_actor_params",
                               "t_critic": "t_critic_params"},
                          actor, critic)
    host.update(actor_opt=_adam_from_optax(st.actor_opt, actor),
                critic_opt=_adam_from_optax(st.critic_opt, critic),
                noise=np.array(st.noise.x_prev, np.float32))
    return ddpg.DDPGState.from_host(cfg, host, device)
