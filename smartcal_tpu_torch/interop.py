"""Carry state from the JAX package into the port.

The JAX package's ``Episode``, ``BatchedEpisode``, ``SolveResult``,
``DemixModels``, ``SACState``, ``TD3State``, ``DDPGState``, ``TSKParams``
and ``XYBuffer`` (any objects with the same field names, holding arrays
that ``numpy.asarray`` accepts), a fuzzy controller's limits, flax
parameter trees (the agents' networks, the transformer and the MLP
regressor) and optax Adam states become the port's types, so one
episode, sky, controller, model or agent can be fed to both packages,
and a JAX trainer's checkpoint payload becomes the port's
(:func:`agent_loop_from_jax`), so a JAX run resumes in the port.  The
serving layer's jobs, job pools, results and served policy cross too
(:func:`job_from_jax`, :func:`job_pool_from_jax`,
:func:`job_result_from_jax`, :func:`served_policy_from_jax`), so the same
episodes and weights go through both servers.  Nothing here imports the
JAX package: the fields are read by name.
"""

import numpy as np
import torch

import copy

from smartcal_tpu_torch.cal import coherency, observation, simulate, solver
from smartcal_tpu_torch.envs import radio
from smartcal_tpu_torch.models import transformer, tsk
from smartcal_tpu_torch.rl import ddpg, sac, sac_discrete, td3


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
    """The ``state_dict`` of ``module`` (a network of ``rl.networks``, or a
    model of ``models/`` whose submodules carry flax's auto names) that
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


def _load_flax(tree, module: torch.nn.Module) -> dict:
    module.load_state_dict(params_from_flax(tree, module))
    return dict(module.named_parameters())


def transformer_params_from_flax(tree, model) -> dict:
    """Load the JAX ``TransformerEncoder``'s flax params into the port's
    ``models.transformer.TransformerEncoder`` of the same widths (its
    submodules carry flax's names, ``EncoderBlock_0/HeadAttention_0/
    Dense_0`` and so on); returns the model's {name: parameter}."""
    return _load_flax(tree, model)


def regressor_params_from_flax(tree, net) -> dict:
    """Load the JAX ``RegressorNet``'s flax params into the port's
    ``models.regressor.RegressorNet``; returns its {name: parameter}."""
    return _load_flax(tree, net)


def tsk_params_from_jax(params, device="cpu") -> tsk.TSKParams:
    """The port's ``TSKParams`` of the JAX package's (arrays copied)."""
    return tsk.TSKParams(*(_t(getattr(params, f), device).to(torch.float32)
                           for f in tsk.TSKParams._fields))


def xy_buffer_from_numpy(buf) -> transformer.XYBuffer:
    """The port's ``XYBuffer`` of a JAX one (host copies)."""
    out = transformer.XYBuffer(int(buf.mem_size), (), ())
    out.x, out.y = np.array(buf.x), np.array(buf.y)
    out.mem_cntr = int(buf.mem_cntr)
    return out


def adam_state_from_optax(opt, module=None, device="cpu", names=None):
    """The port's ``rl.sac.AdamState`` of an ``optax.adam`` state: the
    moments of a flax tree laid out for ``module`` (a network or model),
    or, for a NamedTuple of arrays such as ``TSKParams``, by its field
    ``names``."""
    a = opt[0]
    if module is not None:
        mu = params_from_flax(a.mu, module)
        nu = params_from_flax(a.nu, module)
    else:
        mu = {n: torch.as_tensor(np.array(getattr(a.mu, n), np.float32))
              for n in names}
        nu = {n: torch.as_tensor(np.array(getattr(a.nu, n), np.float32))
              for n in names}
    return sac.AdamState(int(a.count), {k: v.to(device) for k, v in
                                        mu.items()},
                         {k: v.to(device) for k, v in nu.items()})


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


def dsac_state_from_jax(st, cfg, device="cpu"):
    """The port's :class:`~smartcal_tpu_torch.rl.sac_discrete.DSACState` of
    a JAX ``DSACState``: the categorical actor, the Q-vector critics and
    their targets, the three Adam states, alpha and the learn counter.
    ``cfg`` is the port's ``DSACConfig``."""
    actor, critic = sac_discrete.build_nets(cfg)
    host = _nets_from_jax(st, {"actor": "actor_params", "c1": "c1_params",
                               "c2": "c2_params", "t1": "t1_params",
                               "t2": "t2_params"}, actor, critic)
    host.update(actor_opt=_adam_from_optax(st.actor_opt, actor),
                c1_opt=_adam_from_optax(st.c1_opt, critic),
                c2_opt=_adam_from_optax(st.c2_opt, critic),
                alpha=float(st.alpha), learn_counter=int(st.learn_counter))
    return sac_discrete.DSACState.from_host(cfg, host, device)


def sharded_replay_from_jax(buf) -> dict:
    """The port's sharded ring payload (``rl/replay_sharded.replay_to_host``
    form) of a JAX ``ShardedReplayState`` (host arrays): the same (S,
    local) layout, ``cntr`` and ``beta``."""
    return {"cntr": int(np.asarray(buf.cntr)),
            "beta": float(np.asarray(buf.beta)),
            "data": {k: np.array(v) for k, v in buf.data.items()},
            "priority": np.array(buf.priority, np.float32)}


def seed_from_jax_key(key) -> int:
    """The 63-bit ``torch.Generator`` seed the port takes for a JAX PRNG key:
    the key's two uint32 words as one integer, high word first, top bit
    cleared.  A JAX key stream has no torch counterpart, so a run resumed
    from a JAX checkpoint draws a different (but fixed) exploration
    stream from there on (``prng.generator_seed``)."""
    from smartcal_tpu_torch import prng
    return prng.generator_seed(key)


def replay_from_jax(buf) -> dict:
    """The port's ring payload (``rl.replay.replay_to_host`` form) of a JAX
    ``ReplayState`` (host arrays): the filled prefix of every field and of
    the priorities, ``cntr``, ``beta`` and the ring size."""
    size = int(np.asarray(buf.priority).shape[0])
    cntr = int(np.asarray(buf.cntr))
    n = min(cntr, size)
    return {"size": size, "cntr": cntr, "beta": float(np.asarray(buf.beta)),
            "data": {k: np.array(v)[:n] for k, v in buf.data.items()},
            "priority": np.array(buf.priority, np.float32)[:n]}


def native_replay_from_jax(state: dict) -> dict:
    """The port's ``NativePER`` state dict of a JAX ``NativePER.state_dict``
    (host arrays): the same ring, leaves, cursor, fill and beta, the spec's
    dtypes as numpy dtype strings."""
    out = _host({k: v for k, v in state.items() if k != "spec"})
    out["spec"] = {k: (tuple(shape), np.dtype(dt).str)
                   for k, (shape, dt) in state["spec"].items()}
    return out


def _replay_from_jax(obj: dict) -> dict:
    """The port's replay payload of a JAX ``pack_replay`` payload: the
    device ring form of an "hbm" payload, the native form of a "native"
    one."""
    if obj.get("kind") == "native":
        return {"kind": "native",
                "state": native_replay_from_jax(obj["state"])}
    if obj.get("kind") == "hbm_sharded":
        return {"kind": "device_sharded",
                "state": sharded_replay_from_jax(obj["state"])}
    return {"kind": "device_ring", "state": replay_from_jax(obj["state"])}


def _state_from_jax(st, cfg):
    if isinstance(cfg, sac.SACConfig):
        return sac_state_from_jax(st, cfg)
    if isinstance(cfg, td3.TD3Config):
        return td3_state_from_jax(st, cfg)
    if isinstance(cfg, ddpg.DDPGConfig):
        return ddpg_state_from_jax(st, cfg)
    if isinstance(cfg, sac_discrete.DSACConfig):
        return dsac_state_from_jax(st, cfg)
    raise TypeError(f"no agent state for config {type(cfg)!r}")


def _host(x):
    """``x`` with every array-like leaf as a numpy array."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    if hasattr(x, "__array__") and not isinstance(x, np.ndarray):
        return np.array(x)
    return x


def agent_loop_from_jax(payload: dict, cfg, device="cpu") -> dict:
    """The port's checkpoint payload of a JAX checkpoint payload, so a JAX
    run resumes in the port (``train.blocks.restore_agent_loop`` /
    ``restore_fused``):

    * ``pack_agent_loop`` payloads (``kind`` "agent_loop": calib_*,
      demix_*): the agent state through :func:`sac_state_from_jax` /
      :func:`td3_state_from_jax` / :func:`ddpg_state_from_jax` (by the type
      of ``cfg``, the port's config), the ring, the env's key state, the
      scores, the episode, ``extra`` and the native sampler's numpy
      generator state;
    * ``train_fused`` payloads (``kind`` "enet_fused"): the same for the
      elastic-net trainers;
    * supervised-fleet payloads (``kind`` "fleet": ``parallel/learner`` and
      ``parallel/demix_learner``): the agent (a ``DSACConfig`` for the
      demixing fleet), the flat or sharded ring, the scores, the episode,
      the learner version and every actor slot's next iteration, as the
      port's ``run_supervised_loop`` restores them.

    The JAX agent key becomes the state of a ``torch.Generator`` on
    ``device`` seeded with :func:`seed_from_jax_key`."""
    kind = payload.get("kind")
    if kind not in ("agent_loop", "enet_fused", "fleet"):
        raise ValueError(f"not a JAX agent checkpoint payload: {kind!r}")
    key = payload["agent_key" if kind == "agent_loop" else "key"]
    gen = torch.Generator(device=device).manual_seed(seed_from_jax_key(key))
    out = {"kind": kind, "episode": int(payload["episode"]),
           "scores": [float(s) for s in payload["scores"]],
           "agent_state": _state_from_jax(payload["agent_state"],
                                          cfg).to_host(),
           "replay": _replay_from_jax(payload["replay"])}
    gen_state = gen.get_state().numpy().copy()
    if kind == "fleet":
        out.update(generator=gen_state,
                   learner_version=int(payload["learner_version"]),
                   actor_iterations={int(k): int(v) for k, v in
                                     payload["actor_iterations"].items()})
    elif kind == "agent_loop":
        out["agent_generator"] = gen_state
        if "agent_sample_rng" in payload:
            out["agent_sample_rng"] = payload["agent_sample_rng"]
        if "env_state" in payload:
            out["env_state"] = _host(dict(payload["env_state"]))
        if payload.get("extra"):
            out["extra"] = _host(dict(payload["extra"]))
    else:
        out.update(generator=gen_state, entry=payload.get("entry"),
                   seed=payload.get("seed"),
                   saved_marker=int(payload.get("saved_marker", 0)))
    out["generator_device"] = torch.device(device).type
    return out


def job_from_jax(job, device="cpu"):
    """The port's :class:`~smartcal_tpu_torch.serve.router.Job` of a JAX
    ``Job``: its episode through :func:`episode_from_numpy`, the request
    fields (k, rho, rho_spatial, maxiter, deadline_s, obs_vec, warm, trace)
    copied; the port's job gets its own id and future."""
    from smartcal_tpu_torch.serve.router import Job

    def arr(x):
        return None if x is None else np.array(x, np.float32)

    return Job(episode=episode_from_numpy(job.episode, device), k=int(job.k),
               rho=arr(job.rho), rho_spatial=arr(job.rho_spatial),
               maxiter=None if job.maxiter is None else int(job.maxiter),
               deadline_s=job.deadline_s, obs_vec=arr(job.obs_vec),
               warm=bool(job.warm),
               trace=None if job.trace is None else dict(job.trace))


def job_pool_from_jax(pool, device="cpu") -> list:
    """A JAX job pool (``(k, episode)`` pairs of ``build_job_pool`` or
    ``(k, episode, obs_vec)`` triples of ``build_obs_pool``) as the
    port's."""
    return [(int(e[0]), episode_from_numpy(e[1], device))
            + tuple(np.array(x, np.float32) for x in e[2:]) for e in pool]


_RESULT_FIELDS = ("lane", "sigma_res", "sigma_data_img", "sigma_res_img",
                  "img_std", "degraded", "deadline_miss")


def job_result_from_jax(res) -> dict:
    """A JAX (or the port's) ``JobResult`` as a comparable dict: its lane,
    the four served statistics and the two flags (ids and timings differ
    between any two servers)."""
    return {f: (float(getattr(res, f)) if f.startswith(("sigma", "img"))
                else getattr(res, f)) for f in _RESULT_FIELDS}


def served_policy_from_jax(st, cfg, device="cpu"):
    """The port's served policy ``(cfg, actor weights by name)`` of a JAX
    ``SACState`` (its ``actor_params``, through :func:`sac_state_from_jax`).
    ``cfg`` is the port's ``SACConfig``."""
    port = sac_state_from_jax(st, cfg, device)
    return cfg, {k: v.detach().clone()
                 for k, v in port.actor.state_dict().items()}
