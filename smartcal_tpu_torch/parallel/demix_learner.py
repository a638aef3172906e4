"""Distributed PER learner/actors for the demixing workload (counterpart
of smartcal_tpu/parallel/demix_learner.py).

Parity target: ``demixing_rl/distributed_per_sac.py``: actions are the
2^(K-1) direction subsets (``:34``, ``:180-184`` scalar_to_kvec); each
actor runs ``epochs`` episodes of ``steps`` steps with frozen weights and
uploads its buffer; the learner trains a discrete PER SAC agent on
{influence map, metadata} observations.

* Episode simulation (``RadioBackend.new_demixing_episode``) is host work,
  batched into a :class:`DemixWorkload` with a leading (actors, epochs)
  axis.  The keys are the JAX package's (``prng.split``), so the port
  simulates the same episodes;
* an actor's rollout is, per epoch, the target-only calibration and its
  reward, then per step a categorical action, the masked ADMM calibration
  (``cal/solver.solve_admm``, ``maxiter`` ADMM iterations) and the AIC
  reward.  With ``provide_influence`` the observation's map is the mean
  Stokes-I influence image over the sub-bands, each band imaged by
  ``cal/imager.dirty_image_sr``: kernel 1 (``csrc/dft_imager.cu``) on the
  card, Nf launches per observation.  (The JAX package takes its XLA form
  there, as ``pallas_call`` has no partitioning rule for the mesh.);
* :func:`train_distributed_demix` runs the actors one after another and
  then learns (the one-program learner); in a job of several processes
  (``parallel/multihost``) each process runs its block of the actors and
  the learner is replicated (``parallel/trainer.DataParallel``), so each
  rank's rollouts launch kernel 1 for their own observations;
  :func:`train_supervised_demix` is
  the actor fleet of ``parallel/learner``, each actor simulating its own
  workload from its ``fold_in`` key.
"""

from typing import NamedTuple

import numpy as np
import torch

from smartcal_tpu_torch import obs, prng
from smartcal_tpu_torch.cal import imager, influence as influence_mod, solver
from smartcal_tpu_torch.envs import radio
from smartcal_tpu_torch.envs.demixing import (EPS, INF_SCALE, META_SCALE,
                                              REWARD_MEAN, REWARD_STD,
                                              scalar_to_kvec)
from smartcal_tpu_torch.parallel.learner import (_mesh_for, actor_weights,
                                                 exit_if_fleet_failed,
                                                 fleet_work_fn, fused_ingest,
                                                 key_generator,
                                                 make_sharded_fleet_buffer,
                                                 run_supervised_loop)
from smartcal_tpu_torch.parallel.mesh import AXIS_DATA
from smartcal_tpu_torch.parallel.trainer import DataParallel
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl import sac_discrete as dsac


class DemixWorkload(NamedTuple):
    """(actors, epochs) simulated demixing episodes on the device; ``freqs``
    and ``cell`` also as host arrays (the imager takes them as numbers)."""

    V: torch.Tensor          # (A, E, Nf, T, B, 2, 2, 2)
    Ccal: torch.Tensor       # (A, E, Nf, K, T*B, 4, 2)
    freqs: torch.Tensor      # (A, E, Nf)
    f0: torch.Tensor         # (A, E)
    rho: torch.Tensor        # (A, E, K)
    metadata: torch.Tensor   # (A, E, 3K+2) raw (unscaled)
    uvw: torch.Tensor        # (A, E, T, B, 3)
    cell: torch.Tensor       # (A, E) imaging cell size
    freqs_host: np.ndarray   # (A, E, Nf)
    cell_host: np.ndarray    # (A, E)


def mask_table(K: int) -> np.ndarray:
    """(2^(K-1), K) float32: row i = scalar_to_kvec(i) outlier bits plus
    the always-selected target (demixingenv.py:114-118)."""
    n = 2 ** (K - 1)
    tbl = np.zeros((n, K), np.float32)
    for i in range(n):
        tbl[i, :K - 1] = scalar_to_kvec(i, K - 1)
        tbl[i, K - 1] = 1.0
    return tbl


def make_workloads(backend: radio.RadioBackend, K: int, n_actors: int,
                   n_epochs: int, key, actors=None) -> DemixWorkload:
    """n_actors x n_epochs simulated observations from ``split(key,
    n_actors * n_epochs)`` (the reference's per-epoch ``env.reset()``,
    distributed_per_sac.py:131); ``actors`` (a range) makes only those
    actors' observations."""
    actors = range(n_actors) if actors is None else actors
    fields = {k: [] for k in ("V", "Ccal", "freqs", "f0", "rho", "metadata",
                              "uvw", "cell")}
    keys = prng.split(key, n_actors * n_epochs)
    for k in keys[actors.start * n_epochs:actors.stop * n_epochs]:
        ep, mdl = backend.new_demixing_episode(k, K)
        freqs = ep.obs.freqs.cpu().numpy()
        md = np.zeros(3 * K + 2, np.float32)
        md[:K] = mdl.separations
        md[K:2 * K] = mdl.azimuth
        md[2 * K:3 * K] = mdl.elevation
        md[-2] = np.log(freqs[0] / 1e6)
        md[-1] = backend.n_stations
        fields["V"].append(ep.V)
        fields["Ccal"].append(ep.Ccal)
        fields["freqs"].append(torch.as_tensor(freqs))
        fields["f0"].append(torch.tensor(ep.f0, dtype=torch.float32))
        fields["rho"].append(torch.as_tensor(mdl.rho.astype(np.float32)))
        fields["metadata"].append(torch.as_tensor(md))
        fields["uvw"].append(ep.obs.uvw)
        fields["cell"].append(torch.tensor(
            imager.default_cell(ep.obs.uvw, float(freqs[-1])),
            dtype=torch.float32))

    dev = backend.device

    def pack(xs):
        a = torch.stack([x.to(dev, torch.float32) for x in xs])
        return a.reshape((len(actors), n_epochs) + tuple(a.shape[1:]))

    wl = {k: pack(v) for k, v in fields.items()}
    return DemixWorkload(**wl, freqs_host=wl["freqs"].cpu().numpy(),
                         cell_host=wl["cell"].cpu().numpy())


class DistDemixState:
    """The one-program demix learner's state: agent, ring, episode."""

    def __init__(self, agent, buf, episode=0):
        self.agent, self.buf, self.episode = agent, buf, int(episode)


def make_demix_actor_rollout(backend: radio.RadioBackend, K: int,
                             agent_cfg: dsac.DSACConfig,
                             rollout_epochs: int, rollout_steps: int,
                             provide_influence: bool = False,
                             maxiter: int = 10, record_logp: bool = False):
    """One actor's rollout ``(agent, wl, generator) -> transitions``: ``wl``
    a :class:`DemixWorkload` with leading axis ``rollout_epochs`` (one
    actor's slice), output leading axis ``rollout_epochs *
    rollout_steps``; ``record_logp`` adds the categorical
    ``behavior_logp``."""
    n_actions = 2 ** (K - 1)
    if agent_cfg.n_actions != n_actions:
        raise ValueError(f"agent n_actions={agent_cfg.n_actions} != "
                         f"2^(K-1)={n_actions}")
    npix = backend.npix
    N = backend.n_stations
    dev = backend.device
    tbl = torch.as_tensor(mask_table(K), device=dev)
    scfg = solver.SolverConfig(
        n_stations=N, n_dirs=K, n_poly=backend.n_poly,
        admm_iters=backend.admm_iters, lbfgs_iters=backend.lbfgs_iters,
        init_iters=backend.init_iters, polytype=backend.polytype)

    def _calibrate(ep, mask):
        C = ep.Ccal * mask[None, :, None, None, None]
        return solver.solve_admm(ep.V, C, ep.freqs, float(ep.f0), ep.rho,
                                 scfg, n_chunks=backend.n_chunks,
                                 admm_iters=maxiter)

    def _infmap(ep, res, mask):
        """``RadioBackend.influence_image`` with rho*mask + (1 - mask) and
        alpha 0 (``DemixingEnv._influence_map``), each band's map imaged
        by the direct DFT: kernel 1 on the card."""
        if not provide_influence:
            return torch.zeros((npix, npix), device=dev)
        rho_m = ep.rho * mask + (1.0 - mask)
        alpha = torch.zeros(K, device=dev)
        uvw_flat = ep.uvw.reshape(-1, 3)
        imgs = []
        for fi in range(backend.n_freqs):
            hadd = influence_mod.consensus_hadd_scalars(
                rho_m, alpha, ep.freqs, float(ep.f0), fi,
                n_poly=backend.n_poly, polytype=backend.polytype)
            Rk = solver.residual_to_kernel(res.residual[fi])
            inf = influence_mod.influence_visibilities(
                Rk, ep.Ccal[fi], res.J[fi], hadd, N, backend.n_chunks)
            ivis = influence_mod.stokes_i_influence(inf.vis)
            imgs.append(imager.dirty_image_sr(
                uvw_flat, ivis.contiguous(), float(ep.freqs_host[fi]),
                float(ep.cell_host), npix=npix))
        return torch.mean(torch.stack(imgs), dim=0)

    def _aic_reward(std_res, std_data, ksel):
        """demixingenv.py:338-355 with the fixed maxiter."""
        r = -N * N * std_res ** 2 / (std_data ** 2 + EPS) - ksel * N
        return (r - REWARD_MEAN) / REWARD_STD - maxiter / 100.0

    def _obs(ep, res, mask):
        img = _infmap(ep, res, mask) * INF_SCALE
        md = ep.metadata.clone()
        md[:K] = torch.where(mask > 0, 0.0, md[:K])
        return torch.cat([img.reshape(-1), md * META_SCALE])

    def _actor_rollout(agent, wl: DemixWorkload, generator):
        trs = []
        for e in range(rollout_epochs):
            ep = DemixWorkload(*(f[e] for f in wl))
            std_data = backend.noise_std(ep.V)
            mask0 = tbl[0]
            res0 = _calibrate(ep, mask0)
            r0 = _aic_reward(backend.noise_std(res0.residual), std_data, 1.0)
            o = _obs(ep, res0, mask0)
            for _ in range(rollout_steps):
                g = -torch.log(-torch.log(torch.rand(
                    (1, n_actions), generator=generator, device=dev)
                    .clamp_(min=torch.finfo(torch.float32).tiny)))
                if record_logp:
                    a, lp = dsac.choose_action_logp(agent_cfg, agent,
                                                    o[None], g)
                    a, lp = a[0], lp[0]
                else:
                    a = dsac.choose_action(agent_cfg, agent, o[None], g)[0]
                mask = tbl[a]
                res = _calibrate(ep, mask)
                reward = _aic_reward(backend.noise_std(res.residual),
                                     std_data, torch.sum(mask)) - r0
                o2 = _obs(ep, res, mask)
                tr = {"state": o, "action": a.to(torch.int32),
                      "reward": reward, "new_state": o2,
                      "done": torch.zeros((), dtype=torch.bool, device=dev)}
                if record_logp:
                    tr["behavior_logp"] = lp
                trs.append(tr)
                o = o2
        return {k: torch.stack([t[k] for t in trs]) for k in trs[0]}

    return _actor_rollout


def _lanes_rollout(rollout_one, agent, wl, generator, n_lanes):
    """``n_lanes`` actors' (or one actor's lanes') rollouts one after
    another, flattened lane-major."""
    parts = [rollout_one(agent, DemixWorkload(*(f[i] for f in wl)),
                         generator) for i in range(n_lanes)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def make_distributed_demix_sac(backend: radio.RadioBackend, K: int,
                               agent_cfg: dsac.DSACConfig, mesh,
                               n_actors: int, rollout_epochs: int = 2,
                               rollout_steps: int = 5,
                               provide_influence: bool = False,
                               maxiter: int = 10,
                               learn_per_transition: bool = False):
    """``(init_fn, make_workloads_fn, run_episode)`` on ``mesh``'s device.
    ``run_episode(st, wl, generator)`` rolls the ``n_actors`` actors out
    with the episode's frozen weights, stores their transitions and
    learns (per transition, or once).  ``provide_influence`` fills the
    observation's map (else zeros, and ``agent_cfg.use_image`` should be
    False).  On a mesh of processes each rank makes the workloads of its
    block of the actors and rolls them out (its generator stepped past the
    other ranks' draws), the transitions are all-gathered in actor order,
    and rank 0's agent and ring priorities are broadcast after each
    learn (``parallel/trainer.DataParallel``)."""
    dp = DataParallel(mesh, n_actors)
    dev = mesh.device
    n_trans = rollout_epochs * rollout_steps
    spec = dsac.transition_spec(agent_cfg.obs_dim)
    rollout = make_demix_actor_rollout(
        backend, K, agent_cfg, rollout_epochs, rollout_steps,
        provide_influence=provide_influence, maxiter=maxiter)

    def init_fn(generator) -> DistDemixState:
        return DistDemixState(dsac.dsac_init(agent_cfg, generator, dev),
                              rp.replay_init(agent_cfg.mem_size, spec, dev))

    def skip(n_actors_, generator):
        """Advance ``generator`` past the draws of ``n_actors_`` actors'
        rollouts (another rank's), as drawing them would."""
        for _ in range(n_actors_ * n_trans):
            torch.rand((1, agent_cfg.n_actions), generator=generator,
                       device=dev)

    def run_episode(st: DistDemixState, wl: DemixWorkload, generator):
        skip(dp.start, generator)
        flat = _lanes_rollout(rollout, st.agent, wl, generator, dp.n_local)
        skip(n_actors - dp.start - dp.n_local, generator)
        flat = dp.gather(flat)
        if learn_per_transition:
            for i in range(n_actors * n_trans):
                rp.replay_add(st.buf, {k: v[i] for k, v in flat.items()})
                m = dsac.learn(agent_cfg, st.agent, st.buf, generator)
                dp.sync(st.agent, st.buf)
            metrics = {"critic_loss": m["critic_loss"]}
        else:
            rp.replay_add_batch(st.buf, flat)
            metrics = dsac.learn(agent_cfg, st.agent, st.buf, generator)
            dp.sync(st.agent, st.buf)
        metrics["mean_reward"] = torch.mean(flat["reward"])
        st.episode += 1
        return st, metrics

    def make_workloads_fn(key):
        return make_workloads(backend, K, n_actors, rollout_epochs, key,
                              actors=range(dp.start,
                                           dp.start + dp.n_local))

    return init_fn, make_workloads_fn, run_episode


def _demix_agent_cfg(backend: radio.RadioBackend, K: int,
                     provide_influence: bool, is_clip: float,
                     ere_eta: float, agent_kwargs) -> dsac.DSACConfig:
    md_dim = 3 * K + 2
    return dsac.DSACConfig(
        obs_dim=backend.npix * backend.npix + md_dim,
        n_actions=2 ** (K - 1), img_shape=(backend.npix, backend.npix),
        use_image=provide_influence, is_clip=is_clip, ere_eta=ere_eta,
        **(agent_kwargs or {}))


def train_distributed_demix(seed=0, episodes=10, n_actors=None, mesh=None,
                            K=4, backend=None, provide_influence=False,
                            agent_kwargs=None, quiet=False,
                            rollout_epochs=2, rollout_steps=5,
                            metrics=None, diag=False, watchdog=False,
                            ckpt_dir=None, ckpt_every=0, resume=False,
                            device="cuda"):
    """Host loop of the one-program demix learner (run_process +
    Learner.run_episodes, distributed_per_sac.py:193-229).  The workload
    keys follow the JAX package's chain (``PRNGKey(seed)``, split per
    episode), the agent's draws a generator seeded ``seed``.  Returns
    ``(state, scores)``."""
    import time

    from smartcal_tpu_torch.parallel import multihost
    from smartcal_tpu_torch.runtime import pack_replay, unpack_replay
    from smartcal_tpu_torch.train.blocks import (TrainRuntime,
                                                 generator_state,
                                                 set_generator_state,
                                                 train_obs)

    backend = backend or radio.RadioBackend(
        device=multihost.local_device() or device)
    mesh = _mesh_for(mesh, backend.device)
    dev = mesh.device
    n_actors = n_actors or mesh.shape[AXIS_DATA]
    agent_cfg = _demix_agent_cfg(backend, K, provide_influence, 0.0, 1.0,
                                 agent_kwargs)
    init_fn, make_wl, run_episode = make_distributed_demix_sac(
        backend, K, agent_cfg, mesh, n_actors,
        rollout_epochs=rollout_epochs, rollout_steps=rollout_steps,
        provide_influence=provide_influence)
    key = prng.split(prng.PRNGKey(seed))[0]
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = init_fn(gen)
    scores = []
    n_trans = n_actors * rollout_epochs * rollout_steps
    tob = train_obs("demix_learner", metrics=metrics, quiet=quiet,
                    diag=diag, watchdog=watchdog, seed=seed,
                    n_actors=n_actors, K=K)
    rt = TrainRuntime("demix_learner",
                      ckpt_dir=multihost.rank_path(ckpt_dir),
                      ckpt_every=ckpt_every, resume=resume, tob=tob)
    ep0 = 0
    restored = rt.restore()
    if restored is not None:
        st = DistDemixState(
            dsac.DSACState.from_host(agent_cfg, restored["agent_state"],
                                     dev),
            unpack_replay(restored["replay"], dev), restored["episode"])
        key = np.asarray(restored["key"], np.uint32)
        set_generator_state(gen, restored["generator"],
                            restored.get("generator_device"))
        scores = list(restored["scores"])
        ep0 = int(restored["episode"])

    def ckpt_payload(ep, key):
        return {"kind": "dist_demix", "episode": ep + 1,
                "scores": list(scores), "agent_state": st.agent.to_host(),
                "replay": pack_replay(st.buf), "key": np.array(key),
                "generator": generator_state(gen),
                "generator_device": dev.type}

    try:
        for ep in range(ep0, episodes):
            key, kw, _ = prng.split(key, 3)
            with tob.span("learner_episode", episode=ep):
                with tob.span("make_workloads"):
                    wl = make_wl(kw)
                t0 = time.perf_counter()
                st, metrics_out = run_episode(st, wl, gen)
                score = float(metrics_out["mean_reward"])
                wall = time.perf_counter() - t0
            scores.append(score)
            obs.gauge_set("actor_transitions_per_s",
                          round(n_trans / max(wall, 1e-9), 2))
            tripped = False
            if tob.collect_diag:
                tripped = tob.record_diag(
                    {"critic_loss": float(metrics_out["critic_loss"])},
                    episode=ep)
            tripped = tob.log_replay_health(st.buf, episode=ep) or tripped
            tob.episode(ep, score, scores, echo=False, transitions=n_trans,
                        weight_staleness_steps=rollout_epochs
                        * rollout_steps)
            tob.echo(f"episode {ep} mean reward {scores[-1]:.4f}",
                     event=None)
            if tripped:
                break
            rt.maybe_checkpoint(ep + 1, lambda: ckpt_payload(ep, key))
    finally:
        tob.close()
    return st, scores


def _demix_fleet_work_fn(backend_kwargs=None, K=4, agent_kwargs=None,
                         provide_influence=False, is_clip=0.0,
                         ere_eta=1.0, batch_envs=1, rollout_epochs=1,
                         rollout_steps=3, seed=0, _backend=None,
                         device="cuda"):
    """The demix fleet actor's work function from picklable arguments
    (the enet twin is ``parallel/learner._enet_fleet_work_fn``): actor
    threads may pass an already-built ``_backend``, worker processes build
    theirs from ``backend_kwargs``.  Per (actor, iteration) the key splits
    into the workload key (the actor simulates its own ``batch_envs``
    lanes) and the rollout's generator seed."""
    backend = _backend or radio.RadioBackend(device=device,
                                             **(backend_kwargs or {}))
    agent_cfg = _demix_agent_cfg(backend, K, provide_influence, is_clip,
                                 ere_eta, agent_kwargs)
    rollout_one = make_demix_actor_rollout(
        backend, K, agent_cfg, rollout_epochs, rollout_steps,
        provide_influence=provide_influence, record_logp=is_clip > 0)

    def rollout(agent, k):
        k_wl, k_roll = prng.split(k)
        wl = make_workloads(backend, K, batch_envs, rollout_epochs, k_wl)
        return _lanes_rollout(rollout_one, agent, wl,
                              key_generator(k_roll, backend.device),
                              batch_envs)

    return fleet_work_fn(
        rollout, prng.PRNGKey(seed ^ 0x0AC7D32),
        lambda: dsac.build_nets(agent_cfg, device=backend.device)[0],
        backend.device)


def train_supervised_demix(seed=0, episodes=5, n_actors=2, K=4,
                           backend=None, provide_influence=False,
                           agent_kwargs=None, quiet=False,
                           rollout_epochs=1, rollout_steps=3, metrics=None,
                           diag=False, watchdog=False,
                           heartbeat_timeout=300.0, max_restarts=3,
                           queue_timeout=300.0, max_empty_rounds=10,
                           restart_backoff=None, batch_envs=1,
                           is_clip=0.0, ere_eta=1.0, publish_every=1,
                           ckpt_dir=None, ckpt_every=0, keep_ckpts=3,
                           resume=False, actor_mode="thread",
                           replay_shards=0, sim_hosts=1,
                           backend_kwargs=None, device="cuda",
                           worker_device=None):
    """The supervised actor fleet for the demixing workload (see
    ``parallel/learner.train_supervised``): each actor simulates its own
    workload lanes and rolls them out against the newest weights.
    ``actor_mode="process"`` needs ``backend_kwargs`` (a built backend
    cannot cross a process boundary); the CUDA kernels are built in this
    process before any worker is spawned.  Returns ``((agent_state, buf),
    scores, summary)``."""
    from smartcal_tpu_torch.runtime import Fleet
    from smartcal_tpu_torch.train.blocks import TrainRuntime, train_obs

    if actor_mode == "process" and backend is not None \
            and backend_kwargs is None:
        raise ValueError(
            "actor_mode='process' needs backend_kwargs (the picklable "
            "RadioBackend constructor kwargs): a built backend object "
            "cannot be shipped to worker processes")
    backend = backend or radio.RadioBackend(device=device,
                                            **(backend_kwargs or {}))
    dev = backend.device
    agent_cfg = _demix_agent_cfg(backend, K, provide_influence, is_clip,
                                 ere_eta, agent_kwargs)
    n_trans = batch_envs * rollout_epochs * rollout_steps
    wdev = str(worker_device or dev)
    factory_kwargs = dict(backend_kwargs=dict(backend_kwargs or {}), K=K,
                          agent_kwargs=dict(agent_kwargs or {}),
                          provide_influence=provide_influence,
                          is_clip=is_clip, ere_eta=ere_eta,
                          batch_envs=batch_envs,
                          rollout_epochs=rollout_epochs,
                          rollout_steps=rollout_steps, seed=seed)
    if actor_mode == "process" and dev.type == "cuda":
        from smartcal_tpu_torch.ops import build
        build.build()                  # once here, not once per worker
    work_fn = (None if actor_mode == "process"
               else _demix_fleet_work_fn(_backend=backend, **factory_kwargs))
    worker_spec = {
        "factory":
            "smartcal_tpu_torch.parallel.demix_learner:_demix_fleet_work_fn",
        "kwargs": dict(factory_kwargs, device=wdev), "device": wdev}

    def ingest_batch(agent, buf, host_trs, generator, weights_version,
                     learner_version):
        return fused_ingest(agent_cfg, dsac.learn, agent, buf, host_trs,
                            generator, weights_version, learner_version)

    gen = torch.Generator(device=dev).manual_seed(seed)
    agent = dsac.dsac_init(agent_cfg, gen, dev)
    spec = dsac.transition_spec(agent_cfg.obs_dim)
    if is_clip > 0:
        spec = rp.versioned_spec(spec)
    if replay_shards:
        buf = make_sharded_fleet_buffer(agent_cfg.mem_size, spec,
                                        replay_shards, dev)
    else:
        buf = rp.replay_init(agent_cfg.mem_size, spec, dev)

    tob = train_obs("demix_learner_supervised", metrics=metrics,
                    quiet=quiet, diag=diag, watchdog=watchdog, seed=seed,
                    n_actors=n_actors, K=K, batch_envs=batch_envs,
                    is_clip=is_clip, ere_eta=ere_eta,
                    actor_mode=actor_mode, replay_shards=replay_shards,
                    sim_hosts=sim_hosts)
    rt = TrainRuntime("demix_learner_supervised", ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, keep=keep_ckpts,
                      resume=resume, tob=tob)
    fleet = Fleet(n_actors, work_fn, name="demix-actor",
                  heartbeat_timeout=heartbeat_timeout,
                  max_restarts=max_restarts, backoff=restart_backoff,
                  seed=seed, actor_mode=actor_mode,
                  worker_spec=worker_spec if actor_mode == "process"
                  else None, hosts=sim_hosts)
    return run_supervised_loop(
        fleet, ingest_batch, agent, buf, gen, episodes, n_trans, tob,
        queue_timeout=queue_timeout, max_empty_rounds=max_empty_rounds,
        rt=rt, publish_every=publish_every,
        agent_from_host=lambda h: dsac.DSACState.from_host(agent_cfg, h,
                                                           dev),
        weights_of=actor_weights)


def main(argv=None):
    """CLI (the run_process entry of distributed_per_sac.py:193-229).

    Usage: python -m smartcal_tpu_torch.parallel.demix_learner --episodes 10
        [--supervised] [--n-actors 8] [--K 4] [--small]
        [--provide_influence] [--device cpu]
        [--coordinator host:port --num_processes N --process_id i]

    With ``--num_processes`` N > 1 (the same ``--coordinator`` and
    ``--num_processes`` on every process, each its own ``--process_id``)
    the one-program learner runs with one ``dp`` position per process.
    """
    import argparse

    from smartcal_tpu_torch.parallel import multihost
    from smartcal_tpu_torch.train.blocks import (add_batched_args,
                                                 add_fleet_args,
                                                 add_obs_args,
                                                 add_runtime_args,
                                                 diag_from_args)

    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--episodes", type=int, default=10)
    p.add_argument("--actors", type=int, default=None,
                   help="deprecated alias of --n-actors")
    p.add_argument("--K", type=int, default=6)
    p.add_argument("--stations", type=int, default=14)
    p.add_argument("--npix", type=int, default=128)
    p.add_argument("--small", action="store_true")
    p.add_argument("--provide_influence", action="store_true")
    p.add_argument("--rollout_epochs", type=int, default=2,
                   help="episodes per actor per learner episode")
    p.add_argument("--rollout_steps", type=int, default=5)
    p.add_argument("--supervised", action="store_true",
                   help="the supervised actor fleet "
                        "(train_supervised_demix) instead of the "
                        "one-program learner")
    p.add_argument("--heartbeat_timeout", type=float, default=300.0)
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the "
                        "CPU)")
    add_fleet_args(p)
    add_batched_args(p)
    add_obs_args(p)
    add_runtime_args(p)
    multihost.add_cli_args(p)
    args = p.parse_args(argv)
    n_actors = args.n_actors or args.actors
    multi = multihost.initialize_from_args(args)
    if multi:
        obs.echo(f"multihost: {multihost.runtime_summary()}",
                 event="multihost", **multihost.runtime_summary())
        if args.supervised or args.actor_mode == "process" \
                or args.replay_shards or args.sim_hosts > 1:
            raise SystemExit(
                "the supervised actor fleet is one learner process; a job "
                "of several processes runs the one-program learner")
    if args.small:
        backend_kwargs = dict(n_stations=6, n_times=4, tdelta=2,
                              npix=16, admm_iters=2, lbfgs_iters=3,
                              init_iters=4)
    else:
        backend_kwargs = dict(n_stations=args.stations, npix=args.npix)
    backend = radio.RadioBackend(
        device=multihost.local_device() or args.device, **backend_kwargs)
    if args.actor_mode == "process" or args.replay_shards \
            or args.sim_hosts > 1:
        args.supervised = True
    if args.supervised:
        _, scores, summary = train_supervised_demix(
            seed=args.seed, episodes=args.episodes,
            n_actors=n_actors or 2, K=args.K, backend=backend,
            backend_kwargs=backend_kwargs,
            provide_influence=args.provide_influence,
            rollout_epochs=args.rollout_epochs,
            rollout_steps=args.rollout_steps,
            quiet=args.quiet, metrics=args.metrics,
            diag=diag_from_args(args),
            watchdog=getattr(args, "watchdog", False),
            heartbeat_timeout=args.heartbeat_timeout,
            max_restarts=args.max_restarts,
            batch_envs=args.batch_envs, is_clip=args.is_clip,
            ere_eta=args.ere_eta, publish_every=args.publish_every,
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            keep_ckpts=args.keep_ckpts, resume=args.resume,
            actor_mode=args.actor_mode,
            replay_shards=args.replay_shards, sim_hosts=args.sim_hosts,
            device=args.device)
        exit_if_fleet_failed(summary)
        return scores
    _, scores = train_distributed_demix(
        seed=args.seed, episodes=args.episodes, n_actors=n_actors,
        K=args.K, backend=backend,
        provide_influence=args.provide_influence,
        rollout_epochs=args.rollout_epochs,
        rollout_steps=args.rollout_steps,
        quiet=args.quiet, metrics=args.metrics,
        diag=diag_from_args(args),
        watchdog=getattr(args, "watchdog", False),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, device=args.device)
    return scores


if __name__ == "__main__":
    main()
