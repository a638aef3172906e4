"""Distributed prioritized-experience-replay learner/actor training
(counterpart of smartcal_tpu/parallel/learner.py).

Parity target: ``elasticnet/distributed_per_sac.py``: a Learner owns the
SAC agent and a PER ring; per episode its Actors roll out ``epochs x
steps`` env steps with a frozen copy of the actor weights and upload their
buffers, which the Learner ingests (learning per transition or per
buffer).

Two forms, as in the JAX package:

* :func:`train_distributed`: one program.  The JAX package shards the
  actors over the mesh's ``dp`` axis; here the actors are the lanes of
  one batched rollout (``envs/enet``'s lane form: the actors' inner solves
  are the lanes of one L-BFGS solve), followed by ingestion and learning.
  In a job of several processes (``parallel/multihost``) each process
  rolls out its block of the actors and the learner is replicated
  (``parallel/trainer.DataParallel``), its ring optionally sharded over
  the processes;
* :func:`train_supervised`: the asynchronous fleet.  Each actor is a
  thread (its own ``torch.Generator`` and CUDA stream) or a spawned
  process (``runtime/supervisor``) rolling out ``batch_envs`` lanes against
  the newest published weights snapshot and shipping version-stamped host
  transition blocks; the learner ingests whatever arrived through one
  fused device step (store, PER/ERE sample, IS-clipped learn, priority
  update; the sampled batch never reaches the host), publishes weights
  every ``publish_every`` rounds and restarts dead actors.

Per-(actor, iteration) randomness: actor ``i`` at iteration ``n`` seeds its
generator from ``fold_in(fold_in(base, i), n)`` (``prng.fold_in``), so a
restarted actor continues its predecessor's stream and a thread or a
process actor computes the same rollout.
"""

import contextlib
import threading
import time
import types

import numpy as np
import torch

from smartcal_tpu_torch import obs, prng, resolve_device
from smartcal_tpu_torch.envs import enet
from smartcal_tpu_torch.parallel.mesh import AXIS_DATA
from smartcal_tpu_torch.parallel.trainer import DataParallel
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl import sac


class DistPERState:
    """The one-program learner's state: agent, ring, episode counter."""

    def __init__(self, agent, buf, episode=0):
        self.agent, self.buf, self.episode = agent, buf, int(episode)


def _stack_lanes(steps_per_epoch, n_trans):
    """[[step dict of (E, ...) tensors] per epoch] -> one dict of
    (E * epochs * steps, ...) tensors, lane-major (the JAX package's
    ``vmap`` over lanes, flattened)."""
    out = {}
    for k in steps_per_epoch[0][0]:
        x = torch.stack([torch.stack([s[k] for s in ep], 1)
                         for ep in steps_per_epoch], 1)
        out[k] = x.reshape((n_trans,) + tuple(x.shape[3:]))
    return out


def make_fleet_rollout(env_cfg: enet.EnetConfig, agent_cfg: sac.SACConfig,
                       batch_envs: int, rollout_epochs: int,
                       rollout_steps: int, use_hint: bool = False,
                       record_logp: bool = True, dp=None):
    """An actor's program ``(agent, generator) -> transitions``: per epoch,
    ``batch_envs`` env lanes reset (with the first noise draw and, with
    ``use_hint``, the lanes' hints), then ``rollout_steps`` lane steps
    against ``agent.actor`` (the reference ``Actor.run_observations``,
    distributed_per_sac.py:123-146).  Returns one block of
    ``batch_envs * rollout_epochs * rollout_steps`` transitions, lane-major.
    ``record_logp`` adds ``behavior_logp`` (log pi of each sampled action:
    the denominator of the learner's IMPACT ratio); the actions are the
    same draws either way.  Draws come from ``generator``, on the device
    the rollout runs on.  ``dp`` (``parallel/trainer.DataParallel``) runs
    this rank's block of the lanes: the draws are made for every lane and
    sliced, and the block's transitions come back (lane-major)."""
    if dp is not None and record_logp:
        raise ValueError("a data-parallel rollout records no log-probs "
                         "(the one-program learner does not read them)")
    E = batch_envs
    local = dp.local if dp is not None else (lambda x: x)
    E_l = dp.n_local if dp is not None else E
    n_trans = E_l * rollout_epochs * rollout_steps

    def _rollout(agent, generator):
        dev = generator.device

        def randn(n):
            return local(torch.randn((E, n), generator=generator,
                                     device=dev))

        epochs = []
        for _ in range(rollout_epochs):
            st, o = enet.reset_lanes(env_cfg, *(
                local(d) for d in enet.reset_draws_lanes(env_cfg, E,
                                                         generator, dev)))
            st = enet.draw_noise(env_cfg, st, randn(env_cfg.N))
            hint = (enet.get_hint_lanes(env_cfg, st) if use_hint
                    else torch.zeros((E_l, agent_cfg.n_actions),
                                     device=dev))
            steps = []
            for t in range(rollout_steps):
                noise = torch.randn((E, agent_cfg.n_actions),
                                    generator=generator, device=dev)
                if record_logp:
                    a, lp = sac.choose_action_logp(agent_cfg, agent, o,
                                                   noise)
                elif dp is not None:
                    a = dp.act(lambda o_, n_: sac.choose_action(
                        agent_cfg, agent, o_, n_), o, noise)
                else:
                    a = sac.choose_action(agent_cfg, agent, o, noise)
                env_noise = None if t == 0 else randn(env_cfg.N)
                st, o2, r, done = enet.step_lanes(env_cfg, st, a, env_noise,
                                                  keepnoise=t == 0)
                tr = {"state": o, "action": a, "reward": r,
                      "new_state": o2, "done": done, "hint": hint}
                if record_logp:
                    tr["behavior_logp"] = lp
                steps.append(tr)
                o = o2
            epochs.append(steps)
        return _stack_lanes(epochs, n_trans)

    return _rollout


def make_actor_rollout(env_cfg: enet.EnetConfig, agent_cfg: sac.SACConfig,
                       rollout_epochs: int, rollout_steps: int,
                       use_hint: bool = False, record_logp: bool = False):
    """One actor's rollout ``(agent, generator) -> transitions`` with leading
    axis ``rollout_epochs * rollout_steps``: :func:`make_fleet_rollout`
    with one lane."""
    return make_fleet_rollout(env_cfg, agent_cfg, 1, rollout_epochs,
                              rollout_steps, use_hint=use_hint,
                              record_logp=record_logp)


def lane_keys(key, n_lanes: int) -> np.ndarray:
    """The fleet's per-lane keys: lane i follows ``fold_in(key, i)``."""
    return np.stack([prng.fold_in(key, i) for i in range(n_lanes)])


def flatten_lanes(trs, n_trans: int):
    """Collapse a ``(lanes, per_lane, ...)`` transition dict into one
    ``(n_trans, ...)`` block."""
    return {k: v.reshape((n_trans,) + tuple(v.shape[2:]))
            for k, v in trs.items()}


def actor_weights(agent) -> dict:
    """The weights snapshot a fleet publishes: a copy of the actor's state
    dict (the learner updates its own tensors in place).  The copy is
    complete when this returns, so actor threads may read it from their
    own streams."""
    snap = {k: v.detach().clone() for k, v in agent.actor.state_dict()
            .items()}
    dev = next(iter(snap.values())).device
    if dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()
    return snap


def _stream(stream):
    """The context of running on ``stream`` (none on the CPU)."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


class _ActorLocal(threading.local):
    """Per-thread actor module and CUDA stream of a fleet work function."""
    actor = None
    stream = None


def _load_actor(local, build_actor, weights, device):
    """The thread's actor module holding ``weights`` (tensors or host
    arrays)."""
    if local.actor is None:
        local.actor = build_actor().requires_grad_(False)
        if device.type == "cuda":
            local.stream = torch.cuda.Stream(device)
    tensors = {}
    for k, v in weights.items():
        if torch.is_tensor(v):
            if local.stream is not None and v.device.type == "cuda":
                v.record_stream(local.stream)
            tensors[k] = v
        else:
            tensors[k] = torch.as_tensor(np.asarray(v))
    with _stream(local.stream):
        local.actor.load_state_dict(tensors)
    return types.SimpleNamespace(actor=local.actor)


def key_generator(key, device) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded from a PRNG key."""
    return torch.Generator(device=device).manual_seed(
        prng.generator_seed(key))


def warm_cuda_libraries(device) -> None:
    """Load torch's lazily loaded CUDA linear-algebra library in this
    thread: two actor threads that reach it first at the same time race
    (``lazy wrapper should be called at most once``, seen on an H100)."""
    if device.type == "cuda":
        a = torch.eye(2, device=device)
        torch.linalg.eigvalsh(a)
        torch.linalg.solve(a, a)


def fleet_work_fn(rollout, base_key, build_actor, device):
    """The work function ``(actor_id, iteration, weights) -> host
    transitions`` of a fleet actor: the fault plan's kill and delay, the
    per-(actor, iteration) key ``fold_in(fold_in(base_key, actor),
    iteration)``, ``rollout(agent, key)`` on the thread's own CUDA stream
    (the rollout seeds its generator from the key), and the block copied
    to host numpy (as the JAX package's ``jax.device_get``)."""
    from smartcal_tpu_torch.runtime import faults as rt_faults

    warm_cuda_libraries(device)
    local = _ActorLocal()

    def work_fn(actor_id, iteration, weights):
        rt_faults.maybe_delay("actor_rollout", iteration)
        if rt_faults.should_kill_actor(actor_id, iteration):
            raise rt_faults.FaultInjected(
                f"actor {actor_id} killed at iteration {iteration}")
        k = prng.fold_in(prng.fold_in(base_key, actor_id), iteration)
        agent = _load_actor(local, build_actor, weights, device)
        with _stream(local.stream):
            trs = rollout(agent, k)
            return {n: v.cpu().numpy() for n, v in trs.items()}

    return work_fn


def _enet_fleet_work_fn(env_kwargs=None, agent_kwargs=None, use_hint=False,
                        is_clip=0.0, ere_eta=1.0, batch_envs=1,
                        rollout_epochs=2, rollout_steps=5, seed=0,
                        device="cuda"):
    """The enet fleet actor's work function from picklable arguments: the
    one definition behind actor threads (called in-process) and actor
    processes (the ``worker_spec`` factory, called in each worker), so the
    actor mode changes where a rollout runs, never what it computes."""
    dev = resolve_device(device)
    env_cfg = enet.EnetConfig(**(env_kwargs or {}))
    agent_kwargs = dict(agent_kwargs or {})
    agent_kwargs.setdefault("prioritized", True)
    agent_cfg = sac.SACConfig(obs_dim=env_cfg.obs_dim, n_actions=2,
                              use_hint=use_hint, is_clip=is_clip,
                              ere_eta=ere_eta, **agent_kwargs)
    rollout = make_fleet_rollout(env_cfg, agent_cfg, batch_envs,
                                 rollout_epochs, rollout_steps,
                                 use_hint=use_hint, record_logp=is_clip > 0)
    return fleet_work_fn(lambda agent, k: rollout(agent,
                                                  key_generator(k, dev)),
                         prng.PRNGKey(seed ^ 0x0AC7035),
                         lambda: sac.build_nets(agent_cfg, device=dev)[0],
                         dev)


def make_sharded_fleet_buffer(mem_size: int, spec: dict,
                              replay_shards: int, device="cuda", mesh=None):
    """The sharded ring (``rl/replay_sharded``) on ``device``, placed on
    ``mesh``'s ``rp`` axis when given; the shard count must divide the
    ring size."""
    from smartcal_tpu_torch.rl import replay_sharded as rps

    if mem_size % replay_shards != 0:
        raise ValueError(
            f"--replay-shards {replay_shards} must divide mem_size "
            f"{mem_size} (equal round-robin ring shards)")
    return rps.place_on_mesh(rps.replay_init(mem_size, spec, replay_shards,
                                             device=device), mesh)


def make_distributed_per_sac(env_cfg: enet.EnetConfig,
                             agent_cfg: sac.SACConfig, mesh, n_actors: int,
                             rollout_epochs: int = 10,
                             rollout_steps: int = 10,
                             use_hint: bool = False,
                             learn_per_transition: bool = False,
                             replay_shards: int = 0):
    """``(init_fn, run_episode)`` on ``mesh``'s device.  One
    ``run_episode(st, generator)`` is the reference Learner's
    ``run_episodes`` body (:60-74): the ``n_actors`` actors roll out with
    the episode's frozen weights as the lanes of one program, then the
    learner stores everything and learns once per transition
    (``learn_per_transition``, the reference cadence) or once per
    episode.  On a mesh of processes each rank rolls out its block of the
    actors (``dp``), the blocks are all-gathered in actor order, every
    rank stores and learns, and rank 0's agent (and the replicated ring's
    priorities) is broadcast after each learn.  ``replay_shards`` > 0
    keeps the ring sharded (``rl/replay_sharded``), over an ``rp`` axis of
    the same processes in a job of several."""
    dp = DataParallel(mesh, n_actors)
    dev = mesh.device
    n_trans = rollout_epochs * rollout_steps
    rollout = make_fleet_rollout(env_cfg, agent_cfg, n_actors,
                                 rollout_epochs, rollout_steps,
                                 use_hint=use_hint, record_logp=False,
                                 dp=dp)
    spec = rp.transition_spec(env_cfg.obs_dim, agent_cfg.n_actions)

    def init_fn(generator) -> DistPERState:
        agent = sac.sac_init(agent_cfg, generator, dev)
        if replay_shards:
            buf = make_sharded_fleet_buffer(agent_cfg.mem_size, spec,
                                            replay_shards, dev,
                                            mesh=_replay_mesh(mesh))
        else:
            buf = rp.replay_init(agent_cfg.mem_size, spec, dev)
        return DistPERState(agent, buf, 0)

    def run_episode(st: DistPERState, generator):
        flat = dp.gather(rollout(st.agent, generator))
        rpb = rp.backend_for(st.buf)
        if learn_per_transition:
            for i in range(n_actors * n_trans):
                rpb.replay_add(st.buf, {k: v[i] for k, v in flat.items()})
                m = sac.learn(agent_cfg, st.agent, st.buf, generator)
                dp.sync(st.agent, st.buf)
            metrics = {"critic_loss": m["critic_loss"]}
        else:
            rpb.replay_add_batch(st.buf, flat)
            metrics = sac.learn(agent_cfg, st.agent, st.buf, generator)
            dp.sync(st.agent, st.buf)
        metrics["mean_reward"] = torch.mean(flat["reward"])
        st.episode += 1
        return st, metrics

    return init_fn, run_episode


def _replay_mesh(mesh):
    """An ``rp`` mesh over the processes of ``mesh`` (None on one
    process: the ring stays on the device)."""
    if not mesh.is_process:
        return None
    from smartcal_tpu_torch.parallel.mesh import AXIS_REPLAY, make_mesh

    return make_mesh((mesh.size,), (AXIS_REPLAY,))


def _mesh_for(mesh, device):
    """``mesh``, else the learner's default: one position per process in a
    job of several (``dp`` over the processes), else ``device``."""
    from smartcal_tpu_torch.parallel import multihost
    from smartcal_tpu_torch.parallel.mesh import make_mesh

    if mesh is not None:
        return mesh
    if multihost.is_initialized():
        return make_mesh()
    return make_mesh(devices=[resolve_device(device)])


def train_distributed(seed=0, episodes=100, n_actors=None, mesh=None,
                      env_kwargs=None, agent_kwargs=None, use_hint=False,
                      learn_per_transition=False, quiet=False,
                      rollout_epochs=10, rollout_steps=10, metrics=None,
                      diag=False, watchdog=False, ckpt_dir=None,
                      ckpt_every=0, resume=False, device="cuda",
                      replay_shards=0):
    """Host loop of the one-program learner (``run_process`` +
    ``Learner.run_episodes``, distributed_per_sac.py:60-82, :154-174).
    Records per-episode actor throughput (``actor_transitions_per_s``) and
    the weight-staleness bound (the rollout's epochs x steps).  In a job of
    several processes the default mesh has one ``dp`` position per
    process, ``replay_shards`` > 0 shards the ring over an ``rp`` axis of
    the same processes, and each rank checkpoints the whole state to its
    own directory (``multihost.rank_path``).  Returns ``(state,
    scores)``."""
    from smartcal_tpu_torch.parallel import multihost
    from smartcal_tpu_torch.rl import replay_sharded as rps
    from smartcal_tpu_torch.runtime import pack_replay, unpack_replay
    from smartcal_tpu_torch.train.blocks import (TrainRuntime,
                                                 generator_state,
                                                 set_generator_state,
                                                 train_obs)

    mesh = _mesh_for(mesh, device)
    dev = mesh.device
    n_actors = n_actors or mesh.shape[AXIS_DATA]
    env_cfg = enet.EnetConfig(**(env_kwargs or {}))
    agent_kwargs = dict(agent_kwargs or {})
    agent_kwargs.setdefault("prioritized", True)
    agent_cfg = sac.SACConfig(obs_dim=env_cfg.obs_dim, n_actions=2,
                              use_hint=use_hint, **agent_kwargs)
    init_fn, run_episode = make_distributed_per_sac(
        env_cfg, agent_cfg, mesh, n_actors, use_hint=use_hint,
        rollout_epochs=rollout_epochs, rollout_steps=rollout_steps,
        learn_per_transition=learn_per_transition,
        replay_shards=replay_shards)
    gen = torch.Generator(device=dev).manual_seed(seed)
    st = init_fn(gen)
    scores = []
    n_trans = n_actors * rollout_epochs * rollout_steps
    tob = train_obs("parallel_learner", metrics=metrics, quiet=quiet,
                    diag=diag, watchdog=watchdog, seed=seed,
                    n_actors=n_actors, replay_shards=replay_shards)
    rt = TrainRuntime("parallel_learner",
                      ckpt_dir=multihost.rank_path(ckpt_dir),
                      ckpt_every=ckpt_every, resume=resume, tob=tob)
    ep0 = 0
    restored = rt.restore()
    if restored is not None:
        buf = unpack_replay(restored["replay"], dev)
        if replay_shards:
            buf = rps.place_on_mesh(buf, _replay_mesh(mesh))
        st = DistPERState(
            sac.SACState.from_host(agent_cfg, restored["agent_state"], dev),
            buf, restored["episode"])
        set_generator_state(gen, restored["generator"],
                            restored.get("generator_device"))
        scores = list(restored["scores"])
        ep0 = int(restored["episode"])

    def ckpt_payload(ep):
        return {"kind": "dist_per", "episode": ep + 1,
                "scores": list(scores), "agent_state": st.agent.to_host(),
                "replay": pack_replay(st.buf),
                "generator": generator_state(gen),
                "generator_device": dev.type}

    try:
        for ep in range(ep0, episodes):
            t0 = time.perf_counter()
            with tob.span("learner_episode", episode=ep):
                st, metrics_out = run_episode(st, gen)
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
            rt.maybe_checkpoint(ep + 1, lambda: ckpt_payload(ep))
    finally:
        tob.close()
    return st, scores


def train_supervised(seed=0, episodes=50, n_actors=2, env_kwargs=None,
                     agent_kwargs=None, use_hint=False, rollout_epochs=2,
                     rollout_steps=5, metrics=None, quiet=False, diag=False,
                     watchdog=False, heartbeat_timeout=60.0, max_restarts=3,
                     queue_timeout=30.0, max_empty_rounds=20,
                     restart_backoff=None, batch_envs=1, is_clip=0.0,
                     ere_eta=1.0, publish_every=1, ckpt_dir=None,
                     ckpt_every=0, keep_ckpts=3, resume=False,
                     actor_mode="thread", replay_shards=0, sim_hosts=1,
                     device="cuda", worker_device=None):
    """The supervised actor fleet (the asynchronous sibling of
    :func:`train_distributed`; see the module doc).

    ``actor_mode`` "thread" runs each actor as a thread of this process on
    its own CUDA stream; "process" spawns each actor as a worker process
    on ``worker_device`` (default: the learner's ``device``) with per-slot
    ingest queues.  ``sim_hosts > 1`` (process mode) tags slot blocks with
    simulated host ids; ``replay_shards > 0`` swaps the flat ring for the
    sharded one; ``is_clip`` arms the IMPACT weighting (transitions carry
    the actor's snapshot version and behavior log-prob), ``ere_eta`` the
    recency knob, ``publish_every`` the publication cadence.  Checkpoints
    carry every actor slot's next iteration (``actor_iterations``).

    Returns ``((agent_state, buf), scores, summary)``; the summary has the
    restarts, the steady-state ``env_steps_per_s`` after the warm-up
    rounds and, with the IS-clip armed, ``transition_staleness_mean`` and
    ``is_clip_saturation``."""
    from smartcal_tpu_torch.runtime import Fleet
    from smartcal_tpu_torch.train.blocks import TrainRuntime, train_obs

    dev = resolve_device(device)
    env_cfg = enet.EnetConfig(**(env_kwargs or {}))
    agent_kwargs = dict(agent_kwargs or {})
    agent_kwargs.setdefault("prioritized", True)
    agent_cfg = sac.SACConfig(obs_dim=env_cfg.obs_dim, n_actions=2,
                              use_hint=use_hint, is_clip=is_clip,
                              ere_eta=ere_eta, **agent_kwargs)
    n_trans = batch_envs * rollout_epochs * rollout_steps
    wdev = str(worker_device or dev)
    factory_kwargs = dict(env_kwargs=dict(env_kwargs or {}),
                          agent_kwargs=agent_kwargs, use_hint=use_hint,
                          is_clip=is_clip, ere_eta=ere_eta,
                          batch_envs=batch_envs,
                          rollout_epochs=rollout_epochs,
                          rollout_steps=rollout_steps, seed=seed)
    work_fn = (None if actor_mode == "process" else
               _enet_fleet_work_fn(**factory_kwargs, device=str(dev)))
    worker_spec = {"factory":
                   "smartcal_tpu_torch.parallel.learner:_enet_fleet_work_fn",
                   "kwargs": dict(factory_kwargs, device=wdev),
                   "device": wdev}

    gen = torch.Generator(device=dev).manual_seed(seed)
    agent = sac.sac_init(agent_cfg, gen, dev)
    spec = rp.transition_spec(env_cfg.obs_dim, agent_cfg.n_actions)
    if is_clip > 0:
        spec = rp.versioned_spec(spec)
    if replay_shards:
        buf = make_sharded_fleet_buffer(agent_cfg.mem_size, spec,
                                        replay_shards, dev)
    else:
        buf = rp.replay_init(agent_cfg.mem_size, spec, dev)

    def ingest_batch(agent, buf, host_trs, generator, weights_version,
                     learner_version):
        return fused_ingest(agent_cfg, sac.learn, agent, buf, host_trs,
                            generator, weights_version, learner_version)

    tob = train_obs("parallel_learner_supervised", metrics=metrics,
                    quiet=quiet, diag=diag, watchdog=watchdog, seed=seed,
                    n_actors=n_actors, batch_envs=batch_envs,
                    is_clip=is_clip, ere_eta=ere_eta,
                    actor_mode=actor_mode, replay_shards=replay_shards,
                    sim_hosts=sim_hosts)
    rt = TrainRuntime("parallel_learner_supervised", ckpt_dir=ckpt_dir,
                      ckpt_every=ckpt_every, keep=keep_ckpts,
                      resume=resume, tob=tob)
    fleet = Fleet(n_actors, work_fn, name="enet-actor",
                  heartbeat_timeout=heartbeat_timeout,
                  max_restarts=max_restarts, backoff=restart_backoff,
                  seed=seed, actor_mode=actor_mode,
                  worker_spec=worker_spec if actor_mode == "process"
                  else None, hosts=sim_hosts)
    return run_supervised_loop(
        fleet, ingest_batch, agent, buf, gen, episodes, n_trans, tob,
        queue_timeout=queue_timeout, max_empty_rounds=max_empty_rounds,
        rt=rt, publish_every=publish_every,
        agent_from_host=lambda h: sac.SACState.from_host(agent_cfg, h, dev))


def fused_ingest(agent_cfg, learn_fn, agent, buf, host_trs, generator,
                 weights_version, learner_version):
    """The learner's fused step on one actor block: store the host block
    (stamped with the producing actor's snapshot version when the IS-clip
    is armed) and learn once through ``learn_fn`` (``sac.learn`` or
    ``sac_discrete.learn``).  Returns the learn's metrics (device
    tensors)."""
    flat = dict(host_trs)
    if agent_cfg.is_clip > 0:
        n = len(flat["reward"])
        flat["version"] = np.full((n,), weights_version, np.int32)
    rp.backend_for(buf).replay_add_batch(buf, flat)
    return learn_fn(agent_cfg, agent, buf, generator,
                    learner_version=learner_version)


def run_supervised_loop(fleet, ingest_batch, agent, buf, generator,
                        episodes, n_trans, tob, queue_timeout=30.0,
                        max_empty_rounds=20, rt=None, publish_every=1,
                        warmup_rounds=2, agent_from_host=None,
                        weights_of=actor_weights):
    """The supervised learners' ingest loop (enet and demix fleets).

    Per learner episode: collect the arrived actor blocks (at most one per
    slot), ingest and learn each through ``ingest_batch(agent, buf,
    host_trs, generator, weights_version, learner_version)``, bump the
    learner's version, publish ``weights_of(agent)`` every
    ``publish_every`` rounds, run one supervision pass and feed the
    watchdog (a trip stops and joins the fleet).  ``rt`` arms
    checkpoint/resume (``agent_from_host`` rebuilds the agent of a
    payload): the payload holds agent, ring, generator, scores, the
    learner version and ``actor_iterations``.

    Gauges per round: aggregate and per-actor ``transitions_per_s``,
    ``weight_staleness_versions``, ``ingest_queue_depth`` (aggregate and
    per slot), ``replay_shard_occupancy`` per shard, and with the IS-clip
    armed ``transition_staleness_mean`` / ``is_clip_saturation`` /
    ``is_clip_mean``.  The summary's ``env_steps_per_s`` is measured after
    ``warmup_rounds``."""
    from smartcal_tpu_torch.runtime import pack_replay, unpack_replay
    from smartcal_tpu_torch.train.blocks import (generator_state,
                                                 set_generator_state)

    scores = []
    ep0 = 0
    start_iters = None
    version0 = None
    dev = buf.device
    if rt is not None:
        restored = rt.restore()
        if restored is not None and restored.get("kind") != "fleet":
            raise ValueError(
                f"checkpoint kind {restored.get('kind')!r} is not a "
                "supervised-fleet payload; point --ckpt-dir at a fleet "
                "run's checkpoints")
        if restored is not None:
            agent = agent_from_host(restored["agent_state"])
            buf = unpack_replay(restored["replay"], dev)
            set_generator_state(generator, restored["generator"],
                                restored.get("generator_device"))
            scores = list(restored["scores"])
            ep0 = int(restored["episode"])
            start_iters = {int(k): int(v) for k, v
                           in restored["actor_iterations"].items()}
            version0 = int(restored["learner_version"])
    meas_trans, meas_t0, rounds = 0, None, 0
    stale_means, clip_sats, critic_losses = [], [], []
    sharded = hasattr(buf, "n_shards")
    stopped = None
    try:
        fleet.start(weights_of(agent), start_iterations=start_iters,
                    version=version0)
        learner_version = fleet.version
        ep, empty_rounds = ep0, 0
        while ep < episodes:
            t0 = time.perf_counter()
            batches = fleet.collect(max_items=fleet.n_actors,
                                    timeout=queue_timeout)
            fleet.poll()
            if not batches:
                empty_rounds += 1
                if len(fleet.failed_slots) == fleet.n_actors:
                    stopped = "actors_failed"
                    tob.echo("all actor slots permanently failed "
                             f"(after {fleet.restarts_total()} restarts); "
                             "stopping")
                    break
                if empty_rounds >= max_empty_rounds:
                    stopped = "no_actor_output"
                    tob.echo(f"no actor output for {empty_rounds} rounds; "
                             "stopping")
                    break
                continue
            empty_rounds = 0
            staleness = 0
            per_actor = {}
            with tob.span("learner_episode", episode=ep,
                          batches=len(batches)):
                for actor_id, iteration, wv, host_trs in batches:
                    metrics_out = ingest_batch(agent, buf, host_trs,
                                               generator, wv,
                                               learner_version)
                    staleness = max(staleness, learner_version - wv)
                    per_actor[actor_id] = per_actor.get(actor_id, 0) \
                        + n_trans
            learner_version += 1
            if publish_every <= 1 or (ep + 1) % publish_every == 0:
                fleet.set_weights(weights_of(agent), version=learner_version)
            wall = time.perf_counter() - t0
            rounds += 1
            if rounds == warmup_rounds:
                meas_t0 = time.perf_counter()
            elif rounds > warmup_rounds:
                meas_trans += len(batches) * n_trans
            score = float(np.mean([np.mean(b[3]["reward"])
                                   for b in batches]))
            scores.append(score)
            obs.gauge_set("actor_transitions_per_s",
                          round(len(batches) * n_trans / max(wall, 1e-9),
                                2))
            for aid, tr_n in sorted(per_actor.items()):
                obs.gauge_set("per_actor_transitions_per_s",
                              round(tr_n / max(wall, 1e-9), 2), actor=aid)
            obs.gauge_set("weight_staleness_versions", staleness)
            depths = fleet.queue_depths()
            obs.gauge_set("ingest_queue_depth", depths["aggregate"])
            for slot, d in sorted(depths.get("per_slot", {}).items()):
                obs.gauge_set("ingest_queue_depth", d, slot=slot)
            if sharded:
                from smartcal_tpu_torch.rl import replay_sharded as rps

                occ = rps.shard_occupancy(buf.cntr, buf.n_shards,
                                          buf.local_size)
                for sh_i, o in enumerate(occ):
                    obs.gauge_set("replay_shard_occupancy", o, shard=sh_i)
            if "staleness_mean" in metrics_out:
                sm = float(metrics_out["staleness_mean"])
                sat = float(metrics_out["is_clip_saturation"])
                obs.gauge_set("transition_staleness_mean", round(sm, 4))
                obs.gauge_set("is_clip_saturation", round(sat, 4))
                obs.gauge_set("is_clip_mean", round(
                    float(metrics_out["is_clip_mean"]), 4))
                if rounds > warmup_rounds:
                    stale_means.append(sm)
                    clip_sats.append(sat)
            if rounds > warmup_rounds and "critic_loss" in metrics_out:
                critic_losses.append(float(metrics_out["critic_loss"]))
            tripped = False
            if tob.collect_diag:
                tripped = tob.record_diag(
                    {"critic_loss": float(metrics_out["critic_loss"])},
                    episode=ep)
            tripped = tob.log_replay_health(buf, episode=ep) or tripped
            tob.episode(ep, score, scores, echo=False,
                        transitions=len(batches) * n_trans,
                        actors_alive=fleet.alive_count,
                        restarts=fleet.restarts_total(),
                        staleness_versions=staleness)
            tob.echo(f"episode {ep} mean reward {score:.4f} "
                     f"(batches {len(batches)}, alive {fleet.alive_count})",
                     event=None)
            ep += 1
            if tripped:
                stopped = "watchdog"
                joined = fleet.stop(join=True)
                tob.echo(f"watchdog trip: stopped fleet "
                         f"({joined} actor thread(s) joined)")
                break
            if rt is not None:
                rt.maybe_checkpoint(ep, lambda: {
                    "kind": "fleet", "episode": ep, "scores": list(scores),
                    "agent_state": agent.to_host(),
                    "replay": pack_replay(buf),
                    "generator": generator_state(generator),
                    "generator_device": dev.type,
                    "learner_version": learner_version,
                    "actor_iterations": fleet.slot_iterations()})
    finally:
        meas_wall = (time.perf_counter() - meas_t0
                     if meas_t0 is not None else 0.0)
        # an actor thread finishes its rollout before it sees the stop;
        # wait as long as a heartbeat may take, so no thread is left
        # running torch code at interpreter exit
        fleet.stop(join=True, timeout=fleet.heartbeat_timeout)
        tob.close()
    summary = {"restarts": fleet.restarts_total(),
               "failed_slots": sorted(fleet.failed_slots),
               "alive_at_exit": fleet.alive_count,
               "rounds": rounds,
               "transitions_steady": meas_trans,
               "wall_steady_s": round(meas_wall, 4),
               "env_steps_per_s": (round(meas_trans / meas_wall, 2)
                                   if meas_wall > 0 and meas_trans
                                   else None),
               "stopped": stopped}
    if stale_means:
        summary["transition_staleness_mean"] = round(
            float(np.mean(stale_means)), 4)
        summary["is_clip_saturation"] = round(float(np.mean(clip_sats)), 4)
    if critic_losses:
        summary["critic_loss_mean"] = round(float(np.mean(critic_losses)), 4)
    return (agent, buf), scores, summary


def exit_if_fleet_failed(summary):
    """End a fleet CLI with a non-zero status when its fleet stopped
    because no actor was left to produce (every slot failed, or no output
    for ``max_empty_rounds``): such a run has learned nothing it was asked
    to."""
    if summary["stopped"] in ("actors_failed", "no_actor_output"):
        raise SystemExit(
            f"fleet stopped early ({summary['stopped']}) after "
            f"{summary['rounds']} round(s), {summary['restarts']} "
            f"restart(s), failed slots {summary['failed_slots']}")


def main(argv=None):
    """CLI (``run_process`` of elasticnet/distributed_per_sac.py:154-194).

    Usage: python -m smartcal_tpu_torch.parallel.learner --episodes 100
        [--supervised] [--n-actors 8] [--batch-envs 4] [--is-clip 2.0]
        [--ere 0.98] [--actor-mode process] [--replay-shards 4]
        [--sim-hosts 2] [--use_hint] [--learn_per_transition]
        [--device cpu]
        [--coordinator host:port --num_processes N --process_id i]

    With ``--num_processes`` N > 1 (the same ``--coordinator`` and
    ``--num_processes`` on every process, each its own ``--process_id``)
    the one-program learner runs with one ``dp`` position per process,
    ``--replay-shards`` sharding its ring over them.
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
    p.add_argument("--episodes", type=int, default=100)
    p.add_argument("--actors", type=int, default=None,
                   help="deprecated alias of --n-actors")
    p.add_argument("--use_hint", action="store_true")
    p.add_argument("--learn_per_transition", action="store_true")
    p.add_argument("--supervised", action="store_true",
                   help="the supervised actor fleet (train_supervised) "
                        "instead of the one-program learner")
    p.add_argument("--heartbeat_timeout", type=float, default=60.0)
    p.add_argument("--max_restarts", type=int, default=3)
    p.add_argument("--device", default="cuda",
                   help="torch device of the learner and its actors "
                        "(default cuda; 'cpu' runs on the CPU)")
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
                or args.sim_hosts > 1:
            raise SystemExit(
                "the supervised actor fleet is one learner process; a job "
                "of several processes runs the one-program learner "
                "(--replay-shards shards its ring over the processes)")
    elif args.actor_mode == "process" or args.replay_shards \
            or args.sim_hosts > 1:
        args.supervised = True
    if args.supervised:
        _, scores, summary = train_supervised(
            seed=args.seed, episodes=args.episodes,
            n_actors=n_actors or 2, use_hint=args.use_hint,
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
    _, scores = train_distributed(
        seed=args.seed, episodes=args.episodes, n_actors=n_actors,
        use_hint=args.use_hint,
        learn_per_transition=args.learn_per_transition,
        quiet=args.quiet, metrics=args.metrics,
        diag=diag_from_args(args),
        watchdog=getattr(args, "watchdog", False),
        ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
        resume=args.resume, device=args.device,
        replay_shards=args.replay_shards if multi else 0)
    return scores


if __name__ == "__main__":
    main()
