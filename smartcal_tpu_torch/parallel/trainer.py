"""Synchronous batched SAC trainer (counterpart of
smartcal_tpu/parallel/trainer.py) on one GPU.

The JAX package shards a batch of environments over the mesh's ``dp``
axis and runs act, env step, store and learn as one SPMD program.  On one
device the ``dp`` actors are the lanes of one batched program: the E envs
step through ``envs/enet``'s lane form (their E inner solves are the lanes
of one L-BFGS solve), the E transitions go into the device ring with one
store, and one SAC learn follows.

State is held in a mutable :class:`ParallelTrainState`; every function
takes a ``torch.Generator`` on the mesh's device for its draws.
``run_block`` runs whole episodes one after another on the host, each
exactly the per-step cadence of ``reset_envs`` + ``train_step``.
"""

import dataclasses
import time

import torch

from smartcal_tpu_torch import obs
from smartcal_tpu_torch.envs import enet
from smartcal_tpu_torch.parallel.mesh import AXIS_DATA
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl import sac


def _instrument(fn, kind: str, env_steps_per_call: int,
                gauge_every: int = 50):
    """``fn`` with dispatch telemetry: with a RunLog active, a ``dispatch``
    event per call (the call's host seconds), the ``train_dispatches`` and
    ``env_steps`` counters, and every ``gauge_every`` calls an
    ``env_steps_per_s`` gauge over the window (the fleets' throughput
    name).  A single ``None`` check otherwise."""
    window = {"n": 0, "t0": None}

    def wrapped(*args, **kwargs):
        rl = obs.active()
        if rl is None:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        rl.log("dispatch", kind=kind,
               submit_s=round(time.perf_counter() - t0, 6),
               env_steps=env_steps_per_call)
        obs.counter_add("train_dispatches")
        obs.counter_add("env_steps", env_steps_per_call)
        if window["t0"] is None:
            window["t0"] = t0
        window["n"] += 1
        if window["n"] >= gauge_every:
            wall = time.perf_counter() - window["t0"]
            obs.gauge_set(
                "env_steps_per_s",
                round(window["n"] * env_steps_per_call / max(wall, 1e-9),
                      2), kind=kind)
            window["n"], window["t0"] = 0, None
        return out

    wrapped.__wrapped__ = fn
    return wrapped


@dataclasses.dataclass
class ParallelTrainState:
    agent: sac.SACState
    buf: rp.ReplayState
    env_states: enet.EnetState       # lane state, leading axis n_envs
    obs: torch.Tensor                # (n_envs, obs_dim)
    hints: torch.Tensor              # (n_envs, n_actions)
    step_in_episode: int


def make_parallel_sac(env_cfg: enet.EnetConfig, agent_cfg: sac.SACConfig,
                      mesh, n_envs: int, use_hint: bool = False,
                      episode_block=None):
    """``(init_fn, train_step, reset_envs)`` on ``mesh``'s device, plus
    ``run_block`` with ``episode_block=(steps_per_episode,
    episodes_per_dispatch)``.

    One ``train_step(st, generator)`` = every env advances one step (the
    lanes of one program), the E transitions are stored, and one SAC learn
    runs; returns ``(st, metrics)`` with ``mean_reward``.
    ``run_block(st, generator)`` runs ``episodes_per_dispatch`` episodes of
    ``steps_per_episode`` steps and returns ``(st, scores)``, each score the
    mean step reward of an episode over the lanes.  ``n_envs`` must divide
    over the ``dp`` axis (size 1 on one device)."""
    if n_envs % mesh.shape[AXIS_DATA] != 0:
        raise ValueError(f"n_envs={n_envs} not divisible by dp axis "
                         f"{mesh.shape[AXIS_DATA]}")
    dev = mesh.device

    def _fresh_envs(generator):
        """Reset every env and draw its first noisy observation; the hint
        sees that draw, and step 0 of the episode keeps it (reference
        enetenv.py:87-90,156-158)."""
        st, obs0 = enet.reset_lanes(env_cfg, *enet.reset_draws_lanes(
            env_cfg, n_envs, generator, dev))
        st = enet.draw_noise(env_cfg, st, torch.randn(
            (n_envs, env_cfg.N), generator=generator, device=dev))
        if use_hint:
            hints = enet.get_hint_lanes(env_cfg, st)
        else:
            hints = torch.zeros((n_envs, agent_cfg.n_actions), device=dev)
        return st, obs0, hints

    def init_fn(generator) -> ParallelTrainState:
        agent = sac.sac_init(agent_cfg, generator, dev)
        buf = rp.replay_init(agent_cfg.mem_size, rp.transition_spec(
            env_cfg.obs_dim, agent_cfg.n_actions), dev)
        st, obs0, hints = _fresh_envs(generator)
        return ParallelTrainState(agent, buf, st, obs0, hints, 0)

    def train_step(st: ParallelTrainState, generator):
        actions = sac.choose_action(agent_cfg, st.agent, st.obs, torch.randn(
            (n_envs, agent_cfg.n_actions), generator=generator, device=dev))
        first = st.step_in_episode == 0
        noise = None if first else torch.randn(
            (n_envs, env_cfg.N), generator=generator, device=dev)
        env_states, obs2, rewards, dones = enet.step_lanes(
            env_cfg, st.env_states, actions, noise, keepnoise=first)
        rp.replay_add_batch(
            st.buf, {"state": st.obs, "action": actions, "reward": rewards,
                     "new_state": obs2, "done": dones, "hint": st.hints},
            priority=None if agent_cfg.prioritized else 1.0)
        metrics = sac.learn(agent_cfg, st.agent, st.buf, generator)
        metrics["mean_reward"] = torch.mean(rewards)
        st.env_states, st.obs = env_states, obs2
        st.step_in_episode += 1
        return st, metrics

    def reset_envs(st: ParallelTrainState, generator):
        """A new episode on every env (the host calls this every
        steps-per-episode train steps)."""
        st.env_states, st.obs, st.hints = _fresh_envs(generator)
        st.step_in_episode = 0
        return st

    train_step_i = _instrument(train_step, "train_step", n_envs)
    if episode_block is None:
        return init_fn, train_step_i, reset_envs

    steps_pe, eps_pd = (int(v) for v in episode_block)

    def run_block(st: ParallelTrainState, generator):
        scores = []
        for _ in range(eps_pd):
            reset_envs(st, generator)
            rs = []
            for _ in range(steps_pe):
                st, m = train_step(st, generator)
                rs.append(m["mean_reward"])
            scores.append(torch.mean(torch.stack(rs)))
        return st, torch.stack(scores)

    return init_fn, train_step_i, reset_envs, _instrument(
        run_block, "episode_block", n_envs * steps_pe * eps_pd)


def episode_scores(metrics_list, steps_per_episode: int):
    """Per-episode scores from per-step mean rewards."""
    rewards = [float(m["mean_reward"]) for m in metrics_list]
    return [sum(rewards[i:i + steps_per_episode]) / steps_per_episode
            for i in range(0, len(rewards), steps_per_episode)]
