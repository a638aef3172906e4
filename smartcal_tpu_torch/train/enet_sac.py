"""Elastic-net SAC trainer (counterpart of
smartcal_tpu/train/enet_sac.py).

Mirrors ``elasticnet/main_sac.py`` (episode loop, per-step learn, moving
average of scores) in two modes:

* ``--mode fused`` (default): each episode is reset, one noisy draw, the
  hint from that draw (zeros without ``--use_hint``), then per step: choose
  an action, step the env (the first step keeps the draw), store the
  transition and learn, all on tensors that stay on the device (the JAX
  package's one-XLA-program episode, run eagerly in the same order);
* ``--mode loop``: the reference's host loop through ``EnetEnv`` and
  ``SACAgent``.

Usage:
    python -m smartcal_tpu_torch.train.enet_sac --episodes 1000 --steps 5
        [--seed 0] [--use_hint] [--mode fused|loop] [--device cuda|cpu]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.envs import enet
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl import sac
from smartcal_tpu_torch.runtime.atomic import atomic_pickle
from smartcal_tpu_torch.train.blocks import (add_obs_args, add_runtime_args,
                                             reject_unported,
                                             train_obs_from_args)


class Draws:
    """The random draws of fused episodes, from one ``torch.Generator`` on
    the device: the env's reset draws and unit normals in the order the
    episode asks for them, and the learn step's draws (its generator).
    Parity tests hand an object with the same methods the JAX package's
    draws instead."""

    def __init__(self, generator, device):
        self.generator, self.device = generator, device

    def reset(self, cfg: enet.EnetConfig):
        return enet.reset_draws(cfg, self.generator, self.device)

    def normal(self, shape):
        return torch.randn(shape, generator=self.generator,
                           device=self.device)

    def learn(self) -> dict:
        return {"generator": self.generator}


def start_episode(env_cfg: enet.EnetConfig, n_actions, draws, use_hint):
    """Reset, one noisy draw, and the episode's hint from that draw (the
    reference's step draws noise, then get_hint reads it,
    enetenv.py:87-90,156-158).  Returns (env state, obs, hint)."""
    env_state, obs = enet.reset(env_cfg, *draws.reset(env_cfg))
    env_state = enet.draw_noise(env_cfg, env_state,
                                draws.normal((env_cfg.N,)))
    hint = (enet.get_hint(env_cfg, env_state) if use_hint
            else torch.zeros(n_actions, device=obs.device))
    return env_state, obs, hint


def run_episode(env_cfg: enet.EnetConfig, cfg: sac.SACConfig,
                st: sac.SACState, buf: rp.ReplayState, draws, steps: int,
                use_hint: bool):
    """One fused episode; updates ``st`` and ``buf`` in place and returns
    the mean reward (a device scalar)."""
    env_state, obs, hint = start_episode(env_cfg, cfg.n_actions, draws,
                                         use_hint)
    rewards = []
    for i in range(steps):
        action = sac.choose_action(cfg, st, obs,
                                   draws.normal((cfg.n_actions,)))
        env_state, obs2, reward, done = enet.step(
            env_cfg, env_state, action, draws.normal((env_cfg.N,)),
            keepnoise=i == 0)
        rp.replay_add(buf, {"state": obs, "action": action,
                            "reward": reward, "new_state": obs2,
                            "done": done, "hint": hint},
                      priority=None if cfg.prioritized else 1.0)
        sac.learn(cfg, st, buf, **draws.learn())
        rewards.append(reward)
        obs = obs2
    return torch.stack(rewards).mean()


def agent_config(env_cfg: enet.EnetConfig, use_hint) -> sac.SACConfig:
    """The trainer's agent (enet main_sac.py): 2 actions, batch 64, a
    1024-slot ring, reward scale N, alpha 0.03."""
    return sac.SACConfig(
        obs_dim=env_cfg.obs_dim, n_actions=2, gamma=0.99, tau=0.005,
        batch_size=64, mem_size=1024, lr_a=1e-3, lr_c=1e-3,
        reward_scale=float(env_cfg.N), alpha=0.03, use_hint=use_hint)


def run_episodes(episodes, run, save, save_every=0, tob=None, **tags):
    """``episodes`` calls of ``run()`` (one episode's mean reward), echoed
    through ``tob``; ``save(scores)`` every ``save_every`` episodes and at
    the end.  Returns (scores, wall seconds of the episodes)."""
    scores = []
    t0 = time.time()
    for i in range(episodes):
        scores.append(float(run()))
        if tob is not None:
            tob.episode(i, scores[-1], scores, **tags)
        if save_every and i + 1 < episodes and (i + 1) % save_every == 0:
            save(scores)
    wall = time.time() - t0
    save(scores)
    return scores, wall


def save(agent_state, buf, scores, prefix):
    atomic_pickle(agent_state.to_host(), f"{prefix}sac_state.pkl")
    rp.save_replay(buf, f"{prefix}replaymem_sac.pkl")
    atomic_pickle(scores, f"{prefix}scores.pkl")


def train_fused(seed=0, episodes=1000, steps=5, use_hint=False, M=20, N=20,
                save_every=500, prefix="", tob=None, device="cuda"):
    """Fused episodes on ``device``; saves every ``save_every`` episodes
    and at the end.  Returns (scores, wall seconds, agent state, ring)."""
    dev = resolve_device(device)
    env_cfg = enet.EnetConfig(M=M, N=N)
    cfg = agent_config(env_cfg, use_hint)
    generator = torch.Generator(device=dev).manual_seed(seed)
    agent_state = sac.sac_init(cfg, generator, dev)
    buf = rp.replay_init(cfg.mem_size, rp.transition_spec(cfg.obs_dim,
                                                          cfg.n_actions), dev)
    draws = Draws(generator, dev)
    scores, wall = run_episodes(
        episodes, lambda: run_episode(env_cfg, cfg, agent_state, buf, draws,
                                      steps, use_hint),
        lambda sc: save(agent_state, buf, sc, prefix), save_every, tob,
        seed=seed, use_hint=use_hint)
    return scores, wall, agent_state, buf


def train_loop(seed=0, episodes=1000, steps=5, use_hint=False, M=20, N=20,
               tob=None, device="cuda"):
    """Reference-style host loop (main_sac.py:47-76)."""
    env = enet.EnetEnv(M, N, provide_hint=use_hint, seed=seed, device=device)
    agent = sac.SACAgent(agent_config(env.cfg, use_hint), seed=seed,
                         device=device)
    scores = []
    for i in range(episodes):
        obs = env.reset()
        score, loop, done = 0.0, 0, False
        while not done and loop < steps:
            action = agent.choose_action(obs)
            if use_hint:
                obs2, reward, done, hint, _ = env.step(action)
            else:
                obs2, reward, done, _ = env.step(action)
                hint = np.zeros_like(action)
            agent.store_transition(obs, action, reward, obs2, done, hint)
            score += reward
            agent.learn()
            obs = obs2
            loop += 1
        scores.append(score / loop)
        if tob is not None:
            tob.episode(i, scores[-1], scores, seed=seed, use_hint=use_hint)
    return scores


def summary(episodes, steps, wall, scores) -> dict:
    """The closing JSON line of the fused trainers."""
    tail = scores[-100:]
    return {"episodes": episodes, "steps_per_episode": steps,
            "wall_s": round(wall, 2),
            "env_steps_per_sec": round(episodes * steps / wall, 2),
            "final_avg_score": sum(tail) / len(tail)}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Elastic net regression hyperparameter tuning (SAC)")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--episodes", default=1000, type=int)
    p.add_argument("--steps", default=5, type=int)
    p.add_argument("--use_hint", action="store_true", default=False)
    p.add_argument("--mode", default="fused", choices=["fused", "loop"])
    p.add_argument("--block", default=1, type=int,
                   help="episodes per block; the port runs a block's "
                        "episodes one after another, the same learning "
                        "dynamics as --block 1")
    p.add_argument("--prefix", type=str, default="",
                   help="path prefix of the saved agent, ring and scores")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of env, agent and replay (cuda, or "
                        "cpu when asked for)")
    add_obs_args(p)
    add_runtime_args(p)
    args = p.parse_args(argv)
    reject_unported(args)
    tob = train_obs_from_args(args, "enet_sac")
    try:
        if args.mode == "loop":
            return train_loop(seed=args.seed, episodes=args.episodes,
                              steps=args.steps, use_hint=args.use_hint,
                              tob=tob, device=args.device)
        scores, wall, _, _ = train_fused(
            seed=args.seed, episodes=args.episodes, steps=args.steps,
            use_hint=args.use_hint, prefix=args.prefix, tob=tob,
            device=args.device)
    finally:
        tob.close()
    out = summary(args.episodes, args.steps, wall, scores)
    sys.stdout.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
