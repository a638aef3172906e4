"""Elastic-net DDPG trainer (counterpart of
smartcal_tpu/train/enet_ddpg.py; reference ``elasticnet/main_ddpg.py``):
episodes of 5 steps with a fresh noisy draw per step and no hint, each run
fused as a program, one CUDA-graph replay on the card
(:func:`make_episode_fn`), as ``train/enet_sac.py`` describes.

Usage:
    python -m smartcal_tpu_torch.train.enet_ddpg --episodes 1000 --steps 5
        [--seed 0] [--device cuda|cpu]
"""

import argparse
import json
import sys

import torch

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.envs import enet
from smartcal_tpu_torch.rl import ddpg
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.obs import stack_diags
from smartcal_tpu_torch.runtime.atomic import atomic_pickle
from smartcal_tpu_torch.train.blocks import add_obs_args, add_runtime_args
from smartcal_tpu_torch.train.enet_sac import (add_size_args, episode_fn,
                                               fused_handles, fused_loop,
                                               program_env, runtime_kwargs,
                                               summary)


def run_episode(env_cfg: enet.EnetConfig, cfg: ddpg.DDPGConfig,
                st: ddpg.DDPGState, buf: rp.ReplayState, draws, steps: int,
                collect_diag: bool = False):
    """One fused episode; updates ``st`` and ``buf`` in place and returns
    the mean reward (a device scalar), with ``collect_diag`` also the
    episode's step-stacked UpdateDiag."""
    env_state, obs = enet.reset(env_cfg, *draws.reset(env_cfg))
    hint = torch.zeros(cfg.n_actions, device=obs.device)
    rewards, diags = [], []
    for _ in range(steps):
        action = ddpg.choose_action(cfg, st, obs,
                                    draws.normal((cfg.n_actions,)))
        env_state, obs2, reward, done = enet.step(
            env_cfg, env_state, action, draws.normal((env_cfg.N,)))
        rp.replay_add(buf, {"state": obs, "action": action,
                            "reward": reward, "new_state": obs2,
                            "done": done, "hint": hint}, priority=1.0)
        m = ddpg.learn(cfg, st, buf, **draws.learn(),
                       collect_diag=collect_diag)
        if collect_diag:
            diags.append(m["diag"])
        rewards.append(reward)
        obs = obs2
    score = torch.stack(rewards).mean()
    return (score, stack_diags(diags)) if collect_diag else score


def episode_body(env_cfg: enet.EnetConfig, cfg: ddpg.DDPGConfig,
                 steps: int, collect_diag: bool = False):
    """The one-episode body ``(agent_state, buf, draws) -> score`` of the
    programs (the JAX package's ``_make_episode_body``)."""
    program_env(env_cfg)

    def body(st, buf, draws):
        return run_episode(env_cfg, cfg, st, buf, draws, steps, collect_diag)
    return body


def make_episode_fn(env_cfg: enet.EnetConfig, cfg: ddpg.DDPGConfig,
                    steps: int, collect_diag: bool = False):
    """One fused episode as a program (``enet_sac.make_episode_fn``)."""
    return episode_fn(episode_body(env_cfg, cfg, steps, collect_diag),
                      collect_diag, "enet_ddpg_episode")


def make_episode_block_fn(env_cfg: enet.EnetConfig, cfg: ddpg.DDPGConfig,
                          steps: int, block: int):
    """``block`` sequential episodes per program call (see
    ``train/blocks.make_block_fn``)."""
    from smartcal_tpu_torch.train.blocks import make_block_fn

    return make_block_fn(episode_body(env_cfg, cfg, steps), block,
                         f"enet_ddpg_block{block}")


def agent_config(env_cfg: enet.EnetConfig) -> ddpg.DDPGConfig:
    """The trainer's agent: 2 actions, batch 64, a 1024-slot ring."""
    return ddpg.DDPGConfig(obs_dim=env_cfg.obs_dim, n_actions=2,
                           batch_size=64, mem_size=1024)


def train_fused(seed=0, episodes=1000, steps=5, M=20, N=20, log_every=1,
                prefix="", quiet=False, metrics_path=None, run_id=None,
                trace=None, diag=False, watchdog=False, ckpt_dir=None,
                ckpt_every=0, keep_ckpts=3, resume=False, max_recoveries=0,
                recovery_lr_shrink=0.5, recovery_reseed=True,
                compile_cache=None, deterministic=False, tob=None,
                device="cuda"):
    """Fused episodes on ``device`` with the obs and runtime arguments of
    ``enet_sac.train_fused``; saves the scores at the end.  Returns
    (scores, wall seconds, agent state, ring)."""
    dev = resolve_device(device)
    env_cfg = enet.EnetConfig(M=M, N=N)
    cfg = agent_config(env_cfg)
    generator = torch.Generator(device=dev).manual_seed(seed)
    agent_state = ddpg.ddpg_init(cfg, generator, dev)
    buf = rp.replay_init(cfg.mem_size, rp.transition_spec(cfg.obs_dim,
                                                          cfg.n_actions), dev)
    tob, rt = fused_handles(
        "enet_ddpg", tob, seed, quiet, metrics_path, run_id, trace, diag,
        watchdog, ckpt_dir, ckpt_every, keep_ckpts, resume, max_recoveries,
        recovery_lr_shrink, recovery_reseed, compile_cache,
        deterministic=deterministic)
    return fused_loop(
        "enet_ddpg", seed, episodes, cfg, agent_state, buf, generator, dev,
        lambda c, collect: episode_body(env_cfg, c, steps, collect),
        lambda st, b, sc: atomic_pickle(sc, f"{prefix}scores_ddpg.pkl"), 0,
        tob, rt, log_every)


def main(argv=None):
    p = argparse.ArgumentParser(description="Elastic net DDPG")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--episodes", default=1000, type=int)
    p.add_argument("--steps", default=5, type=int)
    p.add_argument("--prefix", type=str, default="",
                   help="path prefix of the saved scores")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of env, agent and replay (cuda, or "
                        "cpu when asked for)")
    add_size_args(p)
    add_obs_args(p)
    add_runtime_args(p)
    args = p.parse_args(argv)
    scores, wall, _, _ = train_fused(
        seed=args.seed, episodes=args.episodes, steps=args.steps, M=args.M,
        N=args.N, prefix=args.prefix, device=args.device,
        **runtime_kwargs(args))
    out = summary(args.episodes, args.steps, wall, scores)
    sys.stdout.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
