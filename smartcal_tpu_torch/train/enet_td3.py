"""Elastic-net TD3 trainer (counterpart of
smartcal_tpu/train/enet_td3.py; reference ``elasticnet/main_td3.py``):
prioritized replay and hint-constrained adaptive-ADMM actor updates by
default, episodes of 4 steps, warmup 100.  Each episode runs fused as a
program, one CUDA-graph replay on the card (:func:`make_episode_fn`), as
``train/enet_sac.py`` describes.

Usage:
    python -m smartcal_tpu_torch.train.enet_td3 --episodes 1000 --steps 4
        [--seed 0] [--no_hint] [--no_per] [--device cuda|cpu]
"""

import argparse
import json
import sys

import torch

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.envs import enet
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl import td3
from smartcal_tpu_torch.obs import stack_diags
from smartcal_tpu_torch.runtime.atomic import atomic_pickle
from smartcal_tpu_torch.train.blocks import add_obs_args, add_runtime_args
from smartcal_tpu_torch.train.enet_sac import (add_size_args, episode_fn,
                                               fused_handles, fused_loop,
                                               program_env, runtime_kwargs,
                                               start_episode, summary)


def run_episode(env_cfg: enet.EnetConfig, cfg: td3.TD3Config,
                st: td3.TD3State, buf: rp.ReplayState, draws, steps: int,
                use_hint: bool, collect_diag: bool = False):
    """One fused episode; updates ``st`` and ``buf`` in place and returns
    the mean reward (a device scalar), with ``collect_diag`` also the
    episode's step-stacked UpdateDiag."""
    env_state, obs, hint = start_episode(env_cfg, cfg.n_actions, draws,
                                         use_hint)
    rewards, diags = [], []
    for i in range(steps):
        noise = (draws.normal((cfg.n_actions,)),
                 draws.normal((cfg.n_actions,)))
        action = td3.choose_action(cfg, st, obs, noise)
        env_state, obs2, reward, done = enet.step(
            env_cfg, env_state, action, draws.normal((env_cfg.N,)),
            keepnoise=i == 0)
        pri = td3.store_priority(cfg, reward)
        rp.replay_add(buf, {"state": obs, "action": action,
                            "reward": reward, "new_state": obs2,
                            "done": done, "hint": hint},
                      priority=1.0 if pri is None else pri)
        m = td3.learn(cfg, st, buf, **draws.learn(),
                      collect_diag=collect_diag)
        if collect_diag:
            diags.append(m["diag"])
        rewards.append(reward)
        obs = obs2
    score = torch.stack(rewards).mean()
    return (score, stack_diags(diags)) if collect_diag else score


def episode_body(env_cfg: enet.EnetConfig, cfg: td3.TD3Config, steps: int,
                 use_hint: bool, collect_diag: bool = False):
    """The one-episode body ``(agent_state, buf, draws) -> score`` of the
    programs (the JAX package's ``_make_episode_body``)."""
    program_env(env_cfg)

    def body(st, buf, draws):
        return run_episode(env_cfg, cfg, st, buf, draws, steps, use_hint,
                           collect_diag)
    return body


def make_episode_fn(env_cfg: enet.EnetConfig, cfg: td3.TD3Config,
                    steps: int, use_hint: bool, collect_diag: bool = False):
    """One fused episode as a program (``enet_sac.make_episode_fn``)."""
    return episode_fn(episode_body(env_cfg, cfg, steps, use_hint,
                                   collect_diag), collect_diag,
                      "enet_td3_episode")


def make_episode_block_fn(env_cfg: enet.EnetConfig, cfg: td3.TD3Config,
                          steps: int, use_hint: bool, block: int):
    """``block`` sequential episodes per program call (see
    ``train/blocks.make_block_fn``)."""
    from smartcal_tpu_torch.train.blocks import make_block_fn

    return make_block_fn(episode_body(env_cfg, cfg, steps, use_hint), block,
                         f"enet_td3_block{block}")


def agent_config(env_cfg: enet.EnetConfig, use_hint=True,
                 prioritized=True) -> td3.TD3Config:
    """The trainer's agent (enet main_td3.py): 2 actions, batch 64, a
    1024-slot ring, warmup 100, admm_rho 1."""
    return td3.TD3Config(
        obs_dim=env_cfg.obs_dim, n_actions=2, gamma=0.99, tau=0.005,
        batch_size=64, mem_size=1024, lr_a=1e-3, lr_c=1e-3,
        update_actor_interval=2, warmup=100, noise=0.1,
        prioritized=prioritized, use_hint=use_hint, admm_rho=1.0)


def save(agent_state, buf, scores, prefix):
    atomic_pickle(agent_state.to_host(), f"{prefix}td3_state.pkl")
    rp.save_replay(buf, f"{prefix}replaymem_td3.pkl")
    atomic_pickle(scores, f"{prefix}scores_td3.pkl")


def train_fused(seed=0, episodes=1000, steps=4, use_hint=True,
                prioritized=True, M=20, N=20, log_every=1, save_every=500,
                prefix="", quiet=False, metrics_path=None, run_id=None,
                trace=None, diag=False, watchdog=False, ckpt_dir=None,
                ckpt_every=0, keep_ckpts=3, resume=False, max_recoveries=0,
                recovery_lr_shrink=0.5, recovery_reseed=True,
                compile_cache=None, deterministic=False, tob=None,
                device="cuda"):
    """Fused episodes on ``device`` with the obs and runtime arguments of
    ``enet_sac.train_fused``; saves every ``save_every`` episodes and at
    the end.  Returns (scores, wall seconds, agent state, ring)."""
    dev = resolve_device(device)
    env_cfg = enet.EnetConfig(M=M, N=N)
    cfg = agent_config(env_cfg, use_hint, prioritized)
    generator = torch.Generator(device=dev).manual_seed(seed)
    agent_state = td3.td3_init(cfg, generator, dev)
    buf = rp.replay_init(cfg.mem_size, rp.transition_spec(cfg.obs_dim,
                                                          cfg.n_actions), dev)
    tob, rt = fused_handles(
        "enet_td3", tob, seed, quiet, metrics_path, run_id, trace, diag,
        watchdog, ckpt_dir, ckpt_every, keep_ckpts, resume, max_recoveries,
        recovery_lr_shrink, recovery_reseed, compile_cache,
        deterministic=deterministic)
    return fused_loop(
        "enet_td3", seed, episodes, cfg, agent_state, buf, generator, dev,
        lambda c, collect: episode_body(env_cfg, c, steps, use_hint,
                                        collect),
        lambda st, b, sc: save(st, b, sc, prefix), save_every, tob, rt,
        log_every, use_hint=use_hint)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Elastic net TD3 + PER + hint-ADMM")
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--episodes", default=1000, type=int)
    p.add_argument("--steps", default=4, type=int)
    p.add_argument("--no_hint", action="store_true", default=False)
    p.add_argument("--no_per", action="store_true", default=False)
    p.add_argument("--prefix", type=str, default="",
                   help="path prefix of the saved agent, ring and scores")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of env, agent and replay (cuda, or "
                        "cpu when asked for)")
    add_size_args(p)
    add_obs_args(p)
    add_runtime_args(p)
    args = p.parse_args(argv)
    scores, wall, _, _ = train_fused(
        seed=args.seed, episodes=args.episodes, steps=args.steps,
        use_hint=not args.no_hint, prioritized=not args.no_per, M=args.M,
        N=args.N, prefix=args.prefix, device=args.device,
        **runtime_kwargs(args))
    out = summary(args.episodes, args.steps, wall, scores)
    sys.stdout.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
