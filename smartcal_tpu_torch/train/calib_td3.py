"""Calibration (ADMM-rho tuning) TD3 trainer (counterpart of
smartcal_tpu/train/calib_td3.py).

Mirrors ``calibration/main_td3.py``: the CNN+metadata TD3 agent (warmup
random phase, delayed actor updates every 2 learn calls, exploration noise
0.1) stepping CalibEnv episodes of up to 10 steps, per-episode
checkpointing.  With ``--use_hint`` the actor takes TD3's adaptive-rho
ADMM inner loop.  Env, agent and replay ring live on ``--device`` (default
cuda).

Usage:
    python -m smartcal_tpu_torch.train.calib_td3 --episodes 30
        [--use_hint] [--small] [--stations 14] [--device cpu]
"""

import argparse

import numpy as np

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.envs.calib import CalibEnv
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.rl import td3
from smartcal_tpu_torch.rl.networks import flatten_obs
from smartcal_tpu_torch.runtime.atomic import atomic_pickle
from smartcal_tpu_torch.train.blocks import (TrainRuntime, add_obs_args,
                                             add_runtime_args,
                                             apply_agent_recovery,
                                             diag_from_args, pack_agent_loop,
                                             restore_agent_loop,
                                             train_obs_from_args)


def run(env, agent, episodes, steps, use_hint, prefix, tob, args=None):
    """The episode loop of the radio TD3/DDPG trainers (main_td3.py:23-48 /
    main_ddpg.py): unscaled rewards, a learn call per step, the agent
    saved after every episode.  ``args`` (the parsed flags) arms
    checkpoint, resume and the watchdog's rollback."""
    scores = []
    rt = (TrainRuntime.from_args(args, prefix, tob=tob) if args is not None
          else TrainRuntime(prefix, tob=tob))
    base_cfg = agent.cfg
    i = 0
    restored = rt.restore()
    if restored is not None:
        scores, i, _ = restore_agent_loop(agent, env, restored)

    def ckpt_payload():
        return pack_agent_loop(agent, env, scores, i)

    try:
        while i < episodes:
            with tob.span("episode", episode=i):
                flat = flatten_obs(env.reset())
                score, loop, done = 0.0, 0, False
                while not done and loop < steps:
                    action = np.asarray(agent.choose_action(flat)).squeeze()
                    out = env.step(action)
                    if use_hint:
                        obs2, reward, done, hint, info = out
                    else:
                        obs2, reward, done, info = out
                        hint = np.zeros_like(action)
                    flat2 = flatten_obs(obs2)
                    agent.store_transition(flat, action, reward, flat2,
                                           done, hint)
                    agent.learn()
                    if tob.record_diag(agent.last_diag, episode=i):
                        done = True
                    score += reward
                    flat = flat2
                    loop += 1
            if tob.tripped:
                act = rt.on_trip()
                if act is not None:
                    scores, i, _ = restore_agent_loop(agent, env,
                                                      act.payload)
                    agent = apply_agent_recovery(agent, base_cfg, act)
                    continue
            scores.append(score / max(loop, 1))
            tob.log_replay_health(agent.buffer, episode=i)
            tob.episode(i, scores[-1], scores, use_hint=use_hint)
            agent.save_models()
            atomic_pickle(scores, f"{prefix}_scores.pkl")
            if tob.tripped:
                break
            i += 1
            rt.maybe_checkpoint(i, ckpt_payload)
    finally:
        tob.close()
    return scores


def build_backend(args, device):
    if args.small:
        return RadioBackend(n_stations=6, n_freqs=2, n_times=4, tdelta=2,
                            admm_iters=2, lbfgs_iters=3, init_iters=5,
                            npix=32, device=device)
    return RadioBackend(n_stations=args.stations, npix=args.npix,
                        device=device)


def add_common_args(p):
    add_runtime_args(p)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--episodes", type=int, default=30)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--M", type=int, default=10)
    p.add_argument("--use_hint", action="store_true")
    p.add_argument("--stations", type=int, default=14)
    p.add_argument("--npix", type=int, default=128)
    p.add_argument("--small", action="store_true",
                   help="tiny shapes for smoke runs")
    p.add_argument("--load", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of env, agent and replay (cuda, or "
                        "cpu when asked for)")
    add_obs_args(p)


def setup(argv, entry, description):
    """Parse the common flags; returns (args, env, device)."""
    p = argparse.ArgumentParser(description=description)
    add_common_args(p)
    p.add_argument("--prefix", type=str, default=entry)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    env = CalibEnv(M=args.M, provide_hint=args.use_hint,
                   backend=build_backend(args, dev), seed=args.seed,
                   device=dev)
    return args, env, dev


def agent_config(npix, M, use_hint) -> td3.TD3Config:
    """The trainer's agent (calibration/main_td3.py's): obs = npix² image +
    (M+1) x 7 sky table, 2M actions, batch 32, a 1000-slot ring."""
    return td3.TD3Config(
        obs_dim=npix * npix + (M + 1) * 7, n_actions=2 * M, gamma=0.99,
        tau=0.005, batch_size=32, mem_size=1000, lr_a=1e-3, lr_c=1e-3,
        warmup=100, noise=0.1, update_actor_interval=2, use_hint=use_hint,
        img_shape=(npix, npix))


def main(argv=None):
    args, env, dev = setup(argv, "calib_td3", __doc__)
    agent = td3.TD3Agent(agent_config(env.backend.npix, args.M,
                                      args.use_hint),
                         seed=args.seed, name_prefix=args.prefix, device=dev,
                         collect_diag=diag_from_args(args))
    if args.load:
        agent.load_models()
    return run(env, agent, args.episodes, args.steps, args.use_hint,
               args.prefix, train_obs_from_args(args, "calib_td3"), args)


if __name__ == "__main__":
    main()
