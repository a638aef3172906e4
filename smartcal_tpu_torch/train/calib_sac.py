"""Calibration (ADMM-rho tuning) SAC trainer (counterpart of
smartcal_tpu/train/calib_sac.py).

Mirrors ``calibration/main_sac.py``: M=10 max directions, 2M actions,
episodes of up to 4 steps, rewards > 1 scaled by 10, per-episode model
checkpointing, score moving average.  The env runs on the port's radio
backend; env, agent and replay ring live on ``--device`` (default cuda).
``--batch-envs E`` > 1 trains on a ``BatchedCalibEnv`` of E lanes, one
learn per vector step, E per-lane scores per vector episode.  The obs and
runtime flags act as in the JAX trainer: ``--metrics`` writes the run log
(``tools/obs_report.py`` reads it), ``--ckpt-every N`` checkpoints into
``--ckpt-dir`` (default ``<prefix>_ckpt``) and ``--resume`` continues from
the newest checkpoint bit for bit.

Usage:
    python -m smartcal_tpu_torch.train.calib_sac --episodes 50 --seed 0
        [--use_hint] [--stations 14] [--small | --light | --medium]
        [--batch-envs E] [--metrics run.jsonl] [--diag] [--watchdog]
        [--ckpt-every 1] [--resume] [--max-recoveries 1]
        [--device cpu]
"""

import argparse

import numpy as np

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.envs.calib import BatchedCalibEnv, CalibEnv
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.rl import sac
from smartcal_tpu_torch.rl.networks import flatten_obs
from smartcal_tpu_torch.runtime.atomic import atomic_pickle
from smartcal_tpu_torch.train import demix_sac
from smartcal_tpu_torch.train.blocks import (TrainRuntime,
                                             add_batched_args, add_ere_arg,
                                             add_obs_args, add_runtime_args,
                                             apply_agent_recovery,
                                             diag_from_args, pack_agent_loop,
                                             restore_agent_loop,
                                             run_batched_agent_loop,
                                             train_obs_from_args)


def agent_config(npix, M, use_hint, ere_eta=1.0) -> sac.SACConfig:
    """The trainer's agent (calibration/main_sac.py's): obs = npix² image +
    (M+1) x 7 sky table, 2M actions, batch 32, a 10,000-slot ring, KLD
    hint."""
    return sac.SACConfig(
        obs_dim=npix * npix + (M + 1) * 7, n_actions=2 * M, gamma=0.99,
        tau=0.005, batch_size=32, mem_size=10000, lr_a=1e-3, lr_c=1e-3,
        reward_scale=M, alpha=0.03, hint_threshold=0.01, admm_rho=1.0,
        use_hint=use_hint, hint_distance="kld", img_shape=(npix, npix),
        ere_eta=ere_eta)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--episodes", type=int, default=50)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--M", type=int, default=10)
    p.add_argument("--use_hint", action="store_true")
    p.add_argument("--stations", type=int, default=14)
    p.add_argument("--npix", type=int, default=128)
    p.add_argument("--small", action="store_true",
                   help="tiny shapes for smoke runs")
    p.add_argument("--medium", action="store_true",
                   help="the demixing trainers' thinner backend "
                        "(demix_sac.make_backend)")
    p.add_argument("--light", action="store_true",
                   help="the demixing trainers' lightest backend "
                        "(demix_sac.make_backend)")
    p.add_argument("--load", action="store_true")
    p.add_argument("--prefix", type=str, default="calib_sac")
    p.add_argument("--fixed_K", type=int, default=None,
                   help="pin the per-episode direction count (default: "
                        "reference draw in [2, M])")
    p.add_argument("--baseline_reward", action="store_true",
                   help="subtract each episode's own reset-calibration "
                        "reward from step rewards")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of env, agent and replay (cuda, or "
                        "cpu when asked for)")
    add_obs_args(p)
    add_runtime_args(p)
    add_batched_args(p)
    add_ere_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.small:
        backend = RadioBackend(n_stations=6, n_freqs=2, n_times=4, tdelta=2,
                               admm_iters=2, lbfgs_iters=3, init_iters=5,
                               npix=32, device=dev)
    elif args.light or args.medium:
        # the demixing trainers' CPU-tractable tiers (the two envs share the
        # backend)
        backend = demix_sac.make_backend(args, dev)
    else:
        backend = RadioBackend(n_stations=args.stations, npix=args.npix,
                               device=dev)
    batched = args.batch_envs > 1
    if batched:
        env = BatchedCalibEnv(M=args.M, n_envs=args.batch_envs,
                              provide_hint=args.use_hint, backend=backend,
                              seed=args.seed, fixed_K=args.fixed_K,
                              baseline_reward=args.baseline_reward,
                              device=dev)
    else:
        env = CalibEnv(M=args.M, provide_hint=args.use_hint,
                       backend=backend, seed=args.seed, fixed_K=args.fixed_K,
                       baseline_reward=args.baseline_reward, device=dev)
    agent_cfg = agent_config(backend.npix, args.M, args.use_hint,
                             args.ere_eta)
    agent = sac.SACAgent(agent_cfg, seed=args.seed, name_prefix=args.prefix,
                         device=dev, collect_diag=diag_from_args(args))
    if args.load:
        agent.load_models()

    scores = []
    tob = train_obs_from_args(args, "calib_sac")
    rt = TrainRuntime.from_args(args, args.prefix, tob=tob)
    if batched:
        # rewards keep the main_sac.py > 1 x10 scaling
        return run_batched_agent_loop(
            env, agent, agent_cfg, args, tob, rt,
            scale_reward=lambda r: r * 10 if r > 1 else r,
            use_hint=args.use_hint)
    i = 0
    restored = rt.restore()
    if restored is not None:
        scores, i, _ = restore_agent_loop(agent, env, restored)

    def ckpt_payload():
        return pack_agent_loop(agent, env, scores, i)

    try:
        while i < args.episodes:
            with tob.span("episode", episode=i):
                flat = flatten_obs(env.reset())
                score, loop, done = 0.0, 0, False
                while not done and loop < args.steps:
                    action = np.asarray(agent.choose_action(flat)).squeeze()
                    out = env.step(action)
                    if args.use_hint:
                        obs2, reward, done, hint, info = out
                    else:
                        obs2, reward, done, info = out
                        hint = np.zeros(2 * args.M, np.float32)
                    flat2 = flatten_obs(obs2)
                    # rewards > 1 scaled by 10 (main_sac.py:24,49)
                    scaled = reward * 10 if reward > 1 else reward
                    agent.store_transition(flat, action, scaled, flat2,
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
                    agent = apply_agent_recovery(agent, agent_cfg, act)
                    continue
            scores.append(score / max(loop, 1))
            tob.log_replay_health(agent.buffer, episode=i)
            tob.episode(i, scores[-1], scores, seed=args.seed,
                        use_hint=args.use_hint)
            agent.save_models()
            atomic_pickle(scores, f"{args.prefix}_scores.pkl")
            if tob.tripped:
                break
            i += 1
            rt.maybe_checkpoint(i, ckpt_payload)
    finally:
        tob.close()
    return scores


if __name__ == "__main__":
    main()
