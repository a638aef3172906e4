"""Demixing (direction selection) SAC trainer (counterpart of
smartcal_tpu/train/demix_sac.py; reference ``demixing_rl/main_sac.py``).

K=6 directions (5 outliers + the target), K actions (K-1 selections and
the max ADMM iterations), 7 steps per episode, warm-up episodes with random
actions from the driver's numpy generator, rewards above 0 scaled by 10,
the agent and scores saved after every episode.  Env, agent and replay
ring live on ``--device`` (default cuda).  ``--batch-envs E`` > 1 trains
on a ``BatchedDemixingEnv`` of E lanes, one learn per vector step.

Usage:
    python -m smartcal_tpu_torch.train.demix_sac --iteration 1000 --seed 0
        [--use_hint] [--provide_influence] [--small | --light | --medium]
        [--batch-envs E] [--device cpu]
"""

import argparse

import numpy as np

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.envs.demixing import BatchedDemixingEnv, DemixingEnv
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.rl import sac
from smartcal_tpu_torch.rl.networks import flatten_obs, flatten_obs_batch
from smartcal_tpu_torch.runtime.atomic import atomic_pickle, safe_pickle_load
from smartcal_tpu_torch.train.blocks import (TrainRuntime,
                                             add_batched_args, add_ere_arg,
                                             add_obs_args, add_runtime_args,
                                             apply_agent_recovery,
                                             diag_from_args, pack_agent_loop,
                                             restore_agent_loop,
                                             run_batched_agent_loop,
                                             train_obs_from_args)


def make_backend(args, device="cuda"):
    """The backend tiers of the demixing-family trainers (and of calib_sac
    --light/--medium): ``--small`` (test speed), ``--light`` (N=stations,
    one solution interval, minimum useful inner solves, one hint mask at a
    time), ``--medium`` (N=stations with thinner time/frequency axes), and
    the default (the reference-like N/Nf/T)."""
    if getattr(args, "small", False):
        return RadioBackend(n_stations=6, n_freqs=2, n_times=4, tdelta=2,
                            admm_iters=30, lbfgs_iters=3, init_iters=5,
                            npix=32, device=device)
    if getattr(args, "light", False):
        return RadioBackend(n_stations=args.stations, n_freqs=2,
                            n_times=5, tdelta=5, admm_iters=30,
                            lbfgs_iters=3, init_iters=8, npix=args.npix,
                            hint_batch=1, device=device)
    if getattr(args, "medium", False):
        return RadioBackend(n_stations=args.stations, n_freqs=2,
                            n_times=10, tdelta=5, admm_iters=30,
                            lbfgs_iters=4, init_iters=10, npix=args.npix,
                            hint_batch=1, device=device)
    return RadioBackend(n_stations=args.stations, admm_iters=30,
                        npix=args.npix, device=device)


def obs_shape(npix, n_meta, provide_influence):
    """(obs_dim, img_shape): without influence maps the observation is the
    metadata alone (an all-zero npix² image in replay would waste ~2 GB at
    mem_size=16000)."""
    if provide_influence:
        return npix * npix + n_meta, (npix, npix)
    return n_meta, None


def flattener(provide_influence, batched=False):
    """The observation -> flat vector map of the trainers."""
    if provide_influence:
        return flatten_obs_batch if batched else flatten_obs
    return lambda o: np.asarray(o["metadata"], np.float32)


def run_warmup_loop(env, agent, args, scores, to_flat, n_actions,
                    scale_reward, rng, tob=None):
    """The episode loop of the demixing-family trainers
    (demixing_rl/main_sac.py:54-98, demixing_fuzzy/main_sac.py:70-99):
    random actions from ``rng`` for the first ``args.warmup`` episodes'
    steps, then the agent's; one learn per step; the agent and the scores
    saved after every episode.  ``--ckpt-every`` checkpoints the agent,
    ring, generators, env key, the warm-up numpy generator and the step
    count; ``--resume`` continues from it bit for bit; a watchdog trip
    with ``--max-recoveries`` rolls back and retries.  The JAX package's
    periodic ``jax.clear_caches()`` has no counterpart: there is no
    compiled-executable cache to bound."""
    tob = tob or train_obs_from_args(args, args.prefix)
    rt = TrainRuntime.from_args(args, args.prefix, tob=tob)
    base_cfg = agent.cfg
    total_steps = 0
    warmup_steps = args.warmup * args.steps
    i = 0

    def restore(payload):
        nonlocal i, total_steps
        scores_r, i, extra = restore_agent_loop(agent, env, payload)
        scores[:] = scores_r
        total_steps = int(extra.get("total_steps", 0))
        if "np_rng" in extra:
            rng.bit_generator.state = extra["np_rng"]

    restored = rt.restore()
    if restored is not None:
        restore(restored)

    def ckpt_payload():
        return pack_agent_loop(
            agent, env, scores, i,
            extra={"total_steps": total_steps,
                   "np_rng": rng.bit_generator.state})

    try:
        while i < args.iteration:
            with tob.span("episode", episode=i):
                flat = to_flat(env.reset())
                score, loop, done = 0.0, 0, False
                while not done and loop < args.steps:
                    if total_steps < warmup_steps:
                        action = rng.uniform(-1, 1,
                                             n_actions).astype(np.float32)
                    else:
                        action = np.asarray(
                            agent.choose_action(flat)).squeeze()
                    out = env.step(action)
                    if args.use_hint:
                        obs2, reward, done, hint, info = out
                    else:
                        obs2, reward, done, info = out
                        hint = np.zeros(n_actions, np.float32)
                    flat2 = to_flat(obs2)
                    agent.store_transition(flat, action,
                                           scale_reward(reward), flat2,
                                           done, hint)
                    agent.learn()
                    if tob.record_diag(agent.last_diag, episode=i):
                        done = True
                    score += reward
                    flat = flat2
                    loop += 1
                    total_steps += 1
            if tob.tripped:
                act = rt.on_trip()
                if act is not None:
                    # discard the poisoned episodes, restore, mitigate
                    restore(act.payload)
                    agent = apply_agent_recovery(agent, base_cfg, act)
                    continue
            scores.append(score / max(loop, 1))
            tob.log_replay_health(agent.buffer, episode=i)
            tob.episode(i, scores[-1], scores, seed=args.seed,
                        use_hint=args.use_hint,
                        warmup=total_steps <= warmup_steps)
            agent.save_models()
            atomic_pickle(scores, f"{args.prefix}_scores.pkl")
            if tob.tripped:
                break
            i += 1
            rt.maybe_checkpoint(i, ckpt_payload)
    finally:
        tob.close()
    return scores


def add_device_arg(p):
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of env, agent and replay (cuda, or "
                        "cpu when asked for)")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iteration", type=int, default=1000,
                   help="max episodes")
    p.add_argument("--warmup", type=int, default=30,
                   help="warmup episodes (random actions)")
    p.add_argument("--steps", type=int, default=7)
    p.add_argument("--K", type=int, default=6)
    p.add_argument("--use_hint", action="store_true")
    p.add_argument("--provide_influence", action="store_true")
    p.add_argument("--stations", type=int, default=14)
    p.add_argument("--npix", type=int, default=128)
    p.add_argument("--small", action="store_true")
    p.add_argument("--medium", action="store_true",
                   help="N=stations with thinner time/freq axes and lighter "
                        "inner solves")
    p.add_argument("--light", action="store_true",
                   help="N=stations, one solution interval, minimum useful "
                        "solver iterations")
    p.add_argument("--load", action="store_true")
    p.add_argument("--prefix", type=str, default="demix_sac")
    add_device_arg(p)
    add_obs_args(p)
    add_runtime_args(p)
    add_batched_args(p)
    add_ere_arg(p)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    rng = np.random.default_rng(args.seed)
    backend = make_backend(args, dev)
    batched = args.batch_envs > 1
    if batched:
        if args.use_hint:
            raise SystemExit("--use_hint is not supported with "
                             "--batch-envs (the exhaustive hint sweep "
                             "stays per-lane; run it sequentially)")
        env = BatchedDemixingEnv(K=args.K, n_envs=args.batch_envs,
                                 provide_influence=args.provide_influence,
                                 backend=backend, seed=args.seed, device=dev)
    else:
        env = DemixingEnv(K=args.K, provide_hint=args.use_hint,
                          provide_influence=args.provide_influence,
                          backend=backend, seed=args.seed, device=dev)
    obs_dim, img_shape = obs_shape(backend.npix, 3 * args.K + 2,
                                   args.provide_influence)
    agent_cfg = sac.SACConfig(
        obs_dim=obs_dim, n_actions=args.K, gamma=0.99, tau=0.005,
        batch_size=256, mem_size=16000, lr_a=3e-4, lr_c=1e-3, alpha=0.03,
        hint_threshold=0.01, admm_rho=1.0, use_hint=args.use_hint,
        hint_distance="kld", img_shape=img_shape, ere_eta=args.ere_eta)
    agent = sac.SACAgent(agent_cfg, seed=args.seed, name_prefix=args.prefix,
                         device=dev, collect_diag=diag_from_args(args))
    scores = []
    if args.load:
        agent.load_models()
        scores = safe_pickle_load(f"{args.prefix}_scores.pkl", default=[])

    # rewards > 0 scaled by 10 (demixing_rl/main_sac.py reward shaping)
    def scale_reward(r):
        return r * 10 if r > 0 else r

    if batched:
        tob = train_obs_from_args(args, args.prefix)
        rt = TrainRuntime.from_args(args, args.prefix, tob=tob)
        return run_batched_agent_loop(
            env, agent, agent_cfg, args, tob, rt, scale_reward,
            warmup=-(-args.warmup // args.batch_envs), warmup_rng=rng,
            episodes=args.iteration,
            to_flat=flattener(args.provide_influence, batched=True),
            scores=scores)
    return run_warmup_loop(env, agent, args, scores,
                           flattener(args.provide_influence), args.K,
                           scale_reward, rng)


if __name__ == "__main__":
    main()
