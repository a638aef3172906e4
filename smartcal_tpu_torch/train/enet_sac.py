"""Elastic-net SAC trainer (counterpart of
smartcal_tpu/train/enet_sac.py).

Mirrors ``elasticnet/main_sac.py`` (episode loop, per-step learn, moving
average of scores) in two modes:

* ``--mode fused`` (default): each episode is reset, one noisy draw, the
  hint from that draw (zeros without ``--use_hint``), then per step: choose
  an action, step the env (the first step keeps the draw), store the
  transition and learn, all on tensors that stay on the device: the JAX
  package's one-XLA-program episode (:func:`make_episode_fn`) and its scan
  of ``--block`` episodes (:func:`make_episode_block_fn`), each on CUDA one
  CUDA-graph replay (``train/blocks.EpisodeProgram``; the env's solves and
  eigenvalues are kernels 4 and 5, so nothing in an episode asks the
  host), on the CPU the same body run eagerly;
* ``--mode loop``: the reference's host loop through ``EnetEnv`` and
  ``SACAgent``.

The fused mode takes the JAX trainer's obs and runtime flags
(:func:`fused_loop`): ``--metrics``, ``--diag``, ``--watchdog`` (both
force block 1), ``--ckpt-every``, ``--resume`` (bit for bit),
``--max-recoveries``.  The programs refuse ``eig_mode="exact"``: its host
eigensolver cannot be captured.

Usage:
    python -m smartcal_tpu_torch.train.enet_sac --episodes 1000 --steps 5
        [--seed 0] [--use_hint] [--mode fused|loop] [--block 20]
        [--device cuda|cpu] [--metrics run.jsonl] [--ckpt-every 10]
        [--resume]
"""

import argparse
import json
import sys
import time

import numpy as np
import torch

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.envs import enet
from smartcal_tpu_torch.obs import stack_diags
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl import sac
from smartcal_tpu_torch.runtime.atomic import atomic_pickle
from smartcal_tpu_torch.train.blocks import (add_obs_args, add_runtime_args,
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
                use_hint: bool, collect_diag: bool = False):
    """One fused episode; updates ``st`` and ``buf`` in place and returns
    the mean reward (a device scalar), with ``collect_diag`` also the
    episode's step-stacked UpdateDiag."""
    env_state, obs, hint = start_episode(env_cfg, cfg.n_actions, draws,
                                         use_hint)
    rewards, diags = [], []
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
        m = sac.learn(cfg, st, buf, **draws.learn(),
                      collect_diag=collect_diag)
        if collect_diag:
            diags.append(m["diag"])
        rewards.append(reward)
        obs = obs2
    score = torch.stack(rewards).mean()
    return (score, stack_diags(diags)) if collect_diag else score


def program_env(env_cfg: enet.EnetConfig) -> enet.EnetConfig:
    """``env_cfg`` checked for the episode programs: ``eig_mode="exact"``
    takes its eigenvalues on the host (numpy, the JAX package's host
    callback), which a CUDA graph cannot capture."""
    if env_cfg.eig_mode != "symmetric":
        raise ValueError(
            f"eig_mode={env_cfg.eig_mode!r}: the episode programs run on "
            "the device only, and the exact mode's host eigensolver cannot "
            "be captured into a CUDA graph; use eig_mode='symmetric', or "
            "the host loop (--mode loop, EnetEnv)")
    return env_cfg


def episode_body(env_cfg: enet.EnetConfig, cfg: sac.SACConfig, steps: int,
                 use_hint: bool, collect_diag: bool = False):
    """The one-episode body ``(agent_state, buf, draws) -> score`` of the
    programs (the JAX package's ``_make_episode_body``): :func:`run_episode`
    in the same draw order."""
    program_env(env_cfg)

    def body(st, buf, draws):
        return run_episode(env_cfg, cfg, st, buf, draws, steps, use_hint,
                           collect_diag)
    return body


def episode_fn(body, collect_diag, name):
    """The one-episode program of ``body`` as a call ``(agent_state, buf,
    draws) -> score`` (0-d), with ``collect_diag`` ``(score, diag)``; its
    :class:`~smartcal_tpu_torch.train.blocks.EpisodeProgram` is
    ``.program``."""
    from smartcal_tpu_torch.train.blocks import make_block_fn

    prog = make_block_fn(body, 1, name)

    def run(st, buf, draws):
        out = prog(st, buf, draws)
        return (out[0][0], out[1][0]) if collect_diag else out[0]

    run.program = prog
    return run


def make_episode_fn(env_cfg: enet.EnetConfig, agent_cfg: sac.SACConfig,
                    steps: int, use_hint: bool, collect_diag: bool = False):
    """One fused episode (reset, hint, ``steps`` steps) as a program: on
    CUDA one CUDA-graph replay per call.  ``run(agent_state, buf, draws)``
    updates the state, the ring and the draws' generator in place."""
    return episode_fn(episode_body(env_cfg, agent_cfg, steps, use_hint,
                                   collect_diag), collect_diag,
                      "enet_sac_episode")


def make_episode_block_fn(env_cfg: enet.EnetConfig, agent_cfg: sac.SACConfig,
                          steps: int, use_hint: bool, block: int):
    """``block`` strictly sequential episodes as one program: the same
    learning dynamics as ``block`` calls of :func:`make_episode_fn` (agent,
    ring and generator chain from episode to episode), one replay per call
    on CUDA; returns the (block,) scores.  Not a batched-env mode."""
    from smartcal_tpu_torch.train.blocks import make_block_fn

    return make_block_fn(episode_body(env_cfg, agent_cfg, steps, use_hint),
                         block, f"enet_sac_block{block}")


def agent_config(env_cfg: enet.EnetConfig, use_hint) -> sac.SACConfig:
    """The trainer's agent (enet main_sac.py): 2 actions, batch 64, a
    1024-slot ring, reward scale N, alpha 0.03."""
    return sac.SACConfig(
        obs_dim=env_cfg.obs_dim, n_actions=2, gamma=0.99, tau=0.005,
        batch_size=64, mem_size=1024, lr_a=1e-3, lr_c=1e-3,
        reward_scale=float(env_cfg.N), alpha=0.03, use_hint=use_hint)


def make_programs(body, cfg, block, episodes, collect, entry):
    """(block program or None, episode program or None) of ``body(cfg,
    collect)``, the JAX trainers' ``build_fns``: the block program when
    ``block`` > 1, the episode program when ``block`` is 1 or does not
    divide ``episodes`` (the remainder)."""
    from smartcal_tpu_torch.train.blocks import make_block_fn

    bf = (make_block_fn(body(cfg, False), block, f"{entry}_block{block}")
          if block > 1 else None)
    ef = (make_block_fn(body(cfg, collect), 1, f"{entry}_episode")
          if block == 1 or episodes % block else None)
    return bf, ef


def fused_loop(entry, seed, episodes, cfg, state, buf, generator, device,
               body, save, save_every, tob, rt, log_every=1, block=1,
               **tags):
    """The episode loop of the fused elastic-net trainers (the JAX
    trainers' ``train_fused`` loop) over the episode programs:
    ``body(cfg, collect_diag)`` is the trainer's episode body
    ``(agent_state, buf, draws) -> score`` (with the step-stacked
    UpdateDiag when diagnostics are on), run as programs of ``block``
    episodes and one-episode programs for the remainder
    (:func:`make_programs`); ``--diag`` and ``--watchdog`` force block 1.
    ``--resume`` restores ``state``, ``buf``, the generator, scores and
    the episode from the newest checkpoint, in place; the cadence
    checkpoints after each program call; a watchdog trip rolls back and
    retries (the LR shrink builds new programs for the episodes that
    follow).  ``save(state, buf, scores)`` runs when a ``save_every``
    multiple was crossed and at the end.  Returns (scores, wall seconds,
    agent state, ring)."""
    from smartcal_tpu_torch.train.blocks import (fused_payload, load_into,
                                                 load_ring_into,
                                                 restore_fused,
                                                 rollback_fused,
                                                 scaled_config)

    state_cls = type(state)
    collect = tob.collect_diag
    block = max(1, min(int(block), episodes))
    if collect and block > 1:
        # diagnostics stream at per-episode cadence: the watchdog must see
        # updates before committing to a whole block's compute
        tob.echo("diag/watchdog: forcing block=1")
        block = 1
    draws = Draws(generator, device)
    progs = make_programs(body, cfg, block, episodes, collect, entry)
    scores = []
    i, saved_marker = 0, 0

    def restore_in_place(restored_state, restored_buf):
        load_into(state, restored_state)
        load_ring_into(buf, restored_buf)

    restored = rt.restore()
    if restored is not None:
        st2, buf2, scores, i = restore_fused(restored, state_cls, cfg,
                                             generator, device)
        restore_in_place(st2, buf2)
        saved_marker = int(restored.get("saved_marker", 0))

    def payload():
        return fused_payload(entry, seed, i, scores, state, buf, generator,
                             saved_marker=saved_marker)

    def log_one(score):
        scores.append(float(score))
        tob.episode(i, scores[-1], scores, echo=(i % log_every == 0),
                    seed=seed, **tags)

    def rebuild(lr_scale):
        nonlocal progs
        progs = make_programs(body, scaled_config(cfg, lr_scale), block,
                              episodes, collect, entry)

    t0 = time.time()
    try:
        while i < episodes:
            block_fn, episode_fn = progs
            if block_fn is not None and episodes - i >= block:
                with tob.span("episode_block", episodes=block):
                    blk = block_fn(state, buf, draws).tolist()
                for sc in blk:
                    log_one(sc)
                    i += 1
            else:
                with tob.span("episode", episode=i):
                    out = episode_fn(state, buf, draws)
                if collect:
                    score, ep_diag = out[0][0], out[1][0]
                    halted = tob.record_diag(ep_diag, episode=i)
                    tob.log_replay_health(buf, episode=i)
                    if halted or tob.tripped:
                        act = rt.on_trip()
                        if act is None:
                            log_one(score)
                            i += 1
                            break
                        # rollback-and-retry: the poisoned episodes since
                        # the checkpoint are discarded (not logged)
                        st2, buf2, scores, i = rollback_fused(
                            act, state_cls, cfg, generator, device, rebuild)
                        restore_in_place(st2, buf2)
                        saved_marker = int(act.payload.get("saved_marker",
                                                           0))
                        continue
                else:
                    score = out[0]
                log_one(score)
                i += 1
            rt.maybe_checkpoint(i, payload)
            if save_every and i < episodes and i // save_every > saved_marker:
                save(state, buf, scores)
                saved_marker = i // save_every
        wall = time.time() - t0
    finally:
        tob.close()
    save(state, buf, scores)
    return scores, wall, state, buf


def fused_handles(entry, tob, seed, quiet, metrics_path, run_id, trace, diag,
                  watchdog, ckpt_dir, ckpt_every, keep_ckpts, resume,
                  max_recoveries, recovery_lr_shrink, recovery_reseed,
                  compile_cache=None, deterministic=False, **meta):
    """(TrainObs, TrainRuntime) of a fused trainer's keyword arguments (the
    JAX ``train_fused`` signature); ``tob`` given is used as it is."""
    from smartcal_tpu_torch.train.blocks import TrainObs, TrainRuntime

    if tob is None:
        tob = TrainObs(entry, metrics=metrics_path, run_id=run_id,
                       trace=trace, quiet=quiet, diag=diag,
                       watchdog=watchdog or max_recoveries > 0,
                       compile_cache=compile_cache,
                       deterministic=deterministic, seed=seed, **meta)
    rt = TrainRuntime(entry, ckpt_dir=ckpt_dir, ckpt_every=ckpt_every,
                      keep=keep_ckpts, resume=resume,
                      max_recoveries=max_recoveries,
                      lr_shrink=recovery_lr_shrink, reseed=recovery_reseed,
                      tob=tob)
    return tob, rt


def runtime_kwargs(args) -> dict:
    """The ``train_fused`` keyword arguments of the obs and runtime
    flags."""
    return dict(quiet=args.quiet, metrics_path=args.metrics,
                run_id=args.run_id, trace=args.trace, diag=args.diag,
                watchdog=args.watchdog, ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every, keep_ckpts=args.keep_ckpts,
                resume=args.resume, max_recoveries=args.max_recoveries,
                recovery_lr_shrink=args.recovery_lr_shrink,
                recovery_reseed=args.recovery_reseed,
                compile_cache=args.compile_cache,
                deterministic=args.deterministic)


def add_size_args(p):
    """The elastic-net problem size (the reference's M = N = 20)."""
    p.add_argument("--M", type=int, default=20,
                   help="rows of the regression problem")
    p.add_argument("--N", type=int, default=20,
                   help="columns (parameters) of the regression problem")


def save(agent_state, buf, scores, prefix):
    atomic_pickle(agent_state.to_host(), f"{prefix}sac_state.pkl")
    rp.save_replay(buf, f"{prefix}replaymem_sac.pkl")
    atomic_pickle(scores, f"{prefix}scores.pkl")


def train_fused(seed=0, episodes=1000, steps=5, use_hint=False, M=20, N=20,
                log_every=1, save_every=500, prefix="", quiet=False,
                metrics_path=None, block=1, run_id=None, trace=None,
                diag=False, watchdog=False, ckpt_dir=None, ckpt_every=0,
                keep_ckpts=3, resume=False, max_recoveries=0,
                recovery_lr_shrink=0.5, recovery_reseed=True,
                compile_cache=None, deterministic=False, tob=None,
                device="cuda"):
    """Fused episodes on ``device`` with the JAX ``train_fused``'s
    observability and fault-tolerance arguments: programs of ``block``
    episodes (one CUDA-graph replay each on the card), one-episode
    programs for the remainder; saves every ``save_every`` episodes and at
    the end.  Returns (scores, wall seconds, agent state, ring)."""
    dev = resolve_device(device)
    env_cfg = enet.EnetConfig(M=M, N=N)
    cfg = agent_config(env_cfg, use_hint)
    generator = torch.Generator(device=dev).manual_seed(seed)
    agent_state = sac.sac_init(cfg, generator, dev)
    buf = rp.replay_init(cfg.mem_size, rp.transition_spec(cfg.obs_dim,
                                                          cfg.n_actions), dev)
    tob, rt = fused_handles(
        "enet_sac", tob, seed, quiet, metrics_path, run_id, trace, diag,
        watchdog, ckpt_dir, ckpt_every, keep_ckpts, resume, max_recoveries,
        recovery_lr_shrink, recovery_reseed, compile_cache,
        deterministic=deterministic, block=block)
    return fused_loop(
        "enet_sac", seed, episodes, cfg, agent_state, buf, generator, dev,
        lambda c, collect: episode_body(env_cfg, c, steps, use_hint,
                                        collect),
        lambda st, b, sc: save(st, b, sc, prefix), save_every, tob, rt,
        log_every, block=block, use_hint=use_hint)


def train_loop(seed=0, episodes=1000, steps=5, use_hint=False, M=20, N=20,
               tob=None, device="cuda"):
    """Reference-style host loop (main_sac.py:47-76); ``tob``'s diagnostics
    and watchdog act here too."""
    env = enet.EnetEnv(M, N, provide_hint=use_hint, seed=seed, device=device)
    agent = sac.SACAgent(agent_config(env.cfg, use_hint), seed=seed,
                         device=device,
                         collect_diag=tob is not None and tob.collect_diag)
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
            if tob is not None and tob.record_diag(agent.last_diag,
                                                   episode=i):
                done = True
            obs = obs2
            loop += 1
        scores.append(score / loop)
        if tob is not None:
            tob.episode(i, scores[-1], scores, seed=seed, use_hint=use_hint)
            if tob.tripped:
                break
    return scores


def reject_loop_runtime(args):
    """``--mode loop`` is the reference's plain host loop, as in the JAX
    trainer: the checkpoint flags act in ``--mode fused`` only, and are
    refused here rather than ignored."""
    for attr, flag in (("resume", "--resume"), ("ckpt_every", "--ckpt-every"),
                       ("max_recoveries", "--max-recoveries")):
        if getattr(args, attr):
            raise SystemExit(f"{flag} acts in --mode fused only")


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
                   help="episodes per program call (one CUDA-graph replay "
                        "of whole episodes on the card; the same learning "
                        "dynamics as --block 1, the reference's "
                        "per-episode cadence)")
    p.add_argument("--prefix", type=str, default="",
                   help="path prefix of the saved agent, ring and scores")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of env, agent and replay (cuda, or "
                        "cpu when asked for)")
    add_size_args(p)
    add_obs_args(p)
    add_runtime_args(p)
    args = p.parse_args(argv)
    if args.mode == "loop":
        reject_loop_runtime(args)
        tob = train_obs_from_args(args, "enet_sac")
        try:
            return train_loop(seed=args.seed, episodes=args.episodes,
                              steps=args.steps, use_hint=args.use_hint,
                              M=args.M, N=args.N, tob=tob,
                              device=args.device)
        finally:
            tob.close()
    scores, wall, _, _ = train_fused(
        seed=args.seed, episodes=args.episodes, steps=args.steps,
        use_hint=args.use_hint, M=args.M, N=args.N, prefix=args.prefix,
        block=args.block, device=args.device, **runtime_kwargs(args))
    out = summary(args.episodes, args.steps, wall, scores)
    sys.stdout.write(json.dumps(out) + "\n")
    return out


if __name__ == "__main__":
    main()
