"""Training-loop plumbing the calibration SAC trainer needs (counterpart of
part of smartcal_tpu/train/blocks.py).

The flag sets are the JAX trainers' own (``add_obs_args``,
``add_runtime_args``, ``add_batched_args``, ``add_ere_arg``), so a command
line of the JAX trainer parses here too.  What stands behind some of them is
not ported yet; :func:`reject_unported` names the ROADMAP item that brings
each such flag instead of ignoring it.  :class:`TrainObs` is the run
handle with neither a metrics stream nor a trace: the per-episode echo on
stderr and no-op span, diagnostics and replay-health hooks.
:class:`TrainRuntime` is the fault-tolerance handle with no checkpoint
flag set: restore and checkpoint are no-ops.  :func:`run_batched_agent_loop`
is the vector-episode loop of ``--batch-envs`` > 1 (with the demixing
trainers' warm-up).
"""

import contextlib
import os
import sys


def add_runtime_args(p):
    """The shared fault-tolerance flags (checkpoint / resume / watchdog
    recovery)."""
    p.add_argument("--resume", action="store_true",
                   help="restore the run from the newest valid checkpoint "
                        "in --ckpt-dir and continue bit-continuably")
    p.add_argument("--ckpt-dir", dest="ckpt_dir", type=str, default=None,
                   help="checkpoint root (default <entry>_ckpt)")
    p.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=0,
                   help="checkpoint every N episodes (0 = none)")
    p.add_argument("--keep-ckpts", dest="keep_ckpts", type=int, default=3,
                   help="retained checkpoints (older ones are pruned)")
    p.add_argument("--max-recoveries", dest="max_recoveries", type=int,
                   default=0,
                   help="on a watchdog trip, roll back to the last good "
                        "checkpoint and retry up to N times")
    p.add_argument("--recovery-lr-shrink", dest="recovery_lr_shrink",
                   type=float, default=0.5,
                   help="learning-rate multiplier applied per recovery")
    p.add_argument("--no-recovery-reseed", dest="recovery_reseed",
                   action="store_false", default=True,
                   help="do NOT fold a fresh offset into the exploration "
                        "key stream on recovery")
    return p


def add_obs_args(p):
    """The shared observability flags."""
    p.add_argument("--metrics", type=str, default=None,
                   help="obs run JSONL path")
    p.add_argument("--run_id", type=str, default=None,
                   help="run id recorded in the JSONL header")
    p.add_argument("--trace", type=str, default=None,
                   help="profiler trace dir")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the per-episode stderr echo")
    p.add_argument("--diag", action="store_true",
                   help="collect per-update agent diagnostics")
    p.add_argument("--watchdog", action="store_true",
                   help="arm the divergence watchdog (implies --diag)")
    p.add_argument("--compile-cache", dest="compile_cache", type=str,
                   default=os.environ.get("SMARTCAL_COMPILE_CACHE") or None,
                   help="persistent compilation cache dir")
    return p


def add_ere_arg(p):
    """The ERE knob for single-learner trainers."""
    p.add_argument("--ere", dest="ere_eta", type=float, default=1.0,
                   help="emphasizing-recent-experience sampling knob "
                        "eta in (0, 1]: 1 = off, smaller biases replay "
                        "sampling toward recent transitions "
                        "(composes with PER)")
    return p


def add_batched_args(p):
    """The batched-env flag shared by the radio trainers."""
    p.add_argument("--batch-envs", dest="batch_envs", type=int, default=1,
                   help="run N env lanes as one batched pass (1 = the "
                        "sequential reference loop).  Each vector step "
                        "stores N transitions and runs ONE learn")
    return p


def diag_from_args(args) -> bool:
    """True when the run would consume update diagnostics: ``--diag`` or
    ``--watchdog`` with a sink (metrics, trace, or the watchdog)."""
    wd = bool(getattr(args, "watchdog", False)
              or getattr(args, "max_recoveries", 0))
    want = bool(getattr(args, "diag", False) or wd)
    sink = (getattr(args, "metrics", None) is not None
            or getattr(args, "trace", None) is not None or wd)
    return want and sink


# flag (attribute, command-line name) -> the ROADMAP queue 1 item that
# ports what stands behind it
UNPORTED = (
    ("metrics", "--metrics", 12), ("trace", "--trace", 12),
    ("diag", "--diag", 12), ("watchdog", "--watchdog", 12),
    ("compile_cache", "--compile-cache", 12), ("resume", "--resume", 12),
    ("ckpt_every", "--ckpt-every", 12),
    ("max_recoveries", "--max-recoveries", 12),
)


def reject_unported(args) -> None:
    """Raise for a flag whose machinery the port does not have yet, naming
    the ROADMAP queue 1 item that brings it."""
    for attr, flag, item in UNPORTED:
        if getattr(args, attr, None):
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP queue 1 item {item}")


class TrainObs:
    """Per-run observability handle without a sink: the classic "episode N
    score ..." echo on stderr (``--quiet`` silences it); span, diagnostics
    and replay-health hooks do nothing."""

    def __init__(self, entry, quiet=False):
        self.entry = entry
        self.quiet = quiet

    def span(self, name, **tags):
        return contextlib.nullcontext()

    def record_diag(self, diag, **tags) -> bool:
        return False

    def log_replay_health(self, buf, **tags) -> bool:
        return False

    def episode(self, i, score, scores=None, **fields):
        if scores:
            tail = scores[-100:]
            avg = sum(float(s) for s in tail) / len(tail)
        else:
            avg = float(score)
        self.echo(f"episode {i} score {float(score):.2f} "
                  f"average score {avg:.2f}")

    def echo(self, msg, **fields):
        if not self.quiet:
            sys.stderr.write(msg + "\n")

    def close(self):
        pass


def train_obs_from_args(args, entry) -> TrainObs:
    return TrainObs(entry, quiet=getattr(args, "quiet", False))


class TrainRuntime:
    """Fault-tolerance handle with no checkpoint flag set (the others raise
    in :func:`reject_unported`): nothing to restore, nothing to save."""

    def __init__(self, entry):
        self.entry = entry

    def restore(self):
        return None

    def maybe_checkpoint(self, step, build_payload) -> bool:
        return False


def run_batched_agent_loop(env, agent, args, tob, rt, scale_reward,
                           use_hint=False, warmup=0, warmup_rng=None,
                           episodes=None, to_flat=None, scores=None):
    """Vector-episode loop of the batched radio envs (the JAX package's
    ``run_batched_agent_loop`` without checkpoint restore and watchdog,
    which are not ported): each vector episode resets all E lanes; each
    vector step advances them in one batched pass, stores the E
    transitions and runs ONE learn (the 1:E learn:env-step regime).  The
    first ``warmup`` vector episodes act randomly through ``warmup_rng``
    (the demixing trainers' warm-up).  ``episodes`` defaults to
    ``args.episodes``, ``to_flat`` to ``flatten_obs_batch``; ``scores`` (a
    ``--load``ed history) is extended.  ``scores`` keeps the sequential drivers'
    format: E per-lane mean-step-reward entries per vector episode,
    ceil(episodes / E) vector episodes."""
    import numpy as np

    from smartcal_tpu_torch.rl.networks import flatten_obs_batch
    from smartcal_tpu_torch.runtime.atomic import atomic_pickle

    if to_flat is None:
        to_flat = flatten_obs_batch
    if episodes is None:
        episodes = args.episodes
    E = env.n_envs
    n_vec = -(-episodes // E)
    scores = list(scores) if scores else []
    rt.restore()
    try:
        for i in range(n_vec):
            with tob.span("episode", episode=i, lanes=E):
                flat = to_flat(env.reset())
                score = np.zeros(E, np.float64)
                loop, done = 0, False
                while not done and loop < args.steps:
                    if i < warmup and warmup_rng is not None:
                        actions = warmup_rng.uniform(
                            -1.0, 1.0, (E, agent.cfg.n_actions)).astype(
                                np.float32)
                    else:
                        actions = np.asarray(
                            agent.choose_action(flat)).reshape(E, -1)
                    out = env.step(actions)
                    if use_hint:
                        ob2, rewards, dones, hints, _ = out
                    else:
                        ob2, rewards, dones, _ = out
                        hints = np.zeros((E, agent.cfg.n_actions),
                                         np.float32)
                    flat2 = to_flat(ob2)
                    for e in range(E):
                        agent.store_transition(
                            flat[e], actions[e],
                            scale_reward(float(rewards[e])), flat2[e],
                            bool(dones[e]), hints[e])
                    agent.learn()          # one learn per vector step
                    if tob.record_diag(agent.last_diag, episode=i):
                        done = True
                    score += np.asarray(rewards, np.float64)
                    flat = flat2
                    loop += 1
            per_lane = score / max(loop, 1)
            scores.extend(float(s) for s in per_lane)
            tob.log_replay_health(agent.buffer, episode=i)
            tob.episode(i, float(per_lane.mean()), scores,
                        seed=getattr(args, "seed", None), lanes=E)
            agent.save_models()
            atomic_pickle(scores, f"{args.prefix}_scores.pkl")
            rt.maybe_checkpoint(i + 1, lambda: None)
    finally:
        tob.close()
    return scores
