"""Shared trainer plumbing: the flags, the observability and
fault-tolerance handles, checkpoint payloads and the vector-episode loop
(counterpart of smartcal_tpu/train/blocks.py).

The flag sets are the JAX trainers' own (``add_obs_args``,
``add_runtime_args``, ``add_batched_args``, ``add_ere_arg``), so a command
line of a JAX trainer parses here too, and every flag acts:

* :class:`TrainObs` owns the run's RunLog (activated for the process, so
  the env, backend and solver record into it), the compile listener, the
  ``--trace`` profiler session (``torch.profiler``; the run log goes beside
  the trace), the update-diagnostics stream and the divergence watchdog,
  and the per-episode "episode N score ..." echo on stderr;
* :class:`TrainRuntime` owns the checkpoint cadence, the ``--resume``
  restore and the watchdog's rollback-and-retry;
* ``--deterministic`` (:func:`set_deterministic`, applied by ``TrainObs``
  for the run and undone at its close) makes a run's learn steps the same
  bits on every run of the card, which keeps the runtime's contract (a
  resumed run equals the straight one bit for bit) once learning has
  begun;
* ``--diag`` also arms ``obs.costs`` (the per-stage flops/bytes events
  and the card's ``roofline_peak``), whose deferred counts ``TrainObs``
  runs between episodes;
* :func:`pack_agent_loop` / :func:`restore_agent_loop` /
  :func:`apply_agent_recovery` are the checkpoint payload of the
  host-driven agent loops (calib_*, demix_*), :func:`rollback_fused` the
  elastic-net trainers' rollback.

A payload holds host data only (numpy arrays, Python values): the agent
state's ``to_host``, the ring's filled prefix, the env's key and the
agent's ``torch.Generator`` state (a CPU ``ByteTensor`` also for a CUDA
generator, kept as a numpy uint8 array), so a checkpoint written on the
card resumes on the CPU.  With none of the flags set every hook is a
no-op and the hot loop is unchanged.
"""

import dataclasses
import os
import time

import numpy as np
import torch

from smartcal_tpu_torch import obs
from smartcal_tpu_torch.obs import costs
from smartcal_tpu_torch.runtime import faults as rt_faults

#: cuBLAS workspace of deterministic mode (PyTorch's reproducibility notes)
CUBLAS_DETERMINISTIC = ":4096:8"


def set_deterministic():
    """``--deterministic``: ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (unless the
    environment already names a workspace) and
    ``torch.use_deterministic_algorithms(True)``.  An op with no
    deterministic implementation then raises.  Off by default: the default
    run keeps its bits.  Returns a function that puts the mode and the
    variable back as they were."""
    was_on = torch.are_deterministic_algorithms_enabled()
    was_warn = torch.is_deterministic_algorithms_warn_only_enabled()
    workspace = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_DETERMINISTIC)
    torch.use_deterministic_algorithms(True)

    def restore():
        torch.use_deterministic_algorithms(was_on, warn_only=was_warn)
        if workspace is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = workspace
    return restore


def add_runtime_args(p):
    """The shared fault-tolerance flags (checkpoint / resume / watchdog
    recovery) and ``--deterministic``."""
    p.add_argument("--resume", action="store_true",
                   help="restore the run from the newest valid checkpoint "
                        "in --ckpt-dir and continue bit-continuably")
    p.add_argument("--ckpt-dir", dest="ckpt_dir", type=str, default=None,
                   help="checkpoint root (versioned ckpt_<episode>/ dirs + "
                        "LATEST pointer; default <entry>_ckpt)")
    p.add_argument("--ckpt-every", dest="ckpt_every", type=int, default=0,
                   help="checkpoint every N episodes (0 = none, except "
                        "--max-recoveries arms a default cadence of "
                        "10 so recovery has something to roll back to)")
    p.add_argument("--keep-ckpts", dest="keep_ckpts", type=int, default=3,
                   help="retained checkpoints (older ones are pruned)")
    p.add_argument("--max-recoveries", dest="max_recoveries", type=int,
                   default=0,
                   help="on a watchdog trip, roll back to the last good "
                        "checkpoint and retry up to N times before the "
                        "graceful halt (implies --watchdog)")
    p.add_argument("--recovery-lr-shrink", dest="recovery_lr_shrink",
                   type=float, default=0.5,
                   help="learning-rate multiplier applied per recovery "
                        "attempt (1.0 disables the LR mitigation)")
    p.add_argument("--no-recovery-reseed", dest="recovery_reseed",
                   action="store_false", default=True,
                   help="do NOT reseed the exploration generator on "
                        "recovery")
    p.add_argument("--deterministic", action="store_true",
                   help="deterministic algorithms (CUBLAS_WORKSPACE_CONFIG="
                        f"{CUBLAS_DETERMINISTIC}, torch.use_deterministic_"
                        "algorithms) for the run, so a resumed run equals "
                        "the straight one bit for bit once learning has "
                        "begun")
    return p


def add_obs_args(p):
    """The shared observability flags."""
    p.add_argument("--metrics", type=str, default=None,
                   help="obs run JSONL path (header + episode/span/solver "
                        "events; aggregate with tools/obs_report.py)")
    p.add_argument("--run_id", type=str, default=None,
                   help="run id recorded in the JSONL header "
                        "(default: generated)")
    p.add_argument("--trace", type=str, default=None,
                   help="torch.profiler trace dir (a Chrome trace; the "
                        "spans appear as record_function ranges, and the "
                        "run log goes beside it)")
    p.add_argument("--quiet", action="store_true",
                   help="suppress the per-episode stderr echo")
    p.add_argument("--diag", action="store_true",
                   help="collect per-update agent diagnostics (UpdateDiag "
                        "grad norms/Q stats/entropy) and replay health "
                        "into the metrics stream")
    p.add_argument("--watchdog", action="store_true",
                   help="arm the divergence watchdog on the diagnostics "
                        "stream (implies --diag): on NaN losses, exploding "
                        "grad norms or Q blowup, emit watchdog_trip and "
                        "halt the run gracefully")
    p.add_argument("--compile-cache", dest="compile_cache", type=str,
                   default=os.environ.get("SMARTCAL_COMPILE_CACHE") or None,
                   help="directory of the built CUDA kernel libraries (env "
                        "SMARTCAL_COMPILE_CACHE): repeat runs load them "
                        "instead of running nvcc again")
    return p


def add_ere_arg(p):
    """The ERE knob for single-learner trainers."""
    p.add_argument("--ere", dest="ere_eta", type=float, default=1.0,
                   help="emphasizing-recent-experience sampling knob "
                        "eta in (0, 1]: 1 = off, smaller biases replay "
                        "sampling toward recent transitions "
                        "(composes with PER)")
    return p


def add_fleet_args(p):
    """The actor-fleet flags of the parallel learners: actor count, the
    IMPACT IS-clip constant, the ERE knob, the weight-publication cadence,
    the actor backend, the replay shards and the simulated hosts."""
    p.add_argument("--n-actors", dest="n_actors", type=int, default=None,
                   help="actors of the supervised fleet / lanes of the "
                        "one-program learner (default: 2 supervised, 1 "
                        "lane per mesh dp device otherwise)")
    p.add_argument("--is-clip", dest="is_clip", type=float, default=0.0,
                   help="IMPACT staleness-clipped importance weighting "
                        "constant c >= 1 (0 = off): stale transitions' TD "
                        "loss is weighted by the policy ratio clipped to "
                        "[1/c, c]; same-version transitions are "
                        "bit-identical to the unweighted path")
    add_ere_arg(p)
    p.add_argument("--publish-every", dest="publish_every", type=int,
                   default=1,
                   help="supervised fleet: publish learner weights every N "
                        "learner rounds (N > 1 forces actor staleness)")
    p.add_argument("--actor-mode", dest="actor_mode",
                   choices=("thread", "process"), default="thread",
                   help="supervised fleet backend: 'thread' (actors share "
                        "this process, each on its own CUDA stream) or "
                        "'process' (spawned worker processes shipping "
                        "framed transition batches into per-slot ingest "
                        "queues)")
    p.add_argument("--replay-shards", dest="replay_shards", type=int,
                   default=0,
                   help="shard the learner's replay ring into N round-robin "
                        "shards on the device (0 = the flat ring)")
    p.add_argument("--sim-hosts", dest="sim_hosts", type=int, default=1,
                   help="process fleet: tag contiguous actor-slot blocks "
                        "with N simulated host ids (one machine)")
    return p


def add_lifecycle_args(p):
    """The online-lifecycle flags (``tools/serve_learn``: learn from served
    traffic, ``serve/lifecycle``).  The IMPACT/ERE spellings are
    ``add_fleet_args``' but with the lifecycle defaults armed: served
    traffic is off-policy and ages across policy hot-swaps, so
    staleness-clipped IS weighting and recency-biased sampling are the
    baseline here, not an ablation (the JAX package's defaults)."""
    p.add_argument("--is-clip", dest="is_clip", type=float, default=2.0,
                   help="IMPACT staleness-clipped importance weighting "
                        "constant c >= 1 (0 = off; default ON at 2.0): "
                        "transitions teed under an older policy version "
                        "get their TD update weighted by the clipped "
                        "policy ratio; current-version transitions are "
                        "bit-identical to the unweighted path")
    add_ere_arg(p)
    p.set_defaults(ere_eta=0.996)        # recency bias ON by default here
    p.add_argument("--learn-every-s", dest="learn_every_s", type=float,
                   default=0.25,
                   help="learner loop tick: drain the transition stage, "
                        "ingest, and run the learn steps every S seconds "
                        "of serving")
    p.add_argument("--publish-every", dest="publish_every", type=int,
                   default=8,
                   help="publish (versioned program-cache entry + atomic "
                        "hot-swap) the learner's policy every N learn "
                        "steps")
    p.add_argument("--replay-shards", dest="replay_shards", type=int,
                   default=4,
                   help="shards of the learner's device-resident versioned "
                        "replay ring")
    p.add_argument("--mem-size", dest="mem_size", type=int, default=1024,
                   help="replay ring capacity (divisible by "
                        "--replay-shards)")
    p.add_argument("--batch-size", dest="batch_size", type=int, default=64,
                   help="SAC learn batch size (the learn step no-ops "
                        "until the ring holds this many transitions)")
    p.add_argument("--stage-cap", dest="stage_cap", type=int, default=4096,
                   help="transition staging-ring capacity between the "
                        "batch worker and the learner (overflow drops "
                        "oldest, counted)")
    p.add_argument("--keep-versions", dest="keep_versions", type=int,
                   default=8,
                   help="published policy programs retained in the "
                        "program cache (older versions pruned)")
    return p


def add_batched_args(p):
    """The batched-env flag shared by the radio trainers."""
    p.add_argument("--batch-envs", dest="batch_envs", type=int, default=1,
                   help="run N env lanes as one batched pass (1 = the "
                        "sequential reference loop).  Each vector step "
                        "stores N transitions and runs ONE learn")
    return p


def diag_from_args(args) -> bool:
    """True when the run will consume update diagnostics: ``--diag`` or
    ``--watchdog`` with a sink (metrics, trace, or the watchdog itself);
    the trainers pass it as the agents' ``collect_diag``."""
    wd = bool(getattr(args, "watchdog", False)
              or getattr(args, "max_recoveries", 0))
    want = bool(getattr(args, "diag", False) or wd)
    sink = (getattr(args, "metrics", None) is not None
            or getattr(args, "trace", None) is not None or wd)
    return want and sink


class TrainObs:
    """Per-run observability handle of a trainer (see the module doc).
    With neither ``metrics`` nor ``trace`` set, the hooks are no-ops.
    ``deterministic`` turns on deterministic algorithms until
    :meth:`close`."""

    MEM_EVERY = 10          # episodes between device-memory gauge samples
    DIAG_LOG_EVERY = 1      # update-diag events logged every N updates

    def __init__(self, entry, metrics=None, run_id=None, trace=None,
                 quiet=False, diag=False, watchdog=False,
                 watchdog_cfg=None, compile_cache=None, deterministic=False,
                 **meta):
        self._undo_deterministic = (set_deterministic() if deterministic
                                    else None)
        self.entry = entry
        self.quiet = quiet
        if compile_cache:
            from smartcal_tpu_torch.ops import build
            build.set_build_dir(compile_cache)
        self._t0 = time.time()
        self._episodes = 0
        self._updates = 0
        self._trace_dir = trace
        self._profiler = None
        self.diag = bool(diag or watchdog)
        self.watchdog = obs.Watchdog(watchdog_cfg) if watchdog else None
        # a SMARTCAL_FAULTS plan (deterministic injection for the recovery
        # paths; no-op without the variable)
        rt_faults.install_from_env()
        path = metrics
        if path is None and trace:
            path = os.path.join(trace, f"{entry}_run.jsonl")
        self.runlog = None
        if deterministic:
            meta["deterministic"] = True
        if path:
            self.runlog = obs.RunLog(path, run_id=run_id,
                                     meta={"entry": entry, **meta})
            obs.activate(self.runlog)
            obs.install_compile_listener()
        if self.diag and self.runlog is None and self.watchdog is None:
            self.diag = False
            self.echo("--diag has no effect without --metrics or "
                      "--watchdog; diagnostics disabled")
        if self.diag and self.runlog is not None:
            # per-stage flops/bytes, counted once per shape signature, and
            # the fraction-of-peak denominator
            costs.set_enabled(True)
            costs.log_roofline_peak()
        if trace:
            from smartcal_tpu_torch.utils.metrics import start_trace
            self._profiler = start_trace(trace)

    @property
    def collect_diag(self) -> bool:
        """Should the trainer's agents return update diagnostics?"""
        return self.diag

    @property
    def tripped(self) -> bool:
        return self.watchdog is not None and self.watchdog.tripped

    def span(self, name, **tags):
        return obs.span(name, **tags)

    def record_diag(self, diag, **tags) -> bool:
        """Feed one (possibly step-stacked) UpdateDiag, or a host dict, into
        the diag stream and the watchdog; the update index is the handle's
        running counter.  Returns True when the watchdog has tripped (the
        trainer leaves its loop).  ``diag=None`` reports the trip state."""
        if self.tripped:
            return True
        if diag is None or not self.diag:
            return self.tripped
        host = diag if isinstance(diag, dict) else obs.diag_to_host(diag)
        for stepd in obs.diag_steps(host):
            i = self._updates
            self._updates += 1
            # deterministic fault injection: identity unless a plan
            # targets exactly this update index
            stepd = rt_faults.mutate_diag(stepd, i)
            if self.runlog is not None and i % self.DIAG_LOG_EVERY == 0:
                self.runlog.log("diag", step=i, **stepd, **tags)
            if self.watchdog is not None \
                    and self.watchdog.observe(stepd, step=i, **tags):
                self.echo(f"watchdog tripped at update {i}: "
                          f"{self.watchdog.trip_reason} — halting run")
                return True
        return False

    def log_replay_health(self, buf, **tags) -> bool:
        """One ``replay_health`` event for ``buf`` (a device ring, flat or
        sharded); feeds the watchdog.  No-op unless diagnostics are on.
        Returns the trip state."""
        if not self.diag:
            return self.tripped
        from smartcal_tpu_torch.rl import replay as rp
        health = rp.backend_for(buf).replay_health(buf)
        if self.runlog is not None:
            self.runlog.log("replay_health", **health, **tags)
        if self.watchdog is not None \
                and self.watchdog.observe_replay(health, **tags):
            self.echo(f"watchdog tripped on replay health: "
                      f"{self.watchdog.trip_reason} — halting run")
        return self.tripped

    def episode(self, i, score, scores=None, echo=True, **fields):
        """One ``episode`` event and the classic stderr echo."""
        if self.runlog is not None:
            self.runlog.log("episode", episode=i, score=score, **fields)
            self._episodes += 1
            if self._episodes % self.MEM_EVERY == 0:
                obs.log_memory_gauges()
            if self.diag:
                # between episodes, outside every span: the counts the
                # in-span sites deferred
                costs.flush_pending()
        if echo and not self.quiet:
            if scores:
                tail = scores[-100:]
                avg = sum(float(s) for s in tail) / len(tail)
            else:
                avg = float(score)
            obs.echo(f"episode {i} score {float(score):.2f} "
                     f"average score {avg:.2f}", event=None)

    def echo(self, msg, **fields):
        obs.echo(msg, quiet=self.quiet, **fields)

    def close(self):
        if self._profiler is not None:
            from smartcal_tpu_torch.utils.metrics import stop_trace
            path = stop_trace(self._profiler, self._trace_dir,
                              f"{self.entry}_trace.json")
            self._profiler = None
            if self.runlog is not None:
                self.runlog.log("trace", path=path)
        if self.runlog is not None:
            obs.log_memory_gauges()
            # reset: a later run in the same process starts from zero
            obs.flush_counters(reset=True)
            if self.diag:
                costs.flush_pending()     # drain before the log closes
                costs.set_enabled(False)
                costs.reset_cache()       # a next run logs into its own
            self.runlog.log("run_end", episodes=self._episodes,
                            updates=self._updates,
                            watchdog_tripped=self.tripped,
                            wall_s=round(time.time() - self._t0, 3))
            obs.deactivate(self.runlog)
            self.runlog.close()
            self.runlog = None
        if self._undo_deterministic is not None:
            self._undo_deterministic()
            self._undo_deterministic = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def train_obs(entry, metrics=None, run_id=None, trace=None, quiet=False,
              diag=False, watchdog=False, **meta) -> TrainObs:
    return TrainObs(entry, metrics=metrics, run_id=run_id, trace=trace,
                    quiet=quiet, diag=diag, watchdog=watchdog, **meta)


def train_obs_from_args(args, entry, **meta) -> TrainObs:
    """The run handle of the ``add_obs_args`` flags (getattr-safe)."""
    return TrainObs(entry,
                    metrics=getattr(args, "metrics", None),
                    run_id=getattr(args, "run_id", None),
                    trace=getattr(args, "trace", None),
                    quiet=getattr(args, "quiet", False),
                    diag=getattr(args, "diag", False),
                    # --max-recoveries implies the watchdog
                    watchdog=(getattr(args, "watchdog", False)
                              or getattr(args, "max_recoveries", 0) > 0),
                    compile_cache=getattr(args, "compile_cache", None),
                    deterministic=getattr(args, "deterministic", False),
                    seed=getattr(args, "seed", None), **meta)


# salt of the recovery reseed (offset by the attempt, so successive
# recoveries explore differently)
RESEED_SALT = 0x5EED0


def generator_state(gen: torch.Generator) -> np.ndarray:
    """A ``torch.Generator``'s state as a host uint8 array (its
    ``get_state()`` is a CPU ``ByteTensor`` on every device)."""
    return gen.get_state().numpy().copy()


def set_generator_state(gen: torch.Generator, state, device_type=None):
    """Load a :func:`generator_state` into ``gen``.  A state saved from a
    generator of another device type (a card's checkpoint resumed on the
    CPU) cannot be loaded, and the two draw different streams anyway:
    ``gen`` is then seeded from the state's sha256 (first 63 bits), a fixed
    function of the checkpoint, and the run continues on its own stream."""
    state = np.array(state, np.uint8)
    if device_type is None or device_type == gen.device.type:
        gen.set_state(torch.from_numpy(state))
        return
    import hashlib
    digest = hashlib.sha256(state.tobytes()).digest()
    gen.manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    obs.echo(f"generator state saved on {device_type}, resumed on "
             f"{gen.device.type}: reseeded from its sha256")


def reseed_generator(gen: torch.Generator, attempt: int) -> None:
    """The recovery's exploration reseed: draw a fresh 62-bit seed from
    ``gen`` and reseed it with that draw XOR ``RESEED_SALT + attempt`` (the
    JAX package folds the same salt into its key)."""
    draw = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))
    gen.manual_seed(draw ^ (RESEED_SALT + int(attempt)))


class TrainRuntime:
    """Per-run fault-tolerance handle: the checkpoint cadence, the
    ``--resume`` restore and the watchdog's rollback-and-retry (built from
    the ``add_runtime_args`` flags).  With none set every method is a
    no-op or None."""

    DEFAULT_RECOVERY_CKPT_EVERY = 10

    def __init__(self, entry, ckpt_dir=None, ckpt_every=0, keep=3,
                 resume=False, max_recoveries=0, lr_shrink=0.5,
                 reseed=True, tob=None):
        from smartcal_tpu_torch.runtime import (Checkpointer,
                                                RecoveryManager,
                                                RecoveryPolicy)

        self.entry = entry
        self.tob = tob
        self.resume = bool(resume)
        if max_recoveries > 0 and ckpt_every <= 0:
            ckpt_every = self.DEFAULT_RECOVERY_CKPT_EVERY
            self._echo(f"--max-recoveries without --ckpt-every: "
                       f"checkpointing every {ckpt_every} episodes")
        enabled = bool(resume or ckpt_every or max_recoveries)
        self.ckpt = None
        if enabled:
            self.ckpt = Checkpointer(ckpt_dir or f"{entry}_ckpt",
                                     keep=keep, every=ckpt_every)
        self.recovery = RecoveryManager(
            RecoveryPolicy(max_recoveries=max_recoveries,
                           lr_shrink=lr_shrink, reseed=reseed), self.ckpt)

    @classmethod
    def from_args(cls, args, entry, tob=None) -> "TrainRuntime":
        return cls(entry,
                   ckpt_dir=getattr(args, "ckpt_dir", None),
                   ckpt_every=getattr(args, "ckpt_every", 0),
                   keep=getattr(args, "keep_ckpts", 3),
                   resume=getattr(args, "resume", False),
                   max_recoveries=getattr(args, "max_recoveries", 0),
                   lr_shrink=getattr(args, "recovery_lr_shrink", 0.5),
                   reseed=getattr(args, "recovery_reseed", True), tob=tob)

    @property
    def enabled(self) -> bool:
        return self.ckpt is not None

    def _echo(self, msg):
        if self.tob is not None:
            self.tob.echo(msg)
        else:
            obs.echo(msg)

    def restore(self):
        """The ``--resume`` payload (newest valid checkpoint), or None."""
        if self.ckpt is None or not self.resume:
            return None
        loaded = self.ckpt.load_latest()
        if loaded is None:
            self._echo(f"--resume: no valid checkpoint under "
                       f"{self.ckpt.root!r}; starting fresh")
            return None
        payload, step = loaded
        rl = obs.active()
        if rl is not None:
            rl.log("resume", step=step, root=self.ckpt.root)
        self._echo(f"resumed from checkpoint step {step} "
                   f"({self.ckpt.root})")
        return payload

    def maybe_checkpoint(self, step, build_payload) -> bool:
        """Save when the cadence says so; ``build_payload()`` (the host
        payload dict) runs only then."""
        if self.ckpt is None or not self.ckpt.due(step):
            return False
        with obs.span("checkpoint", step=step):
            self.ckpt.save(step, build_payload())
        return True

    def on_trip(self):
        """Watchdog-trip escalation: a RecoveryAction to apply, or None
        (graceful halt).  Un-latches the watchdog when a rollback is
        granted."""
        reason = None
        if self.tob is not None and self.tob.watchdog is not None:
            reason = self.tob.watchdog.trip_reason
        act = self.recovery.on_trip(reason=reason)
        if act is None:
            return None
        if self.tob is not None and self.tob.watchdog is not None:
            self.tob.watchdog.reset()
        self._echo(f"watchdog recovery {act.attempt}/"
                   f"{self.recovery.policy.max_recoveries}: rolled back to "
                   f"episode {act.step} (lr x{act.lr_scale:g}, "
                   f"reseed={act.reseed})")
        return act


def scaled_config(cfg, lr_scale):
    """``cfg`` with both learning rates times ``lr_scale``."""
    if lr_scale == 1.0:
        return cfg
    return dataclasses.replace(cfg, lr_a=cfg.lr_a * lr_scale,
                               lr_c=cfg.lr_c * lr_scale)


def fused_payload(entry, seed, episode, scores, agent_state, buf, generator,
                  **extra) -> dict:
    """The elastic-net trainers' checkpoint payload: agent state (host
    arrays), the ring's filled prefix, the one generator of the run's
    draws, scores and the episode counter."""
    from smartcal_tpu_torch.runtime import pack_replay

    return {"kind": "enet_fused", "entry": entry, "seed": seed,
            "episode": int(episode), "scores": list(scores),
            "agent_state": agent_state.to_host(),
            "replay": pack_replay(buf),
            "generator": generator_state(generator),
            "generator_device": generator.device.type, **extra}


def restore_fused(payload, state_cls, cfg, generator, device):
    """(agent state, ring, scores, episode) of a :func:`fused_payload`; the
    generator's state is set in place."""
    from smartcal_tpu_torch.runtime import unpack_replay

    agent_state = state_cls.from_host(cfg, payload["agent_state"], device)
    buf = unpack_replay(payload["replay"], device)
    set_generator_state(generator, payload["generator"],
                        payload.get("generator_device"))
    return agent_state, buf, list(payload["scores"]), int(payload["episode"])


def rollback_fused(act, state_cls, cfg, generator, device, rebuild=None):
    """Restore an elastic-net trainer's checkpoint and apply the recovery
    mitigation, shared by the enet SAC/TD3/DDPG trainers: the reseed
    (:func:`reseed_generator`) and, through ``rebuild(lr_scale)``, the
    LR shrink.  Returns ``(agent_state, buf, scores, episode)``."""
    out = restore_fused(act.payload, state_cls, cfg, generator, device)
    if act.reseed:
        reseed_generator(generator, act.attempt)
    if act.lr_scale != 1.0 and rebuild is not None:
        rebuild(act.lr_scale)
    return out


# ---------------------------------------------------------------------------
# Checkpoint payloads of the host-driven agent loops (SACAgent / TD3Agent /
# DDPGAgent trainers: calib_*, demix_*)
# ---------------------------------------------------------------------------

def pack_agent_loop(agent, env, scores, episode, extra=None) -> dict:
    """Host payload of everything a host-driven agent loop needs to restart
    bit-continuably: the agent state (networks, targets, Adam states,
    alpha/rho, counters, DDPG's OU noise), the agent's generator state,
    the ring (filled prefix, PER priorities, ``cntr``, ``beta``; a native
    ring's whole state), the native sampler's numpy generator state
    (``agent_sample_rng``, JAX train/blocks.py:464), the env's episode RNG
    state (the single key chain of a sequential env, the per-lane keys and
    counters of a batched one), scores and the episode counter."""
    from smartcal_tpu_torch.runtime import pack_env_state, pack_replay

    payload = {
        "kind": "agent_loop",
        "episode": int(episode),
        "scores": list(scores),
        "agent_state": agent.state.to_host(),
        "agent_generator": generator_state(agent.generator),
        "generator_device": agent.generator.device.type,
        "replay": pack_replay(agent.buffer),
    }
    if getattr(agent, "_rng", None) is not None:
        payload["agent_sample_rng"] = agent._rng.bit_generator.state
    if env is not None:
        env_state = pack_env_state(env)
        if env_state is not None:
            payload["env_state"] = env_state
    if extra:
        payload["extra"] = dict(extra)
    return payload


def restore_agent_loop(agent, env, payload):
    """Inverse of :func:`pack_agent_loop`: load the payload into ``agent``
    and ``env`` in place (on the agent's device); returns (scores, episode,
    extra)."""
    from smartcal_tpu_torch.runtime import restore_env_state, unpack_replay

    agent.state = type(agent.state).from_host(agent.cfg,
                                              payload["agent_state"],
                                              agent.device)
    set_generator_state(agent.generator, payload["agent_generator"],
                        payload.get("generator_device"))
    agent.buffer = unpack_replay(payload["replay"], agent.device)
    if "agent_sample_rng" in payload \
            and getattr(agent, "_rng", None) is not None:
        agent._rng.bit_generator.state = payload["agent_sample_rng"]
    if env is not None and "env_state" in payload:
        restore_env_state(env, payload["env_state"])
    return list(payload["scores"]), int(payload["episode"]), \
        payload.get("extra") or {}


def apply_agent_recovery(agent, base_cfg, act):
    """Apply a RecoveryAction's mitigation to an agent: the reseed of its
    generator, and the LR shrink as the CUMULATIVE scale on ``base_cfg``
    (the trainer's original config).  The port's learn steps read the
    rates from ``agent.cfg``, so nothing is rebuilt.  Returns the agent."""
    if act.reseed:
        reseed_generator(agent.generator, act.attempt)
    if act.lr_scale != 1.0:
        agent.cfg = scaled_config(base_cfg, act.lr_scale)
    return agent


def run_batched_agent_loop(env, agent, agent_cfg, args, tob, rt,
                           scale_reward, use_hint=False, warmup=0,
                           warmup_rng=None, episodes=None, to_flat=None,
                           scores=None):
    """Vector-episode loop of the batched radio envs: each vector episode
    resets all E lanes; each vector step advances them in one batched
    pass, stores the E transitions and runs ONE learn (the 1:E
    learn:env-step regime).  The first ``warmup`` vector episodes act
    randomly through ``warmup_rng`` (the demixing trainers' warm-up).
    ``episodes`` defaults to ``args.episodes`` (``args.iteration`` for the
    demixing trainers), ``to_flat`` to ``flatten_obs_batch``; ``scores`` (a
    ``--load``ed history) is extended.  ``scores`` keeps the sequential
    trainers' format: E per-lane mean-step-reward entries per vector
    episode, ceil(episodes / E) vector episodes.  Checkpoint, resume and
    the watchdog's rollback ride :class:`TrainRuntime`; the payload holds
    the per-lane keys and counters and the warm-up generator's state, so
    ``--resume`` continues bit for bit."""
    from smartcal_tpu_torch.rl.networks import flatten_obs_batch
    from smartcal_tpu_torch.runtime.atomic import atomic_pickle

    if to_flat is None:
        to_flat = flatten_obs_batch
    if episodes is None:
        episodes = getattr(args, "episodes", None)
        if episodes is None:
            episodes = args.iteration
    E = env.n_envs
    n_vec = -(-episodes // E)
    scores = list(scores) if scores else []
    i = 0
    restored = rt.restore()
    if restored is not None:
        scores, i, extra = restore_agent_loop(agent, env, restored)
        if warmup_rng is not None and "np_rng" in extra:
            warmup_rng.bit_generator.state = extra["np_rng"]

    def ckpt_payload():
        # the warm-up generator rides along: a resume inside the warm-up
        # must replay the same random actions
        extra = ({"np_rng": warmup_rng.bit_generator.state}
                 if warmup_rng is not None else None)
        return pack_agent_loop(agent, env, scores, i, extra=extra)

    try:
        while i < n_vec:
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
            if tob.tripped:
                act = rt.on_trip()
                if act is not None:
                    scores, i, _ = restore_agent_loop(agent, env,
                                                      act.payload)
                    agent = apply_agent_recovery(agent, agent_cfg, act)
                    continue
            per_lane = score / max(loop, 1)
            scores.extend(float(s) for s in per_lane)
            tob.log_replay_health(agent.buffer, episode=i)
            tob.episode(i, float(per_lane.mean()), scores,
                        seed=getattr(args, "seed", None), lanes=E)
            agent.save_models()
            atomic_pickle(scores, f"{args.prefix}_scores.pkl")
            if tob.tripped:
                break
            i += 1
            rt.maybe_checkpoint(i, ckpt_payload)
    finally:
        tob.close()
    return scores


# ---------------------------------------------------------------------------
# The episode programs (the JAX trainers' jitted episode and its block scan)
# ---------------------------------------------------------------------------

class CarriedCounters:
    """The host counters of an agent state and its ring (the state's
    ``INTS``, its Adam counts, the ring's ``cntr`` and ``beta``) as 0-d
    device tensors, the form the JAX state carries and a program needs: a
    CUDA graph bakes host numbers in at capture.  :meth:`carry` fills the
    tensors from the host values and puts them in their place;
    :meth:`release` puts host values back from one read-back of
    :meth:`exported`."""

    def __init__(self, st, buf):
        self.slots = ([(st, k) for k in st.INTS]
                      + [(getattr(st, k), "count") for k in st.OPTS]
                      + [(buf, "cntr"), (buf, "beta")])
        self.tensors = [torch.zeros((), device=buf.device,
                                    dtype=torch.float32 if a == "beta"
                                    else torch.int64)
                        for _, a in self.slots]

    def host_values(self) -> list:
        return [getattr(o, a) for o, a in self.slots]

    def carry(self) -> None:
        for (o, a), t in zip(self.slots, self.tensors):
            v = getattr(o, a)
            if not torch.is_tensor(v):
                t.fill_(float(v) if a == "beta" else int(v))
            setattr(o, a, t)

    def exported(self):
        """The counters as one (n,) float64 tensor (exact for the int64
        counts up to 2^53 and for float32 beta)."""
        return torch.stack([t.to(torch.float64) for t in self.tensors])

    def release(self, values) -> None:
        for (o, a), v in zip(self.slots, list(values)):
            setattr(o, a, np.float32(v) if a == "beta" else int(v))


def clone_ring(buf):
    """An independent copy of a flat ring (host counters)."""
    from smartcal_tpu_torch.rl import replay as rp
    return rp.ReplayState({k: v.clone() for k, v in buf.data.items()},
                          buf.priority.clone(), buf.cntr, buf.beta)


class EpisodeProgram:
    """``block`` episodes of ``body(agent_state, buf, draws) -> score``
    (or ``(score, diag)``) as one program, the JAX package's jitted
    episode (block 1) and its ``lax.scan`` of episodes.  A call updates
    the state, the ring and the draws' generator in place and returns the
    (block,) scores (with a diag body, also the per-episode diags).

    On CUDA the first call warms the body up on a side stream, on copies
    of the state, the ring and the generator (the real chain does not
    move), then captures the ``block`` episodes into one
    ``torch.cuda.CUDAGraph`` under ``cal/solver._CAPTURE_LOCK``, the
    generator registered with it, the counters carried as device tensors
    (:class:`CarriedCounters`) and every update written in place; each
    call is then one replay and one read-back of the counters.  A call
    with another state, ring or generator object captures again (an LR
    change builds new programs, as the JAX trainer re-jits), and a restore
    that copies into the captured tensors (:func:`load_into`) does not.
    A capture launches nothing, so the kernel wrappers' host ``launches``
    skip it; kernels that count their own runs on the card
    (``device_launches``) count each replay's.

    On the CPU the body runs ``block`` times eagerly on the host
    counters, the eager trainers' route (a gate that is off skips its
    work); on CUDA while ``obs.costs`` counts (a replay is no op it can
    see), eagerly on the device-form counters the graph would carry."""

    def __init__(self, body, block: int, name: str = "episode_program"):
        self.body, self.block, self.name = body, int(block), name
        self.graph = None
        self.capture_seconds = None
        self.replays = 0

    def _stack(self, outs):
        if isinstance(outs[0], tuple):
            return torch.stack([o[0] for o in outs]), [o[1] for o in outs]
        return torch.stack(outs)

    def _eager(self, st, buf, draws, episodes=None):
        def run():
            return self._stack([self.body(st, buf, draws)
                                for _ in range(episodes or self.block)])
        if buf.device.type != "cuda":
            return run()
        counters = CarriedCounters(st, buf)
        counters.carry()
        try:
            return run()
        finally:
            counters.release(counters.exported().cpu().tolist())

    def _capture(self, st, buf, draws):
        from smartcal_tpu_torch.cal.solver import _CAPTURE_LOCK
        dev = buf.device
        gen = draws.generator
        t0 = time.perf_counter()
        with _CAPTURE_LOCK:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                g_w = torch.Generator(device=dev)
                g_w.set_state(gen.get_state())
                st_w, buf_w = st.copy_to(dev), clone_ring(buf)
                self._eager(st_w, buf_w, type(draws)(g_w, dev), 1)
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            del st_w, buf_w, g_w
            counters = CarriedCounters(st, buf)
            host = counters.host_values()
            counters.carry()
            graph = torch.cuda.CUDAGraph()
            if not hasattr(graph, "register_generator_state"):
                raise RuntimeError(
                    "this torch cannot capture the draws of a generator of "
                    "the program's own (no CUDAGraph.register_generator_"
                    "state)")
            graph.register_generator_state(gen)
            try:
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = self._stack([self.body(st, buf, draws)
                                       for _ in range(self.block)])
                    export = counters.exported()
            finally:
                counters.release(host)
        self.graph, self.out, self.export = graph, out, export
        self.counters = counters
        self.bound = (st, buf, gen)
        self.capture_seconds = time.perf_counter() - t0
        obs.record_compile(f"cuda_graph:{self.name}", self.capture_seconds,
                           block=self.block)

    def __call__(self, st, buf, draws):
        if buf.device.type != "cuda" or costs.counting():
            return self._eager(st, buf, draws)
        if self.graph is None or any(
                a is not b for a, b in zip(self.bound,
                                           (st, buf, draws.generator))):
            self._capture(st, buf, draws)
        self.counters.carry()
        self.graph.replay()
        self.counters.release(self.export.cpu().tolist())
        self.replays += 1
        if isinstance(self.out, tuple):
            scores, diags = self.out
            return scores.clone(), [type(d)(*(f.clone() for f in d))
                                    for d in diags]
        return self.out.clone()


def make_block_fn(episode_body, block: int, name: str = "episode_block"):
    """The program of ``block`` successive episodes of ``episode_body(
    agent_state, buf, draws) -> score`` (:class:`EpisodeProgram`): a call
    ``run_block(agent_state, buf, draws)`` plays them in place, one CUDA
    graph replay on the card, and returns the (block,) scores.  The same
    learning dynamics as ``block`` calls of the episode program: agent
    state, ring and generator chain from episode to episode (the JAX
    package's ``make_block_fn``, whose scan carries the key)."""
    return EpisodeProgram(episode_body, block, name)


def load_into(dst, src) -> None:
    """Copy agent state ``src`` into ``dst`` in place (modules through
    ``load_state_dict``, Adam moments and tensors with ``copy_``, counts
    and counters as host values), so a program captured on ``dst`` replays
    the restored state."""
    with torch.no_grad():
        for k in dst.NETS:
            getattr(dst, k).load_state_dict(getattr(src, k).state_dict())
        for k in dst.OPTS:
            d, s = getattr(dst, k), getattr(src, k)
            for n in d.mu:
                d.mu[n].copy_(s.mu[n])
                d.nu[n].copy_(s.nu[n])
            d.count = int(s.count)
        for k in dst.TENSORS:
            getattr(dst, k).copy_(getattr(src, k))
        for k in dst.INTS:
            setattr(dst, k, int(getattr(src, k)))


def load_ring_into(dst, src) -> None:
    """Copy flat ring ``src`` into ``dst`` in place (same size)."""
    if dst.size != src.size:
        raise ValueError(f"ring of {src.size} slots into one of {dst.size}")
    with torch.no_grad():
        for k, v in dst.data.items():
            v.copy_(src.data[k])
        dst.priority.copy_(src.priority)
    dst.cntr, dst.beta = int(src.cntr), np.float32(src.beta)
