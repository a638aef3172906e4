"""Close the loop: learn from served traffic with policy hot-swaps that
drop nothing, and measure it (the port's counterpart of the JAX package's
tools/serve_learn.py, same flags and record, plus ``--device``).

One invocation is one online lifecycle: warm up the ``CalibServer`` with
its policy program armed and every completed request teed into the sharded
versioned replay, drive a sustained open-loop offered rate, and run the SAC
learner beside the server: drain the tee, learn with IMPACT
staleness-clipped IS weighting + ERE, and publish each new snapshot through
the program cache as an atomic hot-swap (``serve/lifecycle``).  A held-out
scenario stream is re-scored periodically through the policy path.

    python -m smartcal_tpu_torch.tools.serve_learn --tier tiny --M 3 \\
        --lanes 4 --rate 3 --duration 60 --cache-dir /tmp/lifecycle_cache \\
        --metrics /tmp/lifecycle.jsonl --device cpu --out /tmp/life.json

The gates the record encodes: >= 3 hot-swaps inside the serving window,
zero compile events in it (the policy program takes the weights as an
operand: a publication re-persists and runs one forward, it never exports,
builds or captures), zero sheds attributable to publication, and the
windowed serving p99 flat across every swap.  Compile events are counted
while a run log records (``--metrics``, default
``<cache-dir>/serve_learn_run.jsonl``).
"""

import argparse
import json
import os
import sys
import threading
import time

import numpy as np

from smartcal_tpu_torch import obs
from smartcal_tpu_torch.obs import tracectx
from smartcal_tpu_torch.serve.loadgen import SERVE_TIERS as TIERS
from smartcal_tpu_torch.train import blocks


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m smartcal_tpu_torch.tools.serve_learn",
        description=__doc__.split("\n")[0])
    p.add_argument("--tier", choices=sorted(TIERS), default="tiny",
                   help="backend scale (tiny = the CPU test tier)")
    p.add_argument("--M", type=int, default=3,
                   help="max calibration directions (jobs carry k <= M)")
    p.add_argument("--lanes", type=int, default=4,
                   help="micro-batch width (BatchedEpisode lanes)")
    p.add_argument("--cache-dir", dest="cache_dir", required=True,
                   help="program cache and nvcc build directory root")
    p.add_argument("--rate", type=float, default=3.0,
                   help="sustained offered rate (jobs/s) for the window")
    p.add_argument("--duration", type=float, default=60.0,
                   help="seconds of the serving/learning window")
    p.add_argument("--pool", type=int, default=10,
                   help="pre-built obs-bearing episodes cycled by the "
                        "load generator (heterogeneous K/diffuse mix)")
    p.add_argument("--eval-pool", dest="eval_pool", type=int, default=6,
                   help="held-out scenarios re-scored through the policy "
                        "path each eval round")
    p.add_argument("--eval-every-s", dest="eval_every_s", type=float,
                   default=12.0, help="seconds between held-out evals")
    p.add_argument("--learn-steps", dest="learn_steps", type=int,
                   default=2, help="SAC learn steps per learner tick")
    p.add_argument("--max-wait-ms", dest="max_wait_ms", type=float,
                   default=50.0, help="micro-batch max wait")
    p.add_argument("--max-queue", dest="max_queue", type=int, default=64,
                   help="bounded admission queue depth (overload sheds)")
    p.add_argument("--swap-window-s", dest="swap_window_s", type=float,
                   default=5.0,
                   help="window either side of each swap for the "
                        "p99-flatness comparison")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu on request)")
    p.add_argument("--out", type=str, default=None,
                   help="write the lifecycle artifact JSON here")
    blocks.add_obs_args(p)
    blocks.add_lifecycle_args(p)
    return p.parse_args(argv)


class _LoadThread(threading.Thread):
    """Open-loop Poisson submitter over an obs-bearing pool, recording
    per-job completion wall times via done-callbacks: the raw series
    the swap-window p99 comparison needs (the shared ``OpenLoopLoadGen``
    only keeps the aggregate).  Half the jobs pin a log-uniform rho
    (the exploration stream the learner needs); half ride the policy."""

    def __init__(self, server, pool, rate, duration_s, seed=0):
        super().__init__(name="lifecycle-load", daemon=True)
        from smartcal_tpu_torch.serve.router import ShedError
        self._shed_error = ShedError
        self.server = server
        self.pool = pool
        self.rate = float(rate)
        self.duration_s = float(duration_s)
        self.seed = seed
        self._lock = threading.Lock()
        self.completions = []            # (t_done_monotonic, total_s)
        self.sheds = []                  # (t_monotonic, reason)
        self.submitted = 0
        self.failed = 0

    def _on_done(self, fut):
        try:
            r = fut.result()
        except self._shed_error as e:
            with self._lock:
                self.sheds.append((time.monotonic(), e.reason))
            return
        except Exception:
            with self._lock:
                self.failed += 1
            return
        with self._lock:
            self.completions.append((time.monotonic(), float(r.total_s)))

    def run(self):
        from smartcal_tpu_torch.serve.router import Job

        rng = np.random.default_rng(self.seed)
        t_end = time.monotonic() + self.duration_s
        next_t = time.monotonic()
        while True:
            next_t += rng.exponential(1.0 / self.rate)
            if next_t > t_end:
                return
            delay = next_t - time.monotonic()
            if delay > 0:
                time.sleep(delay)
            k, ep, ov = self.pool[int(rng.integers(len(self.pool)))]
            rho = None
            if rng.random() < 0.5:       # pinned-rho exploration stream
                rho = np.exp(rng.uniform(np.log(0.1), np.log(10.0),
                                         k)).astype(np.float32)
            job = Job(episode=ep, k=k, rho=rho, obs_vec=ov,
                      trace=tracectx.new_root_carrier())
            self.submitted += 1
            try:
                fut = self.server.submit(job)
            except self._shed_error as e:
                with self._lock:
                    self.sheds.append((time.monotonic(), e.reason))
                continue
            fut.add_done_callback(self._on_done)

    def snapshot(self):
        with self._lock:
            return (list(self.completions), list(self.sheds),
                    self.submitted, self.failed)


def run_eval(server, eval_pool, timeout_s=60.0):
    """Re-score the held-out pool through the policy path (rho=None)
    and return mean sigma_res; eval jobs ride the live server — the
    measurement itself is served traffic."""
    from smartcal_tpu_torch.serve.router import Job, ShedError

    futs = []
    for k, ep, ov in eval_pool:
        job = Job(episode=ep, k=k, rho=None, obs_vec=ov,
                  trace=tracectx.new_root_carrier())
        try:
            futs.append(server.submit(job))
        except ShedError:
            continue
    vals = []
    t0 = time.monotonic()
    for f in futs:
        left = timeout_s - (time.monotonic() - t0)
        try:
            vals.append(float(f.result(timeout=max(0.1, left)).sigma_res))
        except Exception:
            continue
    return (float(np.mean(vals)) if vals else float("nan")), len(vals)


def p99_windows(completions, swap_times, window_s):
    """Per-swap (pre_p99, post_p99) over ``window_s`` either side, from
    the (t_done, total_s) series.  A window with < 3 completions has no
    meaningful percentile and reports None."""
    out = []
    for t_swap in swap_times:
        pre = [s for t, s in completions if t_swap - window_s <= t < t_swap]
        post = [s for t, s in completions if t_swap <= t < t_swap + window_s]
        out.append({
            "pre_p99_s": (round(float(np.percentile(pre, 99)), 4)
                          if len(pre) >= 3 else None),
            "post_p99_s": (round(float(np.percentile(post, 99)), 4)
                           if len(post) >= 3 else None),
            "pre_n": len(pre), "post_n": len(post),
        })
    return out


def trace_continuity(metrics_path, t_wall_start):
    """Scan the run's JSONL for serve_request events inside the serving
    window: every one must carry its trace id (the request's span tree
    survives hot-swaps).  Returns (n_events, n_missing_trace) or None
    when no stream was recorded."""
    if not metrics_path or not os.path.exists(metrics_path):
        return None
    n = missing = 0
    try:
        with open(metrics_path) as fh:
            for line in fh:
                try:
                    ev = json.loads(line)
                except ValueError:
                    continue
                if ev.get("event") != "serve_request":
                    continue
                if float(ev.get("t", 0.0)) < t_wall_start:
                    continue
                n += 1
                if not ev.get("trace"):
                    missing += 1
    except OSError:
        return None
    return {"serve_requests": n, "missing_trace": missing,
            "continuous": missing == 0}


def main(argv=None):
    args = parse_args(argv)
    from smartcal_tpu_torch.envs import radio
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.serve import (CalibServer, PolicyPublisher,
                                          ServingLearner, TransitionStage,
                                          build_obs_pool,
                                          enable_compile_cache)

    if args.metrics is None and args.trace is None:
        args.metrics = os.path.join(args.cache_dir, "serve_learn_run.jsonl")
    os.makedirs(args.cache_dir, exist_ok=True)
    tobs = blocks.train_obs_from_args(args, "serve_learn",
                                      tier=args.tier, lanes=args.lanes)
    t_boot = time.time()
    # the nvcc build directory under the cache root before any kernel
    # loads
    enable_compile_cache(os.path.join(args.cache_dir, "nvcc"))
    backend = radio.RadioBackend(device=args.device, **TIERS[args.tier])
    obs_dim = backend.npix * backend.npix + (args.M + 1) * 7
    cfg = sac.SACConfig(obs_dim=obs_dim, n_actions=2 * args.M,
                        mem_size=args.mem_size,
                        batch_size=args.batch_size,
                        is_clip=args.is_clip, ere_eta=args.ere_eta)
    learner = ServingLearner(cfg, seed=args.seed,
                             n_shards=args.replay_shards,
                             publish_every=args.publish_every,
                             device=backend.device)
    stage = TransitionStage(cap=args.stage_cap)
    srv = CalibServer(backend, M=args.M, lanes=args.lanes,
                      cache_dir=args.cache_dir,
                      policy=(cfg, learner.actor_params),
                      transition_sink=stage,
                      max_wait_s=args.max_wait_ms / 1e3,
                      max_queue=args.max_queue)
    warm = srv.warmup(seed=args.seed)
    learner.publisher = PolicyPublisher(srv,
                                        keep_versions=args.keep_versions)
    learner.warm()                       # learn and publish paths, once
    boot_s = round(time.time() - t_boot, 3)
    tobs.echo(f"server+learner up in {boot_s}s (warmup {warm['wall_s']}s,"
              f" programs {warm['sources']})")

    pool = build_obs_pool(backend, args.M, args.pool, seed=args.seed + 1)
    eval_pool = build_obs_pool(backend, args.M, args.eval_pool,
                               seed=args.seed + 101)
    srv.start()
    c0 = obs.counters_snapshot()         # the zero-compile window opens
    t_wall_start = time.time()
    t_start = time.monotonic()
    load = _LoadThread(srv, pool, rate=args.rate,
                       duration_s=args.duration, seed=args.seed)
    load.start()

    swaps = []                           # (t_monotonic, publish record)
    sigma_track = []                     # held-out trajectory
    next_eval = t_start                  # first eval scores version 0
    last_gauge = 0.0
    while load.is_alive() or srv.batcher.depth() > 0:
        tick_end = time.monotonic() + args.learn_every_s
        learner.ingest(stage.drain())
        for _ in range(args.learn_steps):
            learner.step()
        pub = learner.maybe_publish()
        if pub is not None:
            swaps.append((time.monotonic(), pub))
            tobs.echo(f"hot-swap -> v{pub['version']} "
                      f"(publish {pub['publish_s']*1e3:.1f} ms)")
        now = time.monotonic()
        if now - last_gauge >= 2.0:
            last_gauge = now
            st = learner.staleness()
            obs.gauge_set("replay_staleness_mean", st["staleness_mean"])
            obs.gauge_set("replay_stale_frac", st["stale_frac"])
            m = learner.step(pull_metrics=True)
            for key in ("staleness_mean", "is_clip_mean",
                        "is_clip_saturation"):
                if key in (m or {}):
                    obs.gauge_set(f"learn_{key}", m[key])
        if now >= next_eval:
            next_eval += args.eval_every_s
            ver = srv.policy_version
            sig, n_ok = run_eval(srv, eval_pool)
            sigma_track.append({"t_s": round(now - t_start, 2),
                                "version": ver,
                                "sigma_res_mean": round(sig, 4),
                                "n": n_ok})
            tobs.echo(f"eval @v{ver}: sigma_res {sig:.3f} ({n_ok} jobs)")
        time.sleep(max(0.0, tick_end - time.monotonic()))
        if not load.is_alive() and srv.batcher.depth() == 0:
            break
    # final held-out eval at the last published version
    ver = srv.policy_version
    sig, n_ok = run_eval(srv, eval_pool)
    sigma_track.append({"t_s": round(time.monotonic() - t_start, 2),
                        "version": ver, "sigma_res_mean": round(sig, 4),
                        "n": n_ok})
    learner.ingest(stage.drain())
    c1 = obs.counters_snapshot()
    srv.stop()

    completions, sheds, submitted, failed = load.snapshot()
    swap_times = [t for t, _ in swaps]
    pubs = [p for _, p in swaps]
    publish_ms = sorted(p["publish_s"] * 1e3 for p in pubs)
    windows = p99_windows(completions, swap_times, args.swap_window_s)
    # a swap is p99-flat when the post window is within 1.5x + 100 ms of
    # the pre window (the claim is "no publication spike", not "zero
    # jitter")
    flat = all(w["pre_p99_s"] is None or w["post_p99_s"] is None
               or w["post_p99_s"] <= 1.5 * w["pre_p99_s"] + 0.1
               for w in windows)
    pub_sheds = [t for t, _ in sheds
                 if any(abs(t - ts) <= 1.0 for ts in swap_times)]
    steady_compiles = (c1.get("compile_events", 0.0)
                       - c0.get("compile_events", 0.0))
    lat = np.asarray([s for _, s in completions]) if completions else None
    first = next((s for s in sigma_track
                  if np.isfinite(s["sigma_res_mean"])), None)
    last = next((s for s in reversed(sigma_track)
                 if np.isfinite(s["sigma_res_mean"])), None)
    improvement = (round(1.0 - last["sigma_res_mean"]
                         / first["sigma_res_mean"], 4)
                   if first and last and first is not last
                   and first["sigma_res_mean"] > 0 else None)
    record = {
        "bench": "serve_learn",
        "tier": args.tier, "M": args.M, "lanes": args.lanes,
        "device": str(backend.device),
        "rate": args.rate, "duration_s": args.duration,
        "is_clip": args.is_clip, "ere_eta": args.ere_eta,
        "publish_every": args.publish_every,
        "boot_s": boot_s, "warmup": warm,
        "serving": {
            "submitted": submitted, "completed": len(completions),
            "shed": len(sheds), "failed": failed,
            "latency_p50_s": (round(float(np.percentile(lat, 50)), 4)
                              if lat is not None else None),
            "latency_p99_s": (round(float(np.percentile(lat, 99)), 4)
                              if lat is not None else None),
            "steady_compile_events": steady_compiles,
            "stats": srv.stats(),
        },
        "lifecycle": {
            "swaps": len(swaps),
            "publish_ms_p50": (round(float(np.percentile(publish_ms, 50)),
                                     2) if publish_ms else None),
            "publish_ms_p99": (round(float(np.percentile(publish_ms, 99)),
                                     2) if publish_ms else None),
            "publish_ms": [round(m, 2) for m in publish_ms],
            "publication_sheds": len(pub_sheds),
            "swap_p99_windows": windows,
            "p99_flat_across_swaps": flat,
            "teed": stage.stats(),
            "learner": {"learns": learner.learns,
                        "ingested": learner.ingested,
                        "version": learner.version,
                        "staleness": learner.staleness(),
                        "metrics": learner.last_metrics},
            "sigma_res_trajectory": sigma_track,
            "sigma_res_improvement": improvement,
            "trace_continuity": trace_continuity(args.metrics,
                                                 t_wall_start),
        },
        "wall_s": round(time.time() - t_boot, 3),
    }
    obs.flush_counters()
    tobs.close()
    print(json.dumps(record, indent=1))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        tmp = args.out + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(record, fh, indent=1)
        os.replace(tmp, args.out)
    if steady_compiles:
        print(f"WARNING: {steady_compiles:.0f} compile events in the "
              "serving window (expected 0)", file=sys.stderr)
    return record


if __name__ == "__main__":
    main()
