"""Serve calibration from a replicated fleet: sweep replica topologies
behind the deadline-aware FleetRouter front door and record the
scaling / kill-and-recover / autoscale artifact (the port's counterpart of
the JAX package's tools/serve_fleet.py, same flags and record, plus
``--device``: every replica process serves on that device, the card by
default).

One invocation runs up to three measurements against ONE shared
on-disk cache (replica 0 of the first topology builds it cold; every
later replica — and every later topology — warm-starts off it):

* ``--replicas 1,2,4``  — the SCALING sweep: per topology, offered
  load of ``--rate-per-replica * n`` for ``--duration`` seconds, with
  per-replica compile-event gauges sampled before and after the load
  so the zero-steady-state-compile claim is asserted FLEET-wide (every
  replica process, not just the parent).  ``N@H`` points are accepted and
  recorded, but the port runs on one machine: every replica is on host 0.
* ``--kill``            — 2 replicas under load, one SIGKILLed mid-run:
  the run must complete every admitted job (survivor requeue), shed
  nothing, and respawn the slot; time-to-recover is measured.
* ``--autoscale``       — 1 replica + AutoscalePolicy under a rate
  step: the router must scale up under sustained backlog and reap back
  to the floor when the load drains.
* ``--slowdown``        — the SLO burn-rate demonstration: 2 replicas
  under load, one replica's solve stage stalled mid-run by a
  deterministic fault plan (``runtime/faults`` delay); the fleet's
  SloBurnDetector must FIRE while the stall holds p99 over target,
  LOCALIZE the slow replica (worst per-replica p99), and CLEAR after
  recovery.  The run fails soft (recorded, not raised) so the artifact
  always lands.

``--trace-dir DIR`` gives every measurement its own per-process stream
directory (``DIR/<phase>/``: the router's stream plus one stream per
replica generation, clock-offset handshakes included).  Each phase
record then carries a ``trace`` digest — merged-event counts, per-peer
clock offsets, and the cross-process trace completeness score
(``obs/collect``).

``--stub`` swaps the CalibServer factory for the stdlib SleepServer
(see :class:`smartcal_tpu_torch.serve.fleet.SleepServer`): sleeps overlap
across processes even on a one-core host, so the stub sweep is the
ROUTER-CAPACITY ceiling the real fleet is compared against — on a
many-core host the real curve approaches it; on a starved one the gap
is the host, not the front door (``host_cores`` is recorded).

    python -m smartcal_tpu_torch.tools.serve_fleet --tier tiny --M 3 \\
        --lanes 3 --replicas 1,2 --kill --cache-dir /tmp/fleet_cache \\
        --metrics /tmp/fleet.jsonl --device cpu --out /tmp/fleet.json

Fleet telemetry rides the parent RunLog (``--metrics``): fleet_dispatch
/ fleet_result events, fleet-scoped sheds, scale and replica-lifecycle
events, fleet gauges.
"""

import argparse
import contextlib
import json
import os
import sys
import threading
import time

from smartcal_tpu_torch import obs
from smartcal_tpu_torch.runtime.backoff import BackoffPolicy
from smartcal_tpu_torch.serve.fleet import (
    AutoscalePolicy, FleetRouter, calib_worker_spec, sleep_worker_spec)
from smartcal_tpu_torch.serve.loadgen import SERVE_TIERS as TIERS
from smartcal_tpu_torch.train import blocks


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m smartcal_tpu_torch.tools.serve_fleet",
        description=__doc__.split("\n")[0])
    p.add_argument("--tier", choices=sorted(TIERS), default="tiny")
    p.add_argument("--M", type=int, default=3)
    p.add_argument("--lanes", type=int, default=3)
    p.add_argument("--cache-dir", dest="cache_dir", required=True,
                   help="SHARED program cache + nvcc build root (all "
                        "replicas, all topologies)")
    p.add_argument("--replicas", type=str, default="1,2,4",
                   help="comma list of topology points; 'N@H' spreads "
                        "N replicas over H simulated hosts (e.g. "
                        "1,2,4,4@2); empty string skips the sweep")
    p.add_argument("--rate-per-replica", dest="rate_per_replica",
                   type=float, default=6.0,
                   help="offered jobs/s PER REPLICA at each point")
    p.add_argument("--duration", type=float, default=10.0,
                   help="seconds of offered load per topology point")
    p.add_argument("--pool", type=int, default=8)
    p.add_argument("--pool-mode", dest="pool_mode",
                   choices=("mixed", "uniform"), default="mixed")
    p.add_argument("--deadline-ms", dest="deadline_ms", type=float,
                   default=None)
    p.add_argument("--kill", action="store_true",
                   help="run the kill-and-recover measurement")
    p.add_argument("--autoscale", action="store_true",
                   help="run the rate-step autoscale measurement")
    p.add_argument("--slowdown", action="store_true",
                   help="run the injected-slowdown SLO burn-rate "
                        "demonstration (stub fleets only: the fault "
                        "stalls the stub's solve stage)")
    p.add_argument("--trace-dir", dest="trace_dir", default=None,
                   help="root for per-phase per-process trace streams "
                        "(<dir>/<phase>/{router,replicaN-gK}.jsonl); "
                        "enables the merged-timeline trace digest per "
                        "measurement")
    p.add_argument("--slo-p99-ms", dest="slo_p99_ms", type=float,
                   default=None,
                   help="p99 target for the fleet SLO burn-rate "
                        "detector (default: detector off except in "
                        "--slowdown, which derives one from the stub "
                        "service time)")
    p.add_argument("--stub", action="store_true",
                   help="SleepServer replicas (router-capacity ceiling "
                        "instead of the real CalibServer fleet)")
    p.add_argument("--stub-service-ms", dest="stub_service_ms",
                   type=float, default=50.0)
    p.add_argument("--max-requeues", dest="max_requeues", type=int,
                   default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of every replica and of the pool "
                        "(default cuda; cpu on request)")
    p.add_argument("--out", type=str, default=None)
    blocks.add_obs_args(p)
    return p.parse_args(argv)


def _spec(args):
    if args.stub:
        return sleep_worker_spec(lanes=args.lanes,
                                 service_s=args.stub_service_ms / 1e3)
    return calib_worker_spec(TIERS[args.tier], M=args.M,
                             lanes=args.lanes, cache_dir=args.cache_dir,
                             device=args.device, max_wait_s=0.02,
                             max_queue=64)


def _pool(args, backend):
    from smartcal_tpu_torch.serve import loadgen

    if args.stub:
        # sleeps don't look at the episode: an empty payload keeps the
        # stub sweep measuring dispatch+IPC, not episode pickling
        return [(1 + i % args.M, None) for i in range(args.pool)]
    return loadgen.build_job_pool(backend, args.M, args.pool,
                                  seed=args.seed + 1,
                                  mixed=(args.pool_mode == "mixed"))


def _router(args, replicas, hosts=1, autoscale=None, metrics_dir=None,
            slo=None, spec=None):
    return FleetRouter(
        spec if spec is not None else _spec(args),
        replicas=replicas, hosts=hosts,
        heartbeat_timeout=30.0, max_restarts=3,
        backoff=BackoffPolicy(base_s=0.1, factor=2.0, max_s=2.0,
                              jitter=0.0),
        seed=args.seed, max_requeues=args.max_requeues,
        autoscale=autoscale, poll_s=0.05, metrics_dir=metrics_dir,
        slo=slo)


def _phase_dir(args, name):
    """Per-measurement stream directory under --trace-dir (or None)."""
    if not args.trace_dir:
        return None
    d = os.path.join(args.trace_dir, name)
    os.makedirs(d, exist_ok=True)
    return d


@contextlib.contextmanager
def _phase_obs(pdir):
    """Route the router-side stream into the phase directory: a fresh
    ``router.jsonl`` RunLog shadows the global one for the phase (stack
    discipline), so dispatch/result/clock_offset events land next to
    the replica streams they merge with."""
    if pdir is None:
        yield
        return
    with obs.recording(os.path.join(pdir, "router.jsonl"),
                       run_id="router"):
        yield


def _slo(args):
    if args.slo_p99_ms is None:
        return None
    return obs.SloBurnDetector(p99_target_s=args.slo_p99_ms / 1e3)


def _trace_digest(pdir):
    """Merge a phase's streams and score its trace reconstruction."""
    if pdir is None:
        return None
    from smartcal_tpu_torch.obs import collect

    merger = collect.TimelineMerger()
    merger.add_directory(pdir)
    events = merger.merge()
    comp = collect.completeness(collect.request_paths(events))
    return {"dir": pdir, **merger.stats(), "completeness": comp}


def _compile_gauges(router):
    """{rid: cumulative compile events in that replica process} from
    the latest beat each replica streamed."""
    per = router.stats()["per_replica"]
    return {rid: float(g.get("compile_events", 0.0))
            for rid, g in per.items()}


def _settle(router, beats=3, beat_s=0.1):
    time.sleep(beats * beat_s)           # let every replica beat again


def _run_load(args, router, pool, rate, duration):
    from smartcal_tpu_torch.serve import loadgen

    gen = loadgen.OpenLoopLoadGen(
        router, pool, rate=rate, duration_s=duration, seed=args.seed,
        deadline_s=(args.deadline_ms / 1e3 if args.deadline_ms
                    else None),
        pick=("cycle" if args.pool_mode == "uniform" else "random"))
    return gen.run()


def sweep_point(args, tobs, pool, replicas, hosts):
    pdir = _phase_dir(args, f"scale{replicas}x{hosts}")
    t0 = time.time()
    with _phase_obs(pdir):
        router = _router(args, replicas, hosts=hosts, metrics_dir=pdir,
                         slo=_slo(args))
        try:
            warm = router.start(warm_timeout_s=900.0)
            boot_s = round(time.time() - t0, 3)
            _settle(router)
            c0 = _compile_gauges(router)
            rate = args.rate_per_replica * replicas
            summary = _run_load(args, router, pool, rate, args.duration)
            _settle(router)
            c1 = _compile_gauges(router)
            steady = sum(c1.get(rid, 0.0) - c0.get(rid, 0.0)
                         for rid in c1)
            point = {
                "replicas": replicas, "hosts": hosts, "boot_s": boot_s,
                "warm_sources": {rid: sorted(set(w["sources"].values()))
                                 for rid, w in warm.items()},
                "offered_rate": rate,
                "summary": summary,
                "steady_compile_events_fleet": steady,
                "router_stats": {k: v for k, v in router.stats().items()
                                 if k != "per_replica"},
            }
        finally:
            router.stop(timeout=20.0)
    point["trace"] = _trace_digest(pdir)
    tobs.echo(f"replicas={replicas}x{hosts}h rate={rate}: "
              f"{summary.get('achieved_jobs_s')} jobs/s, "
              f"p99={summary.get('latency_p99_s')}s, "
              f"fleet steady compiles={steady:.0f}")
    return point


def kill_run(args, tobs, pool):
    pdir = _phase_dir(args, "kill")
    with _phase_obs(pdir):
        router = _router(args, 2, metrics_dir=pdir, slo=_slo(args))
        try:
            router.start(warm_timeout_s=900.0)
            rate = args.rate_per_replica * 2
            duration = max(6.0, args.duration)
            killed = {}

            def _chaos():
                time.sleep(duration / 3)
                t_kill = time.monotonic()
                router.kill_replica(0)
                deadline = t_kill + 60.0
                while (router.replicas_alive() < 2
                       or router.stats()["replica_restarts"] < 1):
                    if time.monotonic() > deadline:
                        return
                    time.sleep(0.02)
                killed["recover_s"] = round(time.monotonic() - t_kill, 3)

            chaos = threading.Thread(target=_chaos, daemon=True)
            chaos.start()
            summary = _run_load(args, router, pool, rate, duration)
            chaos.join(timeout=90.0)
            recover_s = killed.get("recover_s")
            st = router.stats()
        finally:
            router.stop(timeout=20.0)
    rec = {"summary": summary, "recover_s": recover_s,
           "replica_restarts": st["replica_restarts"],
           "requeued": st["requeued"],
           "shed_reasons": st["shed_reasons"],
           "replicas_alive_after": st["replicas_alive"]}
    if pdir is not None:
        # the SIGKILLed replica can't flush its own black box — the
        # router's parent-side frame ring must have dumped one
        try:
            rec["blackbox_files"] = sorted(
                n for n in os.listdir(pdir) if n.startswith("blackbox_"))
        except OSError:
            rec["blackbox_files"] = []
        rec["trace"] = _trace_digest(pdir)
    tobs.echo(f"kill: completed={summary['completed']}/"
              f"{summary['submitted']} shed={summary['shed']} "
              f"requeued={st['requeued']} recover={recover_s}s"
              + (f" blackboxes={len(rec['blackbox_files'])}"
                 if "blackbox_files" in rec else ""))
    return rec


def slowdown_run(args, tobs, pool):
    """Injected-slowdown SLO demonstration: 2 stub replicas, replica
    0's solve stalled for a span of consecutive batches mid-run by a
    deterministic runtime.faults delay plan.  The burn-rate detector
    must fire while the stall holds the fast-window p99 over target,
    name replica 0 as the worst per-replica p99 at fire time, and clear
    once the fleet recovers and the hot window drains."""
    pdir = _phase_dir(args, "slowdown")
    service_s = args.stub_service_ms / 1e3
    delay_s = max(4.0 * service_s, 0.25)
    spec = sleep_worker_spec(lanes=args.lanes, service_s=service_s)
    spec["per_replica"] = {0: {"faults": {
        "delay_stage": "serve_batch", "delay_at": 10,
        "delay_span": 12, "delay_s": delay_s}}}
    target_s = (args.slo_p99_ms / 1e3 if args.slo_p99_ms
                else 2.5 * service_s)
    slo = obs.SloBurnDetector(p99_target_s=target_s, fast_window_s=2.0,
                              slow_window_s=6.0, sustain_s=0.5,
                              clear_sustain_s=2.0, min_samples=5)
    with _phase_obs(pdir):
        router = _router(args, 2, metrics_dir=pdir, slo=slo, spec=spec)
        try:
            router.start(warm_timeout_s=900.0)
            rate = args.rate_per_replica * 2
            summary = _run_load(args, router, pool, rate,
                                max(10.0, args.duration))
            # recovery: the supervise thread keeps evaluating after the
            # load drains — wait for the detector to quiet down
            deadline = time.monotonic() + 30.0
            while time.monotonic() < deadline:
                snap = slo.snapshot()
                if snap["transitions"] >= 2 and not snap["firing"]:
                    break
                time.sleep(0.1)
            snap = slo.snapshot()
        finally:
            router.stop(timeout=20.0)
    rec = {"summary": summary, "p99_target_s": target_s,
           "delay_s": delay_s, "slow_replica": 0,
           "snapshot": snap}
    if pdir is not None:
        from smartcal_tpu_torch.obs import collect

        burns = [e for e in collect.merge_directory(pdir)
                 if e.get("event") == "slo_burn"]
        rec["transitions"] = [
            {k: e.get(k) for k in ("state", "burn_fast", "p99_fast_s",
                                   "worst_replica", "t_corr")}
            for e in burns]
        fired = [e for e in burns if e.get("state") == "firing"]
        rec["fired"] = bool(fired)
        rec["localized_replica"] = (fired[0].get("worst_replica")
                                    if fired else None)
        rec["cleared"] = any(e.get("state") == "cleared" for e in burns)
        rec["trace"] = _trace_digest(pdir)
    tobs.echo(f"slowdown: fired={rec.get('fired')} "
              f"localized={rec.get('localized_replica')} "
              f"cleared={rec.get('cleared')} "
              f"(target p99={target_s * 1e3:.0f}ms, "
              f"stall={delay_s * 1e3:.0f}ms x12 batches on replica 0)")
    return rec


def autoscale_run(args, tobs, pool):
    pol = AutoscalePolicy(min_replicas=1, max_replicas=4,
                          spawn_depth=1.5, spawn_sustain_s=1.0,
                          reap_idle_s=3.0, cooldown_s=2.0)
    pdir = _phase_dir(args, "autoscale")
    with _phase_obs(pdir):
        router = _router(args, 1, autoscale=pol, metrics_dir=pdir,
                         slo=_slo(args))
        try:
            router.start(warm_timeout_s=900.0)
            low = _run_load(args, router, pool,
                            args.rate_per_replica * 0.5,
                            max(4.0, args.duration / 2))
            # the step must OVERRUN one replica, not merely busy it: 8x
            # the per-replica operating point keeps depth/replica past
            # spawn_depth for the sustain window
            high = _run_load(args, router, pool,
                             args.rate_per_replica * 8,
                             max(6.0, args.duration))
            peak = router.replicas_alive()
            deadline = time.monotonic() + 30.0
            while (router.replicas_alive() > pol.min_replicas
                   and time.monotonic() < deadline):
                time.sleep(0.1)
            st = router.stats()
        finally:
            router.stop(timeout=20.0)
    rec = {"low": low, "high": high, "policy": pol.__dict__,
           "scale_ups": st["scale_ups"], "scale_downs": st["scale_downs"],
           "peak_replicas": peak,
           "replicas_after_drain": st["replicas_alive"]}
    if pdir is not None:
        rec["trace"] = _trace_digest(pdir)
    tobs.echo(f"autoscale: ups={st['scale_ups']} "
              f"downs={st['scale_downs']} peak={peak} "
              f"drained_to={st['replicas_alive']}")
    return rec


def parse_points(s):
    points = []
    for tok in (t for t in s.split(",") if t.strip()):
        n, _, h = tok.partition("@")
        points.append((int(n), int(h or 1)))
    return points


def main(argv=None):
    args = parse_args(argv)
    tobs = blocks.train_obs_from_args(args, "serve_fleet",
                                      tier=args.tier, lanes=args.lanes)
    t_start = time.time()
    backend = None
    if not args.stub:
        from smartcal_tpu_torch.envs import radio

        backend = radio.RadioBackend(device=args.device, **TIERS[args.tier])
    pool = _pool(args, backend)
    record = {
        "bench": "serve_fleet",
        "tier": args.tier, "M": args.M, "lanes": args.lanes,
        "device": args.device,
        "stub": bool(args.stub), "pool_mode": args.pool_mode,
        "rate_per_replica": args.rate_per_replica,
        "duration_s": args.duration,
        "host_cores": len(os.sched_getaffinity(0)),
        "trace_dir": args.trace_dir,
        "scaling": [],
    }
    for n, h in parse_points(args.replicas):
        record["scaling"].append(sweep_point(args, tobs, pool, n, h))
    if args.kill:
        record["kill"] = kill_run(args, tobs, pool)
    if args.autoscale:
        record["autoscale"] = autoscale_run(args, tobs, pool)
    if args.slowdown:
        record["slowdown"] = slowdown_run(args, tobs, pool)
    record["wall_s"] = round(time.time() - t_start, 3)
    obs.flush_counters()
    tobs.close()
    print(json.dumps(record, indent=1))
    if args.out:
        merge_out(args.out, record)
    return record


def merge_out(path, record):
    """Merge-append into ``runs``; derive the scaling digest (jobs/s vs
    replicas, normalized to the 1-replica point of the same run) from
    the latest run that swept more than one topology."""
    doc = {"bench": "serve_fleet", "runs": []}
    if os.path.exists(path):
        with open(path) as fh:
            doc = json.load(fh)
    doc.setdefault("runs", []).append(record)
    digests = []
    for run in doc["runs"]:
        pts = [p for p in run.get("scaling", [])
               if p["summary"].get("achieved_jobs_s")]
        if len(pts) < 2:
            continue
        base = next((p for p in pts if p["replicas"] == 1), pts[0])
        b = base["summary"]["achieved_jobs_s"]
        digests.append({
            "stub": run.get("stub", False),
            "host_cores": run.get("host_cores"),
            "base_jobs_s": b,
            "curve": [{
                "replicas": p["replicas"], "hosts": p["hosts"],
                "jobs_s": p["summary"]["achieved_jobs_s"],
                "speedup": round(p["summary"]["achieved_jobs_s"]
                                 / max(1e-9, b), 2),
                "efficiency": round(p["summary"]["achieved_jobs_s"]
                                    / max(1e-9, b * p["replicas"]), 3),
                "p99_s": p["summary"].get("latency_p99_s"),
                "shed": p["summary"].get("shed"),
                "steady_compiles":
                    p["steady_compile_events_fleet"],
            } for p in pts],
        })
    if digests:
        doc["scaling_digests"] = digests
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
    os.replace(tmp, path)


if __name__ == "__main__":
    main()
