"""Serve calibration jobs: warm up the CalibServer, drive it with the
open-loop load generator, and record the SLO artifact (the port's
counterpart of the JAX package's tools/serve_calib.py, same flags and
record, plus ``--device``).

One invocation is one server lifecycle: warmup (program-cache load or
build: the cold/warm restart measurement), supervised serving under a
sweep of offered rates, teardown.  Results merge-append into ``--out``:
run it twice against the same ``--cache-dir`` and the artifact gains a
``restart`` section comparing the cold boot to the warm one.

    python -m smartcal_tpu_torch.tools.serve_calib --tier tiny --lanes 4 \\
        --rates 2,4 --duration 10 --cache-dir /tmp/serve_cache \\
        --device cpu --out /tmp/serve.json

On the card drop ``--device cpu``.  The run log (``--metrics``, default
``<cache-dir>/serve_calib_run.jsonl``: compile events are counted only
while a run log records) carries the per-stage spans, a ``serve_request``
event per job, the queue-depth and shed gauges and the counters;
``steady_compile_events`` is the port's ``compile_events`` (nvcc builds
and CUDA-graph captures) between the end of warmup and the end of
serving.
"""

import argparse
import json
import os
import sys
import time

from smartcal_tpu_torch import obs
from smartcal_tpu_torch.serve.loadgen import SERVE_TIERS as TIERS
from smartcal_tpu_torch.train import blocks


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m smartcal_tpu_torch.tools.serve_calib",
        description=__doc__.split("\n")[0])
    p.add_argument("--tier", choices=sorted(TIERS), default="tiny",
                   help="backend scale (tiny = the CPU test tier)")
    p.add_argument("--M", type=int, default=4,
                   help="max calibration directions (jobs carry k <= M)")
    p.add_argument("--lanes", type=int, default=4,
                   help="micro-batch width (BatchedEpisode lanes)")
    p.add_argument("--cache-dir", dest="cache_dir", required=True,
                   help="program cache and nvcc build directory root")
    p.add_argument("--rates", type=str, default="2,4",
                   help="comma list of offered rates (jobs/s) to sweep")
    p.add_argument("--duration", type=float, default=10.0,
                   help="seconds of offered load per rate")
    p.add_argument("--pool", type=int, default=8,
                   help="pre-built synthetic episodes cycled by the "
                        "load generator")
    p.add_argument("--pool-mode", dest="pool_mode",
                   choices=("mixed", "uniform"), default="mixed",
                   help="mixed (default): heterogeneous K/diffuse pool "
                        "drawn at random; uniform: a deterministic K cycle "
                        "walked in order")
    p.add_argument("--max-wait-ms", dest="max_wait_ms", type=float,
                   default=50.0, help="micro-batch max wait")
    p.add_argument("--max-queue", dest="max_queue", type=int, default=32,
                   help="bounded admission queue depth (overload sheds)")
    p.add_argument("--deadline-ms", dest="deadline_ms", type=float,
                   default=None, help="per-job SLO deadline (deadline-"
                   "aware flush + deadline_miss accounting)")
    p.add_argument("--policy", action="store_true",
                   help="arm the exported policy head (fresh SAC actor): "
                        "jobs without pinned rho get theirs from it")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu on request)")
    p.add_argument("--out", type=str, default=None,
                   help="merge-append the run record into this JSON")
    blocks.add_obs_args(p)
    return p.parse_args(argv)


def make_policy(args, M, npix, device):
    """(SACConfig, actor weights by name) of a fresh SAC agent."""
    from smartcal_tpu_torch.rl import sac

    obs_dim = npix * npix + (M + 1) * 7
    agent = sac.SACAgent(sac.SACConfig(obs_dim=obs_dim, n_actions=2 * M),
                         seed=args.seed, name_prefix="serve", device=device)
    return agent.cfg, dict(agent.state.actor.state_dict())


def main(argv=None):
    args = parse_args(argv)
    from smartcal_tpu_torch.envs import radio
    from smartcal_tpu_torch.serve import (CalibServer, enable_compile_cache,
                                          loadgen)

    if args.metrics is None and args.trace is None:
        args.metrics = os.path.join(args.cache_dir, "serve_calib_run.jsonl")
    os.makedirs(args.cache_dir, exist_ok=True)
    tobs = blocks.train_obs_from_args(args, "serve_calib",
                                      tier=args.tier, lanes=args.lanes)
    t_boot = time.time()
    # the nvcc build directory under the cache root, before any kernel
    # loads: a warm restart finds the libraries the cold boot built
    enable_compile_cache(os.path.join(args.cache_dir, "nvcc"))
    backend = radio.RadioBackend(device=args.device, **TIERS[args.tier])
    policy = (make_policy(args, args.M, backend.npix, backend.device)
              if args.policy else None)
    srv = CalibServer(backend, M=args.M, lanes=args.lanes,
                      cache_dir=args.cache_dir, policy=policy,
                      max_wait_s=args.max_wait_ms / 1e3,
                      max_queue=args.max_queue)
    warm = srv.warmup(seed=args.seed)
    boot_s = round(time.time() - t_boot, 3)
    tobs.echo(f"server up in {boot_s}s (warmup {warm['wall_s']}s, "
              f"programs {warm['sources']})")

    pool = loadgen.build_job_pool(
        backend, args.M, args.pool, seed=args.seed + 1,
        heterogeneous=(args.pool_mode == "mixed"))
    srv.start()
    rates_out = []
    c_steady0 = obs.counters_snapshot()
    try:
        for rate in (float(r) for r in args.rates.split(",") if r):
            gen = loadgen.OpenLoopLoadGen(
                srv, pool, rate=rate, duration_s=args.duration,
                seed=args.seed,
                deadline_s=(args.deadline_ms / 1e3
                            if args.deadline_ms else None),
                maxiter_choices=(None, max(1, backend.admm_iters - 1),
                                 backend.admm_iters + 2),
                pick=("cycle" if args.pool_mode == "uniform"
                      else "random"))
            r = gen.run()
            r["stats"] = srv.stats()
            rates_out.append(r)
            tobs.echo(f"rate {rate}: " + json.dumps(r))
    finally:
        srv.stop()
    c_steady1 = obs.counters_snapshot()

    def steady(key):
        return c_steady1.get(key, 0.0) - c_steady0.get(key, 0.0)

    steady_compiles = steady("compile_events")
    record = {
        "tier": args.tier, "M": args.M, "lanes": args.lanes,
        "policy": bool(args.policy), "pool_mode": args.pool_mode,
        "device": str(backend.device),
        "boot_s": boot_s,
        "warmup": warm,
        "rates": rates_out,
        "steady_compile_events": steady_compiles,
        "steady_nvcc_builds": steady("compile_events:nvcc"),
        "steady_graph_captures": steady("compile_events:cuda_graph"),
        "wall_s": round(time.time() - t_boot, 3),
    }
    obs.flush_counters()
    tobs.close()
    print(json.dumps(record, indent=1))
    if args.out:
        merge_out(args.out, record)
    if steady_compiles:
        print(f"WARNING: {steady_compiles:.0f} compile events in steady "
              "state (expected 0)", file=sys.stderr)
    return record


def merge_out(path, record):
    """Append ``record`` to the artifact's ``runs`` list; with >= 2 runs
    derive the cold-vs-warm ``restart`` section (run 0 is the cold boot,
    the last run the restarted server on the same cache)."""
    doc = {"bench": "serve_calib", "runs": []}
    if os.path.exists(path):
        with open(path) as fh:
            doc = json.load(fh)
    doc.setdefault("runs", []).append(record)
    runs = doc["runs"]
    if len(runs) >= 2:
        cold, warmr = runs[0], runs[-1]
        doc["restart"] = {
            "cold_boot_s": cold["boot_s"],
            "warm_boot_s": warmr["boot_s"],
            "cold_warmup_s": cold["warmup"]["wall_s"],
            "warm_warmup_s": warmr["warmup"]["wall_s"],
            "speedup": round(cold["warmup"]["wall_s"]
                             / max(1e-9, warmr["warmup"]["wall_s"]), 2),
            "warm_export_cache_hits":
                warmr["warmup"].get("export_cache_hit"),
            "warm_export_cache_misses":
                warmr["warmup"].get("export_cache_miss"),
            "warm_export_cache_prepared_hits":
                warmr["warmup"].get("export_cache_prepared_hit"),
            "warm_nvcc_builds": warmr["warmup"].get("compile_events:nvcc"),
        }
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(tmp, "w") as fh:
        json.dump(doc, fh, indent=1)
    os.replace(tmp, path)


if __name__ == "__main__":
    main()
