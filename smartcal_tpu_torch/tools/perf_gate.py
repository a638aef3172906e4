"""perf_gate: the port's regression gate (counterpart of the JAX
package's tools/perf_gate.py, with its CLI, exit codes, tiny tier and
fault hooks).

A deterministic micro-bench tier over the port's load-bearing stages,
measured in seconds, then judged against the host-fingerprinted baseline
store (``smartcal_tpu_torch/obs/baselines.py``) by the noise-aware
detector (``smartcal_tpu_torch/obs/regress.py``).  Stages:

* ``solve``: the backend's batched solve (``solver.solve_admm_batched``)
  of 3 stacked tiny episodes;
* ``influence``: their influence images (``influence.influence_images_lanes``
  through ``RadioBackend.influence_images_batched``);
* ``imager``: ``imager.multifreq_image_sr`` of one episode, kernel 1
  (``csrc/dft_imager.cu``) on the card; a rep makes ``IMAGER_REPEAT``
  images, as one image (~0.5 ms on an H100) is a measurement of the
  host's launch jitter, which moves by up to 2x between runs;
* ``replay_fused``: the fleet learner's fused step (``rl/replay_sharded``
  store of 32 versioned transitions into a 4-shard ring, PER + ERE sample,
  the IS-clipped SAC learn, the priority update), the JAX gate's
  composition; a rep runs ``REPLAY_REPEAT`` steps from a fresh copy of the
  same agent and ring.

* ``serve_batch``: one batch of 3 heterogeneous pinned-rho jobs through a
  warmed ``serve.CalibServer`` (``process_once``: pack, the solve program
  with its line-search graph captured at warmup, influence, sigmas);
* ``publish``: one versioned ``ExportCache.publish`` + ``swap_policy``
  against a warmed policy-armed server (``serve.lifecycle.PolicyPublisher``)
  and a policy forward.

For these two the ``compile_events`` metric counts the CUDA-graph captures
too: a warmed batch or a publication that builds or captures anything is
the regression each guards.

Usage::

    python -m smartcal_tpu_torch.tools.perf_gate --update-baseline
    python -m smartcal_tpu_torch.tools.perf_gate          # 1 on FIRE
    python -m smartcal_tpu_torch.tools.perf_gate --json --out gate.json
    python -m smartcal_tpu_torch.tools.perf_gate --device cpu --samples 2

Per stage the gate measures K wall-clock samples (the noise model of the
bootstrap CI; see :func:`measure_stages`), the stage's counted flops and peak
bytes (``obs.costs.stage_cost``), the nvcc builds across the timed reps
(must stay 0: a rebuild is a regression), and one deterministic numeric
scalar whose relative drift from the blessed value is judged against the
bf16 band.  The CUDA-graph captures per rep are reported beside them and
not gated: the fused solve captures its line search once per solve
(ROADMAP lever g).  Baselines are keyed on stage, statics (the tier and
the device) and the host fingerprint (which names the card), so a
baseline recorded elsewhere is NO BASELINE here.  The default store is
``smartcal_tpu_torch/_build/perf_baselines.json`` (not committed).

Fault hooks (``runtime/faults``, armed through ``SMARTCAL_FAULTS``):
``gate_<stage>`` delays inside the timed reps and ``gate_numeric_<stage>``
perturbs the numeric scalar.

Exit codes: 0 clean (or baseline updated), 1 at least one FIRE, 2 usage
or internal error.  Runs on the card unless ``--device cpu``.
"""

import argparse
import dataclasses
import gc
import json
import os
import statistics
import sys
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_BASELINE = os.path.join(_PKG, "_build", "perf_baselines.json")

#: the tiny tier of the JAX gate
TIER = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=32)
M, LANES = 3, 3
K_SAMPLES = 5
WARM_REPS = 2
SUB_REPS = 2
IMAGER_REPEAT = 20
REPLAY_REPEAT = 10
STAGE_NAMES = ("solve", "influence", "imager", "replay_fused",
               "serve_batch", "publish")


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build_stages(names, device):
    """The requested stages: each a dict with ``statics`` (baseline key
    material), ``run()`` (one rep, ending in a sync; returns the numeric
    scalar) and ``cost()`` (the counted flops and bytes)."""
    import numpy as np
    import torch

    from smartcal_tpu_torch import obs, prng
    from smartcal_tpu_torch.cal import imager, solver
    from smartcal_tpu_torch.envs.radio import RadioBackend

    be = RadioBackend(device=device, **TIER)
    dev = be.device
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    key = prng.PRNGKey(0)
    eps = []
    for _ in range(LANES):
        key, k = prng.split(key)
        eps.append(be.new_calib_episode(k, M, M)[0])
    bep = be.stack_episodes(eps)
    rho = np.ones((LANES, M), np.float32)
    alpha = np.zeros((LANES, M), np.float32)
    base = dict(TIER, M=M, lanes=LANES, device=card)
    cfg = be._solver_cfg(M)
    sops = be.batched_solve_operands(bep, rho, np.ones((LANES, M)),
                                     TIER["admm_iters"])

    def solve():
        V, C, freqs, f0, r, iters = sops
        return solver.solve_admm_batched(V, C, freqs, f0, r, cfg,
                                         n_chunks=be.n_chunks,
                                         admm_iters=iters)

    def run_solve():
        res = solve()
        _sync(dev)
        return float(torch.mean(torch.abs(res.sigma_res)))

    res = solve()

    def influence():
        return be.influence_images_batched(bep, res, rho, alpha)

    def run_influence():
        imgs = influence()
        _sync(dev)
        return float(torch.std(imgs))

    ep0 = eps[0]
    cell = imager.default_cell(ep0.obs.uvw, float(ep0.obs.freqs[-1]))

    def image():
        return imager.multifreq_image_sr(ep0.obs.uvw, ep0.V, ep0.obs.freqs,
                                         cell, npix=TIER["npix"])

    def run_imager():
        for _ in range(IMAGER_REPEAT):
            img = image()
        _sync(dev)
        return float(torch.std(img))

    stages = {
        "solve": {"statics": dict(base, stage="solve"), "run": run_solve,
                  "cost": lambda: obs.stage_cost(solve)},
        "influence": {"statics": dict(base, stage="influence"),
                      "run": run_influence,
                      "cost": lambda: obs.stage_cost(influence)},
        "imager": {"statics": {"stage": "imager", "npix": TIER["npix"],
                               "n_stations": TIER["n_stations"],
                               "n_freqs": TIER["n_freqs"],
                               "n_times": TIER["n_times"], "device": card,
                               "repeat": IMAGER_REPEAT},
                   "run": run_imager, "cost": lambda: obs.stage_cost(image)},
    }
    if "replay_fused" in names:
        stages["replay_fused"] = _build_replay_stage(dev, card)
    if "serve_batch" in names:
        stages["serve_batch"] = _build_serve_stage(be, card)
    if "publish" in names:
        stages["publish"] = _build_publish_stage(be, card)
    return {n: stages[n] for n in names}


def _serve_cache_dir() -> str:
    """A scratch program cache for the serve stages, removed at exit."""
    import atexit
    import shutil
    import tempfile

    d = tempfile.mkdtemp(prefix="perf_gate_serve_")
    atexit.register(shutil.rmtree, d, True)
    return d


def _build_serve_stage(be, card):
    """One warmed CalibServer batch: pack -> solve program -> influence ->
    sigmas on the caller's thread (``process_once``), the JAX gate's
    composition; the numeric scalar is the first job's sigma_res."""
    import numpy as np

    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.serve import CalibServer, Job

    srv = CalibServer(be, M=M, lanes=LANES, cache_dir=_serve_cache_dir(),
                      compile_cache=False, max_wait_s=0.02)
    srv.warmup(seed=7)
    key = prng.PRNGKey(9)
    eps, ks = [], [2, 3, 2]
    for k in ks:
        key, sub = prng.split(key)
        eps.append(be.new_calib_episode(sub, k, M)[0])

    def run():
        jobs = [Job(episode=ep, k=k,
                    rho=np.linspace(0.5 + i, 1.5 + i, k).astype(np.float32),
                    maxiter=TIER["admm_iters"])
                for i, (ep, k) in enumerate(zip(eps, ks))]
        srv.process_once(jobs, timeout=0.01)
        return float(jobs[0].future.result(timeout=60).sigma_res)

    from smartcal_tpu_torch import obs

    return {"statics": dict(be.serve_signature(M, LANES, TIER["npix"]),
                            stage="serve_batch", jobs=len(ks), device=card),
            "run": run, "cost": lambda: obs.stage_cost(run),
            "captures_gated": True}


def _build_publish_stage(be, card):
    """Warm hot-swap publication: one versioned ``ExportCache.publish`` +
    ``swap_policy`` against a warmed policy-armed server per rep, then a
    policy forward (the JAX gate's composition).  A publication that
    builds or captures anything breaks the zero-compile hot-swap."""
    import numpy as np
    import torch

    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.serve import CalibServer, PolicyPublisher

    obs_dim = TIER["npix"] * TIER["npix"] + (M + 1) * 7
    cfg = sac.SACConfig(obs_dim=obs_dim, n_actions=2 * M)
    st = sac.sac_init(cfg, torch.Generator(device=be.device).manual_seed(7),
                      be.device)
    params = {k: v.detach().clone() for k, v in st.actor.state_dict().items()}
    srv = CalibServer(be, M=M, lanes=LANES, cache_dir=_serve_cache_dir(),
                      compile_cache=False, policy=(cfg, params),
                      max_wait_s=0.02)
    srv.warmup(seed=7)
    pub = PolicyPublisher(srv, keep_versions=4)
    probe = torch.linspace(-0.5, 0.5, obs_dim, device=be.device)[None, :]
    ver = [0]

    def run():
        ver[0] += 1
        pub.publish(params, ver[0])
        act, _, _ = sac.policy_heads(cfg, st.actor, probe)
        _sync(be.device)
        return float(torch.mean(torch.abs(act)))

    from smartcal_tpu_torch import obs

    def forward():
        # the program's operand is one observation per lane
        return srv._policy_forward(srv._program("policy"), params,
                                   probe.expand(LANES, -1))

    return {"statics": dict(be.serve_signature(M, LANES, TIER["npix"]),
                            stage="publish", obs_dim=obs_dim, device=card),
            "run": run, "cost": lambda: obs.stage_cost(forward),
            "captures_gated": True}


def _build_replay_stage(dev, card):
    """The fleet learner's fused store -> PER/ERE sample -> IS-clipped
    learn -> priority update on a 4-shard ring (the JAX gate's
    composition): one rep is ``REPLAY_REPEAT`` steps from a fresh copy of
    the same agent, ring and generator; the numeric scalar is the ring's
    mean priority after them."""
    import torch

    from smartcal_tpu_torch import obs
    from smartcal_tpu_torch.obs import costs
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.rl import replay_sharded as rps
    from smartcal_tpu_torch.rl import sac

    S, n = 4, 32
    cfg = sac.SACConfig(obs_dim=6, n_actions=2, prioritized=True,
                        is_clip=2.0, ere_eta=0.99, batch_size=8,
                        mem_size=64)
    spec = rp.versioned_spec(rp.transition_spec(cfg.obs_dim, cfg.n_actions))
    gen = torch.Generator(device=dev).manual_seed(7)
    st0 = sac.sac_init(cfg, gen, dev)
    obs_b = torch.randn((n, cfg.obs_dim), generator=gen, device=dev)
    a, lp = sac.choose_action_logp(cfg, st0, obs_b, torch.randn(
        (n, cfg.n_actions), generator=gen, device=dev))
    flat = {"state": obs_b, "new_state": obs_b + 0.1, "action": a,
            "reward": (torch.arange(n, device=dev) % 3).float() - 1.0,
            "done": torch.zeros(n, dtype=torch.bool, device=dev),
            "hint": torch.zeros((n, cfg.n_actions), device=dev),
            "version": torch.ones(n, dtype=torch.int32, device=dev),
            "behavior_logp": lp}

    def fresh():
        with costs.uncounted():
            return (st0.copy_to(dev),
                    rps.replay_init(cfg.mem_size, spec, S, device=dev),
                    torch.Generator(device=dev).manual_seed(3))

    def fused(st, buf, g):
        rps.replay_add_batch(buf, flat)
        return sac.learn(cfg, st, buf, g, learner_version=2)

    def run():
        st, buf, g = fresh()
        for _ in range(REPLAY_REPEAT):
            fused(st, buf, g)
        _sync(dev)
        return float(torch.mean(buf.priority))

    return {"statics": {"stage": "replay_fused", "shards": S,
                        "obs_dim": cfg.obs_dim, "batch_size": cfg.batch_size,
                        "mem_size": cfg.mem_size, "n_store": n,
                        "repeat": REPLAY_REPEAT, "device": card},
            "run": run,
            "cost": lambda: obs.stage_cost(lambda: fused(*fresh()))}


def measure_stages(stages, k_samples):
    """Per stage: K wall samples, the counted cost and the numeric scalar,
    as baseline-store metric dicts, and the CUDA-graph captures per rep
    (reported, not gated).  After ``WARM_REPS`` reps of each stage, the K
    samples are taken round robin over the stages, each the fastest of
    ``SUB_REPS`` reps, with the garbage collector off (as timeit does): a
    card on a shared host stalls for tens to hundreds of ms at random, and
    a sample so taken measures the stage, not the stall.  The fault hooks
    sit inside every timed rep and on the numeric, so an injected
    regression is measured as a real one would be."""
    from smartcal_tpu_torch import obs
    from smartcal_tpu_torch.obs import baselines as bl
    from smartcal_tpu_torch.runtime import faults as rt_faults

    for stage in stages.values():
        for _ in range(WARM_REPS):       # builds and allocator growth
            stage["run"]()
    walls = {n: [] for n in stages}
    numeric = dict.fromkeys(stages, 0.0)
    builds = dict.fromkeys(stages, 0.0)
    captures = dict.fromkeys(stages, 0.0)
    gc.collect()
    gc.disable()
    try:
        for i in range(k_samples):
            for name, stage in stages.items():
                c0 = obs.counters_snapshot()
                best = float("inf")
                for _ in range(SUB_REPS):
                    t0 = time.perf_counter()
                    rt_faults.maybe_delay(f"gate_{name}", i)
                    numeric[name] = stage["run"]()
                    best = min(best, time.perf_counter() - t0)
                walls[name].append(best)
                c1 = obs.counters_snapshot()
                for acc, key in ((builds, "compile_events:nvcc"),
                                 (captures, "compile_events:cuda_graph")):
                    acc[name] += c1.get(key, 0.0) - c0.get(key, 0.0)
    finally:
        gc.enable()
    out = {}
    for name, stage in stages.items():
        value = rt_faults.maybe_perturb(f"gate_numeric_{name}", 0,
                                        float(numeric[name]))
        events = builds[name] + (captures[name]
                                 if stage.get("captures_gated") else 0.0)
        metrics = {"wall_s": bl.summarize_samples(walls[name]),
                   "compile_events": bl.scalar_metric(events),
                   "numeric": bl.scalar_metric(value)}
        cost = stage["cost"]()
        for k in ("flops", "peak_bytes"):
            if cost.get(k):
                metrics[k] = bl.scalar_metric(cost[k])
        out[name] = (metrics, captures[name] / (k_samples * SUB_REPS))
    return out


def judge(store, name, statics, fp, metrics):
    """Findings for one stage: wall, bytes, flops and builds through the
    regular policies, and the numeric scalar as ``rel_err`` from the
    blessed value, judged against the bf16 band."""
    from smartcal_tpu_torch.obs import regress as rg

    measured = {k: v for k, v in metrics.items() if k != "numeric"}
    entry = store.get(name, statics, fp)
    if entry is not None and "numeric" in entry.get("metrics", {}):
        base_num = float(entry["metrics"]["numeric"]["value"])
        new_num = float(metrics["numeric"]["value"])
        rel = abs(new_num - base_num) / max(abs(base_num), 1e-12)
        measured["rel_err"] = {"kind": "scalar", "value": rel}
    return rg.compare(store, name, statics, fp, measured)


def _finding_dict(f):
    d = dataclasses.asdict(f)
    if d.get("ci95"):
        d["ci95"] = list(d["ci95"])
    return d


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m smartcal_tpu_torch.tools.perf_gate",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--baseline", default=None,
                    help=f"baseline store (default: {DEFAULT_BASELINE})")
    ap.add_argument("--update-baseline", action="store_true",
                    help="record this run as the blessed baseline for "
                         "this host fingerprint")
    ap.add_argument("--stages", default=None,
                    help=f"comma-separated subset of {','.join(STAGE_NAMES)}")
    ap.add_argument("--samples", type=int, default=K_SAMPLES,
                    help="timed reps per stage (noise model size)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    ap.add_argument("--out", default=None,
                    help="also write the full result document here")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the stages (cuda; cpu when asked "
                         "for)")
    args = ap.parse_args(argv)

    names = list(STAGE_NAMES)
    if args.stages:
        names = [s.strip() for s in args.stages.split(",") if s.strip()]
        unknown = set(names) - set(STAGE_NAMES)
        if unknown:
            sys.stderr.write(
                f"perf_gate: unknown stage(s): {', '.join(sorted(unknown))}"
                f" (known: {', '.join(STAGE_NAMES)})\n")
            return 2

    from smartcal_tpu_torch import obs
    from smartcal_tpu_torch.obs import baselines as bl
    from smartcal_tpu_torch.obs import regress as rg
    from smartcal_tpu_torch.runtime import faults as rt_faults
    from smartcal_tpu_torch.runtime.atomic import atomic_write_text

    t0 = time.time()
    baseline_path = args.baseline or DEFAULT_BASELINE
    store = bl.BaselineStore(baseline_path)
    rt_faults.install_from_env()
    # a RunLog with no file: the compile sites count into the counters
    with obs.recording(None, meta={"entry": "perf_gate"}):
        obs.install_compile_listener()
        try:
            stages = build_stages(names, args.device)
        except Exception as e:  # noqa: BLE001 — exit code 2, reported
            sys.stderr.write(f"perf_gate: stage build failed: {e!r}\n")
            return 2
        measured = measure_stages(stages, args.samples)
    fp = bl.host_fingerprint()            # after CUDA is up: names the card

    doc = {"fingerprint": fp,
           "fingerprint_digest": bl.fingerprint_digest(fp),
           "baseline": baseline_path, "samples": args.samples,
           "stages": {}, "findings": []}
    n_fire = n_warn = 0
    for name, (metrics, captures) in measured.items():
        statics = stages[name]["statics"]
        doc["stages"][name] = {
            "statics": statics, "metrics": metrics,
            "median_ms": 1e3 * statistics.median(
                metrics["wall_s"]["samples"]),
            "graph_captures_per_rep": captures}
        if args.update_baseline:
            store.record(name, statics, fp, metrics)
            continue
        try:
            findings = judge(store, name, statics, fp, metrics)
        except rg.FingerprintMismatch as e:
            sys.stderr.write(f"perf_gate: {e}\n")
            return 2
        for f in findings:
            doc["findings"].append(_finding_dict(f))
            n_fire += f.verdict == rg.FIRE
            n_warn += f.verdict == rg.WARN
            if not args.as_json:
                print(f.render())

    doc["wall_s"] = round(time.time() - t0, 3)
    if args.update_baseline:
        store.save()
        doc["updated"] = True
        msg = (f"perf_gate: baseline updated for {len(stages)} stage(s) "
               f"on fingerprint {doc['fingerprint_digest']} -> "
               f"{doc['baseline']}")
    else:
        doc["fires"], doc["warns"] = n_fire, n_warn
        msg = (f"perf_gate: {n_fire} FIRE / {n_warn} WARN over "
               f"{len(stages)} stage(s) in {doc['wall_s']}s "
               f"[fingerprint {doc['fingerprint_digest']}]")
    if args.as_json:
        print(json.dumps(doc, indent=1, sort_keys=True))
    else:
        for name, st in doc["stages"].items():
            print(f"perf_gate: {name} median {st['median_ms']:.3f} ms, "
                  f"graph captures per rep "
                  f"{st['graph_captures_per_rep']:g}")
        print(msg)
    if args.out:
        atomic_write_text(args.out,
                          json.dumps(doc, indent=1, sort_keys=True) + "\n")
    return 1 if n_fire else 0


if __name__ == "__main__":
    sys.exit(main())
