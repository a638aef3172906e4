"""Observability of the PyTorch port (smartcal_tpu_torch/obs) against the
JAX package's.

* RunLog: header, schema version, non-finite sanitization, buffering,
  rotation; the headerless ``JsonlLogger`` shim;
* spans: the strict no-op contract, nesting paths per thread, errors;
* counters, gauges, memory gauges, compile events;
* solver telemetry: ``collect_stats`` changes no bit of the solve, and on
  the tiny ``PRNGKey(7)`` episode (well conditioned) the iteration counts
  equal the JAX solver's and ``primal_resid`` is within 1e-3 of it
  (relative, and of the residual's first-iteration scale);
  ``RadioBackend.calibrate`` logs a ``solver`` event only while recording;
* run-log schema parity: a tiny ``CalibEnv`` reset + step under each
  package's RunLog gives the same event kinds and span paths, apart from
  these exclusions: the JAX package's ``jax_event`` / ``cost`` events and
  the port's ``compile`` events (compile telemetry of each framework),
  and the port's ``images`` spans (the data and residual imaging, a
  ``stage_seconds`` stage of the port with no JAX span);
* ``tools/obs_report.py`` renders the port's run log with its stage
  breakdown;
* importing ``smartcal_tpu_torch.obs`` imports no torch module of its own
  (it reads torch from ``sys.modules``).
"""

import ast
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu import obs as jobs
from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu_torch import obs
from smartcal_tpu_torch.cal import solver as tsolver
from smartcal_tpu_torch.utils.metrics import JsonlLogger

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import obs_report  # noqa: E402

TINY = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=32)
# event kinds and span names one package records and the other has no
# counterpart of (see the module docstring)
JAX_ONLY_EVENTS = {"jax_event", "cost"}
PORT_ONLY_EVENTS = {"compile"}
PORT_ONLY_SPANS = {"images"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops on small batches: one intra-op thread for the module, its
    fixtures included (the suite runs six workers on the host's cores, and
    their oversubscribed thread pools slowed this file's trainers several
    times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def clean_obs_state():
    for m in (obs, jobs):
        while m.active() is not None:
            m.deactivate()
        m.reset_counters()
    yield
    for m in (obs, jobs):
        while m.active() is not None:
            m.deactivate()
        m.reset_counters()


def read_jsonl(path):
    return [json.loads(ln) for ln in open(path).read().splitlines()]


# -- RunLog -----------------------------------------------------------------

def test_runlog_header_schema_and_sanitization(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with obs.RunLog(path, run_id="r-1", meta={"entry": "test"},
                    flush_lines=1) as rl:
        rl.log("episode", episode=0, score=float("nan"),
               arr=[1.0, float("inf"), -float("inf")],
               nested={"x": float("nan"), "ok": 2},
               npval=np.float32(1.5), tval=torch.tensor(2.5),
               tarr=torch.tensor([1.0, float("nan")]))
    lines = read_jsonl(path)
    hdr = lines[0]
    assert hdr["event"] == "run_header"
    assert hdr["schema"] == obs.SCHEMA_VERSION == jobs.SCHEMA_VERSION
    assert hdr["run_id"] == "r-1" and hdr["host"] and hdr["pid"]
    assert hdr["meta"]["entry"] == "test"
    assert hdr["torch"] == torch.__version__
    assert hdr["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    ep = lines[1]
    assert ep["score"] is None and ep["arr"] == [1.0, None, None]
    assert ep["nested"] == {"x": None, "ok": 2}
    assert ep["npval"] == 1.5 and ep["tval"] == 2.5
    assert ep["tarr"] == [1.0, None]


def test_runlog_buffering_rotation_and_shim(tmp_path):
    path = str(tmp_path / "run.jsonl")
    rl = obs.RunLog(path, flush_lines=1000, flush_interval=1000.0)
    rl.log("e1")
    assert len(read_jsonl(path)) == 1
    rl.flush()
    assert len(read_jsonl(path)) == 2
    rl.log("e2")
    rl.close()
    assert [r["event"] for r in read_jsonl(path)] == \
        ["run_header", "e1", "e2"]

    rot = str(tmp_path / "rot.jsonl")
    rl = obs.RunLog(rot, run_id="rot-1", max_bytes=2000, flush_lines=1)
    for i in range(40):
        rl.log("episode", episode=i, payload="x" * 50)
    rl.close()
    run = obs_report.load_run(rot)
    eps = [e["episode"] for e in run["events"] if e["event"] == "episode"]
    assert os.path.exists(rot + ".1") and sorted(eps) == list(range(40))
    assert {e["run_id"] for e in run["events"]
            if e["event"] == "run_header"} == {"rot-1"}

    shim = tmp_path / "m.jsonl"
    with JsonlLogger(str(shim)) as log:
        log.log("episode", score=float("nan"))
    recs = read_jsonl(str(shim))
    assert len(recs) == 1 and recs[0]["score"] is None


# -- spans ------------------------------------------------------------------

def test_span_noop_without_runlog():
    assert obs.span("a") is obs.span("b", tag=1)
    with obs.span("a"):
        with obs.span("b") as sp:
            assert sp.tag(x=1) is sp


def test_span_nesting_paths_and_errors(tmp_path):
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path, flush_lines=1):
        with obs.span("episode", episode=3):
            with obs.span("solve", route="fused"):
                pass
            with obs.span("influence") as sp:
                sp.tag(route="per_band")
        with pytest.raises(ValueError):
            with obs.span("probe"):
                raise ValueError("card lost")
    spans = [r for r in read_jsonl(path) if r["event"] == "span"]
    assert [s["path"] for s in spans] == \
        ["episode/solve", "episode/influence", "episode", "probe"]
    assert spans[0]["route"] == "fused" and spans[1]["route"] == "per_band"
    assert spans[2]["episode"] == 3
    assert "card lost" in spans[3]["error"]


def test_spans_carry_the_adopted_trace(tmp_path):
    """Under an adopted trace, each span event names its own span id and
    its parent's, and plain events carry the current span."""
    path = str(tmp_path / "run.jsonl")
    car = {"trace": obs.tracectx.new_trace_id(), "span": "0" * 16}
    with obs.recording(path, flush_lines=1):
        with obs.tracectx.use_trace(car):
            with obs.span("outer"):
                obs.active().log("note")
                with obs.span("inner"):
                    pass
        with obs.span("untraced"):
            pass
    recs = read_jsonl(path)
    note = next(r for r in recs if r["event"] == "note")
    spans = {r["name"]: r for r in recs if r["event"] == "span"}
    assert spans["inner"]["parent"] == spans["outer"]["span"] == note["span"]
    assert spans["outer"]["parent"] == car["span"]
    assert {spans[k]["trace"] for k in ("inner", "outer")} == {car["trace"]}
    assert "trace" not in spans["untraced"]


def test_span_thread_safety(tmp_path):
    """Per-thread stacks never interleave (the prefetch worker's spans)."""
    path = str(tmp_path / "run.jsonl")
    errs = []

    def worker(name):
        try:
            for _ in range(50):
                with obs.span(name):
                    with obs.span(name + "_inner") as sp:
                        assert sp.path == f"{name}/{name}_inner", sp.path
        except Exception as e:
            errs.append(e)

    with obs.recording(path):
        ts = [threading.Thread(target=worker, args=(f"t{i}",), name=f"t{i}")
              for i in range(2)]
        [t.start() for t in ts]
        [t.join() for t in ts]
    assert not errs
    spans = [r for r in read_jsonl(path) if r["event"] == "span"]
    assert len(spans) == 200
    for s in spans:
        assert s["path"] in (s["thread"], f"{s['thread']}/{s['thread']}"
                             "_inner")


def test_spans_are_profiler_ranges(tmp_path):
    """Under a torch.profiler session a span is a record_function range."""
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path):
        with torch.profiler.profile() as prof:
            with obs.span("stage_under_test"):
                torch.ones(4).sum()
    assert any(e.key == "stage_under_test" for e in prof.key_averages())


# -- counters, gauges, memory, compile events --------------------------------

def test_counters_gauges_memory_and_compile_events(tmp_path):
    obs.counter_add("dead", 5)
    obs.record_compile("nvcc:dead", 1.0)
    assert obs.counters_snapshot() == {}
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path, flush_lines=1):
        obs.counter_add("solves")
        obs.counter_add("solves", 2)
        obs.gauge_set("queue_depth", 3, where="prefetch")
        n_mem = obs.log_memory_gauges()
        assert obs.install_compile_listener()
        obs.record_compile("cuda_graph:quartic_line_search", 0.25, lanes=4)
        obs.flush_counters()
    recs = read_jsonl(path)
    gauge = next(r for r in recs if r["event"] == "gauge")
    assert gauge["name"] == "queue_depth" and gauge["value"] == 3
    comp = next(r for r in recs if r["event"] == "compile")
    assert comp["key"] == "cuda_graph:quartic_line_search"
    assert comp["dur_s"] == 0.25 and comp["lanes"] == 4
    values = next(r for r in recs if r["event"] == "counters")["values"]
    assert values["solves"] == 3.0 and values["compile_events"] == 1.0
    assert n_mem == len([r for r in recs if r["event"] == "memory"])
    if not torch.cuda.is_available():
        assert n_mem == 0


def test_obs_modules_import_no_torch():
    """The obs modules read torch from sys.modules and import it only
    inside functions whose callers hold tensors."""
    d = os.path.join(ROOT, "smartcal_tpu_torch", "obs")
    for f in sorted(os.listdir(d)):
        if not f.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(d, f)).read())
        for node in tree.body:
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            assert not any(n.split(".")[0] in ("torch", "numpy")
                           for n in names), (f, names)


# -- solver telemetry ---------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_episode():
    """The tiny backend's PRNGKey(7) episode in the JAX package, and its
    solve with stats."""
    from smartcal_tpu.envs.radio import RadioBackend

    be = RadioBackend(shard=False, **TINY)
    ep, mdl = be.new_calib_episode(jax.random.PRNGKey(7), 3, 3)
    rho = np.asarray(mdl.rho, np.float32)
    cfg = be._solver_cfg(3)
    jres = jsolver.solve_admm(ep.V, ep.Ccal, ep.obs.freqs, ep.f0,
                              jnp.asarray(rho), cfg, n_chunks=be.n_chunks,
                              collect_stats=True)
    return ep, rho, cfg, be.n_chunks, jres


def _port_solve(tiny_episode, collect):
    ep, rho, cfg, n_chunks, _ = tiny_episode
    t = lambda a: torch.from_numpy(np.array(a))   # noqa: E731
    return tsolver.solve_admm(t(ep.V), t(ep.Ccal), t(ep.obs.freqs), ep.f0,
                              t(rho), tsolver.SolverConfig(*cfg),
                              n_chunks=n_chunks, collect_stats=collect)


def test_solver_stats_change_no_bit(tiny_episode):
    off = _port_solve(tiny_episode, False)
    on, stats = _port_solve(tiny_episode, True)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    cfg = tiny_episode[2]
    assert int(stats.admm_iters) == cfg.admm_iters
    assert stats.primal_resid.shape == (cfg.admm_iters,)
    assert int(stats.n_segments) == 1
    assert stats.linesearches > 0 and stats.phi_evals >= 2 * \
        stats.linesearches


def test_solver_stats_match_jax(tiny_episode):
    jst = tiny_episode[4].stats
    _, st = _port_solve(tiny_episode, True)
    assert int(st.admm_iters) == int(jst.admm_iters)
    assert st.inner_iters.tolist() == np.asarray(jst.inner_iters).tolist()
    assert int(st.init_iters) == int(jst.init_iters)
    # within 1e-3 of the residual's scale (its first outer iteration): a
    # later iterate's J - BZ is a difference of near-equal solutions, so
    # the solvers' 1e-3 band is relative to that scale, not to its value
    want = np.asarray(jst.primal_resid)
    np.testing.assert_allclose(st.primal_resid.numpy(), want, rtol=1e-3,
                               atol=1e-3 * float(want.max()))


def test_backend_calibrate_logs_solver_event(tmp_path):
    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.envs.radio import RadioBackend

    be = RadioBackend(device="cpu", **TINY)
    ep, mdl = be.new_calib_episode(prng.PRNGKey(7), 3, 3)
    quiet = be.calibrate(ep, mdl.rho)
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path, flush_lines=1):
        res = be.calibrate(ep, mdl.rho)
    assert torch.equal(res.J, quiet.J)
    recs = read_jsonl(path)
    ev = next(r for r in recs if r["event"] == "solver")
    assert ev["route"] == "fused" and ev["admm_iters"] == TINY["admm_iters"]
    assert len(ev["primal_resid"]) == TINY["admm_iters"]
    assert ev["lbfgs_iters_total"] > 0
    assert 2 <= ev["phi_evals_per_linesearch"] <= 50
    assert ev["phi_evals_est"] > ev["lbfgs_iters_total"]
    span = next(r for r in recs if r["event"] == "span")
    assert span["name"] == "solve" and span["route"] == "fused"
    assert span["synced"] is True


# -- run-log schema parity and obs_report -------------------------------------

def _env_run(pkg, path):
    """A tiny CalibEnv reset + step under ``pkg``'s RunLog; returns the
    events."""
    if pkg == "jax":
        from smartcal_tpu.envs.calib import CalibEnv
        from smartcal_tpu.envs.radio import RadioBackend
        env = CalibEnv(M=3, provide_hint=True, seed=0,
                       backend=RadioBackend(shard=False, **TINY))
        rec = jobs.recording
    else:
        from smartcal_tpu_torch.envs.calib import CalibEnv
        from smartcal_tpu_torch.envs.radio import RadioBackend
        env = CalibEnv(M=3, provide_hint=True, seed=0, device="cpu",
                       backend=RadioBackend(device="cpu", **TINY))
        rec = obs.recording
    with rec(path, meta={"entry": f"{pkg}_env"}):
        env.reset()
        env.step(env.hint)
    return read_jsonl(path)


def test_run_log_schema_matches_jax(tmp_path):
    jev = _env_run("jax", str(tmp_path / "jax.jsonl"))
    tev = _env_run("port", str(tmp_path / "port.jsonl"))
    jkinds = {e["event"] for e in jev} - JAX_ONLY_EVENTS
    tkinds = {e["event"] for e in tev} - PORT_ONLY_EVENTS
    assert jkinds == tkinds
    assert {"run_header", "span", "solver"} <= tkinds

    def paths(events):
        return sorted(e["path"] for e in events if e["event"] == "span"
                      and e["name"] not in PORT_ONLY_SPANS)

    assert paths(tev) == paths(jev)
    assert "episode_step/reward/images" in {e["path"] for e in tev
                                            if e["event"] == "span"}
    jsol = [e for e in jev if e["event"] == "solver"]
    tsol = [e for e in tev if e["event"] == "solver"]
    assert len(tsol) == len(jsol) == 2
    assert set(tsol[0]) - {"trace", "span"} == set(jsol[0]) - {"trace",
                                                               "span"}


def test_obs_report_renders_the_port_log(tmp_path):
    """tools/obs_report.py reads the port's training run: the stage
    breakdown nests the backend's stages under the env's spans."""
    from smartcal_tpu_torch.train import calib_sac

    path = str(tmp_path / "run.jsonl")
    calib_sac.main(["--small", "--M", "3", "--episodes", "2", "--steps", "1",
                    "--use_hint", "--device", "cpu", "--quiet", "--prefix",
                    str(tmp_path / "c"), "--metrics", path, "--diag"])
    run = obs_report.load_run(path)
    assert run["header"]["meta"]["entry"] == "calib_sac"
    rep = obs_report.build_report([run], n_boot=50)
    agg = rep["runs"][0]["spans"]
    for p in ("episode", "episode/episode_reset/solve",
              "episode/episode_step/influence",
              "episode/episode_step/reward/images"):
        assert agg[p]["n"] >= 2, p
    text = obs_report.render(rep)
    assert "episode/episode_reset/solve" in text or "solve" in text
    kinds = {e["event"] for e in run["events"]}
    assert {"diag", "replay_health", "solver", "run_end"} <= kinds


def test_train_obs_enet_driver(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    from smartcal_tpu_torch.train.enet_sac import train_fused

    path = str(tmp_path / "run.jsonl")
    train_fused(episodes=3, steps=2, M=6, N=6, quiet=True, save_every=0,
                metrics_path=path, device="cpu")
    recs = read_jsonl(path)
    assert recs[0]["event"] == "run_header"
    assert recs[0]["meta"]["entry"] == "enet_sac"
    assert [e["episode"] for e in recs if e["event"] == "episode"] == \
        [0, 1, 2]
    spans = [r for r in recs if r["event"] == "span"]
    assert len(spans) == 3 and all(s["name"] == "episode" for s in spans)
    assert recs[-1]["event"] == "run_end" and recs[-1]["episodes"] == 3
    assert obs.active() is None
