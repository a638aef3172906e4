"""The port's SLO burn-rate detector, flight recorder, timeline collector
and cross-process trace context (``smartcal_tpu_torch/obs/{slo,flightrec,
collect,tracectx}.py``) against the JAX package's
(``smartcal_tpu/obs``), on the same event streams and injected clocks:
the cases of tests/test_trace.py, each run through both packages, whose
outputs must be equal."""

import json
import os

import pytest

from smartcal_tpu import obs as jobs
from smartcal_tpu.obs import collect as jcollect
from smartcal_tpu.obs import tracectx as jtracectx
from smartcal_tpu.obs.flightrec import FlightRecorder as JaxRecorder
from smartcal_tpu_torch import obs as tobs
from smartcal_tpu_torch.obs import collect as tcollect
from smartcal_tpu_torch.obs import tracectx as ttracectx
from smartcal_tpu_torch.obs.flightrec import FlightRecorder as PortRecorder

PACKAGES = {"jax": (jobs, jcollect, jtracectx, JaxRecorder),
            "port": (tobs, tcollect, ttracectx, PortRecorder)}


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


def _read_jsonl(path):
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def _both(fn):
    """``fn(obs, collect, tracectx, FlightRecorder)`` through each package;
    returns {package: result}."""
    return {name: fn(*mods) for name, mods in PACKAGES.items()}


# ---------------------------------------------------------------------------
# trace context
# ---------------------------------------------------------------------------

def test_carrier_shapes_and_lineage():
    def run(obs, collect, tracectx, _):
        car = tracectx.new_root_carrier()
        assert len(car["trace"]) == 32 and len(car["span"]) == 16
        int(car["trace"], 16), int(car["span"], 16)
        assert tracectx.fields_of(car) == {"trace": car["trace"],
                                           "span": car["span"]}
        cf = tracectx.child_fields(car)
        assert cf["trace"] == car["trace"] and cf["parent"] == car["span"]
        assert len(cf["span"]) == 16 and cf["span"] != car["span"]
        # a fixed carrier gives the same fields in both packages
        fixed = {"trace": "ab" * 16, "span": "cd" * 8}
        child = tracectx.child_fields(fixed)
        return (tracectx.fields_of(fixed),
                {k: v for k, v in child.items() if k != "span"},
                tracectx.fields_of(None), tracectx.child_fields({}),
                tracectx.fields_of({"span": "x"}))

    out = _both(run)
    assert out["port"] == out["jax"]


def test_use_trace_adoption_and_noop_contract():
    def run(obs, collect, tracectx, _):
        seen = [tracectx.current_fields(), tracectx.carrier(),
                tracectx.push_span()]
        car = {"trace": "ef" * 16, "span": "01" * 8}
        with tracectx.use_trace(car):
            seen.append(dict(tracectx.current_fields()))
            seen.append(tracectx.carrier())
            sid, parent = tracectx.push_span()
            seen.append(parent)
            assert tracectx.current_fields()["span"] == sid
            tracectx.pop_span(sid)
            seen.append(dict(tracectx.current_fields()))
            env = tracectx.envelope()
            seen.append({k: v for k, v in env.items() if k != "t"})
            assert isinstance(env["t"], float)
        seen.append(tracectx.current_fields())
        seen.append({k for k in tracectx.envelope()})
        return seen

    out = _both(run)
    assert out["port"] == out["jax"]
    assert out["port"][:3] == [{}, None, None]


def test_runlog_auto_attaches_adopted_trace():
    car = {"trace": "12" * 16, "span": "34" * 8}

    def run(obs, collect, tracectx, _):
        path = f"trace_rl_{obs.__name__}.jsonl"
        with obs.recording(path, run_id="t") as rl:
            with tracectx.use_trace(car):
                rl.log("traced_evt", x=1)
            rl.log("plain_evt")
        recs = {r["event"]: r for r in _read_jsonl(path)}
        return ({k: recs["traced_evt"].get(k) for k in ("trace", "span",
                                                        "x")},
                "trace" in recs["plain_evt"])

    out = _both(run)
    assert out["port"] == out["jax"] == ({"trace": car["trace"],
                                          "span": car["span"], "x": 1},
                                         False)


# ---------------------------------------------------------------------------
# SLO burn-rate detector (injected clock)
# ---------------------------------------------------------------------------

def test_slo_fire_localize_clear():
    def run(obs, *_):
        det = obs.SloBurnDetector(p99_target_s=0.1, fast_window_s=10.0,
                                  slow_window_s=20.0, sustain_s=2.0,
                                  clear_sustain_s=3.0, min_samples=5)
        for i in range(8):
            det.observe(latency_s=0.5, replica=1, now=0.5 + 0.05 * i)
            det.observe(latency_s=0.05, replica=0, now=0.5 + 0.05 * i)
        evs = [det.evaluate(now=1.0), det.evaluate(now=3.5)]
        snaps = [det.snapshot(now=3.5)]
        for i in range(6):
            det.observe(latency_s=0.01, replica=1, now=24.0 + 0.2 * i)
        evs += [det.evaluate(now=26.0), det.evaluate(now=29.5)]
        snaps.append(det.snapshot(now=29.5))
        return evs, snaps

    out = _both(run)
    assert out["port"] == out["jax"]
    (e0, fire, e2, clear), (s0, s1) = out["port"]
    assert e0 is None and fire["state"] == "firing"
    assert fire["worst_replica"] == 1 and fire["burn_fast"] >= 2.0
    assert s0["firing"] and e2 is None and clear["state"] == "cleared"
    assert not s1["firing"] and s1["transitions"] == 2


def test_slo_min_samples_and_shed_burn():
    def run(obs, *_):
        det = obs.SloBurnDetector(p99_target_s=0.1, min_samples=20,
                                  sustain_s=0.0)
        for i in range(5):
            det.observe(latency_s=9.9, now=float(i) * 0.1)
        quiet = (det.evaluate(now=1.0), det.firing)
        det2 = obs.SloBurnDetector(p99_target_s=0.1, shed_target=0.02,
                                   min_samples=5, sustain_s=1.0)
        for i in range(10):
            det2.observe(shed=True, now=0.1 * i)
        return quiet, det2.evaluate(now=1.0), det2.evaluate(now=2.5)

    out = _both(run)
    assert out["port"] == out["jax"]
    quiet, pending, fire = out["port"]
    assert quiet == (None, False) and pending is None
    assert fire["state"] == "firing" and fire["shed_rate_fast"] == 1.0


# ---------------------------------------------------------------------------
# flight recorder
# ---------------------------------------------------------------------------

def _strip(recs):
    """Dump records without the per-process and wall-clock fields."""
    return [{k: v for k, v in r.items() if k not in ("t", "pid")}
            for r in recs]


def test_flight_recorder_ring_flush_and_rate_limit(tmp_path):
    def run(obs, collect, tracectx, Recorder):
        d = str(tmp_path / obs.__name__ / "bb")
        fr = Recorder()
        armed0 = fr.armed
        fr.record_line('{"dropped": true}\n')
        fr.arm(d, capacity=4)
        for i in range(6):
            fr.record_line(json.dumps({"i": i}) + "\n")
        st = fr.stats()
        path = fr.flush("crash", {"error": "boom"})
        again = fr.flush("crash")
        other = fr.flush("watchdog_trip")
        fr.disarm()
        after = (fr.flush("crash"), fr.armed)
        return (armed0, st, os.path.basename(path), again, other == path,
                after, _strip(_read_jsonl(path)))

    out = _both(run)
    assert out["port"] == out["jax"]
    armed0, st, name, again, same, after, recs = out["port"]
    assert not armed0 and st == {"armed": True, "depth": 4, "flushes": 0}
    assert name == f"blackbox_{os.getpid()}.jsonl" and again is None
    assert same and after == (None, False)
    assert recs[0]["reason"] == "crash" and recs[0]["n_events"] == 4
    assert [r["i"] for r in recs[1:5]] == [2, 3, 4, 5]
    assert recs[5]["reason"] == "watchdog_trip"


def test_flight_recorder_shed_burst_triggers_dump(tmp_path):
    def run(obs, collect, tracectx, Recorder):
        d = str(tmp_path / obs.__name__ / "bb")
        fr = Recorder()
        fr.arm(d, capacity=8)
        fr.record_line('{"event": "x"}\n')
        for i in range(7):
            fr.note_shed(now=10.0 + 0.1 * i)
        before = fr.stats()["flushes"]
        fr.note_shed(now=10.8)
        hdr = _read_jsonl(os.path.join(d, f"blackbox_{os.getpid()}.jsonl"))
        return before, fr.stats()["flushes"], _strip(hdr)

    out = _both(run)
    assert out["port"] == out["jax"]
    before, after, recs = out["port"]
    assert (before, after) == (0, 1)
    assert recs[0]["reason"] == "shed_burst"
    assert recs[0]["sheds_in_window"] == 8


def test_runlog_tees_into_the_flight_recorder_and_watchdog_flushes(
        tmp_path):
    """The port's RunLog tees every line into the armed recorder, and a
    watchdog trip dumps it (the JAX package's wiring)."""
    d = str(tmp_path / "bb")
    tobs.arm_flight_recorder(d, capacity=16)
    try:
        with tobs.recording(str(tmp_path / "run.jsonl"), run_id="r") as rl:
            rl.log("before_trip", x=1)
            wd = tobs.Watchdog()
            assert wd.observe({"critic_loss": float("nan"), "step": 3})
        assert tobs.flight_recorder_stats()["flushes"] >= 1
        recs = _read_jsonl(os.path.join(d, f"blackbox_{os.getpid()}.jsonl"))
        # the trip's reason rides the dump header (the JAX package's extra)
        assert recs[0]["event"] == "blackbox_flush"
        assert recs[0]["reason"] == "non_finite:critic_loss"
        assert "before_trip" in {r.get("event") for r in recs[1:]}
    finally:
        from smartcal_tpu_torch.obs import flightrec
        flightrec.disarm()


# ---------------------------------------------------------------------------
# timeline collection
# ---------------------------------------------------------------------------

def test_discover_streams_rotation_order_and_exclusions(tmp_path):
    d = str(tmp_path / "run")
    os.makedirs(d)
    for name in ("r.jsonl", "r.jsonl.1", "r.jsonl.2", "s.jsonl",
                 "blackbox_123.jsonl", "notes.txt"):
        with open(os.path.join(d, name), "w") as fh:
            fh.write("")

    def run(obs, collect, *_):
        streams = collect.discover_streams(d)
        return ({k: [os.path.basename(p) for p in v]
                 for k, v in streams.items()},
                collect.discover_streams(str(tmp_path / "missing")))

    out = _both(run)
    assert out["port"] == out["jax"]
    assert out["port"][0]["r.jsonl"] == ["r.jsonl.1", "r.jsonl.2",
                                         "r.jsonl"]


def test_read_stream_proc_naming_and_corrupt_tolerance(tmp_path):
    p = str(tmp_path / "replica0-g0.jsonl")
    with open(p, "w") as fh:
        fh.write(json.dumps({"event": "run_header",
                             "run_id": "replica0"}) + "\n")
        fh.write(json.dumps({"event": "x", "t": 1.0}) + "\n")
        fh.write('{"torn tail\n')
        fh.write("3\n")
    q = str(tmp_path / "router.jsonl")
    with open(q, "w") as fh:
        fh.write(json.dumps({"event": "y", "t": 2.0}) + "\n")

    out = _both(lambda obs, collect, *_: (collect.read_stream([p]),
                                          collect.read_stream([q])))
    assert out["port"] == out["jax"]
    (proc, events, bad), (proc_q, _, _) = out["port"]
    assert proc == "replica0" and bad == 2 and len(events) == 2
    assert proc_q == "router"


def _router_stream(trace):
    return [
        {"t": 100.0, "event": "clock_offset", "peer": "replica0",
         "offset_s": 4.5},
        {"t": 100.0, "event": "fleet_dispatch", "job_id": 7,
         "trace": trace, "span": "a" * 16, "requeue": False},
        {"t": 101.0, "event": "fleet_result", "job_id": 7,
         "trace": trace, "total_s": 0.8},
    ]


def _replica_stream(trace):
    return [
        {"t": 95.7, "event": "serve_admit", "trace": trace,
         "replica": 0, "requeues": 0},
        {"t": 96.0, "event": "serve_request", "trace": trace,
         "queue_wait_s": 0.05, "service_s": 0.5, "total_s": 0.8,
         "batch": 3},
        {"t": 96.1, "event": "span", "name": "serve_solve",
         "batch": 3, "dur_s": 0.4},
    ]


def test_merge_applies_clock_offset_and_paths_reconstruct():
    T = "ff" * 16

    def run(obs, collect, *_):
        m = collect.TimelineMerger()
        m.add_stream("router", _router_stream(T))
        m.add_stream("replica0", _replica_stream(T))
        merged = m.merge()
        paths = collect.request_paths(merged)
        return (m.offsets(), merged, paths,
                collect.completeness(paths, require_stages=True),
                m.stats())

    out = _both(run)
    assert out["port"] == out["jax"]
    offsets, merged, paths, comp, _ = out["port"]
    assert offsets == {"replica0": 4.5}
    admit = next(e for e in merged if e["event"] == "serve_admit")
    assert admit["t_corr"] == pytest.approx(100.2)
    (p,) = paths
    assert p["ipc_s"] == pytest.approx(0.2) and p["solve_s"] == 0.4
    assert comp == {"n_requests": 1, "n_completed": 1,
                    "n_complete_trees": 1, "fraction": 1.0}


def test_request_paths_requeue_keeps_trace_and_scores():
    T, U = "aa" * 16, "bb" * 16
    router = [
        {"t": 10.0, "event": "fleet_dispatch", "trace": T,
         "job_id": 1, "requeue": False},
        {"t": 10.5, "event": "fleet_dispatch", "trace": T,
         "job_id": 1, "requeue": True},
        {"t": 11.0, "event": "fleet_result", "trace": T, "job_id": 1},
        {"t": 12.0, "event": "fleet_dispatch", "trace": U, "job_id": 2},
        {"t": 12.4, "event": "fleet_result", "trace": U, "job_id": 2},
    ]
    replica1 = [
        {"t": 10.6, "event": "serve_admit", "trace": T, "replica": 1,
         "requeues": 1},
        {"t": 10.7, "event": "serve_request", "trace": T,
         "total_s": 0.4},
    ]

    def run(obs, collect, *_):
        m = collect.TimelineMerger()
        m.add_stream("router", router)
        m.add_stream("replica1", replica1)
        paths = collect.request_paths(m.merge())
        return paths, collect.completeness(paths)

    out = _both(run)
    assert out["port"] == out["jax"]
    paths, comp = out["port"]
    p = {q["trace"]: q for q in paths}[T]
    assert p["requeued"] and p["requeues"] == 1 and p["dispatches"] == 2
    assert p["ipc_s"] == pytest.approx(0.1)
    assert comp["n_completed"] == 2 and comp["fraction"] == 0.5


def test_merge_directory_of_written_streams(tmp_path):
    """Streams written by each package's RunLog under the same adopted
    trace merge into the same request path."""
    T = "cd" * 16

    def run(obs, collect, tracectx, _):
        d = str(tmp_path / obs.__name__)
        os.makedirs(d)
        with obs.recording(os.path.join(d, "router.jsonl"),
                           run_id="router") as rl:
            rl.log("fleet_dispatch", job_id=1, trace=T, span="e" * 16)
            rl.log("fleet_result", job_id=1, trace=T, total_s=0.3)
        with obs.recording(os.path.join(d, "replica0-g0.jsonl"),
                           run_id="replica0") as rl:
            with tracectx.use_trace({"trace": T, "span": "e" * 16}):
                rl.log("serve_admit", job_id=1, replica=0, requeues=0)
                rl.log("serve_request", job_id=1, total_s=0.3,
                       queue_wait_s=0.01, service_s=0.2, batch=1)
        paths = collect.request_paths(collect.merge_directory(d))
        # wall-clock fields differ between the two runs
        return [{k: v for k, v in p.items()
                 if not k.endswith("_s") and not k.startswith("t_")}
                for p in paths], collect.completeness(paths)

    out = _both(run)
    assert out["port"] == out["jax"]
    assert out["port"][1]["fraction"] == 1.0
