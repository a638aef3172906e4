"""The port's perf gate (``python -m smartcal_tpu_torch.tools.perf_gate``)
on the CPU at K=2: bless then gate without a FIRE, each fault hook firing
on its own stage alone, a baseline from another host fingerprint read as
NO BASELINE, and the usage errors (exit code 2).  Its stages, CLI, exit
codes and fault hooks are the JAX gate's (tools/perf_gate.py).

The gate's clock is a fake one here (every rep 10 ms, a fault's sleep
added to it), so one warm rep and one rep per sample do: a shared CPU's
timing noise is the card run's business (``chip_smoke.py``), the gate's
logic is this file's."""

import json
import types

import pytest
import torch

from smartcal_tpu_torch.obs import baselines as bl
from smartcal_tpu_torch.runtime import faults
from smartcal_tpu_torch.tools import perf_gate


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.005          # two reads per rep: 10 ms a rep
        return self.t

    def sleep(self, s):
        self.t += s


@pytest.fixture(scope="module", autouse=True)
def clock():
    c = FakeClock()
    mp = pytest.MonkeyPatch()
    mp.setattr(perf_gate, "time", types.SimpleNamespace(
        perf_counter=c.perf_counter, time=c.perf_counter))
    mp.setattr(faults, "time", types.SimpleNamespace(sleep=c.sleep))
    mp.setattr(perf_gate, "WARM_REPS", 1)
    mp.setattr(perf_gate, "SUB_REPS", 1)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)          # tiny ops: threads only contend
    yield c
    torch.set_num_threads(threads)
    mp.undo()


@pytest.fixture(scope="module")
def blessed(tmp_path_factory):
    d = tmp_path_factory.mktemp("gate")
    store = str(d / "store.json")
    out = str(d / "bless.json")
    rc = perf_gate.main(["--device", "cpu", "--samples", "2", "--baseline",
                         store, "--update-baseline", "--out", out])
    return rc, store, json.load(open(out))


def _gate(store, tmp_path, tag, *extra, fault=None, monkeypatch=None):
    if fault is not None:
        monkeypatch.setenv("SMARTCAL_FAULTS", json.dumps(fault))
    out = str(tmp_path / f"{tag}.json")
    try:
        rc = perf_gate.main(["--device", "cpu", "--samples", "2",
                             "--baseline", store, "--out", out] + list(extra))
    finally:
        faults.clear()
    doc = json.load(open(out))
    fired = {(f["stage"], f["metric"]) for f in doc["findings"]
             if f["verdict"] == "FIRE"}
    return rc, doc, fired


def test_bless_then_gate_clean(blessed, tmp_path):
    rc, store, doc = blessed
    assert rc == 0 and doc["updated"]
    assert set(doc["stages"]) == set(perf_gate.STAGE_NAMES)
    for name, st in doc["stages"].items():
        m = st["metrics"]
        assert m["wall_s"]["n"] == 2 and m["compile_events"]["value"] == 0
        assert m["flops"]["value"] > 0 and m["peak_bytes"]["value"] > 0
        assert st["statics"]["device"] == "cpu"
        assert st["graph_captures_per_rep"] == 0      # no graphs on the CPU
    rc, doc, fired = _gate(store, tmp_path, "clean")
    assert rc == 0 and not fired and doc["fires"] == 0
    verdicts = {(f["stage"], f["metric"]): f["verdict"]
                for f in doc["findings"]}
    assert verdicts[("imager", "rel_err")] == "OK"
    assert verdicts[("influence", "flops")] == "OK"


@pytest.mark.parametrize("stage,fault,metric", [
    ("solve", {"delay_stage": "gate_solve", "delay_at": 0, "delay_span": 2,
               "delay_s": 1.0}, "wall_s"),
    ("imager", {"perturb_stage": "gate_numeric_imager", "perturb_at": 0,
                "perturb_rel": 0.5}, "rel_err"),
    ("influence", {"perturb_stage": "gate_numeric_influence",
                   "perturb_at": 0, "perturb_rel": -0.5}, "rel_err")])
def test_fault_hooks_fire_on_their_stage(blessed, tmp_path, monkeypatch,
                                         stage, fault, metric):
    _, store, _ = blessed
    other = "imager" if stage != "imager" else "influence"
    rc, _, fired = _gate(store, tmp_path, stage, "--stages",
                         f"{stage},{other}", fault=fault,
                         monkeypatch=monkeypatch)
    assert rc == 1 and fired == {(stage, metric)}


def test_other_fingerprint_is_no_baseline(blessed, tmp_path, monkeypatch):
    _, store, _ = blessed
    fp = dict(bl.host_fingerprint(), nproc=bl.host_fingerprint()["nproc"] + 1)
    monkeypatch.setattr(bl, "host_fingerprint", lambda: fp)
    rc, doc, fired = _gate(store, tmp_path, "other", "--stages", "imager")
    assert rc == 0 and not fired
    assert {f["verdict"] for f in doc["findings"]
            if f["metric"] != "rel_err"} == {"NO BASELINE"}


def test_usage_errors(tmp_path, capsys):
    assert perf_gate.main(["--stages", "serve_stream", "--device",
                           "cpu"]) == 2
    assert "unknown stage" in capsys.readouterr().err
    assert perf_gate.main(["--device", "cuda:7", "--baseline",
                           str(tmp_path / "s.json")]) == 2
