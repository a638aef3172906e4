"""The port's baseline store and noise-aware detector
(``smartcal_tpu_torch.obs.baselines`` / ``regress``) against the claims of
tests/test_perf_radar.py and against the JAX package's modules.

* keyed by host: a lookup from another host or shape finds no baseline,
  an explicit cross-fingerprint compare raises, and a JAX package entry
  (another fingerprint by design) is no baseline for the port;
* seeded regressions fire, with the measured delta and the noise band;
* noise does not fire;
* schema or refuse;
* parity: on the same sample lists both packages' ``compare_entry`` give
  the same verdicts, deltas and bootstrap intervals (both are standard
  library code with the same seeded bootstrap, so they are held exactly).

Host-side logic only: runs in milliseconds.
"""

import json
import random

import pytest

from smartcal_tpu.obs import baselines as jbl
from smartcal_tpu.obs import regress as jrg
from smartcal_tpu_torch import obs
from smartcal_tpu_torch.obs import baselines as bl
from smartcal_tpu_torch.obs import regress as rg

FP_A = {"nproc": 1, "platform": "linux", "machine": "x86_64",
        "python": "3.12.12", "torch": "2.11.0+cu128", "cuda": "12.8",
        "device": "NVIDIA H100 80GB HBM3",
        "dtype_policy": {"tf32": False, "bf16_rel_band": bl.BF16_REL_BAND}}
FP_B = dict(FP_A, nproc=24)            # same box, different cgroup
STATICS = {"stage": "influence", "n_stations": 6, "npix": 32,
           "precision": "bf16"}


def _samples(mean, cv, n=5, seed=42):
    rng = random.Random(seed)
    return [max(1e-9, rng.gauss(mean, cv * mean)) for _ in range(n)]


def _metrics(mod, wall_mean=1.0, cv=0.02):
    return {"wall_s": mod.summarize_samples(_samples(wall_mean, cv)),
            "peak_bytes": mod.scalar_metric(1.0e6),
            "flops": mod.scalar_metric(2.0e7),
            "compile_events": mod.scalar_metric(0.0)}


def _baseline_store(tmp_path, mod=bl, name="base.json"):
    store = mod.BaselineStore(str(tmp_path / name))
    store.record("influence", STATICS, FP_A, _metrics(mod))
    return store


# -- the store ---------------------------------------------------------------

def test_band_and_schema_are_the_jax_packages():
    assert bl.BF16_REL_BAND == jbl.BF16_REL_BAND == 2e-2
    assert bl.SCHEMA_VERSION == jbl.SCHEMA_VERSION
    assert obs.BF16_REL_BAND is bl.BF16_REL_BAND
    assert obs.BaselineStore is bl.BaselineStore
    for fp in (FP_A, FP_B):
        assert bl.fingerprint_digest(fp) == jbl.fingerprint_digest(fp)
        assert bl.baseline_key("s", STATICS, fp) \
            == jbl.baseline_key("s", STATICS, fp)


def test_round_trip_through_disk(tmp_path):
    store = _baseline_store(tmp_path)
    assert store.save() is True
    assert store.save() is False        # not dirty
    again = bl.BaselineStore(store.path)
    ent = again.get("influence", STATICS, FP_A)
    assert ent is not None
    assert ent["metrics"]["wall_s"]["n"] == 5
    assert ent["fingerprint_digest"] == bl.fingerprint_digest(FP_A)


def test_lookup_is_fingerprint_scoped(tmp_path):
    store = _baseline_store(tmp_path)
    assert store.get("influence", STATICS, FP_B) is None
    assert store.get("influence", dict(STATICS, npix=64), FP_A) is None
    assert store.get("solve", STATICS, FP_A) is None


@pytest.mark.parametrize("text", [
    "{not json",
    json.dumps({"schema": 999, "entries": {}}),
    json.dumps({"schema": bl.SCHEMA_VERSION, "entries": {
        "k": {"stage": "s", "statics": {}, "fingerprint": {},
              "metrics": {"wall_s": {"kind": "mystery"}}}}}),
    json.dumps({"schema": bl.SCHEMA_VERSION, "entries": {
        "k": {"stage": "s", "statics": {}, "metrics": {}}}}),
    json.dumps({"schema": bl.SCHEMA_VERSION, "entries": {
        "k": {"stage": "s", "statics": {}, "fingerprint": {},
              "metrics": {"wall_s": {"kind": "samples", "samples": []}}}}}),
], ids=["corrupt", "schema", "kind", "field", "no-samples"])
def test_malformed_document_refuses(tmp_path, text):
    p = tmp_path / "base.json"
    p.write_text(text)
    with pytest.raises(bl.BaselineSchemaError):
        bl.BaselineStore(str(p)).entries()


def test_record_rejects_raw_metric_dicts(tmp_path):
    store = bl.BaselineStore(str(tmp_path / "b.json"))
    with pytest.raises(bl.BaselineSchemaError):
        store.record("s", {}, FP_A, {"wall_s": {"value": 1.0}})
    with pytest.raises(ValueError):
        bl.summarize_samples([])


def test_host_fingerprint_names_what_the_port_depends_on():
    import torch

    fp1, fp2 = bl.host_fingerprint(), bl.host_fingerprint()
    assert bl.fingerprint_digest(fp1) == bl.fingerprint_digest(fp2)
    assert fp1["torch"] == torch.__version__
    assert fp1["cuda"] == torch.version.cuda
    assert fp1["dtype_policy"] == {
        "tf32": torch.backends.cuda.matmul.allow_tf32,
        "bf16_rel_band": bl.BF16_REL_BAND}
    assert fp1["dtype_policy"]["tf32"] is False   # off at package import
    assert fp1["nproc"] >= 1 and "jax" not in fp1
    if not torch.cuda.is_initialized():
        assert fp1["device"] is None
    assert bl.fingerprint_digest(FP_A) != bl.fingerprint_digest(FP_B)


def test_jax_store_entry_is_another_fingerprint(tmp_path):
    """A JAX package entry is no baseline for the port's host, and an
    explicit compare against it is refused."""
    jstore = jbl.BaselineStore(str(tmp_path / "jax.json"))
    jstore.record("influence", STATICS, jbl.host_fingerprint(),
                  _metrics(jbl))
    assert jstore.save()
    store = bl.BaselineStore(jstore.path)
    fp = bl.host_fingerprint()
    measured = {"wall_s": bl.summarize_samples(_samples(1.0, 0.02))}
    fs = rg.compare(store, "influence", STATICS, fp, measured)
    assert [f.verdict for f in fs] == [rg.NO_BASELINE]
    (entry,) = store.entries()
    with pytest.raises(rg.FingerprintMismatch):
        rg.compare_entry(entry, "influence", STATICS, fp, measured)


# -- the detector ------------------------------------------------------------

def test_seeded_regressions_fire_with_delta_and_band(tmp_path):
    store = _baseline_store(tmp_path)
    measured = {
        "wall_s": bl.summarize_samples(
            [2.0 * s for s in _samples(1.0, 0.02, seed=7)]),
        "peak_bytes": bl.scalar_metric(1.3e6),
        "flops": bl.scalar_metric(2.0e7),
        "compile_events": bl.scalar_metric(0.0),
        "rel_err": bl.scalar_metric(5e-2),
        "rel_err_std": bl.scalar_metric(1.5e-2),
    }
    fs = {f.metric: f for f in rg.compare(store, "influence", STATICS, FP_A,
                                          measured)}
    assert fs["wall_s"].verdict == rg.FIRE
    assert fs["wall_s"].delta_rel == pytest.approx(1.0, abs=0.15)
    assert fs["wall_s"].ci95[0] > 1.15
    assert fs["peak_bytes"].verdict == rg.FIRE
    assert fs["peak_bytes"].delta_rel == pytest.approx(0.3, abs=1e-6)
    assert fs["rel_err"].verdict == rg.FIRE
    assert fs["rel_err_std"].verdict == rg.WARN    # above half the band
    assert fs["flops"].verdict == rg.OK
    for f in fs.values():
        assert f.stage == "influence" and "noise" in f.render()
    assert rg.worst_verdict(list(fs.values())) == rg.FIRE


def test_same_distribution_resamples_never_fire(tmp_path):
    store = _baseline_store(tmp_path)
    fired = []
    for trial in range(40):
        measured = {
            "wall_s": bl.summarize_samples(
                _samples(1.0, 0.02, seed=1000 + trial)),
            "peak_bytes": bl.scalar_metric(1.0e6),
            "compile_events": bl.scalar_metric(0.0),
        }
        fired += [(trial, f.render()) for f in rg.compare(
            store, "influence", STATICS, FP_A, measured, seed=trial)
            if f.verdict == rg.FIRE]
    assert fired == []


def test_improvement_never_fires(tmp_path):
    store = _baseline_store(tmp_path)
    measured = {"wall_s": bl.summarize_samples(
        [0.5 * s for s in _samples(1.0, 0.02, seed=9)]),
        "peak_bytes": bl.scalar_metric(0.5e6),
        "rel_err": bl.scalar_metric(1e-3)}
    assert all(f.verdict == rg.OK for f in rg.compare(
        store, "influence", STATICS, FP_A, measured))


def test_any_recompile_fires(tmp_path):
    store = _baseline_store(tmp_path)
    fs = rg.compare(store, "influence", STATICS, FP_A,
                    {"compile_events": bl.scalar_metric(1.0)})
    assert [f.verdict for f in fs] == [rg.FIRE]


@pytest.mark.parametrize("fp,statics", [(FP_B, STATICS),
                                        (FP_A, dict(STATICS, npix=64))],
                         ids=["host", "statics"])
def test_cross_fingerprint_or_statics_compare_raises(tmp_path, fp, statics):
    entry = _baseline_store(tmp_path).get("influence", STATICS, FP_A)
    with pytest.raises(rg.FingerprintMismatch):
        rg.compare_entry(entry, "influence", statics, fp,
                         {"wall_s": bl.summarize_samples([1.0])})


def test_fresh_host_is_no_baseline_but_the_band_applies(tmp_path):
    store = _baseline_store(tmp_path)
    fs = {f.metric: f for f in rg.compare(
        store, "influence", STATICS, FP_B,
        {"wall_s": bl.summarize_samples(_samples(99.0, 0.02)),
         "rel_err": bl.scalar_metric(5e-2)})}
    assert fs["wall_s"].verdict == rg.NO_BASELINE
    assert fs["rel_err"].verdict == rg.FIRE
    assert rg.worst_verdict(list(fs.values())) == rg.FIRE
    assert rg.worst_verdict([]) == rg.OK


def test_bootstrap_ci_is_deterministic():
    a = _samples(2.0, 0.05, seed=3)
    b = _samples(1.0, 0.05, seed=4)
    assert rg.bootstrap_ratio_ci(a, b, seed=5) == \
        rg.bootstrap_ratio_ci(a, b, seed=5)
    lo, hi = rg.bootstrap_ratio_ci(a, b, seed=5)
    assert 1.5 < lo <= hi < 2.5


def test_policies_are_the_jax_packages():
    for name in ("wall_s", "peak_bytes", "flops", "compile_events",
                 "rel_err", "rel_err_img", "something_else"):
        assert rg.policy_for(name).__dict__ == jrg.policy_for(name).__dict__


# -- parity with the JAX package's detector ----------------------------------

@pytest.mark.parametrize("scale,cv,seed", [(1.0, 0.02, 1), (1.2, 0.05, 2),
                                           (2.0, 0.02, 3), (0.7, 0.10, 4),
                                           (1.45, 0.3, 5)])
def test_compare_entry_matches_jax(tmp_path, scale, cv, seed):
    """Both packages judge the same sample lists with the same verdicts,
    deltas and bootstrap intervals, bit for bit."""
    store = _baseline_store(tmp_path)
    jstore = _baseline_store(tmp_path, jbl, "jax.json")
    wall = [scale * s for s in _samples(1.0, cv, seed=100 + seed)]
    measured, jmeasured = ({
        "wall_s": mod.summarize_samples(wall),
        "peak_bytes": mod.scalar_metric(1.0e6 * scale),
        "flops": mod.scalar_metric(2.0e7 * (2.0 - scale)),
        "compile_events": mod.scalar_metric(float(seed % 2)),
        "rel_err_img": mod.scalar_metric(0.01 * scale * cv * 10),
    } for mod in (bl, jbl))
    out = rg.compare_entry(store.get("influence", STATICS, FP_A),
                           "influence", STATICS, FP_A, measured, seed=seed)
    ref = jrg.compare_entry(jstore.get("influence", STATICS, FP_A),
                            "influence", STATICS, FP_A, jmeasured, seed=seed)
    assert [(f.metric, f.verdict, f.delta_rel, f.new_value, f.base_value,
             f.noise_band, f.ci95) for f in out] == \
        [(f.metric, f.verdict, f.delta_rel, f.new_value, f.base_value,
          f.noise_band, f.ci95) for f in ref]
    assert [f.render() for f in out] == [f.render() for f in ref]
    assert rg.worst_verdict(out) == jrg.worst_verdict(ref)
