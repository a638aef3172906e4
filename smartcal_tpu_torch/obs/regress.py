"""Noise-aware change detection over fingerprinted baselines (counterpart
of smartcal_tpu/obs/regress.py, with the same verdicts).

The compare half of the regression radar (store half: :mod:`.baselines`).
Two rules:

1. **Cross-fingerprint comparisons are refused, not attempted.**  A
   comparison between measurements from different hosts (core count,
   platform, torch and CUDA versions, device, dtype policy) or different
   statics raises :class:`FingerprintMismatch`.

2. **A regression is a claim about distributions, not two numbers.**
   Sampled metrics (wall time) are compared by bootstrap: resample both
   sample sets, take the ratio-of-means distribution, and FIRE only when
   the measured relative delta exceeds the threshold AND the CI is
   separated from the warn line, so a single noisy sample cannot fire,
   and every finding carries the measured delta and the noise band it was
   judged against.

Deterministic metrics (peak bytes, flops, compile counts) compare as
scalars with their own relative thresholds; numeric drift metrics
(``rel_err*``) compare against the bf16 band (``BF16_REL_BAND``) as an
absolute ceiling, which applies on a host with no baseline too.
Improvements never FIRE: the radar is one-sided.

Standard library only (a ``random.Random`` bootstrap with a fixed seed,
the JAX package's, so both give the same verdicts on the same samples).
"""

import dataclasses
import random
import statistics
from typing import Dict, List, Optional, Tuple

from .baselines import (BF16_REL_BAND, BaselineStore,
                        fingerprint_digest, statics_digest)

FIRE = "FIRE"
WARN = "WARN"
OK = "OK"
NO_BASELINE = "NO BASELINE"


class FingerprintMismatch(ValueError):
    """Baseline and measurement come from different hosts or statics:
    the detector refuses to compare them."""


@dataclasses.dataclass
class Policy:
    """Per-metric comparison policy.  ``kind``:

    * ``"sampled"`` — bootstrap ratio-of-means CI; FIRE needs delta >
      fire_rel AND ci_lo > 1 + warn_rel (CI separation from the warn
      line, so noise alone cannot fire).
    * ``"scalar"`` — deterministic value; plain relative thresholds.
    * ``"band"`` — absolute ceiling (numeric drift against the bf16
      band); FIRE when the measured value exceeds ``band``, WARN above
      half of it.
    """
    kind: str
    warn_rel: float = 0.15
    fire_rel: float = 0.40
    band: float = BF16_REL_BAND


#: Default policies by metric name.  The wall_s thresholds are loose on
#: purpose: small stages' host timings vary by up to ~10%, and the job is
#: catching 2x slowdowns, not 5% drifts (those show as WARN).
DEFAULT_POLICIES: Dict[str, Policy] = {
    "wall_s": Policy("sampled", warn_rel=0.15, fire_rel=0.40),
    "peak_bytes": Policy("scalar", warn_rel=0.05, fire_rel=0.25),
    "flops": Policy("scalar", warn_rel=0.01, fire_rel=0.10),
    "compile_events": Policy("scalar", warn_rel=0.0, fire_rel=0.0),
    "rel_err": Policy("band"),
}


def policy_for(metric: str,
               overrides: Optional[Dict[str, Policy]] = None) -> Policy:
    table = dict(DEFAULT_POLICIES)
    if overrides:
        table.update(overrides)
    if metric in table:
        return table[metric]
    if metric.startswith("rel_err"):
        return table["rel_err"]
    return Policy("scalar")


@dataclasses.dataclass
class Finding:
    stage: str
    metric: str
    verdict: str
    delta_rel: Optional[float]        # (new - base) / base, None w/o base
    new_value: float
    base_value: Optional[float]
    noise_band: str                   # human-readable band it was judged in
    ci95: Optional[Tuple[float, float]] = None  # ratio CI (sampled only)

    def render(self) -> str:
        d = ("n/a" if self.delta_rel is None
             else f"{self.delta_rel:+.1%}")
        ci = (f" ci95=[{self.ci95[0]:.3f},{self.ci95[1]:.3f}]x"
              if self.ci95 else "")
        base = ("-" if self.base_value is None
                else f"{self.base_value:.6g}")
        return (f"[{self.verdict:>11s}] {self.stage}.{self.metric}: "
                f"{self.new_value:.6g} vs base {base} (delta {d}, "
                f"noise {self.noise_band}{ci})")


def bootstrap_ratio_ci(new: List[float], base: List[float],
                       n_boot: int = 2000, seed: int = 0,
                       pct: Tuple[float, float] = (2.5, 97.5),
                       ) -> Tuple[float, float]:
    """Percentile CI over mean(new*)/mean(base*) under resampling with
    replacement.  Deterministic for a given seed."""
    rng = random.Random(seed)
    nn, nb = len(new), len(base)
    ratios = []
    for _ in range(n_boot):
        mn = statistics.fmean(new[rng.randrange(nn)] for _ in range(nn))
        mb = statistics.fmean(base[rng.randrange(nb)] for _ in range(nb))
        ratios.append(mn / mb if mb else float("inf"))
    ratios.sort()

    def q(p: float) -> float:
        i = min(len(ratios) - 1, max(0, int(round(
            p / 100.0 * (len(ratios) - 1)))))
        return ratios[i]

    return q(pct[0]), q(pct[1])


def _compare_sampled(stage: str, metric: str, pol: Policy,
                     new_m: Dict[str, object], base_m: Dict[str, object],
                     seed: int) -> Finding:
    new_s = [float(x) for x in new_m["samples"]]
    base_s = [float(x) for x in base_m["samples"]]
    mean_new = statistics.fmean(new_s)
    mean_base = statistics.fmean(base_s)
    delta = mean_new / mean_base - 1.0 if mean_base else float("inf")
    lo, hi = bootstrap_ratio_ci(new_s, base_s, seed=seed)
    cv = float(base_m.get("cv", 0.0))
    band = f"base cv={cv:.1%}, warn>{pol.warn_rel:.0%}, fire>{pol.fire_rel:.0%}"
    if delta > pol.fire_rel and lo > 1.0 + pol.warn_rel:
        verdict = FIRE
    elif delta > pol.warn_rel and lo > 1.0:
        verdict = WARN
    else:
        verdict = OK
    return Finding(stage, metric, verdict, delta, mean_new, mean_base,
                   band, ci95=(lo, hi))


def _compare_scalar(stage: str, metric: str, pol: Policy,
                    new_v: float, base_v: float) -> Finding:
    delta = (new_v - base_v) / base_v if base_v else (
        0.0 if new_v == base_v else float("inf"))
    band = f"warn>{pol.warn_rel:.0%}, fire>{pol.fire_rel:.0%}"
    if delta > pol.fire_rel:
        verdict = FIRE
    elif delta > pol.warn_rel:
        verdict = WARN
    else:
        verdict = OK
    return Finding(stage, metric, verdict, delta, new_v, base_v, band)


def _compare_band(stage: str, metric: str, pol: Policy,
                  new_v: float, base_v: Optional[float]) -> Finding:
    delta = (None if base_v in (None, 0.0)
             else (new_v - base_v) / base_v)
    band = f"abs band<{pol.band:g}"
    if new_v > pol.band:
        verdict = FIRE
    elif new_v > 0.5 * pol.band:
        verdict = WARN
    else:
        verdict = OK
    return Finding(stage, metric, verdict, delta, new_v, base_v, band)


def compare_entry(entry: Dict[str, object], stage: str,
                  statics: Dict[str, object], fp: Dict[str, object],
                  measured: Dict[str, Dict[str, object]],
                  policies: Optional[Dict[str, Policy]] = None,
                  seed: int = 0) -> List[Finding]:
    """Judge ``measured`` metrics against one baseline entry.  Raises
    :class:`FingerprintMismatch` unless the measurement's host
    fingerprint and statics digest match the entry's."""
    fpd = fingerprint_digest(fp)
    if entry.get("fingerprint_digest") != fpd:
        raise FingerprintMismatch(
            f"stage {stage!r}: baseline fingerprint "
            f"{entry.get('fingerprint_digest')} != measurement {fpd} "
            f"(baseline host: {entry.get('fingerprint')}; this host: "
            f"{fp}): record a baseline on this host")
    if entry.get("statics_digest") != statics_digest(statics):
        raise FingerprintMismatch(
            f"stage {stage!r}: statics signature changed "
            f"({entry.get('statics')} -> {statics}): a different "
            "problem shape is not comparable; record again")
    findings: List[Finding] = []
    base_metrics = entry["metrics"]
    for metric in sorted(measured):
        new_m = measured[metric]
        pol = policy_for(metric, policies)
        base_m = base_metrics.get(metric)
        if pol.kind == "band":
            base_v = (float(base_m["value"])
                      if base_m and base_m.get("kind") == "scalar"
                      else None)
            findings.append(_compare_band(
                stage, metric, pol, float(new_m["value"]), base_v))
            continue
        if base_m is None:
            findings.append(Finding(
                stage, metric, NO_BASELINE, None,
                float(new_m.get("value", new_m.get("mean", 0.0))),
                None, "no baseline for this metric"))
            continue
        if pol.kind == "sampled" and new_m.get("kind") == "samples" \
                and base_m.get("kind") == "samples":
            findings.append(_compare_sampled(
                stage, metric, pol, new_m, base_m, seed))
        else:
            new_v = float(new_m.get("value", new_m.get("mean", 0.0)))
            base_v = float(base_m.get("value", base_m.get("mean", 0.0)))
            findings.append(_compare_scalar(
                stage, metric, pol, new_v, base_v))
    return findings


def compare(store: BaselineStore, stage: str,
            statics: Dict[str, object],
            fp: Dict[str, object],
            measured: Dict[str, Dict[str, object]],
            policies: Optional[Dict[str, Policy]] = None,
            seed: int = 0) -> List[Finding]:
    """Store-level compare: NO BASELINE findings (never FIRE) when this
    (stage, statics, host) was never recorded, except for band metrics,
    whose ceiling is absolute."""
    entry = store.get(stage, statics, fp)
    if entry is None:
        out = []
        for metric in sorted(measured):
            m = measured[metric]
            pol = policy_for(metric, policies)
            if pol.kind == "band":
                # the band is absolute: it applies on a fresh host too
                out.append(_compare_band(stage, metric, pol,
                                         float(m["value"]), None))
                continue
            out.append(Finding(
                stage, metric, NO_BASELINE, None,
                float(m.get("value", m.get("mean", 0.0))), None,
                "no baseline for this host/shape: record one"))
        return out
    return compare_entry(entry, stage, statics, fp, measured,
                         policies=policies, seed=seed)


def worst_verdict(findings: List[Finding]) -> str:
    order = {FIRE: 3, WARN: 2, NO_BASELINE: 1, OK: 0}
    if not findings:
        return OK
    return max(findings, key=lambda f: order.get(f.verdict, 0)).verdict
