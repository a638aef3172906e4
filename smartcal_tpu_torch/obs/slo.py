"""Windowed SLO burn-rate detection for the serving fleet (the port's
copy of smartcal_tpu/obs/slo.py, same semantics).

The serving telemetry *measures* p99 and shed after the fact;
:class:`SloBurnDetector` watches them live: a
multi-window (fast + slow) burn-rate evaluator over a sliding stream of
per-request latency / shed observations, with hysteresis in the same
spirit as the fleet's autoscale EWMA — a spike must *sustain* before the
alarm fires, and the alarm must *stay quiet* before it clears, so one
slow solve or one shed burst does not flap the detector.

Burn rate is measured against explicit targets: ``p99 / p99_target``
and ``shed_rate / shed_target`` (the worse of the two is the window's
burn).  The classic multi-window condition applies: FIRING requires the
fast window burning above ``burn_threshold`` AND the slow window above
1.0 (a long-running degradation, not a blip); CLEARED requires the fast
window back at or below ``clear_threshold`` for ``clear_sustain_s``.

State transitions surface as structured ``slo_burn`` event dicts —
the FleetRouter logs them live (and exposes a gauge), obs_report folds
them offline — carrying per-replica fast-window p99s so a burn is
*localized*, not just detected: the merged critical path then says
which stage of the worst replica is eating the budget.

Stdlib only; the clock is injectable (``now``) for deterministic tests,
same idiom as the fleet's ``clock`` parameter.
"""

from __future__ import annotations

import collections
import math
import threading
import time
from typing import Deque, Dict, List, Optional, Tuple


def _p99(values: List[float]) -> float:
    """p99 by the nearest-rank method (stdlib; no numpy in obs/)."""
    if not values:
        return 0.0
    xs = sorted(values)
    idx = min(len(xs) - 1, max(0, math.ceil(0.99 * len(xs)) - 1))
    return xs[idx]


class SloBurnDetector:
    """Fast+slow windowed p99/shed burn-rate evaluator with hysteresis.

    ``observe()`` from any thread per completed/shed request;
    ``evaluate()`` periodically (the router's poll tick) — returns a
    transition event dict exactly when the state flips, else None.
    """

    def __init__(self, p99_target_s: float,
                 shed_target: float = 0.02,
                 fast_window_s: float = 10.0,
                 slow_window_s: float = 60.0,
                 burn_threshold: float = 2.0,
                 clear_threshold: float = 1.0,
                 sustain_s: float = 2.0,
                 clear_sustain_s: float = 5.0,
                 min_samples: int = 20) -> None:
        self.p99_target_s = float(p99_target_s)
        self.shed_target = max(1e-9, float(shed_target))
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = max(float(slow_window_s),
                                 float(fast_window_s))
        self.burn_threshold = float(burn_threshold)
        self.clear_threshold = float(clear_threshold)
        self.sustain_s = float(sustain_s)
        self.clear_sustain_s = float(clear_sustain_s)
        self.min_samples = max(1, int(min_samples))
        self._lock = threading.Lock()
        # (t, latency_s or None, shed?, replica) — one deque, pruned to
        # the slow window on every observe/evaluate
        self._obs: Deque[Tuple[float, Optional[float], bool,
                               Optional[int]]] = collections.deque()
        self._state: Dict[str, object] = {
            "firing": False, "pending_since": None,
            "clear_since": None, "transitions": 0}

    def observe(self, latency_s: Optional[float] = None,
                shed: bool = False, replica: Optional[int] = None,
                now: Optional[float] = None) -> None:
        """Record one request outcome: a completion latency and/or a
        shed mark, attributed to ``replica`` when known."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._obs.append((t, latency_s, bool(shed), replica))
            self._prune_locked(t)

    def _prune_locked(self, now: float) -> None:
        horizon = now - self.slow_window_s
        while self._obs and self._obs[0][0] < horizon:
            self._obs.popleft()

    def _window_locked(self, now: float,
                       window_s: float) -> Dict[str, object]:
        t0 = now - window_s
        lats: List[float] = []
        by_rep: Dict[int, List[float]] = {}
        n = shed = 0
        for (t, lat, was_shed, rep) in self._obs:
            if t < t0:
                continue
            n += 1
            if was_shed:
                shed += 1
            if lat is not None:
                lats.append(lat)
                if rep is not None:
                    by_rep.setdefault(int(rep), []).append(lat)
        p99 = _p99(lats)
        shed_rate = shed / n if n else 0.0
        burn = 0.0
        if n >= self.min_samples:
            burn = max(p99 / self.p99_target_s,
                       shed_rate / self.shed_target)
        return {"n": n, "p99_s": round(p99, 6),
                "shed_rate": round(shed_rate, 6),
                "burn": round(burn, 4),
                "replica_p99_s": {r: round(_p99(v), 6)
                                  for r, v in sorted(by_rep.items())}}

    def snapshot(self, now: Optional[float] = None) -> Dict[str, object]:
        """Current fast/slow window stats + firing flag (the router's
        gauge source); no state transition."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._prune_locked(t)
            fast = self._window_locked(t, self.fast_window_s)
            slow = self._window_locked(t, self.slow_window_s)
            return {"firing": bool(self._state["firing"]),
                    "fast": fast, "slow": slow,
                    "transitions": self._state["transitions"]}

    @property
    def firing(self) -> bool:
        with self._lock:
            return bool(self._state["firing"])

    def evaluate(self, now: Optional[float] = None
                 ) -> Optional[Dict[str, object]]:
        """Advance the hysteresis state machine; returns the structured
        ``slo_burn`` transition event on a flip, else None."""
        t = time.monotonic() if now is None else float(now)
        with self._lock:
            self._prune_locked(t)
            fast = self._window_locked(t, self.fast_window_s)
            slow = self._window_locked(t, self.slow_window_s)
            firing = bool(self._state["firing"])
            burning = (fast["burn"] >= self.burn_threshold
                       and slow["burn"] >= 1.0)
            quiet = fast["burn"] <= self.clear_threshold
            if not firing:
                self._state["clear_since"] = None
                if burning:
                    since = self._state["pending_since"]
                    if since is None:
                        self._state["pending_since"] = t
                    elif t - float(since) >= self.sustain_s:  # type: ignore[arg-type]
                        self._state["firing"] = True
                        self._state["pending_since"] = None
                        self._state["transitions"] = \
                            int(self._state["transitions"]) + 1
                        return self._event_locked("firing", fast, slow)
                else:
                    self._state["pending_since"] = None
                return None
            # firing: wait for a sustained quiet fast window
            self._state["pending_since"] = None
            if quiet:
                since = self._state["clear_since"]
                if since is None:
                    self._state["clear_since"] = t
                elif t - float(since) >= self.clear_sustain_s:  # type: ignore[arg-type]
                    self._state["firing"] = False
                    self._state["clear_since"] = None
                    self._state["transitions"] = \
                        int(self._state["transitions"]) + 1
                    return self._event_locked("cleared", fast, slow)
            else:
                self._state["clear_since"] = None
            return None

    def _event_locked(self, state: str, fast: Dict[str, object],
                      slow: Dict[str, object]) -> Dict[str, object]:
        rep_p99 = fast["replica_p99_s"]
        worst = None
        if isinstance(rep_p99, dict) and rep_p99:
            worst = max(rep_p99, key=lambda r: rep_p99[r])
        return {"state": state,
                "burn_fast": fast["burn"], "burn_slow": slow["burn"],
                "p99_fast_s": fast["p99_s"],
                "shed_rate_fast": fast["shed_rate"],
                "p99_target_s": self.p99_target_s,
                "replica_p99_s": rep_p99, "worst_replica": worst}
