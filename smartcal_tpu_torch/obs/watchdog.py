"""Divergence watchdog: trip on non-finite or exploding training internals
(counterpart of smartcal_tpu/obs/watchdog.py, same defaults and trip
reasons).

Consumes the per-update diagnostics stream (host dicts from
``diagnostics.diag_to_host``) and, optionally, replay-health summaries,
and detects:

* **non-finite**: NaN/Inf in a loss, a gradient norm or a Q statistic;
* **exploding gradients**: a gradient norm beyond ``grad_mult`` x its own
  exponential moving average (after ``warmup`` observations);
* **Q blowup**: ``|q|`` beyond ``q_limit``.

On a trip it logs ONE ``watchdog_trip`` event (reason, step, the values
and a ring of the last ``ring`` diagnostics) and latches ``tripped``.
A trip also flushes the flight recorder (``obs/flightrec``).  Standard
library only.
"""

import dataclasses
import math
from collections import deque
from typing import Optional

from .runlog import active

# fields whose non-finiteness constitutes a trip on its own
_FINITE_FIELDS = ("critic_loss", "actor_loss", "critic_grad_norm",
                  "actor_grad_norm", "q_mean", "q_min", "q_max")
# fields the EWMA explosion detector tracks
_GRAD_FIELDS = ("critic_grad_norm", "actor_grad_norm")


@dataclasses.dataclass(frozen=True)
class WatchdogConfig:
    grad_mult: float = 50.0     # trip at grad > grad_mult * EWMA(grad)
    ewma_alpha: float = 0.05    # EWMA smoothing (per observation)
    warmup: int = 20            # observations before the EWMA check arms
    grad_floor: float = 1e-3    # EWMA floor: tiny early grads must not
                                # make any normal step look explosive
    q_limit: float = 1e6        # |q_mean|/|q_max| beyond this trips
    ring: int = 32              # diagnostics kept for trip context


class Watchdog:
    """Streaming divergence detector (see module doc).

    One instance per run; feed it with ``observe(step_diag)`` per update
    and (optionally) ``observe_replay(health)`` per train block.
    """

    def __init__(self, cfg: Optional[WatchdogConfig] = None):
        self.cfg = cfg or WatchdogConfig()
        self.tripped = False
        self.trip_reason: Optional[str] = None
        self.trips = 0                  # lifetime count (survives reset())
        self._ring = deque(maxlen=self.cfg.ring)
        self._ewma = {k: None for k in _GRAD_FIELDS}
        self._n = {k: 0 for k in _GRAD_FIELDS}
        self._seen = 0

    def reset(self) -> None:
        """Un-latch after a recovery rollback (runtime.recovery): the trip
        state clears so the retried trajectory is monitored afresh, while
        the gradient EWMAs and the lifetime ``trips`` count survive — the
        healthy pre-trip baseline is exactly what the retry should be
        judged against."""
        self.tripped = False
        self.trip_reason = None
        self._ring.clear()

    # -- detectors --------------------------------------------------------
    def _check_finite(self, diag: dict) -> Optional[str]:
        for k in _FINITE_FIELDS:
            v = diag.get(k)
            if v is None:
                # sanitized-to-null upstream IS a non-finite sighting
                if k in diag:
                    return f"non_finite:{k}"
                continue
            if not math.isfinite(v):
                return f"non_finite:{k}"
        return None

    def _check_grads(self, diag: dict) -> Optional[str]:
        cfg = self.cfg
        reason = None
        for k in _GRAD_FIELDS:
            v = diag.get(k)
            # exact zeros are skipped entirely: a pre-buffer-fill no-learn
            # step and TD3's delayed-actor skip steps report 0.0, and
            # folding those into the EWMA would make the FIRST real
            # gradient look explosive
            if v is None or not math.isfinite(v) or v == 0.0:
                continue
            ewma = self._ewma[k]
            if (ewma is not None and self._n[k] > cfg.warmup
                    and v > cfg.grad_mult * max(ewma, cfg.grad_floor)):
                reason = (f"exploding_grad:{k} "
                          f"({v:.3e} > {cfg.grad_mult:g} x ewma "
                          f"{max(ewma, cfg.grad_floor):.3e})")
            # the EWMA keeps integrating even on the trip observation so a
            # non-halting consumer sees a decaying alarm, not a latch
            self._ewma[k] = (v if ewma is None
                             else (1 - cfg.ewma_alpha) * ewma
                             + cfg.ewma_alpha * v)
            self._n[k] += 1
        return reason

    def _check_q(self, diag: dict) -> Optional[str]:
        for k in ("q_mean", "q_max", "q_min"):
            v = diag.get(k)
            if v is not None and math.isfinite(v) \
                    and abs(v) > self.cfg.q_limit:
                return f"q_blowup:{k} (|{v:.3e}| > {self.cfg.q_limit:g})"
        return None

    # -- feed -------------------------------------------------------------
    def observe(self, diag: dict, step: Optional[int] = None,
                **tags) -> bool:
        """Feed one per-update diagnostics dict; returns ``tripped``."""
        self._seen += 1
        self._ring.append({"step": step, **diag})
        if self.tripped:
            return True
        reason = (self._check_finite(diag) or self._check_grads(diag)
                  or self._check_q(diag))
        if reason is not None:
            self._trip(reason, step, tags)
        return self.tripped

    def observe_replay(self, health: dict, **tags) -> bool:
        """Feed one replay-health summary; a non-finite priority mass or
        entropy means the PER distribution itself is poisoned."""
        if self.tripped:
            return True
        for k in ("priority_entropy", "priority_total", "is_weight_max"):
            v = health.get(k)
            if v is not None and isinstance(v, float) \
                    and not math.isfinite(v):
                self._trip(f"replay_non_finite:{k}", None, tags)
                break
        return self.tripped

    def _trip(self, reason: str, step, tags: dict):
        self.tripped = True
        self.trip_reason = reason
        self.trips += 1
        rl = active()
        if rl is not None:
            rl.log("watchdog_trip", reason=reason, step=step,
                   observations=self._seen, ring=list(self._ring), **tags)
            rl.flush()
        from . import flightrec
        flightrec.flush("watchdog_trip", {"reason": reason, "step": step})
