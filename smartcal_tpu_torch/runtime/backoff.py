"""Deterministic exponential backoff with jitter and a bounded budget
(counterpart of smartcal_tpu/runtime/backoff.py, the port's own copy).

One policy object for every retry loop; jitter comes from a caller-seeded
:class:`random.Random`, so same-seed reruns see the same delays.
Standard library only.
"""

import dataclasses
import random
from typing import Optional


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    base_s: float = 1.0          # first delay
    factor: float = 2.0          # multiplier per attempt
    max_s: float = 300.0         # per-delay cap (pre-jitter)
    jitter: float = 0.25         # +/- fraction of the computed delay
    max_attempts: Optional[int] = None   # None = unbounded count
    budget_s: Optional[float] = None     # total-sleep bound; None = unbounded

    def delay(self, attempt: int, rng: Optional[random.Random] = None
              ) -> float:
        """Delay before retry ``attempt`` (0-based), jittered."""
        d = min(self.base_s * (self.factor ** attempt), self.max_s)
        if self.jitter > 0.0 and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)


class Backoff:
    """Stateful walk through a :class:`BackoffPolicy`.

    ``next_delay()`` returns the next sleep (clipped into the remaining
    budget) or ``None`` once the policy says give up; the caller does
    the actual sleeping so the class stays trivially testable.
    """

    def __init__(self, policy: BackoffPolicy, seed: int = 0):
        self.policy = policy
        self.attempt = 0
        self.spent_s = 0.0
        self._rng = random.Random(seed)

    @property
    def exhausted(self) -> bool:
        p = self.policy
        if p.max_attempts is not None and self.attempt >= p.max_attempts:
            return True
        if p.budget_s is not None and self.spent_s >= p.budget_s:
            return True
        return False

    def next_delay(self) -> Optional[float]:
        """The delay to sleep before the next retry, or None to give up."""
        if self.exhausted:
            return None
        d = self.policy.delay(self.attempt, self._rng)
        if self.policy.budget_s is not None:
            d = min(d, max(0.0, self.policy.budget_s - self.spent_s))
        self.attempt += 1
        self.spent_s += d
        return d
