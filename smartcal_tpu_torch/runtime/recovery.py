"""Watchdog escalation: rollback-and-retry before the graceful halt
(counterpart of smartcal_tpu/runtime/recovery.py).

The :class:`RecoveryManager` turns a watchdog trip into a bounded retry:

1. load the last good checkpoint (sha-validated; the poisoned episodes
   since it are discarded);
2. hand the driver a :class:`RecoveryAction` with the payload and the
   mitigation: a learning-rate shrink (``lr_scale = lr_shrink **
   attempt``) and/or an exploration reseed;
3. log ONE ``recovery`` RunLog event per rollback;
4. after ``max_recoveries`` attempts (or with nothing to roll back to)
   return None: the driver halts gracefully.

The manager owns policy and counting; restoring state and applying the
mitigation stay with the driver.
"""

import dataclasses
from typing import Optional

from .checkpoint import Checkpointer


@dataclasses.dataclass(frozen=True)
class RecoveryPolicy:
    max_recoveries: int = 0      # 0 = recovery disabled (halt on trip)
    lr_shrink: float = 0.5       # per-attempt LR multiplier (1.0 = off)
    reseed: bool = True          # fold a fresh offset into the key stream


@dataclasses.dataclass
class RecoveryAction:
    payload: dict                # the checkpoint to restore
    step: int                    # its step (episodes completed)
    attempt: int                 # 1-based recovery attempt
    lr_scale: float              # cumulative LR multiplier to apply
    reseed: bool


class RecoveryManager:
    def __init__(self, policy: RecoveryPolicy,
                 ckpt: Optional[Checkpointer]):
        self.policy = policy
        self.ckpt = ckpt
        self.attempts = 0

    @property
    def armed(self) -> bool:
        return self.policy.max_recoveries > 0 and self.ckpt is not None

    def on_trip(self, reason: Optional[str] = None,
                episode: Optional[int] = None) -> Optional[RecoveryAction]:
        """Trip handler; None means halt (budget spent / nothing saved)."""
        if not self.armed or self.attempts >= self.policy.max_recoveries:
            self._log(action="halt", reason=reason, episode=episode,
                      attempt=self.attempts,
                      budget=self.policy.max_recoveries)
            return None
        loaded = self.ckpt.load_latest()
        if loaded is None:
            self._log(action="halt_no_checkpoint", reason=reason,
                      episode=episode, attempt=self.attempts)
            return None
        payload, step = loaded
        self.attempts += 1
        act = RecoveryAction(
            payload=payload, step=step, attempt=self.attempts,
            lr_scale=self.policy.lr_shrink ** self.attempts,
            reseed=self.policy.reseed)
        self._log(action="rollback", reason=reason, episode=episode,
                  rollback_step=step, attempt=self.attempts,
                  budget=self.policy.max_recoveries,
                  lr_scale=act.lr_scale, reseed=act.reseed)
        return act

    def _log(self, **fields) -> None:
        from smartcal_tpu_torch import obs
        rl = obs.active()
        if rl is not None:
            rl.log("recovery", **fields)
            rl.flush()
