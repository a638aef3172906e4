"""Deterministic fault injection: the test harness of the recovery paths
(counterpart of smartcal_tpu/runtime/faults.py; the same
``SMARTCAL_FAULTS`` JSON schema drives both packages).

One process-wide :class:`FaultPlan` (installed in code or from the
``SMARTCAL_FAULTS`` environment variable, a JSON object of FaultPlan field
names) arms fault sites keyed on exact deterministic indices, so injected
runs are reproducible and a retry after recovery does not fire again:

* ``nan_field``/``nan_step``: NaN into the named field of the per-update
  diagnostics dict at global update ``nan_step`` (the watchdog's input);
* ``kill_actor``/``kill_at``: :class:`FaultInjected` inside actor
  ``kill_actor``'s work at rollout iteration ``kill_at``;
* ``delay_stage``/``delay_at``/``delay_s``/``delay_span``: sleep inside
  the named stage at every index in ``[delay_at, delay_at + delay_span)``;
* ``perturb_stage``/``perturb_at``/``perturb_rel``/``perturb_span``:
  scale the value passed through :func:`maybe_perturb` by
  ``(1 + perturb_rel)`` in that window.

Each firing is recorded once as a ``fault_injected`` RunLog event.  With
no plan installed every hook is one ``None`` check.  Standard library only.
"""

import dataclasses
import json
import os
import threading
import time
from typing import Optional


class FaultInjected(RuntimeError):
    """Raised by an injected actor kill (see module doc)."""


@dataclasses.dataclass
class FaultPlan:
    nan_field: Optional[str] = None
    nan_step: Optional[int] = None
    kill_actor: Optional[int] = None
    kill_at: Optional[int] = None
    delay_stage: Optional[str] = None
    delay_at: Optional[int] = None
    delay_s: float = 0.0
    delay_span: int = 1
    perturb_stage: Optional[str] = None
    perturb_at: Optional[int] = None
    perturb_rel: float = 0.0
    perturb_span: int = 1


_plan: Optional[FaultPlan] = None
_lock = threading.Lock()
_fired: set = set()


def install(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` process-wide (None clears)."""
    global _plan
    with _lock:
        _plan = plan
        _fired.clear()


def clear() -> None:
    install(None)


def active() -> Optional[FaultPlan]:
    return _plan


def plan_from_env(env=None) -> Optional[FaultPlan]:
    """Parse ``SMARTCAL_FAULTS`` (JSON with FaultPlan field names) —
    lets the smoke scripts inject faults into unmodified driver CLIs."""
    env = os.environ if env is None else env
    raw = env.get("SMARTCAL_FAULTS", "").strip()
    if not raw:
        return None
    try:
        d = json.loads(raw)
        fields = {f.name for f in dataclasses.fields(FaultPlan)}
        return FaultPlan(**{k: v for k, v in d.items() if k in fields})
    except (ValueError, TypeError) as e:
        import sys
        sys.stderr.write(f"SMARTCAL_FAULTS unparseable ({e!r}); "
                         "ignoring\n")
        return None


def install_from_env() -> Optional[FaultPlan]:
    plan = plan_from_env()
    if plan is not None:
        install(plan)
    return plan


def _record(site: str, **fields) -> None:
    key = (site, tuple(sorted(fields.items())))
    with _lock:
        if key in _fired:
            return
        _fired.add(key)
    from smartcal_tpu_torch import obs
    rl = obs.active()
    if rl is not None:
        rl.log("fault_injected", site=site, **fields)


def mutate_diag(step_diag: dict, step: int) -> dict:
    """Apply the NaN fault to one per-update diagnostics dict (a copy);
    identity when the plan doesn't target this step."""
    p = _plan
    if p is None or p.nan_field is None or p.nan_step != step:
        return step_diag
    out = dict(step_diag)
    out[p.nan_field] = float("nan")
    _record("diag_nan", field=p.nan_field, step=step)
    return out


def should_kill_actor(actor_id: int, iteration: int) -> bool:
    p = _plan
    if p is None or p.kill_actor is None:
        return False
    if p.kill_actor == actor_id and p.kill_at == iteration:
        _record("actor_kill", actor=actor_id, iteration=iteration)
        return True
    return False


def maybe_delay(stage: str, index: int) -> float:
    """Sleep the planned delay when (stage, index) falls inside the
    plan's delay window; returns seconds slept.  Each firing index
    records its own ``fault_injected`` event."""
    p = _plan
    if (p is None or p.delay_stage != stage or p.delay_at is None
            or p.delay_s <= 0.0):
        return 0.0
    if not p.delay_at <= index < p.delay_at + max(1, int(p.delay_span)):
        return 0.0
    _record("delay", stage=stage, index=index, delay_s=p.delay_s)
    time.sleep(p.delay_s)
    return p.delay_s


def maybe_perturb(stage: str, index: int, value: float) -> float:
    """Multiply ``value`` by ``(1 + perturb_rel)`` when (stage, index)
    falls inside the plan's perturb window; identity otherwise.  Each
    firing index records its own ``fault_injected`` event."""
    p = _plan
    if (p is None or p.perturb_stage != stage or p.perturb_at is None
            or p.perturb_rel == 0.0):
        return value
    if not p.perturb_at <= index < p.perturb_at + max(1, int(p.perturb_span)):
        return value
    _record("perturb", stage=stage, index=index, rel=p.perturb_rel)
    return value * (1.0 + p.perturb_rel)
