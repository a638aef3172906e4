"""Trapezoidal Mamdani fuzzy controller for demixing direction priority
(counterpart of smartcal_tpu/models/fuzzy.py; reference
``demixing_fuzzy/demix_controller.py``).

Seven antecedents (azimuth, azimuth_target, elevation, elevation_target,
separation, log_intensity, intensity_ratio), each with low/medium/high
trapezoids, one consequent (priority) and the reference's 13 rules.  The
RL action reparameterizes the trapezoid breakpoints by the chained update
of ``update_set_`` with its exact inverse ``update_action_``.

The Mamdani pipeline (trapezoid membership, min/max rule firing, clipped
aggregation, centroid on a 101-point consequent grid) is float32 tensor
math on the controller's device, batched over leading axes: the K-1
directions of a demixing step, each with its own breakpoints, are one
evaluation.
"""

import json
from typing import Dict

import numpy as np
import torch

from smartcal_tpu_torch import resolve_device

VAR_ORDER = ("azimuth", "azimuth_target", "elevation", "elevation_target",
             "separation", "log_intensity", "intensity_ratio")
# action layout (update_limits, demix_controller.py:127-146)
ACTION_ORDER = ("azimuth", "elevation", "separation", "log_intensity",
                "intensity_ratio", "priority", "azimuth_target",
                "elevation_target")
N_ACTION = 32   # 8 sets x 4 action values


def default_config() -> Dict:
    """The reference's default membership limits."""
    def trio(rng, low, med, high):
        return {"range": list(rng), "low": list(low), "medium": list(med),
                "high": list(high)}

    inputs = {
        "_azimuth": trio([-180, 180, 1], [-180, -180, -65, -55],
                         [-65, -55, 55, 65], [55, 65, 180, 180]),
        "_azimuth_target": trio([-180, 180, 1], [-180, -180, -65, -55],
                                [-65, -55, 55, 65], [55, 65, 180, 180]),
        "_elevation": trio([-90, 90, 1], [-90, -90, -5, 5],
                           [-5, 5, 50, 60], [50, 60, 90, 90]),
        "_elevation_target": trio([-90, 90, 1], [-90, -90, -5, 5],
                                  [-5, 5, 50, 60], [50, 60, 90, 90]),
        "_separation": trio([0, 180, 1], [0, 0, 10, 15],
                            [10, 15, 45, 50], [45, 50, 180, 180]),
        "_log_intensity": trio([0, 100, 1], [0, 0, 1.0, 2.0],
                               [1.0, 2.0, 5.0, 10], [5.0, 10, 100, 100]),
        "_intensity_ratio": trio([0, 100, 1], [0, 0, 0.5, 1.0],
                                 [0.5, 1.0, 50, 55], [50, 55, 100, 100]),
    }
    outputs = {"_priority": trio([0, 100, 1], [0, 0, 40, 50],
                                 [40, 50, 70, 75], [70, 75, 100, 100])}
    return {"inputs": inputs, "outputs": outputs,
            "_comment": "membership limits (auto-generated)"}


def trapmf(x, abcd):
    """Trapezoidal membership (skfuzzy.trapmf semantics): 0 outside [a, d],
    1 inside [b, c], linear ramps; a degenerate ramp (a == b or c == d) is
    a step."""
    a, b, c, d = abcd.unbind(-1)
    one = torch.ones((), dtype=abcd.dtype, device=abcd.device)
    up = torch.where(b > a, (x - a) / torch.where(b > a, b - a, one), one)
    down = torch.where(d > c, (d - x) / torch.where(d > c, d - c, one), one)
    y = torch.minimum(torch.minimum(up, one), torch.minimum(down, one))
    y = torch.where((x < a) | (x > d), torch.zeros_like(y), y)
    return torch.clamp(y, 0.0, 1.0)


def _membership_arrays(config):
    """config -> {var: (3, 4) float32 rows [low, medium, high]}, with the
    priority's."""
    arrs = {}
    for name in VAR_ORDER:
        c = config["inputs"]["_" + name]
        arrs[name] = np.asarray([c["low"], c["medium"], c["high"]],
                                np.float32)
    p = config["outputs"]["_priority"]
    arrs["priority"] = np.asarray([p["low"], p["medium"], p["high"]],
                                  np.float32)
    return arrs


def mamdani_priority(mf_stack, priority_mf, inputs):
    """Crisp priorities, batched over leading axes.

    mf_stack (..., 7, 3, 4): the 7 antecedents' trapezoids (VAR_ORDER rows,
    [low, medium, high]); priority_mf (..., 3, 4); inputs (..., 7).  The
    reference's 13 rules with AND = min, OR = max, implication = clip,
    aggregation = max, and the centroid on the 101-point universe; an
    all-zero aggregate gives 50 (the reference's fallback).  Returns
    (...,)."""
    mu = trapmf(inputs[..., None], mf_stack)        # (..., 7, 3)
    az, azt, el, elt, sep, li, ir = mu.unbind(-2)
    LOW, MED, HIGH = 0, 1, 2

    def amin(*xs):
        return torch.stack(xs).amin(0)

    def amax(*xs):
        return torch.stack(xs).amax(0)

    r = [
        amin(az[..., LOW], azt[..., LOW]),                         # 0 med
        amin(az[..., MED], azt[..., MED]),                         # 1 med
        amin(az[..., HIGH], azt[..., HIGH]),                       # 2 med
        sep[..., LOW],                                             # 3 high
        el[..., LOW],                                              # 4 low
        amin(el[..., LOW], sep[..., HIGH], li[..., LOW],
             ir[..., LOW]),                                        # 5 low
        amin(el[..., MED], sep[..., MED], ir[..., HIGH]),          # 6 med
        amin(el[..., HIGH], sep[..., MED], ir[..., HIGH]),         # 7 high
        amin(el[..., HIGH], li[..., HIGH], ir[..., HIGH]),         # 8 high
        amax(el[..., MED], sep[..., MED], li[..., MED],
             ir[..., MED]),                                        # 9 med
        amin(elt[..., LOW], el[..., HIGH]),                        # 10 high
        amin(elt[..., HIGH], el[..., LOW]),                        # 11 low
        amin(elt[..., MED], el[..., HIGH]),                        # 12 med
    ]
    fire_low = amax(r[4], r[5], r[11])[..., None]
    fire_med = amax(r[0], r[1], r[2], r[6], r[9], r[12])[..., None]
    fire_high = amax(r[3], r[7], r[8], r[10])[..., None]

    u = torch.arange(101, dtype=torch.float32, device=inputs.device)
    pmf = priority_mf[..., None, :]                  # (..., 3, 1, 4)
    agg = torch.maximum(
        torch.maximum(torch.minimum(fire_low, trapmf(u, pmf[..., 0, :, :])),
                      torch.minimum(fire_med, trapmf(u, pmf[..., 1, :, :]))),
        torch.minimum(fire_high, trapmf(u, pmf[..., 2, :, :])))
    total = torch.sum(agg, dim=-1)
    centroid = torch.sum(agg * u, dim=-1) / (total + 1e-30)
    return torch.where(total > 1e-9, centroid, torch.full_like(total, 50.0))


class DemixController:
    """Reference-API wrapper (update_limits / update_action / evaluate /
    get_high_priority / print_config) over the tensor Mamdani core, on
    ``device`` (default "cuda": raises without a GPU)."""

    def __init__(self, n_action=N_ACTION, device="cuda"):
        if n_action != N_ACTION:
            raise ValueError(f"n_action={n_action}, the controller has "
                             f"{N_ACTION} action values")
        self.n_action = n_action
        self.device = resolve_device(device)
        self.config = default_config()

    # -- action <-> membership maps (demix_controller.py:95-125) ------------

    @staticmethod
    def _update_set(fz, action):
        hi = fz["range"][1]
        fz["low"][2] = fz["low"][1] + action[0] * (hi - fz["low"][1])
        fz["low"][3] = fz["low"][2] + action[1] * (hi - fz["low"][2])
        fz["medium"][0] = fz["low"][2]
        fz["medium"][1] = fz["low"][3]
        fz["medium"][2] = fz["medium"][1] + action[2] * (hi - fz["medium"][1])
        fz["medium"][3] = fz["medium"][2] + action[3] * (hi - fz["medium"][2])
        fz["high"][0] = fz["medium"][2]
        fz["high"][1] = fz["medium"][3]

    @staticmethod
    def _update_action(fz, action):
        hi = fz["range"][1]
        action[0] = (fz["low"][2] - fz["low"][1]) / (hi - fz["low"][1])
        action[1] = (fz["low"][3] - fz["low"][2]) / (hi - fz["low"][2])
        action[2] = ((fz["medium"][2] - fz["medium"][1])
                     / (hi - fz["medium"][1]))
        action[3] = ((fz["medium"][3] - fz["medium"][2])
                     / (hi - fz["medium"][2]))

    def update_limits(self, action):
        action = np.asarray(action)
        if action.size != self.n_action:
            raise ValueError(f"action has {action.size} values, expected "
                             f"{self.n_action}")
        ins, outs = self.config["inputs"], self.config["outputs"]
        for i, name in enumerate(ACTION_ORDER):
            grp = outs if name == "priority" else ins
            self._update_set(grp["_" + name], action[4 * i:4 * i + 4])

    def update_action(self):
        action = np.zeros(self.n_action)
        ins, outs = self.config["inputs"], self.config["outputs"]
        for i, name in enumerate(ACTION_ORDER):
            grp = outs if name == "priority" else ins
            self._update_action(grp["_" + name], action[4 * i:4 * i + 4])
        return action

    # -- evaluation ---------------------------------------------------------

    def membership_arrays(self):
        """(mf (7, 3, 4), priority mf (3, 4)) float32 numpy of the current
        limits."""
        arrs = _membership_arrays(self.config)
        return np.stack([arrs[n] for n in VAR_ORDER]), arrs["priority"]

    def membership_stack(self):
        mf, pmf = self.membership_arrays()
        return (torch.as_tensor(mf, device=self.device),
                torch.as_tensor(pmf, device=self.device))

    def create_controller(self):
        """No-op for API parity: the core reads the config directly (the
        reference rebuilds a skfuzzy ControlSystem here)."""

    def evaluate(self, azimuth, azimuth_target, elevation, elevation_target,
                 separation, log_intensity, intensity_ratio):
        """The crisp priority (0-100) of one direction under the current
        limits."""
        mf, pmf = self.membership_stack()
        x = torch.as_tensor(np.asarray(
            [azimuth, azimuth_target, elevation, elevation_target,
             separation, log_intensity, intensity_ratio], np.float32),
            device=self.device)
        return float(mamdani_priority(mf, pmf, x))

    def evaluate_batch(self, mf, pmf, inputs):
        """Priorities of D directions in one evaluation: mf (D, 7, 3, 4),
        pmf (D, 3, 4) and inputs (D, 7), numpy or tensors.  Returns (D,)
        float64 numpy."""
        def dev(x):
            return torch.as_tensor(np.asarray(x, np.float32),
                                   device=self.device)

        return mamdani_priority(dev(mf), dev(pmf), dev(inputs)) \
            .cpu().numpy().astype(np.float64)

    def get_high_priority(self):
        return self.config["outputs"]["_priority"]["high"][0]

    def print_config(self, filename=None):
        if filename:
            with open(filename, "w+") as fh:
                json.dump(self.config, fh)
        else:
            print(json.dumps(self.config))
