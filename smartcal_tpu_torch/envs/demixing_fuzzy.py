"""Fuzzy-controller demixing environment (counterpart of
smartcal_tpu/envs/demixing_fuzzy.py; reference
``demixing_fuzzy/demixingenv.py``).

The observation and calibration skeleton of :class:`DemixingEnv`, with an
action that parameterizes the trapezoidal fuzzy controller
(models/fuzzy.py): 24 membership values per outlier and 8 shared target
values, mapped from [-1, 1] to [0, 1].  Per outlier the controller scores
a priority from (azimuth, azimuth_target, elevation, elevation_target,
separation, log flux, flux ratio), all K-1 outliers in one evaluation on
the backend's device; an outlier with priority >= its 'high' cutoff is
calibrated.  maxiter is fixed at 15 and the reward adds back its penalty.
Metadata is 5K+2: separations, azimuths, elevations, log-fluxes, selection
flags, log(f_low / 1 MHz) and N.  The hint is the default controller
mapped to action space.
"""

from typing import Optional

import numpy as np

from smartcal_tpu_torch import obs as smartcal_obs
from smartcal_tpu_torch.envs import radio
from smartcal_tpu_torch.envs.demixing import DemixingEnv
from smartcal_tpu_torch.models.fuzzy import N_ACTION, DemixController

INF_SCALE = 1e-3
META_SCALE = 1e-3


class FuzzyDemixingEnv(DemixingEnv):
    """The demixing env with the fuzzy action parameterization."""

    def __init__(self, K=6, provide_hint=False, provide_influence=False,
                 backend: Optional[radio.RadioBackend] = None, seed=0,
                 device="cuda"):
        super().__init__(K=K, provide_hint=provide_hint,
                         provide_influence=provide_influence,
                         backend=backend, seed=seed, device=device)
        self.n_fuzzy = N_ACTION
        self.ctrl = self._controller()
        self.log_fluxes = None
        self.target_flux = 1.0
        self.maxiter = 15

    def _controller(self):
        return DemixController(n_action=self.n_fuzzy,
                               device=self.backend.device)

    @property
    def n_actions(self):
        return 24 * (self.K - 1) + 8

    @property
    def n_metadata(self):
        return 5 * self.K + 2

    def _metadata_vec(self, selected_flags):
        md = np.zeros(self.n_metadata, np.float32)
        md[:self.K] = self.mdl.separations
        md[self.K:2 * self.K] = self.mdl.azimuth
        md[2 * self.K:3 * self.K] = self.mdl.elevation
        md[3 * self.K:4 * self.K] = self.log_fluxes
        md[4 * self.K:5 * self.K] = selected_flags
        md[-2] = np.log(self.ep.obs.freqs.cpu().numpy()[0] / 1e6)
        md[-1] = self.backend.n_stations
        return md

    def priorities(self, action):
        """(priority (K-1,), cutoff (K-1,)) of an action: each outlier's
        limits are set from its 24 values and the shared 8, then all
        outliers are evaluated at once."""
        action = np.asarray(action, np.float32).squeeze()
        if action.shape != (self.n_actions,):
            raise ValueError(f"action shape {action.shape}, expected "
                             f"({self.n_actions},)")
        a01 = action * 0.5 + 0.5
        flux_ratio = np.exp(self.log_fluxes) / self.target_flux
        azim, elev, sep = (self.mdl.azimuth, self.mdl.elevation,
                           self.mdl.separations)
        D = self.K - 1
        mf, pmf = [], []
        cutoff = np.zeros(D)
        inputs = np.zeros((D, 7))
        for nd in range(D):
            a = np.zeros(self.n_fuzzy)
            a[:24] = a01[nd * 24:(nd + 1) * 24]
            a[-8:] = a01[-8:]
            self.ctrl.update_limits(a)
            self.ctrl.create_controller()
            m, p = self.ctrl.membership_arrays()
            mf.append(m)
            pmf.append(p)
            inputs[nd] = [azim[nd], azim[-1], elev[nd], elev[-1], sep[nd],
                          self.log_fluxes[nd], flux_ratio[nd]]
            cutoff[nd] = self.ctrl.get_high_priority()
        priority = self.ctrl.evaluate_batch(np.stack(mf), np.stack(pmf),
                                            inputs)
        return priority, cutoff

    def step(self, action):
        priority, cutoff = self.priorities(action)
        clus_sel = np.where(priority >= cutoff)[0].tolist()
        mask = self._mask(clus_sel)
        Kselected = int(mask.sum())
        self.maxiter = 15
        with smartcal_obs.span("episode_step", env="demix_fuzzy"):
            res = self._calibrate(mask)
            with smartcal_obs.span("reward"):
                self.std_residual = float(
                    self.backend.noise_std(res.residual))
            infdata = self._influence_map(res, mask)

        flags = np.zeros(self.K, np.float32)
        flags[np.where(mask > 0)[0]] = 1.0
        md = self._metadata_vec(flags)
        obs = {"infmap": infdata * INF_SCALE, "metadata": md * META_SCALE}
        reward = self.calculate_reward_(Kselected) - self.reward0
        info = {"priority": priority, "selected": clus_sel}
        if self.provide_hint:
            if self.hint is None:
                self.hint = self.get_hint()
            return obs, reward, False, self.hint, info
        return obs, reward, False, info

    def calculate_reward_(self, Kselected):
        """The fuzzy variant drops the maxiter penalty."""
        return super().calculate_reward_(Kselected) + self.maxiter / 100.0

    def reset(self):
        self.ctrl = self._controller()
        obs = super().reset()
        self.maxiter = 15
        # K values (target last); the per-outlier slices use [:K-1]
        self.log_fluxes = np.log(np.maximum(self.mdl.fluxes, 1e-12))
        self.target_flux = float(max(self.mdl.fluxes[-1], 1e-12))
        flags = np.zeros(self.K, np.float32)
        flags[-1] = 1.0
        self.metadata = self._metadata_vec(flags)
        self.hint = self.get_hint() if self.provide_hint else None
        return {"infmap": obs["infmap"],
                "metadata": self.metadata * META_SCALE}

    def get_hint(self):
        """The default fuzzy config as the action."""
        hint_full = np.zeros(self.n_actions)
        hint = DemixController(self.n_fuzzy,
                               device=self.backend.device).update_action()
        for nd in range(self.K - 1):
            hint_full[24 * nd:24 * (nd + 1)] = hint[:24]
        hint_full[-8:] = hint[-8:]
        return (2.0 * (hint_full - 0.5)).astype(np.float32)
