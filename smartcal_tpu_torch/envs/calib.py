"""CalibEnv: RL environment for tuning per-direction ADMM regularization
(counterpart of smartcal_tpu/envs/calib.py).

Action = 2M values in [-1, 1] (M spectral + M spatial rho), affinely mapped
to [LOW, HIGH] with a -0.1 penalty per out-of-range clip; observation =
{npix x npix influence image x 1e-3, (M+1) x 7 sky table x 1e-3}; reward =
sigma_data_img / sigma_res_img + 1e-4 / (sigma_inf + EPS) + penalty; reset
draws K in [2, M] and re-simulates; the hint is the analytic
flux-proportional rho with spatial = 5% of spectral.

The key stream is the JAX package's: ``prng`` reproduces
``jax.random.PRNGKey``/``split``, so ``CalibEnv(seed=s)`` walks the same
episodes in both packages.  Episode prefetch is still to be ported.
"""

from typing import Optional

import numpy as np

from smartcal_tpu_torch import prng, resolve_device
from smartcal_tpu_torch.cal import observation
from smartcal_tpu_torch.envs import radio

LOW, HIGH = 0.01, 1000.0
INF_SCALE = 1e-3
META_SCALE = 1e-3
EPS = 0.01


def _to_unit(rho):
    """rho -> [-1, 1] action coordinates."""
    return (rho - (HIGH + LOW) / 2) * (2 / (HIGH - LOW))


def _std(img):
    """np.std of a (small) image tensor, as the JAX env computes it."""
    return float(np.std(img.cpu().numpy()))


class CalibEnv:
    """Gym-style env (reset/step) with dict observations {'img', 'sky'}.

    ``baseline_reward=True`` subtracts the reward of the episode's own
    reset-time calibration from every step reward; ``fixed_K=k`` pins the
    direction count (the K draw still happens, so the episode stream is
    unchanged).  ``device`` defaults to "cuda" and raises without a GPU;
    a ``backend`` given explicitly must live on the same device."""

    def __init__(self, M=5, provide_hint=False,
                 backend: Optional[radio.RadioBackend] = None, seed=0,
                 fixed_K: Optional[int] = None, baseline_reward=False,
                 device="cuda"):
        dev = resolve_device(device)
        self.backend = backend or radio.RadioBackend(device=dev)
        if self.backend.device != dev:
            raise ValueError(f"backend on {self.backend.device}, env asked "
                             f"for {dev}")
        if fixed_K is not None and not 2 <= fixed_K <= M:
            raise ValueError(f"fixed_K={fixed_K} outside [2, M={M}]")
        self.M = M
        self.K = 0
        self.provide_hint = provide_hint
        self.hint = None
        self.fixed_K = fixed_K
        self.baseline_reward = baseline_reward
        self._reward0 = 0.0
        self._key = prng.PRNGKey(seed)
        self.rho_spectral = np.ones(M, np.float32)
        self.rho_spatial = np.ones(M, np.float32)
        self.ep = None
        self.mdl = None
        self.sky = None
        self._sigma_data_img = 1.0

    def _next_key(self):
        self._key, k = prng.split(self._key)
        return k

    @property
    def n_actions(self):
        return 2 * self.M

    def _run_calibration(self):
        mask = np.zeros(self.M, np.float32)
        mask[:self.K] = 1.0
        rho = np.ones(self.M, np.float32)
        rho[:self.K] = self.rho_spectral[:self.K]
        res = self.backend.calibrate(self.ep, rho, mask=mask)
        alpha = np.zeros(self.M, np.float32)
        alpha[:self.K] = self.rho_spatial[:self.K]
        img = self.backend.influence_image(self.ep, res, rho, alpha)
        return res, img.cpu().numpy()

    def _observation(self, img):
        self.sky[:self.K, 5] = _to_unit(self.rho_spectral[:self.K])
        self.sky[:self.K, 6] = _to_unit(self.rho_spatial[:self.K])
        return {"img": img * INF_SCALE, "sky": self.sky * META_SCALE}

    def step(self, action):
        action = np.asarray(action, np.float32).squeeze()
        if action.shape != (2 * self.M,):
            raise ValueError(f"action shape {action.shape}, expected "
                             f"({2 * self.M},)")
        rho = action * (HIGH - LOW) / 2 + (HIGH + LOW) / 2
        self.rho_spectral[:self.K] = rho[:self.K]
        self.rho_spatial[:self.K] = rho[self.M:self.M + self.K]
        penalty = 0.0
        for arr in (self.rho_spectral, self.rho_spatial):
            for ci in range(self.K):
                if arr[ci] < LOW:
                    arr[ci] = LOW
                    penalty += -0.1
                if arr[ci] > HIGH:
                    arr[ci] = HIGH
                    penalty += -0.1

        res, img = self._run_calibration()
        sigma1 = _std(self.backend.residual_image(self.ep, res))
        reward = (self._sigma_data_img / max(sigma1, 1e-12)
                  + 1e-4 / (float(img.std()) + EPS) + penalty
                  - self._reward0)
        observation_ = self._observation(img)
        info = {"sigma_res": float(res.sigma_res),
                "sigma_data": float(res.sigma_data)}
        if self.provide_hint:
            return observation_, reward, False, self.hint, info
        return observation_, reward, False, info

    def _build_episode(self, key):
        rng = observation.host_rng(key, salt=21)
        # the draw always happens, so fixed_K changes only K
        K = int(rng.integers(2, self.M + 1))
        if self.fixed_K is not None:
            K = self.fixed_K
        ep, mdl = self.backend.new_calib_episode(key, K, self.M)
        return K, ep, mdl

    def reset(self):
        key = self._next_key()
        self.K, self.ep, self.mdl = self._build_episode(key)
        self.rho_spectral = np.ones(self.M, np.float32)
        self.rho_spatial = np.ones(self.M, np.float32)
        self.rho_spectral[:self.K] = self.mdl.rho
        self.rho_spatial[:self.K] = self.mdl.rho_spatial

        # sky table (M+1, 7): K rows [id, l, m, sI, sP, ., .], final row
        # [ra0, dec0, K, f_low_GHz, f_high_GHz]
        freqs = self.ep.obs.freqs.cpu().numpy()
        self.sky = np.zeros((self.M + 1, 7), np.float32)
        self.sky[:self.K, :5] = self.mdl.sky_table
        self.sky[-1, :5] = [self.ep.obs.ra0, self.ep.obs.dec0, self.K,
                            freqs[0] / 1e9, freqs[-1] / 1e9]

        res, img = self._run_calibration()
        self._sigma_data_img = _std(self.backend.data_image(self.ep))
        self._reward0 = 0.0
        if self.baseline_reward:
            sigma1 = _std(self.backend.residual_image(self.ep, res))
            self._reward0 = (self._sigma_data_img / max(sigma1, 1e-12)
                             + 1e-4 / (float(img.std()) + EPS))
        if self.provide_hint:
            self.hint = np.zeros(2 * self.M, np.float32)
            self.hint[:self.K] = _to_unit(self.rho_spectral[:self.K])
            self.hint[self.M:self.M + self.K] = _to_unit(
                0.05 * self.rho_spectral[:self.K])
        return self._observation(img)

    def close(self):
        pass
