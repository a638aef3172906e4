"""DemixingEnv: RL environment for selecting demixing directions
(counterpart of smartcal_tpu/envs/demixing.py; reference
``demixing_rl/demixingenv.py``).

Action = K values in [-1, 1]: K-1 direction selections (a direction is
calibrated when its [0, 1] map exceeds 0.5) and the maximum ADMM
iterations, mapped to [5, 30].  Observation = {influence map (zeros unless
``provide_influence``) x 1e-3, metadata x 1e-3}; the 3K+2 metadata is the
separations, azimuths and elevations of the K directions in degrees, then
log(f_low / 1 MHz) and N, with the separations of the calibrated
directions zeroed after a step.  Reward = -AIC normalised by (-859, 3559)
minus maxiter/100, relative to the reset's target-only calibration.  The
hint sweeps all 2^(K-1) selections (``RadioBackend.hint_sweep``), takes
their AIC and returns the softmin (tau = 100) expectation.

The key stream is the JAX package's (``prng``), so ``DemixingEnv(seed=s)``
walks the same episodes in both packages.  :class:`BatchedDemixingEnv`
advances E such envs as one batched solve.
"""

from typing import Optional

import numpy as np

from smartcal_tpu_torch import obs, prng, resolve_device
from smartcal_tpu_torch.envs import radio

LOW, HIGH = 0.0, 1.0
LOW_ITER, HIGH_ITER = 5, 30     # demixingenv.py:27-28
INF_SCALE = 1e-3
META_SCALE = 1e-3
EPS = 0.01
REWARD_MEAN, REWARD_STD = -859.0, 3559.0   # demixingenv.py:349-350


def scalar_to_kvec(n, K=5):
    """Integer -> K binary selection bits, most significant first."""
    ll = [1 if digit == "1" else 0 for digit in bin(n)[2:]]
    a = np.zeros(K)
    a[len(a) - len(ll):] = ll
    return a


def _backend(backend, device):
    dev = resolve_device(device)
    backend = backend or radio.RadioBackend(admm_iters=30, device=dev)
    if backend.device != dev:
        raise ValueError(f"backend on {backend.device}, env asked for {dev}")
    return backend


def _metadata(mdl, ep, K, n_stations):
    """The reset metadata (3K+2,): separations, azimuths, elevations,
    log(f_low / 1 MHz), N."""
    md = np.zeros(3 * K + 2, np.float32)
    md[:K] = mdl.separations
    md[K:2 * K] = mdl.azimuth
    md[2 * K:3 * K] = mdl.elevation
    md[-2] = np.log(ep.obs.freqs.cpu().numpy()[0] / 1e6)
    md[-1] = n_stations
    return md


class DemixingEnv:
    """Gym-style env with dict observations {'infmap', 'metadata'}.

    ``prefetch=True`` builds the next episode on the backend's worker
    thread after each reset (see ``CalibEnv``).  ``device`` defaults to
    "cuda" and raises without a GPU; a ``backend`` given explicitly must
    live on the same device."""

    def __init__(self, K=6, provide_hint=False, provide_influence=False,
                 backend: Optional[radio.RadioBackend] = None, seed=0,
                 tau=100.0, prefetch=False, device="cuda"):
        self.K = K
        self.provide_hint = provide_hint
        self.provide_influence = provide_influence
        self.backend = _backend(backend, device)
        self.prefetch = prefetch
        self._pf_tag = None
        self.tau = tau
        self._key = prng.PRNGKey(seed)
        self.ep = None
        self.mdl = None
        self.metadata = np.zeros(3 * K + 2, np.float32)
        self.elevation = None
        self.rho = np.ones(K, np.float32)
        self.maxiter = 10
        self.std_data = 1.0
        self.std_residual = 1.0
        self.reward0 = 0.0
        self.hint = None
        self.npix = self.backend.npix

    def _next_key(self):
        self._key, k = prng.split(self._key)
        return k

    @property
    def n_actions(self):
        return self.K

    def _mask(self, clus_sel):
        """(K,) mask: the selected outliers and always the target (last)."""
        m = np.zeros(self.K, np.float32)
        m[clus_sel] = 1.0
        m[self.K - 1] = 1.0
        return m

    def _calibrate(self, mask):
        return self.backend.calibrate(self.ep, self.rho, mask=mask,
                                      admm_iters=self.maxiter)

    def _influence_map(self, res, mask):
        if not self.provide_influence:
            return np.zeros((self.npix, self.npix), np.float32)
        alpha = np.zeros(self.K, np.float32)
        img = self.backend.influence_image(self.ep, res, self.rho * mask
                                           + (1 - mask), alpha)
        return img.cpu().numpy()

    def calculate_reward_(self, Kselected):
        """-AIC, normalised; the penalty grows with maxiter."""
        data_var = self.std_data ** 2
        noise_var = self.std_residual ** 2
        N = self.backend.n_stations
        reward = (-N * N * noise_var / (data_var + EPS)
                  - Kselected * N)
        reward = (reward - REWARD_MEAN) / REWARD_STD
        return reward - self.maxiter / 100.0

    def _selection(self, action):
        """(calibrated outliers, maxiter) of an action; maxiter truncates the
        float32 affine map, as the JAX env's ``int()`` does."""
        action = np.asarray(action, np.float32).squeeze()
        if action.shape != (self.K,):
            raise ValueError(f"action shape {action.shape}, expected "
                             f"({self.K},)")
        sel = action[:self.K - 1] * (HIGH - LOW) / 2 + (HIGH + LOW) / 2
        maxiter = int(action[self.K - 1] * (HIGH_ITER - LOW_ITER) / 2
                      + (HIGH_ITER + LOW_ITER) / 2)
        return np.where(sel > 0.5)[0].tolist(), maxiter

    def step(self, action):
        clus_sel, self.maxiter = self._selection(action)
        mask = self._mask(clus_sel)
        Kselected = int(mask.sum())
        with obs.span("episode_step", env="demix"):
            res = self._calibrate(mask)
            with obs.span("reward"):
                self.std_residual = float(
                    self.backend.noise_std(res.residual))
            infdata = self._influence_map(res, mask)

        md = self.metadata.copy()
        md[np.where(mask > 0)[0]] = 0.0     # separations of calibrated dirs
        observation = {"infmap": infdata * INF_SCALE,
                       "metadata": md * META_SCALE}
        reward = self.calculate_reward_(Kselected) - self.reward0
        info = {"sigma_res": self.std_residual}
        if self.provide_hint:
            if self.hint is None:
                self.hint = self.get_hint()
            return observation, reward, False, self.hint, info
        return observation, reward, False, info

    def _prefetch_tag(self, key):
        # per env instance: two envs on one backend may walk one seed stream
        return f"{type(self).__name__}-{id(self)}-{key.tobytes().hex()}"

    def reset(self):
        with obs.span("episode_reset", env="demix"):
            return self._reset()

    def _reset(self):
        key = self._next_key()
        got = (self.backend.take_prefetched(self._prefetch_tag(key))
               if self.prefetch else None)
        self.ep, self.mdl = got or self.backend.new_demixing_episode(
            key, self.K)
        if self.prefetch:
            nxt = prng.split(self._key)[1]
            self._pf_tag = self._prefetch_tag(nxt)
            self.backend.prefetch_episode(
                self._pf_tag,
                lambda k=nxt: self.backend.new_demixing_episode(k, self.K))
        self.elevation = self.mdl.elevation
        self.rho = self.mdl.rho.astype(np.float32)
        self.maxiter = 10
        mask = self._mask([])               # target only
        res = self._calibrate(mask)
        self.std_data = float(self.backend.noise_std(self.ep.V))
        self.std_residual = float(self.backend.noise_std(res.residual))
        self.reward0 = self.calculate_reward_(1)
        self.metadata = _metadata(self.mdl, self.ep, self.K,
                                  self.backend.n_stations)
        infdata = self._influence_map(res, mask)
        self.hint = None
        return {"infmap": infdata * INF_SCALE,
                "metadata": self.metadata * META_SCALE}

    def hint_masks(self):
        """(masks (2^(K-1), K), valid (2^(K-1),)) of the hint sweep: every
        selection, in ``scalar_to_kvec`` order.  A selection with a chosen
        outlier below 1 degree of elevation is not valid and runs as a
        target-only lane, so the sweep's lane count is fixed."""
        n_cfg = 2 ** (self.K - 1)
        masks = np.zeros((n_cfg, self.K), np.float32)
        valid = np.zeros(n_cfg, bool)
        for idx in range(n_cfg):
            bits = scalar_to_kvec(idx, self.K - 1)
            chosen_el = self.elevation[:-1][bits > 0]
            if not np.any(chosen_el < 1.0):
                masks[idx] = self._mask(np.where(bits > 0)[0].tolist())
                valid[idx] = True
            else:
                masks[idx] = self._mask([])
        return masks, valid

    def hint_from_sigmas(self, masks, valid, sigma_res):
        """The hint action from the sweep's per-mask residual statistic:
        AIC = (N sigma / std_data)^2 + ksel N for valid selections (1e5
        for the others), softmin(tau) over selections, the expected
        selection vector mapped to [-1, 1], and the current maxiter."""
        n_cfg = masks.shape[0]
        AIC = np.full(n_cfg, 1e5)
        N = self.backend.n_stations
        for idx in np.where(valid)[0]:
            ksel = int(masks[idx].sum())
            AIC[idx] = ((N * sigma_res[idx] / self.std_data) ** 2
                        + ksel * N)
        probs = np.exp(-AIC / self.tau)
        probs /= probs.sum()
        hint = np.zeros(self.K - 1)
        for idx in range(n_cfg):
            hint += probs[idx] * scalar_to_kvec(idx, self.K - 1)
        hint = (hint - (HIGH + LOW) / 2) * (2 / (HIGH - LOW))
        out = np.zeros(self.K, np.float32)
        out[:self.K - 1] = hint
        out[self.K - 1] = ((self.maxiter - (HIGH_ITER + LOW_ITER) / 2)
                           * (2 / (HIGH_ITER - LOW_ITER)))
        return out

    def get_hint(self):
        """Exhaustive AIC sweep -> softmin expectation, every selection as a
        lane of the batched masked solve at the current maxiter."""
        masks, valid = self.hint_masks()
        sigma_res = self.backend.hint_sweep(
            self.ep, self.rho, masks, admm_iters=self.maxiter).cpu().numpy()
        return self.hint_from_sigmas(masks, valid, sigma_res)

    def render(self, mode="human"):
        print(f"maxiter {self.maxiter} rho {self.rho}")

    def close(self):
        if self._pf_tag is not None:
            self.backend.discard_prefetched(self._pf_tag)
            self._pf_tag = None


class BatchedDemixingEnv:
    """``n_envs`` DemixingEnv lanes advanced as one batched solve.

    Lane ``i`` walks ``DemixingEnv(K, seed=seed + i)``'s key stream;
    episode construction stays per lane, and the masked solve and the
    reward statistics run over all lanes at once, the per-lane maxiter as
    the (E,) ``admm_iters`` of ``RadioBackend.calibrate_batched``.
    ``fused=False`` is the parity oracle: the lanes go one by one through
    the sequential ``calibrate`` and ``influence_image``.  The exhaustive
    hint sweep stays per episode (it is a batched solve already), so
    ``provide_hint=True`` is refused."""

    def __init__(self, K=6, n_envs=4, provide_influence=False,
                 backend: Optional[radio.RadioBackend] = None, seed=0,
                 fused=True, provide_hint=False, device="cuda"):
        if provide_hint:
            raise ValueError(
                "BatchedDemixingEnv does not provide the hint: the "
                "exhaustive sweep is per episode, run DemixingEnv")
        self.K = K
        self.n_envs = E = int(n_envs)
        self.provide_influence = provide_influence
        self.backend = _backend(backend, device)
        self.fused = fused
        self.npix = self.backend.npix
        self._keys = [prng.PRNGKey(seed + i) for i in range(E)]
        self.metadata = np.zeros((E, 3 * K + 2), np.float32)
        self.elevation = [None] * E
        self.rho = np.ones((E, K), np.float32)
        self.maxiter = np.full(E, 10, np.int32)
        self.std_data = np.ones(E, np.float32)
        self.std_residual = np.ones(E, np.float32)
        self.reward0 = np.zeros(E, np.float32)
        self.lane_episode = np.zeros(E, np.int64)
        self.lane_step = np.zeros(E, np.int64)
        self.eps = [None] * E
        self.mdls = [None] * E
        self.bep = None
        self._last_obs = None

    @property
    def n_actions(self):
        return self.K

    def _next_lane_key(self, i):
        self._keys[i], k = prng.split(self._keys[i])
        return k

    def _masks(self, sel_rows):
        """(E, K) masks from per-lane selected-outlier lists; the target
        (the last direction) is always selected."""
        m = np.zeros((self.n_envs, self.K), np.float32)
        for i, sel in enumerate(sel_rows):
            m[i, sel] = 1.0
            m[i, self.K - 1] = 1.0
        return m

    def _calibrate(self, masks):
        """(solve result(s), per-lane sigma_res (E,) float32)."""
        b = self.backend
        if self.fused:
            res = b.calibrate_batched(self.bep, self.rho, mask=masks,
                                      admm_iters=self.maxiter)
            return res, b.noise_std_batched(res.residual).cpu().numpy()
        results = [b.calibrate(self.eps[i], self.rho[i], mask=masks[i],
                               admm_iters=int(self.maxiter[i]))
                   for i in range(self.n_envs)]
        sig = [float(b.noise_std(r.residual)) for r in results]
        return results, np.asarray(sig, np.float32)

    def _influence_maps(self, res, masks):
        if not self.provide_influence:
            return np.zeros((self.n_envs, self.npix, self.npix), np.float32)
        alpha = np.zeros((self.n_envs, self.K), np.float32)
        rho_eff = self.rho * masks + (1 - masks)
        if self.fused:
            return self.backend.influence_images_batched(
                self.bep, res, rho_eff, alpha).cpu().numpy()
        return np.stack([self.backend.influence_image(
            self.eps[i], res[i], rho_eff[i], alpha[i]).cpu().numpy()
            for i in range(self.n_envs)])

    def calculate_rewards(self, Kselected):
        """``DemixingEnv.calculate_reward_`` over lanes (float32)."""
        data_var = self.std_data ** 2
        noise_var = self.std_residual ** 2
        N = self.backend.n_stations
        reward = (-N * N * noise_var / (data_var + EPS)
                  - np.asarray(Kselected) * N)
        reward = (reward - REWARD_MEAN) / REWARD_STD
        return (reward - self.maxiter / 100.0).astype(np.float32)

    def reset(self):
        """Reset every lane (the start of a vector episode)."""
        return self.reset_lanes(np.ones(self.n_envs, bool))

    def reset_lanes(self, done):
        """Masked reset: rebuild the lanes where ``done`` holds, copy them
        into the batch, and run the batched target-only calibration; live
        lanes keep their observation and baselines."""
        done = np.asarray(done, bool)
        with obs.span("episode_reset", env="demix_batched",
                      lanes=int(done.sum())):
            return self._reset_lanes(done)

    def _reset_lanes(self, done):
        for i in np.where(done)[0]:
            key = self._next_lane_key(i)
            self.eps[i], self.mdls[i] = \
                self.backend.new_demixing_episode(key, self.K)
            self.lane_episode[i] += 1
            self.lane_step[i] = 0
            mdl = self.mdls[i]
            self.elevation[i] = mdl.elevation
            self.rho[i] = mdl.rho.astype(np.float32)
            self.maxiter[i] = 10
            self.metadata[i] = _metadata(mdl, self.eps[i], self.K,
                                         self.backend.n_stations)
            if self.bep is not None:
                self.bep = self.backend.splice_episode(self.bep, int(i),
                                                       self.eps[i])
        if self.bep is None:
            self.bep = self.backend.stack_episodes(self.eps)

        masks = self._masks([[] for _ in range(self.n_envs)])
        res, sig = self._calibrate(masks)
        self.std_data[done] = self.backend.noise_std_batched(
            self.bep.V).cpu().numpy()[done]
        self.std_residual[done] = sig[done]
        self.reward0[done] = self.calculate_rewards(
            np.ones(self.n_envs))[done]
        infmaps = self._influence_maps(res, masks)
        new_obs = {"infmap": infmaps * INF_SCALE,
                   "metadata": self.metadata * META_SCALE}
        if self._last_obs is not None:
            keep = ~done
            for k in new_obs:
                new_obs[k][keep] = self._last_obs[k][keep]
        self._last_obs = new_obs
        return new_obs

    def step(self, actions):
        actions = np.asarray(actions, np.float32)
        if actions.size != self.n_envs * self.K:
            raise ValueError(f"actions shape {actions.shape}, expected "
                             f"({self.n_envs}, {self.K})")
        actions = actions.reshape(self.n_envs, self.K)
        sel = actions[:, :self.K - 1] * (HIGH - LOW) / 2 + (HIGH + LOW) / 2
        self.maxiter = (actions[:, self.K - 1] * (HIGH_ITER - LOW_ITER) / 2
                        + (HIGH_ITER + LOW_ITER) / 2).astype(np.int32)
        masks = self._masks([np.where(s > 0.5)[0].tolist() for s in sel])
        Kselected = masks.sum(axis=1)
        with obs.span("episode_step", env="demix_batched",
                      lanes=self.n_envs):
            res, self.std_residual = self._calibrate(masks)
            infmaps = self._influence_maps(res, masks)
        self.lane_step += 1
        md = self.metadata.copy()
        md[:, :self.K][masks > 0] = 0.0   # separations of calibrated dirs
        observation = {"infmap": infmaps * INF_SCALE,
                       "metadata": md * META_SCALE}
        self._last_obs = observation
        rewards = self.calculate_rewards(Kselected) - self.reward0
        dones = np.zeros(self.n_envs, bool)
        return observation, rewards, dones, {
            "sigma_res": self.std_residual.copy()}

    # -- checkpoint round trip -----------------------------------------------

    def state_dict(self):
        """The per-lane key array and episode/step counters: the episodes
        are a function of the keys and are rebuilt by the next reset."""
        return {"kind": "batched_demix_env",
                "keys": np.stack(self._keys),
                "lane_episode": self.lane_episode.copy(),
                "lane_step": self.lane_step.copy()}

    def load_state_dict(self, state):
        keys = np.asarray(state["keys"], np.uint32)
        if keys.shape[0] != self.n_envs:
            raise ValueError(f"checkpoint has {keys.shape[0]} lanes, env has "
                             f"{self.n_envs}")
        self._keys = [k.copy() for k in keys]
        self.lane_episode = np.asarray(state["lane_episode"]).copy()
        self.lane_step = np.asarray(state["lane_step"]).copy()

    def close(self):
        pass
