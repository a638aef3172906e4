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
episodes in both packages.  ``CalibEnv(prefetch=True)`` builds the next
episode on the backend's worker thread.  :class:`BatchedCalibEnv` advances
E such envs as one batched solve -> influence -> reward pass.
"""

from typing import Optional

import numpy as np

from smartcal_tpu_torch import obs, prng, resolve_device
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
    unchanged).  ``prefetch=True`` builds the NEXT episode on the
    backend's worker thread after each reset, so it overlaps this
    episode's calibrate/influence work; the upcoming key is a function of
    the seed stream, so the episodes are the same.  ``device`` defaults to
    "cuda" and raises without a GPU; a ``backend`` given explicitly must
    live on the same device."""

    def __init__(self, M=5, provide_hint=False,
                 backend: Optional[radio.RadioBackend] = None, seed=0,
                 fixed_K: Optional[int] = None, baseline_reward=False,
                 device="cuda", prefetch=False):
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
        self.prefetch = prefetch
        self._pf_tag = None
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

        with obs.span("episode_step", env="calib"):
            res, img = self._run_calibration()
            with obs.span("reward"):
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

    def _prefetch_tag(self, key):
        # per env instance: two envs on one backend may walk one seed stream
        return f"{type(self).__name__}-{id(self)}-{key.tobytes().hex()}"

    def reset(self):
        with obs.span("episode_reset", env="calib"):
            return self._reset()

    def _reset(self):
        key = self._next_key()
        got = (self.backend.take_prefetched(self._prefetch_tag(key))
               if self.prefetch else None)
        self.K, self.ep, self.mdl = got or self._build_episode(key)
        if self.prefetch:
            # the key the next reset will draw: build it while this one
            # calibrates
            nxt = prng.split(self._key)[1]
            self._pf_tag = self._prefetch_tag(nxt)
            self.backend.prefetch_episode(
                self._pf_tag, lambda k=nxt: self._build_episode(k))
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

    def render(self, mode="human"):
        """Echo the rho vectors (and log them as a ``render`` event)."""
        obs.echo(f"{self.rho_spectral} {self.rho_spatial}", event="render")

    def close(self):
        if self._pf_tag is not None:
            self.backend.discard_prefetched(self._pf_tag)
            self._pf_tag = None


class BatchedCalibEnv:
    """``n_envs`` CalibEnv lanes advanced as one batched pass (counterpart
    of the JAX package's ``BatchedCalibEnv``).

    Lane ``i`` walks ``CalibEnv(M, seed=seed + i)``'s key stream; episode
    construction stays per lane, and the masked ADMM solve, the influence
    chain and the reward images run over all lanes at once
    (``RadioBackend.calibrate_batched`` and friends).  ``reset``/``step``
    take and return stacked arrays: actions (E, 2M) in, observations
    {'img' (E, npix, npix), 'sky' (E, M+1, 7)}, rewards (E,), dones (E,)
    out.  ``reset_lanes`` is the masked reset: a done lane's new episode is
    copied into its slot of the batch, and live lanes keep their state and
    observation.

    ``fused=False`` is the parity oracle: the same lanes go one by one
    through the sequential ``calibrate``, ``influence_image``,
    ``data_image`` and ``residual_image`` and the results are stacked."""

    def __init__(self, M=5, n_envs=4, provide_hint=False,
                 backend: Optional[radio.RadioBackend] = None, seed=0,
                 fixed_K: Optional[int] = None, baseline_reward=False,
                 fused=True, device="cuda"):
        dev = resolve_device(device)
        self.backend = backend or radio.RadioBackend(device=dev)
        if self.backend.device != dev:
            raise ValueError(f"backend on {self.backend.device}, env asked "
                             f"for {dev}")
        if fixed_K is not None and not 2 <= fixed_K <= M:
            raise ValueError(f"fixed_K={fixed_K} outside [2, M={M}]")
        self.M = M
        self.n_envs = E = int(n_envs)
        self.provide_hint = provide_hint
        self.fixed_K = fixed_K
        self.baseline_reward = baseline_reward
        self.fused = fused
        self._keys = [prng.PRNGKey(seed + i) for i in range(E)]
        self.K = np.zeros(E, np.int32)
        self.rho_spectral = np.ones((E, M), np.float32)
        self.rho_spatial = np.ones((E, M), np.float32)
        self.sky = np.zeros((E, M + 1, 7), np.float32)
        self.hint = None
        self._sigma_data_img = np.ones(E, np.float32)
        self._reward0 = np.zeros(E, np.float32)
        self.lane_episode = np.zeros(E, np.int64)
        self.lane_step = np.zeros(E, np.int64)
        self.eps = [None] * E
        self.mdls = [None] * E
        self.bep = None
        self._last_obs = None

    @property
    def n_actions(self):
        return 2 * self.M

    def _next_lane_key(self, i):
        self._keys[i], k = prng.split(self._keys[i])
        return k

    _build_episode = CalibEnv._build_episode

    # -- batched calibrate + reward inputs -----------------------------------

    def _lane_rho_mask(self):
        sel = np.arange(self.M)[None, :] < self.K[:, None]   # (E, M) live
        mask = sel.astype(np.float32)
        rho = np.where(sel, self.rho_spectral, 1.0).astype(np.float32)
        alpha = np.where(sel, self.rho_spatial, 0.0).astype(np.float32)
        return rho, mask, alpha

    def _run_calibration(self):
        """(influence images (E, npix, npix), sigma_data_img, sigma_res_img,
        sigma_res, sigma_data), each (E,), as host numpy."""
        rho, mask, alpha = self._lane_rho_mask()
        b = self.backend
        if self.fused:
            res = b.calibrate_batched(self.bep, rho, mask=mask)
            imgs = b.influence_images_batched(self.bep, res, rho, alpha)
            sig_data, sig_res = b.image_sigmas_batched(self.bep, res)
            return tuple(t.cpu().numpy() for t in (
                imgs, sig_data, sig_res, res.sigma_res, res.sigma_data))
        out = []
        for i, ep in enumerate(self.eps):
            r = b.calibrate(ep, rho[i], mask=mask[i])
            out.append((b.influence_image(ep, r, rho[i], alpha[i])
                        .cpu().numpy(), _std(b.data_image(ep)),
                        _std(b.residual_image(ep, r)), float(r.sigma_res),
                        float(r.sigma_data)))
        imgs, *scalars = zip(*out)
        return (np.stack(imgs),) + tuple(np.asarray(v, np.float32)
                                         for v in scalars)

    def _observation(self, imgs):
        sel = np.arange(self.M)[None, :] < self.K[:, None]
        self.sky[:, :-1, 5] = np.where(sel, _to_unit(self.rho_spectral),
                                       self.sky[:, :-1, 5])
        self.sky[:, :-1, 6] = np.where(sel, _to_unit(self.rho_spatial),
                                       self.sky[:, :-1, 6])
        return {"img": imgs * INF_SCALE, "sky": self.sky * META_SCALE}

    def reset(self):
        """Reset every lane (the start of a vector episode)."""
        return self.reset_lanes(np.ones(self.n_envs, bool))

    def reset_lanes(self, done):
        """Masked reset: rebuild the lanes where ``done`` holds, copy them
        into the batch, and run the batched reset-time calibration; live
        lanes keep their observation and baselines."""
        done = np.asarray(done, bool)
        with obs.span("episode_reset", env="calib_batched",
                      lanes=int(done.sum())):
            return self._reset_lanes(done)

    def _reset_lanes(self, done):
        for i in np.where(done)[0]:
            key = self._next_lane_key(i)
            self.K[i], self.eps[i], self.mdls[i] = self._build_episode(key)
            self.lane_episode[i] += 1
            self.lane_step[i] = 0
            mdl, ep = self.mdls[i], self.eps[i]
            self.rho_spectral[i] = 1.0
            self.rho_spatial[i] = 1.0
            self.rho_spectral[i, :self.K[i]] = mdl.rho
            self.rho_spatial[i, :self.K[i]] = mdl.rho_spatial
            freqs = ep.obs.freqs.cpu().numpy()
            self.sky[i] = 0.0
            self.sky[i, :self.K[i], :5] = mdl.sky_table
            self.sky[i, -1, :5] = [ep.obs.ra0, ep.obs.dec0, self.K[i],
                                   freqs[0] / 1e9, freqs[-1] / 1e9]
            if self.bep is not None:
                self.bep = self.backend.splice_episode(self.bep, int(i), ep)
        if self.bep is None:
            self.bep = self.backend.stack_episodes(self.eps)

        imgs, sig_data, sig_res_img, _, _ = self._run_calibration()
        self._sigma_data_img[done] = sig_data[done]
        self._reward0[done] = 0.0
        if self.baseline_reward:
            r0 = (sig_data / np.maximum(sig_res_img, 1e-12)
                  + 1e-4 / (imgs.std(axis=(1, 2)) + EPS))
            self._reward0[done] = r0[done]
        if self.provide_hint:
            if self.hint is None:
                self.hint = np.zeros((self.n_envs, 2 * self.M), np.float32)
            # reset lanes only: a live lane keeps its own episode's hint
            for i in np.where(done)[0]:
                Ki = self.K[i]
                self.hint[i] = 0.0
                self.hint[i, :Ki] = _to_unit(self.rho_spectral[i, :Ki])
                self.hint[i, self.M:self.M + Ki] = _to_unit(
                    0.05 * self.rho_spectral[i, :Ki])
        new_obs = self._observation(imgs)
        if self._last_obs is not None:
            keep = ~done
            for k in new_obs:
                new_obs[k][keep] = self._last_obs[k][keep]
        self._last_obs = new_obs
        return new_obs

    def step(self, actions):
        actions = np.asarray(actions, np.float32)
        if actions.size != self.n_envs * 2 * self.M:
            raise ValueError(f"actions shape {actions.shape}, expected "
                             f"({self.n_envs}, {2 * self.M})")
        actions = actions.reshape(self.n_envs, 2 * self.M)
        rho = actions * (HIGH - LOW) / 2 + (HIGH + LOW) / 2
        sel = np.arange(self.M)[None, :] < self.K[:, None]
        self.rho_spectral = np.where(sel, rho[:, :self.M], self.rho_spectral)
        self.rho_spatial = np.where(sel, rho[:, self.M:], self.rho_spatial)
        penalty = np.zeros(self.n_envs, np.float32)
        for arr in (self.rho_spectral, self.rho_spatial):
            penalty += -0.1 * np.sum(sel & (arr < LOW), axis=1)
            penalty += -0.1 * np.sum(sel & (arr > HIGH), axis=1)
            np.clip(arr, LOW, HIGH, out=arr)

        with obs.span("episode_step", env="calib_batched",
                      lanes=self.n_envs):
            imgs, _, sig_res_img, sigma_res, sigma_data = \
                self._run_calibration()
        rewards = (self._sigma_data_img / np.maximum(sig_res_img, 1e-12)
                   + 1e-4 / (imgs.std(axis=(1, 2)) + EPS) + penalty
                   - self._reward0).astype(np.float32)
        self.lane_step += 1
        observation_ = self._observation(imgs)
        self._last_obs = observation_
        dones = np.zeros(self.n_envs, bool)
        infos = {"sigma_res": sigma_res, "sigma_data": sigma_data}
        if self.provide_hint:
            return observation_, rewards, dones, self.hint, infos
        return observation_, rewards, dones, infos

    # -- checkpoint round trip -----------------------------------------------

    def state_dict(self):
        """The per-lane key array and episode/step counters: the episodes
        are a function of the keys and are rebuilt by the next reset."""
        return {"kind": "batched_calib_env",
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
