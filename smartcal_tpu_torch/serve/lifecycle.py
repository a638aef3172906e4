"""Online lifecycle: learn from served traffic, publish policy hot-swaps
with no downtime (the port's counterpart of smartcal_tpu/serve/lifecycle.py,
same API and events).

Closes the train/serve loop around :class:`~smartcal_tpu_torch.serve.server
.CalibServer`:

* **tee**: the server's ``transition_sink`` hook feeds every completed
  non-warm, obs-bearing request into a :class:`TransitionStage` (a bounded
  host staging ring: the batch worker pays one locked append);
* **learn**: :class:`ServingLearner` drains the stage into the sharded
  versioned replay (``rl/replay_sharded`` over ``replay.versioned_spec``)
  and runs the SAC learn step beside the server with IMPACT
  staleness-clipped IS weighting and ERE recency bias armed
  (``sac.learn(..., learner_version=...)``): served traffic is off-policy
  and ages across swaps;
* **publish**: :class:`PolicyPublisher` persists each new snapshot keyed on
  ``(version, serve_signature)`` through the
  :class:`~smartcal_tpu_torch.serve.export.ExportCache` and swaps it into
  the server between micro-batch flushes (``CalibServer.swap_policy``;
  fleet-wide through ``FleetRouter.publish_policy`` weight frames).

The exported policy program takes the weights as an operand, so a
publication re-persists the same program under the new versioned key and
runs one forward with the new weights: no export, no nvcc build, no graph
capture.  Tool: ``python -m smartcal_tpu_torch.tools.serve_learn``.
"""

import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from smartcal_tpu_torch import obs, resolve_device
from smartcal_tpu_torch.envs import calib as calib_env


def _event(name: str, **fields) -> None:
    rl = obs.active()
    if rl is not None:
        rl.log(name, **fields)


# ---------------------------------------------------------------------------
# observation construction (the serving side of the CalibEnv contract)
# ---------------------------------------------------------------------------

def job_obs_vec(backend, episode, k: int, M: int,
                npix: Optional[int] = None,
                probe_iters: Optional[int] = None) -> np.ndarray:
    """Flattened policy observation for a serving job, in the CalibEnv
    convention (``envs/calib``): the influence image of a unit-rho probe
    calibration x ``INF_SCALE``, then an (M+1)x7 sky/meta table x
    ``META_SCALE`` with the unit-rho columns (5/6) and the live-direction
    fraction in the spare last row.  Built offline at pool construction
    (one probe calibrate + influence per entry); the serving hot path
    carries observations, it never computes them."""
    npix = int(npix or backend.npix)
    rho = np.ones(M, np.float32)
    alpha = np.zeros(M, np.float32)
    mask = np.zeros(M, np.float32)
    mask[:k] = 1.0
    iters = int(probe_iters or backend.admm_iters)
    r = backend.calibrate(episode, rho, mask=mask, admm_iters=iters)
    img = backend.influence_image(episode, r, rho, alpha, npix=npix)
    img = img.detach().cpu().numpy().astype(np.float32)
    sky = np.zeros((M + 1, 7), np.float32)
    sky[:k, 5] = calib_env._to_unit(rho[:k])
    sky[:k, 6] = calib_env._to_unit(alpha[:k])
    sky[M, 0] = k / max(1, M)
    return np.concatenate([
        (img * calib_env.INF_SCALE).ravel(),
        (sky * calib_env.META_SCALE).ravel()]).astype(np.float32)


def build_obs_pool(backend, M: int, n: int, seed: int = 0,
                   heterogeneous: bool = True,
                   diffuse_frac: float = 0.25,
                   npix: Optional[int] = None
                   ) -> List[Tuple[int, object, np.ndarray]]:
    """A :func:`~smartcal_tpu_torch.serve.loadgen.build_job_pool` pool with
    the flattened observation attached per entry: ``(k, episode, obs_vec)``
    triples, so every job can ride the policy forward and the replay tee."""
    from .loadgen import build_job_pool

    pool = build_job_pool(backend, M, n, seed=seed,
                          heterogeneous=heterogeneous,
                          diffuse_frac=diffuse_frac)
    return [(k, ep, job_obs_vec(backend, ep, k, M, npix=npix))
            for k, ep in pool]


# ---------------------------------------------------------------------------
# the tee: batch worker -> learner staging
# ---------------------------------------------------------------------------

class TransitionStage:
    """Bounded thread-safe staging ring between the batch worker (the
    server's ``transition_sink``) and the learner's ingest loop.  The
    worker-side cost is one locked list-extend per batch; overflow drops
    the oldest staged transitions (counted), never blocks."""

    def __init__(self, cap: int = 4096):
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._items: list = []
        self._dropped = 0
        self._staged = 0

    def __call__(self, transitions: list) -> None:
        """The ``CalibServer(transition_sink=...)`` hook."""
        with self._lock:
            self._items.extend(transitions)
            self._staged += len(transitions)
            over = len(self._items) - self.cap
            if over > 0:
                del self._items[:over]
                self._dropped += over
        if transitions:
            obs.counter_add("lifecycle_staged", len(transitions))

    def drain(self) -> list:
        with self._lock:
            items, self._items = self._items, []
        return items

    def stats(self) -> dict:
        with self._lock:
            return {"staged": self._staged, "dropped": self._dropped,
                    "pending": len(self._items)}


# ---------------------------------------------------------------------------
# publication: versioned re-persist + atomic swap
# ---------------------------------------------------------------------------

class PolicyPublisher:
    """Publish a new policy snapshot to a warmed server (and optionally a
    replica fleet): ExportCache entry keyed on (version, serve_signature)
    -> a forward with the new weights -> atomic ``swap_policy`` between
    micro-batch flushes.  Runs on the caller's thread (the learner loop),
    never on the batch worker's."""

    def __init__(self, server, fleet=None, keep_versions: int = 8):
        self.server = server
        self.fleet = fleet
        self.keep_versions = int(keep_versions)
        self._lock = threading.Lock()
        self._stats = {"publishes": 0, "last_publish_s": 0.0,
                       "last_version": 0}

    def publish(self, actor_params, version: int) -> dict:
        """Synchronous publication; returns the timing record."""
        srv = self.server
        if srv._base_sig is None:
            raise RuntimeError("publish before server warmup() — no "
                               "serve signature to key the program on")
        t0 = time.monotonic()
        with obs.span("serve_publish", version=int(version)):
            sig = srv._policy_sig(srv._base_sig, version)
            t_exp = time.monotonic()
            prog = srv.cache.publish(sig, srv._program("policy"))
            export_s = time.monotonic() - t_exp
            swap = srv.swap_policy(actor_params, version, program=prog)
            srv.cache.prune("policy", self.keep_versions)
            reached = 0
            if self.fleet is not None:
                reached = self.fleet.publish_policy(actor_params, version)
        publish_s = time.monotonic() - t0
        with self._lock:
            self._stats["publishes"] += 1
            self._stats["last_publish_s"] = publish_s
            self._stats["last_version"] = int(version)
        obs.counter_add("policy_publishes")
        _event("policy_publish", version=int(version),
               export_s=round(export_s, 6),
               swap_s=round(swap["swap_s"], 6),
               publish_s=round(publish_s, 6), fleet_reached=reached)
        return {"version": int(version), "export_s": export_s,
                "swap_s": swap["swap_s"], "publish_s": publish_s,
                "fleet_reached": reached}

    def stats(self) -> dict:
        with self._lock:
            return dict(self._stats)


# ---------------------------------------------------------------------------
# the learner beside the server
# ---------------------------------------------------------------------------

class ServingLearner:
    """SAC learner over the sharded versioned replay, fed by the server tee
    and publishing through a :class:`PolicyPublisher`.

    ``version`` is the learner's last published version: transitions teed
    from the current serving snapshot carry it and get IMPACT weight
    exactly 1.0; transitions from older snapshots get the clipped
    importance ratio.  ``cfg.is_clip`` / ``cfg.ere_eta`` should be armed
    for the lifecycle regime (the tool's defaults).  The agent, ring and
    generator live on ``device`` (default "cuda")."""

    def __init__(self, cfg, seed: int = 0, n_shards: int = 4,
                 publisher: Optional[PolicyPublisher] = None,
                 publish_every: int = 8, ingest_chunk: int = 16,
                 device="cuda"):
        from smartcal_tpu_torch.rl import replay as rp
        from smartcal_tpu_torch.rl import replay_sharded as rps
        from smartcal_tpu_torch.rl import sac

        self.cfg = cfg
        self.device = resolve_device(device)
        self.publisher = publisher
        self.publish_every = int(publish_every)
        self.ingest_chunk = int(ingest_chunk)
        self.generator = torch.Generator(
            device=self.device).manual_seed(int(seed))
        self.state = sac.sac_init(cfg, self.generator, self.device)
        self._spec = rp.versioned_spec(
            rp.transition_spec(cfg.obs_dim, cfg.n_actions))
        self.buffer = rps.place_on_mesh(
            rps.replay_init(cfg.mem_size, self._spec, n_shards,
                            device=self.device))
        self._rps = rps
        self._sac = sac
        self._pending: list = []
        self.version = 0
        self.learns = 0
        self.ingested = 0
        self.last_metrics: dict = {}

    @property
    def actor_params(self) -> dict:
        """A copy of the actor's weights by name (the learner updates its
        own tensors in place), complete when this returns."""
        snap = {k: v.detach().clone()
                for k, v in self.state.actor.state_dict().items()}
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return snap

    def warm(self) -> None:
        """Run the paths of the serving window once before it opens: two
        learn steps (no-ops on the empty ring) and, with a publisher wired,
        a publication of the current version, so the window's first real
        publication is a warm one."""
        for _ in range(2):
            self.step()
        self.learns = 0                      # warm steps don't count
        if self.publisher is not None:
            self.publisher.publish(self.actor_params, self.version)

    def ingest(self, transitions: list) -> int:
        """Stage transition dicts and store them in fixed-size chunks
        (round-robin across the replay shards); leftovers below a chunk
        stay pending for the next call.  Returns the number stored."""
        self._pending.extend(transitions)
        stored = 0
        while len(self._pending) >= self.ingest_chunk:
            batch = self._pending[:self.ingest_chunk]
            del self._pending[:self.ingest_chunk]
            flat = {k: np.stack([np.asarray(t[k]) for t in batch])
                    for k in batch[0]}
            self._rps.replay_add_batch(self.buffer, flat)
            stored += len(batch)
        self.ingested += stored
        return stored

    def step(self, pull_metrics: bool = False) -> Optional[dict]:
        """One learn step at the current learner version (a no-op until the
        ring holds a batch)."""
        metrics = self._sac.learn(self.cfg, self.state, self.buffer,
                                  self.generator,
                                  learner_version=int(self.version))
        self.learns += 1
        if pull_metrics:
            host = {k: float(v) for k, v in metrics.items()
                    if isinstance(v, torch.Tensor) and v.dim() == 0}
            self.last_metrics = host
            return host
        return None

    def maybe_publish(self) -> Optional[dict]:
        """Publish version N+1 every ``publish_every`` learns (once the ring
        has actually learned something)."""
        if (self.publisher is None or self.learns == 0
                or self.learns % self.publish_every != 0):
            return None
        if int(self.buffer.cntr) < self.cfg.batch_size:
            return None                  # nothing learned yet: hold fire
        self.version += 1
        return self.publisher.publish(self.actor_params, self.version)

    def staleness(self) -> dict:
        """Host staleness profile of the ring vs the published version."""
        return self._rps.version_staleness(self.buffer, self.version)
