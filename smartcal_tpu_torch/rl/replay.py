"""Replay buffers resident in device memory (counterpart of
smartcal_tpu/rl/replay.py).

A :class:`ReplayState` is a ring of per-field tensors on the device, its
priorities and two host scalars: the store counter ``cntr`` and the PER
exponent ``beta``.  Both evolve deterministically (one per store, one per
prioritized sample), so keeping them on the host lets every decision
(ring slot, fill level, "enough to learn?") be made with no device sync.

The episode programs (``train/blocks.make_block_fn``) carry both as 0-d
device tensors instead, as the JAX state does: a CUDA graph bakes host
numbers in at capture.  Every function here takes either form; on the
device form a store writes its slot with ``index_copy_`` and bumps
``cntr`` in place, the uniform sampler draws Gumbel noise over the whole
ring and masks the unfilled slots (the JAX package's draw), and ``beta``
anneals in place.

* uniform sampling without replacement: Gumbel-top-k over the filled
  prefix, an exact draw of a uniform subset;
* prioritized sampling: stratified prefix-sum search, ``searchsorted(
  cumsum(p), v)``, with IS weights and beta annealing (reference
  ``PER.sample_buffer``);
* ERE: per-slot recency weights, alone or modulating PER.

Every sampler takes its randomness either from a ``torch.Generator`` on the
ring's device or explicitly (the Gumbel noise or the uniforms), so the
parity tests can feed the draws the JAX package made from its keys.  The
functions update the buffer in place.
"""

import math

import numpy as np
import torch

from smartcal_tpu_torch.runtime.atomic import atomic_pickle, strict_pickle_load

# PER constants (reference enet_sac.py:208-212)
PER_EPSILON = 0.01
PER_ALPHA = 0.6
PER_BETA0 = 0.4
PER_BETA_INCREMENT = 1e-4
# exponent span of the ERE weighting: the oldest filled slot weighs
# eta**ERE_SPAN relative to the newest
ERE_SPAN = 100.0


class ReplayState:
    """``data``: field -> (size, ...) tensors; ``priority``: (size,) tensor
    (all ones for uniform buffers); ``cntr``: total stores (host int);
    ``beta``: the PER exponent (host float32)."""

    def __init__(self, data, priority, cntr=0, beta=PER_BETA0):
        self.data = data
        self.priority = priority
        self.cntr = int(cntr)
        self.beta = np.float32(beta)

    @property
    def size(self) -> int:
        return self.priority.shape[0]

    @property
    def filled(self):
        """Stored transitions held: a host int, or a 0-d tensor on the
        device form."""
        if torch.is_tensor(self.cntr):
            return torch.clamp(self.cntr, max=self.size)
        return min(self.cntr, self.size)

    @property
    def on_device(self) -> bool:
        """True when ``cntr`` and ``beta`` are 0-d device tensors (the
        form inside an episode program)."""
        return torch.is_tensor(self.cntr)

    @property
    def device(self) -> torch.device:
        return self.priority.device


def transition_spec(obs_dim: int, n_actions: int) -> dict:
    """Flat-observation transition layout (reference enet_sac.py:27-32)."""
    return {
        "state": ((obs_dim,), torch.float32),
        "new_state": ((obs_dim,), torch.float32),
        "action": ((n_actions,), torch.float32),
        "reward": ((), torch.float32),
        "done": ((), torch.bool),
        "hint": ((n_actions,), torch.float32),
    }


def versioned_spec(spec: dict) -> dict:
    """``spec`` with the fleet's provenance fields: ``version`` (the policy
    snapshot the acting actor held, the learner's staleness currency) and
    ``behavior_logp`` (log pi_behavior of the stored action, the
    denominator of the clipped importance ratio).  The stores write only
    the keys a ring was built with, so versioned and plain rings share
    every other path."""
    return {**spec, "version": ((), torch.int32),
            "behavior_logp": ((), torch.float32)}


def backend_for(buf: object):
    """The replay module of ``buf``'s layout: this module for the flat
    :class:`ReplayState`, :mod:`~smartcal_tpu_torch.rl.replay_sharded` for
    its ``ShardedReplayState``.  Both expose the same store, sample and
    update names, so the agents' learn steps dispatch on the ring type."""
    import sys

    from smartcal_tpu_torch.rl import replay_sharded as rps

    if isinstance(buf, rps.ShardedReplayState):
        return rps
    return sys.modules[__name__]


def staleness_clip_weights(raw, versions, learner_version, clip_c: float):
    """The staleness-gated clipped weights every agent's fleet weighting
    shares (``sac.impact_weights``, the discrete twin,
    ``td3.staleness_weights``): ``raw`` (a per-transition weight, or a
    callable of the staleness) clipped to ``[1/clip_c, clip_c]`` for stale
    transitions and exactly 1.0 at staleness <= 0.  Returns ``(weights,
    aux)``, aux the staleness mean, the mean weight and the fraction of
    stale transitions whose raw weight hit a bound."""
    if not torch.is_tensor(learner_version):
        learner_version = int(learner_version)   # no host-to-device copy
    stale = (learner_version - versions.to(torch.int32)).to(torch.float32)
    if callable(raw):
        raw = raw(stale)
    is_stale = stale > 0
    lo, hi = 1.0 / clip_c, clip_c
    w = torch.where(is_stale, torch.clamp(raw, lo, hi), 1.0)
    n_stale = torch.clamp(torch.sum(is_stale.to(torch.float32)), min=1.0)
    saturated = is_stale & ((raw >= hi) | (raw <= lo))
    aux = {"staleness_mean": torch.mean(stale),
           "is_clip_mean": torch.mean(w),
           "is_clip_saturation": torch.sum(saturated.to(torch.float32))
           / n_stale}
    return w, aux


def zero_clip_aux(device="cpu") -> dict:
    """The no-learn branch's :func:`staleness_clip_weights` aux (identity
    weights, nothing stale)."""
    return {"staleness_mean": torch.zeros((), device=device),
            "is_clip_mean": torch.ones((), device=device),
            "is_clip_saturation": torch.zeros((), device=device)}


def validate_fleet_knobs(is_clip: float, ere_eta: float,
                         replay_backend: str = "hbm") -> None:
    """Config-time checks of the fleet knobs, as the JAX package makes
    them."""
    if is_clip != 0.0 and is_clip < 1.0:
        raise ValueError(f"is_clip must be 0 (off) or >= 1, got {is_clip}")
    if not 0.0 < ere_eta <= 1.0:
        raise ValueError(f"ere_eta must be in (0, 1], got {ere_eta}")
    if replay_backend == "native" and (is_clip > 0 or ere_eta < 1.0):
        raise ValueError(
            "is_clip/ere_eta are features of the device-resident (hbm) "
            "replay path; the native sum-tree backend does not apply "
            "them — use replay_backend='hbm'")


def priority_from_errors(errors, error_clip: float = 100.0):
    """Store-time priority min((|e| + eps)^alpha, clip)
    (``PER.store_transition``); :func:`replay_update_priorities` clips the
    error before the exponent instead, as the reference does."""
    errors = torch.as_tensor(errors, dtype=torch.float32)
    return torch.clamp((errors.abs() + PER_EPSILON) ** PER_ALPHA,
                       max=error_clip)


def replay_init(size: int, spec: dict, device="cuda") -> ReplayState:
    data = {k: torch.zeros((size,) + tuple(shape), dtype=dtype,
                           device=device)
            for k, (shape, dtype) in spec.items()}
    return ReplayState(data, torch.zeros(size, dtype=torch.float32,
                                         device=device))


def _device_add(buf, transition, priority, error, error_clip):
    """:func:`replay_add` on the device form: slot ``cntr % size`` written
    with ``index_copy_`` (Python numbers by a fill), ``cntr`` bumped in
    place; no host number depends on the device."""
    idx = torch.remainder(buf.cntr, buf.size).reshape(1)
    for k, v in buf.data.items():
        val = transition[k]
        if torch.is_tensor(val):
            val = val.to(device=v.device, dtype=v.dtype)
        else:
            val = torch.full(v.shape[1:], val, dtype=v.dtype,
                             device=v.device)
        v.index_copy_(0, idx, val.reshape((1,) + v.shape[1:]))
    if priority is None:
        if error is None:
            pmax = buf.priority.max()
            priority = torch.where(pmax == 0.0, error_clip, pmax)
        else:
            priority = priority_from_errors(error, error_clip).to(buf.device)
    if torch.is_tensor(priority):
        buf.priority.index_copy_(0, idx, priority.to(torch.float32)
                                 .reshape(1))
    else:
        buf.priority.index_fill_(0, idx, float(priority))
    buf.cntr += 1


def _store_priority(buf, idx, priority, errors, error_clip):
    if priority is None:
        if errors is None:
            pmax = buf.priority.max()
            priority = torch.where(pmax == 0.0, error_clip, pmax)
        else:
            priority = priority_from_errors(errors, error_clip).to(
                buf.device)
    buf.priority[idx] = priority


def replay_add(buf: ReplayState, transition: dict, priority=None,
               error=None, error_clip: float = 100.0) -> None:
    """Store one transition (host arrays or tensors) at ``cntr % size``.
    Priority: ``priority`` when given; else min((|error|+eps)^alpha, clip);
    else the current max priority (``clip`` while the buffer is
    untouched), as ``PER.store_transition`` does."""
    if buf.on_device:
        return _device_add(buf, transition, priority, error, error_clip)
    idx = buf.cntr % buf.size
    for k, v in buf.data.items():
        v[idx] = torch.as_tensor(transition[k], dtype=v.dtype,
                                 device=v.device)
    _store_priority(buf, slice(idx, idx + 1), priority, error, error_clip)
    buf.cntr += 1


def replay_add_batch(buf: ReplayState, transitions: dict, priority=None,
                     errors=None, error_clip: float = 100.0) -> None:
    """Store a leading-axis batch of transitions at consecutive ring slots
    (priorities as :func:`replay_add`, per transition)."""
    n = len(next(iter(transitions.values())))
    idx = (buf.cntr + torch.arange(n, device=buf.device)) % buf.size
    for k, v in buf.data.items():
        v[idx] = torch.as_tensor(transitions[k], dtype=v.dtype,
                                 device=v.device)
    _store_priority(buf, idx, priority, errors, error_clip)
    buf.cntr += n


def _gather(buf, idx):
    return {k: v[idx] for k, v in buf.data.items()}


def gumbel(n, generator=None, device="cuda"):
    """``jax.random.gumbel``'s transform of uniforms: -log(-log(u))."""
    u = torch.rand(n, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))


def replay_sample_uniform(buf: ReplayState, batch_size: int,
                          generator=None, gumbel_noise=None):
    """Uniform sample without replacement over the filled prefix:
    Gumbel-top-k.  ``gumbel_noise``: (size,) or (filled,) Gumbel draws
    (default: drawn from ``generator``; over the whole ring on the device
    form, whose unfilled slots score -inf).  Returns (batch, idx)."""
    if buf.on_device:
        n = buf.size
        if gumbel_noise is None:
            gumbel_noise = gumbel(n, generator, buf.device)
        slots = torch.arange(n, device=buf.device)
        score = torch.where(slots < buf.filled, gumbel_noise[:n],
                            float("-inf"))
        _, idx = torch.topk(score, batch_size)
        return _gather(buf, idx), idx
    filled = buf.filled
    if gumbel_noise is None:
        gumbel_noise = gumbel(filled, generator, buf.device)
    _, idx = torch.topk(gumbel_noise[:filled], batch_size)
    return _gather(buf, idx), idx


def _stratified(weights, batch_size, generator, u):
    """Stratified draw (with replacement) from ``weights``: one uniform per
    equal segment of the cumulative sum.  Returns (idx, csum total)."""
    csum = torch.cumsum(weights, 0)
    total = csum[-1]
    if u is None:
        u = torch.rand(batch_size, generator=generator, device=csum.device)
    values = (torch.arange(batch_size, dtype=torch.float32,
                           device=csum.device) + u) * (total / batch_size)
    idx = torch.searchsorted(csum, values).clamp_(0, weights.shape[0] - 1)
    return idx, total


def replay_sample_per(buf: ReplayState, batch_size: int, generator=None,
                      u=None, recency_eta=None):
    """Stratified priority sampling + IS weights (enet_sac.py:270-312);
    ``recency_eta`` < 1 modulates the priorities by :func:`ere_weights`, and
    the IS correction is taken against the distribution sampled from.
    ``u``: the (batch_size,) uniforms (default: from ``generator``).
    Anneals ``buf.beta``; returns (batch, idx, is_weights)."""
    priority = buf.priority
    if recency_eta is not None and recency_eta < 1.0:
        priority = priority * ere_weights(buf, recency_eta)
    if buf.on_device:
        beta = torch.clamp(buf.beta + np.float32(PER_BETA_INCREMENT),
                           max=1.0)
    else:
        beta = np.minimum(np.float32(1.0),
                          buf.beta + np.float32(PER_BETA_INCREMENT))
    idx, total = _stratified(priority, batch_size, generator, u)
    probs = priority[idx] / total
    if buf.on_device:
        is_w = torch.pow(batch_size * probs, -beta)
        buf.beta.copy_(beta)
    else:
        is_w = (batch_size * probs) ** (-float(beta))
        buf.beta = beta
    return _gather(buf, idx), idx, is_w / is_w.max()


def ere_weights(buf: ReplayState, eta: float):
    """Emphasizing-recent-experience weights over the ring slots (Wang &
    Ross, arXiv:1906.04009, as a per-slot weighting): slot weight
    ``eta ** (ERE_SPAN * age / (filled - 1))``, age 0 for the newest write;
    unfilled slots weigh 0."""
    n, filled = buf.size, buf.filled
    slots = torch.arange(n, device=buf.device)
    ages = torch.remainder(buf.cntr - 1 - slots, max(n, 1))
    if buf.on_device:
        x = ages.to(torch.float32) / torch.clamp(filled - 1, min=1)
    else:
        x = ages.to(torch.float32) / max(filled - 1, 1)
    # a Python base: no host-to-device copy (the same float32 bits)
    w = torch.pow(float(eta), ERE_SPAN * x)
    return torch.where(slots < filled, w, 0.0)


def replay_sample_ere(buf: ReplayState, batch_size: int, eta: float,
                      generator=None, u=None):
    """Recency-weighted stratified sampling for uniform buffers (no IS
    correction, as in the ERE paper).  Returns (batch, idx)."""
    idx, _ = _stratified(ere_weights(buf, eta), batch_size, generator, u)
    return _gather(buf, idx), idx


def replay_update_priorities(buf: ReplayState, idx, errors,
                             error_clip: float = 100.0) -> None:
    """``batch_update`` (enet_sac.py:314-323): p = min(|e| + eps, clip)^alpha.
    A slot drawn twice takes the value of its last draw, on every device
    (each duplicate writes that same value)."""
    p = torch.clamp(errors.abs() + PER_EPSILON, max=error_clip) ** PER_ALPHA
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = ((idx[:, None] == idx[None, :]) * pos).argmax(dim=1)
    buf.priority[idx] = p[last]


def per_mse(expected, targets, is_weights):
    """IS-weighted MSE (reference ``PER.mse``, enet_sac.py:326-329)."""
    td = expected - targets
    w = is_weights.reshape(is_weights.shape + (1,) * (td.dim() - 1))
    return torch.sum(w * td * td) / td.numel()


def replay_health(buf: ReplayState, n_age_bins: int = 4) -> dict:
    """Host-side replay summary for telemetry (one device->host pull of the
    filled priorities): fill counters, beta, normalized priority entropy
    (1 = uniform), max/mean priority ratio, IS-weight extremes at the
    current beta, uniform vs priority-weighted mean age, and the priority
    mass per age quartile (young to old)."""
    p = buf.priority[:buf.filled].cpu().numpy()
    return health_from_arrays(p, buf.cntr, buf.size, float(buf.beta),
                              n_age_bins)


def health_from_arrays(p, cntr: int, size: int, beta: float,
                       n_age_bins: int = 4) -> dict:
    """:func:`replay_health`'s math over host priorities ``p`` (at least
    the filled prefix), shared with the native sum-tree replay."""
    filled = int(min(cntr, size))
    out = {"filled": filled, "cntr": int(cntr), "size": int(size),
           "beta": float(beta)}
    if filled == 0:
        return out
    p = np.asarray(p[:filled], np.float64)
    total = float(p.sum())
    out["priority_total"] = total
    out["priority_max"] = float(p.max())
    if total <= 0.0:
        out["priority_entropy"] = 0.0
        out["max_mean_priority_ratio"] = 0.0
        return out
    probs = p / total
    nz = probs[probs > 0]
    h = float(-(nz * np.log(nz)).sum())
    out["priority_entropy"] = h / math.log(filled) if filled > 1 else 1.0
    out["max_mean_priority_ratio"] = float(p.max() / p.mean())
    w = (filled * np.maximum(probs, 1e-12)) ** (-float(beta))
    out["is_weight_min"] = float(w.min())
    out["is_weight_max"] = float(w.max())
    ages = (int(cntr) - 1 - np.arange(filled)) % max(size, 1)
    out["age_mean_uniform"] = float(ages.mean())
    out["age_mean_weighted"] = float((probs * ages).sum())
    edges = np.linspace(0, max(float(ages.max()), 1.0), n_age_bins + 1)
    which = np.minimum(np.searchsorted(edges, ages, side="right") - 1,
                       n_age_bins - 1)
    out["age_priority_hist"] = [round(float(probs[which == b].sum()), 6)
                                for b in range(n_age_bins)]
    return out


def replay_to_host(buf: ReplayState) -> dict:
    """The filled prefix of the ring as numpy arrays, with ``cntr``,
    ``beta`` and the ring size (the slots past the prefix were never
    written and are zero).  A 10,000-slot ring of 128² observations holds
    1.3 GB; after an episode of a fresh run the prefix is a few
    transitions."""
    n = buf.filled
    return {"size": buf.size, "cntr": buf.cntr, "beta": float(buf.beta),
            "data": {k: v[:n].cpu().numpy() for k, v in buf.data.items()},
            "priority": buf.priority[:n].cpu().numpy()}


def save_replay(buf: ReplayState, path: str) -> None:
    """Save :func:`replay_to_host` of the ring (atomic write)."""
    atomic_pickle(replay_to_host(buf), path)


def replay_from_host(payload: dict, device="cuda") -> ReplayState:
    """A full-size ring on ``device`` holding a :func:`save_replay`
    payload."""
    size, n = payload["size"], len(payload["priority"])
    data = {}
    for k, arr in payload["data"].items():
        t = torch.from_numpy(np.asarray(arr))
        data[k] = torch.zeros((size,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=device)
        data[k][:n] = t.to(device)
    priority = torch.zeros(size, dtype=torch.float32, device=device)
    priority[:n] = torch.from_numpy(np.asarray(payload["priority"])).to(
        device)
    return ReplayState(data, priority, payload["cntr"], payload["beta"])


def load_replay(path: str, device="cuda") -> ReplayState:
    return replay_from_host(strict_pickle_load(path), device)


def merge_from_buffer(dst: ReplayState, src_host: dict, n: int) -> None:
    """Learner-side ingestion of an actor's host buffer (reference
    ``store_transition_from_buffer``, enet_sac.py:254-268): the first
    ``n`` transitions enter one by one with max-priority initialisation."""
    for i in range(n):
        replay_add(dst, {k: np.asarray(v[i]) for k, v in src_host.items()})
