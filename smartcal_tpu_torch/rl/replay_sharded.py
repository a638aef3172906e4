"""The sharded replay ring (counterpart of smartcal_tpu/rl/replay_sharded.py)
on one device.

Layout: every field is ``(S, local, ...)`` and the priorities ``(S,
local)``, with a global store counter ``cntr`` and the PER exponent
``beta`` on the host (as in ``rl/replay``).  The global ring is
interleaved round-robin over the shards: store number ``t`` lands at ring
slot ``r = t % size``, shard ``r % S``, local slot ``r // S``, so cell
``(s, j)`` holds what slot ``j*S + s`` of the flat ring holds and ages, ERE
weights and fill match the flat ring exactly.

The JAX package lays the shard axis over a mesh and merges per-shard
draws with collectives.  On one GPU the shard axis is the leading axis of
one tensor: the store is one scatter whose (shard, slot) targets follow
from the host counter, and the stratified draw searches the S shard
totals, then the chosen shard's local prefix sums, exactly as JAX's
per-shard draw routes each value.  Every sampler takes its randomness
from a ``torch.Generator`` or explicitly (``u``, ``gumbel_noise``), so the
parity tests feed the draws JAX made.  Nothing here moves the sampled
batch to the host.  The functions update the ring in place.
"""

import numpy as np
import torch

from smartcal_tpu_torch.parallel.mesh import (AXIS_REPLAY,
                                              MeshFactorizationError,
                                              check_axis_divides)
from smartcal_tpu_torch.rl import replay as rp


class ShardedReplayState:
    """``data``: field -> (S, local, ...) tensors; ``priority``: (S, local);
    ``cntr``: global stores (host int); ``beta``: host float32."""

    def __init__(self, data, priority, cntr=0, beta=rp.PER_BETA0):
        self.data = data
        self.priority = priority
        self.cntr = int(cntr)
        self.beta = np.float32(beta)

    @property
    def n_shards(self) -> int:
        return self.priority.shape[0]

    @property
    def local_size(self) -> int:
        return self.priority.shape[1]

    @property
    def size(self) -> int:
        return self.n_shards * self.local_size

    @property
    def filled(self) -> int:
        return min(self.cntr, self.size)

    @property
    def device(self) -> torch.device:
        return self.priority.device

    def health(self) -> dict:
        return replay_health(self)


def replay_init(size: int, spec: dict, n_shards: int,
                device="cuda") -> ShardedReplayState:
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if size % n_shards != 0:
        raise ValueError(
            f"buffer size {size} must be divisible by n_shards "
            f"{n_shards} (the round-robin ring needs equal shards)")
    local = size // n_shards
    data = {k: torch.zeros((n_shards, local) + tuple(shape), dtype=dtype,
                           device=device)
            for k, (shape, dtype) in spec.items()}
    return ShardedReplayState(data, torch.zeros((n_shards, local),
                                                dtype=torch.float32,
                                                device=device))


def place_on_mesh(buf: ShardedReplayState, mesh=None,
                  axis: str = AXIS_REPLAY) -> ShardedReplayState:
    """The JAX package commits the ring to a device mesh.  The port's mesh
    is one device, so the placement is a check: an explicit ``mesh`` must
    carry ``axis`` with a size that divides ``n_shards`` (raises
    :class:`MeshFactorizationError` otherwise), and the ring is moved to
    the mesh's device."""
    if mesh is None:
        return buf
    if axis not in mesh.shape:
        raise MeshFactorizationError(
            f"place_on_mesh: mesh has no axis {axis!r} "
            f"(mesh axes: {tuple(mesh.shape)})")
    check_axis_divides(buf.n_shards, mesh.shape[axis], axis=axis,
                       what="place_on_mesh n_shards")
    dev = mesh.device
    return ShardedReplayState({k: v.to(dev) for k, v in buf.data.items()},
                              buf.priority.to(dev), buf.cntr, buf.beta)


def _cells(buf, n):
    """(shard, local) index tensors of the next ``n`` stores, from the host
    counter."""
    S, L = buf.priority.shape
    t = buf.cntr + np.arange(n)
    dev = buf.device
    return (torch.as_tensor(t % S, device=dev),
            torch.as_tensor((t // S) % L, device=dev))


def replay_add_batch(buf: ShardedReplayState, transitions: dict,
                     priority=None, errors=None,
                     error_clip: float = 100.0) -> None:
    """Store a leading-axis batch at consecutive global ring slots: row
    ``b`` is store ``cntr + b``, shard ``(cntr + b) % S``.  Priorities as
    ``rl/replay.replay_add_batch``: explicit, else from per-row ``errors``,
    else the current max (``error_clip`` while the ring is untouched)."""
    n = len(next(iter(transitions.values())))
    sh, loc = _cells(buf, n)
    for k, v in buf.data.items():
        v[sh, loc] = torch.as_tensor(transitions[k], dtype=v.dtype,
                                     device=v.device)
    if priority is None:
        if errors is None:
            pmax = buf.priority.max()
            priority = torch.where(pmax == 0.0, error_clip, pmax)
        else:
            priority = rp.priority_from_errors(errors, error_clip).to(
                buf.device)
    buf.priority[sh, loc] = torch.as_tensor(
        priority, dtype=torch.float32, device=buf.device).expand(n)
    buf.cntr += n


def replay_add(buf: ShardedReplayState, transition: dict, priority=None,
               error=None, error_clip: float = 100.0) -> None:
    """One transition: the batch store with one row."""
    one = {k: np.asarray(v)[None] if not torch.is_tensor(v) else v[None]
           for k, v in transition.items()}
    err = None if error is None else torch.as_tensor(error)[None]
    replay_add_batch(buf, one, priority=priority, errors=err,
                     error_clip=error_clip)


def _global_slots(buf):
    """(S, local) map of each cell to its global ring slot ``j*S + s``."""
    S, L = buf.priority.shape
    dev = buf.device
    return (torch.arange(L, device=dev)[None, :] * S
            + torch.arange(S, device=dev)[:, None])


def ere_weights(buf: ShardedReplayState, eta: float):
    """(S, local) emphasizing-recent-experience weights, equal to
    ``rl/replay.ere_weights`` on the flat ring (cell (s, j) = slot
    j*S + s)."""
    size, filled = buf.size, buf.filled
    g = _global_slots(buf)
    ages = torch.remainder(buf.cntr - 1 - g, max(size, 1))
    x = ages.to(torch.float32) / max(filled - 1, 1)
    w = torch.pow(float(eta), rp.ERE_SPAN * x)
    return torch.where(g < filled, w, 0.0)


def _stratified_gather(buf, weights, batch_size, generator, u):
    """Stratified draw of ``batch_size`` rows from the (S, local)
    ``weights``: each value finds its shard in the S shard totals' prefix
    sums, then its slot in that shard's local prefix sums.  Returns
    ``(batch, gidx, p_sel, total)``, ``gidx`` the global ring slots."""
    S, L = weights.shape
    csum = torch.cumsum(weights, dim=1)
    totals = csum[:, -1]
    t_csum = torch.cumsum(totals, dim=0)
    total = t_csum[-1]
    off = t_csum - totals
    if u is None:
        u = torch.rand(batch_size, generator=generator, device=csum.device)
    values = (torch.arange(batch_size, dtype=torch.float32,
                           device=csum.device) + u) * (total / batch_size)
    shard_of = torch.searchsorted(t_csum, values).clamp_(0, S - 1)
    local_v = values - off[shard_of]
    li = torch.searchsorted(csum[shard_of], local_v[:, None])[:, 0]
    li = li.clamp_(0, L - 1)
    batch = {k: v[shard_of, li] for k, v in buf.data.items()}
    return batch, li * S + shard_of, weights[shard_of, li], total


def replay_sample_per(buf: ShardedReplayState, batch_size: int,
                      generator=None, u=None, recency_eta=None):
    """Stratified PER over the shards (ERE-modulated when ``recency_eta`` <
    1) with IS weights against the distribution sampled from.  Anneals
    ``buf.beta``; returns (batch, gidx, is_weights)."""
    weights = buf.priority
    if recency_eta is not None and recency_eta < 1.0:
        weights = weights * ere_weights(buf, recency_eta)
    beta = np.minimum(np.float32(1.0),
                      buf.beta + np.float32(rp.PER_BETA_INCREMENT))
    batch, gidx, p_sel, total = _stratified_gather(buf, weights, batch_size,
                                                   generator, u)
    is_w = (batch_size * (p_sel / total)) ** (-float(beta))
    buf.beta = beta
    return batch, gidx, is_w / is_w.max()


def replay_sample_ere(buf: ShardedReplayState, batch_size: int, eta: float,
                      generator=None, u=None):
    """Recency-weighted stratified sampling for uniform rings (no IS
    correction).  Returns (batch, gidx)."""
    batch, gidx, _, _ = _stratified_gather(buf, ere_weights(buf, eta),
                                           batch_size, generator, u)
    return batch, gidx


def replay_sample_uniform(buf: ShardedReplayState, batch_size: int,
                          generator=None, gumbel_noise=None):
    """Uniform sample without replacement over the filled slots:
    Gumbel-top-k over the (S, local) scores, unfilled cells at -inf.
    ``gumbel_noise``: (S, local) draws (default from ``generator``).
    Returns (batch, gidx)."""
    S, L = buf.priority.shape
    if gumbel_noise is None:
        gumbel_noise = rp.gumbel(S * L, generator, buf.device).reshape(S, L)
    score = torch.where(_global_slots(buf) < buf.filled, gumbel_noise,
                        -torch.inf)
    _, flat = torch.topk(score.reshape(-1), batch_size)
    shard_of, li = flat // L, flat % L
    batch = {k: v[shard_of, li] for k, v in buf.data.items()}
    return batch, li * S + shard_of


def replay_update_priorities(buf: ShardedReplayState, gidx, errors,
                             error_clip: float = 100.0) -> None:
    """p = min(|e| + eps, clip)^alpha written to the sampled cells; a cell
    drawn twice takes the value of its last draw."""
    S = buf.n_shards
    p = torch.clamp(errors.abs() + rp.PER_EPSILON,
                    max=error_clip) ** rp.PER_ALPHA
    pos = torch.arange(gidx.shape[0], device=gidx.device)
    last = ((gidx[:, None] == gidx[None, :]) * pos).argmax(dim=1)
    buf.priority[gidx % S, gidx // S] = p[last]


def shard_occupancy(cntr: int, n_shards: int, local_size: int) -> list:
    """Filled slots per shard from the global counter alone."""
    filled = min(int(cntr), n_shards * local_size)
    return [max(0, (filled - s + n_shards - 1) // n_shards)
            for s in range(n_shards)]


def _ring_order(x):
    """(S, local, ...) -> flat ring order (slot j*S + s)."""
    return x.transpose(0, 1).reshape((-1,) + tuple(x.shape[2:]))


def version_staleness(buf: ShardedReplayState, learner_version: int) -> dict:
    """Staleness of a versioned ring's stored behavior snapshots against
    ``learner_version``, over the filled prefix (zeros when the ring is
    empty or unversioned)."""
    zero = {"filled": 0, "staleness_mean": 0.0, "staleness_max": 0,
            "stale_frac": 0.0}
    if "version" not in buf.data or buf.filled <= 0:
        return zero
    ver = _ring_order(buf.data["version"]).cpu().numpy()[:buf.filled]
    stale = np.maximum(0, int(learner_version) - ver.astype(np.int64))
    return {"filled": buf.filled,
            "staleness_mean": round(float(stale.mean()), 4),
            "staleness_max": int(stale.max()),
            "stale_frac": round(float((stale > 0).mean()), 4)}


def replay_health(buf: ShardedReplayState) -> dict:
    """``rl/replay.replay_health`` of the flat ring the interleave holds,
    plus the per-shard occupancy."""
    flat = _ring_order(buf.priority).cpu().numpy()
    out = rp.health_from_arrays(flat, buf.cntr, buf.size, float(buf.beta))
    out["n_shards"] = buf.n_shards
    out["shard_occupancy"] = shard_occupancy(buf.cntr, buf.n_shards,
                                             buf.local_size)
    return out


def replay_to_host(buf: ShardedReplayState) -> dict:
    """The whole ring as numpy arrays with ``cntr`` and ``beta`` (the
    checkpoint payload form)."""
    return {"cntr": buf.cntr, "beta": float(buf.beta),
            "data": {k: v.cpu().numpy() for k, v in buf.data.items()},
            "priority": buf.priority.cpu().numpy()}


def replay_from_host(payload: dict, device="cuda") -> ShardedReplayState:
    return ShardedReplayState(
        {k: torch.from_numpy(np.asarray(v)).to(device)
         for k, v in payload["data"].items()},
        torch.from_numpy(np.asarray(payload["priority"],
                                    np.float32)).to(device),
        payload["cntr"], payload["beta"])
