"""The sharded replay ring (counterpart of smartcal_tpu/rl/replay_sharded.py).

Layout: every field is ``(S, local, ...)`` and the priorities ``(S,
local)``, with a global store counter ``cntr`` and the PER exponent
``beta`` on the host (as in ``rl/replay``).  The global ring is
interleaved round-robin over the shards: store number ``t`` lands at ring
slot ``r = t % size``, shard ``r % S``, local slot ``r // S``, so cell
``(s, j)`` holds what slot ``j*S + s`` of the flat ring holds and ages, ERE
weights and fill match the flat ring exactly.

The JAX package lays the shard axis over a mesh and merges per-shard
draws with collectives.  On one process the shard axis is the leading
axis of one tensor: the store is one scatter whose (shard, slot) targets
follow from the host counter, and the stratified draw searches the S
shard totals, then the chosen shard's local prefix sums, exactly as JAX's
per-shard draw routes each value.  Over an ``rp`` axis of processes
(:func:`place_on_mesh` on a mesh of processes) each rank keeps its ``S /
k`` shards (from ``shard0`` on): every rank sees every store and writes
only the rows of its shards; a draw all-gathers the shard totals, each
rank gathers the rows it owns, and the rows, masked to zero elsewhere,
merge by a ``psum`` over ``rp`` that adds exact zeros, so every rank gets
the one-process ring's batch; priority updates stay shard-local.  Every
sampler takes its randomness from a ``torch.Generator`` or explicitly
(``u``, ``gumbel_noise``), the same draws on every rank, so the parity
tests feed the draws JAX made.  Nothing here moves the sampled batch to
the host.  The functions update the ring in place.
"""

import numpy as np
import torch

from smartcal_tpu_torch.ops import collectives
from smartcal_tpu_torch.parallel.mesh import (AXIS_REPLAY,
                                              MeshFactorizationError,
                                              check_axis_divides,
                                              replicated, sharded_batch)
from smartcal_tpu_torch.rl import replay as rp


class ShardedReplayState:
    """``data``: field -> (S_local, local, ...) tensors; ``priority``:
    (S_local, local); ``cntr``: global stores (host int); ``beta``: host
    float32.  On a mesh of processes the ring holds the global shards
    ``shard0 .. shard0 + S_local - 1`` of ``n_total`` and ``mesh`` /
    ``axis`` name the shard axis; else it holds all of them."""

    def __init__(self, data, priority, cntr=0, beta=rp.PER_BETA0,
                 shard0=0, n_total=None, mesh=None, axis=AXIS_REPLAY):
        self.data = data
        self.priority = priority
        self.cntr = int(cntr)
        self.beta = np.float32(beta)
        self.shard0 = int(shard0)
        self.n_total = int(priority.shape[0] if n_total is None
                           else n_total)
        self.mesh, self.axis = mesh, axis

    @property
    def n_shards(self) -> int:
        """The ring's shards, on every rank."""
        return self.n_total

    @property
    def local_shards(self) -> int:
        return self.priority.shape[0]

    @property
    def distributed(self) -> bool:
        return self.local_shards < self.n_total

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


def shardings(buf: ShardedReplayState, mesh, axis: str = AXIS_REPLAY):
    """How the ring lies over ``mesh`` (JAX: ``replay_sharded.shardings``):
    the data and priorities sharded on their leading (shard) axis over
    ``axis``, the counters replicated.  ``mesh`` may be a composed mesh;
    the ring then has copies over every other axis.  Returns a dict of
    :class:`~smartcal_tpu_torch.parallel.mesh.NamedSharding` under the
    ring's field names."""
    if axis not in mesh.shape:
        raise MeshFactorizationError(
            f"replay shardings: mesh has no axis {axis!r} "
            f"(mesh axes: {tuple(mesh.shape)})")
    shard, repl = sharded_batch(mesh, axis), replicated(mesh)
    return {"data": {k: shard for k in buf.data}, "priority": shard,
            "cntr": repl, "beta": repl}


def place_on_mesh(buf: ShardedReplayState, mesh=None,
                  axis: str = AXIS_REPLAY) -> ShardedReplayState:
    """Commit the ring to ``mesh``: ``mesh`` must carry ``axis`` with a
    size that divides ``n_shards`` (raises
    :class:`MeshFactorizationError` otherwise).  On a mesh of processes
    each rank keeps its block of the shards (:func:`shardings`) on its
    device; on a one-device mesh the ring moves to the mesh's device."""
    if mesh is None:
        return buf
    if axis not in mesh.shape:
        raise MeshFactorizationError(
            f"place_on_mesh: mesh has no axis {axis!r} "
            f"(mesh axes: {tuple(mesh.shape)})")
    check_axis_divides(buf.n_shards, mesh.shape[axis], axis=axis,
                       what="place_on_mesh n_shards")
    dev = mesh.device
    if not mesh.is_process:
        return ShardedReplayState(
            {k: v.to(dev) for k, v in buf.data.items()},
            buf.priority.to(dev), buf.cntr, buf.beta)
    sh = shardings(buf, mesh, axis)
    per = buf.n_shards // mesh.shape[axis]
    return ShardedReplayState(
        {k: sh["data"][k].local(v).to(dev).clone()
         for k, v in buf.data.items()},
        sh["priority"].local(buf.priority).to(dev).clone(), buf.cntr,
        buf.beta, shard0=mesh.local_coords[axis] * per,
        n_total=buf.n_shards, mesh=mesh, axis=axis)


def _psum(buf, x):
    """The sum of ``x`` over the ring's shard axis (``x`` itself on one
    process)."""
    if not buf.distributed:
        return x
    with collectives.on_mesh(buf.mesh):
        return collectives.psum(x, buf.axis)


def _gather_shards(buf, x):
    """Every rank's ``(S_local, ...)`` block of ``x`` as the global
    ``(S, ...)`` tensor."""
    if not buf.distributed:
        return x
    with collectives.on_mesh(buf.mesh):
        return collectives.all_gather(x, buf.axis)


def _mine(buf, shard):
    """(mask of the rows whose shard this rank holds, their local shard
    index, clamped)."""
    ls = shard - buf.shard0
    return (ls >= 0) & (ls < buf.local_shards), \
        ls.clamp(0, buf.local_shards - 1)


def _cells(buf, n):
    """(shard, local) index tensors of the next ``n`` stores, from the host
    counter (global shard ids)."""
    S, L = buf.n_shards, buf.local_size
    t = buf.cntr + np.arange(n)
    dev = buf.device
    return (torch.as_tensor(t % S, device=dev),
            torch.as_tensor((t // S) % L, device=dev))


def replay_add_batch(buf: ShardedReplayState, transitions: dict,
                     priority=None, errors=None,
                     error_clip: float = 100.0) -> None:
    """Store a leading-axis batch at consecutive global ring slots: row
    ``b`` is store ``cntr + b``, shard ``(cntr + b) % S``; a rank writes
    the rows of its own shards.  Priorities as
    ``rl/replay.replay_add_batch``: explicit, else from per-row ``errors``,
    else the ring's current max (``error_clip`` while the ring is
    untouched)."""
    n = len(next(iter(transitions.values())))
    sh, loc = _cells(buf, n)
    mine, ls = _mine(buf, sh)
    ls, loc_m = ls[mine], loc[mine]
    for k, v in buf.data.items():
        x = torch.as_tensor(transitions[k], dtype=v.dtype, device=v.device)
        v[ls, loc_m] = x[mine]
    if priority is None:
        if errors is None:
            pmax = torch.max(_gather_shards(buf, buf.priority.max()[None]))
            priority = torch.where(pmax == 0.0, error_clip, pmax)
        else:
            priority = rp.priority_from_errors(errors, error_clip).to(
                buf.device)
    p = torch.as_tensor(priority, dtype=torch.float32,
                        device=buf.device).expand(n)
    buf.priority[ls, loc_m] = p[mine]
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
    """(S_local, local) map of each cell to its global ring slot
    ``j*S + s``."""
    S, L = buf.n_shards, buf.local_size
    dev = buf.device
    return (torch.arange(L, device=dev)[None, :] * S
            + torch.arange(buf.shard0, buf.shard0 + buf.local_shards,
                           device=dev)[:, None])


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
    sums, then its slot in that shard's local prefix sums.  Over processes
    the totals are all-gathered, each rank gathers the rows of its shards
    and the masked rows merge by a psum.  Returns ``(batch, gidx, p_sel,
    total)``, ``gidx`` the global ring slots."""
    S, L = buf.n_shards, weights.shape[1]
    csum = torch.cumsum(weights, dim=1)
    totals = _gather_shards(buf, csum[:, -1])
    t_csum = torch.cumsum(totals, dim=0)
    total = t_csum[-1]
    off = t_csum - totals
    if u is None:
        u = torch.rand(batch_size, generator=generator, device=csum.device)
    values = (torch.arange(batch_size, dtype=torch.float32,
                           device=csum.device) + u) * (total / batch_size)
    shard_of = torch.searchsorted(t_csum, values).clamp_(0, S - 1)
    local_v = values - off[shard_of]
    mine, ls = _mine(buf, shard_of)
    li = torch.searchsorted(csum[ls], local_v[:, None])[:, 0]
    li = li.clamp_(0, L - 1)
    if not buf.distributed:
        batch = {k: v[ls, li] for k, v in buf.data.items()}
        return batch, li * S + shard_of, weights[ls, li], total
    batch = {k: _psum(buf, _masked(v[ls, li], mine))
             for k, v in buf.data.items()}
    li = _psum(buf, torch.where(mine, li, 0))
    p_sel = _psum(buf, _masked(weights[ls, li], mine))
    return batch, li * S + shard_of, p_sel, total


def _masked(g, mine):
    """Rows of ``g`` where ``mine``, zeros elsewhere."""
    m = mine.reshape((mine.shape[0],) + (1,) * (g.ndim - 1))
    return torch.where(m, g, torch.zeros_like(g))


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
    S, L = buf.n_shards, buf.local_size
    if gumbel_noise is None:
        gumbel_noise = rp.gumbel(S * L, generator, buf.device).reshape(S, L)
    rows = slice(buf.shard0, buf.shard0 + buf.local_shards)
    score = torch.where(_global_slots(buf) < buf.filled,
                        gumbel_noise[rows], -torch.inf)
    _, flat = torch.topk(_gather_shards(buf, score).reshape(-1), batch_size)
    shard_of, li = flat // L, flat % L
    mine, ls = _mine(buf, shard_of)
    batch = {k: _psum(buf, _masked(v[ls, li], mine)) if buf.distributed
             else v[ls, li] for k, v in buf.data.items()}
    return batch, li * S + shard_of


def replay_update_priorities(buf: ShardedReplayState, gidx, errors,
                             error_clip: float = 100.0) -> None:
    """p = min(|e| + eps, clip)^alpha written to the sampled cells (each
    rank to its own shards); a cell drawn twice takes the value of its
    last draw."""
    S = buf.n_shards
    p = torch.clamp(errors.abs() + rp.PER_EPSILON,
                    max=error_clip) ** rp.PER_ALPHA
    pos = torch.arange(gidx.shape[0], device=gidx.device)
    last = ((gidx[:, None] == gidx[None, :]) * pos).argmax(dim=1)
    mine, ls = _mine(buf, gidx % S)
    buf.priority[ls[mine], (gidx // S)[mine]] = p[last][mine]


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
    ver = _ring_order(_gather_shards(buf, buf.data["version"])) \
        .cpu().numpy()[:buf.filled]
    stale = np.maximum(0, int(learner_version) - ver.astype(np.int64))
    return {"filled": buf.filled,
            "staleness_mean": round(float(stale.mean()), 4),
            "staleness_max": int(stale.max()),
            "stale_frac": round(float((stale > 0).mean()), 4)}


def replay_health(buf: ShardedReplayState) -> dict:
    """``rl/replay.replay_health`` of the flat ring the interleave holds,
    plus the per-shard occupancy."""
    flat = _ring_order(_gather_shards(buf, buf.priority)).cpu().numpy()
    out = rp.health_from_arrays(flat, buf.cntr, buf.size, float(buf.beta))
    out["n_shards"] = buf.n_shards
    out["shard_occupancy"] = shard_occupancy(buf.cntr, buf.n_shards,
                                             buf.local_size)
    return out


def replay_to_host(buf: ShardedReplayState) -> dict:
    """The whole ring (every rank's shards) as numpy arrays with ``cntr``
    and ``beta`` (the checkpoint payload form)."""
    return {"cntr": buf.cntr, "beta": float(buf.beta),
            "data": {k: _gather_shards(buf, v).cpu().numpy()
                     for k, v in buf.data.items()},
            "priority": _gather_shards(buf, buf.priority).cpu().numpy()}


def replay_from_host(payload: dict, device="cuda") -> ShardedReplayState:
    return ShardedReplayState(
        {k: torch.from_numpy(np.asarray(v)).to(device)
         for k, v in payload["data"].items()},
        torch.from_numpy(np.asarray(payload["priority"],
                                    np.float32)).to(device),
        payload["cntr"], payload["beta"])
