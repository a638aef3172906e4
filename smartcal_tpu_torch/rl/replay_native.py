"""Host-side prioritized replay on the native C++ sum tree (counterpart of
smartcal_tpu/rl/replay_native.py).

The default PER of the port keeps the ring on the device
(:mod:`smartcal_tpu_torch.rl.replay`).  This is the alternative the JAX
package measures beside it: transitions stay in host numpy rings,
priorities in the O(log n) C++ sum tree of
:mod:`smartcal_tpu_torch.native`, and only the sampled minibatch crosses
to the agent's device, as one pinned copy per learn (:func:`to_device`).

Its semantics are those of ``rl.replay`` and of the JAX class: the same
constants and priority rules, the same stratified segments, IS weights
and beta annealing, the same ``health``, ``state_dict`` /
``from_state_dict`` and ``save`` / ``load``.  The ring size must be a
power of two (the tree's capacity).
"""

import numpy as np
import torch

from smartcal_tpu_torch import native
from smartcal_tpu_torch.rl.replay import (PER_ALPHA, PER_BETA0,
                                          PER_BETA_INCREMENT, PER_EPSILON,
                                          health_from_arrays)
from smartcal_tpu_torch.runtime.atomic import atomic_pickle, strict_pickle_load


def _np_dtype(dtype) -> np.dtype:
    """The numpy dtype of a spec entry (a torch dtype, or anything numpy
    takes)."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


class NativePER:
    """Prioritized replay: numpy ring storage + native sum-tree priorities.
    ``spec`` is :func:`~smartcal_tpu_torch.rl.replay.transition_spec`'s
    ``{field: (shape, dtype)}`` layout."""

    def __init__(self, size: int, spec: dict, error_clip: float = 100.0):
        native.lib()                     # raises if the library cannot build
        self.size = int(size)
        self.error_clip = float(error_clip)
        self.spec = {k: (tuple(shape), _np_dtype(dt))
                     for k, (shape, dt) in spec.items()}
        self.data = {k: np.zeros((self.size,) + shape, dt)
                     for k, (shape, dt) in self.spec.items()}
        self.tree = native.SumTree(self.size)
        if self.tree.capacity != self.size:
            raise ValueError(
                f"size must be a power of two (got {size}); the tree "
                f"rounds to {self.tree.capacity}")
        self.cntr = 0
        self.beta = PER_BETA0

    # -- storing ----------------------------------------------------------
    def _priority_from_error(self, error) -> float:
        # the scalar form of replay.priority_from_errors
        return float(min((abs(float(error)) + PER_EPSILON) ** PER_ALPHA,
                         self.error_clip))

    def store(self, transition: dict, error=None) -> int:
        """Store one transition; returns its slot.  Priority defaults to the
        current max (or the clip when empty), as ``replay.replay_add``."""
        if error is None:
            pmax = self.tree.max_priority()
            p = self.error_clip if pmax == 0.0 else pmax
        else:
            p = self._priority_from_error(error)
        idx = self.cntr % self.size
        for k, v in self.data.items():
            x = transition[k]
            if isinstance(x, torch.Tensor):
                x = x.detach().cpu().numpy()
            v[idx] = np.asarray(x, v.dtype)
        leaf = self.tree.add(p)
        if leaf != idx:
            raise RuntimeError(f"sum tree wrote leaf {leaf}, ring slot {idx}")
        self.cntr += 1
        return idx

    def store_batch(self, transitions: dict, errors=None) -> None:
        """Bulk ingestion (the learner's ``store_transition_from_buffer``
        role): the transitions enter one by one, each with the priority
        rule of :meth:`store`."""
        n = len(next(iter(transitions.values())))
        for i in range(n):
            self.store({k: v[i] for k, v in transitions.items()},
                       None if errors is None else errors[i])

    @property
    def filled(self) -> int:
        return min(self.cntr, self.size)

    def ready(self, batch_size: int) -> bool:
        return self.filled >= batch_size

    # -- sampling ---------------------------------------------------------
    def sample(self, batch_size: int, rng: np.random.Generator,
               uniforms=None):
        """(batch, idx, is_weights), host numpy, by the stratified scheme
        and beta annealing of ``replay.replay_sample_per``.  ``uniforms``
        overrides the per-segment draws."""
        self.beta = min(1.0, self.beta + PER_BETA_INCREMENT)
        u = rng.random(batch_size) if uniforms is None else \
            np.asarray(uniforms, np.float64)
        idx, pri = self.tree.sample_stratified(batch_size, u)
        # a walk can overshoot into the unfilled suffix of a partly filled
        # ring (float rounding in the descent) and land on a zero-priority
        # leaf, whose infinite IS weight would poison the loss: clamp into
        # the filled prefix and re-read the priority
        filled = self.filled
        if np.any(idx >= filled) or np.any(pri <= 0.0):
            idx = np.minimum(idx, max(filled - 1, 0))
            pri = self.tree.leaves()[idx]
        total = self.tree.total()
        probs = np.maximum(pri / max(total, 1e-300), 1e-12)
        is_w = (batch_size * probs) ** (-self.beta)
        is_w = is_w / np.max(is_w)
        batch = {k: v[idx] for k, v in self.data.items()}
        return batch, idx, is_w.astype(np.float32)

    def update_priorities(self, idx, errors) -> None:
        """``batch_update``: p = min(|e| + eps, clip)^alpha."""
        if isinstance(errors, torch.Tensor):
            errors = errors.detach().cpu().numpy()
        clipped = np.minimum(np.abs(np.asarray(errors, np.float64))
                             + PER_EPSILON, self.error_clip)
        self.tree.update_batch(np.asarray(idx, np.int64),
                               clipped ** PER_ALPHA)

    def health(self) -> dict:
        """``replay.replay_health``'s summary, from the tree's leaves."""
        return health_from_arrays(self.tree.leaves(), self.cntr, self.size,
                                  self.beta)

    # -- checkpoint -------------------------------------------------------
    def state_dict(self) -> dict:
        """The complete host state (ring arrays, the tree's leaves, cursor
        and fill, beta) as one picklable dict: the ``{"kind": "native"}``
        replay payload of ``runtime.checkpoint``."""
        return {
            "data": self.data, "cntr": self.cntr, "beta": self.beta,
            "leaves": self.tree.leaves(), "cursor": self.tree.cursor,
            "filled": self.tree.filled, "size": self.size,
            "error_clip": self.error_clip,
            "spec": {k: (shape, dt.str) for k, (shape, dt)
                     in self.spec.items()},
        }

    @classmethod
    def from_state_dict(cls, state: dict) -> "NativePER":
        buf = cls(state["size"], state["spec"],
                  error_clip=state["error_clip"])
        buf.data = {k: np.asarray(v, buf.spec[k][1])
                    for k, v in state["data"].items()}
        buf.cntr = int(state["cntr"])
        buf.beta = float(state["beta"])
        buf.tree.set_state(state["leaves"], int(state["cursor"]),
                           int(state["filled"]))
        return buf

    def save(self, path: str) -> None:
        atomic_pickle(self.state_dict(), path)

    @classmethod
    def load(cls, path: str) -> "NativePER":
        return cls.from_state_dict(strict_pickle_load(path))


def to_device(batch: dict, is_w, device):
    """A sampled host minibatch and its IS weights on ``device``: every
    field packed into one float32 (B, width) host buffer (pinned for a CUDA
    device), one copy, then split and cast back (float32 and bool values
    survive the round trip exactly).  Returns (batch dict, is_w)."""
    device = torch.device(device)
    names = list(batch)
    B = len(is_w)
    cols = [np.asarray(batch[k]).reshape(B, -1) for k in names]
    widths = [c.shape[1] for c in cols]
    host = torch.empty((B, sum(widths) + 1), dtype=torch.float32,
                       pin_memory=device.type == "cuda")
    hv = host.numpy()
    off = 0
    for c, w in zip(cols, widths):
        hv[:, off:off + w] = c
        off += w
    hv[:, off] = is_w
    dev = host.to(device, non_blocking=True)
    out, off = {}, 0
    for k, w in zip(names, widths):
        shape = np.asarray(batch[k]).shape
        t = dev[:, off:off + w].reshape(shape)
        dt = torch.from_numpy(np.asarray(batch[k])[:0]).dtype
        out[k] = t if dt == torch.float32 else t.to(dt)
        off += w
    return out, dev[:, off].contiguous()
