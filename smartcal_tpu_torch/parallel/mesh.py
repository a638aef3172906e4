"""Mesh-axis registry and device meshes (counterpart of
smartcal_tpu/parallel/mesh.py).

The JAX package lays its parallel axes over a device mesh: replay shards
(``rp``), data-parallel actors (``dp``), episode lanes (``lane``), sub-bands
(``fp``), calibration chunks (``sp``) and baselines (``bp``).  In the port:

* the sub-band, chunk, baseline and lane axes of the calibration routes
  (``parallel/sharded_cal.py``, ``envs/radio.py``) are meshes of positions,
  one SPMD program per route with explicit collectives
  (``ops/collectives.py``).  A mesh may name a device more than once: k
  positions on one card run the same program, collectives included, as k
  cards would;
* ``dp`` actors become the lanes of one batched program
  (``parallel/trainer.py``, ``parallel/learner.py``);
* replay shards become the leading axis of an ``(n_shards, local_size)``
  ring on the device (``rl/replay_sharded.py``).

:func:`default_devices` is the device list of every default mesh and of
the backend's routes: every local CUDA device, or the CPU when asked for.
A run with k positions on one device replaces that function (the tests and
``chip_smoke.py`` do).  :class:`Mesh` keeps the JAX package's vocabulary
(axis names, ``shape``, :class:`MeshFactorizationError`, ``P``); a mesh
that wants more positions than its device list has raises.
"""

from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

AXIS_REPLAY = "rp"
AXIS_DATA = "dp"
AXIS_LANE = "lane"
AXIS_FREQ = "fp"
AXIS_CHUNK = "sp"
AXIS_BASELINE = "bp"

#: canonical order of composed meshes: batching axes lead, collective axes
#: trail
MESH_AXES: Tuple[str, ...] = (AXIS_REPLAY, AXIS_DATA, AXIS_LANE,
                              AXIS_FREQ, AXIS_CHUNK, AXIS_BASELINE)


class MeshFactorizationError(ValueError):
    """Axis sizes do not factor over the available devices or data; the
    message names the axis and the nearest valid size."""


class Mesh:
    """A named mesh of positions: ``devices`` an ndarray of
    ``torch.device`` of shape ``tuple(shape.values())`` (a device may
    repeat), ``shape`` axis name -> size."""

    def __init__(self, devices, axis_names: Sequence[str]):
        self.devices = np.asarray(devices, dtype=object)
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              self.devices.shape))

    @property
    def device(self) -> torch.device:
        """The mesh's first device: where a one-device program runs and
        where a sharded program's global result goes."""
        return self.devices.reshape(-1)[0]

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={list(self.devices.reshape(-1))})"


def largest_divisor(n: int, cap: int) -> int:
    """Largest divisor of ``n`` that is <= ``cap`` (>= 1 for n >= 1)."""
    n, cap = int(n), max(1, int(cap))
    for d in range(min(n, cap), 0, -1):
        if n % d == 0:
            return d
    return 1


def nearest_factorization(axis_sizes: Mapping[str, int],
                          n_devices: int) -> Dict[str, int]:
    """Greedy shrink of ``axis_sizes`` onto ``n_devices``: each axis keeps
    the largest divisor of its size that fits the remaining budget."""
    left = max(1, int(n_devices))
    out: Dict[str, int] = {}
    for name, size in axis_sizes.items():
        d = largest_divisor(size, left)
        out[name] = d
        left //= d
    return out


def check_axis_divides(n_items: int, n_shards: int, *, axis: str,
                       what: str) -> None:
    """Raise :class:`MeshFactorizationError` unless n_shards | n_items."""
    if n_shards <= 0 or n_items % n_shards != 0:
        hint = largest_divisor(n_items, n_shards)
        raise MeshFactorizationError(
            f"{what}: axis {axis!r} wants {n_shards} shards but "
            f"{n_items} items do not divide; nearest valid size is "
            f"{hint} (divisors of {n_items} only)")


def default_devices(device=None) -> list:
    """The devices a mesh lays out by default: every local CUDA device
    (``torch.cuda.device_count()``) when ``device`` is None or a CUDA
    device, the CPU when ``device`` is the CPU.  Without a GPU a CUDA
    request raises, as ``resolve_device`` does."""
    from smartcal_tpu_torch import resolve_device

    dev = resolve_device(device if device is not None else "cuda")
    if dev.type != "cuda":
        return [dev]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


class PartitionSpec(tuple):
    """How an operand lies over a mesh (``jax.sharding.PartitionSpec``):
    entry d names the mesh axis (or a tuple of axes, or None) that splits
    dimension d; trailing dimensions are whole.  ``P()`` is replicated."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return "P" + tuple.__repr__(self)


P = PartitionSpec


def make_mesh(axis_sizes: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = (AXIS_DATA,),
              devices=None) -> Mesh:
    """A mesh over ``devices`` (default: :func:`default_devices`), all of
    them on one ``AXIS_DATA`` axis unless ``axis_sizes`` reshapes them
    (row-major).  A device may appear more than once (positions sharing a
    device); a mesh that wants more positions than ``devices`` has raises
    :class:`MeshFactorizationError` with the nearest valid shape."""
    devices = default_devices() if devices is None else list(devices)
    if axis_sizes is None:
        axis_sizes = (len(devices),)
    n = int(np.prod(axis_sizes))
    if n > len(devices):
        req = dict(zip(axis_names, axis_sizes))
        raise MeshFactorizationError(
            f"mesh wants {n} devices ({req}), only {len(devices)} "
            f"available; nearest valid factorization: "
            f"{nearest_factorization(req, len(devices))}")
    arr = np.empty(n, dtype=object)
    arr[:] = devices[:n]
    return Mesh(arr.reshape(axis_sizes), tuple(axis_names))


def compose_mesh(axis_sizes: Mapping[str, int], devices=None) -> Mesh:
    """The multi-axis mesh of ``{axis name: size}``, laid out in
    :data:`MESH_AXES` order whatever the mapping's order; unknown names
    raise."""
    for name in axis_sizes:
        if name not in MESH_AXES:
            raise MeshFactorizationError(
                f"unknown mesh axis {name!r}; registry axes are "
                f"{MESH_AXES} (add new axes in parallel/mesh.py)")
    names = tuple(a for a in MESH_AXES if a in axis_sizes)
    sizes = tuple(int(axis_sizes[a]) for a in names)
    return make_mesh(sizes, names, devices=devices)
