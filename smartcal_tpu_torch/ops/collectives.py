"""Collectives of the sharded calibration routes: the counterparts of
``jax.lax.psum``, ``pmean``, ``axis_index`` and ``axis_size``.

``parallel/sharded_cal.shard_map`` runs its body once per mesh position,
each in a host thread of its own (on the card with a CUDA stream of its
own), and binds the thread's axis context (:class:`Position`).  The
functions here read that context; outside a ``shard_map`` they raise
:class:`CollectiveError`.  They sit below ``cal/`` because the solver and
the influence engine call them, and ``parallel/`` imports ``cal/``.

A collective over the axes A runs within the positions that share every
other axis's index (the group), ranked by their indices on A in mesh
order.  ``psum`` forms the sum in rank order on the first rank's device,
``((x0 + x1) + x2) + ...``, whatever order the threads arrive in, and every
rank takes a copy of that one result (a position may change its copy in
place), so every position gets the same bits and two runs give the same
bits.  A tensor written on one stream
is read on another only after the reader's stream has waited on an event
recorded on the writer's, and it is marked as used on the reader's stream
(``record_stream``), so the allocator keeps its memory until the read is
done.  Python numbers are summed on the host in the same order.

A barrier that waits past the run's timeout, or a position whose body
raises, aborts the run (:meth:`Run.abort`): every barrier breaks, every
waiting position raises :class:`CollectiveError`, and ``shard_map``
re-raises the first error.  Nothing waits forever.
"""

import threading

import numpy as np
import torch

_tls = threading.local()


class CollectiveError(RuntimeError):
    """A collective outside a ``shard_map``, over an axis the mesh lacks, or
    in a run that was aborted (a position failed, or a barrier waited past
    its timeout)."""


class _Group:
    """The positions of one collective: a barrier, a slot per rank and the
    first rank's result."""

    def __init__(self, size, timeout):
        self.size = size
        self.barrier = threading.Barrier(size, timeout=timeout)
        self.slots = [None] * size
        self.result = None


class Run:
    """The state one ``shard_map`` call shares between its positions: a
    :class:`_Group` per (axes, indices on the other axes), made on first
    use, and the abort flag."""

    def __init__(self, mesh, timeout):
        self.mesh = mesh
        self.timeout = float(timeout)
        self.aborted = False
        self._groups = {}
        self._lock = threading.Lock()

    def group(self, axes, coords):
        """(group, rank) of the position at ``coords`` for a collective over
        ``axes`` (names in mesh order)."""
        shape = self.mesh.shape
        key = (axes, tuple(coords[a] for a in self.mesh.axis_names
                           if a not in axes))
        with self._lock:
            g = self._groups.get(key)
            if g is None:
                size = int(np.prod([shape[a] for a in axes], dtype=np.int64))
                g = self._groups[key] = _Group(size, self.timeout)
                if self.aborted:
                    g.barrier.abort()
        return g, _rank(axes, coords, shape)

    def abort(self):
        """Break every barrier of the run, those made later too."""
        with self._lock:
            self.aborted = True
            groups = list(self._groups.values())
        for g in groups:
            g.barrier.abort()


class Position:
    """One position's axis context: its index on each axis of the shared
    :class:`Run`'s mesh."""

    def __init__(self, run, coords):
        self.run = run
        self.coords = dict(coords)

    def axes(self, axis_name, what):
        """``axis_name`` (a name or a sequence of names) as a tuple of mesh
        axes in mesh order; raises for a name the mesh lacks."""
        names = ((axis_name,) if isinstance(axis_name, str)
                 else tuple(axis_name))
        mesh_axes = self.run.mesh.axis_names
        bad = [a for a in names if a not in mesh_axes]
        if bad:
            raise CollectiveError(f"{what}: axis {bad[0]!r} is not an axis "
                                  f"of the mesh {mesh_axes}")
        return tuple(a for a in mesh_axes if a in names)


def _rank(axes, coords, shape):
    """Row-major index of ``coords`` over ``axes``."""
    r = 0
    for a in axes:
        r = r * shape[a] + coords[a]
    return r


def bind(position):
    """Bind ``position`` as this thread's axis context (None unbinds)."""
    _tls.position = position


def current():
    """This thread's axis context, or None outside a ``shard_map``."""
    return getattr(_tls, "position", None)


def _context(what, axis_name):
    pos = current()
    if pos is None:
        raise CollectiveError(
            f"{what}: axis {axis_name!r} is not bound; call it inside "
            "smartcal_tpu_torch.parallel.sharded_cal.shard_map")
    return pos, pos.axes(axis_name, what)


def axis_index(axis_name) -> int:
    """This position's index along ``axis_name`` (row-major over several
    names)."""
    pos, axes = _context("axis_index", axis_name)
    return _rank(axes, pos.coords, pos.run.mesh.shape)


def axis_size(axis_name) -> int:
    """The number of positions along ``axis_name`` (their product for
    several names)."""
    pos, axes = _context("axis_size", axis_name)
    shape = pos.run.mesh.shape
    return int(np.prod([shape[a] for a in axes], dtype=np.int64))


def _wait(group, pos, what, axes):
    try:
        group.barrier.wait()
    except threading.BrokenBarrierError:
        timed_out = not pos.run.aborted
        pos.run.abort()
        why = (f"waited past {pos.run.timeout:g} s" if timed_out
               else "was aborted: another position failed")
        raise CollectiveError(
            f"{what} over {axes} at position {pos.coords} {why}") from None


def _sum(slots):
    """Rank order sum of the slots on rank 0's device; returns (sum, event
    recorded after it or None).  Each slot is read on this thread's current
    stream of its device, after that stream has waited on the slot's
    event (a copy between devices syncs both devices' current streams)."""
    x0 = slots[0][0]
    if not isinstance(x0, torch.Tensor):
        acc = x0
        for x, _ in slots[1:]:
            acc = acc + x
        return acc, None
    dev = x0.device
    acc = x0
    for x, ev in slots[1:]:
        _read_on(x, ev)
        acc = acc + x.to(dev)
    done = None
    if dev.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(dev))
    return acc, done


def _read_on(x, ev):
    """Order this thread's current stream on ``x``'s device after ``ev``
    (recorded where ``x`` was written) and mark ``x`` used there."""
    if ev is not None:
        src = torch.cuda.current_stream(x.device)
        src.wait_event(ev)
        x.record_stream(src)


def psum(x, axis_name):
    """The sum of ``x`` over the positions of ``axis_name`` (a name or a
    sequence of names), the same bits on every position.  ``x`` is a tensor
    or a Python number; over an axis of size 1 it is returned as it is."""
    pos, axes = _context("psum", axis_name)
    group, rank = pos.run.group(axes, pos.coords)
    if group.size == 1:
        return x
    ev = None
    if isinstance(x, torch.Tensor) and x.device.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(x.device))
    group.slots[rank] = (x, ev)
    _wait(group, pos, "psum", axes)
    if rank == 0:
        group.result = _sum(group.slots)
        group.slots = [None] * group.size
    _wait(group, pos, "psum", axes)
    out, done = group.result
    if not isinstance(out, torch.Tensor):
        return out
    # every rank, the first too, takes a copy: a position may change its
    # result in place while another still reads the shared sum
    dev = x.device
    if rank:
        _read_on(out, done)
    return out.clone() if out.device == dev else out.to(dev)


def pmean(x, axis_name):
    """:func:`psum` divided by :func:`axis_size`."""
    return psum(x, axis_name) / axis_size(axis_name)
