"""Collectives of the sharded calibration routes: the counterparts of
``jax.lax.psum``, ``pmean``, ``all_gather``, ``axis_index`` and
``axis_size``, and of ``multihost_utils.process_allgather``.

``parallel/sharded_cal.shard_map`` runs its body once per mesh position and
binds the position's axis context (:class:`Position`).  The functions here
read that context; outside a ``shard_map`` (or :func:`on_mesh`) they raise
:class:`CollectiveError`.  They sit below ``cal/`` because the solver and
the influence engine call them, and ``parallel/`` imports ``cal/``.

A collective over the axes A runs within the positions that share every
other axis's index (the group), ranked by their indices on A in mesh
order.  ``psum`` forms the sum in rank order, ``((x0 + x1) + x2) + ...``,
whatever order the positions arrive in, so every position gets the same
bits, two runs give the same bits, and the two forms below give each
other's bits.  Python numbers are summed on the host in the same order.

**Threads** (a mesh of devices): each position is a host thread of its own
(on the card with a CUDA stream of its own).  The sum is formed once, on
the first rank's device, and every rank takes a copy of that one result (a
position may change its copy in place).  A tensor written on one stream is
read on another only after the reader's stream has waited on an event
recorded on the writer's, and it is marked as used on the reader's stream
(``record_stream``), so the allocator keeps its memory until the read is
done.  A barrier that waits past the run's timeout, or a position whose
body raises, aborts the run (:meth:`Run.abort`): every barrier breaks,
every waiting position raises :class:`CollectiveError`, and ``shard_map``
re-raises the first error.

**Processes** (a mesh of :class:`~smartcal_tpu_torch.parallel.mesh.
RankDevice` positions, ``parallel/multihost``): each rank runs its one
position in its main thread, and a collective is a ``torch.distributed``
``all_gather`` within the group's process group, followed by the sum in
rank order on the rank's own device; ``all_reduce``, whose order the
backend chooses, is never used.  Under gloo a CUDA tensor is staged
through host memory, under nccl a host tensor through the rank's GPU.
:func:`make_groups` makes every group of a mesh once, when the mesh is
made, on every rank in the same order (``new_group`` is a collective
call).  A rank that raises or dies, or a wait past the job's
timeout, makes the other ranks' collectives raise
:class:`CollectiveError`.

Nothing waits forever.
"""

import contextlib
import datetime
import itertools
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


#: (mesh key, axes, indices on the other axes) -> (process group or None
#: for the job's default group, member ranks in rank order on the axes)
_groups = {}
_made = set()


def _mesh_key(mesh):
    return (mesh.axis_names, tuple(mesh.shape.values()),
            tuple(int(r) for r in mesh.ranks.reshape(-1)))


def make_groups(mesh) -> None:
    """Make every collective group of the mesh of processes ``mesh``: for
    each set of axes (in mesh order, fewer axes first) and each index on
    the other axes, the process group of its ranks.  Every rank makes every
    group, its own or not, in this one order; a group of one rank needs
    none, and a group of every rank is the job's default group.  A mesh
    seen before reuses its groups."""
    import torch.distributed as dist

    from smartcal_tpu_torch.parallel import multihost

    key = _mesh_key(mesh)
    if key in _made:
        return
    names, shape = mesh.axis_names, mesh.shape
    world = multihost.process_count()
    for r in range(1, len(names) + 1):
        for axes in itertools.combinations(names, r):
            others = [a for a in names if a not in axes]
            for oc in itertools.product(*(range(shape[a]) for a in others)):
                members = []
                for ac in itertools.product(*(range(shape[a])
                                              for a in axes)):
                    c = dict(zip(others, oc), **dict(zip(axes, ac)))
                    members.append(int(mesh.ranks[tuple(c[a]
                                                        for a in names)]))
                pg = None
                if 1 < len(members) < world:
                    pg = dist.new_group(
                        sorted(members), timeout=datetime.timedelta(
                            seconds=multihost.timeout()))
                _groups[(key, axes, oc)] = (pg, members)
    _made.add(key)


def forget_groups() -> None:
    """Drop every group (the job is ending)."""
    _groups.clear()
    _made.clear()


class ProcessRun:
    """The collective state of a mesh of processes: its groups (the job's
    timeout bounds their waits)."""

    def __init__(self, mesh):
        self.mesh = mesh
        self._key = _mesh_key(mesh)
        make_groups(mesh)

    def group(self, axes, coords):
        """(process group, member ranks in rank order) of the position at
        ``coords`` for a collective over ``axes``."""
        oc = tuple(coords[a] for a in self.mesh.axis_names if a not in axes)
        return _groups[(self._key, axes, oc)]


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
    if isinstance(pos.run, ProcessRun):
        return _sum_ordered(_process_gather(pos, axes, x, "psum"))
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


def all_gather(x, axis_name):
    """Every position's ``x`` along ``axis_name``, concatenated on the
    leading dimension in rank order (``jax.lax.all_gather(...,
    tiled=True)``), on this position's device.  ``x`` is a tensor whose
    shape is the same on every position.  Over thread positions only a
    one-position axis is supported (no thread program gathers)."""
    pos, axes = _context("all_gather", axis_name)
    if isinstance(pos.run, ProcessRun):
        return torch.cat(_process_gather(pos, axes, x, "all_gather"))
    if axis_size(axis_name) == 1:
        return x
    raise CollectiveError(f"all_gather over {axes}: the thread form "
                          "gathers over one position only")


# -- the process form --------------------------------------------------------

def _staged(x, backend):
    """``x`` as the backend moves it: gloo takes host tensors, nccl the
    rank's GPU's."""
    from smartcal_tpu_torch.parallel import multihost

    x = x.detach()
    if backend == "gloo" and x.device.type != "cpu":
        x = x.cpu()
    elif backend == "nccl" and x.device.type != "cuda":
        x = x.to(multihost.local_device())
    return x.contiguous()


def _gather(x, group, n, what):
    """Every member's ``x`` (a tensor or a Python number) of the process
    group ``group`` (None: the job's), ``n`` members, in the group's rank
    order (ascending global rank), tensors on ``x``'s device."""
    import torch.distributed as dist

    from smartcal_tpu_torch.parallel import multihost

    try:
        if isinstance(x, torch.Tensor):
            y = _staged(x, multihost.backend())
            bufs = [torch.empty_like(y) for _ in range(n)]
            dist.all_gather(bufs, y, group=group)
            return [b.to(x.device) for b in bufs]
        got = [None] * n
        dist.all_gather_object(got, x, group=group)
        return got
    except Exception as e:             # noqa: BLE001 — re-raised as ours
        raise CollectiveError(
            f"{what} at rank {multihost.process_index()} failed: another "
            f"rank failed or the wait passed {multihost.timeout():g} s: "
            f"{e}") from e


def _process_gather(pos, axes, x, what):
    """Every member's ``x`` in rank order on ``axes``."""
    pg, members = pos.run.group(axes, pos.coords)
    if len(members) == 1:
        return [x]
    got = _gather(x, pg, len(members),
                  f"{what} over {axes} at position {pos.coords}")
    by_rank = dict(zip(sorted(members), got))
    return [by_rank[r] for r in members]


def _sum_ordered(parts):
    acc = parts[0]
    for y in parts[1:]:
        acc = acc + y
    return acc


@contextlib.contextmanager
def on_mesh(mesh):
    """Bind this process's position of the mesh of processes ``mesh`` (or
    the one position of a one-position mesh) as the thread's axis context
    for the block, so the collectives run outside a ``shard_map``."""
    if mesh.is_process:
        pos = Position(ProcessRun(mesh), mesh.local_coords)
    elif mesh.size == 1:
        pos = Position(Run(mesh, 0.0), {a: 0 for a in mesh.axis_names})
    else:
        raise CollectiveError(
            f"on_mesh: {mesh!r} has {mesh.size} thread positions; run its "
            "program under shard_map")
    prev = current()
    bind(pos)
    try:
        yield pos
    finally:
        bind(prev)


def _world_gather(x):
    """Every rank's ``x`` in rank order (a one-element list outside a
    job)."""
    from smartcal_tpu_torch.parallel import multihost

    n = multihost.process_count()
    return [x] if n == 1 else _gather(x, None, n, "process_allgather")


def process_allgather(x):
    """Every process's ``x`` stacked on a new leading axis in rank order
    (``jax.experimental.multihost_utils.process_allgather``): a tensor for a
    tensor (on its device), a numpy array for an array or a number.  Outside
    a job the leading axis has size 1."""
    if isinstance(x, torch.Tensor):
        return torch.stack(_world_gather(x))
    arr = np.asarray(x)
    return torch.stack(_world_gather(torch.from_numpy(
        np.ascontiguousarray(arr)))).numpy()


def process_broadcast(tensors, src: int = 0) -> None:
    """Overwrite ``tensors`` (same shapes and dtypes on every rank) in place
    with rank ``src``'s, as one flat message per dtype; a no-op outside a
    job."""
    import torch.distributed as dist

    from smartcal_tpu_torch.parallel import multihost

    if multihost.process_count() == 1 or not tensors:
        return
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    try:
        for dtype, ts in by_dtype.items():
            flat = _staged(torch.cat([t.detach().reshape(-1) for t in ts]),
                           multihost.backend())
            dist.broadcast(flat, src)
            flat = flat.to(ts[0].device)
            i = 0
            with torch.no_grad():
                for t in ts:
                    t.copy_(flat[i:i + t.numel()].view_as(t))
                    i += t.numel()
    except Exception as e:             # noqa: BLE001 — re-raised as ours
        raise CollectiveError(
            f"process_broadcast from rank {src} at rank "
            f"{multihost.process_index()} failed: {e}") from e
