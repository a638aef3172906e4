"""Mesh-sharded calibration (counterpart of
smartcal_tpu/parallel/sharded_cal.py): the frequency-parallel consensus
ADMM and the chunk-, frequency-, baseline- and lane-parallel influence.

The reference distributes calibration over sub-bands with MPI ranks
(``sagecal-mpi``, consensus ADMM) and the influence over calibration
intervals with a process pool.  Here, as in the JAX package, each is one
SPMD program over a :class:`~smartcal_tpu_torch.parallel.mesh.Mesh`:

* :func:`shard_map` runs the program once per mesh position.  On a mesh
  of devices each position is a host thread of its own (PyTorch's
  in-process idiom, ``torch.nn.parallel.parallel_apply``), on the card
  with a CUDA stream of its own.  On a mesh of processes
  (``parallel/multihost``) each rank runs its one position in its main
  thread, on its current stream: every rank is handed the same global
  operands and takes its own block, and every rank assembles the same
  outputs from all ranks' (``torch.distributed`` gathers).  Each global
  operand is split by its :class:`P` spec onto the positions' devices;
  the position binds its axis context, so the collectives of
  ``ops/collectives.py`` (``psum``, ``pmean``, ``axis_index``) run
  between the positions; the outputs are assembled by their out-specs (a
  sharded axis concatenated in mesh order, a replicated output taken from
  the first position) on the mesh's device.  A position that raises, or a
  collective that waits past the timeout, makes the call raise (on a mesh
  of processes, on every rank): nothing hangs, nothing is dropped.
* :func:`solve_admm_sharded` shards the frequency axis over ``fp``: the
  solver's data scale is a ``pmean``, its ``btb``, Z-update sum, residual
  norms and telemetry are ``psum`` s over ``fp`` (the MPI allreduce).
  :func:`solve_admm_sharded2d` adds a ``dp`` axis of independent episodes.
* :func:`influence_sharded` shards the interval (chunk) axis over ``sp``
  (no collective: the output gather); :func:`influence_images_sharded`
  the sub-bands over ``fp`` (one ``psum`` of the band images);
  :func:`influence_baseline_sharded` the baselines over ``bp``
  (``cal/influence.influence_visibilities_blocal``: the psums of the
  Hessian, the adjoint chain's station sum and the LLR norms);
  :func:`influence_images_batched_sharded` lanes over ``lane`` and
  baselines over ``bp`` in one program.

Each position runs the route the single-device port takes at its local
shapes: on the card the SKA tier's kernels (kernel 3 for each position's
baseline slice, kernel 2 for the large-tier images), their plain versions
only for CPU tensors.  The JAX package passes ``use_pallas=False`` inside
its ``shard_map`` because ``pallas_call`` has no partitioning rule; a
position here has no such limit.
"""

import itertools
import threading
from typing import Optional

import numpy as np
import torch

from smartcal_tpu_torch.cal import imager
from smartcal_tpu_torch.cal import influence as influence_mod
from smartcal_tpu_torch.cal import kernels, solver
from smartcal_tpu_torch.ops import collectives
from smartcal_tpu_torch.parallel.mesh import (AXIS_BASELINE, AXIS_CHUNK,
                                              AXIS_DATA, AXIS_FREQ,
                                              AXIS_LANE,
                                              MeshFactorizationError, P,
                                              check_axis_divides)

#: seconds a collective waits for the slowest position before the run is
#: aborted (a first call may build a kernel or capture a graph meanwhile)
TIMEOUT_S = 900.0

_streams = {}
_streams_lock = threading.Lock()


def _position_stream(device, index):
    """The CUDA stream of position ``index`` on ``device``, made once."""
    key = (device, index)
    with _streams_lock:
        s = _streams.get(key)
        if s is None:
            s = _streams[key] = torch.cuda.Stream(device)
        return s


def _positions(mesh):
    """Every position as (flat index, {axis: index}, device), in mesh
    (row-major) order."""
    names, flat = mesh.axis_names, mesh.devices.reshape(-1)
    for i, idx in enumerate(itertools.product(
            *(range(mesh.shape[a]) for a in names))):
        yield i, dict(zip(names, idx)), flat[i]


def _axis_names(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _index(names, coords, shape):
    i = 0
    for a in names:
        i = i * shape[a] + coords[a]
    return i


def _local(x, spec, mesh, coords, dev, what):
    """Position ``coords``'s block of ``x`` under ``spec``, a tensor moved
    to ``dev`` (a view when it lies there)."""
    if not isinstance(x, (torch.Tensor, np.ndarray)):
        if any(_axis_names(e) for e in spec):
            raise ValueError(f"shard_map: {what} is not an array but its "
                             f"spec {spec!r} shards it")
        return x
    idx = []
    for d, entry in enumerate(spec):
        names = _axis_names(entry)
        if not names:
            idx.append(slice(None))
            continue
        n = int(np.prod([mesh.shape[a] for a in names]))
        if x.shape[d] % n:
            raise MeshFactorizationError(
                f"shard_map: {what} dimension {d} of size {x.shape[d]} "
                f"does not divide over {names} ({n} positions)")
        m = x.shape[d] // n
        i = _index(names, coords, mesh.shape)
        idx.append(slice(i * m, (i + 1) * m))
    y = x[tuple(idx)]
    return y.to(dev) if isinstance(y, torch.Tensor) else y


def _leaves(x):
    """The tensors of an output tree (tuples and named tuples)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, tuple):
        for v in x:
            yield from _leaves(v)


def _assemble_leaf(spec, outs, mesh, coords_of):
    """One output leaf on ``mesh.device`` from every position's value
    under ``spec`` (a non-tensor is taken from the first position)."""
    if not isinstance(outs[0], torch.Tensor):
        return outs[0]
    dims = [(d, _axis_names(e)) for d, e in enumerate(spec)]
    flat_of = {tuple(c[a] for a in mesh.axis_names): i
               for i, c in enumerate(coords_of)}

    def build(k, fixed):
        if k == len(dims):
            key = tuple(fixed.get(a, 0) for a in mesh.axis_names)
            return outs[flat_of[key]].to(mesh.device)
        d, names = dims[k]
        if not names:
            return build(k + 1, fixed)
        sizes = [mesh.shape[a] for a in names]
        parts = []
        for idx in np.ndindex(*sizes):
            parts.append(build(k + 1, dict(fixed, **dict(zip(names, idx)))))
        return torch.cat(parts, dim=d)

    return build(0, {})


def _assemble(spec, outs, mesh, coords_of):
    """The output tree from every position's tree: ``spec`` is a prefix of
    it (a :class:`P` applies to every leaf under it)."""
    if isinstance(spec, P) and not isinstance(outs[0], tuple):
        return _assemble_leaf(spec, outs, mesh, coords_of)
    like = outs[0] if isinstance(spec, P) else spec
    specs = (spec,) * len(like) if isinstance(spec, P) else spec
    parts = [_assemble(s, [o[i] for o in outs], mesh, coords_of)
             for i, s in enumerate(specs)]
    return type(like)(*parts) if hasattr(like, "_fields") \
        else type(like)(parts)


def shard_map(f, mesh, in_specs, out_specs, timeout: Optional[float] = None):
    """``f`` as one SPMD program over ``mesh`` (``jax.shard_map``): returns
    a callable of the global operands.

    ``in_specs`` has one :class:`P` per positional operand (a tensor or a
    numpy array; anything else must have ``P()`` and is passed as it is);
    ``out_specs`` is a prefix of ``f``'s output tree.  Each position gets
    its block of every operand on its own device (a view when the device
    is the operand's), runs ``f`` in its thread under its axis context,
    and on the card on its own stream, which first waits on the caller's
    streams; the caller's stream then waits on every position's, and the
    outputs are assembled on ``mesh.device``.  Grad mode follows the
    caller's.  ``timeout`` (default :data:`TIMEOUT_S`) bounds each
    collective's wait (on a mesh of processes the job's timeout does,
    ``parallel/multihost.initialize``).  Raises the first error a position raised other
    than a broken collective's :class:`~smartcal_tpu_torch.ops.
    collectives.CollectiveError`, or the first of those."""
    timeout = TIMEOUT_S if timeout is None else float(timeout)
    in_specs = tuple(in_specs)

    def run(*args):
        if len(args) != len(in_specs):
            raise ValueError(f"shard_map: {len(args)} operands for "
                             f"{len(in_specs)} in_specs")
        if mesh.is_process:
            return _run_process(f, mesh, in_specs, out_specs, args)
        spots = list(_positions(mesh))
        coords_of = [c for _, c, _ in spots]
        state = collectives.Run(mesh, timeout)
        cuda_devs = {t.device for a in args for t in _leaves(a)
                     if t.device.type == "cuda"}
        cuda_devs |= {d for _, _, d in spots if d.type == "cuda"}
        starts = {}
        for d in cuda_devs:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(d))
            starts[d] = ev
        grad = torch.is_grad_enabled()
        results = [None] * len(spots)
        errors, lock = [], threading.Lock()

        def local(coords, dev):
            return [_local(a, s, mesh, coords, dev, f"operand {k}")
                    for k, (a, s) in enumerate(zip(args, in_specs))]

        def body(i, coords, dev):
            collectives.bind(collectives.Position(state, coords))
            try:
                with torch.set_grad_enabled(grad):
                    if dev.type != "cuda":
                        results[i] = (f(*local(coords, dev)), None)
                        return
                    stream = _position_stream(dev, i)
                    with torch.cuda.device(dev), torch.cuda.stream(stream):
                        for ev in starts.values():
                            stream.wait_event(ev)
                        out = f(*local(coords, dev))
                        done = torch.cuda.Event()
                        done.record(stream)
                    results[i] = (out, done)
            except BaseException as e:       # noqa: BLE001 — re-raised below
                with lock:
                    errors.append(e)
                state.abort()
            finally:
                collectives.bind(None)

        threads = [threading.Thread(target=body, args=(i, c, d),
                                    name=f"shard_map-{i}", daemon=True)
                   for i, c, d in spots]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise next((e for e in errors if not isinstance(
                e, collectives.CollectiveError)), errors[0])
        outs = []
        for out, done in results:
            if done is not None:
                for t in _leaves(out):
                    if t.device.type == "cuda":
                        cur = torch.cuda.current_stream(t.device)
                        cur.wait_event(done)
                        t.record_stream(cur)
            outs.append(out)
        return _assemble(out_specs, outs, mesh, coords_of)

    return run


def _gather_trees(x):
    """Every rank's output tree, by rank (tensors on this rank's device)."""
    if isinstance(x, torch.Tensor):
        return collectives._world_gather(x)
    if isinstance(x, tuple):
        rows = zip(*(_gather_trees(v) for v in x))
        if hasattr(x, "_fields"):
            return [type(x)(*r) for r in rows]
        return [type(x)(r) for r in rows]
    return collectives._world_gather(x)


def _run_process(f, mesh, in_specs, out_specs, args):
    """:func:`shard_map`'s run on a mesh of processes: this rank's block of
    every operand on its device, ``f`` in this thread (on the current
    stream) under its position's axis context, then every rank's outputs
    gathered and assembled by ``out_specs`` on every rank."""
    coords = mesh.local_coords
    dev = mesh.device
    local = [_local(a, s, mesh, coords, dev, f"operand {k}")
             for k, (a, s) in enumerate(zip(args, in_specs))]
    prev = collectives.current()
    collectives.bind(collectives.Position(collectives.ProcessRun(mesh),
                                          coords))
    try:
        out = f(*local)
    finally:
        collectives.bind(prev)
    by_rank = _gather_trees(out)
    spots = list(_positions(mesh))
    ranks = mesh.ranks.reshape(-1)
    return _assemble(out_specs, [by_rank[int(ranks[i])] for i, _, _ in spots],
                     mesh, [c for _, c, _ in spots])


def _host(x):
    """``x`` as a host numpy array (a tensor is copied to the host)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def solve_admm_sharded(mesh, V, C, freqs, f0, rho, cfg: solver.SolverConfig,
                       axis: str = AXIS_FREQ, n_chunks: Optional[int] = None,
                       admm_iters=None, freq_range=None,
                       collect_stats: bool = False):
    """Consensus-ADMM solve with the frequency axis sharded over ``axis``.

    V (Nf, T, B, 2, 2, 2), C (Nf, K, T*B, 4, 2), freqs (Nf,) are global; Nf
    must divide by the axis size.  Returns a SolveResult with J, residual
    and final_cost frequency-sharded and Z and the sigmas replicated, the
    single-device solve's math (the psum is the global sum; only the order
    of the sums differs).  ``admm_iters`` rides as a replicated operand.
    ``collect_stats`` returns ``(result, SolverStats)`` with the telemetry
    summed over ``axis`` (replicated).  With ``polytype=1`` and no
    ``freq_range`` the band edges are the global min and max of ``freqs``,
    so every shard builds the same basis."""
    nfp = mesh.shape[axis]
    check_axis_divides(V.shape[0], nfp, axis=axis,
                       what="solve_admm_sharded Nf")
    if cfg.polytype == 1 and freq_range is None:
        fr = _host(freqs)
        freq_range = (float(fr.min()), float(fr.max()))

    def local(v, c, f, r, it):
        return solver.solve_admm(v, c, f, f0, r, cfg, n_chunks=n_chunks,
                                 admm_iters=it, collect_stats=collect_stats,
                                 axis_name=axis, freq_range=freq_range)

    out_specs = solver.SolveResult(J=P(axis), Z=P(), residual=P(axis),
                                   sigma_res=P(), sigma_data=P(),
                                   final_cost=P(axis))
    if collect_stats:
        out_specs = (out_specs, P())
    sharded = shard_map(local, mesh, (P(axis), P(axis), P(axis), P(), P()),
                        out_specs)
    return sharded(V, C, freqs, rho,
                   None if admm_iters is None else int(admm_iters))


def solve_admm_sharded2d(mesh, Vb, Cb, freqs_b, f0_b, rho,
                         cfg: solver.SolverConfig, dp_axis: str = AXIS_DATA,
                         fp_axis: str = AXIS_FREQ,
                         n_chunks: Optional[int] = None, admm_iters=None,
                         freq_range=None):
    """Batched frequency-consensus solves on a 2-D (dp x fp) mesh: E
    independent episodes sharded over ``dp``, each episode's frequency axis
    over ``fp``; the consensus psums ride ``fp`` only.  Vb (E, Nf, T, B, 2,
    2, 2), Cb (E, Nf, K, T*B, 4, 2), freqs_b (E, Nf), f0_b (E,), rho (K,)
    shared.  E must divide by the dp size and Nf by the fp size.  With
    ``polytype=1`` each episode's basis spans its own band (its own min and
    max), or ``freq_range`` for all.  A position solves its episodes one
    after another."""
    ndp, nfp = mesh.shape[dp_axis], mesh.shape[fp_axis]
    check_axis_divides(Vb.shape[0], ndp, axis=dp_axis,
                       what="solve_admm_sharded2d E")
    check_axis_divides(Vb.shape[1], nfp, axis=fp_axis,
                       what="solve_admm_sharded2d Nf")
    E = Vb.shape[0]
    fb = _host(freqs_b).astype(np.float32).reshape(E, -1)
    if cfg.polytype == 1:
        if freq_range is not None:
            lo = np.full(E, freq_range[0], np.float32)
            hi = np.full(E, freq_range[1], np.float32)
        else:
            lo, hi = fb.min(axis=1), fb.max(axis=1)
    else:
        lo = hi = np.zeros(E, np.float32)
    f0_b = np.asarray(_host(f0_b), np.float32).reshape(E)

    def local(v, c, f, f0, lo_, hi_, r):
        outs = []
        for e in range(v.shape[0]):
            rng = (float(lo_[e]), float(hi_[e])) if cfg.polytype == 1 \
                else None
            outs.append(solver.solve_admm(
                v[e], c[e], f[e], float(f0[e]), r, cfg, n_chunks=n_chunks,
                admm_iters=admm_iters, axis_name=fp_axis, freq_range=rng))
        return solver.SolveResult(*(torch.stack(x) for x in zip(*outs)))

    out_specs = solver.SolveResult(
        J=P(dp_axis, fp_axis), Z=P(dp_axis),
        residual=P(dp_axis, fp_axis), sigma_res=P(dp_axis),
        sigma_data=P(dp_axis), final_cost=P(dp_axis, fp_axis))
    sharded = shard_map(
        local, mesh, (P(dp_axis, fp_axis), P(dp_axis, fp_axis),
                      P(dp_axis, fp_axis), P(dp_axis), P(dp_axis),
                      P(dp_axis), P()), out_specs)
    return sharded(Vb, Cb, freqs_b, f0_b, lo, hi, rho)


def influence_sharded(mesh, R, C, J, hadd, n_stations: int, n_chunks: int,
                      axis: str = AXIS_CHUNK, perdir=False, optimized=True,
                      block_baselines=0, precision: str = "f32"):
    """Influence visibilities with the interval (chunk) axis sharded over
    ``axis`` (the reference's process pool as a mesh axis): the arguments
    and result of ``cal/influence.influence_visibilities``, ``n_chunks``
    divisible by the axis size.  The chunks are independent, so the only
    collective is the gather; each position runs the single-device chain
    on its chunks (``block_baselines`` > 0: kernel 3 on the card)."""
    nsp = mesh.shape[axis]
    check_axis_divides(n_chunks, nsp, axis=axis,
                       what="influence_sharded n_chunks")
    B = n_stations * (n_stations - 1) // 2
    K = C.shape[0]
    Td = C.shape[1] // B // n_chunks
    local_chunks = n_chunks // nsp
    # pre-chunked so the shard axis leads
    R4 = R.reshape(n_chunks, 2 * B * Td, 2, 2)
    C4 = C.reshape(K, n_chunks, B * Td, 4, 2).movedim(1, 0)

    def local(r4, c4, j):
        r = r4.reshape(local_chunks * 2 * B * Td, 2, 2)
        c = c4.movedim(0, 1).reshape(K, local_chunks * B * Td, 4, 2)
        return influence_mod.influence_visibilities(
            r, c, j, hadd, n_stations, local_chunks,
            block_baselines=block_baselines, perdir=perdir,
            precision=precision, optimized=optimized)

    # the chunk-major local samples concatenate into the global time order
    out_specs = influence_mod.InfluenceResult(
        vis=P(None, axis) if perdir else P(axis), llr=P(axis))
    return shard_map(local, mesh, (P(axis), P(axis), P(axis)),
                     out_specs)(R4, C4, J)


def influence_baseline_sharded(mesh, R, C, J, hadd, n_stations: int,
                               n_chunks: int, axis: str = AXIS_BASELINE,
                               perdir=False, precision: str = "f32"):
    """Influence visibilities with the BASELINE axis sharded over ``axis``
    (the SKA-scale partition: every per-baseline tensor lives 1/n-th per
    position; the 4N x 4N solves run replicated).  Arguments and result of
    ``cal/influence.influence_visibilities`` on the optimized chain; B =
    N(N-1)/2 must divide by the axis size.  The collectives are the psums
    of ``influence_visibilities_blocal``; each position's Hessian sums are
    one kernel-3 launch per interval on the card.  Equal to the
    single-device chain to float round-off (the psums reassociate)."""
    nbp = mesh.shape[axis]
    B = n_stations * (n_stations - 1) // 2
    check_axis_divides(B, nbp, axis=axis,
                       what="influence_baseline_sharded B")
    K = C.shape[0]
    T = C.shape[1] // B
    Td = T // n_chunks
    R3 = R.reshape(n_chunks, Td, B, 2, 2, 2)
    C5 = C.reshape(K, n_chunks, Td, B, 2, 2, 2).transpose(-3, -2) \
        .movedim(1, 0)
    p_idx, q_idx = kernels.baseline_indices(n_stations, R.device)

    def local(r3, c5, j, h, pi, qi):
        return influence_mod.influence_visibilities_blocal(
            r3, c5, j, pi, qi, h, n_stations, B, perdir=perdir,
            axis_name=axis, precision=precision)

    out_specs = influence_mod.InfluenceResult(
        vis=P(None, None, axis) if perdir else P(None, axis), llr=P())
    res = shard_map(local, mesh,
                    (P(None, None, axis), P(None, None, None, axis), P(),
                     P(), P(axis), P(axis)),
                    out_specs)(R3, C5, J, hadd, p_idx, q_idx)
    # the concatenated baseline axis restores the time-major order
    vis = res.vis.reshape((K, T * B, 4, 2) if perdir else (T * B, 4, 2))
    return influence_mod.InfluenceResult(vis=vis, llr=res.llr)


def influence_images_sharded(mesh, residual, C, J, hadd_all, freqs, uvw,
                             cell, n_stations: int, n_chunks: int, npix: int,
                             axis: str = AXIS_FREQ, optimized=True,
                             block_baselines=0, imager_block_r=0,
                             precision: str = "f32"):
    """Mean influence dirty image with the FREQUENCY axis sharded over
    ``axis``: each position runs ``cal/influence.influence_images_multi``
    on its sub-bands and the mean is one psum.  residual (Nf, T, B, 2, 2,
    2); C (Nf, K, T*B, 4, 2); J (Nf, Ts, K, 2N, 2, 2); hadd_all (Nf, K);
    freqs (Nf,); uvw (T*B, 3).  Nf must divide by the axis size.  Returns
    the (npix, npix) mean image."""
    nfp = mesh.shape[axis]
    Nf = residual.shape[0]
    check_axis_divides(Nf, nfp, axis=axis,
                       what="influence_images_sharded Nf")

    def local(r, c, j, h, f, uvw_):
        imgs = influence_mod.influence_images_multi(
            r, c, j, h, f, uvw_, cell, n_stations, n_chunks, npix,
            optimized=optimized, block_baselines=block_baselines,
            imager_block_r=imager_block_r, precision=precision)
        return collectives.psum(torch.sum(imgs, dim=0), axis)

    sharded = shard_map(local, mesh,
                        (P(axis), P(axis), P(axis), P(axis), P(axis), P()),
                        P())
    return sharded(residual, C, J, hadd_all, _host(freqs), uvw) / Nf


def influence_images_batched_sharded(mesh, residual_b, Cb, Jb, rho_b,
                                     alpha_b, freqs_b, f0_b, uvw_b, cell_b,
                                     n_stations: int, n_chunks: int,
                                     npix: int, n_poly: int = 2,
                                     polytype: int = 0,
                                     lane_axis: str = AXIS_LANE,
                                     baseline_axis: str = AXIS_BASELINE,
                                     imager_block_r: int = 0,
                                     precision: str = "f32"):
    """Batched mean influence images with the LANE axis and the BASELINE
    axis sharded in one program on the composed mesh: each position holds
    E/n_lane lanes by B/n_baseline baselines, runs the shard-local engine
    (``influence_visibilities_blocal``) per lane and sub-band and images
    its local baselines; the Hessian, adjoint and LLR psums and the final
    image sum ride ``baseline_axis`` only, the lane axis carries none.

    residual_b (E, Nf, T, B, 2, 2, 2); Cb (E, Nf, K, T*B, 4, 2); Jb (E, Nf,
    Ts, K, 2N, 2, 2); rho_b / alpha_b (E, K); freqs_b (E, Nf); f0_b (E,);
    uvw_b (E, T*B, 3); cell_b (E,).  Returns (E, npix, npix).  Either axis
    may have size 1.  A position images its baselines with the factored
    imager, ``imager_block_r`` > 0 its large tier (kernel 2 on the card)."""
    nl = mesh.shape[lane_axis]
    nb = mesh.shape[baseline_axis]
    E = residual_b.shape[0]
    B = n_stations * (n_stations - 1) // 2
    check_axis_divides(E, nl, axis=lane_axis,
                       what="influence_images_batched_sharded E")
    check_axis_divides(B, nb, axis=baseline_axis,
                       what="influence_images_batched_sharded B")
    Nf, T = residual_b.shape[1], residual_b.shape[2]
    K = Cb.shape[2]
    Ts = n_chunks
    Td = T // Ts
    # the (T*B,) sample axis is t-major: unfold (T, B) so a shard is a
    # contiguous baseline range
    C7 = Cb.reshape(E, Nf, K, T, B, 4, 2)
    U4 = torch.as_tensor(uvw_b).reshape(E, T, B, 3)
    p_idx, q_idx = kernels.baseline_indices(n_stations,
                                           residual_b.device)

    def local(res, c7, j, r, a, f, f0_, u4, cl, pi, qi):
        imgs = []
        for e in range(res.shape[0]):
            hadd = influence_mod.consensus_hadd_all(
                r[e], a[e], f[e], float(f0_[e]), n_poly=n_poly,
                polytype=polytype)                           # (Nf, K)
            Bl = res.shape[3]
            ul = u4[e].reshape(-1, 3)
            acc = None
            for fi in range(Nf):
                R3 = res[e, fi].reshape(Ts, Td, Bl, 2, 2, 2)
                C5 = c7[e, fi].reshape(K, Ts, Td, Bl, 2, 2, 2) \
                    .transpose(-3, -2).movedim(1, 0)
                inf = influence_mod.influence_visibilities_blocal(
                    R3, C5, j[e, fi], pi, qi, hadd[fi], n_stations, B,
                    axis_name=baseline_axis, precision=precision)
                ivis = influence_mod.stokes_i_influence(
                    inf.vis.reshape(Ts * Td * Bl, 4, 2))
                if imager_block_r:
                    img = imager.dirty_image_factored_large_sr(
                        ul, ivis, float(f[e, fi]), float(cl[e]), npix=npix,
                        block_r=imager_block_r, precision=precision)
                else:
                    img = imager.dirty_image_factored_sr(
                        ul, ivis, float(f[e, fi]), float(cl[e]), npix=npix,
                        precision=precision)
                acc = img if acc is None else acc + img
            imgs.append(acc / Nf)
        # each position imaged its baselines with a local-R normalization:
        # the psum over the baseline axis and the 1/nb restore the global
        # (1/R_total) sum image
        return collectives.psum(torch.stack(imgs), baseline_axis) / nb

    sharded = shard_map(
        local, mesh,
        (P(lane_axis, None, None, baseline_axis),
         P(lane_axis, None, None, None, baseline_axis),
         P(lane_axis), P(lane_axis), P(lane_axis), P(lane_axis),
         P(lane_axis), P(lane_axis, None, baseline_axis), P(lane_axis),
         P(baseline_axis), P(baseline_axis)),
        P(lane_axis))
    return sharded(residual_b, C7, Jb, torch.as_tensor(_host(rho_b)),
                   torch.as_tensor(_host(alpha_b)),
                   torch.as_tensor(_host(freqs_b)),
                   np.asarray(_host(f0_b), np.float32), U4,
                   np.asarray(_host(cell_b), np.float32), p_idx, q_idx)
