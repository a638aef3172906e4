"""Sharded calibration routes of the PyTorch port (``parallel/sharded_cal``,
the solver's frequency collectives, the baseline-local influence engine and
the backend's mesh routing) against the JAX package's sharded functions on
its 8 virtual CPU devices and against the port's own single-device routes.

The port's meshes here are k positions on the CPU (one thread each); the
JAX calls repeat those of tests/test_sharded_cal.py (same episodes, meshes
and shapes), so its compiled programs are shared through the persistent
compilation cache.  Tolerances are JAX's own: the solve at rtol 5e-3 /
atol 5e-4 (J, Z), the residual's relative norm 1e-3 and sigma_res rel
1e-3 (tests/test_sharded_cal.py: the psum reassociates float32 sums, which
the ADMM iterations amplify); the chunk-sharded influence rtol 1e-5 / atol
1e-6 (its chunks are independent); the baseline-sharded one at relative
norm 1e-5 and its LLR at rtol / atol 1e-4 (tests/test_nscale_kernels.py);
the composed batched arms rtol 2e-3 / atol 2e-5 (tests/test_mesh_compose
.py); the frequency-sharded image at relative norm 1e-4
(tests/test_torch_influence.py's image class).  The influence tolerances
of JAX's sharded-against-single tests hold the port's sharded routes
against the port's single-device ones; against JAX's functions the
influence visibilities are held at the port's cross-package class,
relative norm 1e-4 (``XPKG_REL``).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import imager as jimager
from smartcal_tpu.cal import influence as jinf
from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu.envs import radio as jradio
from smartcal_tpu.parallel import make_mesh as jmake_mesh
from smartcal_tpu.parallel import sharded_cal as jsc
from smartcal_tpu_torch import interop, obs
from smartcal_tpu_torch.cal import influence as tinf
from smartcal_tpu_torch.cal import solver as tsolver
from smartcal_tpu_torch.envs import radio as tradio
from smartcal_tpu_torch.ops import collectives
from smartcal_tpu_torch.parallel import mesh as tmesh
from smartcal_tpu_torch.parallel import sharded_cal as tsc

N_ST, NFREQ, NCH, K = 6, 4, 4, 3
# the port's single-device influence chain against JAX's: 1e-4 relative
# norm (tests/test_torch_influence.py); elementwise it is 3e-5 apart on this
# episode, so JAX's 1e-5 class holds the port's sharded route against its
# own single-device route, and this one against JAX
XPKG_REL = 1e-4
CPU = torch.device("cpu")
P = tmesh.P


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def cpu_mesh(sizes, names):
    return tmesh.make_mesh(sizes, names,
                           devices=[CPU] * int(np.prod(sizes)))


def hold_solve(out, ref):
    """JAX's sharded-solve tolerances (tests/test_sharded_cal.py:52-63)."""
    np.testing.assert_allclose(np.asarray(out.Z), np.asarray(ref.Z),
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(np.asarray(out.J), np.asarray(ref.J),
                               rtol=5e-3, atol=5e-4)
    assert rel(out.residual, ref.residual) < 1e-3
    assert float(out.sigma_res) == pytest.approx(float(ref.sigma_res),
                                                 rel=1e-3)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """k position threads times torch's intra-op pool oversubscribe the CPU
    under the suite's parallel workers: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def episode():
    """tests/test_sharded_cal.py's episode and its 1-D sharded JAX solve;
    the port's copy of the episode and its single-device solve (``jref``:
    that solve as JAX arrays, the operands of both packages' influence
    functions)."""
    backend = jradio.RadioBackend(n_stations=N_ST, n_freqs=NFREQ, n_times=8,
                                  tdelta=2, admm_iters=3, lbfgs_iters=3,
                                  init_iters=4, npix=8)
    ep, mdl = backend.new_demixing_episode(jax.random.PRNGKey(3), K)
    cfg = backend._solver_cfg(K)
    rho = jnp.asarray(mdl.rho)
    jsh = jsc.solve_admm_sharded(jmake_mesh((NFREQ, 2), ("fp", "sp")), ep.V,
                                 ep.Ccal, ep.obs.freqs, ep.f0, rho, cfg,
                                 axis="fp", n_chunks=backend.n_chunks)
    tep = interop.episode_from_numpy(ep)
    tcfg = tsolver.SolverConfig(*cfg)
    trho = torch.as_tensor(np.asarray(mdl.rho, np.float32))
    tref = tsolver.solve_admm(tep.V, tep.Ccal, tep.obs.freqs, tep.f0, trho,
                              tcfg, n_chunks=NCH)
    jref = jsolver.SolveResult(*(jnp.asarray(x.numpy()) for x in tref))
    return dict(backend=backend, ep=ep, mdl=mdl, cfg=cfg, jref=jref,
                jsh=jsh, tep=tep, tcfg=tcfg, trho=trho, tref=tref)


@pytest.fixture(scope="module")
def tsharded(episode):
    e = episode
    mesh = cpu_mesh((2, 2), (tmesh.AXIS_FREQ, tmesh.AXIS_CHUNK))
    return tsc.solve_admm_sharded(mesh, e["tep"].V, e["tep"].Ccal,
                                  e["tep"].obs.freqs, e["tep"].f0,
                                  e["trho"], e["tcfg"], axis="fp",
                                  n_chunks=NCH)


def test_solve_admm_sharded_matches_jax_and_single_device(episode,
                                                          tsharded):
    hold_solve(tsharded, episode["jsh"])
    hold_solve(tsharded, episode["tref"])
    assert tuple(tsharded.J.shape) == tuple(episode["tref"].J.shape)


def test_solve_admm_sharded_gives_the_same_bits_twice(episode, tsharded):
    e = episode
    mesh = cpu_mesh((2, 2), (tmesh.AXIS_FREQ, tmesh.AXIS_CHUNK))
    again = tsc.solve_admm_sharded(mesh, e["tep"].V, e["tep"].Ccal,
                                   e["tep"].obs.freqs, e["tep"].f0,
                                   e["trho"], e["tcfg"], axis="fp",
                                   n_chunks=NCH)
    for a, b in zip(tsharded, again):
        assert torch.equal(a, b)


def test_solve_admm_sharded_stats_and_iterations_operand(episode):
    """collect_stats psums the telemetry over the axis: the same counts as
    the single-device solve and its consensus RMS; admm_iters rides as an
    operand."""
    e = episode
    mesh = cpu_mesh((2,), (tmesh.AXIS_FREQ,))
    out, st = tsc.solve_admm_sharded(
        mesh, e["tep"].V, e["tep"].Ccal, e["tep"].obs.freqs, e["tep"].f0,
        e["trho"], e["tcfg"], n_chunks=NCH, admm_iters=2,
        collect_stats=True)
    ref, rst = tsolver.solve_admm(
        e["tep"].V, e["tep"].Ccal, e["tep"].obs.freqs, e["tep"].f0,
        e["trho"], e["tcfg"], n_chunks=NCH, admm_iters=2,
        collect_stats=True)
    hold_solve(out, ref)
    assert int(st.admm_iters) == int(rst.admm_iters) == 2
    assert int(st.init_iters) == int(rst.init_iters)
    assert st.inner_iters.tolist() == rst.inner_iters.tolist()
    np.testing.assert_allclose(st.primal_resid.numpy(),
                               rst.primal_resid.numpy(), rtol=5e-3)


@pytest.mark.parametrize("polytype", [0, 1])
def test_solve_admm_sharded2d_matches_per_episode(episode, polytype):
    """The dp x fp batched solve against each episode's own single-device
    solve: consensus only within an episode, and under polytype=1 each
    episode's own band edges (tests/test_sharded_cal.py's check).  JAX's
    2-D program is not rerun here (its trace alone takes ~14 s a polytype
    on this CPU): tests/test_sharded_cal.py holds it to JAX's per-episode
    solve, and tests/test_torch_solver.py the port's solve to JAX's."""
    e = episode
    ep1, _ = e["backend"].new_demixing_episode(jax.random.PRNGKey(11), K)
    teps = [e["tep"], interop.episode_from_numpy(ep1)]
    tcfg = e["tcfg"]._replace(polytype=polytype)
    out = tsc.solve_admm_sharded2d(
        cpu_mesh((2, 2), (tmesh.AXIS_DATA, tmesh.AXIS_FREQ)),
        torch.stack([t.V for t in teps]), torch.stack([t.Ccal for t in teps]),
        torch.stack([t.obs.freqs for t in teps]),
        np.asarray([t.f0 for t in teps]), e["trho"], tcfg, n_chunks=NCH)
    for i, t in enumerate(teps):
        ref = tsolver.solve_admm(t.V, t.Ccal, t.obs.freqs, t.f0, e["trho"],
                                 tcfg, n_chunks=NCH)
        hold_solve(tsolver.SolveResult(*(x[i] for x in out)), ref)


def _hadd0(e):
    return jinf.consensus_hadd_scalars(
        e["mdl"].rho, np.zeros(K, np.float32), np.asarray(e["ep"].obs.freqs),
        e["ep"].f0, 0, n_poly=e["backend"].n_poly,
        polytype=e["backend"].polytype)


@pytest.mark.parametrize("perdir", [False, True])
def test_influence_sharded_matches_jax_and_single_device(episode, perdir):
    e = episode
    hadd = _hadd0(e)
    jres = e["jref"]
    Rk = jsolver.residual_to_kernel(jres.residual[0])
    jout = jsc.influence_sharded(jmake_mesh((2, 4), ("fp", "sp")), Rk,
                                 e["ep"].Ccal[0], jres.J[0], hadd, N_ST, NCH,
                                 axis="sp", perdir=perdir)
    tres = interop.solve_result_from_numpy(jres)
    tRk = tsolver.residual_to_kernel(tres.residual[0])
    th = torch.as_tensor(np.array(hadd))
    out = tsc.influence_sharded(cpu_mesh((4,), (tmesh.AXIS_CHUNK,)), tRk,
                                e["tep"].Ccal[0], tres.J[0], th, N_ST, NCH,
                                perdir=perdir)
    ref = tinf.influence_visibilities(tRk, e["tep"].Ccal[0], tres.J[0], th,
                                      N_ST, NCH, perdir=perdir)
    np.testing.assert_allclose(out.vis.numpy(), ref.vis.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out.llr.numpy(), ref.llr.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert rel(out.vis, jout.vis) < XPKG_REL
    assert rel(out.llr, jout.llr) < XPKG_REL


@pytest.mark.parametrize("perdir", [False, True])
def test_influence_baseline_sharded_matches_jax_and_single_device(episode,
                                                                  perdir):
    """B=15 over 5 positions: each position's Hessian sums through kernel
    3's wrapper (its plain version on the CPU) on its slice, the psums
    rebuild the global Hessian; the same bits over two calls."""
    e = episode
    hadd = _hadd0(e)
    jres = e["jref"]
    Rk = jsolver.residual_to_kernel(jres.residual[0])
    jout = jsc.influence_baseline_sharded(
        jmake_mesh((5,), ("bp",), devices=jax.devices()[:5]), Rk,
        e["ep"].Ccal[0], jres.J[0], hadd, N_ST, NCH, axis="bp",
        perdir=perdir)
    tres = interop.solve_result_from_numpy(jres)
    tRk = tsolver.residual_to_kernel(tres.residual[0])
    th = torch.as_tensor(np.array(hadd))
    mesh = cpu_mesh((5,), (tmesh.AXIS_BASELINE,))
    out = tsc.influence_baseline_sharded(mesh, tRk, e["tep"].Ccal[0],
                                         tres.J[0], th, N_ST, NCH,
                                         perdir=perdir)
    ref = tinf.influence_visibilities(tRk, e["tep"].Ccal[0], tres.J[0], th,
                                      N_ST, NCH, perdir=perdir)
    assert rel(out.vis, ref.vis) < 1e-5
    assert rel(out.vis, jout.vis) < XPKG_REL
    for want in (jout, ref):
        np.testing.assert_allclose(out.llr.numpy(), np.asarray(want.llr),
                                   rtol=1e-4, atol=1e-4)
    again = tsc.influence_baseline_sharded(mesh, tRk, e["tep"].Ccal[0],
                                           tres.J[0], th, N_ST, NCH,
                                           perdir=perdir)
    assert torch.equal(out.vis, again.vis) and torch.equal(out.llr,
                                                           again.llr)


def test_influence_images_sharded_matches_jax_and_single_device(episode):
    e = episode
    ep, jres, be = e["ep"], e["jref"], e["backend"]
    freqs = np.asarray(ep.obs.freqs)
    hall = jinf.consensus_hadd_all(e["mdl"].rho, np.zeros(K, np.float32),
                                   freqs, ep.f0, n_poly=be.n_poly,
                                   polytype=be.polytype)
    uvw = np.asarray(ep.obs.uvw).reshape(-1, 3)
    cell = jimager.default_cell(ep.obs.uvw, float(freqs[-1]))
    jimg = jsc.influence_images_sharded(
        jmake_mesh((4,), ("fp",), devices=jax.devices()[:4]), jres.residual,
        ep.Ccal, jres.J, hall, ep.obs.freqs, jnp.asarray(uvw), cell, N_ST,
        NCH, 8)
    tres = interop.solve_result_from_numpy(jres)
    tep = e["tep"]
    th = torch.as_tensor(np.array(hall))
    tuvw = torch.as_tensor(uvw)
    out = tsc.influence_images_sharded(
        cpu_mesh((2,), (tmesh.AXIS_FREQ,)), tres.residual, tep.Ccal, tres.J,
        th, tep.obs.freqs, tuvw, cell, N_ST, NCH, 8)
    ref = torch.mean(tinf.influence_images_multi(
        tres.residual, tep.Ccal, tres.J, th, freqs, tuvw, cell, N_ST, NCH,
        8), dim=0)
    assert out.shape == (8, 8)
    assert rel(out, jimg) < 1e-4
    assert rel(out, ref) < 1e-4


@pytest.fixture(scope="module")
def batched():
    """tests/test_mesh_compose.py's batch (E=2, N=6, B=15), solved by the
    port (the solve is not what the composed arms hold)."""
    jbe = jradio.RadioBackend(n_stations=6, n_freqs=2, n_times=4, tdelta=2,
                              admm_iters=2, lbfgs_iters=2, init_iters=3,
                              npix=16, shard=False)
    eps, rhos = [], []
    for i in range(2):
        ep, mdl = jbe.new_demixing_episode(jax.random.PRNGKey(20 + i), K)
        eps.append(ep)
        rhos.append(np.asarray(mdl.rho))
    jbep = jbe.stack_episodes(eps)
    rho = np.stack(rhos).astype(np.float32)
    tbe = tradio.RadioBackend(n_stations=6, n_freqs=2, n_times=4, tdelta=2,
                              admm_iters=2, lbfgs_iters=2, init_iters=3,
                              npix=16, device="cpu")
    tbep = interop.batched_episode_from_numpy(jbep)
    tres = tbe.calibrate_batched(tbep, rho)
    jres = jsolver.SolveResult(*(jnp.asarray(x.numpy()) for x in tres))
    return dict(jbe=jbe, jbep=jbep, rho=rho, alpha=np.zeros_like(rho),
                tbe=tbe, tbep=tbep, tres=tres, jres=jres)


@pytest.mark.parametrize("compose", [(2, 3), (0, 3), (2, 0)],
                         ids=["lane_x_baseline", "baseline_only",
                              "lane_only"])
def test_composed_influence_arms_match_jax_and_vmap(batched, compose):
    b = batched
    jimg = b["jbe"].influence_images_batched(b["jbep"], b["jres"], b["rho"],
                                             b["alpha"], compose=compose)
    devs = [CPU] * 6
    with _positions(devs):
        out = b["tbe"].influence_images_batched(
            b["tbep"], b["tres"], b["rho"], b["alpha"], compose=compose)
    ref = b["tbe"].influence_images_batched(b["tbep"], b["tres"], b["rho"],
                                            b["alpha"], compose=(0, 0))
    assert out.shape == (2, 16, 16)
    for want in (jimg, ref):
        np.testing.assert_allclose(out.numpy(), np.asarray(want),
                                   rtol=2e-3, atol=2e-5)


def test_lane_sharded_batched_solve_matches_vmap(batched):
    """calibrate_batched on the composed lane x baseline mesh (the lanes
    split, the baseline positions holding copies) against the vmap route
    (tests/test_mesh_compose.py's check)."""
    b = batched
    with _positions([CPU] * 6):
        out = b["tbe"].calibrate_batched(b["tbep"], b["rho"], compose=(2, 3))
    np.testing.assert_allclose(out.J.numpy(), b["tres"].J.numpy(),
                               rtol=5e-3, atol=5e-4)
    assert rel(out.residual, b["tres"].residual) < 1e-3
    np.testing.assert_allclose(out.sigma_res.numpy(),
                               b["tres"].sigma_res.numpy(), rtol=5e-3)


class _positions:
    """Replace ``parallel/mesh.default_devices`` (the backend's device
    list) by ``devices`` for a block."""

    def __init__(self, devices):
        self.devices = list(devices)

    def __enter__(self):
        self.orig = tmesh.default_devices
        tmesh.default_devices = lambda device=None: list(self.devices)

    def __exit__(self, *exc):
        tmesh.default_devices = self.orig


def test_nondividing_axes_raise_mesh_factorization_error(episode, batched):
    e, b = episode, batched
    tres = e["tref"]
    tRk = tsolver.residual_to_kernel(tres.residual[0])
    th = torch.zeros(K)
    with pytest.raises(tmesh.MeshFactorizationError, match="nearest valid"):
        tsc.solve_admm_sharded(cpu_mesh((3,), (tmesh.AXIS_FREQ,)),
                               e["tep"].V, e["tep"].Ccal, e["tep"].obs.freqs,
                               e["tep"].f0, e["trho"], e["tcfg"],
                               n_chunks=NCH)
    with pytest.raises(tmesh.MeshFactorizationError, match="nearest valid"):
        tsc.influence_baseline_sharded(cpu_mesh((4,), (tmesh.AXIS_BASELINE,)),
                                       tRk, e["tep"].Ccal[0], tres.J[0], th,
                                       N_ST, NCH)
    with pytest.raises(tmesh.MeshFactorizationError, match="nearest valid"):
        tsc.influence_sharded(cpu_mesh((3,), (tmesh.AXIS_CHUNK,)), tRk,
                              e["tep"].Ccal[0], tres.J[0], th, N_ST, NCH)
    with _positions([CPU] * 8), \
            pytest.raises(tmesh.MeshFactorizationError, match="nearest valid"):
        b["tbe"].influence_images_batched(b["tbep"], b["tres"], b["rho"],
                                          b["alpha"], compose=(2, 4))


def test_failing_position_raises_instead_of_hanging():
    """A body that raises on one position aborts the others' collective: the
    call raises that error at once; a position that never reaches the
    collective makes the others give up after the timeout."""
    mesh = cpu_mesh((3,), (tmesh.AXIS_FREQ,))

    def body(x):
        if collectives.axis_index("fp") == 1:
            raise ValueError("position 1 failed")
        return collectives.psum(x, "fp")

    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="position 1 failed"):
        tsc.shard_map(body, mesh, (P("fp"),), P(), timeout=60)(
            torch.ones(3))
    assert time.perf_counter() - t0 < 30
    gate = threading.Event()

    def late(x):
        if collectives.axis_index("fp") == 2:
            gate.wait(1.5)
        return collectives.psum(x, "fp")

    t0 = time.perf_counter()
    with pytest.raises(collectives.CollectiveError, match="waited past"):
        tsc.shard_map(late, mesh, (P("fp"),), P(), timeout=0.5)(
            torch.ones(3))
    assert time.perf_counter() - t0 < 4


def test_collectives_sum_in_mesh_order_and_need_a_shard_map():
    mesh = cpu_mesh((2, 3), (tmesh.AXIS_DATA, tmesh.AXIS_FREQ))

    def body(x):
        return (collectives.psum(x, "fp"), collectives.pmean(x, "dp"),
                collectives.axis_index(("dp", "fp")),
                collectives.axis_size(("dp", "fp")),
                collectives.psum(1.5, ("dp", "fp")))

    x = torch.arange(6.0).reshape(2, 3)
    s, m, idx, size, n = tsc.shard_map(
        body, mesh, (P("dp", "fp"),), (P("dp"), P(None, "fp"), P(), P(),
                                       P()))(x)
    assert s.tolist() == [[3.0], [12.0]]
    assert m.tolist() == [[1.5, 2.5, 3.5]]
    assert (idx, size, n) == (0, 6, 9.0)
    with pytest.raises(collectives.CollectiveError, match="not bound"):
        collectives.psum(x, "fp")
    with pytest.raises(collectives.CollectiveError, match="not an axis"):
        tsc.shard_map(lambda y: collectives.psum(y, "bp"), mesh,
                      (P(),), P())(x)


class _Routed(Exception):
    """Raised by the JAX backend's `_mesh` / `_mesh2` in the route test: the
    route it took, before any program runs."""


def _jax_route(call):
    try:
        call()
    except _Routed as r:
        return r.args
    raise AssertionError("the JAX backend took no mesh route")


def _port_routes(path):
    import json

    out = []
    for line in open(path):
        ev = json.loads(line)
        if ev.get("event") == "span" and ev.get("name") in ("solve",
                                                            "influence"):
            out.append((ev["name"], ev["route"], ev.get("shards",
                                                        ev.get("baseline_shards"))))
    return out


def test_backend_takes_jax_routes_with_four_positions(episode, batched,
                                                      monkeypatch, tmp_path):
    """SMARTCAL_SHARD=1 and 4 positions (the port's device list replaced,
    JAX's device count patched to 4): the port's RadioBackend runs and tags
    the route the JAX backend picks at the same shapes (the JAX backend's
    `_mesh` / `_mesh2` stop it before any program runs)."""
    e, b = episode, batched
    monkeypatch.setenv("SMARTCAL_SHARD", "1")
    monkeypatch.setattr(jax, "device_count", lambda *a, **k: 4)
    axis_route = {"fp": "freq_sharded", "bp": "baseline_sharded",
                  "sp": "chunk_sharded"}

    def jmesh(self, size, axis="fp"):
        raise _Routed(axis, size)

    def jmesh2(self, n_lane, n_baseline):
        raise _Routed("composed", n_baseline)

    monkeypatch.setattr(jradio.RadioBackend, "_mesh", jmesh)
    monkeypatch.setattr(jradio.RadioBackend, "_mesh2", jmesh2)
    jbe = jradio.RadioBackend(n_stations=N_ST, n_freqs=NFREQ, n_times=8,
                              tdelta=2, admm_iters=3, lbfgs_iters=3,
                              init_iters=4, npix=8)
    tbe = tradio.RadioBackend(n_stations=N_ST, n_freqs=NFREQ, n_times=8,
                              tdelta=2, admm_iters=3, lbfgs_iters=3,
                              init_iters=4, npix=8, device="cpu")
    ep, tep, rho = e["ep"], e["tep"], np.asarray(e["mdl"].rho, np.float32)
    alpha = np.zeros(K, np.float32)
    # the Nf=1 episode: no band divisor, so the chunk axis shards
    ep1 = ep._replace(V=ep.V[:1], Ccal=ep.Ccal[:1],
                      obs=ep.obs._replace(freqs=ep.obs.freqs[:1]))
    tep1 = interop.episode_from_numpy(ep1)
    kw1 = dict(n_stations=N_ST, n_freqs=1, n_times=8, tdelta=2,
               admm_iters=3, lbfgs_iters=3, init_iters=4, npix=8)
    jbe1 = jradio.RadioBackend(**kw1)
    tbe1 = tradio.RadioBackend(device="cpu", **kw1)
    tres1 = tbe1.calibrate(tep1, rho)
    jres1 = jsolver.SolveResult(*(jnp.asarray(x.numpy()) for x in tres1))
    jres = e["jref"]

    a, n = _jax_route(lambda: jbe.calibrate(ep, rho))
    assert a == "fp"
    want = [("solve", "sharded", n)]
    a, n = _jax_route(lambda: jbe.influence_image(ep, jres, rho, alpha))
    want.append(("influence", axis_route[a], n))
    monkeypatch.setattr(jradio, "_BLOCK_MIN_B", 10)
    a, n = _jax_route(lambda: jbe.influence_image(ep, jres, rho, alpha))
    want.append(("influence", axis_route[a], n))
    monkeypatch.setattr(jradio, "_BLOCK_MIN_B", 8128)
    a, n = _jax_route(lambda: jbe1.influence_image(ep1, jres1, rho, alpha))
    want.append(("influence", axis_route[a], n))
    a, n = _jax_route(lambda: jbe.calibrate_batched(b["jbep"], b["rho"]))
    assert a == "lane"
    want.append(("solve", "batched_sharded", n))
    monkeypatch.setenv("SMARTCAL_COMPOSE", "1")
    one = b["jbep"]._replace(V=b["jbep"].V[:1], Ccal=b["jbep"].Ccal[:1],
                             freqs=b["jbep"].freqs[:1], f0=b["jbep"].f0[:1],
                             uvw=b["jbep"].uvw[:1], cell=b["jbep"].cell[:1])
    jres_b1 = jsolver.SolveResult(*(x[:1] for x in b["jres"][:6]))
    a, n = _jax_route(lambda: b["jbe"].influence_images_batched(
        one, jres_b1, b["rho"][:1], b["alpha"][:1]))
    want.append(("influence", "batched_lane_bshard", n))
    monkeypatch.setenv("SMARTCAL_COMPOSE", "")

    path = str(tmp_path / "run.jsonl")
    tres = e["tref"]
    tone = b["tbep"]._replace(V=b["tbep"].V[:1], Ccal=b["tbep"].Ccal[:1],
                              freqs=b["tbep"].freqs[:1],
                              f0=b["tbep"].f0[:1], uvw=b["tbep"].uvw[:1],
                              cell=b["tbep"].cell[:1])
    tres_b1 = tsolver.SolveResult(*(x[:1] for x in b["tres"]))
    rl = obs.activate(obs.RunLog(path, flush_lines=1))
    try:
        with _positions([CPU] * 4):
            tbe.calibrate(tep, rho)
            tbe.influence_image(tep, tres, rho, alpha)
            monkeypatch.setattr(tradio, "_BLOCK_MIN_B", 10)
            tbe.influence_image(tep, tres, rho, alpha)
            monkeypatch.setattr(tradio, "_BLOCK_MIN_B", 8128)
            tbe1.influence_image(tep1, tres1, rho, alpha)
            b["tbe"].calibrate_batched(b["tbep"], b["rho"])
            monkeypatch.setenv("SMARTCAL_COMPOSE", "1")
            b["tbe"].influence_images_batched(tone, tres_b1, b["rho"][:1],
                                              b["alpha"][:1])
    finally:
        obs.deactivate(rl)
        rl.close()
    assert _port_routes(path) == want
    assert [w[1] for w in want] == ["sharded", "freq_sharded",
                                    "baseline_sharded", "chunk_sharded",
                                    "batched_sharded",
                                    "batched_lane_bshard"]
