"""The port's host-segmented solve, ``lbfgs_resume``, the ``J0`` warm start
and the solver's degradation ladder against the JAX package.

The problem is tests/test_cal_backend.py's (N=6, K=2, Nf=3, T=6, two
solution intervals; admm 3, L-BFGS 5, init 11), made by the JAX package
and handed to the port as numpy.  Tolerances: the port's host-segmented
solve against JAX's at JAX's own host-vs-fused tolerances (J rtol 2e-3 /
atol 2e-4, residual 2e-3 / 2e-3, sigma_res rtol 1e-3, sigma_data 1e-5);
against the port's fused solve bit for bit (one line search serves every
segment and a resumed segment runs the same loop).  The warm start is
held as tests/test_torch_solver.py holds the cold solve (J and residual
1e-3 relative norm, sigma_res in the 1e-3 band).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import coherency, observation, simulate
from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu.ops import lbfgs as jlbfgs
from smartcal_tpu_torch import obs, prng
from smartcal_tpu_torch.cal import solver as tsolver
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.ops import lbfgs as tlbfgs

CFG = dict(n_stations=6, n_dirs=2, n_poly=2, admm_iters=3, lbfgs_iters=5,
           init_iters=11)
TINY = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=16)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops on small batches: one intra-op thread for the module, its
    fixtures included (the suite runs six workers on the host's cores, and
    their oversubscribed thread pools slowed this file's trainers several
    times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def problem():
    """tests/test_cal_backend.py's problem: (V, C, freqs, f0, rho) as
    numpy."""
    key = jax.random.PRNGKey(42)
    N, K, Nf, T = 6, 2, 3, 6
    ob = observation.make_observation(key, n_stations=N, n_freqs=Nf,
                                      n_times=T, ra0=0.5, dec0=1.0,
                                      t0=100.0)
    mdl = simulate.simulate_models(key, K=K, Kc=6, M_weak=0, M_gauss=0,
                                   M2=4)
    uvw = np.asarray(ob.uvw).reshape(-1, 3)
    C = jnp.stack([coherency.predict_coherencies_sr(
        uvw[:, 0], uvw[:, 1], uvw[:, 2], mdl.sky_cal, f)
        for f in np.asarray(ob.freqs)])
    Jtrue = simulate.synth_solutions(
        jax.random.PRNGKey(43), K, N, 1, np.asarray(ob.freqs),
        float(ob.freqs[1]), amp=0.05)
    V = jnp.stack([jsolver.simulate_vis_sr(jnp.asarray(Jtrue[f]), C[f], N, 1)
                   for f in range(Nf)])
    Vn, _ = simulate.add_noise(jax.random.PRNGKey(2), np.asarray(V),
                               snr=0.05)
    freqs = np.asarray(ob.freqs, np.float32)
    return (np.asarray(Vn, np.float32), np.asarray(C, np.float32), freqs,
            float(freqs[1]), np.asarray(mdl.rho, np.float32))


def _torch(p):
    V, C, freqs, f0, rho = p
    return (torch.tensor(V), torch.tensor(C), torch.tensor(freqs), f0,
            torch.tensor(rho))


# -- ops/lbfgs: resume and the evaluation model -----------------------------

def _lanes_objective(seed=5, L=3):
    """JAX tests/test_lbfgs.py's ridge objective, one per lane."""
    rng = np.random.default_rng(seed)
    A = torch.from_numpy(rng.standard_normal((L, 40, 12)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((L, 40)).astype(np.float32))

    def vag(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            r = torch.einsum("lij,lj->li", A, xr) - y
            f = torch.mean(r * r, dim=-1) + 0.05 * torch.sum(xr * xr, dim=-1)
            (g,) = torch.autograd.grad(f.sum(), xr)
        return f.detach(), g
    return vag, L


def test_lbfgs_resume_walks_identical_trajectory():
    """solve(21) == solve(8) + resume(8) + resume(5) bit for bit, lane by
    lane, with the stop flags; a resume past convergence is a no-op."""
    vag, L = _lanes_objective()
    full = tlbfgs.lbfgs_solve(vag, torch.zeros(L, 12), max_iters=21)
    seg = tlbfgs.lbfgs_solve(vag, torch.zeros(L, 12), max_iters=8)
    seg = tlbfgs.lbfgs_resume(vag, seg, 8)
    seg = tlbfgs.lbfgs_resume(vag, seg, 5)
    for f in ("x", "loss", "grad", "n_iters", "stop", "diverged",
              "converged"):
        assert torch.equal(getattr(seg, f), getattr(full, f)), f
    for a, b in zip(seg.hist, full.hist):
        assert torch.equal(a, b)
    conv = tlbfgs.lbfgs_solve(vag, torch.zeros(L, 12), max_iters=200)
    assert bool(conv.stop.all())
    again = tlbfgs.lbfgs_resume(vag, conv, 10)
    assert torch.equal(again.n_iters, conv.n_iters)
    assert torch.equal(again.x, conv.x)


@pytest.mark.parametrize("m", [1, 7])
def test_history_size_matches_jax(m):
    """``LBFGSHistory.size`` is the depth m, as in the JAX package (the
    port's history carries a lane axis in front)."""
    assert tlbfgs.history_init(3, 12, history_size=m).size == \
        jlbfgs.history_init(12, history_size=m).size == m


def test_eval_model_matches_jax():
    for vm in (True, False):
        assert tlbfgs.linesearch_phi_evals(vm) == \
            jlbfgs.linesearch_phi_evals(vm)
        for n in (0, 7):
            assert tlbfgs.solve_eval_counts(n, vmapped=vm) == \
                jlbfgs.solve_eval_counts(n, vmapped=vm)
    assert tlbfgs.linesearch_phi_evals() == 50
    assert tlbfgs.solve_eval_counts(4, use_line_search=False) == \
        {"value_and_grad_evals": 5, "phi_evals": 0}


# -- cal/solver: the host-segmented route and the warm start ----------------

def test_solve_admm_host_matches_jax_and_fused(problem):
    V, C, freqs, f0, rho = _torch(problem)
    cfg = tsolver.SolverConfig(**CFG)
    host = tsolver.solve_admm_host(V, C, freqs, f0, rho, cfg, n_chunks=2,
                                   seg_iters=4)
    fused = tsolver.solve_admm(V, C, freqs, f0, rho, cfg, n_chunks=2)
    for f in ("J", "Z", "residual", "sigma_res", "sigma_data", "final_cost"):
        assert torch.equal(getattr(host, f), getattr(fused, f)), f
    jhost = jsolver.solve_admm_host(
        jnp.asarray(problem[0]), jnp.asarray(problem[1]),
        jnp.asarray(problem[2]), f0, jnp.asarray(problem[4]),
        jsolver.SolverConfig(**CFG), n_chunks=2, seg_iters=4)
    np.testing.assert_allclose(host.J.numpy(), np.asarray(jhost.J),
                               rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(host.residual.numpy(),
                               np.asarray(jhost.residual), rtol=2e-3,
                               atol=2e-3)
    np.testing.assert_allclose(float(host.sigma_res),
                               float(jhost.sigma_res), rtol=1e-3)
    np.testing.assert_allclose(float(host.sigma_data),
                               float(jhost.sigma_data), rtol=1e-5)
    # the telemetry rides on the same segments: the same result bits
    on, st = tsolver.solve_admm_host(V, C, freqs, f0, rho, cfg, n_chunks=2,
                                     seg_iters=4, collect_stats=True)
    assert torch.equal(on.J, host.J)
    # init (11 iterations -> 3 segments) + 3 outer x (5 -> 2) = 9
    assert int(st.n_segments) == 9
    assert int(st.admm_iters) == cfg.admm_iters
    assert tuple(st.primal_resid.shape) == (cfg.admm_iters,)
    assert bool((st.primal_resid > 0).all())
    assert bool((st.inner_iters > 0).all()) and int(st.init_iters) > 0
    _, fst = tsolver.solve_admm(V, C, freqs, f0, rho, cfg, n_chunks=2,
                                collect_stats=True)
    assert int(fst.n_segments) == 1
    assert torch.equal(fst.inner_iters, st.inner_iters)
    assert int(fst.init_iters) == int(st.init_iters)


def test_warm_start_matches_jax(problem):
    """``J0`` skips the init phase (JAX solver.py:522-534); the solve then
    follows JAX's from the same start."""
    V, C, freqs, f0, rho = _torch(problem)
    rng = np.random.default_rng(7)
    Nf, Ts, K, N = 3, 2, 2, 6
    eye = np.zeros((2, 2, 2), np.float32)
    eye[:, :, 0] = np.eye(2)
    J0 = (np.broadcast_to(eye, (Nf, Ts, K, N, 2, 2, 2)).reshape(
        Nf, Ts, K, 2 * N, 2, 2)
        + 0.05 * rng.standard_normal((Nf, Ts, K, 2 * N, 2, 2))).astype(
            np.float32)
    cfg = tsolver.SolverConfig(**CFG)
    tres, st = tsolver.solve_admm(V, C, freqs, f0, rho, cfg,
                                  J0=torch.from_numpy(J0),
                                  collect_stats=True)
    assert int(st.init_iters) == 0
    jres = jsolver.solve_admm(
        jnp.asarray(problem[0]), jnp.asarray(problem[1]),
        jnp.asarray(problem[2]), f0, jnp.asarray(problem[4]),
        jsolver.SolverConfig(**CFG), J0=jnp.asarray(J0))
    assert rel(tres.J.numpy(), jres.J) < 1e-3
    assert rel(tres.residual.numpy(), jres.residual) < 1e-3
    sj, s = float(jres.sigma_res), float(tres.sigma_res)
    assert abs(s - sj) <= 1e-3 * sj
    with pytest.raises(ValueError):
        tsolver.solve_admm(V, C, freqs, f0, rho, cfg,
                           J0=torch.from_numpy(J0), n_chunks=1)


def _fake(value):
    z = torch.full((2,), value)
    return tsolver.SolveResult(J=z, Z=z, residual=z, sigma_res=z[0],
                               sigma_data=z[0], final_cost=z)


def test_solve_admm_safe_ladder():
    """JAX tests/test_runtime.py's ladder cases on the port."""
    events = []
    res, info = tsolver.solve_admm_safe(
        lambda r: _fake(float("nan")), torch.ones(2),
        host_fallback=lambda r: _fake(1.0), max_retries=1,
        on_event=lambda **kw: events.append(kw))
    assert info == {"degraded": True, "attempts": 1,
                    "route": "host_segmented", "rho_scale": 1.0}
    assert [e["route"] for e in events] == ["retry_rho", "host_segmented"]
    with pytest.raises(tsolver.SolverDegradedError, match="host-segmented"):
        tsolver.solve_admm_safe(lambda r: _fake(float("nan")), torch.ones(2),
                                host_fallback=lambda r: _fake(float("nan")),
                                max_retries=1)
    res, info = tsolver.solve_admm_safe(lambda r: _fake(float("nan")),
                                        torch.ones(2),
                                        initial_result=_fake(1.0))
    assert not info["degraded"] and info["route"] == "primary"


# -- envs/radio: the route choice and the ladder on a real episode -----------

@pytest.fixture(scope="module")
def tiny():
    be = RadioBackend(device="cpu", **TINY)
    ep, _ = be.new_calib_episode(prng.PRNGKey(3), 2, 3)
    return be, ep


def _events(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def _counted(monkeypatch, calls, poison_fused=False):
    """Count the solves (both routes run ``solve_admm``); with
    ``poison_fused`` the fused route's results come out non-finite (a
    fault of that route alone)."""
    real = tsolver.solve_admm

    def solve(*a, **kw):
        calls.append(kw.get("seg_iters"))
        out = real(*a, **kw)
        if not poison_fused or kw.get("seg_iters") is not None:
            return out
        if not isinstance(out, tsolver.SolveResult):     # (result, stats)
            return out[0]._replace(J=out[0].J * float("nan")), out[1]
        return out._replace(J=out.J * float("nan"))

    monkeypatch.setattr(tsolver, "solve_admm", solve)


def _nan_episode(ep):
    """The episode with one non-finite visibility: data both routes read
    (it makes the data scale NaN, which the solve carries on as JAX's
    does, rather than raising from the consensus pinv)."""
    V = ep.V.clone()
    V[0, 0, 0, 0, 0, 0] = float("nan")
    return ep._replace(V=V)


def test_ladder_reaches_host_rung(tiny, monkeypatch, tmp_path):
    """A non-finite visibility: the fused solve, two boosted retries, the host
    rung (the same math, so as non-finite), then SolverDegradedError; each
    step logged."""
    be, ep = tiny
    monkeypatch.delenv("SMARTCAL_HOST_SOLVER", raising=False)
    monkeypatch.delenv("SMARTCAL_ROBUST_SOLVER", raising=False)
    calls = []
    _counted(monkeypatch, calls)
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path, flush_lines=1):
        with pytest.raises(tsolver.SolverDegradedError,
                           match="host-segmented"):
            be.calibrate(_nan_episode(ep), np.ones(3, np.float32))
    assert calls == [None] * (1 + be.solver_max_retries) + [8]
    deg = [e for e in _events(path) if e["event"] == "solver_degraded"]
    assert [e["route"] for e in deg] == ["retry_rho"] * 2 + ["host_segmented"]
    assert all(e["primary_route"] == "fused" for e in deg)


def test_ladder_host_rung_rescues_fused_fault(tiny, monkeypatch, tmp_path):
    """A fault of the fused route alone: the host rung's finite result is
    returned and tagged with its route."""
    be, ep = tiny
    monkeypatch.delenv("SMARTCAL_HOST_SOLVER", raising=False)
    monkeypatch.delenv("SMARTCAL_ROBUST_SOLVER", raising=False)
    calls = []
    _counted(monkeypatch, calls, poison_fused=True)
    path = str(tmp_path / "run.jsonl")
    rho = np.ones(3, np.float32)
    with obs.recording(path, flush_lines=1):
        res = be.calibrate(ep, rho)
    assert tsolver.result_finite(res)
    assert calls == [None] * (1 + be.solver_max_retries) + [8]
    ev = _events(path)
    deg = [e for e in ev if e["event"] == "solver_degraded"]
    assert [e["route"] for e in deg] == ["retry_rho"] * 2 + ["host_segmented"]
    solver_ev = [e for e in ev if e["event"] == "solver"]
    assert [e["route"] for e in solver_ev] == ["host_segmented"]
    span = [e for e in ev if e["event"] == "span" and e["name"] == "solve"]
    assert span[0]["final_route"] == "host_segmented"
    monkeypatch.undo()
    want = tsolver.solve_admm_host(ep.V, ep.Ccal, ep.obs.freqs, ep.f0,
                                   torch.from_numpy(rho),
                                   be._solver_cfg(3), n_chunks=be.n_chunks)
    assert torch.equal(res.J, want.J)


def test_host_solver_override(tiny, monkeypatch, tmp_path):
    be, ep = tiny
    rho = np.full(3, 2.0, np.float32)
    cfg = be._solver_cfg(3)
    args = (ep.V, ep.Ccal, ep.obs.freqs, ep.f0, torch.from_numpy(rho), cfg)
    fused = tsolver.solve_admm(*args, n_chunks=be.n_chunks)
    # the JAX backend would segment this solve (its watchdog threshold);
    # the port has no fused program to guard, so only the override does
    big = RadioBackend(device="cpu", n_stations=62)
    assert big._fused_work() > 1e7
    monkeypatch.delenv("SMARTCAL_HOST_SOLVER", raising=False)
    assert not big._use_host_solver()
    routes = {}
    for v in ("1", "0"):
        monkeypatch.setenv("SMARTCAL_HOST_SOLVER", v)
        assert be._use_host_solver() == (v == "1")
        path = str(tmp_path / f"run{v}.jsonl")
        with obs.recording(path, flush_lines=1):
            res = be.calibrate(ep, rho)
        routes[v] = [e["route"] for e in _events(path)
                     if e["event"] == "solver"]
        assert torch.equal(res.J, fused.J)     # the same bits either way
    assert routes == {"1": ["host_segmented"], "0": ["fused"]}
    seg = [e["n_segments"] for e in _events(str(tmp_path / "run1.jsonl"))
           if e["event"] == "solver"]
    # init 5 -> 1 segment of 8, then 2 outer x (3 -> 1)
    assert seg == [3]


def test_robust_solver_override(tiny, monkeypatch):
    be, ep = tiny
    ep = _nan_episode(ep)
    rho = np.ones(3, np.float32)
    calls = []
    _counted(monkeypatch, calls)
    monkeypatch.delenv("SMARTCAL_HOST_SOLVER", raising=False)
    monkeypatch.setenv("SMARTCAL_ROBUST_SOLVER", "0")
    res = be.calibrate(ep, rho)            # the ladder is off: as it came
    assert not tsolver.result_finite(res) and len(calls) == 1
    off = RadioBackend(device="cpu", robust_solver=False,
                       solver_max_retries=1, **TINY)
    monkeypatch.setenv("SMARTCAL_ROBUST_SOLVER", "1")
    calls.clear()
    with pytest.raises(tsolver.SolverDegradedError):
        off.calibrate(ep, rho)
    assert calls == [None, None, 8]        # fused, one retry, host rung
    monkeypatch.delenv("SMARTCAL_ROBUST_SOLVER")
    calls.clear()
    assert not tsolver.result_finite(off.calibrate(ep, rho))
    assert len(calls) == 1
