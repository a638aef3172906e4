"""Consensus-ADMM solver of the PyTorch port vs the JAX package.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the cost and its gradient are f32 sums over a few hundred
terms (rtol 1e-5 on values, 1e-4 relative-norm on gradients); the batched
L-BFGS must follow JAX's vmapped trajectory on a convex quadratic to 1e-4;
the full solve at the tiny tier holds J and the residual to 1e-3
relative-norm and sigma_res inside the 1e-3 band the JAX solver tests
hold (smartcal_tpu/cal/precision.py:31-35).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu.ops import lbfgs as jlbfgs
from smartcal_tpu_torch.cal import solver as tsolver
from smartcal_tpu_torch.cal.kernels import baseline_onehots
from smartcal_tpu_torch.ops import lbfgs as tlbfgs

N, K, TC = 5, 2, 3
B = N * (N - 1) // 2


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _operands(seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    cfg = jsolver.SolverConfig(n_stations=N, n_dirs=K)
    n = K * 2 * N * 4
    x = (np.tile(np.eye(2)[None, None].repeat(N, 1).reshape(1, 2 * N, 2)
                 [..., None] * [1, 0], (K, 1, 1, 1)).reshape(-1)
         + 0.1 * rng.standard_normal(n)).astype(f32)
    d = (0.05 * rng.standard_normal(n)).astype(f32)
    Vp = rng.standard_normal((2, 2, 2, TC, B)).astype(f32)
    Cp = rng.standard_normal((K, 2, 2, 2, TC, B)).astype(f32)
    prior = rng.standard_normal((K, 2 * N, 2, 2)).astype(f32)
    half_rho = np.asarray([0.3, 1.7], f32)
    return cfg, x, d, Vp, Cp, prior, half_rho


def _torch_cfg(cfg):
    return tsolver.SolverConfig(*cfg)


@pytest.mark.parametrize("seed", [0, 1])
def test_cost_value_and_gradient_match(seed):
    cfg, x, _, Vp, Cp, prior, half_rho = _operands(seed)
    oh = jsolver._baseline_onehots(N)
    jv, jg = jax.value_and_grad(lambda q: jsolver._cost_fn_onehot(
        q, Vp, Cp, oh, prior, half_rho, cfg))(jnp.asarray(x))
    toh = baseline_onehots(N)
    t = torch.from_numpy

    def cost(q):
        return tsolver._cost_fn_onehot(q, t(Vp)[None], t(Cp)[None], toh,
                                       t(prior)[None], t(half_rho),
                                       _torch_cfg(cfg))

    tv, tg = tsolver.lane_value_and_grad(cost)(t(x)[None])
    np.testing.assert_allclose(tv.numpy()[0], float(jv), rtol=1e-5)
    assert rel(tg.numpy()[0], jg) < 1e-4


@pytest.mark.parametrize("seed", [0, 3])
def test_quartic_line_search_polynomial_matches(seed):
    cfg, x, d, Vp, Cp, prior, half_rho = _operands(seed)
    phi = jsolver._quartic_phi_maker(Vp, Cp, jsolver._baseline_onehots(N),
                                     prior, half_rho, cfg)(None, x, d)
    t = torch.from_numpy
    coeffs = tsolver._quartic_coeffs(t(x)[None], t(d)[None], t(Vp)[None],
                                     t(Cp)[None], baseline_onehots(N),
                                     t(prior)[None], t(half_rho),
                                     _torch_cfg(cfg))
    tphi = tsolver._quartic_phi(coeffs)
    for a in (0.0, 0.3, 1.0, 2.5):
        jv, jd = phi(a)
        tv, td = tphi(torch.tensor([a], dtype=torch.float32))
        np.testing.assert_allclose(float(tv[0]), float(jv), rtol=1e-5)
        np.testing.assert_allclose(float(td[0]), float(jd), rtol=1e-4,
                                   atol=1e-4 * abs(float(jv)))


def test_batched_lbfgs_follows_vmapped_jax():
    """Lanes of different conditioning stop at different iterations; the
    batched solve must freeze each stopped lane as JAX's vmapped
    while_loop does."""
    rng = np.random.default_rng(0)
    L, n = 3, 12
    A = np.stack([(lambda m: m @ m.T + s * np.eye(n))(rng.standard_normal(
        (n, n))) for s in (1.0, 5.0, 50.0)]).astype(np.float32)
    b = rng.standard_normal((L, n)).astype(np.float32)

    def jsolve(a, bb):
        return jlbfgs.lbfgs_solve(lambda q: 0.5 * q @ a @ q - bb @ q,
                                  jnp.zeros(n), max_iters=12)

    jres = jax.vmap(jsolve)(jnp.asarray(A), jnp.asarray(b))
    tA, tb = torch.from_numpy(A), torch.from_numpy(b)

    def vag(q):
        g = torch.einsum("lij,lj->li", tA, q) - tb
        return torch.sum(0.5 * q * (g - tb), dim=-1), g

    tres = tlbfgs.lbfgs_solve(vag, torch.zeros((L, n)), max_iters=12)
    np.testing.assert_array_equal(tres.n_iters.numpy(),
                                  np.asarray(jres.n_iters))
    assert rel(tres.x.numpy(), jres.x) < 1e-4
    assert len(set(tres.n_iters.tolist())) > 1     # lanes stopped apart


@pytest.fixture(scope="module")
def tiny_problem():
    from smartcal_tpu.envs.radio import RadioBackend

    be = RadioBackend(n_stations=6, n_freqs=2, n_times=4, tdelta=2,
                      admm_iters=2, lbfgs_iters=3, init_iters=5, npix=32,
                      shard=False)
    ep, mdl = be.new_calib_episode(jax.random.PRNGKey(11), 3, 3)
    rho = np.asarray(mdl.rho, np.float32)
    cfg = be._solver_cfg(3)
    res = jsolver.solve_admm(ep.V, ep.Ccal, ep.obs.freqs, ep.f0,
                             jnp.asarray(rho), cfg, n_chunks=be.n_chunks)
    return ep, rho, cfg, be.n_chunks, res


def test_solve_admm_tiny_tier_matches(tiny_problem):
    ep, rho, cfg, n_chunks, jres = tiny_problem
    t = lambda a: torch.from_numpy(np.array(a))
    tres = tsolver.solve_admm(t(ep.V), t(ep.Ccal), t(ep.obs.freqs), ep.f0,
                              t(rho), _torch_cfg(cfg), n_chunks=n_chunks)
    assert rel(tres.J.numpy(), jres.J) < 1e-3
    assert rel(tres.residual.numpy(), jres.residual) < 1e-3
    sj, st = float(jres.sigma_res), float(tres.sigma_res)
    assert abs(st - sj) <= 1e-3 * sj
    np.testing.assert_allclose(float(tres.sigma_data),
                               float(jres.sigma_data), rtol=1e-5)
    assert st < float(tres.sigma_data)


def _result(value):
    z = torch.full((1,), value)
    return tsolver.SolveResult(J=z, Z=z, residual=z, sigma_res=z[0],
                               sigma_data=z[0], final_cost=z)


def test_solve_admm_safe_retries_with_boosted_rho():
    calls = []

    def solve(r):
        calls.append(float(r[0]))
        return _result(float("nan") if len(calls) < 2 else 1.0)

    res, info = tsolver.solve_admm_safe(solve, torch.ones(2), rho_boost=10.0)
    assert calls == [1.0, 10.0] and info["attempts"] == 1
    assert tsolver.result_finite(res)
    with pytest.raises(tsolver.SolverDegradedError):
        tsolver.solve_admm_safe(lambda r: _result(float("nan")),
                                torch.ones(2), max_retries=1)


def test_line_search_skips_only_discarded_work(monkeypatch):
    """The strong-Wolfe search gives the same steps, bit for bit, with its
    host-side skips (zooms no live lane needs, finished trips) and without
    them (as under CUDA graph capture), on lanes that take every branch."""
    from smartcal_tpu_torch.ops import lbfgs as tl
    rng = np.random.default_rng(3)
    L, n = 64, 6
    H = rng.standard_normal((L, n, n)).astype(np.float32)
    H = torch.from_numpy(H @ H.transpose(0, 2, 1) + 0.1 * np.eye(n,
                                                                dtype=np.float32))
    x = torch.from_numpy(rng.standard_normal((L, n)).astype(np.float32))
    # steepest-descent directions of assorted lengths: steps of 10, 1 and
    # 0.01 are each right for some lane
    g = torch.einsum("lij,lj->li", H, x)
    d = -g * torch.from_numpy(10.0 ** rng.uniform(-2, 1, (L, 1)).astype(
        np.float32))

    def phi(alpha):
        z = x + alpha[:, None] * d
        hz = torch.einsum("lij,lj->li", H, z)
        return (0.5 * torch.sum(z * hz, -1) + torch.sum(torch.abs(z), -1),
                torch.sum((hz + torch.sign(z)) * d, -1))

    def lane_alone(lane):
        return tl.strong_wolfe_cubic(lambda a: tuple(
            v[lane:lane + 1] for v in phi(a.expand(L))), 1)

    got = tl.strong_wolfe_cubic(phi, L)
    alone = [lane_alone(lane) for lane in range(4)]
    monkeypatch.setattr(tl, "_can_sync", lambda device: False)
    want = tl.strong_wolfe_cubic(phi, L)
    assert torch.equal(got, want)
    assert len(set(np.round(want.numpy(), 3).tolist())) > 4
    for lane in range(4):                  # one lane alone, with skips
        assert torch.equal(alone[lane], want[lane:lane + 1])
