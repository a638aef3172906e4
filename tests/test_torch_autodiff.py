"""The port's autodiff module (``ops/autodiff.py``, on ``torch.func``) and
``ops/lbfgs.inv_hessian_mult`` against the JAX package's, on the fixtures
of tests/test_autodiff.py.

Gradients, Jacobians and Hessian-vector products are held at rtol 1e-5 /
atol 1e-6 (float32 autodiff of the same expressions); the Taylor inverse
HVP (10 normalised steps) and the influence matrices at rtol 1e-4 /
atol 1e-6; ``inv_hessian_mult`` at rtol 1e-5 / atol 1e-6 (a few float32
ulps of its O(1) outputs) on a JAX ``LBFGSHistory`` with no pair, a
partial ring and a full ring.  The flat
parameter order is held exactly: a network's ``loss_hvp`` on the port's
named tensors matches flax's ``ravel_pytree`` order element for element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import func

from smartcal_tpu.ops import autodiff as jad
from smartcal_tpu.ops import lbfgs as jl
from smartcal_tpu.rl import networks as jn
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.ops import autodiff as tad
from smartcal_tpu_torch.ops import lbfgs as tl
from smartcal_tpu_torch.rl import networks as tn

RTOL, ATOL = 1e-5, 1e-6


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_gradient_and_jacobian():
    A = np.arange(12.0, dtype=np.float32).reshape(3, 4)
    x = np.linspace(-1, 1, 4).astype(np.float32)
    close(tad.gradient(lambda z: t(A) @ z, t(x)),
          jad.gradient(lambda z: jnp.asarray(A) @ z, jnp.asarray(x)))
    w = np.array([1.0, -2.0, 0.5], np.float32)
    close(tad.gradient(lambda z: torch.sin(t(A) @ z), t(x), t(w)),
          jad.gradient(lambda z: jnp.sin(jnp.asarray(A) @ z),
                       jnp.asarray(x), jnp.asarray(w)))
    close(tad.jacobian(lambda z: torch.tanh(t(A) @ z), t(x)),
          jad.jacobian(lambda z: jnp.tanh(jnp.asarray(A) @ z),
                       jnp.asarray(x)))


def test_hessian_vec_prod_quadratic():
    rng = np.random.default_rng(0)
    H = rng.normal(size=(5, 5))
    H = (H + H.T).astype(np.float32)
    v = rng.normal(size=5).astype(np.float32)
    x = rng.normal(size=5).astype(np.float32)
    got = tad.hessian_vec_prod(lambda z: 0.5 * z @ (t(H) @ z) + torch.sum(
        z ** 4), t(x), t(v))
    want = jad.hessian_vec_prod(lambda z: 0.5 * z @ (jnp.asarray(H) @ z)
                                + jnp.sum(z ** 4), jnp.asarray(x),
                                jnp.asarray(v))
    close(got, want)


def test_loss_hvp_pytree_order():
    """ravel_pytree sorts dict keys: flat order (b, w0, w1, w2), Hessian
    diag(2, 4, 4, 4)."""
    v = np.array([1.0, 2.0, 3.0, 4.0], np.float32)
    got = tad.loss_hvp(lambda p: torch.sum(p["w"] ** 2) * 2.0 + p["b"] ** 2,
                       {"w": torch.ones(3), "b": torch.zeros(())}, t(v))
    want = jad.loss_hvp(lambda p: jnp.sum(p["w"] ** 2) * 2.0 + p["b"] ** 2,
                        {"w": jnp.ones((3,)), "b": jnp.zeros(())},
                        jnp.asarray(v))
    close(got, [2.0, 8.0, 12.0, 16.0])
    close(got, want)


def test_network_flat_order_matches_ravel_pytree():
    """A network's named tensors flatten in flax's order and layout: the
    flat vectors agree element for element, and a loss_hvp along one flat
    v agrees."""
    hidden = (3, 2)
    fa = jn.MLPDeterministicActor(2, hidden=hidden)
    ta = tn.MLPDeterministicActor(5, 2, hidden=hidden)
    x = np.random.default_rng(1).standard_normal((4, 5)).astype(np.float32)
    params = fa.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    named = {k: v.requires_grad_(False) for k, v in
             interop.params_from_flax(params, ta).items()}
    flat_j, _ = jax.flatten_util.ravel_pytree(params)
    flat_t, unravel = tad.ravel_params(named)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = unravel(flat_t)
    for k, v in named.items():
        np.testing.assert_array_equal(back[k].numpy(), v.numpy(), k)
    v = np.random.default_rng(2).standard_normal(flat_t.numel()).astype(
        np.float32)
    got = tad.loss_hvp(lambda p: torch.sum(func.functional_call(
        ta, p, (t(x),)) ** 2), named, t(v))
    want = jad.loss_hvp(lambda p: jnp.sum(fa.apply({"params": p}, x) ** 2),
                        params, jnp.asarray(v))
    close(got, want, rtol=1e-4, atol=1e-6)


def test_taylor_inverse_hvp():
    rng = np.random.default_rng(2)
    L = rng.normal(size=(4, 4))
    H = (L @ L.T / 8 + 0.5 * np.eye(4)).astype(np.float32)
    v = rng.normal(size=4).astype(np.float32)
    got = tad.inverse_hessian_vec_prod(lambda z: 0.5 * z @ (t(H) @ z),
                                       torch.zeros(4), t(v), maxiter=10)
    want = jad.inverse_hessian_vec_prod(
        lambda z: 0.5 * z @ (jnp.asarray(H) @ z), jnp.zeros(4),
        jnp.asarray(v), maxiter=10)
    close(got, want, rtol=1e-4)


def test_cross_derivative():
    theta = np.array([1.0, 2.0], np.float32)
    x = np.array([3.0, 4.0], np.float32)
    got = tad.cross_derivative(lambda p, xx: torch.sum((xx * p) ** 2),
                               t(theta), t(x))
    want = jad.cross_derivative(lambda p, xx: jnp.sum((xx * p) ** 2),
                                jnp.asarray(theta), jnp.asarray(x))
    close(got, want)
    close(got, np.diag(4.0 * x * theta))
    pd = {"a": theta, "b": theta[:1] * 3}
    got = tad.cross_derivative(
        lambda p, xx: torch.sum((xx * p["a"]) ** 2 * p["b"]),
        {k: t(v) for k, v in pd.items()}, t(x))
    want = jad.cross_derivative(
        lambda p, xx: jnp.sum((xx * p["a"]) ** 2 * p["b"]),
        {k: jnp.asarray(v) for k, v in pd.items()}, jnp.asarray(x))
    close(got, want)


def _lane_hist(h):
    """A JAX ``LBFGSHistory`` as the port's one-lane history."""
    return tl.LBFGSHistory(s=t(h.s)[None], y=t(h.y)[None],
                           count=t(h.count).reshape(1),
                           gamma=t(h.gamma).reshape(1))


@pytest.mark.parametrize("pairs", [0, 3, 9])     # none, partial, full ring
def test_inv_hessian_mult_on_jax_history(pairs):
    rng = np.random.default_rng(pairs)
    n, m, k = 6, 7, 4
    h = jl.history_init(n, m)
    for _ in range(pairs):
        s = rng.standard_normal(n).astype(np.float32)
        y = s + 0.3 * rng.standard_normal(n).astype(np.float32)
        h = jl.history_push(h, jnp.asarray(s), jnp.asarray(y), True)
    q = rng.standard_normal(n).astype(np.float32)
    Q = rng.standard_normal((n, k)).astype(np.float32)
    th = _lane_hist(h)
    close(tl.inv_hessian_mult(th, t(q)[None])[0],
          jl.inv_hessian_mult(h, jnp.asarray(q)))
    close(tl.inv_hessian_mult(th, t(Q)[None])[0],
          jax.vmap(lambda c: jl.inv_hessian_mult(h, c), in_axes=1,
                   out_axes=1)(jnp.asarray(Q)))
    if pairs == 0:
        np.testing.assert_array_equal(
            tl.inv_hessian_mult(th, t(Q)[None])[0].numpy(), Q)


def _linear_case(seed, n=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, n)).astype(np.float32)
    theta0 = rng.normal(size=n).astype(np.float32)
    y = (X @ theta0 + 0.1 * rng.normal(size=n)).astype(np.float32)
    return X, theta0, y


def test_influence_matrix_lbfgs_history():
    """Held on JAX's solve: the same x and curvature history go into both
    packages' influence_matrix."""
    X, theta0, y = _linear_case(4)
    x_in = np.ones(3, np.float32)

    def train_loss(p):
        return jnp.mean((jnp.asarray(X) @ (p * x_in) - jnp.asarray(y)) ** 2)

    res = jl.lbfgs_solve(train_loss, jnp.asarray(theta0), max_iters=60)
    want = jad.influence_matrix(lambda p, xx: jnp.asarray(X) @ (p * xx),
                                res.x, jnp.asarray(x_in), jnp.asarray(y),
                                hist=res.hist)
    got = tad.influence_matrix(lambda p, xx: t(X) @ (p * xx), t(res.x),
                               t(x_in), t(y), hist=_lane_hist(res.hist))
    close(got, want, rtol=1e-4)


def test_influence_matrix_taylor_path():
    rng = np.random.default_rng(6)
    X = rng.normal(size=(4, 4)).astype(np.float32)
    params = rng.normal(size=4).astype(np.float32)
    got = tad.influence_matrix(lambda p, xx: t(X) @ (p * xx), t(params),
                               torch.ones(4), torch.zeros(4),
                               taylor_iters=5)
    want = jad.influence_matrix(lambda p, xx: jnp.asarray(X) @ (p * xx),
                                jnp.asarray(params), jnp.ones(4),
                                jnp.zeros(4), hist=None, taylor_iters=5)
    assert got.shape == (4, 4)
    close(got, want, rtol=1e-4)


def test_lane_value_and_grad_is_per_lane():
    x = torch.tensor([[1.0, -2.0], [0.5, 3.0]])
    val, g = tad.lane_value_and_grad(lambda z: torch.sum(z ** 3, -1))(x)
    np.testing.assert_allclose(val.numpy(), [-7.0, 27.125])
    np.testing.assert_allclose(g.numpy(), 3 * x.numpy() ** 2)
