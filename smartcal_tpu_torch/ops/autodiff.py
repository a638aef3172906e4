"""Jacobian / Hessian / influence-function machinery on ``torch.func``
(counterpart of smartcal_tpu/ops/autodiff.py).

* :func:`gradient` is a VJP, :func:`jacobian` one ``jacrev``;
* :func:`hessian_vec_prod` is Pearlmutter's product as ``jvp`` of ``grad``;
* :func:`inverse_hessian_vec_prod` is the Koh & Liang Taylor recursion with
  per-step normalisation, a plain loop of ``maxiter``;
* :func:`cross_derivative` and :func:`influence_matrix` take the mixed
  second derivative d(dL/dtheta)/dx as ``jacfwd`` of ``grad``, push it
  through the inverse Hessian (the L-BFGS pairs, or the Taylor recursion)
  and contract it with the model Jacobian;
* :func:`lane_value_and_grad` is the per-lane ``value_and_grad`` the
  lane-batched L-BFGS solver takes.

Flat parameter order.  The JAX functions flatten a parameter pytree with
``ravel_pytree``: dict keys sorted at every level, arrays raveled row-major
in flax's layout.  :func:`ravel_params` flattens the port's dict of named
tensors in the same order, so a flat ``v`` or a (P, N) cross derivative
means the same thing in both packages.  A dotted name is a path of
``rl.networks`` (``interop.params_from_flax``'s convention): ``a.b.weight``
is flax's ``['a']['b']['kernel']`` (or ``['scale']`` of a norm), which
sorts after ``bias`` as ``weight`` does, and a 2-D or 4-D ``weight`` is
raveled in flax's kernel layout, (in, out) or HWIO.
"""

import math
from typing import Callable, Optional

import torch
from torch import func

from smartcal_tpu_torch.ops.lbfgs import (LBFGSHistory,  # noqa: F401
                                          inv_hessian_mult)


def _flax_layout(name: str, t):
    """A tensor of a dotted parameter path in flax's layout."""
    if name.split(".")[-1] == "weight":
        if t.dim() == 2:
            return t.T
        if t.dim() == 4:
            return t.permute(2, 3, 1, 0)
    return t


def _torch_layout(name: str, t, shape):
    """Inverse of :func:`_flax_layout`: flax-layout values to ``shape``."""
    if name.split(".")[-1] == "weight":
        if len(shape) == 2:
            return t.reshape(shape[1], shape[0]).T
        if len(shape) == 4:
            return t.reshape(shape[2], shape[3], shape[1],
                             shape[0]).permute(3, 2, 0, 1)
    return t.reshape(shape)


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def ravel_params(params):
    """``(flat, unravel)`` of a tensor or a (nested) dict of tensors, in
    ``jax.flatten_util.ravel_pytree``'s order (see the module docstring);
    ``unravel(flat)`` rebuilds the dict, differentiably."""
    if isinstance(params, torch.Tensor):
        shape = params.shape
        return params.reshape(-1), lambda f: f.reshape(shape)
    leaves = sorted(_leaves(params),
                    key=lambda kv: kv[0][:-1] + tuple(kv[0][-1].split(".")))
    names = [".".join(p) for p, _ in leaves]
    shapes = [v.shape for _, v in leaves]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.cat([_flax_layout(n, v).reshape(-1)
                      for n, (_, v) in zip(names, leaves)])

    def unravel(f):
        out = {}
        for (path, _), n, shape, part in zip(leaves, names, shapes,
                                             torch.split(f, sizes)):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _torch_layout(n, part, shape)
        return out

    return flat, unravel


def gradient(f: Callable, x, grad_outputs=None):
    """VJP ``(dy/dx)^T @ grad_outputs`` (reference ``gradient``, ``:13-18``);
    ``grad_outputs`` defaults to ones."""
    y, vjp = func.vjp(f, x)
    if grad_outputs is None:
        grad_outputs = torch.ones_like(y)
    return vjp(grad_outputs)[0]


def jacobian(f: Callable, x):
    """Dense Jacobian dy/dx, shape ``(y.size, *x.shape)``."""
    return func.jacrev(lambda z: f(z).reshape(-1))(x)


def hessian_vec_prod(f: Callable, x, v):
    """Pearlmutter Hessian-vector product ``H(x) v`` of a scalar ``f``:
    ``jvp`` of ``grad``, no Hessian materialised."""
    return func.jvp(func.grad(f), (x,), (v,))[1]


def loss_hvp(loss_fn: Callable, params, v):
    """HVP with respect to a parameter dict; ``v`` and the result are flat
    in :func:`ravel_params` order."""
    flat, unravel = ravel_params(params)
    return hessian_vec_prod(lambda p: loss_fn(unravel(p)), flat, v)


def inverse_hessian_vec_prod(f: Callable, x, v, maxiter: int = 10):
    """Taylor-series inverse HVP (Koh & Liang 2017, sec. 3):
    ``x_{j+1} = v + x_j - H x_j``, normalised every step, as the reference
    recursion (``autograd_tools.py:183-194``)."""
    xcur = v / torch.linalg.norm(v)
    for _ in range(maxiter):
        xnew = v + xcur - hessian_vec_prod(f, x, xcur)
        xcur = xnew / torch.linalg.norm(xnew)
    return xcur


def cross_derivative(loss_fn: Callable, params, x):
    """Mixed second derivative ``d/dx [dL/dtheta]`` as a ``(P, N)`` matrix
    (P flat parameters in :func:`ravel_params` order, N = x.numel());
    ``loss_fn(params, x)`` is scalar."""
    flat, unravel = ravel_params(params)

    def grad_wrt_params(x_flat):
        xs = x_flat.reshape(x.shape)
        return func.grad(lambda p: loss_fn(unravel(p), xs))(flat)

    return func.jacfwd(grad_wrt_params)(x.reshape(-1))


def influence_matrix(model_fn: Callable, params, x, labels,
                     hist: Optional[LBFGSHistory] = None,
                     taylor_iters: int = 10):
    """Influence function of a model, shape ``(M_out, N_in)``:
    ``If[j, i] = (d model_j / d theta) . H^{-1} . (d^2 L / d x_i d theta)``
    with ``L`` the MSE of ``model_fn(params, x)`` against ``labels``.  The
    inverse Hessian is the L-BFGS one of ``hist`` (one lane) when given,
    else the Taylor recursion of ``taylor_iters`` steps."""
    flat, unravel = ravel_params(params)
    y_flat = labels.reshape(-1)

    def loss_fn(p, xx):
        pred = model_fn(p, xx).reshape(-1)
        return torch.mean((pred - y_flat) ** 2)

    cross = cross_derivative(loss_fn, params, x)                # (P, N)
    if hist is not None:
        ihvp = inv_hessian_mult(hist, cross[None])[0]
    else:
        def f_params(p_flat):
            return loss_fn(unravel(p_flat), x)

        ihvp = func.vmap(
            lambda col: inverse_hessian_vec_prod(f_params, flat, col,
                                                 maxiter=taylor_iters),
            in_dims=1, out_dims=1)(cross)
    jac = func.jacrev(lambda p: model_fn(unravel(p), x).reshape(-1))(flat)
    return jac @ ihvp


def lane_value_and_grad(cost: Callable) -> Callable:
    """(L, n) -> ((L,) values, (L, n) gradients) of a per-lane ``cost``.
    Lanes are independent, so the gradient of the lane sum is exact per
    lane; one backward pass serves every lane."""
    def vag(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            val = cost(xr)
            (g,) = torch.autograd.grad(val.sum(), xr)
        return val.detach(), g
    return vag
