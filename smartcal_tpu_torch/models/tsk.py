"""Takagi-Sugeno-Kang (TSK) order-1 fuzzy regressor (counterpart of
smartcal_tpu/models/tsk.py; reference: the pytsk model of
``demixing_rl/train_tsk.py``): Gaussian-membership antecedents,
``n_rule`` rules, order-1 consequents, a tanh output head, and the two
regularizers, the inverse-center-distance loss (train_tsk.py:81-98) and
the sigma-magnitude loss (:100-110).

Model: for input x (M,), rule firing uses log-Gaussian memberships
  z_r = sum_m -(x_m - c_{m,r})^2 / (2 sigma_{m,r}^2)
  w = softmax(z)                         (normalized firing strengths)
  y = tanh( sum_r w_r (A_r x + b_r) )    (order-1 consequents)

Training is Adam (``rl.sac.adam_update``, optax's step) on minibatches
drawn without replacement from the caller's ``torch.Generator``.
"""

import pickle
from typing import NamedTuple

import numpy as np
import torch

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.rl.sac import adam_init, adam_update


class TSKParams(NamedTuple):
    center: torch.Tensor   # (M, R)
    sigma: torch.Tensor    # (M, R)
    A: torch.Tensor        # (R, M, out)
    b: torch.Tensor        # (R, out)


def tsk_init(generator, n_inputs, n_outputs, n_rule=3, x_sample=None,
             device="cpu") -> TSKParams:
    """Centers from ``n_rule`` distinct data samples when given (pytsk
    runs k-means over the training inputs; random draws are the cheap
    equivalent), else normal draws; consequents 0.01 x normal.  Draws from
    ``generator`` (on ``device``)."""
    dev = torch.device(device)
    if x_sample is not None and x_sample.shape[0] >= n_rule:
        idx = torch.randperm(x_sample.shape[0], generator=generator,
                             device=dev)[:n_rule]
        center = torch.as_tensor(np.asarray(x_sample, np.float32),
                                 device=dev)[idx].T.contiguous()
    else:
        center = torch.randn((n_inputs, n_rule), generator=generator,
                             device=dev)
    sigma = torch.ones((n_inputs, n_rule), device=dev)
    A = 0.01 * torch.randn((n_rule, n_inputs, n_outputs),
                           generator=generator, device=dev)
    b = 0.01 * torch.randn((n_rule, n_outputs), generator=generator,
                           device=dev)
    return TSKParams(center=center, sigma=sigma, A=A, b=b)


def tsk_forward(params: TSKParams, x):
    """x (..., M) -> (..., out)."""
    d = x[..., :, None] - params.center                  # (..., M, R)
    z = -0.5 * torch.sum((d / (params.sigma + 1e-8)) ** 2, dim=-2)
    w = torch.softmax(z, dim=-1)                         # (..., R)
    rule_out = torch.einsum("...m,rmo->...ro", x, params.A) + params.b
    return torch.tanh(torch.einsum("...r,...ro->...o", w, rule_out))


def center_difference_loss(params: TSKParams):
    """Inverse pairwise center distance (train_tsk.py:81-98)."""
    c = params.center                                    # (M, R)
    M, R = c.shape
    d2 = (c[:, :, None] - c[:, None, :]) ** 2            # (M, R, R)
    iu = np.triu_indices(R, 1)
    inv = torch.sum(1.0 / (d2[:, iu[0], iu[1]] + 1e-5))
    return inv / (M * R * (R - 1) / 2)


def sigma_loss(params: TSKParams):
    """Mean sigma^2 (train_tsk.py:100-110)."""
    return torch.mean(params.sigma ** 2)


def tsk_loss(params: TSKParams, x, y, g1=1e-4, g2=1e-4):
    """||y - f(x)||^2 / batch + g1*center_diff + g2*sigma
    (train_tsk.py:136-147)."""
    pred = tsk_forward(params, x)
    mse = torch.sum((pred - y) ** 2) / x.shape[0]
    return mse + g1 * center_difference_loss(params) + g2 * sigma_loss(params)


def tsk_adam_step(params: TSKParams, opt, x, y, lr, g1=1e-4, g2=1e-4):
    """One Adam step of :func:`tsk_loss` on the batch (x, y), in place on
    ``params``' tensors; returns the pre-step loss."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    loss = tsk_loss(TSKParams(*leaves), x, y, g1, g2)
    grads = torch.autograd.grad(loss, leaves)
    adam_update(opt, dict(zip(TSKParams._fields, params)), grads, lr)
    return loss.detach()


def train_tsk(generator, x_train, y_train, n_rule=3, n_iter=2000,
              batch_size=256, lr=1e-3, g1=1e-4, g2=1e-4, x_test=None,
              y_test=None, log_every=0, device="cuda"):
    """Adam training loop (train_tsk.py:112-158) on ``device``; the init
    and the minibatch draws (without replacement) come from ``generator``,
    a ``torch.Generator`` on ``device``."""
    dev = resolve_device(device)
    x_train = torch.as_tensor(np.asarray(x_train, np.float32), device=dev)
    y_train = torch.as_tensor(np.asarray(y_train, np.float32), device=dev)
    params = tsk_init(generator, x_train.shape[1], y_train.shape[1], n_rule,
                      x_sample=x_train, device=dev)
    opt = adam_init(dict(zip(TSKParams._fields, params)))
    bs = min(batch_size, x_train.shape[0])
    losses = []
    for _ in range(n_iter):
        idx = torch.randperm(x_train.shape[0], generator=generator,
                             device=dev)[:bs]
        losses.append(tsk_adam_step(params, opt, x_train[idx], y_train[idx],
                                    lr, g1, g2))
    out = {"params": params,
           "losses": torch.stack(losses).cpu().numpy() if losses
           else np.zeros(0, np.float32)}
    if x_test is not None:
        with torch.no_grad():
            pred = tsk_forward(params, torch.as_tensor(
                np.asarray(x_test, np.float32), device=dev))
            out["test_mse"] = float(torch.mean(torch.sum(
                (pred - torch.as_tensor(np.asarray(y_test, np.float32),
                                        device=dev)) ** 2, dim=-1)))
    return out


def save_tsk(params: TSKParams, path="tsk.model.pkl"):
    """Pickle of the parameters as numpy arrays (the JAX package's
    layout: a TSKParams of host arrays)."""
    with open(path, "wb") as fh:
        pickle.dump(TSKParams(*(p.detach().cpu().numpy() for p in params)),
                    fh)


def load_tsk(path="tsk.model.pkl", device="cpu") -> TSKParams:
    from smartcal_tpu_torch.runtime.atomic import strict_pickle_load

    return TSKParams(*(torch.as_tensor(np.asarray(p), device=device)
                       for p in strict_pickle_load(path)))
