"""Influence functions OF the trained aux models (counterpart of
smartcal_tpu/train/model_influence.py): how sensitive a model's output is
to each input coordinate, through the trained weights.

* ``demixing/eval_model.py:51-118``, the transformer: a few epochs of
  batch-mode L-BFGS on the trained net (only to accumulate curvature
  pairs approximating the loss Hessian), then ``influence_matrix`` of one
  sample at the TRAINED weights, each output class's row reshaped into
  per-direction (Ninf^2 + 8) blocks: influence maps per (class,
  direction).
* ``demixing_rl/influence_tsk.py:64-72``, the TSK fuzzy regressor:
  ``influence_matrix`` (Taylor inverse-HVP) averaged over inputs.

Both sit on :func:`smartcal_tpu_torch.ops.autodiff.influence_matrix`.
The transformer's cross derivative is (P, N) with P parameters and N
inputs: ~40M x 98,352 floats at the default width, so the transformer
influence runs at reduced widths only, in both packages.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import func

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.models.transformer import (TransformerEncoder,
                                                   XYBuffer, bce)
from smartcal_tpu_torch.models.tsk import TSKParams, tsk_forward
from smartcal_tpu_torch.ops.autodiff import influence_matrix, ravel_params
from smartcal_tpu_torch.ops.lbfgs import lbfgs_init, lbfgs_step


def transformer_influence(params, model: TransformerEncoder, buf: XYBuffer,
                          K: int, npix: int, warmup_epochs: int = 30,
                          batch_size: int = 4, seed: int = 0,
                          outdir: Optional[str] = None, device="cuda"):
    """Per-(class, direction) influence maps of a trained transformer
    (eval_model.py:52-118): L-BFGS warm-up in batch mode over the buffer
    (history 7, 4 iterations per batch of ``batch_size`` drawn by numpy
    ``seed``, the JAX package's draws) builds the curvature pairs whose
    two-loop recursion is the inverse Hessian inside ``influence_matrix``,
    evaluated at the TRAINED weights ``params`` ({name: tensor}).  Runs on
    ``device`` (default "cuda": raises without a GPU); the model is moved
    there.

    Returns ``(If, maps)``: If (K-1, K*(npix^2+8)) numpy; maps
    ``(ci, ck) -> (npix, npix)`` and ``('meta', ci, ck) -> (8,)``."""
    dev = resolve_device(device)
    model = model.to(dev)
    n = min(buf.mem_cntr, buf.mem_size)
    x_all = torch.as_tensor(buf.x[:n], device=dev)
    y_all = torch.as_tensor(buf.y[:n], device=dev)
    params = {k: v.detach().to(dev) for k, v in params.items()}
    flat, unravel = ravel_params(params)

    rng = np.random.default_rng(seed)
    st = lbfgs_init(flat, history_size=7)
    for _ in range(warmup_epochs):
        idx = torch.as_tensor(rng.integers(0, n, size=min(batch_size, n)),
                              device=dev)

        def loss_fn(p_flat, idx=idx):
            pred = func.functional_call(model, unravel(p_flat),
                                        (x_all[idx],))
            return bce(pred, y_all[idx])

        st, _ = lbfgs_step(loss_fn, st, max_iter=4)

    def model_fn(p, xx):
        return func.functional_call(model, p, (xx[None],))[0]

    If = influence_matrix(model_fn, params, x_all[0], y_all[0],
                          hist=st.hist).detach().cpu().numpy()
    nout = npix * npix + 8
    maps = {}
    for ci in range(If.shape[0]):                     # output classes (K-1)
        Z = If[ci].reshape(K, nout)                   # per direction blocks
        for ck in range(K):
            maps[(ci, ck)] = Z[ck, :npix * npix].reshape(npix, npix)
            maps[("meta", ci, ck)] = Z[ck, npix * npix:]
    if outdir is not None:
        os.makedirs(outdir, exist_ok=True)
        np.savez(os.path.join(outdir, "transformer_influence.npz"),
                 If=If, **{f"map_{ci}_{ck}": maps[(ci, ck)]
                           for ci in range(If.shape[0]) for ck in range(K)})
        try:                                          # PNG maps, like the
            import matplotlib                         # reference If_*.png
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            plt = None
        if plt is not None:
            for key, m in maps.items():
                if key[0] != "meta":
                    plt.imsave(os.path.join(outdir,
                                            f"If_{key[0]}_{key[1]}.png"), m)
    return If, maps


def tsk_influence(params: TSKParams, X, y, n_avg: int = 100,
                  taylor_iters: int = 10, device="cuda"):
    """Mean influence matrix of the trained TSK regressor over the first
    ``n_avg`` inputs (influence_tsk.py:64-72; Taylor inverse-HVP, no
    optimizer history), on ``device`` (default "cuda": raises without a
    GPU).  Returns numpy (out, M)."""
    dev = resolve_device(device)
    X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
    y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
    n_avg = min(n_avg, X.shape[0])
    tree = {k: torch.as_tensor(v).detach().to(dev)
            for k, v in zip(TSKParams._fields, params)}

    def model_fn(p, xx):
        return tsk_forward(TSKParams(**p), xx[None])[0]

    If = None
    for ci in range(n_avg):
        one = influence_matrix(model_fn, tree, X[ci], y[ci], hist=None,
                               taylor_iters=taylor_iters)
        If = one if If is None else If + one
    return (If / n_avg).detach().cpu().numpy()
