"""Supervised pipelines: data generation and training of the aux models
(counterpart of smartcal_tpu/train/supervised.py).

Parity targets:
  * ``demixing_rl/makedata.py``: (metadata, exhaustive-AIC hint) pairs
    into a TrainingBuffer (:27-37);
  * ``demixing_rl/train_regressor.py``: Adam MLP regression with a
    train/test split and ||.||^2 loss (:36-84);
  * ``demixing_rl/train_tsk.py``: the TSK fuzzy regressor on the same
    buffer;
  * ``calibration/generate_data.py:519-615`` (generate_training_data):
    per-direction features (normalized influence image + 8 scalars) and
    binary demix labels for the transformer classifier;
  * ``demixing/train_model.py``: BCE transformer training;
  * ``demixing_rl/evaluate_tsk_msp.py``: MLP vs TSK vs hint rewards on
    live env episodes.

Every entry point runs on ``device`` (default "cuda": raises without a
GPU).  The numpy draws are the JAX package's (the train/test splits, the
class balancing); the weight inits, the minibatches (without replacement)
and the dropout masks come from ``torch.Generator``s seeded from ``seed``
(JAX's key streams have no torch counterpart).  An Adam step is
``rl.sac.adam_update``, optax's step.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import func

from smartcal_tpu_torch import prng, resolve_device
from smartcal_tpu_torch.cal import dataset
from smartcal_tpu_torch.envs.demixing import DemixingEnv
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.models.regressor import RegressorNet, TrainingBuffer
from smartcal_tpu_torch.models.transformer import (XYBuffer, bce,
                                                   build_transformer)
from smartcal_tpu_torch.models.tsk import train_tsk, tsk_forward
from smartcal_tpu_torch.rl.sac import adam_init, adam_update

META_SCALE = 1e-3


def _generators(seed, dev):
    """(init generator on the CPU, loop generator on ``dev``)."""
    return (torch.Generator().manual_seed(seed),
            torch.Generator(device=dev).manual_seed(seed + 1))


def _split(n, seed, test_frac):
    """The JAX package's train/test index split (numpy ``seed``)."""
    idx = np.random.default_rng(seed).permutation(n)
    n_test = max(1, int(test_frac * n))
    return idx[n_test:], idx[:n_test]


def make_hint_dataset(n_iter=40, K=6, backend: Optional[RadioBackend] = None,
                      seed=0, buffer_path=None, n_samples=3000,
                      device="cuda"):
    """(metadata, hint[:-1]) pairs from env resets (makedata.py:27-37)."""
    env = DemixingEnv(K=K, provide_hint=True, provide_influence=False,
                      backend=backend, seed=seed, device=device)
    buf = TrainingBuffer(n_samples, 3 * K + 2, K - 1)
    for _ in range(n_iter):
        obs = env.reset()
        hint = env.get_hint()
        buf.store(obs["metadata"], hint[:-1])
        if buffer_path:
            buf.save_checkpoint(buffer_path)
    return buf


def params_of(module) -> dict:
    """{dotted name: parameter} of a module (the trainers' Adam keys)."""
    return dict(module.named_parameters())


def regressor_step(net, opt, xb, yb, lr):
    """One Adam step of the summed squared error on (xb, yb), in place;
    returns the pre-step loss."""
    params = params_of(net)
    loss = torch.sum((net(xb) - yb) ** 2)
    grads = torch.autograd.grad(loss, list(params.values()))
    adam_update(opt, params, grads, lr)
    return loss.detach()


def train_regressor(buf: TrainingBuffer, n_iter=1000, batch_size=32,
                    lr=1e-3, test_frac=0.2, seed=0, hidden=32,
                    device="cuda"):
    """Adam MLP training (train_regressor.py:36-84).  Returns (params,
    history): params the net's {name: tensor}, history {"losses",
    "test_mse", "net"}."""
    dev = resolve_device(device)
    x, y = buf.filled()
    train_idx, test_idx = _split(x.shape[0], seed, test_frac)
    x_train, y_train, x_test, y_test = (
        torch.as_tensor(a, device=dev) for a in (
            x[train_idx], y[train_idx], x[test_idx], y[test_idx]))
    g_init, g_loop = _generators(seed, dev)
    net = RegressorNet(x.shape[1], y.shape[1], hidden=hidden,
                       generator=g_init).to(dev)
    opt = adam_init(params_of(net))
    bs = min(batch_size, x_train.shape[0])
    losses = []
    for _ in range(n_iter):
        i = torch.randperm(x_train.shape[0], generator=g_loop,
                           device=dev)[:bs]
        losses.append(regressor_step(net, opt, x_train[i], y_train[i], lr))
    with torch.no_grad():
        test_mse = float(torch.mean(torch.sum(
            (net(x_test) - y_test) ** 2, dim=-1)))
    return params_of(net), {"losses": torch.stack(losses).cpu().numpy(),
                            "test_mse": test_mse, "net": net}


def train_tsk_on_buffer(buf: TrainingBuffer, seed=0, device="cuda", **kw):
    """TSK regressor on the same hint buffer (train_tsk.py)."""
    dev = resolve_device(device)
    x, y = buf.filled()
    train_idx, test_idx = _split(x.shape[0], seed, 0.2)
    return train_tsk(torch.Generator(device=dev).manual_seed(seed),
                     x[train_idx], y[train_idx], x_test=x[test_idx],
                     y_test=y[test_idx], device=dev, **kw)


# ---------------------------------------------------------------------------
# Transformer classifier data + training
# ---------------------------------------------------------------------------

def generate_training_data(key, backend: RadioBackend, K=6,
                           flux_floor=1.0, el_floor=3.0):
    """One (x, y) sample for the demixing transformer.

    x: K blocks of [normalized per-direction influence image (npix^2),
    separation, azimuth, elevation, log||J||, log||C||, log|Inf|, LLR,
    log(f_0)] (generate_data.py:586-615).  y: K-1 binary labels, the
    apparent flux above ``flux_floor`` and the elevation above
    ``el_floor`` (the simulation knows the fluxes exactly).  ``key`` is a
    ``prng`` key.  The backend's ``stage_seconds`` gain
    "perdir_influence" and "features" beside its "simulate" and "solve"."""
    ep, mdl = backend.new_demixing_episode(key, K)
    res = backend.calibrate(ep, mdl.rho, mask=np.ones(K, np.float32))
    freqs = ep.obs.freqs.cpu().numpy()
    stages = {}
    x = dataset.perdir_features(
        res.residual[0], ep.Ccal[0], res.J[0], mdl.rho, freqs, ep.f0,
        ep.obs.uvw, backend.n_stations, backend.n_chunks, mdl.separations,
        mdl.azimuth, mdl.elevation, npix=backend.npix, n_poly=backend.n_poly,
        polytype=backend.polytype, stage_seconds=stages)
    for k, v in stages.items():
        backend.stage_seconds[k] += v
    y = ((mdl.fluxes[:-1] > flux_floor)
         & (mdl.elevation[:-1] >= el_floor)).astype(np.float32)
    return x, y


def make_transformer_dataset(n_iter=30, K=6,
                             backend: Optional[RadioBackend] = None,
                             seed=0, buffer_path=None, device="cuda"):
    """demixing/simulate_data.py: n_iter samples into an XYBuffer, the
    episodes of the key stream split from ``prng.PRNGKey(seed)`` (the JAX
    package's)."""
    backend = backend or RadioBackend(device=device)
    npix = backend.npix
    buf = XYBuffer(max(n_iter, 8), (K * (npix * npix + 8),), (K - 1,))
    key = prng.PRNGKey(seed)
    for _ in range(n_iter):
        key, k = prng.split(key)
        x, y = generate_training_data(k, backend, K=K)
        buf.store(x, y)
        if buffer_path:
            buf.save(buffer_path)
    return buf


def transformer_step(model, opt, xb, yb, lr, generator=None):
    """One Adam step of the BCE on (xb, yb), in place; dropout on (train
    mode) when ``generator`` is given, off otherwise.  Returns the
    pre-step loss."""
    params = params_of(model)
    pred = model(xb, train=generator is not None, generator=generator)
    loss = bce(pred, yb)
    grads = torch.autograd.grad(loss, list(params.values()))
    adam_update(opt, params, grads, lr)
    return loss.detach()


def train_transformer(buf: XYBuffer, K=6, model_dim=66, epochs=2000,
                      batch_size=8, lr=1e-3, dropout=0.6, seed=0,
                      device="cuda"):
    """BCE training of the K-head classifier (demixing/train_model.py:26-57;
    Nmodel=66, dropout 0.6, heads=K).  Returns (params, history): params
    the model's {name: tensor}, history {"losses", "model", "opt"} (the
    Adam state, to continue from)."""
    dev = resolve_device(device)
    n = min(buf.mem_cntr, buf.mem_size)
    x = torch.as_tensor(buf.x[:n], device=dev)
    y = torch.as_tensor(buf.y[:n], device=dev)
    g_init, g_loop = _generators(seed, dev)
    model = build_transformer(K, 0, model_dim, dropout=dropout,
                              input_dim=x.shape[1], generator=g_init,
                              device=dev)
    opt = adam_init(params_of(model))
    bs = min(batch_size, n)
    losses = []
    for _ in range(epochs):
        i = torch.randperm(n, generator=g_loop, device=dev)[:bs]
        losses.append(transformer_step(model, opt, x[i], y[i], lr,
                                       generator=g_loop))
    return params_of(model), {
        "losses": (torch.stack(losses).cpu().numpy() if losses
                   else np.zeros(0, np.float32)), "model": model, "opt": opt}


# ---------------------------------------------------------------------------
# Transformer dataset maintenance: merge + class balancing (host numpy,
# the JAX package's code and draws)
# ---------------------------------------------------------------------------

def merge_xy_buffers(*bufs: XYBuffer) -> XYBuffer:
    """Concatenate the filled parts of several datasets into one
    (demixing/mergebuffers.py:25-35)."""
    xs, ys = [], []
    for b in bufs:
        n = min(b.mem_cntr, b.mem_size)
        xs.append(b.x[:n])
        ys.append(b.y[:n])
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    out = XYBuffer(x.shape[0], x.shape[1:], y.shape[1:])
    for xi, yi in zip(x, y):
        out.store(xi, yi)
    return out


def label_combination_counts(buf: XYBuffer):
    """Bit-encode each multi-label row into a class integer and count
    occurrences (populatebuffer.py:31-42).  Returns (codes (n,),
    {code: count})."""
    n = min(buf.mem_cntr, buf.mem_size)
    codes = np.zeros(n, dtype=int)
    for ci in range(n):
        for bit in buf.y[ci]:
            codes[ci] = (codes[ci] << 1) | int(bit > 0.5)
    uniq, cnt = np.unique(codes, return_counts=True)
    return codes, dict(zip(uniq.tolist(), cnt.tolist()))


def balance_xy_buffer(buf: XYBuffer, seed: int = 0,
                      jitter: float = 1e-3) -> XYBuffer:
    """SMOTE-style oversampling of minority label combinations (the role
    of populatebuffer.py:45-50's SMOTETomek): convex interpolation between
    same-class samples, jittered copies of singletons, every combination
    raised to the majority count; the Tomek cleaning is omitted."""
    rng = np.random.default_rng(seed)
    n = min(buf.mem_cntr, buf.mem_size)
    codes, counts = label_combination_counts(buf)
    target = max(counts.values())
    xs = [buf.x[:n]]
    ys = [buf.y[:n]]
    for code, cnt in counts.items():
        need = target - cnt
        if need <= 0:
            continue
        idx = np.where(codes == code)[0]
        i = rng.choice(idx, size=need)
        if len(idx) > 1:
            j = rng.choice(idx, size=need)
            resample = (j == i)
            j[resample] = idx[(np.searchsorted(idx, j[resample]) + 1)
                              % len(idx)]
            u = rng.random((need, 1)).astype(buf.x.dtype)
            x_new = buf.x[i] + u * (buf.x[j] - buf.x[i])
        else:
            scale = jitter * max(float(np.abs(buf.x[idx]).max()), 1.0)
            x_new = buf.x[i] + scale * rng.standard_normal(
                (need,) + buf.x.shape[1:]).astype(buf.x.dtype)
        xs.append(x_new)
        ys.append(buf.y[i])
    x = np.concatenate(xs)
    y = np.concatenate(ys)
    perm = rng.permutation(x.shape[0])
    out = XYBuffer(x.shape[0], x.shape[1:], y.shape[1:])
    for k in perm:
        out.store(x[k], y[k])
    return out


def evaluate_tsk_msp(buf: TrainingBuffer, mlp_params, mlp_net, tsk_params,
                     env: DemixingEnv, episodes=3):
    """MLP vs TSK vs data-driven hint rewards over live episodes
    (evaluate_tsk_msp.py:62-89).  Returns {name: per-episode rewards}."""
    dev = env.backend.device
    out = {"mlp": [], "tsk": [], "hint": []}
    for _ in range(episodes):
        obs = env.reset()
        md = torch.as_tensor(np.asarray(obs["metadata"], np.float32),
                             device=dev)[None]
        hint = env.get_hint()
        iter_act = hint[-1]
        with torch.no_grad():
            sel_mlp = func.functional_call(mlp_net, mlp_params, (md,))
            sel_tsk = tsk_forward(tsk_params, md)
        for name, sel in (("mlp", sel_mlp[0].cpu().numpy()),
                          ("tsk", sel_tsk[0].cpu().numpy()),
                          ("hint", hint[:-1])):
            action = np.concatenate([sel, [iter_act]]).astype(np.float32)
            _, reward, _, _ = env.step(action)[:4]
            out[name].append(float(reward))
    return out
