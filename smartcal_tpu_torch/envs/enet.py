"""Elastic-net hyperparameter-tuning environment (counterpart of
smartcal_tpu/envs/enet.py).

The reference ``elasticnet/enetenv.py`` as pure ``(reset, step, hint)``
functions on tensors, semantics line by line:

* problem: ``min_x ||y - Ax||^2 + rho0 ||x||_2^2 + rho1 ||x||_1``; action
  -> rho affine map with a -0.1 penalty per out-of-range component; fresh
  noise at a fixed SNR per step;
* inner solve: one lane of :func:`~smartcal_tpu_torch.ops.lbfgs.lbfgs_solve`
  with ``max_iters=cfg.lbfgs_iters`` and a 7-pair history, its gradient by
  autograd.  The slope of ``|x|`` at 0 is +1, as JAX's derivative rule for
  ``abs`` (``select(x >= 0, g, -g)``) gives in both ``jax.grad`` and
  ``jax.jvp``; torch's ``abs`` would give 0 there, and every solve starts
  at x = 0, so :func:`_abs` writes JAX's rule as a ``where``;
* influence state: ``B = A @ H^{-1} (d(dL/dx)/dy)`` with the inverse
  Hessian of the solve's own curvature pairs, state ``1 + eig(B)``;
* reward ``||y|| / ||Ax - y|| + min(E) / max(E) + penalty``;
* hint: 5x5 grid over (lambda1, lambda2) with 2-fold cross-validation, the
  25 x 2 solves as 50 lanes of ONE ``lbfgs_solve`` (the JAX package's
  ``vmap(vmap(...))``), each lane with its own lambdas and fold mask.

Randomness is explicit: :func:`reset` takes the raw draws (A, the nonzero
count Mo, the values z and indices idx), :func:`step` and
:func:`draw_noise` the noise vector; :class:`EnetEnv` draws them from its
own ``torch.Generator`` on the env's device.
"""

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import func

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.ops.autodiff import lane_value_and_grad
from smartcal_tpu_torch.ops.lbfgs import (LBFGSResult, inv_hessian_mult,
                                          lbfgs_solve)

LOW = 1e-3   # enetenv.py:21
HIGH = 1e-1  # enetenv.py:22
HINT_GRID = (0.001, 0.005, 0.01, 0.05, 0.1)  # enetenv.py:233
HINT_ITERS = 100


@dataclasses.dataclass(frozen=True)
class EnetConfig:
    M: int = 20                  # parameters (columns)
    N: int = 20                  # data points (rows)
    snr: float = 0.1             # ||noise||/||data|| (enetenv.py:48)
    lbfgs_iters: int = 200       # 20 epochs x max_iter 10
    history_size: int = 7
    eig_mode: str = "symmetric"  # 'symmetric' | 'exact'

    @property
    def obs_dim(self) -> int:
        # state vector = concat(eig (N), A.ravel() (N*M))
        return self.N + self.N * self.M


class EnetState(NamedTuple):
    A: torch.Tensor    # (N, M) normalised design matrix
    x0: torch.Tensor   # (M,) sparse ground truth
    y0: torch.Tensor   # (N,) noise-free data
    y: torch.Tensor    # (N,) last noisy draw
    x: torch.Tensor    # (M,) last solution


def reset(cfg: EnetConfig, A, Mo, z, idx) -> Tuple[EnetState, torch.Tensor]:
    """A new problem (enetenv.py:163-183) from the raw draws: ``A`` (N, M)
    unit normals, ``Mo`` the nonzero count in [3, M), ``z`` (M,) unit
    normals and ``idx`` (M,) indices in [0, M).  The first ``Mo`` draws
    land at their indices; where an index repeats, the LAST draw wins (as
    the JAX package's scatter does on the CPU), and indices >= M drop."""
    M, N = cfg.M, cfg.N
    A = A / torch.linalg.norm(A)
    pos = torch.arange(M, device=A.device)
    idx_eff = torch.where(pos < Mo, idx, M)
    later = ((idx_eff[None, :] == idx_eff[:, None])
             & (pos[None, :] > pos[:, None])).any(dim=1)
    # losers and dropped draws go to a spare slot M, which is cut off
    target = torch.where(later | (idx_eff >= M), M, idx_eff)
    x0 = torch.zeros(M + 1, dtype=z.dtype, device=z.device).scatter(
        0, target, z)[:M]
    y0 = A @ x0
    st = EnetState(A=A, x0=x0, y0=y0, y=y0, x=torch.zeros_like(x0))
    obs = torch.cat([torch.zeros(N, dtype=A.dtype, device=A.device),
                     A.reshape(-1)])
    return st, obs


def action_to_rho(action):
    """Affine action -> (rho, penalty) map (enetenv.py:75-84): actions in
    [-1, 1] span [LOW, HIGH]; out-of-range components are clamped with a
    -0.1 penalty each."""
    rho_raw = action * (HIGH - LOW) / 2.0 + (HIGH + LOW) / 2.0
    penalty = (-0.1 * torch.sum(rho_raw < LOW)
               - 0.1 * torch.sum(rho_raw > HIGH)).to(torch.float32)
    return torch.clamp(rho_raw, LOW, HIGH), penalty


def _eig_state(cfg: EnetConfig, B):
    """``1 + eig(B)``: eigvalsh of the symmetric part on the device
    (ascending; on CUDA it syncs once for its error check), or host
    ``numpy.linalg.eigvals`` real parts in ``eig_mode='exact'``, as the
    JAX package's host callback does."""
    if cfg.eig_mode == "exact":
        E = np.real(np.linalg.eigvals(B.detach().cpu().numpy())).astype(
            np.float32)
        E = torch.from_numpy(E).to(B.device)
    else:
        E = torch.linalg.eigvalsh(0.5 * (B + B.T))
    return 1.0 + E


def _abs(x):
    """``|x|`` whose derivative at 0 is +1 (JAX's rule, see the module
    docstring)."""
    return torch.where(x >= 0, x, -x)


def _lane_loss(A, y, x, l2, l1, w=None):
    """Per-lane elastic-net loss of x (L, M): ``sum(((y - A x) w)^2) +
    l2 ||x||^2 + l1 ||x||_1`` with (L,) or scalar l2, l1 and an optional
    (L, N) row weight w."""
    err = y - x @ A.T
    if w is not None:
        err = err * w
    return (torch.sum(err ** 2, dim=-1) + l2 * torch.sum(x ** 2, dim=-1)
            + l1 * torch.sum(_abs(x), dim=-1))


def _solve(cfg: EnetConfig, A, y, rho) -> LBFGSResult:
    """The step's inner solve (enetenv.py:96-114): one L-BFGS lane from
    x = 0."""
    x0 = torch.zeros((1, cfg.M), dtype=A.dtype, device=A.device)
    return lbfgs_solve(
        lane_value_and_grad(lambda x: _lane_loss(A, y, x, rho[0], rho[1])),
        x0, max_iters=cfg.lbfgs_iters, history_size=cfg.history_size)


def _influence(cfg: EnetConfig, A, y, rho, res: LBFGSResult):
    """Influence eigen-state (enetenv.py:117-139) at the solve's x: the
    model Jacobian is A; ``ll`` = d(dL/dx)/dy at y = ones (it equals
    -2 A^T) through the solve's inverse Hessian, ``B = A @ mm``."""
    x = res.x[0]

    def lossfn(xv, yv):
        return _lane_loss(A, yv, xv[None], rho[0], rho[1])[0]

    ll = func.jacrev(func.grad(lossfn, argnums=0), argnums=1)(
        x, torch.ones_like(y))                                   # (M, N)
    mm = inv_hessian_mult(res.hist, ll[None])[0]
    return _eig_state(cfg, A @ mm)


def _solve_and_influence(cfg: EnetConfig, A, y, rho):
    """Inner solve + influence eigen-state: ``(x, E, solve result)``."""
    res = _solve(cfg, A, y, rho)
    return res.x[0], _influence(cfg, A, y, rho, res), res


def _noisy(cfg: EnetConfig, y0, noise):
    return y0 + cfg.snr * torch.linalg.norm(y0) / torch.linalg.norm(noise) \
        * noise


def step(cfg: EnetConfig, st: EnetState, action, noise,
         keepnoise: bool = False):
    """One env step (enetenv.py:72-161) with the (N,) unit normal ``noise``
    of the fresh draw (unused, and may be None, with ``keepnoise``).
    Returns ``(new_state, obs, reward, done)``; ``done`` is always False as
    in the reference."""
    action = torch.as_tensor(action, dtype=torch.float32,
                             device=st.A.device).reshape(-1)
    rho, penalty = action_to_rho(action)
    y = st.y if keepnoise else _noisy(cfg, st.y0, noise)
    x, EE, _ = _solve_and_influence(cfg, st.A, y, rho)
    obs = torch.cat([EE, st.A.reshape(-1)])
    final_err = torch.linalg.norm(st.A @ x - y)
    reward = (torch.linalg.norm(y) / final_err
              + torch.min(EE) / torch.max(EE) + penalty)
    return st._replace(y=y, x=x), obs, reward, False


def draw_noise(cfg: EnetConfig, st: EnetState, noise) -> EnetState:
    """One noisy observation into ``st.y`` (reference ``initsol``'s data
    draw, enetenv.py:197-202) for later ``keepnoise=True`` steps."""
    return st._replace(y=_noisy(cfg, st.y0, noise))


def _grid(device):
    """The (25, 2) (lambda1, lambda2) candidates, lambda1-major."""
    return torch.tensor([(l1, l2) for l1 in HINT_GRID for l2 in HINT_GRID],
                        dtype=torch.float32, device=device)


def hint_lanes(cfg: EnetConfig, device):
    """The hint's 50 lanes, grid-major then fold: the (50, 2) (lambda1,
    lambda2) per lane and (50, N) test masks (fold 0 tests the first half
    of the rows, fold 1 the second)."""
    grid = _grid(device)
    first = torch.arange(cfg.N, device=device) < cfg.N // 2
    folds = torch.stack([first, ~first])
    return grid.repeat_interleave(2, dim=0), folds.repeat(len(grid), 1)


def hint_mses(cfg: EnetConfig, st: EnetState, x):
    """The (25, 2) held-out MSEs of the hint's 50 lane solutions x (50, M):
    each lane scores the rows of its test fold."""
    test = hint_lanes(cfg, x.device)[1].to(x.dtype)
    pred_err = (x @ st.A.T - st.y) ** 2
    mses = torch.sum(pred_err * test, dim=-1) / torch.sum(test, dim=-1)
    return mses.reshape(len(HINT_GRID) ** 2, 2)


def hint_solve(cfg: EnetConfig, st: EnetState):
    """The hint's 25 x 2 cross-validation solves (enetenv.py:229-241) as
    50 lanes of one L-BFGS solve: each candidate trains on one half of the
    rows (the SKEnet objective, lambda1 on the L1 term, lambda2 on the
    squared L2 term) and scores the MSE on the other.  Returns the (25, 2)
    MSEs and the solve's result."""
    lams, test = hint_lanes(cfg, st.A.device)
    w = torch.where(test, 0.0, 1.0)
    x0 = torch.zeros((lams.shape[0], cfg.M), dtype=st.A.dtype,
                     device=st.A.device)
    res = lbfgs_solve(
        lane_value_and_grad(lambda x: _lane_loss(st.A, st.y, x, lams[:, 1],
                                                 lams[:, 0], w)),
        x0, max_iters=HINT_ITERS, history_size=cfg.history_size)
    return hint_mses(cfg, st, res.x), res


def hint_from_mses(mses):
    """The grid point of least mean MSE, mapped back to action space (the
    inverse of the step's affine map; hint[0] = lambda1, hint[1] =
    lambda2)."""
    lam = _grid(mses.device)[torch.argmin(torch.mean(mses, dim=1))]
    return (lam - (HIGH + LOW) / 2.0) / ((HIGH - LOW) / 2.0)


def get_hint(cfg: EnetConfig, st: EnetState):
    """Grid-search hint in action space (enetenv.py:229-241)."""
    return hint_from_mses(hint_solve(cfg, st)[0])


def reset_draws(cfg: EnetConfig, generator, device):
    """The raw draws of :func:`reset` from ``generator``."""
    M, N = cfg.M, cfg.N
    return (torch.randn((N, M), generator=generator, device=device),
            torch.randint(3, M, (), generator=generator, device=device),
            torch.randn(M, generator=generator, device=device),
            torch.randint(0, M, (M,), generator=generator, device=device))


class EnetEnv:
    """Host-driven gym-like wrapper (reference ``ENetEnv`` interface).  The
    problem lives on ``device`` (default "cuda": raises without a GPU);
    draws come from the env's own generator there."""

    def __init__(self, M: int = 20, N: int = 20, provide_hint: bool = False,
                 seed: int = 0, eig_mode: str = "symmetric",
                 lbfgs_iters: int = 200, device="cuda"):
        self.cfg = EnetConfig(M=M, N=N, eig_mode=eig_mode,
                              lbfgs_iters=lbfgs_iters)
        self.provide_hint = provide_hint
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state: EnetState = None
        self.hint = None

    def _noise(self):
        return torch.randn(self.cfg.N, generator=self.generator,
                           device=self.device)

    def reset(self):
        self.state, obs = reset(self.cfg, *reset_draws(
            self.cfg, self.generator, self.device))
        self.hint = None
        return obs.cpu().numpy()

    def initsol(self):
        """Fix the noise draw for later ``step(..., keepnoise=True)``."""
        self.state = draw_noise(self.cfg, self.state, self._noise())

    def step(self, action, keepnoise: bool = False):
        self.state, obs, reward, done = step(
            self.cfg, self.state, action, None if keepnoise
            else self._noise(), keepnoise=keepnoise)
        out = (obs.cpu().numpy(), float(reward), bool(done))
        if self.provide_hint:
            if self.hint is None:
                self.hint = self.get_hint()
            return (*out, self.hint, {})
        return (*out, {})

    def get_hint(self):
        return get_hint(self.cfg, self.state).cpu().numpy()
