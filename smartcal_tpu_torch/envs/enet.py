"""Elastic-net hyperparameter-tuning environment (counterpart of
smartcal_tpu/envs/enet.py).

The reference ``elasticnet/enetenv.py`` as pure ``(reset, step, hint)``
functions on tensors, semantics line by line:

* problem: ``min_x ||y - Ax||^2 + rho0 ||x||_2^2 + rho1 ||x||_1``; action
  -> rho affine map with a -0.1 penalty per out-of-range component; fresh
  noise at a fixed SNR per step;
* inner solve: one lane of the elastic-net L-BFGS
  (:func:`~smartcal_tpu_torch.ops.enet_lbfgs.solve`: kernel 4 on CUDA, on
  the CPU :func:`~smartcal_tpu_torch.ops.lbfgs.lbfgs_solve` with its
  gradient by autograd) with ``max_iters=cfg.lbfgs_iters`` and a 7-pair
  history.  The slope of ``|x|`` at 0 is +1, as JAX's derivative rule for
  ``abs`` (``select(x >= 0, g, -g)``) gives in both ``jax.grad`` and
  ``jax.jvp``; torch's ``abs`` would give 0 there, and every solve starts
  at x = 0, so :func:`_abs` writes JAX's rule as a ``where``;
* influence state: ``B = A @ H^{-1} (d(dL/dx)/dy)`` with the inverse
  Hessian of the solve's own curvature pairs, state ``1 + eig(B)`` (the
  symmetric part's eigenvalues by ``ops/sym_eigvals``: kernel 5 on CUDA,
  ``eigvalsh`` on the CPU);
* reward ``||y|| / ||Ax - y|| + min(E) / max(E) + penalty``;
* hint: 5x5 grid over (lambda1, lambda2) with 2-fold cross-validation, the
  25 x 2 solves as 50 lanes of ONE solve (the JAX package's
  ``vmap(vmap(...))``), each lane with its own lambdas and fold mask.

On CUDA nothing of a step or a hint asks the host anything, so the
episode programs of ``train/enet_sac`` capture it into a CUDA graph.

Randomness is explicit: :func:`reset` takes the raw draws (A, the nonzero
count Mo, the values z and indices idx), :func:`step` and
:func:`draw_noise` the noise vector; :class:`EnetEnv` draws them from its
own ``torch.Generator`` on the env's device.

The step and the hint are written once, over E envs as one program (the
JAX package's ``vmap`` of its one-env functions): each lane keeps its own
A, y and noise, the E inner solves are the lanes of ONE solve
(:func:`step_lanes`), and the E hints its E x 50 lanes
(:func:`get_hint_lanes`).  :func:`step`, :func:`get_hint` and the other
one-env functions run them at E = 1.
"""

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import func

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.ops import enet_lbfgs
from smartcal_tpu_torch.ops.enet_lbfgs import abs_jax as _abs
from smartcal_tpu_torch.ops.enet_lbfgs import lane_loss as _lane_loss
from smartcal_tpu_torch.ops.lbfgs import LBFGSResult, inv_hessian_mult
from smartcal_tpu_torch.ops.sym_eigvals import sym_eigvals

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
    -0.1 penalty each.  Leading axes are lanes."""
    rho_raw = action * (HIGH - LOW) / 2.0 + (HIGH + LOW) / 2.0
    penalty = (-0.1 * torch.sum(rho_raw < LOW, dim=-1)
               - 0.1 * torch.sum(rho_raw > HIGH, dim=-1)).to(torch.float32)
    return torch.clamp(rho_raw, LOW, HIGH), penalty


def _eig_state(cfg: EnetConfig, B):
    """``1 + eig(B)``: the ascending eigenvalues of the symmetric part on
    the device (``ops/sym_eigvals``: kernel 5 on CUDA, ``eigvalsh`` on the
    CPU), or host ``numpy.linalg.eigvals`` real parts in
    ``eig_mode='exact'``, as the JAX package's host callback does."""
    if cfg.eig_mode == "exact":
        E = np.real(np.linalg.eigvals(B.detach().cpu().numpy())).astype(
            np.float32)
        E = torch.from_numpy(E).to(B.device)
    else:
        E = sym_eigvals(B)
    return 1.0 + E


def _solve_lanes(cfg: EnetConfig, A, y, rho) -> LBFGSResult:
    """The step's inner solves (enetenv.py:96-114) of E envs as the lanes
    of one L-BFGS solve from x = 0: A (E, N, M), y (E, N), rho (E, 2)
    (``ops/enet_lbfgs``: kernel 4 on CUDA, the plain solve on the CPU)."""
    return enet_lbfgs.solve(A, y, rho[:, 0], rho[:, 1],
                            max_iters=cfg.lbfgs_iters,
                            history_size=cfg.history_size)


def _solve(cfg: EnetConfig, A, y, rho) -> LBFGSResult:
    """:func:`_solve_lanes` of one env: a one-lane result."""
    return _solve_lanes(cfg, A[None], y[None], rho[None])


def _influence_matrix_lanes(cfg: EnetConfig, A, y, rho, res: LBFGSResult):
    """The influence matrices (enetenv.py:117-139) at the solves' x: the
    model Jacobian is A; ``ll`` = d(dL/dx)/dy at y = ones (it equals
    -2 A^T), by ``torch.func`` over the lanes, through each lane's inverse
    Hessian, ``B = A @ mm``.  Returns (E, N, N)."""
    def lossfn(xv, yv, Av, rv):
        return _lane_loss(Av, yv, xv[None], rv[0], rv[1])[0]

    ll = func.vmap(func.jacrev(func.grad(lossfn, argnums=0), argnums=1))(
        res.x, torch.ones_like(y), A, rho)                    # (E, M, N)
    return A @ inv_hessian_mult(res.hist, ll)


def _influence_lanes(cfg: EnetConfig, A, y, rho, res: LBFGSResult):
    """Influence eigen-states ``1 + eig(B)`` of
    :func:`_influence_matrix_lanes`.  Returns (E, N)."""
    return _eig_state(cfg, _influence_matrix_lanes(cfg, A, y, rho, res))


def _influence(cfg: EnetConfig, A, y, rho, res: LBFGSResult):
    """:func:`_influence_lanes` of one env and its one-lane result."""
    return _influence_lanes(cfg, A[None], y[None], rho[None], res)[0]


def _solve_and_influence_lanes(cfg: EnetConfig, A, y, rho):
    """Lane solves + influence eigen-states: ``(x (E, M), E (E, N), solve
    result)``."""
    res = _solve_lanes(cfg, A, y, rho)
    return res.x, _influence_lanes(cfg, A, y, rho, res), res


def _noisy(cfg: EnetConfig, y0, noise):
    return y0 + cfg.snr * torch.linalg.norm(y0, dim=-1, keepdim=True) \
        / torch.linalg.norm(noise, dim=-1, keepdim=True) * noise


def _lanes(st: EnetState) -> EnetState:
    return EnetState(*(f[None] for f in st))


def step_lanes(cfg: EnetConfig, st: EnetState, actions, noise,
               keepnoise: bool = False):
    """One env step (enetenv.py:72-161) of E envs: ``actions`` (E, 2),
    ``noise`` (E, N) unit normals of the fresh draws (unused, and may be
    None, with ``keepnoise``).  Returns ``(state, obs (E, obs_dim),
    rewards (E,), dones (E,))``; ``done`` is always False as in the
    reference."""
    actions = torch.as_tensor(actions, dtype=torch.float32,
                              device=st.A.device)
    rho, penalty = action_to_rho(actions)
    y = st.y if keepnoise else _noisy(cfg, st.y0, noise)
    x, EE, _ = _solve_and_influence_lanes(cfg, st.A, y, rho)
    obs = torch.cat([EE, st.A.flatten(1)], dim=-1)
    final_err = torch.linalg.norm((st.A @ x[..., None])[..., 0] - y, dim=-1)
    reward = (torch.linalg.norm(y, dim=-1) / final_err
              + torch.amin(EE, dim=-1) / torch.amax(EE, dim=-1) + penalty)
    dones = torch.zeros(x.shape[0], dtype=torch.bool, device=x.device)
    return st._replace(y=y, x=x), obs, reward, dones


def step(cfg: EnetConfig, st: EnetState, action, noise,
         keepnoise: bool = False):
    """:func:`step_lanes` of one env: ``action`` (2,), ``noise`` (N,).
    Returns ``(new_state, obs, reward, done)``, ``done`` the bool False."""
    action = torch.as_tensor(action, dtype=torch.float32,
                             device=st.A.device).reshape(1, -1)
    st2, obs, reward, _ = step_lanes(
        cfg, _lanes(st), action, None if keepnoise else noise[None],
        keepnoise=keepnoise)
    return EnetState(*(f[0] for f in st2)), obs[0], reward[0], False


def draw_noise(cfg: EnetConfig, st: EnetState, noise) -> EnetState:
    """One noisy observation into ``st.y`` (reference ``initsol``'s data
    draw, enetenv.py:197-202) for later ``keepnoise=True`` steps;
    ``noise`` (N,) unit normals, or (E, N) for E lanes."""
    return st._replace(y=_noisy(cfg, st.y0, noise))


_GRIDS = {}


def _grid(device):
    """The (25, 2) (lambda1, lambda2) candidates, lambda1-major; made once
    per device, so a CUDA graph that captures the hint copies nothing from
    the host."""
    key = str(torch.device(device))
    g = _GRIDS.get(key)
    if g is None:
        g = _GRIDS[key] = torch.tensor(
            [(l1, l2) for l1 in HINT_GRID for l2 in HINT_GRID],
            dtype=torch.float32, device=device)
    return g


def hint_lanes(cfg: EnetConfig, device):
    """The hint's 50 lanes, grid-major then fold: the (50, 2) (lambda1,
    lambda2) per lane and (50, N) test masks (fold 0 tests the first half
    of the rows, fold 1 the second)."""
    grid = _grid(device)
    first = torch.arange(cfg.N, device=device) < cfg.N // 2
    folds = torch.stack([first, ~first])
    return grid.repeat_interleave(2, dim=0), folds.repeat(len(grid), 1)


def hint_mses(cfg: EnetConfig, st: EnetState, x):
    """The held-out MSEs of the hint's lane solutions x (E x 50, M), each
    lane scored on the rows of its test fold: (E, 25, 2) for a lane state,
    (25, 2) for one env's state and x (50, M)."""
    test = hint_lanes(cfg, x.device)[1].to(x.dtype)
    lead = st.A.shape[:-2]
    xs = x.reshape(lead + (test.shape[0], cfg.M))
    pred = (st.A[..., None, :, :] @ xs[..., None])[..., 0]
    pred_err = (pred - st.y[..., None, :]) ** 2
    mses = torch.sum(pred_err * test, dim=-1) / torch.sum(test, dim=-1)
    return mses.reshape(lead + (len(HINT_GRID) ** 2, 2))


def hint_solve_lanes(cfg: EnetConfig, st: EnetState):
    """The hint's 25 x 2 cross-validation solves (enetenv.py:229-241) of E
    envs as the E x 50 lanes of one L-BFGS solve (env-major): each
    candidate trains on one half of the rows (the SKEnet objective,
    lambda1 on the L1 term, lambda2 on the squared L2 term) and scores the
    MSE on the other.  Returns the (E, 25, 2) MSEs and the solve's
    result."""
    E = st.A.shape[0]
    lams, test = hint_lanes(cfg, st.A.device)
    lams, test = lams.repeat(E, 1), test.repeat(E, 1)
    w = torch.where(test, 0.0, 1.0)
    res = enet_lbfgs.solve(st.A, st.y, lams[:, 1], lams[:, 0], w,
                           max_iters=HINT_ITERS,
                           history_size=cfg.history_size)
    return hint_mses(cfg, st, res.x), res


def hint_solve(cfg: EnetConfig, st: EnetState):
    """:func:`hint_solve_lanes` of one env: the (25, 2) MSEs and the
    solve's 50-lane result."""
    mses, res = hint_solve_lanes(cfg, _lanes(st))
    return mses[0], res


def hint_from_mses(mses):
    """The grid point of least mean MSE, mapped back to action space (the
    inverse of the step's affine map; hint[..., 0] = lambda1, hint[..., 1]
    = lambda2); leading axes of ``mses`` are lanes."""
    lam = _grid(mses.device)[torch.argmin(torch.mean(mses, dim=-1), dim=-1)]
    return (lam - (HIGH + LOW) / 2.0) / ((HIGH - LOW) / 2.0)


def get_hint_lanes(cfg: EnetConfig, st: EnetState):
    """(E, 2) grid-search hints in action space (enetenv.py:229-241)."""
    return hint_from_mses(hint_solve_lanes(cfg, st)[0])


def get_hint(cfg: EnetConfig, st: EnetState):
    """:func:`get_hint_lanes` of one env: its (2,) hint."""
    return get_hint_lanes(cfg, _lanes(st))[0]


def reset_draws(cfg: EnetConfig, generator, device):
    """The raw draws of :func:`reset` from ``generator``."""
    M, N = cfg.M, cfg.N
    return (torch.randn((N, M), generator=generator, device=device),
            torch.randint(3, M, (), generator=generator, device=device),
            torch.randn(M, generator=generator, device=device),
            torch.randint(0, M, (M,), generator=generator, device=device))


def reset_draws_lanes(cfg: EnetConfig, n_lanes: int, generator, device):
    """The raw draws of :func:`reset_lanes` for ``n_lanes`` envs."""
    M, N, E = cfg.M, cfg.N, n_lanes
    return (torch.randn((E, N, M), generator=generator, device=device),
            torch.randint(3, M, (E,), generator=generator, device=device),
            torch.randn((E, M), generator=generator, device=device),
            torch.randint(0, M, (E, M), generator=generator, device=device))


def reset_lanes(cfg: EnetConfig, A, Mo, z, idx):
    """:func:`reset` of E envs from their stacked draws (leading axis E).
    Returns the lane state (every field with a leading E axis) and the
    (E, obs_dim) observations."""
    sts, obs = zip(*(reset(cfg, A[e], Mo[e], z[e], idx[e])
                     for e in range(A.shape[0])))
    return EnetState(*(torch.stack(f) for f in zip(*sts))), torch.stack(obs)


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

