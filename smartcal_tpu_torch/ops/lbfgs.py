"""Full-batch L-BFGS with the strong-Wolfe cubic line search, batched over
an explicit lane axis (counterpart of smartcal_tpu/ops/lbfgs.py).

The JAX solver runs ``lbfgs_solve`` under ``vmap(vmap(...))`` over the
(frequency, interval) lanes.  A batched JAX ``while_loop`` runs until
EVERY lane has stopped, and a stopped lane keeps its carry (the loop
condition becomes a select); every ``lax.cond`` becomes a select too, so
both branches run and the lane picks one.  This module writes those
semantics out: every tensor carries a leading lane axis ``L``, the loop
runs while any lane is active, and inactive lanes are frozen with
``torch.where``.  The trajectories therefore follow the JAX package's
lane by lane.

The line search only ever sees ``phi(alpha) -> (value, slope)`` on (L,)
tensors, and every branch of it is a lane-masked ``torch.where``, so it
can run where ``x`` lives without a host sync (inside a CUDA graph it
does).  Elsewhere it syncs a few times to skip work that every lane
discards (:func:`strong_wolfe_cubic`); the loop's own sync per iteration
is the ``active.any()`` test that ends it.
"""

from typing import Callable, NamedTuple, Optional

import torch

LBFGS_HISTORY_DEFAULT = 7


class LBFGSHistory(NamedTuple):
    """Ring buffers of curvature pairs per lane, oldest row first: ``count``
    rows at the END of (L, m, n) ``s``/``y`` are valid; ``gamma`` (L,) is
    the initial inverse-Hessian scale y's/y'y of the newest pair."""

    s: torch.Tensor
    y: torch.Tensor
    count: torch.Tensor
    gamma: torch.Tensor

    @property
    def size(self) -> int:
        """The history depth m."""
        return self.s.shape[-2]


class LBFGSResult(NamedTuple):
    x: torch.Tensor          # (L, n)
    loss: torch.Tensor       # (L,)
    grad: torch.Tensor       # (L, n)
    hist: LBFGSHistory
    n_iters: torch.Tensor    # (L,) int32
    converged: torch.Tensor  # (L,) bool
    stop: torch.Tensor       # (L,) bool
    diverged: torch.Tensor   # (L,) bool


def history_init(n_lanes, n, history_size=LBFGS_HISTORY_DEFAULT,
                 dtype=torch.float32, device="cpu") -> LBFGSHistory:
    z = torch.zeros((n_lanes, history_size, n), dtype=dtype, device=device)
    return LBFGSHistory(
        s=z, y=z.clone(),
        count=torch.zeros(n_lanes, dtype=torch.int32, device=device),
        gamma=torch.ones(n_lanes, dtype=dtype, device=device))


def history_push(hist: LBFGSHistory, s, y, accept) -> LBFGSHistory:
    """Append a curvature pair on the lanes where ``accept`` holds,
    evicting the oldest (lbfgsnew.py:610-622)."""
    m = hist.s.shape[1]
    new_s = torch.cat([hist.s[:, 1:], s[:, None]], dim=1)
    new_y = torch.cat([hist.y[:, 1:], y[:, None]], dim=1)
    ys = torch.sum(y * s, dim=-1)
    yy = torch.sum(y * y, dim=-1)
    a3 = accept[:, None, None]
    return LBFGSHistory(
        s=torch.where(a3, new_s, hist.s),
        y=torch.where(a3, new_y, hist.y),
        count=torch.where(accept, torch.clamp(hist.count + 1, max=m),
                          hist.count),
        gamma=torch.where(accept, ys / yy, hist.gamma))


def two_loop_direction(hist: LBFGSHistory, grad):
    """Descent direction -H^{-1} g per lane by the two-loop recursion,
    invalid ring rows masked to no-ops (lbfgsnew.py:629-651).  ``grad`` is
    (L, n), or (L, k, n) for k vectors per lane at once."""
    m = hist.s.shape[1]
    extra = (1,) * (grad.dim() - 2)

    def lane(t):                     # (L, ...) -> broadcastable over k
        return t.reshape(t.shape[:1] + extra + t.shape[1:])

    rows = torch.arange(m, device=grad.device)
    valid = rows[None, :] >= (m - hist.count)[:, None]          # (L, m)
    ys = torch.sum(hist.y * hist.s, dim=-1)
    rho = torch.where(valid, 1.0 / torch.where(valid, ys, torch.ones_like(ys)),
                      torch.zeros_like(ys))
    q = -grad
    al = [None] * m
    for i in reversed(range(m)):                                # newest first
        al[i] = lane(rho[:, i]) * torch.sum(lane(hist.s[:, i]) * q, dim=-1)
        q = q - al[i][..., None] * lane(hist.y[:, i])
    scale = torch.where(hist.count > 0, hist.gamma,
                        torch.ones_like(hist.gamma))
    r = q * lane(scale)[..., None]
    for i in range(m):
        be = lane(rho[:, i]) * torch.sum(lane(hist.y[:, i]) * r, dim=-1)
        r = r + (al[i] - be)[..., None] * lane(hist.s[:, i])
    return r


def inv_hessian_mult(hist: LBFGSHistory, q):
    """``H^{-1} q`` per lane from the stored curvature pairs (BFGS
    approximation; autograd_tools.py:35-66): the two-loop recursion with
    the initial scale of the newest pair, and ``q`` unchanged on a lane
    with no pair.  ``q`` is (L, n), or (L, n, k): k columns per lane, each
    multiplied as its own vector."""
    cols = q.dim() == 3
    qq = q.transpose(1, 2) if cols else q
    r = -two_loop_direction(hist, qq)
    has = (hist.count > 0).reshape((-1,) + (1,) * (qq.dim() - 1))
    r = torch.where(has, r, qq)
    return r.transpose(1, 2) if cols else r


def _cubic_choose(phi, a, fa, fad, b, fb, fbd):
    """Cubic-interpolation trial point in [a, b] from precomputed endpoint
    values (lbfgsnew.py:319-409); at most one new phi eval.  Returns
    (point, f(point), f'(point)) per lane."""
    one = torch.ones_like(a)
    denom = torch.where(b == a, one, b - a)
    aa = 3.0 * (fa - fb) / denom + fbd - fad
    disc = aa * aa - fad * fbd

    # disc > 0 branch
    cc = torch.sqrt(torch.clamp(disc, min=0.0))
    den2 = fbd - fad + 2.0 * cc
    z0 = torch.where(den2 == 0.0, 0.5 * (a + b),
                     b - (fbd + cc - aa) * (b - a)
                     / torch.where(den2 == 0.0, one, den2))
    hi, lo = torch.maximum(a, b), torch.minimum(a, b)
    inside = (z0 <= hi) & (z0 >= lo)
    fz0, fz0d = phi(z0)
    fz0 = torch.where(inside, fz0, torch.full_like(fz0, float("inf")))
    pick_a = (fa < fb) & (fa < fz0)
    pick_b = (~pick_a) & (fb < fz0)
    p_out = torch.where(pick_a, a, torch.where(pick_b, b, z0))
    p_f = torch.where(pick_a, fa, torch.where(pick_b, fb, fz0))
    p_fd = torch.where(pick_a, fad, torch.where(pick_b, fbd, fz0d))

    # disc <= 0 branch
    pa = fa < fb
    n_out = torch.where(pa, a, b)
    n_f = torch.where(pa, fa, fb)
    n_fd = torch.where(pa, fad, fbd)

    pos = disc > 0.0
    return (torch.where(pos, p_out, n_out), torch.where(pos, p_f, n_f),
            torch.where(pos, p_fd, n_fd))


def _can_sync(device) -> bool:
    """False while a CUDA graph is being captured on ``device``'s stream."""
    return (torch.device(device).type != "cuda"
            or not torch.cuda.is_current_stream_capturing())


def strong_wolfe_cubic(phi: Callable, n_lanes: int, lr: float = 1.0,
                       dtype=torch.float32, device="cpu"):
    """Fletcher strong-Wolfe line search with cubic interpolation, per lane
    (lbfgsnew.py:192-316; bracket trip count 3, zoom 4).  ``phi(alpha)``
    maps (L,) step sizes on ``device`` to (value, directional derivative).
    Returns the (L,) step.

    Every branch is lane-masked, so the result needs no host sync.  Outside
    a CUDA graph capture the search still asks the host a few questions
    that only skip work whose result every lane discards: a zoom no live
    lane needs, zoom trips after every live lane has its step, and bracket
    trips after every lane is done.  The steps are the same either way;
    on one lane this is the work the JAX package's un-vmapped search does
    (its ``lax.cond`` branches are real there)."""
    sigma, rho_ls = 0.1, 0.01
    t1, t2, t3 = 9.0, 0.1, 0.5
    sync = _can_sync(device)

    phi_0, gphi_0 = phi(torch.zeros(n_lanes, dtype=dtype, device=device))

    def full(v):
        return torch.full((n_lanes,), v, dtype=dtype, device=device)

    tol = torch.clamp(phi_0 * 0.01, max=1e-6)
    mu = (tol - phi_0) / (rho_ls * gphi_0)

    def keep(flag, old, new):
        return torch.where(flag, old, new)

    def zoom(a, b, fa, fad, live):
        aj, bj, faj, fajd = a, b, fa, fad
        alphak, found = full(lr), torch.zeros(n_lanes, dtype=torch.bool,
                                              device=device)
        for _ in range(4):
            if sync and bool((found | ~live).all()):
                break
            p01 = aj + t2 * (bj - aj)
            p02 = bj - t3 * (bj - aj)
            f01, f01d = phi(p01)
            f02, f02d = phi(p02)
            alphaj, phi_j, gphi_j = _cubic_choose(phi, p01, f01, f01d,
                                                  p02, f02, f02d)
            cond_shrink = ((phi_j > phi_0 + rho_ls * alphaj * gphi_0)
                           | (phi_j >= faj))
            term1 = (aj - alphaj) * gphi_j <= 1e-6
            term2 = torch.abs(gphi_j) <= -sigma * gphi_0
            newly_found = (~cond_shrink) & (term1 | term2)
            bj_new = torch.where(cond_shrink, alphaj,
                                 torch.where(gphi_j * (bj - aj) >= 0.0,
                                             aj, bj))
            aj_new = torch.where(cond_shrink, aj, alphaj)
            faj_new = torch.where(cond_shrink, faj, phi_j)
            fajd_new = torch.where(cond_shrink, fajd, gphi_j)
            alphak = torch.where(found, alphak, alphaj)
            aj, bj = keep(found, aj, aj_new), keep(found, bj, bj_new)
            faj, fajd = keep(found, faj, faj_new), keep(found, fajd, fajd_new)
            found = found | newly_found
        return alphak

    # bracket phase
    alphai, alphai1 = full(10.0 * lr), full(0.0)
    fi, fid = phi(alphai)
    fi1, fi1d, phi_prev = phi_0, gphi_0, phi_0
    alphak = full(lr)
    done = torch.zeros(n_lanes, dtype=torch.bool, device=device)
    for i in range(3):
        phi_i, gphi_i = fi, fid
        cond0 = phi_i < tol
        cond1 = phi_i > phi_0 + alphai * gphi_0
        if i > 0:
            cond1 = cond1 | (phi_i >= phi_prev)
        cond2 = torch.abs(gphi_i) <= -sigma * gphi_0
        cond3 = gphi_i >= 0.0
        need_zoom = (~cond0) & (cond1 | ((~cond2) & cond3))
        za = torch.where(cond1, alphai1, alphai)
        zb = torch.where(cond1, alphai, alphai1)
        fza = torch.where(cond1, fi1, fi)
        fzad = torch.where(cond1, fi1d, fid)
        live = need_zoom & ~done
        if sync and not bool(live.any()):
            zoom_val = full(lr)
        else:
            zoom_val = torch.where(need_zoom, zoom(za, zb, fza, fzad, live),
                                   full(lr))

        newly_done = cond0 | cond1 | cond2 | cond3
        val = torch.where(cond0, alphai,
                          torch.where(cond1, zoom_val,
                                      torch.where(cond2, alphai, zoom_val)))
        alphak = torch.where(done, alphak,
                             torch.where(newly_done, val, alphak))
        done = done | newly_done
        if sync and bool(done.all()):
            break

        # continuation: extrapolate or interpolate the next trial point
        lo = 2.0 * alphai - alphai1
        hi = torch.minimum(mu, alphai + t1 * (alphai - alphai1))
        flo, flod = phi(lo)
        fhi, fhid = phi(hi)
        cand, fcand, fcandd = _cubic_choose(phi, lo, flo, flod, hi, fhi, fhid)
        use_mu = mu <= lo
        next_ai = torch.where(use_mu, mu, cand)
        next_ai1 = torch.where(use_mu, alphai, alphai1)
        fmu, fmud = phi(mu)
        fnext = torch.where(use_mu, fmu, fcand)
        fnextd = torch.where(use_mu, fmud, fcandd)
        fnext1 = torch.where(use_mu, fi, fi1)
        fnext1d = torch.where(use_mu, fid, fi1d)

        alphai, alphai1 = keep(done, alphai, next_ai), keep(done, alphai1,
                                                             next_ai1)
        fi, fid = keep(done, fi, fnext), keep(done, fid, fnextd)
        fi1, fi1d = keep(done, fi1, fnext1), keep(done, fi1d, fnext1d)
        phi_prev = keep(done, phi_prev, phi_i)

    # degenerate-slope guards (the reference returns 1.0)
    degenerate = (torch.abs(gphi_0) < 1e-12) | torch.isnan(mu)
    alphak = torch.where(degenerate, full(1.0), alphak)
    return torch.where(torch.isnan(alphak), full(lr), alphak)


def _default_line_search(value_and_grad, lr):
    """Strong-Wolfe search on phi(alpha) = (f(x + alpha d),
    g(x + alpha d) . d) per lane: the generic objective when the cost has
    no cheaper form."""
    def line_search(x, d):
        def phi(alpha):
            f, g = value_and_grad(x + alpha[:, None] * d)
            return f, torch.sum(g * d, dim=-1)
        return strong_wolfe_cubic(phi, x.shape[0], lr=lr, dtype=x.dtype,
                                  device=x.device)
    return line_search


def _solve_loop(value_and_grad, line_search, x, loss, g, hist, it, stop,
                diverged, cap, tolerance_grad, tolerance_change):
    """The L-BFGS loop over the carry (x, loss, g, hist, it, stop,
    diverged) until no lane is below its iteration ``cap`` and unstopped,
    shared by :func:`lbfgs_solve` and :func:`lbfgs_resume` so a segmented
    solve walks the same trajectory.  The loop carries nothing else: the
    line search's host-side skips look at its own per-call state only."""
    while True:
        active = (it < cap) & (~stop)
        if not bool(active.any()):
            break
        d = two_loop_direction(hist, g)
        gtd = torch.sum(g * d, dim=-1)
        t = line_search(x, d)
        s = t[:, None] * d
        x_new = x + s
        loss_new, g_new = value_and_grad(x_new)

        # curvature acceptance (lbfgsnew.py:610-613)
        y_new = g_new - g
        accept = torch.sum(y_new * s, dim=-1) > 1e-10 * torch.sum(s * s,
                                                                  dim=-1)
        hist_new = history_push(hist, s, y_new, accept & active)

        abs_gsum = torch.sum(torch.abs(g_new), dim=-1)
        diverged_new = diverged | torch.isnan(abs_gsum) | torch.isnan(loss_new)
        stop_new = ((abs_gsum <= tolerance_grad)
                    | (gtd > -tolerance_change)
                    | (torch.sum(torch.abs(s), dim=-1) <= tolerance_change)
                    | (torch.abs(loss_new - loss) < tolerance_change)
                    | diverged_new)

        a2 = active[:, None]
        x = torch.where(a2, x_new, x)
        g = torch.where(a2, g_new, g)
        loss = torch.where(active, loss_new, loss)
        hist = hist_new
        it = it + active.to(torch.int32)
        stop = torch.where(active, stop_new, stop)
        diverged = torch.where(active, diverged_new, diverged)
    return LBFGSResult(x=x, loss=loss, grad=g, hist=hist, n_iters=it,
                       converged=stop & ~diverged, stop=stop,
                       diverged=diverged)


def lbfgs_solve(value_and_grad: Callable, x0, max_iters: int = 200,
                history_size: int = LBFGS_HISTORY_DEFAULT,
                tolerance_grad: float = 1e-5,
                tolerance_change: float = 1e-9, lr: float = 1.0,
                line_search: Optional[Callable] = None) -> LBFGSResult:
    """Minimise independent per-lane objectives by L-BFGS.

    ``value_and_grad(x)`` maps (L, n) iterates to ((L,) values, (L, n)
    gradients); ``line_search(x, d)`` returns the (L,) step along ``d``.  The
    six early-exit tests of lbfgsnew.py:725-741 stop a lane; the loop ends
    when no lane is active, checked once per iteration (the only sync)."""
    L, n = x0.shape
    dtype, dev = x0.dtype, x0.device
    line_search = line_search or _default_line_search(value_and_grad, lr)
    loss, g = value_and_grad(x0)
    hist = history_init(L, n, history_size, dtype, dev)
    it = torch.zeros(L, dtype=torch.int32, device=dev)
    stop = torch.sum(torch.abs(g), dim=-1) <= tolerance_grad
    return _solve_loop(value_and_grad, line_search, x0, loss, g, hist, it,
                       stop, torch.isnan(loss), max_iters, tolerance_grad,
                       tolerance_change)


def lbfgs_resume(value_and_grad: Callable, res: LBFGSResult,
                 extra_iters: int, tolerance_grad: float = 1e-5,
                 tolerance_change: float = 1e-9, lr: float = 1.0,
                 line_search: Optional[Callable] = None) -> LBFGSResult:
    """Continue a lane-batched :func:`lbfgs_solve` for up to
    ``extra_iters`` more iterations per lane (the JAX package's
    ``lbfgs_resume``): the same loop over the carry recovered from
    ``res``, each lane capped at its own ``n_iters + extra_iters``, so
    ``solve(30)`` and ``solve(10)`` + 2x ``resume(10)`` walk the same
    trajectory bit for bit.  A stopped lane stays as it is.  This is how
    :func:`~smartcal_tpu_torch.cal.solver.solve_admm_host` splits a solve
    into bounded segments."""
    line_search = line_search or _default_line_search(value_and_grad, lr)
    return _solve_loop(value_and_grad, line_search, res.x, res.loss,
                       res.grad, res.hist, res.n_iters, res.stop,
                       res.diverged, res.n_iters + int(extra_iters),
                       tolerance_grad, tolerance_change)


def linesearch_phi_evals(vmapped: bool = True) -> int:
    """Static phi-evaluation count of ONE :func:`strong_wolfe_cubic` call
    (the JAX package's line-search cost model).  The bracket loop runs 3
    trips and zoom 4, so the counts are constants.  Where every branch of
    the search runs (a vmapped JAX solve; here a CUDA graph replay), each
    bracket trip makes 4 zoom trips x (p01 + p02 + interior) and the
    continuation's lo + hi + interior + mu:

      init: phi(0) + phi(alpha1)                                 =  2
      per bracket trip: 4 x 3 + 4                                = 16
      total: 2 + 3 x 16                                          = 50

    ``vmapped=False`` is the lower bound where the zoom runs at most once
    per search.  The solver's measured count is
    ``SolverStats.phi_evals``."""
    if vmapped:
        return 2 + 3 * (4 * 3 + 4)
    return 2 + 3 * 4 + 4 * 3


def solve_eval_counts(n_iters: int, use_line_search: bool = True,
                      vmapped: bool = True) -> dict:
    """Evaluation budget of an :func:`lbfgs_solve` that took ``n_iters``
    iterations: one ``value_and_grad`` per iteration plus the initial one,
    and the line search's phi probes (:func:`linesearch_phi_evals`)."""
    n = int(n_iters)
    return {
        "value_and_grad_evals": n + 1,
        "phi_evals": (n * linesearch_phi_evals(vmapped)
                      if use_line_search else 0),
    }


# ---------------------------------------------------------------------------
# Stochastic (batch-mode) optimizer: one lane, host control flow
# ---------------------------------------------------------------------------

def _value_and_grad(fun):
    def vag(x):
        with torch.enable_grad():
            xr = x.detach().requires_grad_(True)
            val = fun(xr)
            (g,) = torch.autograd.grad(val, xr)
        return val.detach(), g
    return vag


@torch.no_grad()
def backtracking_search(fun: Callable, x, d, grad, alphabar,
                        c1: float = 1e-4, max_halvings: int = 35):
    """Armijo backtracking with a negative-step rescue (lbfgsnew.py:115-186;
    the JAX package's ``backtracking_search``): halve from ``alphabar``
    until the Armijo condition holds; if the decrease is still below
    ``|c1 alpha g.d|``, try the mirrored negative step and keep the better
    one.  ``x``, ``d``, ``grad`` (n,); returns the 0-d step."""
    f_old = fun(x)
    prodterm = c1 * torch.dot(grad, d)

    def halve(alpha0):
        alpha = torch.as_tensor(alpha0, dtype=x.dtype, device=x.device)
        f_new = fun(x + alpha * d)
        for _ in range(max_halvings):
            if not bool(torch.isnan(f_new)
                        | (f_new > f_old + alpha * prodterm)):
                break
            alpha = 0.5 * alpha
            f_new = fun(x + alpha * d)
        return alpha, f_new

    alphak, f_new = halve(alphabar)
    if bool(f_old - f_new < torch.abs(prodterm)):
        alpha1, f_new1 = halve(-alphabar)
        return torch.where(f_new1 < f_new, alpha1, alphak)
    return alphak


class LBFGSState(NamedTuple):
    """State of the stochastic L-BFGS (reference batch mode) on one flat
    parameter vector; ``hist`` is one lane of :class:`LBFGSHistory`."""

    x: torch.Tensor
    hist: LBFGSHistory
    prev_grad: torch.Tensor
    prev_d: torch.Tensor
    prev_t: torch.Tensor
    running_avg: torch.Tensor      # online inter-batch gradient mean
    running_avg_sq: torch.Tensor   # online second moment accumulator
    alphabar: torch.Tensor
    n_total: int                   # iterations across step() calls
    initialized: bool


def lbfgs_init(x0, history_size: int = LBFGS_HISTORY_DEFAULT,
               lr: float = 1.0) -> LBFGSState:
    z = torch.zeros_like(x0)
    return LBFGSState(
        x=x0, hist=history_init(1, x0.shape[0], history_size, x0.dtype,
                                x0.device),
        prev_grad=z, prev_d=z, prev_t=torch.zeros((), dtype=x0.dtype,
                                                  device=x0.device),
        running_avg=z, running_avg_sq=z,
        alphabar=torch.tensor(lr, dtype=x0.dtype, device=x0.device),
        n_total=0, initialized=False)


def lbfgs_step(fun: Callable, state: LBFGSState, max_iter: int = 4,
               lm0: float = 1e-6):
    """One stochastic ``step(closure)`` on a (new) batch: ``fun`` maps the
    flat parameters to the scalar loss of the current batch.  As in the
    reference batch mode (lbfgsnew.py:554-607) and the JAX
    ``lbfgs_step``: on a batch change the curvature pair is not stored,
    the online gradient mean and variance update ``alphabar`` (which caps
    the backtracking search); within the batch, pairs are stored with the
    trust-region modification ``y <- y + lm0 * s``.  Returns ``(state,
    loss)``, the loss the PRE-step objective at the incoming iterate."""
    vag = _value_and_grad(fun)
    loss0, g = vag(state.x)
    loss, st = loss0, state
    for i in range(max_iter):
        n_tot = st.n_total + 1
        batch_changed = i == 0 and st.initialized
        running_avg, running_avg_sq, alphabar = (
            st.running_avg, st.running_avg_sq, st.alphabar)
        if batch_changed:                    # lbfgsnew.py:592-607
            grad_nrm = torch.linalg.norm(g)
            g_old = g - st.running_avg
            running_avg = st.running_avg + g_old / float(n_tot)
            g_new = g - running_avg
            running_avg_sq = st.running_avg_sq + g_new * g_old
            denom = float(max(n_tot - 1, 1)) * grad_nrm
            alphabar = 1.0 / (1.0 + torch.sum(running_avg_sq) / denom)

        # memory update from the previous move
        y = g - st.prev_grad + lm0 * st.prev_d * st.prev_t
        s = st.prev_d * st.prev_t
        accept = ((torch.dot(y, s) > 1e-10 * torch.dot(s, s))
                  & (not batch_changed) & st.initialized)
        hist = history_push(st.hist, s[None], y[None], accept.reshape(1))

        d = two_loop_direction(hist, g[None])[0]
        t = backtracking_search(fun, st.x, d, g, alphabar)
        x_new = st.x + t * d
        # the last inner iteration skips the re-evaluation: the next
        # step() re-evaluates on its new batch (lbfgsnew.py:712-716)
        loss_new, g_new = vag(x_new) if i < max_iter - 1 else (loss, g)
        st = LBFGSState(x=x_new, hist=hist, prev_grad=g, prev_d=d, prev_t=t,
                        running_avg=running_avg,
                        running_avg_sq=running_avg_sq, alphabar=alphabar,
                        n_total=n_tot, initialized=True)
        loss, g = loss_new, g_new
    return st, loss0
