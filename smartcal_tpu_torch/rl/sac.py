"""Soft Actor-Critic (counterpart of smartcal_tpu/rl/sac.py).

The reference SAC agent (``elasticnet/enet_sac.py:478-658``; CNN variants
``calibration/calib_sac.py``) with the JAX package's learn step, update for
update:

* the target value uses the OLD actor, the targets and the old alpha;
* the critics step first (Adam), then the actor loss reads the UPDATED
  critics, with no gradient into them, plus the old alpha and rho; the
  hint-constrained loss adds ``0.5 rho_admm g^2 + rho g`` with
  ``g = max(0, D(a, hint) - thresh)^2``, D an MSE or a KL divergence of
  softmaxed vectors;
* every 10 learn calls (the counter before the increment, so the first
  call too) the dual/temperature update runs on the NEW actor:
  ``rho += rho_admm g``, and alpha by the reference's clamped SGD or by
  Adam on log_alpha (``alpha_rule='sac_v2'``);
* the targets move to ``tau * critic + (1 - tau) * target``.

Each gradient is taken with ``torch.autograd.grad`` against one network's
parameters, so no ``.grad`` buffer is shared between the critic and actor
losses.  Adam is optax's (b1 0.9, b2 0.999, eps 1e-8), applied in place
with ``torch._foreach`` ops; its state (moments and count) is carried
like optax's.

Randomness is explicit: :func:`learn_from_batch` takes the three unit
normal draws ``(n_next, n_pi, n_dual)``, :func:`learn` the replay draws
(Gumbel noise or uniforms), and :class:`SACAgent` draws them from its own
``torch.Generator`` on the device.  The learn counter is a host int, so
"learn or not" and "dual update or not" are decided without a device
sync.

Inside an episode program (``train/blocks.make_block_fn``) the counters
are 0-d device tensors instead (the learn counter, the Adam counts and the
ring's ``cntr`` and ``beta``), as the JAX state carries them: a CUDA graph
bakes host numbers in at capture.  There each decision is a select, as
the JAX package's ``lax.cond`` is under ``vmap``: the learn step always
runs, and where the ring holds fewer than ``batch_size`` transitions
:class:`Kept` puts every tensor it changed back (the dual update likewise
off its cadence); Adam's bias correction is taken in float64 from the
device count and rounded to float32, as the host form's Python float is.

``SACConfig(prioritized=True, replay_backend="native")`` keeps the ring on
the host (:class:`~smartcal_tpu_torch.rl.replay_native.NativePER`, the C++
sum tree), sampled with a numpy generator seeded ``seed + 1`` as in the
JAX agent; only the minibatch crosses to the device.  Each learn is an
``agent_update_sac`` span, and with ``obs.costs`` armed a deferred
``cost`` event (:func:`record_update_cost`).
"""

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from smartcal_tpu_torch import obs, resolve_device
from smartcal_tpu_torch.obs import costs
from smartcal_tpu_torch.obs import diagnostics as dg
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl import replay_native
from smartcal_tpu_torch.rl.networks import (MLPActor, MLPCritic,
                                            SplitImageMetaActor,
                                            SplitImageMetaCritic,
                                            gaussian_sample,
                                            tanh_gaussian_log_prob)
from smartcal_tpu_torch.runtime.atomic import atomic_pickle, safe_pickle_load

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8       # optax.adam defaults
DUAL_EVERY = 10                                     # enet_sac.py:608


@dataclasses.dataclass(frozen=True)
class SACConfig:
    obs_dim: int
    n_actions: int
    gamma: float = 0.99
    tau: float = 0.005
    lr_a: float = 1e-3
    lr_c: float = 1e-3
    alpha: float = 0.03           # entropy temperature (enet main_sac.py:36)
    reward_scale: float = 20.0    # reference reward_scale=N
    batch_size: int = 64
    mem_size: int = 1024
    use_hint: bool = False
    hint_threshold: float = 0.1   # enet_sac.py:514
    admm_rho: float = 0.01        # enet_sac.py:516
    hint_distance: str = "mse"    # 'mse' | 'kld'
    learn_alpha: bool = False
    alpha_lr: float = 1e-4
    # 'reference': alpha = max(0, alpha + alpha_lr*mean(target_entropy +
    # logpi)) from the ``alpha`` argument (enet_sac.py:500,613); 'sac_v2':
    # Adam on log_alpha, alpha = exp(log_alpha) from 1 (the JAX package's
    # deliberate deviation)
    alpha_rule: str = "reference"
    prioritized: bool = False
    error_clip: float = 100.0     # PER absolute_error_upper (enet_sac.py:212)
    replay_backend: str = "hbm"
    # image + metadata towers over a flat obs when set (obs_dim = H*W +
    # meta_dim); use_image=False drops the CNN branch
    img_shape: Optional[Tuple[int, int]] = None
    use_image: bool = True
    is_clip: float = 0.0
    ere_eta: float = 1.0

    def __post_init__(self):
        if self.alpha_rule not in ("reference", "sac_v2"):
            raise ValueError(
                f"alpha_rule must be 'reference' or 'sac_v2', got "
                f"{self.alpha_rule!r}")
        if self.replay_backend not in ("hbm", "native"):
            raise ValueError(
                f"replay_backend must be 'hbm' or 'native', got "
                f"{self.replay_backend!r}")
        rp.validate_fleet_knobs(self.is_clip, self.ere_eta,
                                self.replay_backend)


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the step count and the first and second
    moments, keyed by parameter name."""
    count: int
    mu: dict
    nu: dict


def adam_init(params: dict) -> AdamState:
    return AdamState(0, {k: torch.zeros_like(v) for k, v in params.items()},
                     {k: torch.zeros_like(v) for k, v in params.items()})


def _bias_correction(beta: float, count):
    """``1 - beta ** count``: a Python float of the host count, or a 0-d
    float32 tensor of a device count, taken in float64 and rounded once,
    as the host form's float is where the update reads it."""
    if torch.is_tensor(count):
        return (1.0 - torch.pow(beta, count.to(torch.float64))).to(
            torch.float32)
    return 1.0 - beta ** count


@torch.no_grad()
def adam_update(opt: AdamState, params: dict, grads, lr: float) -> list:
    """One ``optax.adam(lr)`` step applied in place: ``p -= lr * mu_hat /
    (sqrt(nu_hat) + eps)`` with bias-corrected moments; ``grads`` in the
    order of ``params``, None for a parameter the loss does not reach (a
    zero gradient, as optax sees it).  Returns the step tensors
    ``mu_hat / (sqrt(nu_hat) + eps)`` (the update is ``-lr`` times them),
    which the update diagnostics read."""
    opt.count += 1
    names = list(params)
    p = [params[k] for k in names]
    mu = [opt.mu[k] for k in names]
    nu = [opt.nu[k] for k in names]
    grads = [torch.zeros_like(q) if g is None else g
             for q, g in zip(p, grads)]
    torch._foreach_mul_(mu, ADAM_B1)
    torch._foreach_add_(mu, grads, alpha=1.0 - ADAM_B1)
    torch._foreach_mul_(nu, ADAM_B2)
    torch._foreach_addcmul_(nu, grads, grads, value=1.0 - ADAM_B2)
    den = torch._foreach_div(nu, _bias_correction(ADAM_B2, opt.count))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, ADAM_EPS)
    step = torch._foreach_div(mu, _bias_correction(ADAM_B1, opt.count))
    torch._foreach_div_(step, den)
    torch._foreach_add_(p, step, alpha=-lr)
    return step


def state_tensors(st, names=None) -> list:
    """The tensors of agent state ``st`` that an update changes in place:
    the parameters of its modules, its Adam moments and (device form)
    counts, its other tensors and (device form) its counters; ``names``
    picks the fields (default: all)."""
    names = names or (st.NETS + st.OPTS + st.TENSORS + st.INTS)
    out = []
    for k in names:
        v = getattr(st, k)
        if k in st.NETS:
            out += list(v.parameters())
        elif k in st.OPTS:
            out += list(v.mu.values()) + list(v.nu.values())
            if torch.is_tensor(v.count):
                out.append(v.count)
        elif torch.is_tensor(v):
            out.append(v)
    return out


class Kept:
    """Copies of tensors taken before an update that a device-side
    decision gates: :meth:`restore_where` puts them back where the gate is
    off, leaving every tensor as it was, bit for bit (the select form of
    the JAX package's ``lax.cond``)."""

    def __init__(self, tensors):
        self.live = list(tensors)
        with torch.no_grad():
            self.saved = [t.clone() for t in self.live]

    def restore_where(self, off) -> None:
        with torch.no_grad():
            for t, c in zip(self.live, self.saved):
                torch.where(off, c, t, out=t)


def gate_metrics(on, metrics: dict) -> dict:
    """``metrics`` where ``on``, else the no-learn branch's zeros (a diag
    field by field; the tensors the state holds, such as alpha, are
    returned as they are)."""
    out = {}
    for k, v in metrics.items():
        if isinstance(v, dg.UpdateDiag):
            out[k] = dg.UpdateDiag(*(torch.where(on, f, 0.0) for f in v))
        elif k in ("alpha", "rho") or not torch.is_tensor(v):
            out[k] = v
        elif k == "is_clip_mean":
            out[k] = torch.where(on, v, 1.0)
        else:
            out[k] = torch.where(on, v, 0.0)
    return out


def soft_update(target, source, tau: float) -> None:
    """``target <- tau * source + (1 - tau) * target``, in place."""
    with torch.no_grad():
        tp = list(target.parameters())
        torch._foreach_mul_(tp, 1.0 - tau)
        torch._foreach_add_(tp, list(source.parameters()), alpha=tau)


def build_nets(cfg: SACConfig, generator=None, device="cpu"):
    """(actor, critic) modules of ``cfg``'s shape, freshly initialised."""
    if cfg.img_shape is not None:
        return (SplitImageMetaActor(cfg.img_shape, cfg.obs_dim,
                                    cfg.n_actions, use_image=cfg.use_image,
                                    generator=generator, device=device),
                SplitImageMetaCritic(cfg.img_shape, cfg.obs_dim,
                                     cfg.n_actions, use_image=cfg.use_image,
                                     generator=generator, device=device))
    return (MLPActor(cfg.obs_dim, cfg.n_actions, generator=generator,
                     device=device),
            MLPCritic(cfg.obs_dim, cfg.n_actions, generator=generator,
                      device=device))


def _params(module) -> dict:
    return dict(module.named_parameters())


def _host(t):
    return t.detach().cpu().numpy()


class AgentState:
    """Host round trip and device copies of an agent state: ``NETS`` name
    the modules (targets start with "t" and take no gradient), ``OPTS``
    their Adam states, ``TENSORS`` the other tensors and ``INTS`` the host
    counters.  A subclass says how to build a fresh module of each name
    (:meth:`build`)."""

    NETS: Tuple[str, ...] = ()
    OPTS: Tuple[str, ...] = ()
    TENSORS: Tuple[str, ...] = ()
    INTS: Tuple[str, ...] = ()

    @staticmethod
    def build(cfg, name: str, device) -> torch.nn.Module:
        raise NotImplementedError

    @property
    def carried(self) -> bool:
        """True while the counters are 0-d device tensors (inside an
        episode program, ``train/blocks.make_block_fn``)."""
        return (any(torch.is_tensor(getattr(self, k)) for k in self.INTS)
                or any(torch.is_tensor(getattr(self, k).count)
                       for k in self.OPTS))

    def to_host(self) -> dict:
        """Everything as numpy arrays and Python numbers (the pickle of
        ``save_models``)."""
        out = {k: {n: _host(v) for n, v in getattr(self, k).state_dict()
                   .items()} for k in self.NETS}
        for k in self.OPTS:
            o = getattr(self, k)
            out[k] = {"count": o.count,
                      "mu": {n: _host(v) for n, v in o.mu.items()},
                      "nu": {n: _host(v) for n, v in o.nu.items()}}
        for k in self.TENSORS:
            t = getattr(self, k)
            out[k] = float(t) if t.dim() == 0 else _host(t)
        out.update({k: getattr(self, k) for k in self.INTS})
        return out

    @classmethod
    def from_host(cls, cfg, host: dict, device):
        """The state of a :meth:`to_host` payload, on ``device``."""
        def tensor(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        nets = {}
        for k in cls.NETS:
            net = cls.build(cfg, k, device)
            net.load_state_dict({n: tensor(v) for n, v in host[k].items()})
            nets[k] = net.requires_grad_(k[0] != "t")
        opts = {k: AdamState(int(host[k]["count"]),
                             {n: tensor(v) for n, v in host[k]["mu"].items()},
                             {n: tensor(v) for n, v in host[k]["nu"].items()})
                for k in cls.OPTS}
        return cls(**nets, **opts, **{k: tensor(host[k]) for k in cls.TENSORS},
                   **{k: int(host[k]) for k in cls.INTS})

    def copy_to(self, device):
        """An independent copy of the state on ``device``."""
        st = copy.deepcopy(self)
        for k in self.NETS:
            getattr(st, k).to(device)
        for k in self.OPTS:
            o = getattr(st, k)
            o.mu = {n: v.to(device) for n, v in o.mu.items()}
            o.nu = {n: v.to(device) for n, v in o.nu.items()}
        for k in self.TENSORS:
            setattr(st, k, getattr(st, k).to(device))
        return st


@dataclasses.dataclass
class SACState(AgentState):
    """The agent: actor, critics and targets (modules), their Adam states,
    alpha and rho (0-d tensors), the learn counter (host int), and log_alpha
    with its Adam state (used by ``alpha_rule='sac_v2'``)."""
    actor: torch.nn.Module
    c1: torch.nn.Module
    c2: torch.nn.Module
    t1: torch.nn.Module
    t2: torch.nn.Module
    actor_opt: AdamState
    c1_opt: AdamState
    c2_opt: AdamState
    alpha: torch.Tensor
    rho: torch.Tensor
    learn_counter: int
    log_alpha: torch.Tensor
    alpha_opt: AdamState

    NETS = ("actor", "c1", "c2", "t1", "t2")
    OPTS = ("actor_opt", "c1_opt", "c2_opt", "alpha_opt")
    TENSORS = ("alpha", "rho", "log_alpha")
    INTS = ("learn_counter",)

    @staticmethod
    def build(cfg, name, device):
        return build_nets(cfg, device=device)[0 if name == "actor" else 1]


def sac_init(cfg: SACConfig, generator=None, device="cuda") -> SACState:
    """A fresh agent on ``device`` (default "cuda": raises without a GPU),
    initialised from ``generator`` (a ``torch.Generator`` on that device)."""
    dev = resolve_device(device)
    actor, c1 = build_nets(cfg, generator, dev)
    _, c2 = build_nets(cfg, generator, dev)
    t1 = copy.deepcopy(c1).requires_grad_(False)
    t2 = copy.deepcopy(c2).requires_grad_(False)
    # under the 'reference' rule alpha itself is the learned variable, from
    # the alpha argument; 'sac_v2' starts at exp(log_alpha = 0) = 1
    alpha0 = 1.0 if cfg.learn_alpha and cfg.alpha_rule == "sac_v2" \
        else cfg.alpha
    log_alpha = torch.zeros((), device=dev)
    return SACState(
        actor=actor, c1=c1, c2=c2, t1=t1, t2=t2,
        actor_opt=adam_init(_params(actor)), c1_opt=adam_init(_params(c1)),
        c2_opt=adam_init(_params(c2)),
        alpha=torch.tensor(alpha0, dtype=torch.float32, device=dev),
        rho=torch.zeros((), device=dev), learn_counter=0,
        log_alpha=log_alpha,
        alpha_opt=adam_init({"log_alpha": log_alpha}))


@torch.no_grad()
def choose_action(cfg: SACConfig, st: SACState, obs, noise=None,
                  deterministic: bool = False):
    """Sample an action (reference ``choose_action``); ``noise`` is the unit
    normal draw of the actor's mean's shape."""
    mu, logsigma = st.actor(obs)
    if deterministic:
        return torch.tanh(mu)
    return gaussian_sample(mu, logsigma, noise)[0]


@torch.no_grad()
def choose_action_logp(cfg: SACConfig, st: SACState, obs, noise):
    """:func:`choose_action` that also returns ``log pi(a|s)`` (shape
    ``obs.shape[:-1]``): the behavior log-prob a fleet actor stores for the
    learner's importance ratio.  The same draw gives the same action."""
    a, lp = gaussian_sample(*st.actor(obs), noise)
    return a, lp[..., 0]


def impact_weights(cfg: SACConfig, actor, batch: dict, learner_version):
    """Clipped importance weights of a versioned batch (IMPACT,
    arXiv:1912.00167 eq. 2, for one-step TD): ``pi_now(a|s) /
    pi_behavior(a|s)``, the numerator under the current ``actor`` module
    and the denominator the stored ``behavior_logp``, clipped to
    ``[1/is_clip, is_clip]`` and exactly 1.0 where the transition's
    ``version`` is not behind ``learner_version``.  Returns ``(weights,
    aux)``."""
    with torch.no_grad():
        mu, logsigma = actor(batch["state"])
        lp_now = tanh_gaussian_log_prob(mu, logsigma, batch["action"])
        ratio = torch.exp(lp_now - batch["behavior_logp"])
    return rp.staleness_clip_weights(ratio, batch["version"],
                                     learner_version, cfg.is_clip)


def weighted_critic_loss(cfg, q1, q2, y, is_w):
    """The twin TD loss: IS-weighted (``replay.per_mse``) under PER or with
    ``is_clip`` armed (the fleet weights folded into ``is_w``), plain MSE
    otherwise.  Both are sum / numel, as ``jnp.mean`` is, so weights of
    exactly 1.0 give the unweighted loss bit for bit."""
    if cfg.prioritized or cfg.is_clip > 0:
        return rp.per_mse(q1, y, is_w) + rp.per_mse(q2, y, is_w)
    td1, td2 = q1 - y, q2 - y
    return (torch.sum(td1 * td1) / td1.numel()
            + torch.sum(td2 * td2) / td2.numel())


@torch.no_grad()
def policy_apply(cfg: SACConfig, actor, obs):
    """Deterministic policy head: ``tanh(mu)`` of the actor module."""
    return torch.tanh(actor(obs)[0])


@torch.no_grad()
def policy_heads(cfg: SACConfig, actor, obs):
    """:func:`policy_apply` that also returns the distribution heads:
    ``(tanh(mu), mu, logsigma)``."""
    mu, logsigma = actor(obs)
    return torch.tanh(mu), mu, logsigma


def _hint_gap(cfg: SACConfig, actions, hints):
    """g = max(0, D(a, hint) - thresh)^2 with D the MSE (enet_sac.py:601) or
    the KL divergence of the softmaxed vectors (calib_sac.py:361-366)."""
    if cfg.hint_distance == "kld":
        p = torch.softmax(hints, dim=-1)
        q = torch.softmax(actions, dim=-1)
        d = torch.mean(torch.sum(p * (torch.log(p + 1e-9)
                                      - torch.log(q + 1e-9)), dim=-1))
    else:
        d = torch.mean((actions - hints) ** 2)
    return torch.clamp(d - cfg.hint_threshold, min=0.0) ** 2


def learn_from_batch(cfg: SACConfig, st: SACState, batch: dict, is_w,
                     noise, collect_diag: bool = False,
                     learner_version=None) -> dict:
    """The SAC learn step on an already-sampled ``batch`` (field -> (B, ...)
    tensors), with PER importance weights ``is_w`` (B,) and the unit normal
    draws ``noise = (n_next, n_pi, n_dual)``, each (B, n_actions).  Updates
    ``st`` in place; returns the losses, alpha, rho and ``td`` = |Q1 - y|
    per transition (the PER priority signal), all on the device.

    ``collect_diag`` adds ``diag``, an :class:`~smartcal_tpu_torch.obs.
    diagnostics.UpdateDiag` read from tensors the step holds (gradients
    and Adam steps, the Q batch, the policy's log-probabilities), the
    parameter norms taken before each optimizer step; the update itself
    is the same computation either way.

    ``learner_version`` (required when ``cfg.is_clip`` is armed) drives the
    fleet's staleness weighting (:func:`impact_weights`): the critic loss
    is weighted per transition, same-version transitions at exactly 1.0,
    and the metrics carry its aux."""
    n_next, n_pi, n_dual = noise
    clip_aux = {}
    if cfg.is_clip > 0:
        if learner_version is None:
            raise ValueError("cfg.is_clip armed but learn_from_batch was "
                             "not given the learner_version")
        w_clip, clip_aux = impact_weights(cfg, st.actor, batch,
                                          learner_version)
        is_w = is_w * w_clip
    s, a, s2, hint = (batch[k] for k in ("state", "action", "new_state",
                                          "hint"))
    r = cfg.reward_scale * batch["reward"][:, None]
    done = batch["done"][:, None]
    alpha, rho = st.alpha, st.rho

    # -- target value (enet_sac.py:569-575)
    with torch.no_grad():
        a2, lp2 = gaussian_sample(*st.actor(s2), n_next)
        min_t = torch.minimum(st.t1(s2, a2), st.t2(s2, a2)) - alpha * lp2
        y = r + cfg.gamma * torch.where(done, 0.0, min_t)

    # -- critic update (enet_sac.py:577-587)
    p1, p2 = _params(st.c1), _params(st.c2)
    q1, q2 = st.c1(s, a), st.c2(s, a)
    closs = weighted_critic_loss(cfg, q1, q2, y, is_w)
    g = torch.autograd.grad(closs, list(p1.values()) + list(p2.values()))
    if collect_diag:
        c_norm = dg.tree_norm([p1, p2])
    u1 = adam_update(st.c1_opt, p1, g[:len(p1)], cfg.lr_c)
    u2 = adam_update(st.c2_opt, p2, g[len(p1):], cfg.lr_c)

    # -- actor update with the hint ADMM penalty (enet_sac.py:589-605),
    # against the updated critics
    pa = _params(st.actor)
    acts, lp = gaussian_sample(*st.actor(s), n_pi)
    qa = torch.minimum(st.c1(s, acts), st.c2(s, acts))
    aloss = torch.mean(alpha * lp - qa)
    if cfg.use_hint:
        gap = _hint_gap(cfg, acts, hint)
        aloss = aloss + 0.5 * cfg.admm_rho * gap * gap + rho * gap
    ga = torch.autograd.grad(aloss, list(pa.values()))
    if collect_diag:
        a_norm = dg.tree_norm(pa)
    ua = adam_update(st.actor_opt, pa, ga, cfg.lr_a)

    # -- dual/temperature updates every 10 learn calls
    # (enet_sac.py:608-617), on the updated actor; on a device counter
    # always computed, then kept where the cadence says so
    on_device = torch.is_tensor(st.learn_counter)
    if on_device:
        dual_on = torch.remainder(st.learn_counter, DUAL_EVERY) == 0
    if (cfg.use_hint or cfg.learn_alpha) and (
            on_device or st.learn_counter % DUAL_EVERY == 0):
        if on_device:
            alpha_t, rho_t = st.alpha, st.rho
            kept = Kept(state_tensors(st, ("alpha", "rho", "log_alpha",
                                           "alpha_opt")))
        with torch.no_grad():
            acts_d, lp_d = gaussian_sample(*st.actor(s), n_dual)
            if cfg.learn_alpha:
                target_entropy = -float(cfg.n_actions)
                if cfg.alpha_rule == "reference":
                    st.alpha = torch.clamp(
                        alpha + cfg.alpha_lr
                        * torch.mean(target_entropy + lp_d), min=0.0)
                else:
                    g_la = -torch.mean(lp_d + target_entropy)
                    adam_update(st.alpha_opt, {"log_alpha": st.log_alpha},
                                [g_la], cfg.alpha_lr)
                    st.alpha = torch.exp(st.log_alpha)
            if cfg.use_hint:
                st.rho = rho + cfg.admm_rho * _hint_gap(cfg, acts_d, hint)
        if on_device:
            # the new values into the captured tensors, then the cadence
            with torch.no_grad():
                alpha_t.copy_(st.alpha)
                rho_t.copy_(st.rho)
            st.alpha, st.rho = alpha_t, rho_t
            kept.restore_where(~dual_on)

    # -- soft target update (enet_sac.py:523-542)
    soft_update(st.t1, st.c1, cfg.tau)
    soft_update(st.t2, st.c2, cfg.tau)
    st.learn_counter += 1
    out = {"critic_loss": closs.detach(), "actor_loss": aloss.detach(),
           "alpha": st.alpha, "rho": st.rho,
           "td": (q1 - y).abs().squeeze(-1).detach(), **clip_aux}
    if collect_diag:
        q = q1.detach()
        out["diag"] = dg.make_diag(
            critic_loss=closs, actor_loss=aloss,
            critic_grad_norm=dg.tree_norm(g), actor_grad_norm=dg.tree_norm(ga),
            critic_update_ratio=cfg.lr_c * dg.tree_norm([u1, u2])
            / (c_norm + 1e-12),
            actor_update_ratio=cfg.lr_a * dg.tree_norm(ua) / (a_norm + 1e-12),
            q_mean=torch.mean(q), q_min=torch.min(q), q_max=torch.max(q),
            target_drift=dg.target_drift(st.c1, st.t1), alpha=st.alpha,
            entropy=-torch.mean(lp.detach()),
            hint_residual=(torch.mean((acts.detach() - hint) ** 2)
                           if cfg.use_hint else 0.0))
    return out


def sample_batch(cfg, buf, generator=None, sample_noise=None):
    """Draw one batch from ``buf`` (flat or sharded) as the agents' learn
    steps do: PER (with ERE modulation when ``cfg.ere_eta`` < 1), ERE, or
    uniform.  Returns (batch, idx, is_w)."""
    rpb = rp.backend_for(buf)
    ere = cfg.ere_eta if cfg.ere_eta < 1.0 else None
    B = cfg.batch_size
    if cfg.prioritized:
        return rpb.replay_sample_per(buf, B, generator, u=sample_noise,
                                     recency_eta=ere)
    if ere is not None:
        batch, idx = rpb.replay_sample_ere(buf, B, ere, generator,
                                           u=sample_noise)
    else:
        batch, idx = rpb.replay_sample_uniform(buf, B, generator,
                                               gumbel_noise=sample_noise)
    return batch, idx, torch.ones(B, device=buf.device)


def learn(cfg: SACConfig, st: SACState, buf, generator=None,
          sample_noise=None, noise=None, collect_diag: bool = False,
          learner_version=None) -> dict:
    """One learn step: sample from ``buf``, :func:`learn_from_batch`, and
    re-prioritise the sampled slots under PER.  A no-op while the buffer
    holds fewer than ``batch_size`` transitions (decided on the host
    counter).  ``sample_noise`` (Gumbel noise for uniform sampling,
    uniforms for PER/ERE) and ``noise`` default to draws from
    ``generator``.  Updates ``st`` and ``buf`` in place; returns the
    metrics without ``td`` (with ``collect_diag``, ``diag``: a zero one
    when no learn happened, as in the JAX package).

    ``buf`` is the flat ring or the sharded one (``rl/replay_sharded``):
    the sample and priority update dispatch on its type, and nothing of
    the sampled batch crosses to the host.  ``learner_version`` arms the
    staleness weighting when ``cfg.is_clip`` is set.

    On the device form of ``st`` and ``buf`` (an episode program's) the
    step always runs and "learn or not" is a select (:class:`Kept`)."""
    if torch.is_tensor(buf.cntr):
        learn_on = buf.cntr >= cfg.batch_size
        kept = Kept(state_tensors(st) + [buf.priority, buf.beta])
        m = _learn_step(cfg, st, buf, generator, sample_noise, noise,
                        collect_diag, learner_version)
        kept.restore_where(~learn_on)
        return gate_metrics(learn_on, m)
    if buf.cntr < cfg.batch_size:
        return _no_learn(cfg, st, collect_diag)
    return _learn_step(cfg, st, buf, generator, sample_noise, noise,
                       collect_diag, learner_version)


def _no_learn(cfg, st, collect_diag):
    """The metrics of a learn step that did not learn."""
    zero = torch.zeros((), device=st.alpha.device)
    out = {"critic_loss": zero, "actor_loss": zero, "alpha": st.alpha,
           "rho": st.rho}
    if cfg.is_clip > 0:
        out.update(rp.zero_clip_aux(st.alpha.device))
    if collect_diag:
        out["diag"] = dg.zero_diag(st.alpha.device)
    return out


def _learn_step(cfg, st, buf, generator, sample_noise, noise, collect_diag,
                learner_version):
    """Sample, :func:`learn_from_batch`, re-prioritise: :func:`learn`
    past its gate."""
    batch, idx, is_w = sample_batch(cfg, buf, generator, sample_noise)
    if noise is None:
        noise = tuple(torch.randn((cfg.batch_size, cfg.n_actions),
                                  generator=generator, device=buf.device)
                      for _ in range(3))
    m = learn_from_batch(cfg, st, batch, is_w, noise,
                         collect_diag=collect_diag,
                         learner_version=learner_version)
    td = m.pop("td")
    if cfg.prioritized:
        rp.backend_for(buf).replay_update_priorities(buf, idx, td,
                                                     cfg.error_clip)
    return m


def _update_probe(learn_fn, cfg, st, buf, collect_diag):
    """``learn_fn`` (an agent module's ``learn``) on copies of ``st`` and of
    the ring's priorities, with a generator of its own: what a deferred
    update cost counts, leaving the agent's state, ring and draws as they
    are.  The copies are not counted."""
    dev = buf.device
    with costs.uncounted():
        st = st.copy_to(dev)
        buf = rp.ReplayState(buf.data, buf.priority.clone(), buf.cntr,
                             buf.beta)
    return learn_fn(cfg, st, buf, torch.Generator(device=dev).manual_seed(0),
                    collect_diag=collect_diag)


def _native_update_probe(cfg, st, batch, is_w, collect_diag):
    """:func:`learn_from_batch` on a copy of ``st`` (the native arm's
    update; see :func:`_update_probe`)."""
    dev = is_w.device
    with costs.uncounted():
        st = st.copy_to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    noise = tuple(torch.randn((cfg.batch_size, cfg.n_actions),
                              generator=gen, device=dev) for _ in range(3))
    return learn_from_batch(cfg, st, batch, is_w, noise,
                            collect_diag=collect_diag)


def record_update_cost(stage, learn_fn, cfg, st, buf, collect_diag=False):
    """The deferred ``cost`` event of an agent update (the JAX agents'
    ``agent_update_<algo>`` site), counted on copies by
    :func:`_update_probe` between episodes.  A no-op unless ``obs.costs``
    is armed and a RunLog records."""
    costs.record_stage_cost(stage, _update_probe, learn_fn, cfg, st, buf,
                            collect_diag, defer=True)


class SACAgent:
    """Stateful wrapper with the reference ``Agent`` API (choose_action /
    store_transition / learn / save_models / load_models) for host-driven
    training loops.  The agent and its generator live on ``device``
    (default "cuda": raises without a GPU), and so does its replay ring,
    except under ``replay_backend="native"`` with PER: a host
    :class:`~smartcal_tpu_torch.rl.replay_native.NativePER` sampled by a
    numpy generator seeded ``seed + 1`` (JAX rl/sac.py:509-625)."""

    def __init__(self, cfg: SACConfig, seed: int = 0, name_prefix: str = "",
                 device="cuda", collect_diag: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = sac_init(cfg, self.generator, self.device)
        spec = rp.transition_spec(cfg.obs_dim, cfg.n_actions)
        self.native = cfg.prioritized and cfg.replay_backend == "native"
        if self.native:
            self.buffer = replay_native.NativePER(cfg.mem_size, spec,
                                                  error_clip=cfg.error_clip)
            self._rng = np.random.default_rng(seed + 1)
        else:
            self.buffer = rp.replay_init(cfg.mem_size, spec, self.device)
            self._rng = None
        self.name_prefix = name_prefix
        self.collect_diag = collect_diag
        self.last_metrics = {}
        self.last_diag = None

    def choose_action(self, observation, noise=None):
        """A sampled action as a numpy array; ``noise`` (the unit normal
        draw) defaults to one from the agent's generator."""
        obs = torch.as_tensor(np.asarray(observation, np.float32),
                              device=self.device)
        if noise is None:
            noise = torch.randn(obs.shape[:-1] + (self.cfg.n_actions,),
                                generator=self.generator, device=self.device)
        else:
            noise = torch.as_tensor(noise, device=self.device)
        return _host(choose_action(self.cfg, self.state, obs, noise))

    def store_transition(self, state, action, reward, state_, done, hint):
        tr = {"state": state, "action": action, "reward": reward,
              "new_state": state_, "done": done, "hint": hint}
        if self.native:
            self.buffer.store(tr)      # max-priority init (enet_sac.py:63-64)
            return
        # uniform buffers store priority 1; PER the max priority
        # (enet_sac.py:63-64)
        rp.replay_add(self.buffer, tr,
                      priority=None if self.cfg.prioritized else 1.0)

    def learn(self, sample_noise=None, noise=None):
        """One learn step (a no-op below ``batch_size`` transitions); the
        replay draws and the normal draws default to the generators'
        (under the native backend ``sample_noise`` is the segment
        uniforms, else drawn from the numpy sampler)."""
        if self.native:
            self.last_metrics = self._learn_native(sample_noise, noise)
        else:
            with obs.span("agent_update_sac"):
                self.last_metrics = learn(self.cfg, self.state, self.buffer,
                                          self.generator, sample_noise,
                                          noise,
                                          collect_diag=self.collect_diag)
            if self.buffer.cntr >= self.cfg.batch_size:
                record_update_cost("agent_update_sac", learn, self.cfg,
                                   self.state, self.buffer,
                                   self.collect_diag)
        self.last_diag = self.last_metrics.pop("diag", None)

    def _learn_native(self, uniforms=None, noise=None) -> dict:
        """The native arm: sample on the host, one copy of the minibatch to
        the device, :func:`learn_from_batch`, then the new priorities from
        ``td`` back to the tree."""
        cfg = self.cfg
        if not self.buffer.ready(cfg.batch_size):
            # the metrics of the device ring's no-learn branch
            zero = torch.zeros((), device=self.device)
            out = {"critic_loss": zero, "actor_loss": zero,
                   "alpha": self.state.alpha, "rho": self.state.rho}
            if self.collect_diag:
                out["diag"] = dg.zero_diag(self.device)
            return out
        batch, idx, is_w = self.buffer.sample(cfg.batch_size, self._rng,
                                              uniforms=uniforms)
        batch, is_w = replay_native.to_device(batch, is_w, self.device)
        if noise is None:
            noise = tuple(torch.randn((cfg.batch_size, cfg.n_actions),
                                      generator=self.generator,
                                      device=self.device)
                          for _ in range(3))
        with obs.span("agent_update_sac"):
            m = learn_from_batch(cfg, self.state, batch, is_w, noise,
                                 collect_diag=self.collect_diag)
        costs.record_stage_cost("agent_update_sac", _native_update_probe,
                                cfg, self.state, batch, is_w,
                                self.collect_diag, defer=True)
        self.buffer.update_priorities(idx, m.pop("td"))
        return m

    def save_models(self, prefix: Optional[str] = None):
        prefix = prefix if prefix is not None else self.name_prefix
        atomic_pickle(self.state.to_host(), f"{prefix}sac_state.pkl")
        if self.native:
            self.buffer.save(f"{prefix}replaymem_sac.pkl")
        else:
            rp.save_replay(self.buffer, f"{prefix}replaymem_sac.pkl")

    def load_models(self, prefix: Optional[str] = None) -> bool:
        """Resume from ``save_models`` files; a missing or corrupt state file
        warns and keeps the fresh agent (returns False)."""
        prefix = prefix if prefix is not None else self.name_prefix
        host = safe_pickle_load(f"{prefix}sac_state.pkl")
        if host is None:
            return False
        self.state = SACState.from_host(self.cfg, host, self.device)
        mem = safe_pickle_load(f"{prefix}replaymem_sac.pkl")
        if mem is not None:
            self.buffer = (replay_native.NativePER.from_state_dict(mem)
                           if self.native
                           else rp.replay_from_host(mem, self.device))
        return True
