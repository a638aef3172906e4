"""Twin-Delayed DDPG (counterpart of smartcal_tpu/rl/td3.py).

The reference TD3 agent (``elasticnet/enet_td3.py``; CNN variant
``calibration/calib_td3.py``) with the JAX package's learn step:

* deterministic tanh actor, twin critics, target copies; a warmup phase of
  pure exploration noise before the actor is consulted (``:207-220``);
* target-policy smoothing by ONE clipped scalar normal per learn call
  (``:247-251``);
* the two critics step from one joint gradient of the summed loss (the JAX
  package's deliberate deviation from the reference's sequential steps);
* delayed actor and target updates every ``update_actor_interval`` learn
  calls (``:298``), decided on the host counter;
* PER: priority from the reward on store (``:199-205``), refreshed with the
  mean twin TD error of the current critics before the critic step
  (``:263-269``);
* the hint constraint as an inner ADMM loop of ``n_admm`` actor Adam steps
  with dual ascent and the adaptive-rho spectral rule behind a correlation
  gate (``:310-361``).

Randomness is explicit: :func:`choose_action` takes its two normal draws,
:func:`learn` the replay draws and the smoothing normal; :class:`TD3Agent`
draws them from its own ``torch.Generator``.  Adam is optax's, in place
(``rl/sac.adam_update``).

Inside an episode program the counters (``learn_counter``, ``time_step``,
the Adam counts and the ring's) are 0-d device tensors, and each decision
they make is a select (``rl/sac``'s module doc): the warmup choice, the
learn gate and the delayed actor update, whose changes :class:`Kept` puts
back off its cadence.
"""

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from smartcal_tpu_torch import obs, resolve_device
from smartcal_tpu_torch.obs import diagnostics as dg
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl.networks import (MLPCritic, MLPDeterministicActor,
                                            SplitImageMetaCritic,
                                            SplitImageMetaDeterministicActor)
from smartcal_tpu_torch.rl.sac import (AdamState, AgentState, Kept, _host,
                                       _params, adam_init, adam_update,
                                       gate_metrics, record_update_cost,
                                       sample_batch, soft_update,
                                       state_tensors, weighted_critic_loss)
from smartcal_tpu_torch.runtime.atomic import atomic_pickle, safe_pickle_load


@dataclasses.dataclass(frozen=True)
class TD3Config:
    obs_dim: int
    n_actions: int
    gamma: float = 0.99
    tau: float = 0.005
    lr_a: float = 1e-3
    lr_c: float = 1e-3
    batch_size: int = 64
    mem_size: int = 1024
    warmup: int = 100             # main_td3.py:20
    noise: float = 0.1            # exploration noise scale
    update_actor_interval: int = 2
    use_hint: bool = False
    admm_rho: float = 1.0         # main_td3.py:22 override of the 0.1 default
    n_admm: int = 5               # enet_td3.py:141
    adaptive_admm: bool = True
    corr_min: float = 0.5         # enet_td3.py:143
    prioritized: bool = False
    error_clip: float = 100.0
    img_shape: Optional[Tuple[int, int]] = None   # see sac.SACConfig
    use_image: bool = True
    is_clip: float = 0.0
    is_decay: float = 0.9
    ere_eta: float = 1.0

    def __post_init__(self):
        rp.validate_fleet_knobs(self.is_clip, self.ere_eta)
        if not 0.0 < self.is_decay <= 1.0:
            raise ValueError(
                f"is_decay must be in (0, 1], got {self.is_decay}")


def build_nets(cfg, generator=None, device="cpu"):
    """(actor, critic) modules of ``cfg``'s shape, freshly initialised: the
    deterministic heads of TD3 and DDPG."""
    if cfg.img_shape is not None:
        return (SplitImageMetaDeterministicActor(
                    cfg.img_shape, cfg.obs_dim, cfg.n_actions,
                    use_image=cfg.use_image, generator=generator,
                    device=device),
                SplitImageMetaCritic(cfg.img_shape, cfg.obs_dim,
                                     cfg.n_actions, use_image=cfg.use_image,
                                     generator=generator, device=device))
    return (MLPDeterministicActor(cfg.obs_dim, cfg.n_actions,
                                  generator=generator, device=device),
            MLPCritic(cfg.obs_dim, cfg.n_actions, generator=generator,
                      device=device))


@dataclasses.dataclass
class TD3State(AgentState):
    """Actor, critics and their targets (modules), three Adam states, and
    the host counters of learn calls and chosen actions."""
    actor: torch.nn.Module
    c1: torch.nn.Module
    c2: torch.nn.Module
    t_actor: torch.nn.Module
    t1: torch.nn.Module
    t2: torch.nn.Module
    actor_opt: AdamState
    c1_opt: AdamState
    c2_opt: AdamState
    learn_counter: int
    time_step: int

    NETS = ("actor", "c1", "c2", "t_actor", "t1", "t2")
    OPTS = ("actor_opt", "c1_opt", "c2_opt")
    INTS = ("learn_counter", "time_step")

    @staticmethod
    def build(cfg, name, device):
        return build_nets(cfg, device=device)[
            0 if name in ("actor", "t_actor") else 1]


def td3_init(cfg: TD3Config, generator=None, device="cuda") -> TD3State:
    """A fresh agent on ``device`` (default "cuda": raises without a GPU)."""
    dev = resolve_device(device)
    actor, c1 = build_nets(cfg, generator, dev)
    _, c2 = build_nets(cfg, generator, dev)

    def target(m):
        return copy.deepcopy(m).requires_grad_(False)

    return TD3State(
        actor=actor, c1=c1, c2=c2, t_actor=target(actor), t1=target(c1),
        t2=target(c2), actor_opt=adam_init(_params(actor)),
        c1_opt=adam_init(_params(c1)), c2_opt=adam_init(_params(c2)),
        learn_counter=0, time_step=0)


@torch.no_grad()
def choose_action(cfg: TD3Config, st: TD3State, obs, noise):
    """Warmup noise or the actor's action, plus exploration noise, clamped
    to [-1, 1] (enet_td3.py:207-220); bumps ``st.time_step``.  ``noise`` is
    the two unit normal draws (each ``obs.shape[:-1] + (n_actions,)``),
    both used every call as in the JAX package; the warmup branch is taken
    on the host counter."""
    n_random, n_explore = noise
    if torch.is_tensor(st.time_step):          # device form: a select
        mu = torch.where(st.time_step < cfg.warmup, cfg.noise * n_random,
                         st.actor(obs))
    elif st.time_step < cfg.warmup:
        mu = cfg.noise * n_random
    else:
        mu = st.actor(obs)
    st.time_step += 1
    return torch.clamp(mu + cfg.noise * n_explore, -1.0, 1.0)


def store_priority(cfg: TD3Config, reward):
    """TD3 PER initialises priority with the reward (enet_td3.py:199-205);
    None without PER."""
    if not cfg.prioritized:
        return None
    r = torch.as_tensor(reward, dtype=torch.float32)
    return torch.clamp((torch.abs(r) + rp.PER_EPSILON) ** rp.PER_ALPHA,
                       max=cfg.error_clip)


def _grads(loss, params: dict):
    return torch.autograd.grad(loss, list(params.values()),
                               allow_unused=True)


def _actor_admm_update(cfg: TD3Config, st: TD3State, s, hint, is_w):
    """Hint-constrained actor update: ``n_admm`` actor Adam steps on the
    augmented Lagrangian, dual ascent, and the adaptive-rho rule at
    iteration 3 (enet_td3.py:310-361).  At iteration 0 the rule's anchors
    y0 and a0 are both set to the flat ACTIONS (the reference's quirk, kept
    by the JAX package).  Returns the last iteration's (loss, gradients,
    actions), the update diagnostics' inputs."""
    pa = _params(st.actor)
    B = s.shape[0]
    numel = float(B * cfg.n_actions)
    y = torch.zeros(B * cfg.n_actions, device=s.device)
    y0, a0 = y, torch.zeros_like(y)
    rho = torch.full((), cfg.admm_rho, dtype=torch.float32, device=s.device)
    for admm in range(cfg.n_admm):
        actions = st.actor(s)
        q1 = st.c1(s, actions)
        if cfg.prioritized:
            aloss = -torch.mean(q1 * is_w[:, None])
        else:
            aloss = -torch.mean(q1)
        diff = (actions - hint).reshape(-1)
        lagr = torch.dot(y, diff) + rho / 2.0 * torch.mean(
            (actions - hint) ** 2)
        if cfg.prioritized:
            lagr = torch.mean(lagr * is_w)
        loss = aloss + lagr / numel
        g = _grads(loss, pa)
        adam_update(st.actor_opt, pa, g, cfg.lr_a)
        diff = diff.detach()
        y_new = y + rho * diff
        if cfg.adaptive_admm:
            a_flat = actions.detach().reshape(-1)
            if admm == 0:
                y0, a0 = a_flat, a_flat
            elif admm % 3 == 0 and admm < cfg.n_admm - 1:
                y1 = y_new + rho * diff
                dy, du = y1 - y0, a_flat - a0
                d11, d12, d22 = (torch.dot(dy, dy), torch.dot(dy, du),
                                 torch.dot(du, du))
                alpha = d12 / torch.sqrt(torch.clamp(d11 * d22, min=1e-30))
                alpha_sd = d11 / torch.where(d12 == 0, 1.0, d12)
                alpha_mg = d12 / torch.where(d22 == 0, 1.0, d22)
                alpha_hat = torch.where(2.0 * alpha_mg > alpha_sd, alpha_mg,
                                        alpha_sd - 0.5 * alpha_mg)
                ok = ((d11 > 0) & (d12 > 0) & (d22 > 0)
                      & (alpha > cfg.corr_min)
                      & (alpha_hat < 10.0 * cfg.admm_rho)
                      & (alpha_hat > 0.1 * cfg.admm_rho))
                y0, a0, rho = y1, a_flat, torch.where(ok, alpha_hat, rho)
        y = y_new
    return loss.detach(), g, actions.detach()


def learn_from_batch(cfg: TD3Config, st: TD3State, batch: dict, is_w,
                     smooth_noise, collect_diag: bool = False) -> dict:
    """The TD3 learn step on an already-sampled ``batch`` with importance
    weights ``is_w`` (B,) and the scalar unit normal ``smooth_noise``.
    Updates ``st`` in place; returns the critic loss and, under PER,
    ``td``: the mean twin TD error of the critics BEFORE their step (the
    new priority signal, enet_td3.py:263-269), all on the device.

    ``collect_diag`` adds ``diag`` (see ``rl/sac.learn_from_batch``): the
    actor fields are those of the hint ADMM's last iteration, or of the
    single plain step, and 0 on the delayed skip steps; the actor's update
    ratio is ||new - old|| / ||old|| over the whole update."""
    s, a, r, s2, done, hint = (batch[k] for k in (
        "state", "action", "reward", "new_state", "done", "hint"))
    with torch.no_grad():
        smooth = torch.clamp(0.2 * smooth_noise, -0.5, 0.5)
        ta = torch.clamp(st.t_actor(s2) + smooth, -1.0, 1.0)
        q1t = torch.where(done, 0.0, st.t1(s2, ta).squeeze(-1))
        q2t = torch.where(done, 0.0, st.t2(s2, ta).squeeze(-1))
        y = (r + cfg.gamma * torch.minimum(q1t, q2t))[:, None]
        out = {}
        if cfg.prioritized:
            out["td"] = 0.5 * (torch.abs(st.c1(s, a) - y)
                               + torch.abs(st.c2(s, a) - y)).squeeze(-1)

    p1, p2 = _params(st.c1), _params(st.c2)
    q1, q2 = st.c1(s, a), st.c2(s, a)
    closs = weighted_critic_loss(cfg, q1, q2, y, is_w)
    g = torch.autograd.grad(closs, list(p1.values()) + list(p2.values()))
    if collect_diag:
        c_norm = dg.tree_norm([p1, p2])
    u1 = adam_update(st.c1_opt, p1, g[:len(p1)], cfg.lr_c)
    u2 = adam_update(st.c2_opt, p2, g[len(p1):], cfg.lr_c)

    st.learn_counter += 1
    actor_diag = {}
    on_device = torch.is_tensor(st.learn_counter)
    if on_device:
        actor_on = torch.remainder(st.learn_counter,
                                   cfg.update_actor_interval) == 0
    if on_device or st.learn_counter % cfg.update_actor_interval == 0:
        if on_device:
            kept = Kept(state_tensors(st, ("actor", "actor_opt", "t_actor",
                                           "t1", "t2")))
        if collect_diag:
            old = [p.detach().clone() for p in st.actor.parameters()]
        if cfg.use_hint:
            aloss, ga, acts = _actor_admm_update(cfg, st, s, hint, is_w)
            hres = torch.mean((acts - hint) ** 2)
        else:
            pa = _params(st.actor)
            q1a = st.c1(s, st.actor(s))
            aloss = (-torch.mean(q1a * is_w[:, None]) if cfg.prioritized
                     else -torch.mean(q1a))
            ga = _grads(aloss, pa)
            adam_update(st.actor_opt, pa, ga, cfg.lr_a)
            hres = 0.0
        if collect_diag:
            actor_diag = dict(
                actor_loss=aloss, actor_grad_norm=dg.tree_norm(ga),
                actor_update_ratio=dg.update_ratio(torch._foreach_sub(
                    [p.detach() for p in st.actor.parameters()], old), old),
                hint_residual=hres)
        for t, o in ((st.t_actor, st.actor), (st.t1, st.c1), (st.t2, st.c2)):
            soft_update(t, o, cfg.tau)
        if on_device:
            kept.restore_where(~actor_on)
            actor_diag = {k: torch.where(actor_on, v, 0.0)
                          for k, v in actor_diag.items()}
    out["critic_loss"] = closs.detach()
    if collect_diag:
        q = q1.detach()
        out["diag"] = dg.make_diag(
            critic_loss=closs, critic_grad_norm=dg.tree_norm(g),
            critic_update_ratio=cfg.lr_c * dg.tree_norm([u1, u2])
            / (c_norm + 1e-12),
            q_mean=torch.mean(q), q_min=torch.min(q), q_max=torch.max(q),
            target_drift=dg.target_drift(st.c1, st.t1), **actor_diag)
    return out


def staleness_weights(cfg: TD3Config, batch: dict, learner_version):
    """Clipped staleness-decay weights of a versioned batch (the
    deterministic policy's stand-in for ``sac.impact_weights``):
    ``clip(is_decay ** staleness, 1/is_clip, is_clip)``, exactly 1.0 at
    staleness <= 0.  Returns ``(weights, aux)``."""
    return rp.staleness_clip_weights(lambda stale: torch.pow(cfg.is_decay,
                                                            stale),
                                     batch["version"], learner_version,
                                     cfg.is_clip)


def learn(cfg: TD3Config, st: TD3State, buf, generator=None,
          sample_noise=None, smooth_noise=None,
          collect_diag: bool = False, learner_version=None) -> dict:
    """One TD3 learn step (enet_td3.py:222-364): a no-op while the ring
    holds fewer than ``batch_size`` transitions (decided on the host
    counter).  ``sample_noise`` (Gumbel noise, or uniforms for PER/ERE) and
    the scalar ``smooth_noise`` default to draws from ``generator``.
    Updates ``st`` and ``buf`` (flat or sharded) in place; returns the
    metrics (with ``collect_diag``, ``diag``: a zero one when no learn
    happened).  ``cfg.is_clip`` with ``learner_version`` weights the critic
    loss by :func:`staleness_weights`.  On the device form (an episode
    program's) the step always runs and "learn or not" is a select."""
    if torch.is_tensor(buf.cntr):
        learn_on = buf.cntr >= cfg.batch_size
        kept = Kept(state_tensors(st) + [buf.priority, buf.beta])
        m = _learn_step(cfg, st, buf, generator, sample_noise, smooth_noise,
                        collect_diag, learner_version)
        kept.restore_where(~learn_on)
        return gate_metrics(learn_on, m)
    if buf.cntr < cfg.batch_size:
        return _no_learn(cfg, buf, collect_diag)
    return _learn_step(cfg, st, buf, generator, sample_noise, smooth_noise,
                       collect_diag, learner_version)


def _no_learn(cfg, buf, collect_diag):
    """The metrics of a learn step that did not learn."""
    out = {"critic_loss": torch.zeros((), device=buf.device)}
    if cfg.is_clip > 0:
        out.update(rp.zero_clip_aux(buf.device))
    if collect_diag:
        out["diag"] = dg.zero_diag(buf.device)
    return out


def _learn_step(cfg, st, buf, generator, sample_noise, smooth_noise,
                collect_diag, learner_version):
    """Sample, :func:`learn_from_batch`, re-prioritise: :func:`learn`
    past its gate."""
    batch, idx, is_w = sample_batch(cfg, buf, generator, sample_noise)
    clip_aux = {}
    if cfg.is_clip > 0:
        if learner_version is None:
            raise ValueError("cfg.is_clip armed but learn was not given "
                             "the learner_version")
        w_clip, clip_aux = staleness_weights(cfg, batch, learner_version)
        # staleness 0: w_clip is exactly 1.0 and is_w keeps its bits
        is_w = is_w * w_clip
    if smooth_noise is None:
        smooth_noise = torch.randn((), generator=generator,
                                   device=buf.device)
    m = learn_from_batch(cfg, st, batch, is_w, smooth_noise,
                         collect_diag=collect_diag)
    if cfg.prioritized:
        rp.backend_for(buf).replay_update_priorities(buf, idx, m.pop("td"),
                                                     cfg.error_clip)
    m.update(clip_aux)
    return m


class TD3Agent:
    """Stateful wrapper with the reference ``Agent`` API.  Agent, replay ring
    and generator live on ``device`` (default "cuda": raises without a
    GPU)."""

    def __init__(self, cfg: TD3Config, seed: int = 0, name_prefix: str = "",
                 device="cuda", collect_diag: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = td3_init(cfg, self.generator, self.device)
        self.buffer = rp.replay_init(
            cfg.mem_size, rp.transition_spec(cfg.obs_dim, cfg.n_actions),
            self.device)
        self.name_prefix = name_prefix
        self.collect_diag = collect_diag
        self.last_metrics = {}
        self.last_diag = None

    def choose_action(self, observation, noise=None):
        """An action as a numpy array; ``noise`` (the two unit normal
        draws) defaults to draws from the agent's generator."""
        obs = torch.as_tensor(np.asarray(observation, np.float32),
                              device=self.device)
        shape = obs.shape[:-1] + (self.cfg.n_actions,)
        if noise is None:
            noise = tuple(torch.randn(shape, generator=self.generator,
                                      device=self.device) for _ in range(2))
        else:
            noise = tuple(torch.as_tensor(n, device=self.device)
                          for n in noise)
        return _host(choose_action(self.cfg, self.state, obs, noise))

    def store_transition(self, state, action, reward, state_, done, hint):
        tr = {"state": state, "action": action, "reward": reward,
              "new_state": state_, "done": done, "hint": hint}
        pri = store_priority(self.cfg, reward)
        rp.replay_add(self.buffer, tr, priority=1.0 if pri is None else pri)

    def learn(self, sample_noise=None, smooth_noise=None):
        with obs.span("agent_update_td3"):
            self.last_metrics = learn(self.cfg, self.state, self.buffer,
                                      self.generator, sample_noise, smooth_noise,
                                      collect_diag=self.collect_diag)
        if self.buffer.cntr >= self.cfg.batch_size:
            record_update_cost("agent_update_td3", learn, self.cfg,
                               self.state, self.buffer, self.collect_diag)
        self.last_diag = self.last_metrics.pop("diag", None)

    def save_models(self, prefix: Optional[str] = None):
        prefix = prefix if prefix is not None else self.name_prefix
        atomic_pickle(self.state.to_host(), f"{prefix}td3_state.pkl")
        rp.save_replay(self.buffer, f"{prefix}replaymem_td3.pkl")

    def load_models(self, prefix: Optional[str] = None) -> bool:
        """Resume from ``save_models`` files; a missing or corrupt state
        file warns and keeps the fresh agent (returns False)."""
        prefix = prefix if prefix is not None else self.name_prefix
        host = safe_pickle_load(f"{prefix}td3_state.pkl")
        if host is None:
            return False
        self.state = TD3State.from_host(self.cfg, host, self.device)
        mem = safe_pickle_load(f"{prefix}replaymem_td3.pkl")
        if mem is not None:
            self.buffer = rp.replay_from_host(mem, self.device)
        return True
