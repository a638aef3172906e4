"""DDPG (counterpart of smartcal_tpu/rl/ddpg.py).

The reference DDPG agent (``elasticnet/enet_ddpg.py``,
``calibration/calib_ddpg.py``): deterministic actor and one critic with
target copies, Ornstein-Uhlenbeck exploration noise (``:23-43``) carried in
the agent state, critic loss ``||q - y||^2`` SUMMED over the batch (the
reference's ``T.norm(...)**2``, ``:281-284``), actor loss
``-mean(critic(s, actor(s)))`` against the updated critic
(``:291-297``), and soft targets with ``tau`` 0.001.

Randomness is explicit: :func:`choose_action` takes the OU step's unit
normal draw, :func:`learn` the replay's Gumbel noise; :class:`DDPGAgent`
draws them from its own ``torch.Generator``.  Inside an episode program
the counters are 0-d device tensors and "learn or not" is a select
(``rl/sac``'s module doc); the OU state is then written in place.
"""

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from smartcal_tpu_torch import obs, resolve_device
from smartcal_tpu_torch.obs import diagnostics as dg
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl.sac import (AdamState, AgentState, Kept, _host,
                                       _params, adam_init, adam_update,
                                       gate_metrics, record_update_cost,
                                       soft_update, state_tensors)
from smartcal_tpu_torch.rl.td3 import _grads, build_nets
from smartcal_tpu_torch.runtime.atomic import atomic_pickle, safe_pickle_load


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    obs_dim: int
    n_actions: int
    gamma: float = 0.99
    tau: float = 0.001
    lr_a: float = 1e-3
    lr_c: float = 1e-3
    batch_size: int = 64
    mem_size: int = 1024
    ou_sigma: float = 0.15
    ou_theta: float = 0.2
    ou_dt: float = 1e-2
    img_shape: Optional[Tuple[int, int]] = None   # see sac.SACConfig
    use_image: bool = True


@dataclasses.dataclass
class OUState:
    x_prev: torch.Tensor


def ou_init(n_actions: int, device="cpu") -> OUState:
    return OUState(x_prev=torch.zeros(n_actions, device=device))


def ou_sample(cfg: DDPGConfig, st: OUState, noise) -> Tuple[torch.Tensor,
                                                            OUState]:
    """One Ornstein-Uhlenbeck step (enet_ddpg.py:30-35), mu = 0, from the
    unit normal ``noise``."""
    x_prev = st.x_prev
    sqrt_dt = torch.sqrt(torch.full((), cfg.ou_dt, dtype=x_prev.dtype,
                                    device=x_prev.device))
    x = (x_prev - cfg.ou_theta * x_prev * cfg.ou_dt
         + cfg.ou_sigma * sqrt_dt * noise)
    return x, OUState(x_prev=x)


@dataclasses.dataclass
class DDPGState(AgentState):
    """Actor, critic and their targets (modules), two Adam states and the
    OU noise state ``noise`` (the previous draw, (n_actions,))."""
    actor: torch.nn.Module
    critic: torch.nn.Module
    t_actor: torch.nn.Module
    t_critic: torch.nn.Module
    actor_opt: AdamState
    critic_opt: AdamState
    noise: torch.Tensor

    NETS = ("actor", "critic", "t_actor", "t_critic")
    OPTS = ("actor_opt", "critic_opt")
    TENSORS = ("noise",)

    @staticmethod
    def build(cfg, name, device):
        return build_nets(cfg, device=device)[
            0 if name in ("actor", "t_actor") else 1]


def ddpg_init(cfg: DDPGConfig, generator=None, device="cuda") -> DDPGState:
    """A fresh agent on ``device`` (default "cuda": raises without a GPU)."""
    dev = resolve_device(device)
    actor, critic = build_nets(cfg, generator, dev)

    def target(m):
        return copy.deepcopy(m).requires_grad_(False)

    return DDPGState(
        actor=actor, critic=critic, t_actor=target(actor),
        t_critic=target(critic), actor_opt=adam_init(_params(actor)),
        critic_opt=adam_init(_params(critic)),
        noise=ou_init(cfg.n_actions, dev).x_prev)


@torch.no_grad()
def choose_action(cfg: DDPGConfig, st: DDPGState, obs, noise):
    """``actor(obs)`` plus OU noise (enet_ddpg.py:243-249), NOT clamped, as
    in the reference (the env clamps and penalises); advances the OU
    state."""
    n, ou = ou_sample(cfg, OUState(st.noise), noise)
    if st.carried:
        st.noise.copy_(ou.x_prev)       # device form: the captured tensor
    else:
        st.noise = ou.x_prev
    return st.actor(obs) + n


def learn_from_batch(cfg: DDPGConfig, st: DDPGState, batch: dict,
                     collect_diag: bool = False) -> dict:
    """The DDPG learn step on an already-sampled ``batch``; updates ``st``
    in place and returns the losses on the device (``collect_diag`` adds
    ``diag``, see ``rl/sac.learn_from_batch``)."""
    s, a, r, s2 = (batch[k] for k in ("state", "action", "reward",
                                      "new_state"))
    done = batch["done"].to(torch.float32)
    with torch.no_grad():
        qt = st.t_critic(s2, st.t_actor(s2)).squeeze(-1)
        y = (r + cfg.gamma * qt * (1.0 - done))[:, None]

    pc = _params(st.critic)
    q = st.critic(s, a)
    closs = torch.sum((q - y) ** 2)
    gc = _grads(closs, pc)
    if collect_diag:
        c_norm = dg.tree_norm(pc)
    uc = adam_update(st.critic_opt, pc, gc, cfg.lr_c)

    pa = _params(st.actor)
    aloss = -torch.mean(st.critic(s, st.actor(s)))
    ga = _grads(aloss, pa)
    if collect_diag:
        a_norm = dg.tree_norm(pa)
    ua = adam_update(st.actor_opt, pa, ga, cfg.lr_a)

    soft_update(st.t_actor, st.actor, cfg.tau)
    soft_update(st.t_critic, st.critic, cfg.tau)
    out = {"critic_loss": closs.detach(), "actor_loss": aloss.detach()}
    if collect_diag:
        qd = q.detach()
        out["diag"] = dg.make_diag(
            critic_loss=closs, actor_loss=aloss,
            critic_grad_norm=dg.tree_norm(gc),
            actor_grad_norm=dg.tree_norm(ga),
            critic_update_ratio=cfg.lr_c * dg.tree_norm(uc) / (c_norm
                                                               + 1e-12),
            actor_update_ratio=cfg.lr_a * dg.tree_norm(ua) / (a_norm + 1e-12),
            q_mean=torch.mean(qd), q_min=torch.min(qd), q_max=torch.max(qd),
            target_drift=dg.target_drift(st.critic, st.t_critic))
    return out


def learn(cfg: DDPGConfig, st: DDPGState, buf: rp.ReplayState,
          generator=None, sample_noise=None,
          collect_diag: bool = False) -> dict:
    """One DDPG learn step (enet_ddpg.py:251-302) on a uniform sample
    (``sample_noise``: its Gumbel noise, default from ``generator``); a
    no-op while the ring holds fewer than ``batch_size`` transitions (with
    ``collect_diag``, a zero ``diag`` then; a select on the device form)."""
    if torch.is_tensor(buf.cntr):
        learn_on = buf.cntr >= cfg.batch_size
        batch, _ = rp.replay_sample_uniform(buf, cfg.batch_size, generator,
                                            gumbel_noise=sample_noise)
        kept = Kept(state_tensors(st) + [buf.priority])
        m = learn_from_batch(cfg, st, batch, collect_diag=collect_diag)
        kept.restore_where(~learn_on)
        return gate_metrics(learn_on, m)
    if buf.cntr < cfg.batch_size:
        return _no_learn(buf, collect_diag)
    batch, _ = rp.replay_sample_uniform(buf, cfg.batch_size, generator,
                                        gumbel_noise=sample_noise)
    return learn_from_batch(cfg, st, batch, collect_diag=collect_diag)


def _no_learn(buf, collect_diag):
    """The metrics of a learn step that did not learn."""
    zero = torch.zeros((), device=buf.device)
    out = {"critic_loss": zero, "actor_loss": zero}
    if collect_diag:
        out["diag"] = dg.zero_diag(buf.device)
    return out


class DDPGAgent:
    """Stateful wrapper with the reference ``Agent`` API.  Agent, replay ring
    and generator live on ``device`` (default "cuda": raises without a
    GPU)."""

    def __init__(self, cfg: DDPGConfig, seed: int = 0, name_prefix: str = "",
                 device="cuda", collect_diag: bool = False):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state = ddpg_init(cfg, self.generator, self.device)
        self.buffer = rp.replay_init(
            cfg.mem_size, rp.transition_spec(cfg.obs_dim, cfg.n_actions),
            self.device)
        self.name_prefix = name_prefix
        self.collect_diag = collect_diag
        self.last_metrics = {}
        self.last_diag = None

    def choose_action(self, observation, noise=None):
        """An action as a numpy array; ``noise`` (the OU step's unit normal
        draw) defaults to one from the agent's generator."""
        obs = torch.as_tensor(np.asarray(observation, np.float32),
                              device=self.device)
        if noise is None:
            noise = torch.randn(self.cfg.n_actions, generator=self.generator,
                                device=self.device)
        else:
            noise = torch.as_tensor(noise, device=self.device)
        return _host(choose_action(self.cfg, self.state, obs, noise))

    def store_transition(self, state, action, reward, state_, done,
                         hint=None):
        tr = {"state": state, "action": action, "reward": reward,
              "new_state": state_, "done": done,
              "hint": np.zeros(self.cfg.n_actions, np.float32)
              if hint is None else hint}
        rp.replay_add(self.buffer, tr, priority=1.0)

    def learn(self, sample_noise=None):
        with obs.span("agent_update_ddpg"):
            self.last_metrics = learn(self.cfg, self.state, self.buffer,
                                      self.generator, sample_noise,
                                      collect_diag=self.collect_diag)
        if self.buffer.cntr >= self.cfg.batch_size:
            record_update_cost("agent_update_ddpg", learn, self.cfg,
                               self.state, self.buffer, self.collect_diag)
        self.last_diag = self.last_metrics.pop("diag", None)

    def save_models(self, prefix: Optional[str] = None):
        prefix = prefix if prefix is not None else self.name_prefix
        atomic_pickle(self.state.to_host(), f"{prefix}ddpg_state.pkl")
        rp.save_replay(self.buffer, f"{prefix}replaymem_ddpg.pkl")

    def load_models(self, prefix: Optional[str] = None) -> bool:
        """Resume from ``save_models`` files; a missing or corrupt state
        file warns and keeps the fresh agent (returns False)."""
        prefix = prefix if prefix is not None else self.name_prefix
        host = safe_pickle_load(f"{prefix}ddpg_state.pkl")
        if host is None:
            return False
        self.state = DDPGState.from_host(self.cfg, host, self.device)
        mem = safe_pickle_load(f"{prefix}replaymem_ddpg.pkl")
        if mem is not None:
            self.buffer = rp.replay_from_host(mem, self.device)
        return True
