"""Discrete-action Soft Actor-Critic (counterpart of
smartcal_tpu/rl/sac_discrete.py): the categorical agent of the distributed
demixing learner (``demixing_rl/distributed_per_sac.py:34,144,180-184``),
whose actions are the 2^(K-1) direction subsets.

* actor: categorical logits pi(a|s);
* critics: Q(s, .) over every action, so the soft value is an exact
  expectation: V(s') = sum_a pi(a|s') [min_i Q_i(s', a) - alpha log
  pi(a|s')];
* the critics step first (Adam), then the actor loss E_s sum_a pi(a|s)
  [alpha log pi(a|s) - min_i Q_i(s, a)] reads the updated critics without
  a gradient into them;
* PER priorities from |Q1 - y| of the critics before their step; targets
  move by ``tau``.

The fleet knobs are those of ``rl/sac``: ``is_clip`` weights the TD loss by
the clipped categorical ratio pi_now(a|s) / pi_behavior(a|s) of stale
transitions (exactly 1.0 at staleness 0), ``ere_eta`` biases sampling
toward recent slots.  Randomness is explicit: :func:`choose_action` takes
the Gumbel noise of the categorical draw (``jax.random.categorical`` is
``argmax(logits + gumbel)``), :func:`learn` the replay draws.
"""

import copy
import dataclasses
from typing import Optional, Tuple

import torch

from smartcal_tpu_torch import resolve_device
from smartcal_tpu_torch.obs import diagnostics as dg
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl.networks import (SplitImageMetaCategoricalActor,
                                            SplitImageMetaQVector)
from smartcal_tpu_torch.rl.sac import (AdamState, AgentState, _params,
                                       adam_init, adam_update, sample_batch,
                                       soft_update, weighted_critic_loss)


@dataclasses.dataclass(frozen=True)
class DSACConfig:
    obs_dim: int
    n_actions: int                 # 2^(K-1) subset configurations
    gamma: float = 0.99
    tau: float = 0.005
    lr_a: float = 1e-3
    lr_c: float = 1e-3
    alpha: float = 0.03
    reward_scale: float = 1.0
    batch_size: int = 64
    mem_size: int = 1024
    prioritized: bool = True       # the reference variant is distributed PER
    error_clip: float = 1.0        # demix_sac.py:160
    img_shape: Optional[Tuple[int, int]] = None
    use_image: bool = True
    is_clip: float = 0.0
    ere_eta: float = 1.0

    def __post_init__(self):
        rp.validate_fleet_knobs(self.is_clip, self.ere_eta)


def build_nets(cfg: DSACConfig, generator=None, device="cpu"):
    """(actor, critic) modules of ``cfg``'s shape, freshly initialised."""
    if cfg.img_shape is None:
        raise ValueError("discrete SAC serves the radio dict-obs envs; "
                         "set img_shape (use_image=False drops the CNN)")
    return (SplitImageMetaCategoricalActor(
                cfg.img_shape, cfg.obs_dim, cfg.n_actions,
                use_image=cfg.use_image, generator=generator, device=device),
            SplitImageMetaQVector(
                cfg.img_shape, cfg.obs_dim, cfg.n_actions,
                use_image=cfg.use_image, generator=generator, device=device))


@dataclasses.dataclass
class DSACState(AgentState):
    """Actor, critics and targets (modules), three Adam states, alpha (0-d
    tensor) and the learn counter (host int)."""
    actor: torch.nn.Module
    c1: torch.nn.Module
    c2: torch.nn.Module
    t1: torch.nn.Module
    t2: torch.nn.Module
    actor_opt: AdamState
    c1_opt: AdamState
    c2_opt: AdamState
    alpha: torch.Tensor
    learn_counter: int

    NETS = ("actor", "c1", "c2", "t1", "t2")
    OPTS = ("actor_opt", "c1_opt", "c2_opt")
    TENSORS = ("alpha",)
    INTS = ("learn_counter",)

    @staticmethod
    def build(cfg, name, device):
        return build_nets(cfg, device=device)[0 if name == "actor" else 1]


def transition_spec(obs_dim: int) -> dict:
    """Replay layout: the discrete action as one int32 index."""
    return {"state": ((obs_dim,), torch.float32),
            "action": ((), torch.int32),
            "reward": ((), torch.float32),
            "new_state": ((obs_dim,), torch.float32),
            "done": ((), torch.bool)}


def dsac_init(cfg: DSACConfig, generator=None, device="cuda") -> DSACState:
    """A fresh agent on ``device`` (default "cuda": raises without a GPU)."""
    dev = resolve_device(device)
    actor, c1 = build_nets(cfg, generator, dev)
    _, c2 = build_nets(cfg, generator, dev)
    return DSACState(
        actor=actor, c1=c1, c2=c2,
        t1=copy.deepcopy(c1).requires_grad_(False),
        t2=copy.deepcopy(c2).requires_grad_(False),
        actor_opt=adam_init(_params(actor)), c1_opt=adam_init(_params(c1)),
        c2_opt=adam_init(_params(c2)),
        alpha=torch.tensor(cfg.alpha, dtype=torch.float32, device=dev),
        learn_counter=0)


@torch.no_grad()
def choose_action(cfg: DSACConfig, st, obs, gumbel_noise=None,
                  deterministic: bool = False):
    """Sample the categorical policy (``Actor.choose_action``,
    distributed_per_sac.py:155-176): ``argmax(logits + gumbel_noise)``;
    the argmax of the logits when ``deterministic``."""
    logits = st.actor(obs)
    if deterministic:
        return torch.argmax(logits, dim=-1)
    return torch.argmax(logits + gumbel_noise, dim=-1)


@torch.no_grad()
def choose_action_logp(cfg: DSACConfig, st, obs, gumbel_noise):
    """:func:`choose_action` that also returns ``log pi(a|s)`` of the
    sampled index (the behavior log-prob a fleet actor stores)."""
    logits = st.actor(obs)
    a = torch.argmax(logits + gumbel_noise, dim=-1)
    logpi = torch.log_softmax(logits, dim=-1)
    return a, torch.gather(logpi, -1, a[..., None])[..., 0]


def impact_weights(cfg: DSACConfig, actor, batch: dict, learner_version):
    """Clipped categorical importance weights (the discrete twin of
    ``sac.impact_weights``): pi_now(a|s) / pi_behavior(a|s) under the
    current ``actor``, clipped to ``[1/is_clip, is_clip]``, exactly 1.0 at
    staleness <= 0.  Returns ``(weights, aux)``."""
    with torch.no_grad():
        logpi = torch.log_softmax(actor(batch["state"]), dim=-1)
        lp_now = torch.gather(logpi, -1,
                              batch["action"].long()[:, None])[:, 0]
        ratio = torch.exp(lp_now - batch["behavior_logp"])
    return rp.staleness_clip_weights(ratio, batch["version"],
                                     learner_version, cfg.is_clip)


def learn_from_batch(cfg: DSACConfig, st: DSACState, batch: dict, is_w,
                     collect_diag: bool = False,
                     learner_version=None) -> dict:
    """The discrete-SAC step on a sampled ``batch`` with PER weights
    ``is_w`` (B,); with ``cfg.is_clip`` the staleness weights multiply in.
    Updates ``st`` in place; returns the losses, ``td`` = |Q1 - y| and the
    clip aux (device tensors)."""
    clip_aux = {}
    if cfg.is_clip > 0:
        if learner_version is None:
            raise ValueError("cfg.is_clip armed but learn was not given "
                             "the learner_version")
        w_clip, clip_aux = impact_weights(cfg, st.actor, batch,
                                          learner_version)
        is_w = is_w * w_clip
    s, a = batch["state"], batch["action"].long()
    r = cfg.reward_scale * batch["reward"]
    s2, done = batch["new_state"], batch["done"]
    alpha = st.alpha

    with torch.no_grad():
        logits2 = st.actor(s2)
        pi2 = torch.softmax(logits2, dim=-1)
        logpi2 = torch.log_softmax(logits2, dim=-1)
        v2 = torch.sum(pi2 * (torch.minimum(st.t1(s2), st.t2(s2))
                              - alpha * logpi2), dim=-1)
        y = r + cfg.gamma * torch.where(done, 0.0, v2)

    p1, p2 = _params(st.c1), _params(st.c2)
    q1 = torch.gather(st.c1(s), -1, a[:, None])[:, 0]
    q2 = torch.gather(st.c2(s), -1, a[:, None])[:, 0]
    closs = weighted_critic_loss(cfg, q1[:, None], q2[:, None], y[:, None],
                                 is_w)
    g = torch.autograd.grad(closs, list(p1.values()) + list(p2.values()))
    if collect_diag:
        c_norm = dg.tree_norm([p1, p2])
    u1 = adam_update(st.c1_opt, p1, g[:len(p1)], cfg.lr_c)
    u2 = adam_update(st.c2_opt, p2, g[len(p1):], cfg.lr_c)

    pa = _params(st.actor)
    logits = st.actor(s)
    pi = torch.softmax(logits, dim=-1)
    logpi = torch.log_softmax(logits, dim=-1)
    with torch.no_grad():
        qmin = torch.minimum(st.c1(s), st.c2(s))
    aloss = torch.mean(torch.sum(pi * (alpha * logpi - qmin), dim=-1))
    ga = torch.autograd.grad(aloss, list(pa.values()))
    if collect_diag:
        a_norm = dg.tree_norm(pa)
    ua = adam_update(st.actor_opt, pa, ga, cfg.lr_a)

    soft_update(st.t1, st.c1, cfg.tau)
    soft_update(st.t2, st.c2, cfg.tau)
    st.learn_counter += 1
    q = q1.detach()
    out = {"critic_loss": closs.detach(), "actor_loss": aloss.detach(),
           "td": (q - y).abs(), **clip_aux}
    if collect_diag:
        out["diag"] = dg.make_diag(
            critic_loss=closs, actor_loss=aloss,
            critic_grad_norm=dg.tree_norm(g), actor_grad_norm=dg.tree_norm(ga),
            critic_update_ratio=cfg.lr_c * dg.tree_norm([u1, u2])
            / (c_norm + 1e-12),
            actor_update_ratio=cfg.lr_a * dg.tree_norm(ua) / (a_norm + 1e-12),
            q_mean=torch.mean(q), q_min=torch.min(q), q_max=torch.max(q),
            target_drift=dg.target_drift(st.c1, st.t1), alpha=alpha,
            entropy=-torch.mean(torch.sum(pi.detach() * logpi.detach(),
                                          dim=-1)))
    return out


def learn(cfg: DSACConfig, st: DSACState, buf, generator=None,
          sample_noise=None, collect_diag: bool = False,
          learner_version=None) -> dict:
    """One learn step on ``buf`` (flat or sharded): sample (PER with ERE
    modulation, ERE, or uniform; ``sample_noise`` the uniforms or Gumbel
    noise, default from ``generator``), :func:`learn_from_batch`, and the
    PER priority update.  A no-op below ``batch_size`` transitions
    (decided on the host counter).  Returns the metrics without ``td``."""
    if buf.cntr < cfg.batch_size:
        zero = torch.zeros((), device=st.alpha.device)
        out = {"critic_loss": zero, "actor_loss": zero}
        if cfg.is_clip > 0:
            out.update(rp.zero_clip_aux(st.alpha.device))
        if collect_diag:
            out["diag"] = dg.zero_diag(st.alpha.device)
        return out
    batch, idx, is_w = sample_batch(cfg, buf, generator, sample_noise)
    m = learn_from_batch(cfg, st, batch, is_w, collect_diag=collect_diag,
                         learner_version=learner_version)
    td = m.pop("td")
    if cfg.prioritized:
        rp.backend_for(buf).replay_update_priorities(buf, idx, td,
                                                     cfg.error_clip)
    return m
