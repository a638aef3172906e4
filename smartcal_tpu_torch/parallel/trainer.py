"""Synchronous batched SAC trainer (counterpart of
smartcal_tpu/parallel/trainer.py).

The JAX package shards a batch of environments over the mesh's ``dp``
axis and runs act, env step, store and learn as one SPMD program.  On one
device the ``dp`` actors are the lanes of one batched program: the E envs
step through ``envs/enet``'s lane form (their E inner solves are the lanes
of one L-BFGS solve), the E transitions go into the device ring with one
store, and one SAC learn follows.

Over a ``dp`` axis of processes (a mesh of processes, ``parallel/
multihost``; :class:`DataParallel`) each rank steps its ``E / k`` lanes.
Every random tensor is drawn at its global shape from the same generator
on every rank and sliced, so the lanes see the one-process draws; the
transitions are all-gathered in lane order into a ring every rank holds
(replicated), every rank runs the same learn, and rank 0's agent is then
broadcast to the others (the learn is not deterministic on the card), so
the replicas stay the same bits: the JAX package's replicated learner, in
which the broadcast is the sharding.

State is held in a mutable :class:`ParallelTrainState`; every function
takes a ``torch.Generator`` on the mesh's device for its draws.
``run_block`` runs whole episodes one after another on the host, each
exactly the per-step cadence of ``reset_envs`` + ``train_step``.
"""

import dataclasses
import hashlib
import time

import torch

from smartcal_tpu_torch import obs
from smartcal_tpu_torch.envs import enet
from smartcal_tpu_torch.ops import collectives
from smartcal_tpu_torch.parallel.mesh import AXIS_DATA, sharded_batch
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.rl import sac


def _instrument(fn, kind: str, env_steps_per_call: int,
                gauge_every: int = 50):
    """``fn`` with dispatch telemetry: with a RunLog active, a ``dispatch``
    event per call (the call's host seconds), the ``train_dispatches`` and
    ``env_steps`` counters, and every ``gauge_every`` calls an
    ``env_steps_per_s`` gauge over the window (the fleets' throughput
    name).  A single ``None`` check otherwise."""
    window = {"n": 0, "t0": None}

    def wrapped(*args, **kwargs):
        rl = obs.active()
        if rl is None:
            return fn(*args, **kwargs)
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        rl.log("dispatch", kind=kind,
               submit_s=round(time.perf_counter() - t0, 6),
               env_steps=env_steps_per_call)
        obs.counter_add("train_dispatches")
        obs.counter_add("env_steps", env_steps_per_call)
        if window["t0"] is None:
            window["t0"] = t0
        window["n"] += 1
        if window["n"] >= gauge_every:
            wall = time.perf_counter() - window["t0"]
            obs.gauge_set(
                "env_steps_per_s",
                round(window["n"] * env_steps_per_call / max(wall, 1e-9),
                      2), kind=kind)
            window["n"], window["t0"] = 0, None
        return out

    wrapped.__wrapped__ = fn
    return wrapped


def agent_tensors(st) -> list:
    """Every tensor of an agent state (``rl/sac.AgentState``) in one fixed
    order: each module's state dict, each Adam state's moments, the other
    tensors."""
    out = []
    for k in st.NETS:
        out.extend(getattr(st, k).state_dict().values())
    for k in st.OPTS:
        o = getattr(st, k)
        out.extend(o.mu.values())
        out.extend(o.nu.values())
    out.extend(getattr(st, k) for k in st.TENSORS)
    return out


def agent_digest(st) -> str:
    """SHA-256 of the agent's tensors' bytes and its counters: two replicas
    with the same digest hold the same bits."""
    h = hashlib.sha256()
    for t in agent_tensors(st):
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    for k in st.INTS:
        h.update(str(getattr(st, k)).encode())
    for k in st.OPTS:
        h.update(str(getattr(st, k).count).encode())
    return h.hexdigest()


class DataParallel:
    """The ``dp`` axis of a trainer's mesh.  On a mesh of processes:
    :meth:`local` slices a global batch (leading axis) to this rank's
    block (items ``start .. start + n_local - 1``), :meth:`gather` all-gathers every rank's block of a dict of
    tensors in lane order, :meth:`sync` broadcasts rank 0's agent.  On a
    mesh of one device all three are identities."""

    def __init__(self, mesh, n_items: int, axis: str = AXIS_DATA):
        k = mesh.shape[axis]
        if n_items % k != 0:
            raise ValueError(f"{n_items} envs (actors) not divisible by the "
                             f"{axis} axis {k}")
        self.mesh, self.axis = mesh, axis
        self.active = mesh.is_process and k > 1
        self.n_local = n_items // k if self.active else n_items
        self.start = (mesh.local_coords[axis] * self.n_local if self.active
                      else 0)
        self.sharding = sharded_batch(mesh, axis)

    def local(self, x):
        return self.sharding.local(x) if self.active else x

    def gather(self, tree: dict) -> dict:
        if not self.active:
            return tree
        with collectives.on_mesh(self.mesh):
            return {k: collectives.all_gather(v, self.axis)
                    for k, v in tree.items()}

    def act(self, choose, obs, noise):
        """This rank's block of ``choose(every lane's obs, noise)``: the
        policy sees the whole batch, as on one process (a matrix product's
        rounding may depend on its row count)."""
        if not self.active:
            return choose(obs, noise)
        return self.local(choose(self.gather({"o": obs})["o"], noise))

    def sync(self, agent, buf=None) -> None:
        """Rank 0's agent, and the priorities of a replicated device ring
        ``buf`` (a learn re-prioritises them), on every rank."""
        if not self.active:
            return
        ts = agent_tensors(agent)
        if isinstance(buf, rp.ReplayState):
            ts.append(buf.priority)
        collectives.process_broadcast(ts, src=0)


@dataclasses.dataclass
class ParallelTrainState:
    agent: sac.SACState
    buf: rp.ReplayState
    env_states: enet.EnetState       # lane state, leading axis n_envs
    obs: torch.Tensor                # (n_envs, obs_dim)
    hints: torch.Tensor              # (n_envs, n_actions)
    step_in_episode: int


def make_parallel_sac(env_cfg: enet.EnetConfig, agent_cfg: sac.SACConfig,
                      mesh, n_envs: int, use_hint: bool = False,
                      episode_block=None):
    """``(init_fn, train_step, reset_envs)`` on ``mesh``'s device, plus
    ``run_block`` with ``episode_block=(steps_per_episode,
    episodes_per_dispatch)``.

    One ``train_step(st, generator)`` = every env advances one step (the
    lanes of one program), the E transitions are stored, and one SAC learn
    runs; returns ``(st, metrics)`` with ``mean_reward``.
    ``run_block(st, generator)`` runs ``episodes_per_dispatch`` episodes of
    ``steps_per_episode`` steps and returns ``(st, scores)``, each score the
    mean step reward of an episode over the lanes.  ``n_envs`` must divide
    over the ``dp`` axis; on a mesh of processes the state's ``obs``,
    ``hints`` and ``env_states`` hold this rank's lanes (module doc)."""
    dp = DataParallel(mesh, n_envs)
    dev = mesh.device

    def randn(shape, generator):
        return dp.local(torch.randn((n_envs,) + shape, generator=generator,
                                    device=dev))

    def choose(agent):
        return lambda o, noise: sac.choose_action(agent_cfg, agent, o, noise)

    def _fresh_envs(generator):
        """Reset every env and draw its first noisy observation; the hint
        sees that draw, and step 0 of the episode keeps it (reference
        enetenv.py:87-90,156-158)."""
        draws = enet.reset_draws_lanes(env_cfg, n_envs, generator, dev)
        st, obs0 = enet.reset_lanes(env_cfg, *(dp.local(d) for d in draws))
        st = enet.draw_noise(env_cfg, st, randn((env_cfg.N,), generator))
        if use_hint:
            hints = enet.get_hint_lanes(env_cfg, st)
        else:
            hints = torch.zeros((dp.n_local, agent_cfg.n_actions),
                                device=dev)
        return st, obs0, hints

    def init_fn(generator) -> ParallelTrainState:
        agent = sac.sac_init(agent_cfg, generator, dev)
        buf = rp.replay_init(agent_cfg.mem_size, rp.transition_spec(
            env_cfg.obs_dim, agent_cfg.n_actions), dev)
        st, obs0, hints = _fresh_envs(generator)
        return ParallelTrainState(agent, buf, st, obs0, hints, 0)

    def train_step(st: ParallelTrainState, generator):
        actions = dp.act(choose(st.agent), st.obs, torch.randn(
            (n_envs, agent_cfg.n_actions), generator=generator, device=dev))
        first = st.step_in_episode == 0
        noise = None if first else randn((env_cfg.N,), generator)
        env_states, obs2, rewards, dones = enet.step_lanes(
            env_cfg, st.env_states, actions, noise, keepnoise=first)
        trs = dp.gather({"state": st.obs, "action": actions,
                         "reward": rewards, "new_state": obs2,
                         "done": dones, "hint": st.hints})
        rp.replay_add_batch(
            st.buf, trs, priority=None if agent_cfg.prioritized else 1.0)
        metrics = sac.learn(agent_cfg, st.agent, st.buf, generator)
        dp.sync(st.agent, st.buf)
        metrics["mean_reward"] = torch.mean(trs["reward"])
        st.env_states, st.obs = env_states, obs2
        st.step_in_episode += 1
        return st, metrics

    def reset_envs(st: ParallelTrainState, generator):
        """A new episode on every env (the host calls this every
        steps-per-episode train steps)."""
        st.env_states, st.obs, st.hints = _fresh_envs(generator)
        st.step_in_episode = 0
        return st

    train_step_i = _instrument(train_step, "train_step", dp.n_local)
    if episode_block is None:
        return init_fn, train_step_i, reset_envs

    steps_pe, eps_pd = (int(v) for v in episode_block)

    def run_block(st: ParallelTrainState, generator):
        scores = []
        for _ in range(eps_pd):
            reset_envs(st, generator)
            rs = []
            for _ in range(steps_pe):
                st, m = train_step(st, generator)
                rs.append(m["mean_reward"])
            scores.append(torch.mean(torch.stack(rs)))
        return st, torch.stack(scores)

    return init_fn, train_step_i, reset_envs, _instrument(
        run_block, "episode_block", dp.n_local * steps_pe * eps_pd)


def episode_scores(metrics_list, steps_per_episode: int):
    """Per-episode scores from per-step mean rewards."""
    rewards = [float(m["mean_reward"]) for m in metrics_list]
    return [sum(rewards[i:i + steps_per_episode]) / steps_per_episode
            for i in range(0, len(rewards), steps_per_episode)]
