"""Rank programs of tests/test_torch_multihost.py and
tests/test_torch_multiprocess.py, and the one-process runs they are held
against (the same code on a one-device or thread mesh).

A spawned rank imports this module by name (``parallel/multihost.launch``
pickles the function), so it imports only torch and the port at the top:
a rank pays for no JAX import unless its job reads a JAX state.  Operands
come from, and results go to, files in the job's directory.
"""

import contextlib
import os
import pickle
import time

import numpy as np
import torch

from smartcal_tpu_torch.ops import collectives
from smartcal_tpu_torch.parallel import mesh as pm
from smartcal_tpu_torch.parallel import multihost

CPU = torch.device("cpu")


@contextlib.contextmanager
def one_thread():
    """One torch intra-op thread, as every rank has: a CPU matrix product's
    bits may depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def save(out, name, obj):
    tmp = os.path.join(out, f".{name}.tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(obj, fh)
    os.replace(tmp, os.path.join(out, name))


def load(out, name):
    with open(os.path.join(out, name), "rb") as fh:
        return pickle.load(fh)


# -- collectives and the sharded ring ----------------------------------------

def psum_operand(rank):
    return torch.from_numpy(np.random.default_rng(rank).standard_normal(
        4096).astype(np.float32) * 10 ** np.float32(rank))


RING_S, RING_SIZE, RING_OBS, RING_NA, RING_B = 4, 32, 3, 2, 8


def ring_batches():
    """Store batches that cross the ring's end: 5, 11, 9, 13 rows."""
    rng = np.random.default_rng(0)
    out = []
    for n in (5, 11, 9, 13):
        out.append({
            "state": rng.standard_normal((n, RING_OBS)).astype(np.float32),
            "new_state": rng.standard_normal((n, RING_OBS)).astype(
                np.float32),
            "action": rng.uniform(-1, 1, (n, RING_NA)).astype(np.float32),
            "reward": rng.uniform(-1, 1, n).astype(np.float32),
            "done": rng.uniform(size=n) < 0.3,
            "hint": np.zeros((n, RING_NA), np.float32)})
    return out


def ring_ops(mesh=None):
    """Stores (errors, then the running max), a PER draw, an ERE-weighted
    PER draw and a uniform draw, a priority update, then the whole ring:
    on a sharded ring placed on ``mesh`` (None: one process)."""
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.rl import replay_sharded as rps

    buf = rps.place_on_mesh(rps.replay_init(
        RING_SIZE, rp.transition_spec(RING_OBS, RING_NA), RING_S,
        device=CPU), mesh)
    rng = np.random.default_rng(5)
    for i, b in enumerate(ring_batches()):
        n = len(b["reward"])
        err = torch.from_numpy(rng.standard_normal(n).astype(np.float32))
        rps.replay_add_batch(buf, b, errors=err if i % 2 == 0 else None)
    gen = torch.Generator().manual_seed(11)
    out = {}
    out["per"] = rps.replay_sample_per(buf, RING_B, gen)
    out["per_ere"] = rps.replay_sample_per(buf, RING_B, gen,
                                           recency_eta=0.9)
    out["uniform"] = rps.replay_sample_uniform(buf, RING_B, gen)
    gidx = out["per"][1]
    rps.replay_update_priorities(buf, gidx, torch.linspace(
        -2.0, 3.0, gidx.shape[0]))
    out["health"] = rps.replay_health(buf)
    out["ring"] = rps.replay_to_host(buf)
    out["local_shards"] = buf.local_shards
    return out


def thread_psum(xs):
    """The thread form's psum of ``xs`` (one operand per position) over two
    CPU positions."""
    from smartcal_tpu_torch.parallel import sharded_cal

    mesh = pm.make_mesh((len(xs),), (pm.AXIS_FREQ,),
                        devices=[CPU] * len(xs))
    f = sharded_cal.shard_map(
        lambda x, k: (collectives.psum(x[0], pm.AXIS_FREQ),
                      collectives.psum(float(k[0]) + 0.25, pm.AXIS_FREQ)),
        mesh, (pm.P(pm.AXIS_FREQ), pm.P(pm.AXIS_FREQ)), pm.P())
    return f(torch.stack(xs), np.arange(len(xs), dtype=np.float64))


def job_basics(rank, out):
    """runtime_summary and process_allgather; psum and all_gather over an
    ``fp`` axis of processes; the ``rp``-sharded ring; then a position
    that raises in a ``shard_map``: rank 1 raises in its body and leaves
    the job, rank 0 waits in a psum and must raise CollectiveError.  Rank
    0 then ends by raising (the launcher must raise)."""
    from smartcal_tpu_torch.parallel import sharded_cal

    res = {"summary": multihost.runtime_summary(),
           "ids": collectives.process_allgather(np.asarray([rank]))}
    fp = pm.make_mesh((2,), (pm.AXIS_FREQ,))
    res["mesh"] = (fp.is_process, fp.local_coords, repr(fp))
    with collectives.on_mesh(fp):
        x = psum_operand(rank)
        res["psum"] = collectives.psum(x, pm.AXIS_FREQ)
        res["psum_float"] = collectives.psum(float(rank) + 0.25,
                                             pm.AXIS_FREQ)
        res["gather"] = collectives.all_gather(x[None], pm.AXIS_FREQ)
        res["index"] = (collectives.axis_index(pm.AXIS_FREQ),
                        collectives.axis_size(pm.AXIS_FREQ))
    try:
        pm.make_mesh((2,), (pm.AXIS_FREQ,),
                     devices=[pm.RankDevice(0, CPU), CPU])
    except pm.MeshFactorizationError as e:
        res["mixed"] = str(e)
    res["ring"] = ring_ops(pm.make_mesh((2,), (pm.AXIS_REPLAY,)))

    def body(x):
        if collectives.axis_index(pm.AXIS_FREQ) == 1:
            raise ValueError("position 1 fails on purpose")
        return collectives.psum(x, pm.AXIS_FREQ)

    t0 = time.monotonic()
    try:
        sharded_cal.shard_map(body, fp, (pm.P(pm.AXIS_FREQ),), pm.P())(
            torch.ones(2, 3))
        res["raised"] = None
    except Exception as e:                 # noqa: BLE001 — recorded
        res["raised"] = (type(e).__name__, str(e))
    res["raised_after_s"] = time.monotonic() - t0
    save(out, f"basics{rank}.pkl", res)
    if rank == 0:
        raise RuntimeError("rank 0 ends with an error on purpose")


# -- the sharded calibration routes -------------------------------------------

def calib_routes(ops, mesh):
    """The sharded solve and the frequency-sharded influence image of the
    operands ``ops`` over ``mesh``."""
    from smartcal_tpu_torch.cal import solver
    from smartcal_tpu_torch.parallel import sharded_cal as tsc

    cfg = solver.SolverConfig(*ops["cfg"])
    res = tsc.solve_admm_sharded(mesh, ops["V"], ops["Ccal"], ops["freqs"],
                                 ops["f0"], ops["rho"], cfg,
                                 axis=pm.AXIS_FREQ, n_chunks=ops["n_chunks"])
    img = tsc.influence_images_sharded(
        mesh, ops["residual"], ops["Ccal"], ops["J"], ops["hall"],
        ops["freqs"], ops["uvw"], ops["cell"], ops["n_stations"],
        ops["n_chunks"], ops["npix"])
    return {"solve": tuple(res), "image": img}


def job_calib(rank, out):
    ops = load(out, "calib_ops.pkl")
    save(out, f"calib{rank}.pkl",
         calib_routes(ops, pm.make_mesh((2,), (pm.AXIS_FREQ,))))


# -- the data-parallel trainers -----------------------------------------------

TRAIN_ENV = {"M": 4, "N": 4, "lbfgs_iters": 10}
TRAIN_ENVS, TRAIN_STEPS = 4, 2
LEARNER = dict(seed=0, episodes=1, n_actors=2, env_kwargs=TRAIN_ENV,
               agent_kwargs={"batch_size": 8, "mem_size": 64}, quiet=True,
               rollout_epochs=2, rollout_steps=3, device="cpu")


def agent_cfg():
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.rl import sac

    return sac.SACConfig(obs_dim=enet.EnetConfig(**TRAIN_ENV).obs_dim,
                         n_actions=2, batch_size=4, mem_size=64,
                         prioritized=True)


def first_step_stages(mesh, agent, draws):
    """The first train step's stages up to the env's solve on JAX's draws:
    the lanes' reset (each rank its block, gathered) and the policy's
    actions on every lane with JAX's noise."""
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.parallel.trainer import DataParallel
    from smartcal_tpu_torch.rl import sac

    cfg = enet.EnetConfig(**TRAIN_ENV)
    dp = DataParallel(mesh, TRAIN_ENVS)
    st, obs = enet.reset_lanes(cfg, *(dp.local(torch.from_numpy(d))
                                      for d in draws["reset"]))
    acts = dp.act(lambda o, n: sac.choose_action(agent_cfg(), agent, o, n),
                  obs, torch.from_numpy(draws["noise"]))
    g = dp.gather({"obs": obs, "action": acts, "x0": st.x0})
    return {k: v.numpy() for k, v in g.items()}


def parallel_sac_run(mesh, agent):
    """make_parallel_sac with 4 envs, 2 train steps from ``agent``."""
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.parallel import make_parallel_sac
    from smartcal_tpu_torch.parallel.trainer import agent_digest

    init, step, _ = make_parallel_sac(enet.EnetConfig(**TRAIN_ENV),
                                      agent_cfg(), mesh, TRAIN_ENVS)
    gen = torch.Generator().manual_seed(0)
    st = init(gen)
    st.agent = agent
    rewards = []
    for _ in range(TRAIN_STEPS):
        st, m = step(st, gen)
        rewards.append(float(m["mean_reward"]))
    return {"digest": agent_digest(st.agent), "rewards": rewards,
            "ring": {k: v.numpy().copy() for k, v in st.buf.data.items()},
            "priority": st.buf.priority.numpy().copy(),
            "cntr": st.buf.cntr}


def learner_runs():
    """train_distributed for one episode: the replicated ring, the ring
    sharded in two, learning per transition."""
    from smartcal_tpu_torch.parallel import learner
    from smartcal_tpu_torch.parallel.trainer import agent_digest
    from smartcal_tpu_torch.rl import replay_sharded as rps

    out = {}
    for tag, kw in (("flat", {}), ("rp2", {"replay_shards": 2}),
                    ("per_transition", {"learn_per_transition": True})):
        st, scores = learner.train_distributed(**LEARNER, **kw)
        ring = (rps.replay_to_host(st.buf) if kw.get("replay_shards")
                else {"data": {k: v.numpy().copy()
                               for k, v in st.buf.data.items()},
                      "priority": st.buf.priority.numpy().copy()})
        out[tag] = {"digest": agent_digest(st.agent), "scores": scores,
                    "ring": ring, "learns": st.agent.learn_counter}
    return out


def jax_agent(out):
    """The JAX SAC state the parent saved, as the port's
    (``interop.sac_state_from_jax``)."""
    from smartcal_tpu_torch import interop

    return interop.sac_state_from_jax(load(out, "jax_agent.pkl"),
                                      agent_cfg())


def job_train(rank, out):
    from smartcal_tpu_torch.parallel.trainer import agent_digest

    draws = load(out, "train_draws.pkl")
    agent = jax_agent(out)
    dp = pm.make_mesh()
    save(out, f"train{rank}.pkl", {
        "loaded_digest": agent_digest(agent),
        "stages": first_step_stages(dp, agent, draws),
        "parallel_sac": parallel_sac_run(dp, jax_agent(out)),
        "learner": learner_runs()})


# -- the GPU phase (tests/test_torch_multiprocess.py, cuda marker) -----------

def job_cuda(rank, out):
    """psum against the thread form's operands and make_parallel_sac over
    two ranks on one GPU."""
    from smartcal_tpu_torch.parallel.trainer import agent_digest

    fp = pm.make_mesh((2,), (pm.AXIS_FREQ,))
    with collectives.on_mesh(fp):
        s = collectives.psum(psum_operand(rank).cuda(), pm.AXIS_FREQ)
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.parallel import make_parallel_sac

    init, step, _ = make_parallel_sac(enet.EnetConfig(**TRAIN_ENV),
                                      agent_cfg(), pm.make_mesh(),
                                      TRAIN_ENVS)
    gen = torch.Generator(device=multihost.local_device()).manual_seed(0)
    st = init(gen)
    for _ in range(TRAIN_STEPS):
        st, _ = step(st, gen)
    save(out, f"cuda{rank}.pkl", {"psum": s.cpu(),
                                  "digest": agent_digest(st.agent),
                                  "backend": multihost.backend()})
