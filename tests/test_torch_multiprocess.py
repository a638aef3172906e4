"""The port's parallel programs with one process per mesh position, on the
CPU: two jobs of two spawned ranks over gloo (``tests/torch_mp_jobs``),
each run once for the module, each rank with one torch thread.

* The sharded calibration routes over an ``fp`` axis of two processes
  (``job_calib``): ``solve_admm_sharded`` (shallow: ADMM 3, L-BFGS 3) and
  ``influence_images_sharded`` on tests/test_torch_sharded_cal.py's
  episode equal the port's thread route over two positions bit for bit,
  and JAX's ``shard_map`` routes on two virtual devices at that file's
  tolerances (the solve rtol 5e-3 / atol 5e-4 on J and Z, the residual's
  relative norm 1e-3, sigma_res rel 1e-3; the image's relative norm
  1e-4).
* The data-parallel trainers over a ``dp`` axis of two processes
  (``job_train``), from a JAX SAC state that every rank loads with
  ``interop.sac_state_from_jax`` (the ranks hold the same parameters):
  the first train step's stages up to the env's solve agree with JAX's
  ``make_distributed_per_sac`` rollout on a 2-device ``dp`` mesh, on its
  own keys (the lanes' reset at tests/test_torch_parallel.py's
  tolerances, x0 bit for bit and the observations rtol 2.5e-7; the
  actions rtol 1e-5 / atol 1e-6, tests/test_torch_sac.py's); past the
  solve the float32 enet step is chaotic (ROADMAP queue 3).
  ``make_parallel_sac`` (4 envs, 2 train steps) and ``train_distributed``
  (1 episode: the replicated ring, the ring sharded over an ``rp`` axis of
  the two processes, and learning per transition) equal the one-process
  run bit for bit: the agent's digest, the rewards or scores, the ring.
"""

import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mp_jobs as jobs
from smartcal_tpu.cal import imager as jimager
from smartcal_tpu.cal import influence as jinf
from smartcal_tpu.envs import enet as je
from smartcal_tpu.envs import radio as jradio
from smartcal_tpu.parallel import learner as jlearner
from smartcal_tpu.parallel import make_mesh as jmake_mesh
from smartcal_tpu.parallel import sharded_cal as jsc
from smartcal_tpu.rl import sac as jsac
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.cal import solver as tsolver
from smartcal_tpu_torch.parallel import mesh as tmesh
from smartcal_tpu_torch.parallel import multihost
from smartcal_tpu_torch.parallel.trainer import agent_digest

N_ST, NFREQ, NCH, K, NPIX = 6, 4, 4, 3, 8
JOIN_TIMEOUT_S = 240.0
TEST_TIMEOUT_S = 200


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(autouse=True)
def _deadline():
    """Each test's own timeout (the jobs are bounded by the launcher's)."""
    def expired(*_):
        raise TimeoutError(f"test ran past {TEST_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_TIMEOUT_S)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def run_job(fn, out):
    multihost.launch(fn, 2, args=(out,), device="cpu",
                     join_timeout=JOIN_TIMEOUT_S)
    return [jobs.load(out, f"{fn.__name__[4:]}{r}.pkl") for r in range(2)]


# -- the sharded calibration routes -------------------------------------------

@pytest.fixture(scope="module")
def calib(tmp_path_factory):
    """tests/test_torch_sharded_cal.py's episode; JAX's sharded solve and
    frequency-sharded image on two virtual devices; the operands the ranks
    and the thread route take (the influence on the port's single-device
    solve); the job's results."""
    backend = jradio.RadioBackend(n_stations=N_ST, n_freqs=NFREQ, n_times=8,
                                  tdelta=2, admm_iters=3, lbfgs_iters=3,
                                  init_iters=4, npix=NPIX)
    ep, mdl = backend.new_demixing_episode(jax.random.PRNGKey(3), K)
    cfg = backend._solver_cfg(K)
    jmesh = jmake_mesh((2,), ("fp",), devices=jax.devices()[:2])
    jsh = jsc.solve_admm_sharded(jmesh, ep.V, ep.Ccal, ep.obs.freqs, ep.f0,
                                 jnp.asarray(mdl.rho), cfg, axis="fp",
                                 n_chunks=backend.n_chunks)
    tep = interop.episode_from_numpy(ep)
    trho = torch.as_tensor(np.asarray(mdl.rho, np.float32))
    tref = tsolver.solve_admm(tep.V, tep.Ccal, tep.obs.freqs, tep.f0, trho,
                              tsolver.SolverConfig(*cfg), n_chunks=NCH)
    freqs = np.asarray(ep.obs.freqs)
    hall = jinf.consensus_hadd_all(mdl.rho, np.zeros(K, np.float32), freqs,
                                   ep.f0, n_poly=backend.n_poly,
                                   polytype=backend.polytype)
    uvw = np.array(ep.obs.uvw).reshape(-1, 3)
    cell = jimager.default_cell(ep.obs.uvw, float(freqs[-1]))
    jimg = jsc.influence_images_sharded(
        jmesh, jnp.asarray(tref.residual.numpy()), ep.Ccal,
        jnp.asarray(tref.J.numpy()), hall, ep.obs.freqs, jnp.asarray(uvw),
        cell, N_ST, NCH, NPIX)
    ops = dict(V=tep.V, Ccal=tep.Ccal, freqs=tep.obs.freqs, f0=tep.f0,
               rho=trho, cfg=tuple(cfg), n_chunks=NCH, residual=tref.residual,
               J=tref.J, hall=torch.as_tensor(np.array(hall)),
               uvw=torch.as_tensor(uvw), cell=cell, n_stations=N_ST,
               npix=NPIX)
    out = str(tmp_path_factory.mktemp("calib"))
    jobs.save(out, "calib_ops.pkl", ops)
    with jobs.one_thread():
        threads = jobs.calib_routes(ops, tmesh.make_mesh(
            (2,), (tmesh.AXIS_FREQ,), devices=[jobs.CPU] * 2))
    return dict(ranks=run_job(jobs.job_calib, out), threads=threads,
                jsh=jsh, jimg=jimg)


def test_sharded_solve_over_processes_matches_threads_and_jax(calib):
    want = calib["threads"]["solve"]
    jsh = calib["jsh"]
    for res in calib["ranks"]:
        for got, w in zip(res["solve"], want):
            assert torch.equal(got, w)
        out = tsolver.SolveResult(*res["solve"])
        np.testing.assert_allclose(out.Z.numpy(), np.asarray(jsh.Z),
                                   rtol=5e-3, atol=5e-4)
        np.testing.assert_allclose(out.J.numpy(), np.asarray(jsh.J),
                                   rtol=5e-3, atol=5e-4)
        assert rel(out.residual, jsh.residual) < 1e-3
        assert float(out.sigma_res) == pytest.approx(float(jsh.sigma_res),
                                                     rel=1e-3)


def test_sharded_images_over_processes_match_threads_and_jax(calib):
    for res in calib["ranks"]:
        assert res["image"].shape == (NPIX, NPIX)
        assert torch.equal(res["image"], calib["threads"]["image"])
        assert rel(res["image"], calib["jimg"]) < 1e-4


# -- the data-parallel trainers -----------------------------------------------

@pytest.fixture(scope="module")
def train(tmp_path_factory):
    """JAX's distributed learner on a 2-device dp mesh: its initial agent
    and its first rollout step's reset draws, observations and actions
    (four actors, one epoch key each); the one-process runs; the job's
    results."""
    jecfg = je.EnetConfig(**jobs.TRAIN_ENV)
    jacfg = jsac.SACConfig(obs_dim=jecfg.obs_dim, n_actions=2, batch_size=4,
                           mem_size=64, prioritized=True)
    jmesh = jmake_mesh((2,), ("dp",), devices=jax.devices()[:2])
    k_init, k_run = jax.random.split(jax.random.PRNGKey(0))
    jinit, _ = jlearner.make_distributed_per_sac(
        jecfg, jacfg, jmesh, jobs.TRAIN_ENVS, rollout_epochs=2,
        rollout_steps=3)
    jagent = jax.tree_util.tree_map(np.asarray,
                                    jax.jit(jinit)(k_init).agent)
    def first_step(k_actor):
        """Actor ``k_actor``'s epoch 0, step 0 (run_episode's keys): its
        reset draws, x0, observation, noise and action."""
        k_epoch = jax.random.split(k_actor, 2)[0]
        k_reset, _, k_scan = jax.random.split(k_epoch, 3)
        kA, kMo, kz, kidx = jax.random.split(k_reset, 4)
        raw = (jax.random.normal(kA, (jecfg.N, jecfg.M)),
               jax.random.randint(kMo, (), 3, jecfg.M),
               jax.random.normal(kz, (jecfg.M,)),
               jax.random.randint(kidx, (jecfg.M,), 0, jecfg.M))
        st, o = je.reset(jecfg, k_reset)
        k_act, _ = jax.random.split(jax.random.split(k_scan, 3)[0])
        a = jsac.choose_action(jacfg, jagent, o[None], k_act)[0]
        return raw, st.x0, o, jax.random.normal(k_act, (1, 2))[0], a

    k_roll, _ = jax.random.split(k_run)
    raw, x0, obs, noise, acts = jax.jit(jax.vmap(first_step))(
        jax.random.split(k_roll, jobs.TRAIN_ENVS))
    draws = {"reset": [np.array(r) for r in raw],
             "noise": np.array(noise)}
    out = str(tmp_path_factory.mktemp("train"))
    jobs.save(out, "jax_agent.pkl", jagent)
    jobs.save(out, "train_draws.pkl", draws)
    one = tmesh.make_mesh(devices=[jobs.CPU])
    with jobs.one_thread():
        ref = {"loaded_digest": agent_digest(jobs.jax_agent(out)),
               "stages": jobs.first_step_stages(one, jobs.jax_agent(out),
                                                draws),
               "parallel_sac": jobs.parallel_sac_run(one,
                                                     jobs.jax_agent(out)),
               "learner": jobs.learner_runs()}
    return dict(ranks=run_job(jobs.job_train, out), ref=ref,
                jax_x0=np.asarray(x0), jax_obs=np.asarray(obs),
                jax_actions=np.asarray(acts))


def test_ranks_load_the_same_jax_weights(train):
    want = train["ref"]["loaded_digest"]
    assert [r["loaded_digest"] for r in train["ranks"]] == [want, want]


def test_first_train_step_stages_match_jax(train):
    for res in train["ranks"] + [train["ref"]]:
        st = res["stages"]
        np.testing.assert_array_equal(st["x0"], train["jax_x0"])
        np.testing.assert_allclose(st["obs"], train["jax_obs"], rtol=2.5e-7)
        np.testing.assert_allclose(st["action"], train["jax_actions"],
                                   rtol=1e-5, atol=1e-6)
    for res in train["ranks"]:
        for k, v in train["ref"]["stages"].items():
            np.testing.assert_array_equal(res["stages"][k], v)


def test_parallel_sac_over_processes_equals_one_process(train):
    want = train["ref"]["parallel_sac"]
    assert want["cntr"] == jobs.TRAIN_ENVS * jobs.TRAIN_STEPS
    for res in train["ranks"]:
        got = res["parallel_sac"]
        assert got["digest"] == want["digest"]
        assert got["rewards"] == want["rewards"]
        assert got["cntr"] == want["cntr"]
        np.testing.assert_array_equal(got["priority"], want["priority"])
        for k, v in want["ring"].items():
            np.testing.assert_array_equal(got["ring"][k], v)


@pytest.mark.parametrize("tag", ["flat", "rp2", "per_transition"])
def test_train_distributed_over_processes_equals_one_process(train, tag):
    want = train["ref"]["learner"][tag]
    assert want["learns"] >= 1
    for res in train["ranks"]:
        got = res["learner"][tag]
        assert got["digest"] == want["digest"]
        assert got["scores"] == want["scores"]
        assert got["learns"] == want["learns"]
        np.testing.assert_array_equal(got["ring"]["priority"],
                                      want["ring"]["priority"])
        for k, v in want["ring"]["data"].items():
            np.testing.assert_array_equal(got["ring"]["data"][k], v)
