"""The port's demixing learner (``parallel/demix_learner``) and discrete
SAC (``rl/sac_discrete``) against the JAX package's, on the demixing
trainers' ``--small`` tier (N=6, Nf=3, T=4, tdelta=2, npix=16), K=3.

* ``mask_table`` equal; ``make_workloads`` from one key: frequencies and
  f0 equal, rho, the metadata and uvw at the coordinate tolerance of
  tests/test_torch_demixing.py (rtol 1e-5 / atol 1e-7), the cell rtol
  1e-6, the target cluster's coherencies relative 5e-4 (the episode
  tolerance; the A-team clusters and V are held there, not here);
* the categorical actor and Q-vector heads against flax's on carried
  parameters (``interop.dsac_state_from_jax``), rtol 1e-5 / atol 1e-6;
* 12 DSAC learn steps (PER, and PER with the IS-clip and ERE on a
  versioned ring) from an Adam-warm state on JAX's draws, at the SAC
  parity tolerance of tests/test_torch_sac.py;
* an actor rollout's first observation (the influence map, its
  metadata) and its step reward around ``r0`` on JAX's handed-over solves
  (the port's solve replaced by JAX's on the same operands), the map at
  the imager tolerance rtol 2e-4 / atol 2e-5 of max|map| and the rest
  rtol 1e-5 / atol 1e-6;
* ``train_supervised_demix`` for one round with one thread actor, and
  ``train_distributed_demix`` for one episode, on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import imager as jimager
from smartcal_tpu.cal import influence as jinf
from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu.parallel import demix_learner as jdl
from smartcal_tpu.rl import replay as jr
from smartcal_tpu.rl import sac_discrete as jdsac
from smartcal_tpu_torch import interop, prng
from smartcal_tpu_torch.cal import solver as tsolver
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.parallel import demix_learner as tdl
from smartcal_tpu_torch.rl import replay as tr
from smartcal_tpu_torch.rl import sac_discrete as tdsac

SMALL = dict(n_stations=6, n_freqs=3, n_times=4, tdelta=2, npix=16,
             admm_iters=2, lbfgs_iters=3, init_iters=4)
K = 3
NA = 2 ** (K - 1)
OBS = 16 * 16 + 3 * K + 2
RTOL, ATOL = 1e-4, 1e-5
B, MEM = 4, 16


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small ops on small batches: one intra-op thread for the module, its
    fixtures included (the suite runs six workers on the host's cores, and
    their oversubscribed thread pools slowed this file's trainers several
    times over)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.from_numpy(np.array(x))


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.fixture(scope="module")
def backends():
    return JaxBackend(shard=False, **SMALL), RadioBackend(device="cpu",
                                                          **SMALL)


@pytest.fixture(scope="module")
def workloads(backends):
    jb, tb = backends
    key = jax.random.PRNGKey(7)
    return (jdl.make_workloads(jb, K, 2, 1, key),
            tdl.make_workloads(tb, K, 2, 1, prng.PRNGKey(7)))


def test_mask_table_and_workloads_match(workloads):
    np.testing.assert_array_equal(tdl.mask_table(K), jdl.mask_table(K))
    np.testing.assert_array_equal(tdl.mask_table(4), jdl.mask_table(4))
    jw, tw = workloads
    for f in ("freqs", "f0"):
        np.testing.assert_array_equal(getattr(tw, f).numpy(),
                                      np.asarray(getattr(jw, f)), f)
    for f in ("rho", "metadata", "uvw"):
        np.testing.assert_allclose(getattr(tw, f).numpy(),
                                   np.asarray(getattr(jw, f)), rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    np.testing.assert_allclose(tw.cell.numpy(), np.asarray(jw.cell),
                               rtol=1e-6)
    np.testing.assert_array_equal(tw.freqs_host, np.asarray(jw.freqs))
    assert rel(tw.Ccal.numpy()[..., K - 1, :, :, :],
               np.asarray(jw.Ccal)[..., K - 1, :, :, :]) < 5e-4
    assert tw.V.shape == jw.V.shape


def dsac_cfgs(**kw):
    kw = dict(obs_dim=OBS, n_actions=NA, img_shape=(16, 16), batch_size=B,
              mem_size=MEM, **kw)
    return jdsac.DSACConfig(**kw), tdsac.DSACConfig(**kw)


@functools.lru_cache(maxsize=None)
def jax_learn(jcfg, lv=None):
    """One jit of JAX's DSAC learn per configuration."""
    return jax.jit(lambda s, b, k: jdsac.learn(jcfg, s, b, k,
                                               learner_version=lv))


@pytest.fixture(scope="module")
def warm_state():
    """JAX's DSAC agent after 6 learn steps, its counter set back to 0
    (Adam history: see tests/test_torch_sac.py)."""
    jcfg, _ = dsac_cfgs()
    st = jax.jit(lambda k: jdsac.dsac_init(k, jcfg))(jax.random.PRNGKey(0))
    jb, _ = rings(jcfg, seed=4)
    step = jax_learn(jcfg)
    for i in range(6):
        st, jb, _ = step(st, jb, jax.random.PRNGKey(30 + i))
    return st._replace(learn_counter=jnp.asarray(0, jnp.int32))


def test_categorical_heads_match_flax(warm_state):
    jcfg, tcfg = dsac_cfgs()
    tst = interop.dsac_state_from_jax(warm_state, tcfg)
    x = np.random.default_rng(0).standard_normal((5, OBS)).astype(np.float32)
    actor, critic = jdsac._nets(jcfg)
    jl = actor.apply({"params": warm_state.actor_params}, jnp.asarray(x))
    jq = critic.apply({"params": warm_state.c1_params}, jnp.asarray(x))
    with torch.no_grad():
        np.testing.assert_allclose(tst.actor(t(x)).numpy(), np.asarray(jl),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(tst.c1(t(x)).numpy(), np.asarray(jq),
                                   rtol=1e-5, atol=1e-6)
    # the deterministic head and the sampled one on JAX's Gumbel draw
    g = jax.random.gumbel(jax.random.PRNGKey(3), (5, NA))
    np.testing.assert_array_equal(
        tdsac.choose_action(tcfg, tst, t(x), t(g)).numpy(),
        np.asarray(jnp.argmax(jl + g, axis=-1)))
    np.testing.assert_array_equal(
        tdsac.choose_action(tcfg, tst, t(x), deterministic=True).numpy(),
        np.asarray(jdsac.choose_action(jcfg, warm_state, jnp.asarray(x),
                                       None, deterministic=True)))


def rings(jcfg, n=13, seed=1):
    """A JAX ring and a port ring with the same ``n`` transitions
    (versioned, versions 1..4, when ``jcfg.is_clip`` is armed)."""
    rng = np.random.default_rng(seed)
    spec = jdsac.transition_spec(OBS)
    tspec = tdsac.transition_spec(OBS)
    if jcfg.is_clip > 0:
        spec, tspec = jr.versioned_spec(spec), tr.versioned_spec(tspec)
    jb, tb = jr.replay_init(MEM, spec), tr.replay_init(MEM, tspec,
                                                       device="cpu")
    for _ in range(n):
        x = {"state": rng.standard_normal(OBS).astype(np.float32),
             "action": np.int32(rng.integers(0, NA)),
             "reward": np.float32(rng.uniform(-1, 1)),
             "new_state": rng.standard_normal(OBS).astype(np.float32),
             "done": bool(rng.uniform() < 0.2)}
        if jcfg.is_clip > 0:
            x["version"] = np.int32(rng.integers(1, 5))
            x["behavior_logp"] = np.float32(np.log(1.0 / NA)
                                            + rng.uniform(-1.5, 1.5))
        jb = jr.replay_add(jb, x)
        tr.replay_add(tb, x)
    return jb, tb


@pytest.mark.parametrize("knobs", [{}, {"is_clip": 2.0, "ere_eta": 0.98}])
def test_twelve_dsac_learn_steps_match(knobs, warm_state):
    jcfg, tcfg = dsac_cfgs(**knobs)
    jst = warm_state
    tst = interop.dsac_state_from_jax(jst, tcfg)
    jb, tb = rings(jcfg)
    lv = 4 if jcfg.is_clip > 0 else None
    step = jax_learn(jcfg, lv)
    for i in range(12):
        key = jax.random.PRNGKey(100 + i)
        jst, jb, jm = step(jst, jb, key)
        u = t(jax.random.uniform(jax.random.split(key)[0], (B,)))
        tm = tdsac.learn(tcfg, tst, tb, sample_noise=u, learner_version=lv)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {k}")
    want = interop.dsac_state_from_jax(jst, tcfg).to_host()
    got = tst.to_host()
    for name in tdsac.DSACState.NETS:
        for k, w in want[name].items():
            np.testing.assert_allclose(got[name][k], w, rtol=RTOL,
                                       atol=ATOL, err_msg=f"{name} {k}")
    assert got["learn_counter"] == int(jst.learn_counter) == 12
    np.testing.assert_allclose(tb.priority.numpy(), np.asarray(jb.priority),
                               rtol=RTOL)


def jax_obs(jb):
    """The JAX learner's observation (``make_demix_actor_rollout._obs``)
    of one workload episode, a solve and a mask, as (map, metadata)."""
    fn = jax.jit(lambda e, r, m: _jax_obs(jb, e, r, m))

    def obs(ep, res, mask):
        img, md = fn(ep, res, mask)
        return np.asarray(img), np.asarray(md)

    return obs


def _jax_obs(jb, ep, res, mask):
    rho_m = ep.rho * mask + (1.0 - mask)
    imgs = []
    for fi in range(jb.n_freqs):
        hadd = jinf.consensus_hadd_scalars(
            rho_m, jnp.zeros(K), ep.freqs, ep.f0, fi, n_poly=jb.n_poly,
            polytype=jb.polytype)
        inf = jinf.influence_visibilities(
            jsolver.residual_to_kernel(res.residual[fi]), ep.Ccal[fi],
            res.J[fi], hadd, jb.n_stations, jb.n_chunks)
        imgs.append(jimager.dirty_image_sr_xla(
            ep.uvw.reshape(-1, 3), jinf.stokes_i_influence(inf.vis),
            ep.freqs[fi], ep.cell, npix=jb.npix))
    img = jnp.mean(jnp.stack(imgs), axis=0) * 1e-3
    md = ep.metadata.at[:K].set(jnp.where(mask > 0, 0.0, ep.metadata[:K]))
    return img.reshape(-1), md * 1e-3


def test_rollout_first_observation_and_reward_on_jax_solves(
        backends, workloads, monkeypatch):
    jb, tb = backends
    jw, _ = workloads
    # the port's rollout on JAX's workload (lane 0), its solves JAX's
    tw = tdl.DemixWorkload(
        *(t(np.asarray(getattr(jw, f))[0]) for f in jdl.DemixWorkload._fields),
        freqs_host=np.asarray(jw.freqs)[0], cell_host=np.asarray(jw.cell)[0])
    ep = jax.tree_util.tree_map(lambda x: x[0, 0], jw)
    cfg = jsolver.SolverConfig(
        n_stations=jb.n_stations, n_dirs=K, n_poly=jb.n_poly,
        admm_iters=jb.admm_iters, lbfgs_iters=jb.lbfgs_iters,
        init_iters=jb.init_iters, polytype=jb.polytype)
    solve = jax.jit(lambda V, C, r: jsolver.solve_admm(
        V, C, ep.freqs, ep.f0, r, cfg, n_chunks=jb.n_chunks,
        admm_iters=jnp.asarray(10)))
    solves = []

    def handed_over(V, C, freqs, f0, rho, scfg, n_chunks=None,
                    admm_iters=None):
        res = solve(jnp.asarray(V.numpy()), jnp.asarray(C.numpy()),
                    jnp.asarray(rho.numpy()))
        solves.append(res)
        return interop.solve_result_from_numpy(res)

    monkeypatch.setattr(tsolver, "solve_admm", handed_over)
    a_full = NA - 1                      # every direction
    monkeypatch.setattr(tdsac, "choose_action",
                        lambda *a, **k: torch.tensor([a_full]))
    _, tcfg = dsac_cfgs()
    tst = tdsac.dsac_init(tcfg, torch.Generator().manual_seed(0), "cpu")
    rollout = tdl.make_demix_actor_rollout(tb, K, tcfg, 1, 1,
                                           provide_influence=True)
    trs = rollout(tst, tw, torch.Generator().manual_seed(1))
    assert len(solves) == 2
    tbl = jnp.asarray(jdl.mask_table(K))
    obs = jax_obs(jb)
    img0, md0 = obs(ep, solves[0], tbl[0])
    img1, md1 = obs(ep, solves[1], tbl[a_full])
    npix2 = 16 * 16
    for got, img, md in ((trs["state"][0], img0, md0),
                         (trs["new_state"][0], img1, md1)):
        got = got.numpy()
        np.testing.assert_allclose(got[:npix2], img, rtol=2e-4,
                                   atol=2e-5 * np.abs(img).max())
        np.testing.assert_allclose(got[npix2:], md, rtol=1e-5, atol=1e-6)
    N, maxiter = jb.n_stations, 10
    std_data = float(jb.noise_std(ep.V))

    def aic(res, k):
        s = float(jb.noise_std(res.residual))
        r = -N * N * s ** 2 / (std_data ** 2 + 0.01) - k * N
        return (r + 859.0) / 3559.0 - maxiter / 100.0

    r0 = aic(solves[0], 1.0)
    np.testing.assert_allclose(float(trs["reward"][0]),
                               aic(solves[1], float(K)) - r0, rtol=1e-5,
                               atol=1e-6)
    assert int(trs["action"][0]) == a_full and not bool(trs["done"][0])


def test_supervised_and_distributed_demix_run(backends):
    _, tb = backends
    (st, buf), scores, summary = tdl.train_supervised_demix(
        seed=0, episodes=1, n_actors=1, K=K, backend=tb,
        provide_influence=True, rollout_epochs=1, rollout_steps=2,
        is_clip=2.0, quiet=True, device="cpu",
        agent_kwargs={"batch_size": 2, "mem_size": 16})
    assert len(scores) == 1 and np.isfinite(scores[0])
    assert buf.cntr == 2 and st.learn_counter == 1
    assert summary["alive_at_exit"] == 0 and summary["restarts"] == 0
    st, scores = tdl.train_distributed_demix(
        seed=0, episodes=1, n_actors=2, K=K, backend=tb, rollout_epochs=1,
        rollout_steps=1, quiet=True, device="cpu",
        agent_kwargs={"batch_size": 2, "mem_size": 16})
    assert len(scores) == 1 and st.buf.cntr == 2


def test_fleet_payload_from_jax(warm_state):
    """A JAX demixing fleet's checkpoint payload (``kind`` "fleet": the
    DSAC state, a flat ring, the learner version and the actors'
    iterations) becomes the port's, which the port's fleet loop
    restores."""
    from smartcal_tpu.runtime import pack_replay as jax_pack
    from smartcal_tpu_torch.runtime import unpack_replay

    jcfg, tcfg = dsac_cfgs()
    jb, _ = rings(jcfg)
    payload = {"kind": "fleet", "episode": 3, "scores": [0.1, 0.2, 0.3],
               "agent_state": jax.device_get(warm_state),
               "replay": jax_pack(jb), "key": jax.random.PRNGKey(4),
               "learner_version": 3, "actor_iterations": {0: 2, 1: 4}}
    out = interop.agent_loop_from_jax(payload, tcfg)
    assert out["kind"] == "fleet" and out["episode"] == 3
    assert out["learner_version"] == 3
    assert out["actor_iterations"] == {0: 2, 1: 4}
    st = tdsac.DSACState.from_host(tcfg, out["agent_state"], "cpu")
    want = interop.dsac_state_from_jax(warm_state, tcfg).to_host()
    for k, v in want["actor"].items():
        np.testing.assert_array_equal(st.to_host()["actor"][k], v)
    ring = unpack_replay(out["replay"], "cpu")
    assert ring.cntr == int(jb.cntr)
    np.testing.assert_array_equal(ring.data["action"][:ring.filled].numpy(),
                                  np.asarray(jb.data["action"])[:ring.filled])
