"""The elastic-net episode programs: ``make_episode_fn`` and
``make_episode_block_fn`` of ``train/enet_sac``, ``enet_td3`` and
``enet_ddpg``, and ``train/blocks.make_block_fn`` under them.

On the CPU a program runs its body eagerly on the host counters (a gate
that is off skips its work).  On the card a CUDA graph replays the body on
the device form of the counters (0-d tensors; every decision a select), so
each program is held in both forms: as the CPU runs it, and its body on
the device form (``train/blocks.CarriedCounters``).  Two tiny episodes
(M = N = 8, 3 steps, a 16-slot ring) of each against the JAX package's
``_make_episode_body`` on JAX's draws, handed to the port in JAX's order
through a stand-in for ``enet_sac.Draws``; the env's step outputs and the
hint are JAX's, read back from JAX's ring, as in
tests/test_torch_enet_drivers.py (which says why).  Both start from an
empty ring and batch 5, so the first learn comes in the middle of the
second episode; SAC's dual update runs at counter 0 and not at 1; TD3
switches from warmup noise to its actor at time step 3, updates its actor
on the second learn only, and anneals PER's beta on both.  Held as the
drivers' test holds them: actions, parameters, targets and Adam moments
at rtol 1e-4 and an atol of 1e-5 times the array's largest magnitude,
rewards and scores at rtol 1e-6, priorities at rtol 1e-4, the counters
exactly.

Then the block program against three chained episode programs (bit for
bit), the trainer's ``--block 3`` against ``--block 1`` and ``--resume``
across a block (bit for bit), and the programs' refusal of
``eig_mode="exact"``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.envs import enet as je
from smartcal_tpu.rl import ddpg as jddpg
from smartcal_tpu.rl import replay as jr
from smartcal_tpu.rl import sac as jsac
from smartcal_tpu.rl import td3 as jtd3
from smartcal_tpu.train import enet_ddpg as jdrv_ddpg
from smartcal_tpu.train import enet_sac as jdrv_sac
from smartcal_tpu.train import enet_td3 as jdrv_td3
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.envs import enet as te
from smartcal_tpu_torch.rl import ddpg as tddpg
from smartcal_tpu_torch.rl import replay as tr
from smartcal_tpu_torch.rl import sac as tsac
from smartcal_tpu_torch.rl import td3 as ttd3
from smartcal_tpu_torch.train import enet_ddpg, enet_sac, enet_td3
from smartcal_tpu_torch.train.blocks import CarriedCounters, clone_ring

M = N = 8
NA, B, MEM, STEPS = 2, 5, 16, 3
OBS = N + N * M
RTOL, ATOL = 1e-4, 1e-5
ENV = je.EnetConfig(M=M, N=N)
TENV = te.EnetConfig(M=M, N=N)
CFG = {
    "sac": dict(obs_dim=OBS, n_actions=NA, gamma=0.99, tau=0.005,
                batch_size=B, mem_size=MEM, lr_a=1e-3, lr_c=1e-3,
                reward_scale=float(N), alpha=0.03, use_hint=True),
    "td3": dict(obs_dim=OBS, n_actions=NA, gamma=0.99, tau=0.005,
                batch_size=B, mem_size=MEM, lr_a=1e-3, lr_c=1e-3,
                update_actor_interval=2, warmup=3, noise=0.1,
                prioritized=True, use_hint=True, admm_rho=1.0),
    "ddpg": dict(obs_dim=OBS, n_actions=NA, batch_size=B, mem_size=MEM),
}



@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small ops on small batches: one intra-op thread (the suite runs six
    workers on the host's cores, and oversubscribed thread pools made
    these steps ~100x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def t(x):
    return torch.from_numpy(np.array(x))


def _leaves(d, path=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def same_state(got_host, want_host, tag):
    want = dict(_leaves(want_host))
    for k, v in _leaves(got_host):
        if isinstance(v, int):
            assert v == want[k], (tag, k)
        else:
            scale = max(1.0, float(np.max(np.abs(want[k]), initial=0.0)))
            np.testing.assert_allclose(v, want[k], rtol=RTOL,
                                       atol=ATOL * scale,
                                       err_msg=f"{tag} {k}")


def normals(key, n, shape):
    return tuple(t(jax.random.normal(k, shape))
                 for k in jax.random.split(key, n))


class JaxDraws:
    """Stands in for ``enet_sac.Draws``: the draws one JAX episode body
    makes from its key, in the order the port asks for them."""

    def __init__(self, key, kind):
        if kind == "ddpg":
            k_reset, k_scan = jax.random.split(key)
            self.normals = []
        else:
            k_reset, k_noise, k_scan = jax.random.split(key, 3)
            self.normals = [jax.random.normal(k_noise, (N,))]
        kA, kMo, kz, kidx = jax.random.split(k_reset, 4)
        self._reset = (jax.random.normal(kA, (N, M)),
                       jax.random.randint(kMo, (), 3, M),
                       jax.random.normal(kz, (M,)),
                       jax.random.randint(kidx, (M,), 0, M))
        self.learns = []
        step_keys = jax.random.split(k_scan, STEPS)
        for i in range(STEPS):
            k_act, k_env, k_learn = jax.random.split(step_keys[i], 3)
            if kind == "td3":
                self.normals += list(normals(k_act, 2, (NA,)))
                k_samp, k_smooth = jax.random.split(k_learn)
                self.learns.append({
                    "sample_noise": t(jax.random.uniform(k_samp, (B,))),
                    "smooth_noise": t(jax.random.normal(k_smooth, ()))})
            elif kind == "sac":
                self.normals.append(jax.random.normal(k_act, (NA,)))
                k_samp, k_core = jax.random.split(k_learn)
                self.learns.append({
                    "sample_noise": t(jax.random.gumbel(k_samp, (MEM,))),
                    "noise": normals(k_core, 3, (B, NA))})
            else:
                self.normals.append(jax.random.normal(k_act, (NA,)))
                self.learns.append(
                    {"sample_noise": t(jax.random.gumbel(k_learn, (MEM,)))})
            self.normals.append(jax.random.normal(k_env, (N,)))

    def reset(self, cfg):
        return tuple(t(d) for d in self._reset)

    def normal(self, shape):
        v = self.normals.pop(0)
        assert tuple(v.shape) == tuple(shape)
        return t(v)

    def learn(self):
        return self.learns.pop(0)


def replay_jax_env(monkeypatch, jbuf, first):
    """The port's env hands out what JAX's env gave (the reset obs, the
    (obs, reward) of ring slots ``first``.. and their hint)."""
    slots = iter(range(first, first + STEPS))
    reset = te.reset

    def fed_reset(cfg, *draws):
        return reset(cfg, *draws)[0], t(jbuf.data["state"][first])

    def step(cfg, st, action, noise, keepnoise=False):
        i = next(slots)
        return (st, t(jbuf.data["new_state"][i]), t(jbuf.data["reward"][i]),
                False)

    monkeypatch.setattr(te, "reset", fed_reset)
    monkeypatch.setattr(te, "step", step)
    monkeypatch.setattr(te, "get_hint",
                        lambda cfg, st: t(jbuf.data["hint"][first]))


@functools.lru_cache(maxsize=None)
def warm_jax(kind):
    """A JAX agent with Adam history (10 learns on a random ring), its
    counters back at 0, and its episode body."""
    mod = {"sac": jsac, "td3": jtd3, "ddpg": jddpg}[kind]
    jcfg = {"sac": jsac.SACConfig, "td3": jtd3.TD3Config,
            "ddpg": jddpg.DDPGConfig}[kind](**CFG[kind])
    init = {"sac": jsac.sac_init, "td3": jtd3.td3_init,
            "ddpg": jddpg.ddpg_init}[kind]
    st = jax.jit(lambda k: init(k, jcfg))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    buf = jr.replay_init(MEM, jr.transition_spec(OBS, NA))
    for _ in range(8):
        x = {"state": rng.standard_normal(OBS).astype(np.float32),
             "new_state": rng.standard_normal(OBS).astype(np.float32),
             "action": rng.uniform(-1, 1, NA).astype(np.float32),
             "reward": np.float32(rng.uniform(0, 3)), "done": False,
             "hint": rng.uniform(-1, 1, NA).astype(np.float32)}
        buf = jr.replay_add(buf, x, priority=jnp.asarray(1.0))
    learn = jax.jit(lambda s, b, k: mod.learn(jcfg, s, b, k))
    for i in range(10):
        st, buf, _ = learn(st, buf, jax.random.PRNGKey(70 + i))
    if kind == "sac":
        st = st._replace(learn_counter=jnp.asarray(0, jnp.int32),
                         rho=jnp.asarray(0.0, jnp.float32))
        body = jdrv_sac._make_episode_body(ENV, jcfg, STEPS, True)
    elif kind == "td3":
        st = st._replace(learn_counter=jnp.asarray(0, jnp.int32))
        body = jdrv_td3._make_episode_body(ENV, jcfg, STEPS, True)
    else:
        body = jdrv_ddpg._make_episode_body(ENV, jcfg, STEPS)
    return jcfg, st, jax.jit(body)


def port_program(kind, tcfg):
    if kind == "sac":
        return enet_sac.make_episode_fn(TENV, tcfg, STEPS, True)
    if kind == "td3":
        return enet_td3.make_episode_fn(TENV, tcfg, STEPS, True)
    return enet_ddpg.make_episode_fn(TENV, tcfg, STEPS)


TCFG = {"sac": tsac.SACConfig, "td3": ttd3.TD3Config,
        "ddpg": tddpg.DDPGConfig}
TO_PORT = {"sac": interop.sac_state_from_jax,
           "td3": interop.td3_state_from_jax,
           "ddpg": interop.ddpg_state_from_jax}


def run_form(program, form, st, buf, draws):
    """One episode of ``program``: as it runs on the CPU (``host``), or its
    body on the device-form counters a CUDA graph carries (``device``)."""
    if form == "host":
        return program(st, buf, draws)
    counters = CarriedCounters(st, buf)
    counters.carry()
    try:
        return program.program.body(st, buf, draws)
    finally:
        counters.release(counters.exported().tolist())


@pytest.mark.parametrize("kind", ["sac", "td3", "ddpg"])
def test_episode_program_matches_jax_body(kind, monkeypatch):
    hold_against_jax(kind, "host", monkeypatch)


@pytest.mark.parametrize("kind", ["sac", "td3", "ddpg"])
def test_episode_body_on_device_counters_matches_jax_body(kind, monkeypatch):
    hold_against_jax(kind, "device", monkeypatch)


def hold_against_jax(kind, form, monkeypatch):
    jcfg, jst, j_episode = warm_jax(kind)
    tcfg = TCFG[kind](**CFG[kind])
    tst = TO_PORT[kind](jst, tcfg)
    program = port_program(kind, tcfg)
    jbuf = jr.replay_init(MEM, jr.transition_spec(OBS, NA))
    tbuf = tr.replay_init(MEM, tr.transition_spec(OBS, NA), device="cpu")
    for ep in range(2):
        key = jax.random.PRNGKey(40 + ep)
        first = int(jbuf.cntr)
        jst, jbuf, jscore = j_episode(jst, jbuf, key)
        with monkeypatch.context() as mp:
            replay_jax_env(mp, jbuf, first)
            draws = JaxDraws(key, kind)
            tscore = run_form(program, form, tst, tbuf, draws)
        assert not draws.normals and not draws.learns
        np.testing.assert_allclose(float(tscore), float(jscore), rtol=1e-6)
        # the host counters are back, as ints, and agree
        assert isinstance(tbuf.cntr, int) and tbuf.cntr == int(jbuf.cntr)
        np.testing.assert_allclose(float(tbuf.beta), float(jbuf.beta),
                                   rtol=1e-7)
        sl = slice(first, first + STEPS)
        for k in ("state", "new_state", "action", "hint"):
            np.testing.assert_allclose(tbuf.data[k][sl].numpy(),
                                       np.asarray(jbuf.data[k][sl]),
                                       rtol=RTOL, atol=ATOL, err_msg=k)
        np.testing.assert_allclose(tbuf.data["reward"].numpy(),
                                   np.asarray(jbuf.data["reward"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(tbuf.priority.numpy(),
                                   np.asarray(jbuf.priority), rtol=RTOL)
        same_state(tst.to_host(), TO_PORT[kind](jst, tcfg).to_host(),
                   f"{kind} episode {ep}")
    # the first learn came at slot 5, mid second episode: two learns
    if kind in ("sac", "td3"):
        assert tst.learn_counter == int(jst.learn_counter) == 2
    if kind == "sac":
        assert float(tst.rho) == pytest.approx(float(jst.rho), rel=RTOL,
                                               abs=ATOL)
    if kind == "td3":
        assert tst.time_step == int(jst.time_step) == 2 * STEPS
        assert float(tbuf.beta) > jr.PER_BETA0


# -- the block program against chained episode programs -------------------

SMALL = 5
SMALL_CFG = {
    "sac": dict(obs_dim=SMALL + SMALL * SMALL, n_actions=NA, batch_size=3,
                mem_size=16, reward_scale=float(SMALL)),
    "td3": dict(obs_dim=SMALL + SMALL * SMALL, n_actions=NA, batch_size=3,
                mem_size=16, warmup=3, prioritized=True),
    "ddpg": dict(obs_dim=SMALL + SMALL * SMALL, n_actions=NA, batch_size=3,
                 mem_size=16),
}
INIT = {"sac": tsac.sac_init, "td3": ttd3.td3_init, "ddpg": tddpg.ddpg_init}


def _programs(kind, block):
    env = te.EnetConfig(M=SMALL, N=SMALL, lbfgs_iters=20)
    cfg = TCFG[kind](**SMALL_CFG[kind])
    drv = {"sac": enet_sac, "td3": enet_td3, "ddpg": enet_ddpg}[kind]
    args = (env, cfg, 2) if kind == "ddpg" else (env, cfg, 2, False)
    return cfg, drv.make_episode_fn(*args), drv.make_episode_block_fn(
        *args, block=block)


def _tensors(st, buf):
    return tsac.state_tensors(st) + [buf.priority] + list(buf.data.values())


@pytest.mark.parametrize("kind", ["sac", "td3", "ddpg"])
def test_block_program_equals_chained_episodes(kind):
    """``make_episode_block_fn(block=3)`` is three chained
    ``make_episode_fn`` calls, bit for bit: scores, every tensor of the
    agent and the ring, the counters and the generator."""
    cfg, episode, block = _programs(kind, 3)
    gen = torch.Generator().manual_seed(5)
    st = INIT[kind](cfg, gen, "cpu")
    buf = tr.replay_init(cfg.mem_size, tr.transition_spec(cfg.obs_dim, NA),
                         device="cpu")
    st_b, buf_b = st.copy_to("cpu"), clone_ring(buf)
    gen_b = torch.Generator().manual_seed(0)
    gen_b.set_state(gen.get_state())
    chained = [float(episode(st, buf, enet_sac.Draws(gen, "cpu")))
               for _ in range(3)]
    blocked = block(st_b, buf_b, enet_sac.Draws(gen_b, "cpu"))
    assert blocked.shape == (3,)
    assert blocked.tolist() == chained
    for a, b in zip(_tensors(st, buf), _tensors(st_b, buf_b)):
        assert torch.equal(a, b)
    assert (buf.cntr, float(buf.beta)) == (buf_b.cntr, float(buf_b.beta))
    assert buf.cntr == 6 and isinstance(buf_b.cntr, int)
    for k in st.INTS:
        assert getattr(st, k) == getattr(st_b, k)
    for k in st.OPTS:
        assert getattr(st, k).count == getattr(st_b, k).count
    assert torch.equal(gen.get_state(), gen_b.get_state())


# -- the trainer: --block and --resume -------------------------------------

def _trainer(tmp_path, name, extra):
    import pickle
    pre = str(tmp_path / name)
    out = enet_sac.main(["--device", "cpu", "--quiet", "--M", "4", "--N", "4",
                         "--steps", "2", "--seed", "3", "--prefix", pre]
                        + extra)
    with open(pre + "sac_state.pkl", "rb") as fh:
        state = pickle.load(fh)
    with open(pre + "scores.pkl", "rb") as fh:
        scores = pickle.load(fh)
    return out, state, scores


def _same_host(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_host(a[k], b[k])
        else:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                          err_msg=k)


def test_trainer_block_equals_block_1_and_resumes_across_a_block(tmp_path):
    """``enet_sac --block 3`` over 4 episodes (a block, then a one-episode
    program) equals ``--block 1``, and 3 episodes checkpointed at the
    block's end then ``--resume`` to 4 equal the straight run, bit for bit
    (scores and every saved array)."""
    _, s1, sc1 = _trainer(tmp_path, "b1_", ["--episodes", "4"])
    _, s3, sc3 = _trainer(tmp_path, "b3_", ["--episodes", "4", "--block",
                                            "3"])
    assert sc1 == sc3 and len(sc1) == 4
    _same_host(s1, s3)
    ck = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "1",
          "--block", "3"]
    _trainer(tmp_path, "r_", ["--episodes", "3"] + ck)
    _, sr, scr = _trainer(tmp_path, "r_", ["--episodes", "4", "--resume"]
                          + ck)
    assert scr == sc1
    _same_host(sr, s1)


def test_programs_refuse_the_exact_eig_mode():
    env = te.EnetConfig(M=SMALL, N=SMALL, eig_mode="exact")
    cfgs = {k: TCFG[k](**SMALL_CFG[k]) for k in TCFG}
    with pytest.raises(ValueError, match="cannot be captured"):
        enet_sac.make_episode_fn(env, cfgs["sac"], 2, True)
    with pytest.raises(ValueError, match="cannot be captured"):
        enet_sac.make_episode_block_fn(env, cfgs["sac"], 2, True, 3)
    with pytest.raises(ValueError, match="cannot be captured"):
        enet_td3.make_episode_fn(env, cfgs["td3"], 2, True)
    with pytest.raises(ValueError, match="cannot be captured"):
        enet_ddpg.make_episode_block_fn(env, cfgs["ddpg"], 2, 2)
