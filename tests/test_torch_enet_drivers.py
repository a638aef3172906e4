"""The elastic-net slice as a whole and the six new trainers.

Two tiny fused episodes (M = N = 8, 3 steps each, batch 4, a 16-slot
ring) of the port's ``train/enet_sac.run_episode`` and
``train/enet_td3.run_episode`` against the JAX package's
``_make_episode_body`` on the JAX package's draws: the port takes the
draws JAX made from its keys, in JAX's order, through a stand-in for
``enet_sac.Draws``.  The env's step outputs (obs, reward) and the hint
are JAX's, read back from JAX's ring: float32 round-off parts the two
packages' env solves (tests/test_torch_enet.py, ROADMAP queue 3), so the
env enters only stage by stage there; the reset obs is JAX's too (the
port's reset runs on the fed draws, its A within 2 ulps of JAX's).
Everything else is the port's own: the draw order, action choice (SAC's sample;
TD3's warmup switch at time step 3), the transitions stored (TD3's PER
priority from the reward), and the learn steps (SAC's dual update at
counter 0; TD3's delayed ADMM actor update at counter 2).  Both agents
start from a carried JAX state with Adam history (tests/test_torch_sac.py
says why).  Actions, every parameter, target and Adam moment are held at
rtol 1e-4 and an atol of 1e-5 times the array's largest magnitude (at
least 1e-5) after each episode: the env's rewards, scaled by N, give the
critics' Adam moments entries near 40, and float32 round-off in their
sums then reaches ~3e-5 on an entry near 0.1.  The stored rewards and
episode scores are held at rtol 1e-6, the PER priorities (which the learn
steps refresh from the critics) at rtol 1e-4.

Then every trainer end to end on the CPU at small size, every obs and
runtime flag acting in every trainer, and every entry point asking for
cuda by default.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.envs import enet as je
from smartcal_tpu.rl import replay as jr
from smartcal_tpu.rl import sac as jsac
from smartcal_tpu.rl import td3 as jtd3
from smartcal_tpu.train import enet_sac as jdrv_sac
from smartcal_tpu.train import enet_td3 as jdrv_td3
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.envs import enet as te
from smartcal_tpu_torch.rl import replay as tr
from smartcal_tpu_torch.rl import sac as tsac
from smartcal_tpu_torch.rl import td3 as ttd3
from smartcal_tpu_torch.train import (calib_ddpg, calib_td3, enet_ddpg,
                                      enet_eval, enet_sac, enet_td3)

M = N = 8
NA, B, MEM, STEPS = 2, 4, 16, 3
OBS = N + N * M
RTOL, ATOL = 1e-4, 1e-5
ENV = je.EnetConfig(M=M, N=N)
TENV = te.EnetConfig(M=M, N=N)
SAC = dict(obs_dim=OBS, n_actions=NA, gamma=0.99, tau=0.005, batch_size=B,
           mem_size=MEM, lr_a=1e-3, lr_c=1e-3, reward_scale=float(N),
           alpha=0.03, use_hint=True)
TD3 = dict(obs_dim=OBS, n_actions=NA, gamma=0.99, tau=0.005, batch_size=B,
           mem_size=MEM, lr_a=1e-3, lr_c=1e-3, update_actor_interval=2,
           warmup=3, noise=0.1, prioritized=True, use_hint=True,
           admm_rho=1.0)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Small ops on small batches: one intra-op thread (the suite runs six
    workers on the host's cores, and their oversubscribed thread pools
    slowed the full-width trainers' run several times over)."""
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
    """``n`` unit normal draws of ``shape`` from the split of ``key``."""
    return tuple(t(jax.random.normal(k, shape))
                 for k in jax.random.split(key, n))


class JaxDraws:
    """Stands in for ``enet_sac.Draws``: the draws one JAX fused episode
    makes from its key, handed out in the order the port asks for them
    (each normal's shape is checked against JAX's)."""

    def __init__(self, key, td3):
        k_reset, k_noise, k_scan = jax.random.split(key, 3)
        kA, kMo, kz, kidx = jax.random.split(k_reset, 4)
        self._reset = (jax.random.normal(kA, (N, M)),
                       jax.random.randint(kMo, (), 3, M),
                       jax.random.normal(kz, (M,)),
                       jax.random.randint(kidx, (M,), 0, M))
        self.normals = [jax.random.normal(k_noise, (N,))]
        self.learns = []
        step_keys = jax.random.split(k_scan, STEPS)
        for i in range(STEPS):
            k_act, k_env, k_learn = jax.random.split(step_keys[i], 3)
            if td3:
                self.normals += list(normals(k_act, 2, (NA,)))
                k_samp, k_smooth = jax.random.split(k_learn)
                self.learns.append({
                    "sample_noise": t(jax.random.uniform(k_samp, (B,))),
                    "smooth_noise": t(jax.random.normal(k_smooth, ()))})
            else:
                self.normals.append(jax.random.normal(k_act, (NA,)))
                k_samp, k_core = jax.random.split(k_learn)
                self.learns.append({
                    "sample_noise": t(jax.random.gumbel(k_samp, (MEM,))),
                    "noise": normals(k_core, 3, (B, NA))})
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
    """Make the port's env hand out what JAX's env gave: the reset obs, the
    (obs, reward) of ring slots ``first``.. and their hint.  The port's
    reset still runs on the fed draws; its obs differs from JAX's by up to
    2 ulps of A (tests/test_torch_enet.py), which the critics' large
    gradients would carry past atol 1e-5."""
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


def fill_jax(jcfg, n, add, seed=0):
    rng = np.random.default_rng(seed)
    buf = jr.replay_init(MEM, jr.transition_spec(OBS, NA))
    for _ in range(n):
        tr_ = {"state": rng.standard_normal(OBS).astype(np.float32),
               "new_state": rng.standard_normal(OBS).astype(np.float32),
               "action": rng.uniform(-1, 1, NA).astype(np.float32),
               "reward": np.float32(rng.uniform(0, 3)), "done": False,
               "hint": rng.uniform(-1, 1, NA).astype(np.float32)}
        buf = add(buf, tr_)
    return buf


def check_episodes(monkeypatch, jst, j_episode, t_episode, tst, tcfg,
                   to_port, td3):
    jbuf = jr.replay_init(MEM, jr.transition_spec(OBS, NA))
    tbuf = tr.replay_init(MEM, tr.transition_spec(OBS, NA), device="cpu")
    for ep in range(2):
        key = jax.random.PRNGKey(40 + ep)
        first = int(jbuf.cntr)
        jst, jbuf, jscore = j_episode(jst, jbuf, key)
        with monkeypatch.context() as mp:
            replay_jax_env(mp, jbuf, first)
            draws = JaxDraws(key, td3)
            tscore = t_episode(TENV, tcfg, tst, tbuf, draws, STEPS, True)
        assert not draws.normals and not draws.learns
        np.testing.assert_allclose(float(tscore), float(jscore), rtol=1e-6)
        assert tbuf.cntr == int(jbuf.cntr) == first + STEPS
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
        same_state(tst.to_host(), to_port(jst).to_host(), f"episode {ep}")
    return tst


def test_fused_sac_episodes_match_jax(monkeypatch):
    jcfg, tcfg = jsac.SACConfig(**SAC), tsac.SACConfig(**SAC)
    st = jax.jit(lambda k: jsac.sac_init(k, jcfg))(jax.random.PRNGKey(0))
    buf = fill_jax(jcfg, 8, lambda b, x: jr.replay_add(
        b, x, priority=jnp.asarray(1.0)))
    learn = jax.jit(lambda s, b, k: jsac.learn(jcfg, s, b, k))
    for i in range(10):
        st, buf, _ = learn(st, buf, jax.random.PRNGKey(70 + i))
    jst = st._replace(learn_counter=jnp.asarray(0, jnp.int32),
                      rho=jnp.asarray(0.0, jnp.float32))
    tst = interop.sac_state_from_jax(jst, tcfg)
    tst = check_episodes(
        monkeypatch, jst,
        jax.jit(jdrv_sac._make_episode_body(ENV, jcfg, STEPS, True)),
        enet_sac.run_episode, tst, tcfg,
        lambda s: interop.sac_state_from_jax(s, tcfg), td3=False)
    assert tst.learn_counter == 3 and float(tst.rho) >= 0.0


def test_fused_td3_episodes_match_jax(monkeypatch):
    jcfg, tcfg = jtd3.TD3Config(**TD3), ttd3.TD3Config(**TD3)
    st = jax.jit(lambda k: jtd3.td3_init(k, jcfg))(jax.random.PRNGKey(0))
    buf = fill_jax(jcfg, 8, lambda b, x: jr.replay_add(
        b, x, priority=jtd3.store_priority(jcfg, jnp.asarray(x["reward"]))))
    learn = jax.jit(lambda s, b, k: jtd3.learn(jcfg, s, b, k))
    for i in range(10):
        st, buf, _ = learn(st, buf, jax.random.PRNGKey(70 + i))
    jst = st._replace(learn_counter=jnp.asarray(0, jnp.int32))
    tst = interop.td3_state_from_jax(jst, tcfg)
    tst = check_episodes(
        monkeypatch, jst,
        jax.jit(jdrv_td3._make_episode_body(ENV, jcfg, STEPS, True)),
        enet_td3.run_episode, tst, tcfg,
        lambda s: interop.td3_state_from_jax(s, tcfg), td3=True)
    assert tst.learn_counter == 3 and tst.time_step == 2 * STEPS


# -- the trainers on the CPU ------------------------------------------------

def test_enet_trainers_run_on_cpu(tmp_path, capsys):
    pre = str(tmp_path / "e_")
    common = ["--episodes", "1", "--steps", "1", "--device", "cpu",
              "--quiet"]
    out = enet_sac.main(common + ["--use_hint", "--prefix", pre])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == out
    assert set(out) == {"episodes", "steps_per_episode", "wall_s",
                        "env_steps_per_sec", "final_avg_score"}
    assert np.isfinite(out["final_avg_score"])
    for f in ("sac_state.pkl", "replaymem_sac.pkl", "scores.pkl"):
        assert (tmp_path / f"e_{f}").exists(), f
    scores = enet_sac.main(common + ["--mode", "loop"])
    assert len(scores) == 1 and np.isfinite(scores[0])
    rows = enet_eval.main(["--agent", pre + "sac_state.pkl", "--games", "1",
                           "--steps", "1", "--device", "cpu"])
    assert len(rows) == 1 and np.isfinite(rows[0]["rl_rel_err"]) \
        and np.isfinite(rows[0]["grid_rel_err"])
    assert all(te.LOW <= r <= te.HIGH for r in rows[0]["grid_rho"])
    enet_td3.main(common + ["--prefix", pre])
    for f in ("td3_state.pkl", "replaymem_td3.pkl", "scores_td3.pkl"):
        assert (tmp_path / f"e_{f}").exists(), f
    out = enet_ddpg.main(common + ["--prefix", pre])
    assert (tmp_path / "e_scores_ddpg.pkl").exists()
    assert np.isfinite(out["final_avg_score"])


def test_calib_trainers_run_on_cpu(tmp_path):
    common = ["--small", "--episodes", "1", "--M", "3", "--device", "cpu",
              "--quiet"]
    scores = calib_td3.main(common + ["--steps", "2", "--use_hint",
                                      "--prefix", str(tmp_path / "td3")])
    assert len(scores) == 1 and np.isfinite(scores[0])
    assert (tmp_path / "td3td3_state.pkl").exists()
    scores = calib_ddpg.main(common + ["--steps", "1", "--prefix",
                                       str(tmp_path / "ddpg")])
    assert len(scores) == 1 and np.isfinite(scores[0])
    assert (tmp_path / "ddpgddpg_state.pkl").exists()


ENTRIES = {"enet_sac": enet_sac.main, "enet_td3": enet_td3.main,
           "enet_ddpg": enet_ddpg.main, "calib_td3": calib_td3.main,
           "calib_ddpg": calib_ddpg.main}


@pytest.mark.parametrize("entry", sorted(ENTRIES))
@pytest.mark.parametrize("flag", [["--metrics", "m.jsonl"],
                                  ["--trace", "tr"], ["--diag"],
                                  ["--watchdog"], ["--resume"],
                                  ["--ckpt-every", "2"],
                                  ["--max-recoveries", "1"],
                                  ["--compile-cache", "cc"]])
def test_unported_flags_raise_with_their_item(entry, flag, tmp_path,
                                              monkeypatch):
    """The obs and runtime flags of ROADMAP queue 1 item 12 act in every
    trainer: two short episodes on the CPU run with the flag, and the flag
    leaves its mark (run log, trace, checkpoint, kernel library
    directory); ``--resume`` continues a checkpointed first episode."""
    from smartcal_tpu_torch.ops import build
    from smartcal_tpu_torch.runtime import checkpoint

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    size = (["--M", "5", "--N", "5"] if entry.startswith("enet")
            else ["--small", "--M", "3"])
    base = ["--device", "cpu", "--steps", "1", "--quiet", "--prefix", "p_",
            "--ckpt-dir", "ck"] + size
    first = None
    if flag[0] == "--resume":
        first = ENTRIES[entry](base + ["--episodes", "1", "--ckpt-every",
                                       "1"])
    out = ENTRIES[entry](base + ["--episodes", "2"] + flag)
    if entry.startswith("enet"):
        assert out["episodes"] == 2 and np.isfinite(out["final_avg_score"])
    else:
        assert len(out) == 2 and np.all(np.isfinite(out))
        if first is not None:
            assert out[0] == first[0]
    if flag[0] in ("--metrics", "--trace"):
        log = "m.jsonl" if flag[0] == "--metrics" else f"tr/{entry}_run.jsonl"
        recs = [json.loads(ln) for ln in open(log)]
        assert recs[0]["event"] == "run_header"
        assert recs[-1]["event"] == "run_end" and recs[-1]["episodes"] == 2
        if flag[0] == "--trace":
            assert (tmp_path / "tr" / f"{entry}_trace.json").exists()
    elif flag[0] == "--ckpt-every":
        assert [s for s, _ in checkpoint.list_checkpoints("ck")] == [2]
    elif flag[0] == "--resume":
        assert checkpoint.load_latest("ck")[1] == 1
    elif flag[0] == "--compile-cache":
        assert build.BUILD_DIR == (tmp_path / "cc").resolve()


@pytest.mark.parametrize("entry", sorted(ENTRIES) + ["enet_eval"])
def test_entry_points_default_to_cuda(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    main = enet_eval.main if entry == "enet_eval" else ENTRIES[entry]
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["--episodes", "1"] if entry != "enet_eval"
             else ["--agent", str(tmp_path / "none.pkl")])
