"""Fault-tolerant runtime of the PyTorch port (smartcal_tpu_torch/runtime,
train/blocks): atomic writes, the checksummed checkpoint store, the device
ring through a checkpoint, kill/resume bit-continuity of the trainers,
fault injection, the watchdog's rollback-and-retry, and a JAX trainer's
checkpoint resumed in the port.

Kill/resume: N/2 episodes with checkpoints, then ``--resume`` to N, equal N
straight episodes bit for bit (scores, agent state, ring, PER priorities),
as tests/test_runtime.py demands of the JAX package, for the elastic-net
SAC, TD3 (PER + hint) and DDPG trainers at M = N = 5 and for
``calib_sac --small``, sequential and with ``--batch-envs 2``.
"""

import argparse
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from smartcal_tpu.runtime import faults as jfaults
from smartcal_tpu_torch import interop, obs
from smartcal_tpu_torch.rl import replay as rp
from smartcal_tpu_torch.runtime import (Backoff, BackoffPolicy, FaultPlan,
                                        atomic_pickle, checkpoint,
                                        clear_faults, faults, install_faults,
                                        safe_pickle_load)
from smartcal_tpu_torch.train import blocks, calib_sac, enet_ddpg, enet_sac
from smartcal_tpu_torch.train import enet_td3


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


@pytest.fixture(autouse=True)
def in_tmp(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    yield
    clear_faults()
    while obs.active() is not None:
        obs.deactivate()


def read_jsonl(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def assert_host_equal(a, b, path=""):
    """Two host payloads (nested dicts of arrays and numbers) are the same
    bits."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_host_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_host_equal(x, y, f"{path}[{i}]")
    else:
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


# -- atomic writes, backoff ------------------------------------------------

def test_atomic_pickle_roundtrip_and_no_partial(tmp_path):
    path = str(tmp_path / "obj.pkl")
    atomic_pickle({"a": 1, "b": [1, 2]}, path)
    with open(path, "rb") as f:
        assert pickle.load(f) == {"a": 1, "b": [1, 2]}
    atomic_pickle({"a": 2}, path)
    with open(path, "rb") as f:
        assert pickle.load(f) == {"a": 2}
    assert [p for p in os.listdir(tmp_path) if p.endswith(".tmp")] == []
    good = pickle.dumps(list(range(100)))
    (tmp_path / "trunc.pkl").write_bytes(good[:len(good) // 2])
    assert safe_pickle_load(str(tmp_path / "trunc.pkl"), "fresh") == "fresh"
    assert safe_pickle_load(str(tmp_path / "nope.pkl"), [1]) == [1]


def test_backoff_deterministic_bounded_and_as_jax():
    from smartcal_tpu.runtime import Backoff as JBackoff
    from smartcal_tpu.runtime import BackoffPolicy as JPolicy

    kw = dict(base_s=1.0, factor=2.0, max_s=5.0, jitter=0.25,
              max_attempts=4, budget_s=100.0)
    a, b = Backoff(BackoffPolicy(**kw), seed=7), JBackoff(JPolicy(**kw),
                                                          seed=7)
    da = [a.next_delay() for _ in range(5)]
    assert da == [b.next_delay() for _ in range(5)]
    assert da[4] is None
    c = Backoff(BackoffPolicy(base_s=10.0, jitter=0.0, budget_s=15.0))
    assert [c.next_delay() for _ in range(3)] == [10.0, 5.0, None]


# -- the checkpoint store ---------------------------------------------------

def test_checkpoint_roundtrip_latest_and_retention(tmp_path):
    root = str(tmp_path / "ck")
    for step in (2, 4, 6, 8):
        checkpoint.save_checkpoint(root, step, {"step": step,
                                                "x": np.arange(step)},
                                   keep=2)
    payload, step = checkpoint.load_latest(root)
    assert step == 8 and payload["step"] == 8
    np.testing.assert_array_equal(payload["x"], np.arange(8))
    assert [s for s, _ in checkpoint.list_checkpoints(root)] == [6, 8]
    with open(os.path.join(root, "LATEST")) as f:
        assert json.load(f)["dir"] == "ckpt_000008"


def test_checkpoint_corruption_falls_back(tmp_path):
    root = str(tmp_path / "ck")
    checkpoint.save_checkpoint(root, 1, {"v": 1}, keep=3)
    checkpoint.save_checkpoint(root, 2, {"v": 2}, keep=3)
    with open(os.path.join(root, "ckpt_000002", "payload.pkl"), "r+b") as f:
        f.write(b"\x00\x00\x00\x00")
    payload, step = checkpoint.load_latest(root)
    assert step == 1 and payload["v"] == 1
    with open(os.path.join(root, "LATEST"), "w") as f:
        f.write("{not json")
    assert checkpoint.load_latest(root)[1] == 1
    os.makedirs(os.path.join(root, ".ckpt_000009.partial"))
    assert checkpoint.load_latest(root)[1] == 1
    checkpoint.save_checkpoint(root, 3, {"v": 3}, keep=3)
    assert not [d for d in os.listdir(root) if d.startswith(".ckpt_")]


def test_checkpoint_empty_root_and_host_only_payloads(tmp_path):
    assert checkpoint.load_latest(str(tmp_path / "missing")) is None

    class OnCard:                   # what a CUDA tensor looks like here
        device, is_cuda = "cuda:0", True

        def detach(self):
            return self

    with pytest.raises(TypeError, match="host data only"):
        checkpoint.save_checkpoint(str(tmp_path / "ck"), 1,
                                   {"a": [1, {"t": OnCard()}]})
    checkpoint.save_checkpoint(str(tmp_path / "ck"), 1,
                               {"t": torch.ones(2), "n": np.ones(2)})
    assert checkpoint.load_latest(str(tmp_path / "ck"))[1] == 1


def test_per_ring_survives_bit_for_bit(tmp_path):
    """A wrapped PER ring, after a prioritized sample (beta annealed), goes
    through a checkpoint and comes back the same bits, its zero tail past
    the filled prefix too."""
    for n in (20, 5):                           # wrapped, and a prefix
        buf = rp.replay_init(16, rp.transition_spec(3, 2), device="cpu")
        rng = np.random.default_rng(0)
        for i in range(n):
            rp.replay_add(buf, {
                "state": rng.standard_normal(3).astype(np.float32),
                "new_state": rng.standard_normal(3).astype(np.float32),
                "action": rng.standard_normal(2).astype(np.float32),
                "reward": np.float32(i), "done": bool(i % 3 == 0),
                "hint": np.zeros(2, np.float32)}, error=float(i) / 3)
        rp.replay_sample_per(buf, 4, torch.Generator().manual_seed(1))
        root = str(tmp_path / f"ck{n}")
        checkpoint.save_checkpoint(root, 1,
                                   {"replay": checkpoint.pack_replay(buf)})
        back = checkpoint.unpack_replay(checkpoint.load_latest(root)[0]
                                        ["replay"], "cpu")
        assert (back.cntr, back.beta, back.size) == (buf.cntr, buf.beta,
                                                     buf.size)
        assert torch.equal(back.priority, buf.priority)
        for k, v in buf.data.items():
            assert back.data[k].dtype == v.dtype
            assert torch.equal(back.data[k], v), k
        if n < 16:
            assert not back.priority[n:].any()


def test_env_state_kinds_and_prefetch_discard():
    from smartcal_tpu_torch.envs.calib import BatchedCalibEnv, CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend

    tiny = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
                lbfgs_iters=3, init_iters=5, npix=32, device="cpu")
    seq = CalibEnv(M=3, backend=RadioBackend(**tiny), seed=4, device="cpu")
    bat = BatchedCalibEnv(M=3, n_envs=2, backend=RadioBackend(**tiny),
                          seed=4, device="cpu")
    p_seq, p_bat = (checkpoint.pack_env_state(e) for e in (seq, bat))
    assert p_seq["kind"] == "env_key" and p_bat["kind"] == "env_state_dict"
    with pytest.raises(ValueError):
        checkpoint.restore_env_state(seq, p_bat)
    with pytest.raises(ValueError):
        checkpoint.restore_env_state(bat, p_seq)
    seq._next_key()
    checkpoint.restore_env_state(seq, p_seq)
    np.testing.assert_array_equal(seq._key, p_seq["key"])
    # a pending prefetch of the abandoned walk is discarded on restore
    seq._pf_tag = "stale"
    seq.backend._prefetched["stale"] = seq.backend._submit(lambda: None)
    checkpoint.restore_env_state(seq, p_seq)
    assert seq._pf_tag is None and "stale" not in seq.backend._prefetched


# -- kill / resume bit-continuity -------------------------------------------

def _kill_resume_parity(mod, episodes=4, **kw):
    straight, _, st_all, buf_all = mod.train_fused(
        seed=0, episodes=episodes, quiet=True, prefix="a_", device="cpu",
        **kw)
    mod.train_fused(seed=0, episodes=episodes // 2, quiet=True, prefix="b_",
                    ckpt_dir="ck", ckpt_every=episodes // 2, device="cpu",
                    **kw)
    resumed, _, st_res, buf_res = mod.train_fused(
        seed=0, episodes=episodes, quiet=True, prefix="b_", ckpt_dir="ck",
        resume=True, device="cpu", **kw)
    assert resumed == straight
    assert_host_equal(st_all.to_host(), st_res.to_host())
    assert_host_equal(rp.replay_to_host(buf_all), rp.replay_to_host(buf_res))
    assert torch.equal(buf_all.priority, buf_res.priority)


@pytest.mark.parametrize("entry", ["enet_sac", "enet_td3_per_hint",
                                   "enet_ddpg"])
def test_kill_resume_parity_enet(entry):
    mod, kw = {"enet_sac": (enet_sac, {}),
               "enet_td3_per_hint": (enet_td3, dict(use_hint=True,
                                                    prioritized=True)),
               "enet_ddpg": (enet_ddpg, {})}[entry]
    _kill_resume_parity(mod, steps=2, M=5, N=5, **kw)


CALIB = ["--small", "--M", "3", "--steps", "2", "--use_hint", "--device",
         "cpu", "--quiet"]


@pytest.mark.parametrize("batch", [1, 2], ids=["sequential", "batched"])
def test_kill_resume_parity_calib_sac(batch):
    extra = ["--batch-envs", str(batch)] if batch > 1 else []
    straight = calib_sac.main(CALIB + extra + ["--episodes", "4", "--prefix",
                                               "a"])
    calib_sac.main(CALIB + extra + ["--episodes", "2", "--prefix", "b",
                                    "--ckpt-every", "1", "--ckpt-dir",
                                    "ck"])
    resumed = calib_sac.main(CALIB + extra + ["--episodes", "4", "--prefix",
                                              "b", "--resume", "--ckpt-dir",
                                              "ck"])
    assert resumed == straight
    for f in ("sac_state.pkl", "replaymem_sac.pkl"):
        with open("a" + f, "rb") as fa, open("b" + f, "rb") as fb:
            assert_host_equal(pickle.load(fa), pickle.load(fb))
    payload, step = checkpoint.load_latest("ck")
    assert step == (2 if batch == 1 else 1)
    assert payload["env_state"]["kind"] == ("env_key" if batch == 1
                                            else "env_state_dict")


@pytest.mark.parametrize("entry", ["calib_sac", "enet_sac"])
def test_deterministic_flag_holds_for_the_run(entry, monkeypatch):
    """``--deterministic`` parses without a side effect; the run's handle
    turns the mode and the cuBLAS workspace on for its episodes and puts
    both back at its close (a host-driven loop and a fused one)."""
    p = blocks.add_runtime_args(argparse.ArgumentParser())
    assert p.parse_args(["--deterministic"]).deterministic
    assert not p.parse_args([]).deterministic
    assert not torch.are_deterministic_algorithms_enabled()
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    seen = []
    real = blocks.TrainObs.episode

    def episode(self, *a, **kw):
        seen.append((torch.are_deterministic_algorithms_enabled(),
                     os.environ.get("CUBLAS_WORKSPACE_CONFIG")))
        return real(self, *a, **kw)

    monkeypatch.setattr(blocks.TrainObs, "episode", episode)
    if entry == "calib_sac":
        calib_sac.main(CALIB + ["--episodes", "1", "--prefix", "d",
                                "--deterministic"])
    else:
        enet_sac.main(["--episodes", "1", "--steps", "2", "--M", "5",
                       "--N", "5", "--device", "cpu", "--quiet", "--prefix",
                       "d_", "--deterministic"])
    assert seen == [(True, blocks.CUBLAS_DETERMINISTIC)]
    assert not torch.are_deterministic_algorithms_enabled()
    assert "CUBLAS_WORKSPACE_CONFIG" not in os.environ


# -- fault injection ---------------------------------------------------------

def test_faults_mutate_diag_exact_step():
    install_faults(FaultPlan(nan_field="critic_loss", nan_step=3))
    d = {"critic_loss": 1.0, "q_mean": 0.5}
    assert faults.mutate_diag(d, 2) == d
    out = faults.mutate_diag(d, 3)
    assert np.isnan(out["critic_loss"]) and out["q_mean"] == 0.5
    assert d["critic_loss"] == 1.0


def test_fault_plan_parses_as_jax(monkeypatch):
    """One SMARTCAL_FAULTS value drives both packages the same way."""
    install_faults(FaultPlan(kill_actor=1, kill_at=2))
    assert not faults.should_kill_actor(0, 2)
    assert faults.should_kill_actor(1, 2)
    clear_faults()
    raw = json.dumps({"nan_field": "q_mean", "nan_step": 7,
                      "delay_stage": "solve", "delay_at": 1, "delay_s": 0.5,
                      "unknown_key": 1})
    monkeypatch.setenv("SMARTCAL_FAULTS", raw)
    mine, theirs = faults.plan_from_env(), jfaults.plan_from_env()
    assert vars(mine) == vars(theirs)
    assert mine.nan_field == "q_mean" and mine.nan_step == 7
    monkeypatch.setenv("SMARTCAL_FAULTS", "{broken")
    assert faults.plan_from_env() is None


def test_watchdog_reset_unlatches():
    wd = obs.Watchdog()
    assert wd.observe({"critic_loss": float("nan")}, step=0)
    assert wd.tripped and wd.trips == 1
    wd.reset()
    assert not wd.tripped and wd.trip_reason is None
    assert not wd.observe({"critic_loss": 1.0}, step=1)
    assert wd.trips == 1


# -- the watchdog's rollback-and-retry ----------------------------------------

ENET = dict(seed=0, episodes=6, steps=3, M=5, N=5, quiet=True, save_every=0,
            device="cpu")


def test_rollback_e2e_enet_nan_injection(tmp_path):
    """An injected NaN rolls back to the last checkpoint and, with the
    identity mitigation, finishes bit-identical to the run without it; the
    run log has the fault, the trip and the recovery."""
    ref, _, st_ref, _ = enet_sac.train_fused(prefix="r_", watchdog=True,
                                             **ENET)
    install_faults(FaultPlan(nan_field="critic_loss", nan_step=10))
    run = str(tmp_path / "inj.jsonl")
    inj, _, st_inj, _ = enet_sac.train_fused(
        prefix="i_", metrics_path=run, ckpt_dir="ck_inj", ckpt_every=2,
        max_recoveries=2, recovery_lr_shrink=1.0, recovery_reseed=False,
        **ENET)
    clear_faults()
    events = read_jsonl(run)
    kinds = [e["event"] for e in events]
    assert "fault_injected" in kinds and "watchdog_trip" in kinds
    rec = [e for e in events if e["event"] == "recovery"]
    assert rec and rec[0]["action"] == "rollback"
    assert rec[0]["rollback_step"] == 2
    assert rec[0]["reason"].startswith("non_finite")
    assert inj == ref
    assert_host_equal(st_ref.to_host(), st_inj.to_host())
    end = [e for e in events if e["event"] == "run_end"][-1]
    assert end["episodes"] == 7
    assert [e["episode"] for e in events if e["event"] == "episode"] == \
        [0, 1, 2, 2, 3, 4, 5]


def test_rollback_budget_exhausts_to_halt(tmp_path):
    install_faults(FaultPlan(nan_field="critic_loss", nan_step=10))
    run = str(tmp_path / "halt.jsonl")
    scores, _, _, _ = enet_sac.train_fused(
        prefix="h_", metrics_path=run, ckpt_dir="ck_halt", ckpt_every=10,
        max_recoveries=1, recovery_lr_shrink=1.0, recovery_reseed=False,
        **ENET)
    clear_faults()
    rec = [e for e in read_jsonl(run) if e["event"] == "recovery"]
    assert rec and rec[0]["action"] == "halt_no_checkpoint"
    assert len(scores) < 6


def test_recovery_mitigation_reseeds_and_shrinks():
    """The mitigation of a rollback: the reseed changes the generator's
    stream (the same way for the same attempt), the LR shrink scales the
    agent's rates."""
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.runtime import RecoveryAction

    cfg = sac.SACConfig(obs_dim=4, n_actions=2, batch_size=2, mem_size=8)
    agent = sac.SACAgent(cfg, seed=0, device="cpu")
    state = blocks.generator_state(agent.generator)
    act = RecoveryAction(payload={}, step=2, attempt=1, lr_scale=0.25,
                         reseed=True)
    blocks.apply_agent_recovery(agent, cfg, act)
    assert agent.cfg.lr_a == cfg.lr_a * 0.25
    assert agent.cfg.lr_c == cfg.lr_c * 0.25
    after = torch.rand(4, generator=agent.generator)
    g = torch.Generator().manual_seed(0)
    blocks.set_generator_state(g, state)
    assert not torch.equal(torch.rand(4, generator=g), after)
    blocks.set_generator_state(g, state)
    blocks.reseed_generator(g, 1)
    assert torch.equal(torch.rand(4, generator=g), after)


# -- a JAX trainer's checkpoint resumed in the port ---------------------------

def test_jax_checkpoint_resumes_in_the_port(monkeypatch):
    """A JAX ``calib_sac --small`` checkpoint becomes the port's payload
    (``interop.agent_loop_from_jax``): the agent state is the carried state,
    the ring the same bits (its zero tail too), and the env's next episode
    is the JAX env's next episode within the tiny-episode tolerance
    (tests/test_torch_calib_env.py)."""
    from smartcal_tpu.envs.calib import CalibEnv as JaxEnv
    from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
    from smartcal_tpu.rl import sac as jsac
    from smartcal_tpu.runtime import checkpoint as jcheckpoint
    from smartcal_tpu.train import calib_sac as jcalib_sac
    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.rl import sac

    init = jsac.sac_init                # jitted: eager flax init is slow
    monkeypatch.setattr(jsac, "sac_init", lambda key, cfg: jax.jit(
        lambda k: init(k, cfg))(key))
    jcalib_sac.main(["--small", "--M", "3", "--episodes", "1", "--steps",
                     "2", "--use_hint", "--quiet", "--prefix", "j",
                     "--ckpt-every", "1", "--ckpt-dir", "jck"])
    jpayload, step = jcheckpoint.load_latest("jck")
    assert step == 1
    cfg = calib_sac.agent_config(32, 3, use_hint=True)
    payload = interop.agent_loop_from_jax(jpayload, cfg)
    checkpoint.save_checkpoint("ck", step, payload)

    tiny = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
                lbfgs_iters=3, init_iters=5, npix=32)
    env = CalibEnv(M=3, provide_hint=True,
                   backend=RadioBackend(device="cpu", **tiny), seed=0,
                   device="cpu")
    agent = sac.SACAgent(cfg, seed=5, device="cpu")
    scores, episode, _ = blocks.restore_agent_loop(
        agent, env, checkpoint.load_latest("ck")[0])
    assert episode == 1 and scores == [float(s) for s in jpayload["scores"]]
    assert_host_equal(agent.state.to_host(), interop.sac_state_from_jax(
        jpayload["agent_state"], cfg).to_host())
    jring = jpayload["replay"]["state"]
    assert agent.buffer.cntr == int(jring.cntr) == 2
    for k, v in jring.data.items():
        np.testing.assert_array_equal(agent.buffer.data[k].numpy(),
                                      np.asarray(v), k)
    np.testing.assert_array_equal(agent.buffer.priority.numpy(),
                                  np.asarray(jring.priority))
    gen = torch.Generator().manual_seed(
        interop.seed_from_jax_key(jpayload["agent_key"]))
    assert torch.equal(agent.generator.get_state(), gen.get_state())

    # the continued episode: both envs from the checkpoint's key.  The
    # port draws its own sky and K from the key (the sky tables must be
    # equal); its visibilities are the JAX episode's, as in
    # tests/test_torch_calib_env.py: this second episode of seed 0 is one
    # of the ill-conditioned ones, where the packages' f32 phase round-off
    # moves the image by ~2.5e-3 (ROADMAP queue 3)
    jenv = JaxEnv(M=3, provide_hint=True,
                  backend=JaxBackend(shard=False, **tiny), seed=0)
    jenv._key = jax.numpy.asarray(jpayload["env_state"]["key"])
    build = env.backend.new_calib_episode

    def from_jax(key, K, M):
        _, mdl = build(key, K, M)
        jep, _ = jenv.backend.new_calib_episode(jax.numpy.asarray(key), K, M)
        return interop.episode_from_numpy(jep), mdl

    env.backend.new_calib_episode = from_jax
    jo, to = jenv.reset(), env.reset()
    assert env.K == jenv.K
    np.testing.assert_array_equal(to["sky"], jo["sky"])
    img_rel = (np.linalg.norm(to["img"] - jo["img"])
               / np.linalg.norm(jo["img"]))
    assert img_rel < 1e-3
    jout, tout = jenv.step(jenv.hint), env.step(env.hint)
    np.testing.assert_allclose(tout[1], jout[1], rtol=1e-3, atol=1e-3)
