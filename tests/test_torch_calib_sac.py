"""The calibration SAC slice as a whole: the port's agent against the JAX
package's on the observations of two tiny JAX ``CalibEnv`` episodes, and
the port's ``train/calib_sac.py`` trainer end to end on the CPU.

Both agents see only the JAX env's observations (so the env round-off of
ROADMAP queue 3 does not enter), start from the same carried state, pick
actions with the noise JAX drew from its keys, store the same transitions
and learn with ``batch_size=4`` on the draws JAX made: 5 learn calls over
the 8 transitions.  The carried state is JAX's agent after 10 warm-up
learn steps on random transitions, with its counter set back to 0 and a
fresh ring: fresh Adam moments turn gradient round-off near 1e-9 into
parameter differences of up to 1e-4 (tests/test_torch_sac.py).  Actions,
every parameter and Adam moment are held at rtol 1e-4 / atol 1e-5 after
each episode.
"""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.envs.calib import CalibEnv as JaxEnv
from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu.rl import replay as jr
from smartcal_tpu.rl import sac as jsac
from smartcal_tpu.rl.networks import flatten_obs
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.rl import sac as tsac
from smartcal_tpu_torch.train import blocks, calib_sac

# the --small backend of train/calib_sac.py
SMALL = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
             lbfgs_iters=3, init_iters=5, npix=32)
M, NPIX = 3, 32
RTOL, ATOL = 1e-4, 1e-5
# train/calib_sac.py's agent, with batch 4 and a 64-slot ring
CFG = dict(obs_dim=NPIX * NPIX + (M + 1) * 7, n_actions=2 * M, gamma=0.99,
           tau=0.005, batch_size=4, mem_size=64, lr_a=1e-3, lr_c=1e-3,
           reward_scale=M, alpha=0.03, hint_threshold=0.01, admm_rho=1.0,
           use_hint=True, hint_distance="kld", img_shape=(NPIX, NPIX))


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


def _next_sub(jagent):
    """The key ``jagent._next_key()`` will hand out next."""
    return jax.random.split(jagent.key)[1]


def learn_draws(key, cfg):
    """The draws ``smartcal_tpu.rl.sac.learn`` makes from ``key``: the
    Gumbel noise of k_samp and the three normals of k_core's split."""
    k_samp, k_core = jax.random.split(key)
    gumbel = jax.random.gumbel(k_samp, (cfg.mem_size,))
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(
        k, (cfg.batch_size, cfg.n_actions))))
        for k in jax.random.split(k_core, 3))
    return torch.from_numpy(np.array(gumbel)), noise


def _leaves(d, path=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def same_agent(tagent, jagent, tag):
    want = dict(_leaves(interop.sac_state_from_jax(
        jagent.state, tagent.cfg).to_host()))
    for k, v in _leaves(tagent.state.to_host()):
        np.testing.assert_allclose(v, want[k], rtol=RTOL, atol=ATOL,
                                   err_msg=f"{tag} {k}")
    assert tagent.buffer.cntr == int(jagent.buffer.cntr)
    for k, v in jagent.buffer.data.items():
        np.testing.assert_array_equal(tagent.buffer.data[k].numpy(),
                                      np.asarray(v), f"{tag} ring {k}")


def warmed_jax_agent(monkeypatch):
    jcfg = jsac.SACConfig(**CFG)
    # the agent's init, jitted (eager flax init of three CNNs takes ~15 s)
    init = jsac.sac_init
    monkeypatch.setattr(jsac, "sac_init", lambda key, cfg: jax.jit(
        lambda k: init(k, cfg))(key))
    jagent = jsac.SACAgent(jcfg, seed=0)
    rng = np.random.default_rng(0)
    buf = jr.replay_init(jcfg.mem_size, jr.transition_spec(jcfg.obs_dim,
                                                           jcfg.n_actions))
    for _ in range(8):
        buf = jagent._add(buf, {
            "state": 1e-3 * rng.standard_normal(jcfg.obs_dim),
            "new_state": 1e-3 * rng.standard_normal(jcfg.obs_dim),
            "action": rng.uniform(-1, 1, jcfg.n_actions),
            "reward": rng.uniform(0, 3), "done": False,
            "hint": rng.uniform(-1, 1, jcfg.n_actions)})
    st = jagent.state
    for i in range(10):
        st, buf, _ = jagent._learn(st, buf, jax.random.PRNGKey(70 + i))
    jagent.state = st._replace(learn_counter=jnp.asarray(0, jnp.int32),
                               rho=jnp.asarray(0.0, jnp.float32))
    return jagent


def test_agents_match_on_two_jax_episodes(monkeypatch):
    env = JaxEnv(M=M, provide_hint=True, backend=JaxBackend(shard=False,
                                                           **SMALL),
                 seed=0, fixed_K=2)
    jagent = warmed_jax_agent(monkeypatch)
    tcfg = tsac.SACConfig(**CFG)
    tagent = tsac.SACAgent(tcfg, seed=0, device="cpu")
    tagent.state = interop.sac_state_from_jax(jagent.state, tcfg)
    worst_action = 0.0
    for episode in range(2):
        flat = flatten_obs(env.reset())
        for _ in range(4):
            noise = np.array(jax.random.normal(_next_sub(jagent),
                                               (2 * M,)))
            action = np.asarray(jagent.choose_action(flat)).squeeze()
            t_action = tagent.choose_action(flat, noise=noise)
            np.testing.assert_allclose(t_action, action, rtol=RTOL,
                                       atol=ATOL)
            worst_action = max(worst_action,
                               float(np.abs(t_action - action).max()))
            obs2, reward, done, hint, _ = env.step(action)
            flat2 = flatten_obs(obs2)
            scaled = reward * 10 if reward > 1 else reward
            for agent in (jagent, tagent):
                agent.store_transition(flat, action, scaled, flat2, done,
                                       hint)
            gumbel, noise3 = learn_draws(_next_sub(jagent), tcfg)
            jagent.learn()
            tagent.learn(sample_noise=gumbel, noise=noise3)
            if tagent.state.learn_counter:
                np.testing.assert_allclose(
                    float(tagent.last_metrics["critic_loss"]),
                    float(jagent.last_metrics["critic_loss"]), rtol=RTOL)
            flat = flat2
        same_agent(tagent, jagent, f"after episode {episode}")
    assert tagent.state.learn_counter == int(jagent.state.learn_counter) == 5
    print(f"2 episodes, 5 learn calls: max abs action err {worst_action:.3e}")


def _saved(prefix):
    with open(f"{prefix}sac_state.pkl", "rb") as fh:
        state = pickle.load(fh)
    with open(f"{prefix}replaymem_sac.pkl", "rb") as fh:
        ring = pickle.load(fh)
    return state, ring


def test_trainer_trains_and_resumes_on_the_cpu(tmp_path):
    prefix = str(tmp_path / "cs_")
    args = ["--small", "--use_hint", "--device", "cpu", "--quiet",
            "--prefix", prefix]
    scores = calib_sac.main(args + ["--episodes", "2"])
    assert len(scores) == 2 and np.all(np.isfinite(scores))
    state, ring = _saved(prefix)
    assert ring["cntr"] == 8 and ring["size"] == 10000
    assert len(ring["priority"]) == 8
    with open(f"{prefix}_scores.pkl", "rb") as fh:
        assert pickle.load(fh) == scores
    # a different seed would start another agent: --load must bring back
    # the saved one and its ring
    scores = calib_sac.main(args + ["--episodes", "1", "--load", "--seed",
                                    "1"])
    assert len(scores) == 1 and np.isfinite(scores[0])
    state2, ring2 = _saved(prefix)
    assert ring2["cntr"] == 12
    np.testing.assert_array_equal(ring2["data"]["state"][:8],
                                  ring["data"]["state"])
    for k, v in _leaves(state):
        np.testing.assert_array_equal(dict(_leaves(state2))[k], v, k)


def test_batched_trainer_trains_on_the_cpu(tmp_path):
    """--batch-envs 2: one vector episode of 2 lanes, 2 steps each, one
    learn per vector step, 2 per-lane scores."""
    prefix = str(tmp_path / "cb_")
    scores = calib_sac.main(["--small", "--batch-envs", "2", "--episodes",
                             "2", "--steps", "2", "--device", "cpu",
                             "--quiet", "--prefix", prefix])
    assert len(scores) == 2 and np.all(np.isfinite(scores))
    _, ring = _saved(prefix)
    assert ring["cntr"] == 4               # 2 lanes x 2 steps
    with open(f"{prefix}_scores.pkl", "rb") as fh:
        assert pickle.load(fh) == scores


def test_batched_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no GPU"):
        calib_sac.main(["--small", "--batch-envs", "2", "--episodes", "2"])


@pytest.mark.parametrize("flag, item", [
    (["--metrics", "m.jsonl"], "item 12"), (["--trace", "t"], "item 12"),
    (["--diag"], "item 12"), (["--watchdog"], "item 12"),
    (["--compile-cache", "c"], "item 12"), (["--resume"], "item 12"),
    (["--ckpt-every", "2"], "item 12"), (["--max-recoveries", "1"],
                                         "item 12"),
    (["--batch-envs", "2", "--resume"], "item 12")])
def test_trainer_names_the_roadmap_item_of_an_unported_flag(
        flag, item, tmp_path, monkeypatch):
    """Every obs and runtime flag of ROADMAP queue 1 ``item`` 12 now acts: the
    trainer runs ``--small`` on the CPU with it, and the flag leaves its
    mark (a run log, a trace, diagnostics, a checkpoint, the kernel
    library directory); ``--resume`` continues a checkpointed run."""
    from smartcal_tpu_torch.ops import build
    from smartcal_tpu_torch.runtime import checkpoint

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    base = ["--small", "--M", "3", "--steps", "1", "--device", "cpu",
            "--quiet", "--prefix", "c"]
    batch = flag[:2] if flag[0] == "--batch-envs" else []
    first = None
    if "--resume" in flag:           # a checkpointed first episode
        first = calib_sac.main(base + batch + ["--episodes", str(
            2 if batch else 1), "--ckpt-every", "1"])
    scores = calib_sac.main(base + ["--episodes", "4" if batch else "2"]
                            + flag)
    assert len(scores) == (4 if batch else 2)
    assert np.all(np.isfinite(scores))
    if first is not None:
        assert scores[:len(first)] == first
    if flag[0] in ("--metrics", "--trace"):
        log = "m.jsonl" if flag[0] == "--metrics" else "t/calib_sac_run.jsonl"
        kinds = {json.loads(ln)["event"] for ln in open(log)}
        assert {"run_header", "episode", "span", "solver",
                "run_end"} <= kinds
        if flag[0] == "--trace":
            assert os.path.exists("t/calib_sac_trace.json")
    elif flag[0] == "--compile-cache":
        assert build.BUILD_DIR == (tmp_path / "c").resolve()
        assert build.library_path("dft_imager").parent == build.BUILD_DIR
    elif flag[0] in ("--ckpt-every", "--max-recoveries"):
        # --max-recoveries arms the default cadence of 10 episodes
        steps = [s for s, _ in checkpoint.list_checkpoints("c_ckpt")]
        assert steps == ([2] if flag[0] == "--ckpt-every" else [])


def test_trainer_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no GPU"):
        calib_sac.main(["--small", "--episodes", "1"])


def test_diag_from_args_matches_jax():
    import argparse

    from smartcal_tpu.train import blocks as jblocks
    for flags in ([], ["--diag"], ["--diag", "--metrics", "m"],
                  ["--watchdog"], ["--max-recoveries", "2"],
                  ["--diag", "--trace", "t"]):
        p = argparse.ArgumentParser()
        blocks.add_obs_args(p)
        blocks.add_runtime_args(p)
        args = p.parse_args(flags)
        assert blocks.diag_from_args(args) == jblocks.diag_from_args(args)
