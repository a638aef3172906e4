"""The port's native prioritized replay (``rl/replay_native.NativePER``)
and the native arms of its SAC agent, checkpoint payloads and interop,
against the JAX package.

Both packages' rings sit on byte-identical copies of the C++ sum tree
(``native/_src/sumtree.cc``) and draw their segment uniforms from numpy
generators, so the same stores and the same seed give the same indices,
IS weights and priorities bit for bit.  The native learn is held at the
learn-step tolerances of tests/test_torch_sac.py (losses rtol 1e-4; every
parameter, Adam moment, alpha and rho rtol 1e-4 / atol 1e-5), from a JAX
state with Adam history (see that file's docstring).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.rl import replay as jr
from smartcal_tpu.rl import replay_native as jn
from smartcal_tpu.rl import sac as jsac
from smartcal_tpu.train import blocks as jblocks
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.rl import replay as tr
from smartcal_tpu_torch.rl import replay_native as tn
from smartcal_tpu_torch.rl import sac as tsac
from smartcal_tpu_torch.runtime import checkpoint
from smartcal_tpu_torch.train import blocks as tblocks

OBS, NA, B, MEM = 6, 2, 4, 16
RTOL, ATOL = 1e-4, 1e-5


def transitions(n, seed=1, obs=OBS, na=NA):
    rng = np.random.default_rng(seed)
    return [{"state": rng.standard_normal(obs).astype(np.float32),
             "action": rng.uniform(-1, 1, na).astype(np.float32),
             "reward": np.float32(rng.uniform(0, 3)),
             "new_state": rng.standard_normal(obs).astype(np.float32),
             "done": bool(rng.uniform() < 0.2),
             "hint": rng.uniform(-1, 1, na).astype(np.float32)}
            for _ in range(n)]


def pair(size=MEM, error_clip=100.0):
    return (jn.NativePER(size, jr.transition_spec(OBS, NA),
                         error_clip=error_clip),
            tn.NativePER(size, tr.transition_spec(OBS, NA),
                         error_clip=error_clip))


def same_buffers(jb, tb):
    np.testing.assert_array_equal(tb.tree.leaves(), jb.tree.leaves())
    assert (tb.cntr, tb.beta, tb.tree.cursor, tb.tree.filled) == \
        (jb.cntr, jb.beta, jb.tree.cursor, jb.tree.filled)
    for k, v in jb.data.items():
        np.testing.assert_array_equal(tb.data[k], np.asarray(v), k)


def test_sampling_matches_jax_bit_for_bit():
    """The same stores (max-priority and error priorities, a wrapped ring)
    and the same seed: the same indices, IS weights, batches and, after
    the priority updates, the same tree."""
    jb, tb = pair()
    for i, t in enumerate(transitions(21)):
        e = None if i % 3 == 0 else 0.1 * i
        assert jb.store(t, e) == tb.store(t, e)
    same_buffers(jb, tb)
    jr_, tr_ = np.random.default_rng(11), np.random.default_rng(11)
    for step in range(5):
        bj, ij, wj = jb.sample(B, jr_)
        bt, it, wt = tb.sample(B, tr_)
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(wt, wj)
        assert wt.dtype == np.float32
        for k in bj:
            np.testing.assert_array_equal(bt[k], bj[k], k)
        err = np.linspace(0.0, 3.0 + step, B)
        jb.update_priorities(ij, err)
        tb.update_priorities(it, err)
        same_buffers(jb, tb)
    assert tb.health() == jb.health()


def test_priority_rules_and_save_load(tmp_path):
    """JAX tests/test_native.py's priority rules and checkpoint on the
    port."""
    spec = tr.transition_spec(2, 1)
    buf = tn.NativePER(8, spec, error_clip=1.0)
    tr0 = {k: np.zeros(shape) for k, (shape, _) in spec.items()}
    buf.store(tr0)                      # empty -> clip
    assert buf.tree.leaves()[0] == 1.0
    buf.store(tr0, error=0.5)           # (0.5+eps)^alpha capped at clip
    np.testing.assert_allclose(buf.tree.leaves()[1],
                               min((0.5 + tr.PER_EPSILON) ** tr.PER_ALPHA,
                                   1.0))
    buf.store(tr0)                      # non-empty -> max priority
    np.testing.assert_allclose(buf.tree.leaves()[2], buf.tree.max_priority())
    buf.update_priorities([0, 1], torch.tensor([3.0, 0.2]))
    lv = buf.tree.leaves()
    np.testing.assert_allclose(lv[0], 1.0 ** tr.PER_ALPHA)
    np.testing.assert_allclose(lv[1], (0.2 + tr.PER_EPSILON) ** tr.PER_ALPHA)
    p = str(tmp_path / "per.pkl")
    buf.save(p)
    back = tn.NativePER.load(p)
    np.testing.assert_array_equal(back.tree.leaves(), buf.tree.leaves())
    assert back.cntr == buf.cntr and back.beta == buf.beta
    _, i1, w1 = buf.sample(4, np.random.default_rng(0))
    _, i2, w2 = back.sample(4, np.random.default_rng(0))
    np.testing.assert_array_equal(i1, i2)
    np.testing.assert_array_equal(w1, w2)


@pytest.mark.parametrize("with_errors", [False, True])
def test_store_batch_matches_jax(with_errors):
    """``store_batch`` feeds the transitions one by one (max priority, or
    the error rule), wrapping the ring: the JAX package's buffer bit for
    bit."""
    jb, tb = pair(size=8)
    ts = transitions(11, seed=4)
    batch = {k: np.stack([np.asarray(t[k]) for t in ts]) for k in ts[0]}
    errors = np.linspace(0.0, 2.0, 11) if with_errors else None
    jb.store_batch(batch, errors)
    tb.store_batch(batch, errors)
    assert tb.cntr == 11
    same_buffers(jb, tb)


def test_rejects_non_pow2_size():
    with pytest.raises(ValueError):
        tn.NativePER(10, tr.transition_spec(2, 1))


def test_partial_fill_gives_finite_weights():
    """u = 1.0 on a partly filled ring walks into the unfilled suffix: the
    leaf is clamped into the filled prefix, the IS weights stay finite."""
    jb, tb = pair(size=8)
    for i, t in enumerate(transitions(3)):
        jb.store(t, error=0.1 * (i + 1))
        tb.store(t, error=0.1 * (i + 1))
    _, ij, wj = jb.sample(4, np.random.default_rng(0), uniforms=[1.0] * 4)
    _, it, wt = tb.sample(4, np.random.default_rng(0), uniforms=[1.0] * 4)
    assert np.all(np.isfinite(wt)) and np.all(it < 3) and np.all(wt > 0)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(wt, wj)


def test_to_device_round_trip_is_exact():
    tb = pair()[1]
    for t in transitions(8):
        tb.store(t)
    batch, idx, w = tb.sample(B, np.random.default_rng(3))
    got, gw = tn.to_device(batch, w, "cpu")
    for k, v in batch.items():
        t = got[k].numpy()
        assert t.dtype == v.dtype and t.shape == v.shape, k
        np.testing.assert_array_equal(t, v, k)
    np.testing.assert_array_equal(gw.numpy(), w)


def test_checkpoint_arm(tmp_path):
    tb = pair()[1]
    for t in transitions(5):
        tb.store(t)
    payload = checkpoint.pack_replay(tb)
    assert payload["kind"] == "native"
    checkpoint.save_checkpoint(str(tmp_path / "ck"), 1, {"replay": payload})
    loaded, step = checkpoint.load_latest(str(tmp_path / "ck"))
    back = checkpoint.unpack_replay(loaded["replay"], "cpu")
    assert isinstance(back, tn.NativePER)
    same_buffers(tb, back)
    # the device ring keeps its own arm
    ring = tr.replay_init(MEM, tr.transition_spec(OBS, NA), "cpu")
    assert checkpoint.pack_replay(ring)["kind"] == "device_ring"


# -- the native agent ----------------------------------------------------------

def _warm_jax_state(jcfg):
    """A JAX state with Adam history: 10 HBM learns, counter and rho reset
    (tests/test_torch_sac.py's fixture)."""
    hcfg = jsac.SACConfig(obs_dim=OBS, n_actions=NA, batch_size=B,
                          mem_size=MEM)
    st = jax.jit(lambda k: jsac.sac_init(k, hcfg))(jax.random.PRNGKey(0))
    buf = jr.replay_init(MEM, jr.transition_spec(OBS, NA))
    for t in transitions(13, seed=2):
        buf = jr.replay_add(buf, t, priority=jnp.asarray(1.0))
    step = jax.jit(lambda s, b, k: jsac.learn(hcfg, s, b, k))
    for i in range(10):
        st, buf, _ = step(st, buf, jax.random.PRNGKey(50 + i))
    return st._replace(learn_counter=jnp.asarray(0, jnp.int32),
                       rho=jnp.asarray(0.0, jnp.float32))


@pytest.fixture(scope="module")
def agents():
    """A JAX and a port native agent (PER, batch 4) from one warmed state,
    holding the same 9 transitions."""
    kw = dict(obs_dim=OBS, n_actions=NA, batch_size=B, mem_size=MEM,
              prioritized=True, replay_backend="native")
    jcfg, tcfg = jsac.SACConfig(**kw), tsac.SACConfig(**kw)
    ja = jsac.SACAgent(jcfg, seed=3)
    ja.state = _warm_jax_state(jcfg)
    ta = tsac.SACAgent(tcfg, seed=3, device="cpu")
    ta.state = interop.sac_state_from_jax(ja.state, tcfg)
    for t in transitions(9):
        args = [t[k] for k in ("state", "action", "reward", "new_state",
                               "done", "hint")]
        ja.store_transition(*args)
        ta.store_transition(*args)
    return jcfg, tcfg, ja, ta


def _leaves(d, path=""):
    for k, v in d.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{path}{k}/")
        else:
            yield f"{path}{k}", v


def test_native_learn_matches_jax(agents):
    """One native learn of each agent: the same sample (the numpy sampler
    seeded ``seed + 1`` in both), the JAX core's normal draws fed to the
    port; losses, state and the re-prioritised tree agree."""
    jcfg, tcfg, ja, ta = agents
    assert isinstance(ta.buffer, tn.NativePER)
    same_buffers(ja.buffer, ta.buffer)
    _, sub = jax.random.split(ja.key)     # the key ja.learn will use
    noise = tuple(torch.from_numpy(np.array(jax.random.normal(k, (B, NA))))
                  for k in jax.random.split(sub, 3))
    ja.learn()
    ta.learn(noise=noise)
    for k in ("critic_loss", "actor_loss", "alpha", "rho"):
        np.testing.assert_allclose(float(ta.last_metrics[k]),
                                   float(ja.last_metrics[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    want = dict(_leaves(interop.sac_state_from_jax(ja.state,
                                                   tcfg).to_host()))
    got = dict(_leaves(ta.state.to_host()))
    for k, w in want.items():
        if isinstance(w, int):
            assert got[k] == w, k
        else:
            np.testing.assert_allclose(got[k], w, rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    np.testing.assert_allclose(ta.buffer.tree.leaves(),
                               ja.buffer.tree.leaves(), rtol=RTOL)
    assert ta.buffer.beta == ja.buffer.beta


def test_native_agent_below_batch_and_save_load(tmp_path):
    cfg = tsac.SACConfig(obs_dim=OBS, n_actions=NA, batch_size=B,
                         mem_size=MEM, prioritized=True,
                         replay_backend="native")
    a = tsac.SACAgent(cfg, seed=0, device="cpu", collect_diag=True)
    before = a.state.to_host()
    for t in transitions(B - 1):
        a.store_transition(*[t[k] for k in ("state", "action", "reward",
                                             "new_state", "done", "hint")])
        a.learn()
    assert float(a.last_metrics["critic_loss"]) == 0.0
    assert a.last_diag is not None and a.state.learn_counter == 0
    for k, v in _leaves(before):
        np.testing.assert_array_equal(dict(_leaves(a.state.to_host()))[k],
                                      v, k)
    t = transitions(1, seed=9)[0]
    a.store_transition(*[t[k] for k in ("state", "action", "reward",
                                        "new_state", "done", "hint")])
    a.learn()
    assert a.state.learn_counter == 1
    prefix = str(tmp_path / "n_")
    a.save_models(prefix)
    b = tsac.SACAgent(cfg, seed=5, device="cpu")
    assert b.load_models(prefix)
    same_buffers(a.buffer, b.buffer)
    assert isinstance(b.buffer, tn.NativePER)


def test_agent_loop_payload_keeps_the_sampler(tmp_path):
    """pack_agent_loop carries the native sampler's numpy state: a restored
    agent draws the same next sample."""
    cfg = tsac.SACConfig(obs_dim=OBS, n_actions=NA, batch_size=B,
                         mem_size=MEM, prioritized=True,
                         replay_backend="native")
    a = tsac.SACAgent(cfg, seed=0, device="cpu")
    for t in transitions(7):
        a.store_transition(*[t[k] for k in ("state", "action", "reward",
                                            "new_state", "done", "hint")])
    a.learn()
    payload = tblocks.pack_agent_loop(a, None, [1.5], 3)
    assert payload["replay"]["kind"] == "native"
    assert "agent_sample_rng" in payload
    checkpoint.save_checkpoint(str(tmp_path / "ck"), 3, payload)
    loaded, _ = checkpoint.load_latest(str(tmp_path / "ck"))
    b = tsac.SACAgent(cfg, seed=7, device="cpu")
    scores, ep, _ = tblocks.restore_agent_loop(b, None, loaded)
    assert (scores, ep) == ([1.5], 3)
    _, ia, wa = a.buffer.sample(B, a._rng)
    _, ib, wb = b.buffer.sample(B, b._rng)
    np.testing.assert_array_equal(ia, ib)
    np.testing.assert_array_equal(wa, wb)


def test_jax_native_payload_resumes_in_the_port(agents):
    """A JAX native-replay agent-loop payload through
    ``interop.agent_loop_from_jax``: the ring, the tree, the sampler and
    the state resume in the port."""
    jcfg, tcfg, ja, _ = agents
    jpay = jblocks.pack_agent_loop(ja, None, [0.25, 0.5], 2)
    assert jpay["replay"]["kind"] == "native"
    pay = interop.agent_loop_from_jax(jpay, tcfg)
    t = tsac.SACAgent(tcfg, seed=11, device="cpu")
    scores, ep, _ = tblocks.restore_agent_loop(t, None, pay)
    assert (scores, ep) == ([0.25, 0.5], 2)
    same_buffers(ja.buffer, t.buffer)
    _, ij, wj = ja.buffer.sample(B, ja._rng)
    _, it, wt = t.buffer.sample(B, t._rng)
    np.testing.assert_array_equal(it, ij)
    np.testing.assert_array_equal(wt, wj)
