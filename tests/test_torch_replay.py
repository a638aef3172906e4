"""The port's device replay ring against the JAX package's.

Both rings take the same transitions; the samplers take the draws JAX
made from its keys (Gumbel noise, uniforms).  Sampled indices must be
equal, IS weights within 1e-6, stored fields and priorities equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.rl import replay as jr
from smartcal_tpu_torch.rl import replay as tr

OBS, NA = 5, 2


def transitions(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"state": rng.standard_normal(OBS).astype(np.float32),
             "action": rng.uniform(-1, 1, NA).astype(np.float32),
             "reward": np.float32(rng.standard_normal()),
             "new_state": rng.standard_normal(OBS).astype(np.float32),
             "done": bool(rng.uniform() < 0.3),
             "hint": rng.uniform(-1, 1, NA).astype(np.float32)}
            for _ in range(n)]


def pair(size, trs, errors=None, priority=None):
    """A JAX ring and a port ring holding ``trs``; priorities from
    ``errors`` (PER), ``priority`` (uniform) or the max-priority rule."""
    jb = jr.replay_init(size, jr.transition_spec(OBS, NA))
    tb = tr.replay_init(size, tr.transition_spec(OBS, NA), device="cpu")
    for i, t in enumerate(trs):
        e = None if errors is None else errors[i]
        jb = jr.replay_add(jb, t, priority=priority, error=e)
        tr.replay_add(tb, t, priority=priority, error=e)
    return jb, tb


def same_ring(jb, tb):
    assert tb.cntr == int(jb.cntr) and tb.size == jb.size
    assert tb.beta == np.float32(jb.beta)
    for k, v in jb.data.items():
        np.testing.assert_array_equal(tb.data[k].numpy(), np.asarray(v), k)
    np.testing.assert_allclose(tb.priority.numpy(), np.asarray(jb.priority),
                               rtol=1e-6, atol=0)


def same_batch(batch, jbatch):
    for k, v in jbatch.items():
        np.testing.assert_array_equal(batch[k].numpy(), np.asarray(v), k)


def test_ring_wraps_like_jax():
    jb, tb = pair(5, transitions(7), priority=1.0)
    same_ring(jb, tb)
    assert tb.filled == 5
    jb2 = jr.replay_add_batch(jb, {k: np.stack([t[k] for t in transitions(
        4, 1)]) for k in jb.data})
    tr.replay_add_batch(tb, {k: np.stack([t[k] for t in transitions(4, 1)])
                             for k in tb.data})
    same_ring(jb2, tb)


def test_max_priority_and_error_priorities_match():
    trs = transitions(6)
    same_ring(*pair(8, trs))                       # clip, then the max
    errs = np.array([0.1, 5.0, 300.0, -2.0, 0.0, 1e-3], np.float32)
    same_ring(*pair(8, trs, errors=errs))
    np.testing.assert_allclose(tr.priority_from_errors(errs).numpy(),
                               np.asarray(jr.priority_from_errors(errs)),
                               rtol=1e-6)


@pytest.mark.parametrize("n_stored", [6, 11])
def test_uniform_selection_given_the_same_gumbel_noise(n_stored):
    jb, tb = pair(8, transitions(n_stored), priority=1.0)
    for s in range(3):
        key = jax.random.PRNGKey(s)
        jbatch, jidx = jr.replay_sample_uniform(jb, key, 4)
        g = torch.from_numpy(np.array(jax.random.gumbel(key, (8,))))
        batch, idx = tr.replay_sample_uniform(tb, 4, gumbel_noise=g)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        same_batch(batch, jbatch)


def _per_pair():
    errs = np.random.default_rng(3).exponential(2.0, 13).astype(np.float32)
    return pair(16, transitions(13), errors=errs)


def test_per_indices_weights_and_beta_given_the_same_uniforms():
    jb, tb = _per_pair()
    for s in range(4):
        key = jax.random.PRNGKey(10 + s)
        jbatch, jidx, jw, jb = jr.replay_sample_per(jb, key, 4)
        u = torch.from_numpy(np.array(jax.random.uniform(key, (4,))))
        batch, idx, w = tr.replay_sample_per(tb, 4, u=u)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=0,
                                   atol=1e-6)
        same_batch(batch, jbatch)
        assert tb.beta == np.float32(jb.beta)


def test_beta_anneals_as_in_jax_and_caps_at_one():
    jb, tb = _per_pair()
    jb = jb._replace(beta=jnp.asarray(0.99985, jnp.float32))
    tb.beta = np.float32(0.99985)
    for s in range(3):
        key = jax.random.PRNGKey(s)
        _, _, _, jb = jr.replay_sample_per(jb, key, 4)
        tr.replay_sample_per(tb, 4, u=torch.rand(4))
        assert tb.beta == np.float32(jb.beta)
    assert tb.beta == np.float32(1.0)


def test_ere_weights_and_samples_match():
    jb, tb = pair(8, transitions(11), priority=1.0)
    for eta in (1.0, 0.9, 0.5):
        np.testing.assert_allclose(tr.ere_weights(tb, eta).numpy(),
                                   np.asarray(jr.ere_weights(jb, eta)),
                                   rtol=1e-6, atol=1e-30)
    key = jax.random.PRNGKey(4)
    jbatch, jidx = jr.replay_sample_ere(jb, key, 4, 0.5)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (4,))))
    batch, idx = tr.replay_sample_ere(tb, 4, 0.5, u=u)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    same_batch(batch, jbatch)
    jb, tb = _per_pair()
    _, jidx, jw, _ = jr.replay_sample_per(jb, key, 4, recency_eta=0.7)
    _, idx, w = tr.replay_sample_per(tb, 4, u=u, recency_eta=0.7)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6)


def test_priority_updates_match_with_repeated_slots():
    jb, tb = _per_pair()
    idx = np.array([3, 7, 3, 12, 7, 3], np.int32)
    errs = np.array([0.5, 250.0, 2.0, -1.0, 0.01, 7.0], np.float32)
    jb = jr.replay_update_priorities(jb, jnp.asarray(idx), jnp.asarray(errs))
    tr.replay_update_priorities(tb, torch.from_numpy(idx).long(),
                                torch.from_numpy(errs))
    same_ring(jb, tb)
    assert np.isclose(float(tb.priority[3]), 7.01 ** 0.6, rtol=1e-6)


def test_per_mse_and_health_match():
    rng = np.random.default_rng(7)
    q, y = (rng.standard_normal((6, 1)).astype(np.float32) for _ in range(2))
    w = rng.uniform(0.1, 1, 6).astype(np.float32)
    np.testing.assert_allclose(
        float(tr.per_mse(*map(torch.from_numpy, (q, y, w)))),
        float(jr.per_mse(q, y, w)), rtol=1e-6)
    jb, tb = _per_pair()
    want, got = jr.replay_health(jb), tr.replay_health(tb)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


@pytest.mark.parametrize("n_stored", [3, 11])
def test_save_load_round_trip_writes_only_the_filled_prefix(tmp_path,
                                                            n_stored):
    import pickle
    _, tb = pair(8, transitions(n_stored), errors=np.linspace(
        0.1, 3, n_stored).astype(np.float32))
    tr.replay_sample_per(tb, 2, u=torch.rand(2))        # beta moves
    path = str(tmp_path / "ring.pkl")
    tr.save_replay(tb, path)
    with open(path, "rb") as fh:
        payload = pickle.load(fh)
    assert len(payload["priority"]) == min(n_stored, 8)
    assert all(len(v) == min(n_stored, 8) for v in payload["data"].values())
    back = tr.load_replay(path, device="cpu")
    assert (back.cntr, back.size, back.beta) == (tb.cntr, tb.size, tb.beta)
    for k, v in tb.data.items():
        assert back.data[k].dtype == v.dtype
        assert torch.equal(back.data[k], v), k
    assert torch.equal(back.priority, tb.priority)
