"""The port's sharded ring (``rl/replay_sharded``: an (n_shards,
local_size) layout on one device) against the JAX package's
``smartcal_tpu.rl.replay_sharded`` placed on the test suite's virtual CPU
mesh, on the same transitions and the same draws (uniforms, Gumbel
noise).

Held: the stores (every field, the counter) bit for bit; the sampled
indices equal and the batches bit for bit for PER, PER with ERE, ERE and
uniform sampling; every priority (store-time from errors, and after the
priority update), the IS weights and the annealed beta at rtol 1e-6: each
is a float32 power, and XLA's and torch's ``pow`` differ by one ulp;
occupancy, version staleness and the health summary equal.  In the port
alone: cell (s, j) of the sharded ring holds what slot j*S + s of the
flat ring holds, with the same ERE weights.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.rl import replay as jr
from smartcal_tpu.rl import replay_sharded as jrs
from smartcal_tpu_torch.parallel import mesh as tmesh
from smartcal_tpu_torch.rl import replay as tr
from smartcal_tpu_torch.rl import replay_sharded as trs

S, SIZE, OBS, NA, B = 4, 32, 3, 2, 8


def t(x):
    return torch.from_numpy(np.array(x))


def batches(seed=0):
    """Store batches that cross the ring's end: 5, 11, 9, 13 rows."""
    rng = np.random.default_rng(seed)
    out = []
    for n in (5, 11, 9, 13):
        out.append({
            "state": rng.standard_normal((n, OBS)).astype(np.float32),
            "new_state": rng.standard_normal((n, OBS)).astype(np.float32),
            "action": rng.uniform(-1, 1, (n, NA)).astype(np.float32),
            "reward": rng.uniform(-1, 1, n).astype(np.float32),
            "done": rng.uniform(size=n) < 0.3,
            "hint": np.zeros((n, NA), np.float32),
            "version": rng.integers(0, 5, n).astype(np.int32),
            "behavior_logp": rng.standard_normal(n).astype(np.float32)})
    return out


@pytest.fixture(scope="module")
def rings():
    spec_j = jr.versioned_spec(jr.transition_spec(OBS, NA))
    spec_t = tr.versioned_spec(tr.transition_spec(OBS, NA))
    jb = jrs.place_on_mesh(jrs.replay_init(SIZE, spec_j, S))
    tb = trs.replay_init(SIZE, spec_t, S, device="cpu")
    add = jax.jit(lambda b, x, e: jrs.replay_add_batch(b, x, errors=e))
    rng = np.random.default_rng(5)
    for x in batches():
        err = rng.uniform(0, 3, len(x["reward"])).astype(np.float32)
        jb = add(jb, {k: jnp.asarray(v) for k, v in x.items()},
                 jnp.asarray(err))
        trs.replay_add_batch(tb, x, errors=t(err))
    return jb, tb


def same_ring(jb, tb):
    assert tb.cntr == int(jb.cntr)
    np.testing.assert_allclose(tb.priority.numpy(), np.asarray(jb.priority),
                               rtol=1e-6)
    for k, v in jb.data.items():
        np.testing.assert_array_equal(tb.data[k].numpy(), np.asarray(v), k)


def test_store_matches_jax(rings):
    jb, tb = rings
    same_ring(jb, tb)
    assert tb.cntr == 38 and tb.filled == SIZE
    # a default-priority store (max priority) and a one-row store
    jb2 = jrs.replay_add(jb, {k: jnp.asarray(v[0]) for k, v in
                              batches(1)[0].items()})
    tb2 = trs.ShardedReplayState(dict((k, v.clone())
                                      for k, v in tb.data.items()),
                                 tb.priority.clone(), tb.cntr, tb.beta)
    trs.replay_add(tb2, {k: v[0] for k, v in batches(1)[0].items()})
    same_ring(jb2, tb2)


def copy(tb):
    return trs.ShardedReplayState({k: v.clone() for k, v in tb.data.items()},
                                  tb.priority.clone(), tb.cntr, tb.beta)


@pytest.mark.parametrize("eta", [None, 0.9])
def test_per_sample_and_update_match(rings, eta):
    jb, tb = rings
    tb = copy(tb)
    sample = jax.jit(lambda b, k: jrs.replay_sample_per(b, k, B,
                                                        recency_eta=eta))
    update = jax.jit(lambda b, i, e: jrs.replay_update_priorities(b, i, e,
                                                                  1.0))
    for i in range(4):
        key = jax.random.PRNGKey(i)
        jbatch, jidx, jw, jb = sample(jb, key)
        tbatch, tidx, tw = trs.replay_sample_per(
            tb, B, u=t(jax.random.uniform(key, (B,))), recency_eta=eta)
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        for k in jbatch:
            np.testing.assert_array_equal(tbatch[k].numpy(),
                                          np.asarray(jbatch[k]), k)
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
        np.testing.assert_allclose(float(tb.beta), float(jb.beta),
                                   rtol=1e-6)
        err = np.linspace(0.1, 2.0, B).astype(np.float32)
        jb = update(jb, jidx, jnp.asarray(err))
        trs.replay_update_priorities(tb, tidx, t(err), 1.0)
        np.testing.assert_allclose(tb.priority.numpy(),
                                   np.asarray(jb.priority), rtol=1e-6)


def test_ere_and_uniform_sample_match(rings):
    jb, tb = rings
    np.testing.assert_allclose(trs.ere_weights(tb, 0.95).numpy(),
                               np.asarray(jrs.ere_weights(jb, 0.95)),
                               rtol=1e-6)
    ere = jax.jit(lambda b, k: jrs.replay_sample_ere(b, k, B, 0.95))
    uni = jax.jit(lambda b, k: jrs.replay_sample_uniform(b, k, B))
    for i in range(4):
        k_ere, k_uni = jax.random.split(jax.random.PRNGKey(10 + i))
        jbatch, jidx = ere(jb, k_ere)
        tbatch, tidx = trs.replay_sample_ere(
            tb, B, 0.95, u=t(jax.random.uniform(k_ere, (B,))))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tbatch["state"].numpy(),
                                      np.asarray(jbatch["state"]))
        jbatch, jidx = uni(jb, k_uni)
        tbatch, tidx = trs.replay_sample_uniform(
            tb, B, gumbel_noise=t(jax.random.gumbel(k_uni, (S, SIZE // S))))
        np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(tbatch["action"].numpy(),
                                      np.asarray(jbatch["action"]))


def test_occupancy_staleness_health_match(rings):
    jb, tb = rings
    for c in (0, 3, 17, 40):
        assert trs.shard_occupancy(c, S, SIZE // S) == \
            jrs.shard_occupancy(c, S, SIZE // S)
    for lv in (0, 4, 9):
        assert trs.version_staleness(tb, lv) == jrs.version_staleness(jb, lv)
    got, want = trs.replay_health(tb), jrs.replay_health(jb)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)


def test_sharded_ring_is_the_flat_ring_interleaved():
    spec = tr.transition_spec(OBS, NA)
    flat = tr.replay_init(SIZE, spec, device="cpu")
    sh = trs.replay_init(SIZE, spec, S, device="cpu")
    for x in batches(2):
        x = {k: v for k, v in x.items() if k in spec}
        tr.replay_add_batch(flat, x, priority=1.0)
        trs.replay_add_batch(sh, x, priority=1.0)
    for k in spec:
        np.testing.assert_array_equal(
            trs._ring_order(sh.data[k]).numpy(), flat.data[k].numpy())
    np.testing.assert_array_equal(
        trs._ring_order(trs.ere_weights(sh, 0.9)).numpy(),
        tr.ere_weights(flat, 0.9).numpy())
    assert trs.replay_health(sh)["priority_entropy"] == pytest.approx(
        tr.replay_health(flat)["priority_entropy"])


def test_one_device_mesh_and_placement():
    m = tmesh.compose_mesh({tmesh.AXIS_BASELINE: 1, tmesh.AXIS_REPLAY: 1},
                           devices=[torch.device("cpu")])
    assert m.axis_names == (tmesh.AXIS_REPLAY, tmesh.AXIS_BASELINE)
    with pytest.raises(tmesh.MeshFactorizationError, match="nearest"):
        tmesh.make_mesh((2,), devices=[torch.device("cpu")])
    with pytest.raises(tmesh.MeshFactorizationError, match="unknown"):
        tmesh.compose_mesh({"zz": 1}, devices=[torch.device("cpu")])
    buf = trs.replay_init(SIZE, tr.transition_spec(OBS, NA), S,
                          device="cpu")
    assert trs.place_on_mesh(buf, m, tmesh.AXIS_REPLAY).n_shards == S
    with pytest.raises(tmesh.MeshFactorizationError):
        trs.place_on_mesh(buf, tmesh.make_mesh(
            devices=[torch.device("cpu")]), tmesh.AXIS_REPLAY)
    with pytest.raises(tmesh.MeshFactorizationError, match="divide"):
        tmesh.check_axis_divides(6, 4, axis=tmesh.AXIS_REPLAY, what="x")
    assert tmesh.largest_divisor(12, 5) == 4


def test_sharded_ring_from_jax(rings):
    """``interop.sharded_replay_from_jax`` carries a JAX sharded ring (its
    ``pack_replay`` payload too) into the port's layout unchanged."""
    from smartcal_tpu.runtime import pack_replay as jax_pack
    from smartcal_tpu_torch import interop
    from smartcal_tpu_torch.runtime import unpack_replay

    jb, tb = rings
    got = trs.replay_from_host(interop.sharded_replay_from_jax(jb), "cpu")
    same_ring(jb, got)
    payload = interop._replay_from_jax(jax_pack(jb))
    assert payload["kind"] == "device_sharded"
    same_ring(jb, unpack_replay(payload, "cpu"))
