"""Episode prefetch of the PyTorch port (the JAX package's
``RadioBackend.prefetch_episode`` / ``take_prefetched`` /
``run_pipelined`` and ``CalibEnv(prefetch=True)``): the worker thread
builds the same episodes bit for bit, a closed env drops its pending
build, and the worker's exception comes back to the caller."""

import threading

import numpy as np
import pytest

from smartcal_tpu_torch import prng
from smartcal_tpu_torch.envs.calib import CalibEnv
from smartcal_tpu_torch.envs.radio import RadioBackend

TINY = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=32)
M = 3


def env(prefetch, seed=3, **kw):
    return CalibEnv(M=M, backend=RadioBackend(device="cpu", **TINY),
                    seed=seed, device="cpu", prefetch=prefetch, **kw)


def test_prefetch_walks_the_same_episodes():
    plain, pre = env(False, provide_hint=True), env(True, provide_hint=True)
    rng = np.random.default_rng(0)
    for _ in range(3):
        a, b = plain.reset(), pre.reset()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(plain.ep.V, pre.ep.V)
        np.testing.assert_array_equal(plain.hint, pre.hint)
        act = rng.uniform(-1, 1, 2 * M).astype(np.float32)
        sa, sb = plain.step(act), pre.step(act)
        np.testing.assert_array_equal(sa[0]["img"], sb[0]["img"])
        assert sa[1] == sb[1]
    counts = pre.backend.prefetch_counts
    assert counts["hit"] + counts["stall"] == 2 and counts["miss"] == 1
    pre.close()
    assert not pre.backend._prefetched


def test_run_pipelined_equals_the_sequential_loop():
    b = RadioBackend(device="cpu", **TINY)
    keys = [prng.PRNGKey(s) for s in (1, 2, 3)]

    def make(key):
        return b.new_calib_episode(key, 2, M)

    def process(ep, mdl):
        return ep.V.clone(), mdl.sky_table.copy()

    want = [process(*make(k)) for k in keys]
    got = list(b.run_pipelined(keys, make, process))
    assert len(got) == len(want)
    for (gv, gs), (wv, ws) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gs, ws)
    assert list(b.run_pipelined([], make, process)) == []


def test_close_discards_the_pending_build():
    e = env(True)
    gate = threading.Event()
    busy = e.backend._worker().submit(gate.wait, 30)  # the build queues
    try:
        e.reset()
        fut = e.backend._prefetched[e._pf_tag]
        e.close()
        assert fut.cancelled()
        assert e._pf_tag is None and not e.backend._prefetched
    finally:
        gate.set()
    assert busy.result(timeout=30)


def test_worker_exception_comes_back_from_reset():
    e = env(True)
    build = e.backend.new_calib_episode
    calls = []

    def failing(key, K, M_):
        calls.append(key)
        if len(calls) == 2:                  # the prefetched build
            raise RuntimeError("episode build failed")
        return build(key, K, M_)

    e.backend.new_calib_episode = failing
    e.reset()
    with pytest.raises(RuntimeError, match="episode build failed"):
        e.reset()
