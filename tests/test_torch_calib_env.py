"""CalibEnv of the PyTorch port vs the JAX package, step by step.

Both envs start from the same seed: the port's numpy threefry walks the
same key chain, so both build the same episodes.  Everything downstream is
f32 with different reduction orders and trig (the coherency phases reach
~1e4 rad), so the observations, rewards and sigma_res are held at a
relative 1e-3 — the solver's sigma_res band (precision.py:31-35).

Some drawn episodes are ill-conditioned: in the fixed_K=2 episode of seed
0 the ~1e-4 relative difference of the two packages' visibilities (f32
phase round-off) moves the solved sigma_res by ~1% and the influence map
by tens of percent, while the same visibilities give the same solution to
1e-5 in both packages.  That case therefore hands the JAX episode to the
port (``interop``) and checks the env logic on identical data.
"""

import jax
import numpy as np
import pytest
import torch

from smartcal_tpu.envs.calib import CalibEnv as JaxEnv
from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.envs.calib import CalibEnv as TorchEnv
from smartcal_tpu_torch.envs.radio import RadioBackend as TorchBackend

TINY = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=32)
TOL = 1e-3


def rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _pair(shared_episode=False, **kw):
    j = JaxEnv(M=3, backend=JaxBackend(shard=False, **TINY), seed=0, **kw)
    t = TorchEnv(M=3, backend=TorchBackend(device="cpu", **TINY), seed=0,
                 device="cpu", **kw)
    if shared_episode:
        build = t.backend.new_calib_episode

        def from_jax(key, K, M):
            _, mdl = build(key, K, M)          # the port's own draws
            jep, _ = j.backend.new_calib_episode(jax.numpy.asarray(key), K, M)
            return interop.episode_from_numpy(jep), mdl

        t.backend.new_calib_episode = from_jax
    return j, t


def _compare_obs(jo, to):
    assert to["img"].shape == jo["img"].shape == (32, 32)
    np.testing.assert_array_equal(to["sky"], jo["sky"])
    assert rel(to["img"], jo["img"]) < TOL


@pytest.mark.parametrize("kw", [
    {"provide_hint": True},
    {"fixed_K": 2, "baseline_reward": True, "shared_episode": True}],
    ids=["hint", "fixedK-baseline-shared-episode"])
def test_reset_and_two_steps_match(kw):
    jenv, tenv = _pair(**kw)
    _compare_obs(jenv.reset(), tenv.reset())
    assert jenv.K == tenv.K
    np.testing.assert_allclose(tenv._sigma_data_img, jenv._sigma_data_img,
                               rtol=TOL)
    if kw.get("provide_hint"):
        np.testing.assert_array_equal(tenv.hint, jenv.hint)
    rng = np.random.default_rng(1)
    for i in range(2):
        if kw.get("provide_hint") and i == 0:
            action = jenv.hint
        else:
            action = rng.uniform(-1, 1, 6).astype(np.float32)
        jout, tout = jenv.step(action), tenv.step(action)
        _compare_obs(jout[0], tout[0])
        np.testing.assert_allclose(tout[1], jout[1], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tout[-1]["sigma_res"],
                                   jout[-1]["sigma_res"], rtol=TOL)
        assert tout[-1]["sigma_res"] < tout[-1]["sigma_data"]


def test_entry_points_default_to_cuda_and_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="no GPU"):
        TorchEnv()
    with pytest.raises(RuntimeError, match="no GPU"):
        TorchEnv(backend=TorchBackend(device="cpu", **TINY))


def test_backend_device_mismatch_rejected():
    with pytest.raises(ValueError):
        TorchEnv(backend=TorchBackend(device="cpu", **TINY), device="meta")
