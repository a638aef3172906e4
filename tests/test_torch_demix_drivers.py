"""The demixing trainers of the PyTorch port (demix_sac, demix_td3,
demix_fuzzy_sac) and calib_sac's --light/--medium tiers, end to end on
the CPU at the --small backend with K=3: 1 episode x 2 steps each (the
batched arm one vector episode of 2 lanes).  Held: finite scores, the
saved agent, ring and scores, the warm-up's random actions from the
driver's numpy generator, the reward scaling of each trainer, and the
refusals (no GPU, --use_hint with --batch-envs, flags whose machinery is
not ported).
"""

import json
import pickle

import numpy as np
import pytest
import torch

from smartcal_tpu_torch.envs.demixing import BatchedDemixingEnv
from smartcal_tpu_torch.train import (calib_sac, demix_fuzzy_sac, demix_sac,
                                      demix_td3)

CPU = ["--device", "cpu", "--quiet", "--K", "3"]


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


def _load(path):
    with open(path, "rb") as fh:
        return pickle.load(fh)


def _ring(prefix, kind):
    return _load(f"{prefix}replaymem_{kind}.pkl")


@pytest.mark.parametrize("argv,kind,n", [
    (["--use_hint", "--provide_influence", "--warmup", "0"], "sac", 2),
    (["--warmup", "1"], "sac", 2),
    (["--batch-envs", "2", "--iteration", "2", "--warmup", "1"], "sac", 4),
])
def test_demix_sac_trains(tmp_path, argv, kind, n):
    prefix = str(tmp_path / "demix_sac")
    argv = ["--small", "--iteration", "1", "--steps", "2", "--prefix",
            prefix] + CPU + argv
    scores = demix_sac.main(argv)
    lanes = 2 if "--batch-envs" in argv else 1
    assert len(scores) == lanes and np.isfinite(scores).all()
    assert _load(f"{prefix}_scores.pkl") == scores
    assert "actor" in _load(f"{prefix}sac_state.pkl")
    ring = _ring(prefix, kind)
    assert ring["cntr"] == n
    obs_dim = 32 * 32 + 11 if "--provide_influence" in argv else 11
    assert ring["data"]["state"].shape == (n, obs_dim)
    # rewards above 0 are stored x10; the score is the raw mean
    stored = ring["data"]["reward"].reshape(-1)
    raw = np.where(stored > 0, stored / 10, stored)
    np.testing.assert_allclose(np.mean(raw.reshape(-1, lanes), axis=0)
                               if lanes > 1 else raw.mean(),
                               scores if lanes > 1 else scores[0],
                               rtol=1e-5)
    if "--warmup" in argv and argv[argv.index("--warmup") + 1] == "1":
        rng = np.random.default_rng(0)
        shape = (lanes, 3) if lanes > 1 else (3,)
        want = [rng.uniform(-1, 1, shape).astype(np.float32)
                for _ in range(2)]
        np.testing.assert_array_equal(ring["data"]["action"],
                                      np.reshape(want, (n, 3)))


def test_demix_sac_refuses_hint_with_batched_envs(tmp_path):
    with pytest.raises(SystemExit, match="use_hint"):
        demix_sac.main(["--small", "--batch-envs", "2", "--use_hint",
                        "--prefix", str(tmp_path / "x")] + CPU)
    with pytest.raises(ValueError, match="hint"):
        BatchedDemixingEnv(K=3, provide_hint=True, device="cpu")


def test_demix_td3_trains(tmp_path):
    prefix = str(tmp_path / "demix_td3")
    scores = demix_td3.main(["--small", "--iteration", "1", "--steps", "2",
                             "--use_hint", "--prefix", prefix] + CPU)
    assert len(scores) == 1 and np.isfinite(scores).all()
    state = _load(f"{prefix}td3_state.pkl")
    assert state["time_step"] == 2          # the agent's own warm-up
    ring = _ring(prefix, "td3")
    assert ring["cntr"] == 2 and ring["data"]["action"].shape == (2, 3)
    np.testing.assert_allclose(ring["data"]["reward"].mean(), scores[0],
                               rtol=1e-5)          # unscaled rewards
    assert _load(f"{prefix}_scores.pkl") == scores


def test_demix_fuzzy_sac_trains(tmp_path):
    prefix = str(tmp_path / "demix_fuzzy")
    scores = demix_fuzzy_sac.main(["--small", "--iteration", "1", "--steps",
                                   "2", "--use_hint", "--warmup", "0",
                                   "--prefix", prefix] + CPU)
    assert len(scores) == 1 and np.isfinite(scores).all()
    ring = _ring(prefix, "sac")
    assert ring["data"]["action"].shape == (2, 24 * 2 + 8)
    assert ring["data"]["state"].shape == (2, 5 * 3 + 2)
    # the hint is the default controller, the same every step
    np.testing.assert_array_equal(ring["data"]["hint"][0],
                                  ring["data"]["hint"][1])
    stored = ring["data"]["reward"].reshape(-1)
    raw = np.where(stored > 0.01, stored / 10, stored)
    np.testing.assert_allclose(raw.mean(), scores[0], rtol=1e-5)


@pytest.mark.parametrize("tier", ["--light", "--medium"])
def test_calib_sac_takes_the_demixing_tiers(tmp_path, tier):
    prefix = str(tmp_path / "calib")
    scores = calib_sac.main([tier, "--stations", "6", "--npix", "32", "--M",
                             "3", "--episodes", "1", "--steps", "1",
                             "--prefix", prefix, "--device", "cpu",
                             "--quiet"])
    assert len(scores) == 1 and np.isfinite(scores).all()
    args = type("A", (), {"light": tier == "--light",
                          "medium": tier == "--medium", "stations": 6,
                          "npix": 32})()
    b = demix_sac.make_backend(args, "cpu")
    assert (b.n_freqs, b.hint_batch, b.admm_iters) == (2, 1, 30)
    assert b.n_times == (5 if tier == "--light" else 10)


@pytest.mark.parametrize("main", [demix_sac.main, demix_td3.main,
                                  demix_fuzzy_sac.main])
def test_trainers_default_to_cuda_and_refuse_unported_flags(main,
                                                            monkeypatch,
                                                            tmp_path):
    """Without --device the trainers ask for cuda; the runtime flags act:
    a checkpointed episode, then ``--resume`` to the second one, which
    keeps the first episode's score, with a run log."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        main(["--small", "--iteration", "1"])
    monkeypatch.chdir(tmp_path)
    argv = ["--small", "--steps", "1", "--warmup", "0", "--prefix", "d",
            "--ckpt-dir", "ck"] + CPU
    first = main(argv + ["--iteration", "1", "--ckpt-every", "1"])
    scores = main(argv + ["--iteration", "2", "--resume", "--metrics",
                          "m.jsonl", "--watchdog"])
    assert len(scores) == 2 and scores[0] == first[0]
    assert np.all(np.isfinite(scores))
    kinds = [json.loads(ln)["event"] for ln in open("m.jsonl")]
    assert "resume" in kinds and "diag" in kinds
