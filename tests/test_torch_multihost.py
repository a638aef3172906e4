"""Multi-process runs of the PyTorch port (``parallel/multihost``, the
process form of ``ops/collectives``, meshes of processes and the
``rp``-sharded ring over them) on the CPU: one job of two spawned ranks
over gloo on 127.0.0.1 (``tests/torch_mp_jobs.job_basics``), run once for
the module, each rank with one torch thread.

Held: ``initialize`` is a no-op for one process and the CLI flags round
trip (as tests/test_multihost.py holds the JAX package's); the job's
``runtime_summary`` and a ``process_allgather`` of the rank ids (JAX's
``test_two_process_cpu_job``, which skips here: jaxlib's CPU backend has
no multi-process collectives); the process ``psum`` (a tensor and a
Python number) and ``all_gather`` equal the thread form's bit for bit;
a mesh that mixes process and thread positions raises; the sharded ring
over two ranks (stores, PER / ERE-weighted PER / uniform draws, a
priority update, the health summary and the whole ring) equals the
one-process ring bit for bit; a position that raises in a ``shard_map``
makes the other rank's collective raise ``CollectiveError`` within the
job's timeout, and a rank that raises makes the launcher raise.  A
``cuda``-marked test runs the psum and ``make_parallel_sac`` over two
ranks on one GPU (gloo: the ranks share it); it skips here, and the file
imports no JAX, so ``python -m pytest --noconftest
tests/test_torch_multihost.py -m cuda`` runs it on a machine with a GPU.
"""

import signal

import numpy as np
import pytest
import torch

import torch_mp_jobs as jobs
from smartcal_tpu_torch.parallel import multihost

JOB_TIMEOUT_S = 60.0        # every collective of the job
JOIN_TIMEOUT_S = 150.0      # the whole job
TEST_TIMEOUT_S = 120


@pytest.fixture(autouse=True)
def _deadline():
    """Each test's own timeout (the job itself is bounded by the
    launcher's)."""
    def expired(*_):
        raise TimeoutError(f"test ran past {TEST_TIMEOUT_S} s")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TEST_TIMEOUT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


@pytest.fixture(scope="module")
def basics(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("basics"))
    with pytest.raises(Exception) as failed:
        multihost.launch(jobs.job_basics, 2, args=(out,), device="cpu",
                         timeout=JOB_TIMEOUT_S, join_timeout=JOIN_TIMEOUT_S)
    return {"ranks": [jobs.load(out, f"basics{r}.pkl") for r in range(2)],
            "launch_error": str(failed.value)}


def test_initialize_noop_without_config(monkeypatch):
    for v in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False
    assert not multihost.is_initialized()
    assert multihost.runtime_summary()["process_count"] == 1
    assert multihost.rank_path("run.jsonl") == "run.jsonl"
    with pytest.raises(ValueError, match="coordinator"):
        multihost.initialize(num_processes=2)


def test_add_cli_args_roundtrip():
    import argparse

    p = argparse.ArgumentParser()
    multihost.add_cli_args(p)
    args = p.parse_args(["--coordinator", "h:1234", "--num_processes", "2",
                         "--process_id", "1"])
    assert (args.coordinator, args.num_processes, args.process_id) == \
        ("h:1234", 2, 1)


def test_two_process_cpu_job(basics):
    for r, res in enumerate(basics["ranks"]):
        info = res["summary"]
        assert info["process_count"] == 2 and info["process_index"] == r
        assert info["global_devices"] == 2 and info["local_devices"] == 1
        assert (info["platform"], info["backend"]) == ("cpu", "gloo")
        np.testing.assert_array_equal(res["ids"], [[0], [1]])
        assert res["mesh"][0] and res["mesh"][1] == {"fp": r}
        assert res["index"] == (r, 2)


def test_process_psum_equals_thread_psum_bits(basics):
    xs = [jobs.psum_operand(r) for r in range(2)]
    with jobs.one_thread():
        want, want_f = jobs.thread_psum(xs)
    for res in basics["ranks"]:
        assert torch.equal(res["psum"], want)
        assert res["psum_float"] == want_f
        assert torch.equal(res["gather"], torch.stack(xs))


def test_mixed_mesh_raises(basics):
    for res in basics["ranks"]:
        assert "mixes process positions with thread" in res["mixed"]


def test_rp_sharded_ring_matches_one_process(basics):
    with jobs.one_thread():
        want = jobs.ring_ops(None)
    for res in basics["ranks"]:
        got = res["ring"]
        assert got["local_shards"] == jobs.RING_S // 2
        assert want["local_shards"] == jobs.RING_S
        for k in ("per", "per_ere", "uniform"):
            for g, w in zip(got[k][1:], want[k][1:]):
                assert torch.equal(g, w), k
            for f in want[k][0]:
                assert torch.equal(got[k][0][f], want[k][0][f]), (k, f)
        assert got["health"] == want["health"]
        assert got["ring"]["cntr"] == want["ring"]["cntr"]
        np.testing.assert_array_equal(got["ring"]["priority"],
                                      want["ring"]["priority"])
        for f, v in want["ring"]["data"].items():
            np.testing.assert_array_equal(got["ring"]["data"][f], v)


def test_a_rank_that_raises_makes_the_other_raise(basics):
    r0, r1 = basics["ranks"]
    assert r1["raised"][0] == "ValueError"
    assert r0["raised"][0] == "CollectiveError", r0["raised"]
    assert "psum" in r0["raised"][1]
    assert r0["raised_after_s"] < JOB_TIMEOUT_S + 10
    assert "rank 0 ends with an error on purpose" in basics["launch_error"]


@pytest.mark.cuda
def test_two_ranks_on_one_gpu(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    out = str(tmp_path)
    multihost.launch(jobs.job_cuda, 2, args=(out,),
                     join_timeout=JOIN_TIMEOUT_S)
    got = [jobs.load(out, f"cuda{r}.pkl") for r in range(2)]
    want, _ = jobs.thread_psum([jobs.psum_operand(r) for r in range(2)])
    for res in got:
        assert res["backend"] == "gloo"
        assert torch.equal(res["psum"], want)
    assert got[0]["digest"] == got[1]["digest"]
