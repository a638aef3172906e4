"""The port's stage-cost accounting (``obs/costs``) against the JAX
package's contract: tests/test_diagnostics.py's five cases on the port,
``cal/solver.cost_eval_flops``'s analytic model equal to JAX's, the
kernel wrappers' analytic counts on their CPU plain paths, and
``tools/obs_report.py`` rendering a port run's roofline rows.

The port counts by running the stage under a dispatch mode: a matrix
product of (8, 8) by (8, 8) is 2·8·8·8 flops, a pointwise op one flop per
output element, bytes the op's inputs plus its outputs.
"""

import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu_torch import obs
from smartcal_tpu_torch.cal import solver as tsolver
from smartcal_tpu_torch.obs import costs
from smartcal_tpu_torch.ops import dft_imager, hessian_blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import obs_report  # noqa: E402


def read_jsonl(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


@pytest.fixture(autouse=True)
def _fresh():
    costs.set_enabled(False)
    costs.reset_cache()
    yield
    costs.set_enabled(False)
    costs.reset_cache()


def test_stage_cost_counts_flops():
    x = torch.ones(8, 8)
    c = costs.stage_cost(lambda a, b: a @ b, x, x)
    assert c["flops"] == 2.0 * 8 * 8 * 8
    assert c["bytes_accessed"] == 3 * 8 * 8 * 4
    assert c["peak_bytes"] == 8 * 8 * 4
    c = costs.stage_cost(lambda a: (a * 2.0).sum(), x)
    assert c["flops"] == 64 + 1


def test_record_stage_cost_gating_and_cache(tmp_path):
    path = str(tmp_path / "c.jsonl")

    def f(a):
        return a * 2.0

    x = torch.ones(4)
    assert costs.record_stage_cost("s", f, x) is None     # no runlog
    with obs.recording(path):
        assert costs.record_stage_cost("s", f, x) is None  # not enabled
        costs.set_enabled(True)
        c1 = costs.record_stage_cost("s", f, x)
        assert c1["flops"] >= 0
        assert costs.record_stage_cost("s", f, x) == c1   # cached
        costs.record_stage_cost("s", f, torch.ones(8))    # new signature
        # a float is data (a traced scalar in JAX), not a new signature
        costs.record_stage_cost("s", lambda a, k: a * k, x, 2.0)
        costs.record_stage_cost("s", lambda a, k: a * k, x, 3.0)
    evs = [e for e in read_jsonl(path) if e["event"] == "cost"]
    assert len(evs) == 3
    assert all(e["stage"] == "s" for e in evs)


def test_record_stage_cost_failure_is_recorded_not_raised(tmp_path):
    path = str(tmp_path / "c.jsonl")

    def boom(a):
        raise ValueError("no count for you")

    with obs.recording(path):
        costs.set_enabled(True)
        out = costs.record_stage_cost("bad", boom, torch.ones(2))
        assert "error" in out
        assert costs.record_stage_cost("bad", boom, torch.ones(2)) == out
    evs = [e for e in read_jsonl(path) if e["event"] == "cost"]
    assert len(evs) == 1 and "error" in evs[0]


def test_record_stage_cost_defer_flush(tmp_path):
    path = str(tmp_path / "c.jsonl")

    def f(a):
        return a + 1.0

    x = torch.ones(4)
    with obs.recording(path):
        costs.set_enabled(True)
        assert costs.record_stage_cost("d", f, x, defer=True) is None
        assert costs.record_stage_cost("d", f, x, defer=True) is None
        assert not [e for e in read_jsonl(path) if e["event"] == "cost"]
        assert costs.flush_pending() == 1
        assert costs.flush_pending() == 0
        assert costs.record_stage_cost("d", f, x)["flops"] >= 0
    evs = [e for e in read_jsonl(path) if e["event"] == "cost"]
    assert len(evs) == 1 and evs[0]["stage"] == "d"


def test_roofline_peak_cpu_graceful(tmp_path):
    assert costs.device_peak() is None   # no card here
    path = str(tmp_path / "c.jsonl")
    with obs.recording(path):
        assert costs.log_roofline_peak() is None
    assert not [e for e in read_jsonl(path)
                if e["event"] == "roofline_peak"]
    assert costs.PEAK_FLOPS["H100"] == {"bf16": 989e12, "fp32_est": 67e12,
                                        "chip": "H100"}


def test_cost_eval_flops_model_matches_jax():
    kw = dict(n_stations=6, n_dirs=3)
    args = (2, 2, 3, 15)                       # Nf, Ts, td, B
    t = tsolver.cost_eval_flops(tsolver.SolverConfig(**kw), *args,
                                device="cpu")
    j = jsolver.cost_eval_flops(jsolver.SolverConfig(**kw), *args)
    for k in ("model_value_and_grad_flops", "model_linesearch_setup_flops"):
        assert t[k] == j[k], k
    assert t["counted_value_and_grad_flops"] > 0
    assert t["counted_linesearch_setup_flops"] > 0
    assert t["vag_model_over_counted"] > 0


def test_kernel_wrappers_add_their_analytic_count():
    """On the CPU plain paths the wrapper's analytic count replaces the
    plain version's ops: the DFT image is its 4 npix² R flops plus the uv
    scaling outside the kernel (2R flops; its (R, 2) operand and result
    and the 4-byte scale); the Hessian block sums exactly their analytic
    count."""
    rng = np.random.default_rng(0)
    R, npix = 50, 16
    uvw = torch.tensor(rng.standard_normal((R, 3)) * 100, dtype=torch.float32)
    vis = torch.tensor(rng.standard_normal((R, 2)), dtype=torch.float32)
    c = costs.stage_cost(dft_imager.dirty_image, uvw, vis, 150e6, 1e-3,
                         npix=npix)
    flops, nbytes = dft_imager.image_cost(npix, R)
    assert c["flops"] == flops + 2 * R
    assert c["bytes_accessed"] == nbytes + 2 * R * 4 * 2 + 4
    N, K, Td = 5, 2, 3
    B = N * (N - 1) // 2
    sched, p, q = hessian_blocks.full_schedule(N, torch.device("cpu"))

    def rnd(*shape):
        return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)

    hargs = (rnd(Td, B, 2, 2, 2), rnd(K, Td, B, 2, 2, 2), rnd(K, B, 2, 2, 2),
             rnd(K, B, 2, 2, 2), p, q, N)
    c = costs.stage_cost(hessian_blocks.hessian_block_sums, *hargs)
    want = hessian_blocks.block_sums_cost(*hargs)
    assert (c["flops"], c["bytes_accessed"]) == want
    # outside a count the context is a no-op
    with costs.kernel_cost(1.0, 1.0):
        assert not costs.counting()


def test_obs_report_renders_a_port_roofline(tmp_path):
    """A port run with spans and counted stages: tools/obs_report.py joins
    the cost events with the span stream (calls, achieved rate, fraction
    of the card's peak) unchanged."""
    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.envs.radio import RadioBackend

    be = RadioBackend(device="cpu", n_stations=6, n_freqs=2, n_times=4,
                      tdelta=2, admm_iters=2, lbfgs_iters=3, init_iters=5,
                      npix=16)
    path = str(tmp_path / "run.jsonl")
    with obs.recording(path, meta={"entry": "port_test"}) as rl:
        costs.set_enabled(True)
        # the event the card's device_peak() logs
        rl.log("roofline_peak", platform="gpu", device_kind="NVIDIA H100",
               power_limit="700.00 W", **costs.PEAK_FLOPS["H100"])
        for i in range(2):
            with obs.span("episode", episode=i):
                ep, _ = be.new_calib_episode(prng.PRNGKey(i), 2, 3)
                res = be.calibrate(ep, np.ones(3, np.float32))
                be.influence_image(ep, res, np.ones(3), np.ones(3))
            assert costs.flush_pending() >= (3 if i == 0 else 0)
    run = obs_report.load_run(path)
    rep = obs_report.build_report([run], n_boot=20)
    rl_ = rep["runs"][0]["roofline"]
    assert rl_["peak"]["chip"] == "H100"
    for stage in ("simulate", "solve", "influence"):
        row = rl_["stages"][stage]
        assert row["flops_per_call"] > 0 and row["bytes_per_call"] > 0
        assert row["calls"] >= 2 and row["achieved_flops_per_s"] > 0
        assert row["peak_dtype"] == "fp32_est" and "fraction_of_peak" in row
    assert rl_["stages"]["solve"]["signatures"] == 1
    text = obs_report.render(rep)
    assert "-- roofline" in text and "influence" in text
