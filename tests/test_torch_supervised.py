"""The supervised slice of the PyTorch port against the JAX package:
featurization (``supervised.generate_training_data``'s and
``dataset.get_info_from_dataset``'s), the model influences, the
``evaluate`` CLI and ``evaluate_models``.

One backend shape for the file: N=6, Nf=3, T=8, tdelta=4, npix=8, K=3,
admm 2 / L-BFGS 3 / init 5 (tests/test_ms_io.py's counts).

Tolerances.  The calibration solve is chaotic in float32 (ROADMAP queue
3), so featurization is held on a SHARED solve: the JAX package's
``SolveResult`` (and, for the real-data path, its coherencies) carried
into the port.  There each direction's unit-norm image block and the
perdir scalars are held at the influence tests' 1e-4 relative (the
log-norms and LLR at atol 1e-4 on the logs, separations, azimuths,
elevations and log f_0 exactly: the same host numbers).  End to end at
these tiny iteration counts the packages solve apart by float32
round-off amplified through 10 L-BFGS steps, so only the layout, the
metadata (rtol 1e-5) and finiteness are held there, and each image block
within 5e-2 relative.  The model influences: the TSK's Taylor form at
rtol 1e-3 (10 normalized HVP recursions in float32), the transformer's on
the JAX warm-up's curvature pairs at 1e-3 relative norm; the port's own
stochastic L-BFGS against the JAX ``lbfgs_step`` at 1e-4 relative over 3
steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import coherency as jcoh
from smartcal_tpu.cal import dataset as jdataset
from smartcal_tpu.cal import ms_io as jms
from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu.models import transformer as jtr
from smartcal_tpu.models import tsk as jtsk
from smartcal_tpu.ops import lbfgs as jlbfgs
from smartcal_tpu.train import model_influence as jmi
from smartcal_tpu.train import supervised as jsup
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.cal import coherency as tcoh
from smartcal_tpu_torch.cal import dataset as tdataset
from smartcal_tpu_torch.cal import ms_io as tms
from smartcal_tpu_torch.envs.radio import RadioBackend
from smartcal_tpu_torch.models import transformer as ttr
from smartcal_tpu_torch.ops import lbfgs as tlbfgs
from smartcal_tpu_torch.train import evaluate as tev
from smartcal_tpu_torch.train import evaluate_models as tevm
from smartcal_tpu_torch.train import model_influence as tmi
from smartcal_tpu_torch.train import supervised as tsup

SHAPE = dict(n_stations=6, n_freqs=3, n_times=8, tdelta=4, npix=8,
             admm_iters=2, lbfgs_iters=3, init_iters=5)
K, NPIX, SEED = 3, 8, 3
NOUT = NPIX * NPIX + 8


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


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def hold_features(x, ref, img_rel, shared=True):
    """Per direction: the image block, then the eight scalars."""
    assert x.shape == ref.shape == (K * NOUT,)
    assert np.all(np.isfinite(x))
    for ck in range(K):
        o = ck * NOUT
        img, rimg = x[o:o + NPIX * NPIX], ref[o:o + NPIX * NPIX]
        assert abs(np.linalg.norm(img) - 1.0) < 1e-5
        assert rel(img, rimg) < img_rel, (ck, rel(img, rimg))
        s, rs = x[o + NPIX * NPIX:o + NOUT], ref[o + NPIX * NPIX:o + NOUT]
        np.testing.assert_allclose(s[[0, 1, 2, 7]], rs[[0, 1, 2, 7]],
                                   rtol=1e-5, atol=1e-5)
        if shared:
            np.testing.assert_allclose(s[3:6], rs[3:6], atol=1e-4)
            assert abs(s[6] - rs[6]) <= 1e-4 * max(abs(rs[6]), 1.0)


@pytest.fixture(scope="module")
def jax_backend():
    return JaxBackend(shard=False, **SHAPE)


@pytest.fixture(scope="module")
def backend():
    return RadioBackend(device="cpu", **SHAPE)


def test_training_features_on_a_shared_solve(jax_backend):
    key = jax.random.PRNGKey(SEED)
    ref_x, ref_y = jsup.generate_training_data(key, jax_backend, K=K)
    ep, mdl = jax_backend.new_demixing_episode(key, K)
    res = jax_backend.calibrate(ep, mdl.rho, mask=np.ones(K, np.float32))
    tep = interop.episode_from_numpy(ep)
    tres = interop.solve_result_from_numpy(res)
    stages = {}
    x = tdataset.perdir_features(
        tres.residual[0], tep.Ccal[0], tres.J[0], mdl.rho,
        np.asarray(ep.obs.freqs), ep.f0, tep.obs.uvw, SHAPE["n_stations"],
        2, mdl.separations, mdl.azimuth, mdl.elevation, npix=NPIX,
        stage_seconds=stages)
    hold_features(x, ref_x, 1e-4)
    assert set(stages) == {"perdir_influence", "features"}
    assert ref_y.shape == (K - 1,)


def test_training_data_end_to_end(jax_backend, backend):
    key = jax.random.PRNGKey(SEED)
    ref_x, ref_y = jsup.generate_training_data(key, jax_backend, K=K)
    x, y = tsup.generate_training_data(np.asarray(key, np.uint32), backend,
                                       K=K)
    hold_features(x, ref_x, 5e-2, shared=False)
    np.testing.assert_array_equal(y, ref_y)
    for st in ("simulate", "solve", "perdir_influence", "features"):
        assert backend.stage_seconds[st] > 0
    buf = tsup.make_transformer_dataset(n_iter=2, K=K, backend=backend,
                                        seed=SEED)
    assert buf.mem_cntr == 2 and buf.x.shape == (8, K * NOUT)
    assert np.all(np.isfinite(buf.x[:2]))


@pytest.fixture(scope="module")
def ms_pair(tmp_path_factory, jax_backend):
    ep, _ = jax_backend.new_demixing_episode(jax.random.PRNGKey(7), K)
    d = tmp_path_factory.mktemp("ms")
    tep = interop.episode_from_numpy(ep)
    (d / "t").mkdir()
    (d / "j").mkdir()
    return (tms.observation_to_ms_set(str(d / "t"), tep.obs, tep.V), d / "t",
            jms.observation_to_ms_set(str(d / "j"), ep.obs,
                                      np.asarray(ep.V)), d / "j")


def test_single_band_coherencies_match():
    from smartcal_tpu.cal import skyio as jsky

    sky_p, clus_p, _ = tdataset.ateam_paths()
    ra0, dec0 = 1.0, 0.9
    tsky = interop.sky_from_numpy(jsky.build_sky_arrays(sky_p, clus_p, ra0,
                                                        dec0))
    keep = np.asarray(tsky.cluster) == 1          # the nearest cluster
    rng = np.random.default_rng(0)
    uvw = (rng.standard_normal((40, 3)) * 300.0).astype(np.float32)
    jskyarr = jsky.build_sky_arrays(sky_p, clus_p, ra0, dec0)
    ref = np.asarray(jcoh.predict_coherencies_sr(
        uvw[:, 0], uvw[:, 1], uvw[:, 2], jskyarr, 143.3e6))
    u = torch.from_numpy(uvw)
    out = tcoh.predict_coherencies_sr(u[:, 0], u[:, 1], u[:, 2], tsky,
                                      143.3e6).numpy()
    assert out.shape == ref.shape
    assert keep.any()
    # the A-team phases reach ~1e4 rad: ~1e-3 float32 error in each
    # package (tests/test_torch_demixing.py)
    assert rel(out, ref) < 5e-3


def test_real_data_features_on_a_shared_solve(ms_pair, monkeypatch):
    tlist, tdir, jlist, jdir = ms_pair
    seen = {}
    jpred, jsolve = jcoh.predict_coherencies_sr, jsolver.solve_admm

    def pred(*a, **kw):
        out = jpred(*a, **kw)
        seen.setdefault("C", []).append(np.asarray(out))
        return out

    def solve(*a, **kw):
        seen["res"] = jsolve(*a, **kw)
        return seen["res"]

    monkeypatch.setattr(jcoh, "predict_coherencies_sr", pred)
    monkeypatch.setattr(jsolver, "solve_admm", solve)
    ref = jdataset.get_info_from_dataset(
        jlist, timesec=8.0, Ninf=NPIX, K=K, tdelta=4, admm_iters=2,
        lbfgs_iters=3, init_iters=5, workdir=str(jdir),
        rng=np.random.default_rng(1))
    shared = iter(seen["C"])
    monkeypatch.setattr(tcoh, "predict_coherencies_sr",
                        lambda *a, **kw: torch.from_numpy(next(shared)))
    monkeypatch.setattr(tdataset.solver, "solve_admm",
                        lambda *a, **kw: interop.solve_result_from_numpy(
                            seen["res"]))
    stages = {}
    x = tdataset.get_info_from_dataset(
        tlist, timesec=8.0, Ninf=NPIX, K=K, tdelta=4, admm_iters=2,
        lbfgs_iters=3, init_iters=5, workdir=str(tdir),
        rng=np.random.default_rng(1), device="cpu", stage_seconds=stages)
    hold_features(x, ref, 1e-4)
    assert set(stages) == {"extract", "sky", "solve", "perdir_influence",
                           "features"}


def test_real_data_features_end_to_end(ms_pair):
    tlist, tdir, jlist, jdir = ms_pair
    kw = dict(timesec=8.0, Ninf=NPIX, K=K, tdelta=4, admm_iters=2,
              lbfgs_iters=3, init_iters=5)
    ref = jdataset.get_info_from_dataset(jlist, workdir=str(jdir),
                                         rng=np.random.default_rng(2), **kw)
    x = tdataset.get_info_from_dataset(tlist, workdir=str(tdir),
                                       rng=np.random.default_rng(2),
                                       device="cpu", **kw)
    hold_features(x, ref, 5e-2, shared=False)
    with pytest.raises(ValueError, match="directions"):
        tdataset.get_info_from_dataset(
            tlist, workdir=str(tdir), device="cpu",
            **dict(kw, K=4), sky_path=tdataset.ateam_paths()[0],
            cluster_path=tdataset.ateam_paths()[1])


def test_stochastic_lbfgs_matches_jax():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((6, 20, 8)).astype(np.float32)
    b = rng.standard_normal((6, 20)).astype(np.float32)
    x0 = np.zeros(8, np.float32)
    jst, tst = jlbfgs.lbfgs_init(jnp.asarray(x0)), tlbfgs.lbfgs_init(
        torch.from_numpy(x0))
    for i in range(3):
        Aj, bj = jnp.asarray(A[i]), jnp.asarray(b[i])
        At, bt = torch.from_numpy(A[i]), torch.from_numpy(b[i])
        jst, jl = jlbfgs.lbfgs_step(
            lambda x, Aj=Aj, bj=bj: jnp.mean((Aj @ x - bj) ** 2), jst,
            max_iter=4)
        tst, tl = tlbfgs.lbfgs_step(
            lambda x, At=At, bt=bt: torch.mean((At @ x - bt) ** 2), tst,
            max_iter=4)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-4)
        assert rel(tst.x.numpy(), jst.x) < 1e-4
        assert int(tst.hist.count[0]) == int(jst.hist.count)
        assert rel(tst.hist.s[0].numpy(), jst.hist.s) < 1e-4
        np.testing.assert_allclose(float(tst.alphabar), float(jst.alphabar),
                                   rtol=1e-4)


def test_tsk_influence_matches():
    rng = np.random.default_rng(1)
    M = 3 * K + 2
    X = rng.standard_normal((30, M)).astype(np.float32)
    y = np.tanh(X[:, :K - 1] + 0.1 * rng.standard_normal((30, K - 1))
                ).astype(np.float32)
    params = jtsk.train_tsk(jax.random.PRNGKey(0), X, y, n_iter=50)["params"]
    ref = jmi.tsk_influence(params, X, y, n_avg=3, taylor_iters=5)
    out = tmi.tsk_influence(interop.tsk_params_from_jax(params), X, y,
                            n_avg=3, taylor_iters=5, device="cpu")
    assert out.shape == ref.shape == (K - 1, M)
    np.testing.assert_allclose(out, ref, rtol=1e-3,
                               atol=1e-3 * np.abs(ref).max())


def test_transformer_influence_matches(tmp_path, monkeypatch):
    npix, nout = 4, 4 * 4 + 8
    rng = np.random.default_rng(0)
    buf = jtr.XYBuffer(12, (K * nout,), (K - 1,))
    for _ in range(12):
        buf.store(rng.standard_normal(K * nout).astype(np.float32),
                  (rng.random(K - 1) > 0.5).astype(np.float32))
    params, hist = jsup.train_transformer(buf, K=K, model_dim=2, epochs=5,
                                          batch_size=4)
    seen = {}
    jinf = jmi.influence_matrix

    def capture(*a, hist=None, **kw):
        seen["hist"] = hist
        return jinf(*a, hist=hist, **kw)

    monkeypatch.setattr(jmi, "influence_matrix", capture)
    ref, _ = jmi.transformer_influence(params, hist["model"], buf, K=K,
                                       npix=npix, warmup_epochs=2)
    model = ttr.build_transformer(K, npix, 2)
    tparams = {k: v.detach() for k, v in
               interop.transformer_params_from_flax(params, model).items()}
    h = seen["hist"]
    carried = tlbfgs.LBFGSHistory(
        s=torch.from_numpy(np.array(h.s))[None],
        y=torch.from_numpy(np.array(h.y))[None],
        count=torch.tensor([int(h.count)], dtype=torch.int32),
        gamma=torch.tensor([float(h.gamma)]))
    x0 = torch.from_numpy(buf.x[0])
    y0 = torch.from_numpy(buf.y[0])
    out = tmi.influence_matrix(
        lambda p, xx: torch.func.functional_call(model, p, (xx[None],))[0],
        tparams, x0, y0, hist=carried).detach().numpy()
    assert out.shape == ref.shape == (K - 1, K * nout)
    assert rel(out, ref) < 1e-3

    If, maps = tmi.transformer_influence(
        tparams, model, interop.xy_buffer_from_numpy(buf), K=K, npix=npix,
        warmup_epochs=3, outdir=str(tmp_path), device="cpu")
    assert If.shape == (K - 1, K * nout) and np.all(np.isfinite(If))
    assert not np.allclose(If, 0.0)
    np.testing.assert_array_equal(maps[(0, 1)].ravel(),
                                  If[0, nout:nout + npix * npix])
    np.testing.assert_array_equal(maps[("meta", 0, 0)],
                                  If[0, npix * npix:nout])
    assert (tmp_path / "transformer_influence.npz").exists()


def test_evaluate_selftest_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    argv = ["--selftest", "--stations", "6", "--times", "8", "--tdelta",
            "4", "--npix", "8", "--K", "3"]
    probs = tev.main(argv + ["--device", "cpu"])
    assert probs.shape == (K - 1,)
    assert np.all((probs >= 0) & (probs <= 1))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            tev.main(argv)


def test_recommend_reads_a_saved_model(tmp_path, ms_pair):
    tlist, _, _, _ = ms_pair
    model = ttr.build_transformer(K, NPIX, 2,
                                  generator=torch.Generator().manual_seed(0))
    tev.save_model(str(tmp_path / "net.pkl"), dict(model.named_parameters()),
                   K=K, npix=NPIX, model_dim=2)
    back, params, k2, n2 = tev.load_model(str(tmp_path / "net.pkl"),
                                          device="cpu")
    assert (k2, n2) == (K, NPIX)
    for k, v in model.state_dict().items():
        assert torch.equal(back.state_dict()[k], v)
    stages = {}
    probs = tev.recommend(tlist, 8.0, str(tmp_path / "net.pkl"), tdelta=4,
                          workdir=str(tmp_path), device="cpu",
                          stage_seconds=stages)
    assert probs.shape == (K - 1,) and np.all((probs >= 0) & (probs <= 1))
    assert "forward" in stages and "solve" in stages


def test_evaluate_models_on_the_cpu(tmp_path):
    res = tevm.main(["--small", "--games", "1", "--K", "3", "--device",
                     "cpu"])
    assert set(res) == {"nohint", "withhint", "untrained", "hint"}
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in res.values())
    with pytest.raises(FileNotFoundError):
        tevm.main(["--small", "--games", "1", "--K", "3", "--device", "cpu",
                   "--nohint", str(tmp_path / "missing_")])


def test_hint_dataset_and_evaluate_tsk_msp(backend):
    from smartcal_tpu_torch.envs.demixing import DemixingEnv

    buf = tsup.make_hint_dataset(n_iter=2, K=K, backend=backend, seed=0,
                                 device="cpu")
    assert buf.mem_cntr == 2 and buf.x.shape[1] == 3 * K + 2
    assert np.all(np.abs(buf.y[:2]) <= 1.0)
    params, hist = tsup.train_regressor(buf, n_iter=20, batch_size=2,
                                        device="cpu")
    tsk = tsup.train_tsk_on_buffer(buf, n_iter=20, batch_size=2,
                                   device="cpu")
    env = DemixingEnv(K=K, provide_hint=True, backend=backend, seed=1,
                      device="cpu")
    out = tsup.evaluate_tsk_msp(buf, params, hist["net"], tsk["params"],
                                env, episodes=1)
    assert all(len(v) == 1 and np.isfinite(v[0]) for v in out.values())


def test_plots_name_matplotlib_when_absent(monkeypatch):
    import builtins

    from smartcal_tpu_torch.train import plots

    real = builtins.__import__

    def no_mpl(name, *a, **kw):
        if name.split(".")[0] == "matplotlib":
            raise ImportError("No module named 'matplotlib'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_mpl)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.plot_rewards([[0.0, 1.0]])
    np.testing.assert_allclose(plots.gray_to_unit(np.eye(3)).max(), 0.9)
