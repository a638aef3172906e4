"""The oracle chain of the PyTorch port (the reference formulation of
cal/kernels.py and cal/influence.py) against the JAX package's, and
against the port's optimized chain.

One toy problem (N=5, K=3, two intervals of three slots) built from a
numpy seed crosses as numpy.  Each port kernel takes the JAX twin's own
operands (its Hessian, its dJ), so a case measures one kernel.  Bounds
are the JAX package's: the Hessian rtol 2e-5 / atol 2e-5; dJ, dR and the
LLR rtol 1e-3 / atol 1e-4 (a solve against a (2*4N)-square system);
the column means rtol 1e-4 / atol 1e-6; the optimized chain against the
oracle as in tests/test_influence_opt.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import consensus as jcons
from smartcal_tpu.cal import creal as jcreal
from smartcal_tpu.cal import imager as jimager
from smartcal_tpu.cal import influence as jinf
from smartcal_tpu.cal import kernels as jk
from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu_torch.cal import consensus as tcons
from smartcal_tpu_torch.cal import creal as tcreal
from smartcal_tpu_torch.cal import imager as timager
from smartcal_tpu_torch.cal import influence as tinf
from smartcal_tpu_torch.cal import kernels as tk
from smartcal_tpu_torch.cal import solver as tsolver

N, K, TS, TD = 5, 3, 2, 3
B = N * (N - 1) // 2
HESS = dict(rtol=2e-5, atol=2e-5)
DERIV = dict(rtol=1e-3, atol=1e-4)
COLMEANS = dict(rtol=1e-4, atol=1e-6)


def t(x):
    return torch.as_tensor(np.array(x))


def close(got, want, tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), **tol)


@pytest.fixture(scope="module")
def problem():
    """Complex operands of one interval (R, C, J), the whole sub-band's
    split-real ones and the JAX oracle's Hessian and dJ."""
    rng = np.random.default_rng(11)
    T = TS * TD

    def cplx(*shape):
        return (rng.standard_normal(shape)
                + 1j * rng.standard_normal(shape)).astype(np.complex64)

    R, C, J = cplx(2 * B * T, 2), cplx(K, T * B, 4), cplx(TS, K, 2 * N, 2)
    hadd = np.asarray([0.5, 1.0, 0.25], np.float32)
    Rs = jcreal.split(R).reshape(-1, 2, 2)
    Cs, Js = jcreal.split(C), jcreal.split(J)
    R1 = Rs.reshape(TS, 2 * B * TD, 2, 2)[0]
    C1 = Cs.reshape(K, TS, B * TD, 4, 2)[:, 0]
    J1 = Js[0]
    H = jk.hessian_res_sr(R1, C1, J1, N)
    n4 = jnp.arange(4 * N)
    Dg = H.at[:, n4, n4, 0].add(hadd[:, None])
    dJ = jk.dsolutions_all_sr(C1, J1, N, Dg)
    return dict(R=R[:2 * B * TD], C=np.asarray(C).reshape(K, TS, B * TD, 4)
                [:, 0], J=J[0], Rs=Rs, Cs=Cs, Js=Js, hadd=hadd, R1=R1,
                C1=C1, J1=J1, H=H, Dg=Dg, dJ=dJ)


@pytest.mark.parametrize("name", ["hessian_res_sr", "hessian_res_opt_sr"])
def test_hessian_matches_jax(problem, name):
    p = problem
    got = getattr(tk, name)(t(p["R1"]), t(p["C1"]), t(p["J1"]), N)
    close(got, getattr(jk, name)(p["R1"], p["C1"], p["J1"], N), HESS)


def test_hessian_oracle_equals_optimized_core(problem):
    """The scatter placement and the gathered one agree to round-off."""
    p = problem
    ops = (t(p["R1"]), t(p["C1"]), t(p["J1"]), N)
    close(tk.hessian_res_opt_sr(*ops), tk.hessian_res_sr(*ops).numpy(), HESS)


def test_dsolutions_matches_jax(problem):
    p = problem
    got = tk.dsolutions_all_sr(t(p["C1"]), t(p["J1"]), N, t(p["Dg"]))
    assert got.shape == (8, K, 4 * N, B, 2)
    close(got, p["dJ"], DERIV)


@pytest.mark.parametrize("addself", [False, True])
@pytest.mark.parametrize("name", ["dresiduals_all_sr",
                                  "dresiduals_all_perdir_sr"])
def test_dresiduals_match_jax(problem, name, addself):
    p = problem
    got = getattr(tk, name)(t(p["C1"]), t(p["J1"]), N, t(p["dJ"]),
                            addself=addself)
    close(got, getattr(jk, name)(p["C1"], p["J1"], N, p["dJ"],
                                 addself=addself), DERIV)


@pytest.mark.parametrize("perdir", [False, True])
@pytest.mark.parametrize("addself", [False, True])
def test_column_means_match_jax(problem, addself, perdir):
    """The oracle's column means on JAX's dJ, and the optimized adjoint
    form on JAX's Hessian, each against its JAX twin."""
    p = problem
    kw = dict(addself=addself, perdir=perdir)
    close(tk.dresiduals_colmeans_sr(t(p["C1"]), t(p["J1"]), N, t(p["dJ"]),
                                    **kw),
          jk.dresiduals_colmeans_sr(p["C1"], p["J1"], N, p["dJ"], **kw),
          COLMEANS)
    close(tk.influence_colmeans_opt_sr(t(p["C1"]), t(p["J1"]), N,
                                       t(p["Dg"]), **kw),
          jk.influence_colmeans_opt_sr(p["C1"], p["J1"], N, p["Dg"], **kw),
          COLMEANS)


def test_column_means_are_the_mean_of_dense_dresiduals(problem):
    """dresiduals_colmeans_sr is the row mean of the dense dR."""
    p = problem
    ops = (t(p["C1"]), t(p["J1"]), N, t(p["dJ"]))
    dense = tk.dresiduals_all_sr(*ops, addself=True).reshape(8, B, 4, B, 2)
    close(tk.dresiduals_colmeans_sr(*ops, addself=True),
          dense.mean(dim=1).numpy(), COLMEANS)


def test_llr_matches_jax(problem):
    p = problem
    close(tk.log_likelihood_ratio_sr(t(p["R1"]), t(p["C1"]), t(p["J1"]), N),
          jk.log_likelihood_ratio_sr(p["R1"], p["C1"], p["J1"], N), DERIV)


@pytest.mark.parametrize("name", ["hessian_res", "dsolutions_all",
                                  "dresiduals_all", "dresiduals_all_perdir",
                                  "log_likelihood_ratio"])
def test_complex_wrappers_match_jax(problem, name):
    p = problem
    Dg, dJ = jcreal.fuse(np.asarray(p["Dg"])), jcreal.fuse(np.asarray(p["dJ"]))
    args = {"hessian_res": (p["R"], p["C"], p["J"]),
            "dsolutions_all": (p["C"], p["J"], N, Dg),
            "dresiduals_all": (p["C"], p["J"], N, dJ),
            "dresiduals_all_perdir": (p["C"], p["J"], N, dJ),
            "log_likelihood_ratio": (p["R"], p["C"], p["J"])}[name]
    if name in ("hessian_res", "log_likelihood_ratio"):
        args = args + (N,)
    got = getattr(tk, name)(*args, device="cpu")
    want = getattr(jk, name)(*args)
    assert isinstance(got, np.ndarray) and got.dtype == np.asarray(want).dtype
    np.testing.assert_allclose(got, want,
                               **(HESS if name == "hessian_res" else DERIV))


@pytest.mark.parametrize("addself", [False, True])
def test_single_r_forms_match_their_all_forms(problem, addself):
    p = problem
    Dg, dJ = jcreal.fuse(np.asarray(p["Dg"])), jcreal.fuse(np.asarray(p["dJ"]))
    dsol = tk.dsolutions_all(p["C"], p["J"], N, Dg, device="cpu")
    dres = tk.dresiduals_all(p["C"], p["J"], N, dJ, addself=addself,
                             device="cpu")
    for r in (0, 5):
        np.testing.assert_array_equal(
            tk.dsolutions(p["C"], p["J"], N, Dg, r, device="cpu"), dsol[r])
        np.testing.assert_allclose(
            tk.dresiduals(p["C"], p["J"], N, dJ[r], addself, r,
                          device="cpu"), dres[r], rtol=1e-5, atol=1e-7)


def test_creal_host_edge_and_products():
    rng = np.random.default_rng(3)
    a = (rng.standard_normal((3, 4)) + 1j * rng.standard_normal((3, 4)))
    b = (rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2)))
    np.testing.assert_array_equal(tcreal.split(a), jcreal.split(a))
    np.testing.assert_array_equal(tcreal.fuse(t(jcreal.split(a))),
                                  jcreal.fuse(jcreal.split(a)))
    sa, sb = t(jcreal.split(a)), t(jcreal.split(b))
    close(tcreal.matmul(sa, sb),
          jcreal.matmul(jcreal.split(a), jcreal.split(b)), HESS)
    close(tcreal.mul(sa, sa), jcreal.mul(jcreal.split(a), jcreal.split(a)),
          HESS)
    s = rng.standard_normal(4).astype(np.float32)
    close(tcreal.scale(sa, s), jcreal.scale(jcreal.split(a), s), HESS)


@pytest.mark.parametrize("alpha", [0.0, 0.3])
def test_consensus_poly_matches_jax(alpha):
    freqs = np.asarray([120e6, 140e6, 160e6], np.float32)
    F, P = tcons.consensus_poly(2, 4, freqs, 140e6, 1, polytype=0, rho=2.0,
                                alpha=alpha)
    jF, jP = jcons.consensus_poly(2, 4, freqs, 140e6, 1, polytype=0, rho=2.0,
                                  alpha=alpha)
    assert F.shape == (8, 8) and P.shape == (16, 8)
    close(F, jF, HESS)
    close(P, jP, HESS)


# -- the chain: per interval, per band, imaged ------------------------------

@pytest.mark.parametrize("perdir", [False, True])
def test_influence_visibilities_oracle(problem, perdir):
    """The port's oracle against JAX's oracle (its own bound) and against
    the port's optimized chain (tests/test_influence_opt.py's bounds)."""
    p = problem
    ops = (t(p["Rs"]), t(p["Cs"]), t(p["Js"]), t(p["hadd"]), N, TS)
    orc = tinf.influence_visibilities(*ops, perdir=perdir, optimized=False)
    opt = tinf.influence_visibilities(*ops, perdir=perdir)
    ref = jinf.influence_visibilities(p["Rs"], p["Cs"], p["Js"], p["hadd"],
                                      N, TS, perdir=perdir, optimized=False)
    assert orc.vis.shape == ref.vis.shape and orc.llr.shape == (TS, K)
    close(orc.vis, ref.vis, DERIV)
    close(orc.llr, ref.llr, DERIV)
    close(opt.vis, orc.vis.numpy(), dict(rtol=2e-4, atol=1e-6))
    close(opt.llr, orc.llr.numpy(), dict(rtol=1e-5, atol=1e-5))


@pytest.fixture(scope="module")
def multi_band(problem):
    """Two bands of solver-convention operands (tests/test_influence_opt.py's
    multi_band fixture)."""
    rng = np.random.default_rng(7)
    T, Nf = TS * TD, 2
    f32 = np.float32
    return dict(
        resid=rng.standard_normal((Nf, T, B, 2, 2, 2)).astype(f32),
        C=rng.standard_normal((Nf,) + problem["Cs"].shape).astype(f32),
        J=(rng.standard_normal((Nf,) + problem["Js"].shape) * 0.3)
        .astype(f32),
        hadd=rng.uniform(0.1, 1.0, (Nf, K)).astype(f32),
        freqs=np.linspace(120e6, 160e6, Nf),
        uvw=(rng.standard_normal((T * B, 3)) * 300.0).astype(f32))


@pytest.mark.parametrize("use_pallas", [True, False])
def test_influence_images_multi_oracle(multi_band, use_pallas):
    """The oracle arm against JAX's (its imager through the plain XLA
    formulation on the CPU) and against the port's optimized arm, at
    tests/test_influence_opt.py's bound; ``use_pallas=False`` takes
    ``dirty_image_sr_xla``."""
    m = multi_band
    args = (m["resid"], m["C"], m["J"], m["hadd"], m["freqs"], m["uvw"],
            1e-4, N, TS)
    targs = tuple(t(a) for a in args[:4]) + (m["freqs"], t(m["uvw"]), 1e-4,
                                             N, TS)
    ref = np.asarray(jinf.influence_images_multi(
        *args, npix=16, use_pallas=False, optimized=False))
    orc = tinf.influence_images_multi(*targs, npix=16, use_pallas=use_pallas,
                                      optimized=False)
    opt = tinf.influence_images_multi(*targs, npix=16)
    bound = dict(rtol=2e-3, atol=1e-5)
    assert orc.shape == (2, 16, 16)
    close(orc, ref, bound)
    close(opt, orc.numpy(), bound)


def test_plain_imager_and_noise_statistics():
    rng = np.random.default_rng(5)
    uvw = (rng.standard_normal((40, 3)) * 200.0).astype(np.float32)
    vis = rng.standard_normal((40, 2)).astype(np.float32)
    ref = np.asarray(jimager.dirty_image_sr_xla(uvw, vis, 140e6, 1e-4,
                                                npix=32))
    img = timager.dirty_image_sr_xla(t(uvw), t(vis), 140e6, 1e-4, npix=32)
    close(img, ref, dict(rtol=1e-4, atol=1e-5))
    close(timager.dirty_image_sr(t(uvw), t(vis), 140e6, 1e-4, npix=32),
          img.numpy(), dict(rtol=1e-4, atol=1e-5))
    np.testing.assert_allclose(float(timager.image_noise_std(img)),
                               float(jimager.image_noise_std(ref)),
                               rtol=1e-4)
    V = rng.standard_normal((4, B, 2, 2, 2)).astype(np.float32)
    np.testing.assert_allclose(float(tsolver.stokes_i_std(t(V))),
                               float(jsolver.stokes_i_std(V)), rtol=1e-6)
