"""Mixed-precision (bf16) influence path of the PyTorch port against the JAX
package: the policy table, ``creal.einsum`` under a compute dtype, the
factored imager's bf16 mode (plain versions against JAX's and against the
Pallas kernel in interpret mode), the bf16 influence chain and the
backend's ``precision=``.  Inputs come from numpy with a seed or from the
JAX package's own episode, handed over through ``interop``.

Tolerances.  Where both packages round the same f32 values to bf16, only
the order of the f32 sums differs: ``creal.einsum`` and the column means'
contraction on the JAX package's own Yr and Lr are held at 1e-5 relative
norm.  The imagers' planes part at f32 round-off between the packages
(and the Pallas kernel reduces the phase mod 2 pi), which flips the bf16
rounding of a small share of the operands by one bf16 step; they are
held at the f32 gate's rtol 2e-4 / atol 2e-4 * max|ref|.  The f32 chains
part by up to 1e-4 (tests/test_torch_influence.py), which can flip the
bf16 rounding of a share of the column means' operands by 2^-8 each, so
the whole bf16 chain is held at 1e-3 relative norm.  Measured on this
fixture: 4.7e-8 on the visibilities and 1.2e-7 on the backend's image
(the f32 chains part by 1.2e-6 and 5.4e-6 there: rounding both packages'
operands to bf16 mostly erases their f32 round-off).  bf16 against f32 is
held inside the documented band ``BF16_RTOL`` = 2e-2
(tests/test_nscale_kernels.py), and must differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smartcal_tpu.cal import creal as jcreal
from smartcal_tpu.cal import imager as jimager
from smartcal_tpu.cal import influence as jinf
from smartcal_tpu.cal import kernels as jkernels
from smartcal_tpu.cal import precision as jprec
from smartcal_tpu.cal import solver as jsolver
from smartcal_tpu.envs.radio import RadioBackend as JaxBackend
from smartcal_tpu.ops import pallas_imager
from smartcal_tpu_torch import interop
from smartcal_tpu_torch.cal import creal, imager, influence, kernels
from smartcal_tpu_torch.cal import precision as prec
from smartcal_tpu_torch.cal import solver
from smartcal_tpu_torch.envs.radio import RadioBackend

BF16_RTOL = 2e-2              # tests/test_nscale_kernels.py
SAME_VALUES = 1e-5            # both packages round the same f32 values
CHAIN = 1e-3                  # whole bf16 chain, port against JAX
RTOL, ATOL_SCALE = 2e-4, 2e-4  # the factored imagers' gate

N_ST, NCH, K = 6, 2, 3
JAX_TINY = dict(n_stations=N_ST, n_freqs=2, n_times=4, tdelta=2,
                admm_iters=2, lbfgs_iters=2, init_iters=3, npix=16)


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def max_rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12)


# -- the policy ---------------------------------------------------------------

def test_policy_table_is_the_jax_packages():
    assert prec.POLICIES == jprec.POLICIES
    assert prec.KERNEL_DTYPES == jprec.KERNEL_DTYPES
    for kernel in prec.KERNEL_DTYPES:
        for p in prec.POLICIES:
            want = jprec.dtype_name(jprec.contraction_dtype(kernel, p))
            assert prec.dtype_name(prec.contraction_dtype(kernel, p)) == want


def test_precision_policy_pins_and_validates():
    """tests/test_nscale_kernels.py's claims on the port's policy."""
    assert prec.contraction_dtype("imager_matmul", "bf16") == torch.bfloat16
    assert prec.contraction_dtype("colmeans_contract", "bf16") \
        == torch.bfloat16
    assert prec.contraction_dtype("imager_matmul", "f32") == prec.F32
    for pinned in ("hessian", "solve_4n", "admm"):
        assert prec.contraction_dtype(pinned, "bf16") == prec.F32
    assert prec.contraction_dtype("imager_matmul") == prec.F32
    with pytest.raises(ValueError):
        prec.check("fp16")
    with pytest.raises(ValueError):
        prec.contraction_dtype("imager_matmul", "fp16")
    with pytest.raises(KeyError):
        prec.contraction_dtype("unknown-kernel", "bf16")
    with pytest.raises(ValueError):
        RadioBackend(precision="f16", device="cpu")
    assert RadioBackend(device="cpu").precision == "f32"
    assert prec.dtype_name(torch.bfloat16) == "bf16"
    assert prec.dtype_name(prec.F32) == "f32"


def test_narrow_rounds_to_nearest_even_and_keeps_f32():
    x = torch.tensor([1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -9,
                      -(1.0 + 2.0 ** -7)], dtype=torch.float32)
    out = prec.narrow(x, torch.bfloat16)
    assert out.dtype == torch.float32
    # ties to even: 1 + 2^-8 -> 1, 1 + 3 * 2^-8 -> 1 + 2^-6
    np.testing.assert_array_equal(
        out.numpy(), np.array([1.0, 1.0 + 2.0 ** -6, 1.0,
                               -(1.0 + 2.0 ** -7)], np.float32))
    assert prec.narrow(x, prec.F32) is x


# -- creal.einsum under a compute dtype -----------------------------------

def _complex_pair(seed):
    rng = np.random.default_rng(seed)
    return [jcreal.split(rng.standard_normal((64, 8))
                         + 1j * rng.standard_normal((64, 8)))
            for _ in range(2)]


def test_bf16_creal_einsum_matches_jax_and_accumulates_f32():
    a, b = _complex_pair(3)
    ref = np.asarray(jcreal.einsum("bi,bj->ij", jnp.asarray(a),
                                   jnp.asarray(b),
                                   compute_dtype=jnp.bfloat16))
    ta, tb = torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b))
    out = creal.einsum("bi,bj->ij", ta, tb, compute_dtype=torch.bfloat16)
    assert out.dtype == torch.float32        # f32 accumulation contract
    assert rel(out.numpy(), ref) < SAME_VALUES
    f32 = creal.einsum("bi,bj->ij", ta, tb)
    assert 0 < max_rel(out.numpy(), f32.numpy()) < BF16_RTOL


def test_f32_compute_dtype_is_bit_identical():
    a, b = _complex_pair(4)
    ta, tb = torch.from_numpy(np.asarray(a)), torch.from_numpy(np.asarray(b))
    np.testing.assert_array_equal(
        creal.einsum("bi,bj->ij", ta, tb, compute_dtype=torch.float32)
        .numpy(), creal.einsum("bi,bj->ij", ta, tb).numpy())


# -- the factored imager's bf16 mode -----------------------------------------

@pytest.fixture(scope="module")
def imager_case():
    """tests/test_nscale_kernels.py's _imager_case(R=700): the JAX bf16
    images it is held against."""
    rng = np.random.default_rng(0)
    R, freq = 700, 150e6
    uvw = rng.uniform(-2e3, 2e3, size=(R, 3)).astype(np.float32)
    vis = rng.standard_normal((R, 2)).astype(np.float32)
    cell = jimager.default_cell(uvw, freq)
    refs = {
        ("jax_factored", 64): jimager.dirty_image_factored_sr(
            uvw, vis, freq, cell, npix=64, precision="bf16"),
        ("jax_blocked", 64): jimager.dirty_image_factored_blocked_sr(
            uvw, vis, freq, cell, npix=64, block_r=256, precision="bf16"),
        ("pallas_interpret", 128): pallas_imager.dirty_image_factored_pallas(
            uvw, vis, freq, cell, npix=128, precision="bf16",
            interpret=True),
    }
    return uvw, vis, freq, cell, {k: np.asarray(v) for k, v in refs.items()}


def _port_image(kind, uvw, vis, freq, cell, npix, precision="bf16"):
    u, v = torch.from_numpy(uvw), torch.from_numpy(vis)
    if kind == "factored":
        return imager.dirty_image_factored_sr(u, v, freq, cell, npix=npix,
                                              precision=precision).numpy()
    return imager.dirty_image_factored_blocked_sr(
        u, v, freq, cell, npix=npix, block_r=256,
        precision=precision).numpy()


@pytest.mark.parametrize("ref", [("jax_factored", 64), ("jax_blocked", 64),
                                 ("pallas_interpret", 128)],
                         ids=lambda r: r[0])
@pytest.mark.parametrize("kind", ["factored", "blocked"])
def test_bf16_factored_imager_matches_jax(imager_case, kind, ref):
    uvw, vis, freq, cell, refs = imager_case
    want = refs[ref]
    out = _port_image(kind, uvw, vis, freq, cell, ref[1])
    assert out.shape == want.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, want, rtol=RTOL,
                               atol=ATOL_SCALE * np.max(np.abs(want)))


@pytest.mark.parametrize("kind", ["factored", "blocked"])
def test_bf16_imager_within_band_of_f32_in_both_packages(imager_case, kind):
    uvw, vis, freq, cell, refs = imager_case
    f32 = _port_image(kind, uvw, vis, freq, cell, 64, precision="f32")
    b16 = _port_image(kind, uvw, vis, freq, cell, 64)
    assert 0 < max_rel(b16, f32) < BF16_RTOL
    assert float(np.std(b16)) == pytest.approx(float(np.std(f32)),
                                               rel=BF16_RTOL)
    jf32 = np.asarray(jimager.dirty_image_factored_sr(uvw, vis, freq, cell,
                                                      npix=64))
    jb16 = refs[("jax_" + kind, 64)]
    assert 0 < max_rel(jb16, jf32) < BF16_RTOL
    # the f32 default computes the bits it computed before the policy
    u, v = torch.from_numpy(uvw), torch.from_numpy(vis)
    np.testing.assert_array_equal(
        f32, (imager.dirty_image_factored_sr(u, v, freq, cell, npix=64)
              if kind == "factored" else
              imager.dirty_image_factored_blocked_sr(
                  u, v, freq, cell, npix=64, block_r=256)).numpy())


def test_large_dispatch_runs_the_bf16_plain_version_on_cpu(imager_case):
    from smartcal_tpu_torch.ops import factored_imager
    uvw, vis, freq, cell, refs = imager_case
    before = (factored_imager.launches, factored_imager.launches_bf16)
    out = imager.dirty_image_factored_large_sr(
        torch.from_numpy(uvw), torch.from_numpy(vis), freq, cell, npix=128,
        block_r=256, precision="bf16")
    assert (factored_imager.launches, factored_imager.launches_bf16) \
        == before
    want = refs[("pallas_interpret", 128)]
    np.testing.assert_allclose(out.numpy(), want, rtol=RTOL,
                               atol=ATOL_SCALE * np.max(np.abs(want)))
    with pytest.raises(ValueError):
        imager.dirty_image_factored_large_sr(
            torch.from_numpy(uvw), torch.from_numpy(vis), freq, cell,
            npix=128, precision="fp16")


def test_factored_cuda_wrapper_checks_precision_first():
    from smartcal_tpu_torch.ops import factored_imager
    x = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="precision"):
        factored_imager.dirty_image_factored_cuda(x, x[:, :2], 150e6, 1e-3,
                                                  npix=8, precision="f16")
    with pytest.raises(ValueError, match="CUDA"):
        factored_imager.dirty_image_factored_cuda(x, x[:, :2], 150e6, 1e-3,
                                                  npix=8, precision="bf16")
    assert factored_imager.ENTRY == {"f32": "factored_image",
                                     "bf16": "factored_image_bf16"}


# -- the influence chain on the JAX package's episode ------------------------

@pytest.fixture(scope="module")
def episode():
    """tests/test_nscale_kernels.py's fixture: a demixing episode
    (PRNGKey(7), K=3) solved by the JAX package, band 0's operands."""
    backend = JaxBackend(shard=False, **JAX_TINY)
    ep, mdl = backend.new_demixing_episode(jax.random.PRNGKey(7), K)
    res = jsolver.solve_admm(ep.V, ep.Ccal, ep.obs.freqs, ep.f0,
                             jnp.asarray(mdl.rho), backend._solver_cfg(K),
                             n_chunks=backend.n_chunks)
    freqs = np.asarray(ep.obs.freqs)
    hadd = jinf.consensus_hadd_scalars(
        mdl.rho, np.zeros(K, np.float32), freqs, ep.f0, 0,
        n_poly=backend.n_poly, polytype=backend.polytype)
    Rk = jsolver.residual_to_kernel(res.residual[0])
    return backend, ep, mdl, res, hadd, Rk


def _jax_vis(episode, precision):
    _, ep, _, res, hadd, Rk = episode
    return jinf.influence_visibilities(Rk, ep.Ccal[0], res.J[0], hadd,
                                       N_ST, NCH, precision=precision)


def _port_vis(episode, **kw):
    _, ep, _, res, hadd, Rk = episode
    return influence.influence_visibilities(
        torch.from_numpy(np.array(Rk)), torch.from_numpy(np.array(ep.Ccal[0])),
        torch.from_numpy(np.array(res.J[0])),
        torch.from_numpy(np.array(hadd)), N_ST, NCH, **kw)


def test_bf16_colmeans_contraction_on_jax_operands(episode, monkeypatch):
    """The Yr x Lr contraction of the JAX package's own column means, taken
    as JAX built it, through both packages' bf16 einsum."""
    _, ep, _, res, hadd, Rk = episode
    R3, C5, B, T, _ = jkernels._split_samples_sr(
        Rk[:2 * 15 * 2], ep.Ccal[0][:, :15 * 2], N_ST)
    p_idx, q_idx = jkernels.baseline_indices(N_ST)
    J4 = jkernels._jones_blocks_sr(res.J[0][0], N_ST)
    Jp, Jq = J4[:, p_idx], J4[:, q_idx]
    lhs = jcreal.einsum("kbuv,kbwv->kbuw", Jq,
                        jcreal.conj(jnp.sum(C5, axis=1)))
    H = jkernels._hessian_res_core_sr(R3, C5, Jp, Jq, N_ST)
    seen = []
    einsum = jcreal.einsum

    def spy(spec, a, b, compute_dtype=None):
        if compute_dtype is not None:
            seen.append((spec, np.array(a), np.array(b)))
        return einsum(spec, a, b, compute_dtype=compute_dtype)

    monkeypatch.setattr(jcreal, "einsum", spy)
    jkernels._colmeans_adjoint_core_sr(lhs, H, p_idx, N_ST, T,
                                       addself=False, perdir=False,
                                       contract_dtype=jnp.bfloat16)
    monkeypatch.undo()
    (spec, Yr, Lr), = seen
    ref = np.asarray(jcreal.einsum(spec, jnp.asarray(Yr), jnp.asarray(Lr),
                                   compute_dtype=jnp.bfloat16))
    out = creal.einsum(spec, torch.from_numpy(Yr), torch.from_numpy(Lr),
                       compute_dtype=torch.bfloat16).numpy()
    assert rel(out, ref) < SAME_VALUES
    f32 = creal.einsum(spec, torch.from_numpy(Yr),
                       torch.from_numpy(Lr)).numpy()
    assert 0 < rel(out, f32) < BF16_RTOL


def test_bf16_chain_matches_jax(episode):
    ref = _jax_vis(episode, "bf16")
    out = _port_vis(episode, precision="bf16")
    assert out.vis.shape == ref.vis.shape
    assert rel(out.vis.numpy(), ref.vis) < CHAIN
    assert rel(out.llr.numpy(), ref.llr) < 1e-4


def test_bf16_chain_within_band_llr_pinned(episode):
    """In each package bf16 moves the visibilities inside the band, and
    the f32-pinned LLR keeps its bits."""
    jf, jb = _jax_vis(episode, "f32"), _jax_vis(episode, "bf16")
    assert 0 < max_rel(jb.vis, jf.vis) < BF16_RTOL
    tf, tb = _port_vis(episode), _port_vis(episode, precision="bf16")
    assert 0 < max_rel(tb.vis.numpy(), tf.vis.numpy()) < BF16_RTOL
    np.testing.assert_array_equal(tb.llr.numpy(), tf.llr.numpy())


@pytest.mark.parametrize("blocked", [False, True])
def test_f32_policy_is_bit_identical_to_no_argument(episode, blocked):
    kw = {"block_baselines": 4} if blocked else {}
    default = _port_vis(episode, **kw)
    explicit = _port_vis(episode, precision="f32", **kw)
    np.testing.assert_array_equal(default.vis.numpy(), explicit.vis.numpy())
    np.testing.assert_array_equal(default.llr.numpy(), explicit.llr.numpy())


def test_blocked_bf16_chain_matches_unblocked(episode):
    """The SKA tier's blocked Hessian under bf16: the same narrowing."""
    plain = _port_vis(episode, precision="bf16")
    blk = _port_vis(episode, precision="bf16", block_baselines=4)
    assert rel(blk.vis.numpy(), plain.vis.numpy()) < CHAIN
    np.testing.assert_array_equal(blk.llr.numpy(), _port_vis(
        episode, block_baselines=4).llr.numpy())


# -- the backend's precision= ------------------------------------------------

@pytest.mark.parametrize("n_stations,npix",
                         [(62, 128), (128, 512), (256, 1024)])
@pytest.mark.parametrize("override", [None, 0])
def test_bf16_influence_statics_match_jax(n_stations, npix, override):
    kw = dict(n_stations=n_stations, npix=npix, block_baselines=override,
              imager_block_r=override, precision="bf16")
    ref = JaxBackend(shard=False, **kw)._influence_statics(npix)
    out = RadioBackend(device="cpu", **kw)._influence_statics(npix)
    assert out == ref and out["precision"] == "bf16"


@pytest.fixture(scope="module")
def backend_images(episode):
    """The JAX and the port's bf16 and f32 backends' influence images of
    the handed-over episode and solve (both bands)."""
    _, ep, mdl, res, _, _ = episode
    rho, alpha = np.asarray(mdl.rho, np.float32), np.zeros(K, np.float32)
    tep = interop.episode_from_numpy(ep)
    tres = interop.solve_result_from_numpy(res)
    out = {}
    for p in ("f32", "bf16"):
        jbe = JaxBackend(shard=False, precision=p, **JAX_TINY)
        tbe = RadioBackend(device="cpu", precision=p, **JAX_TINY)
        out[p] = (np.asarray(jbe.influence_image(ep, res, rho, alpha)),
                  tbe.influence_image(tep, tres, rho, alpha).numpy())
    return out, tep, tres, rho, alpha


def test_bf16_backend_influence_image_matches_jax(backend_images):
    out = backend_images[0]
    jb, tb = out["bf16"]
    assert tb.shape == (16, 16)
    assert rel(tb, jb) < CHAIN
    jf, tf = out["f32"]
    assert 0 < max_rel(tb, tf) < BF16_RTOL
    assert 0 < max_rel(jb, jf) < BF16_RTOL


def test_bf16_batched_lane_equals_single_route(backend_images):
    """Lane 0 of ``influence_images_batched`` under bf16 is the
    single-episode route's image (two lanes: the episode and the same
    episode with its solve's J scaled)."""
    _, tep, tres, rho, alpha = backend_images
    tbe = RadioBackend(device="cpu", precision="bf16", **JAX_TINY)
    bep = tbe.stack_episodes([tep, tep])
    res2 = solver.SolveResult(*(
        torch.stack([t, t * 1.01]) if f == "J" else torch.stack([t, t])
        for f, t in zip(solver.SolveResult._fields, tres)))
    imgs = tbe.influence_images_batched(bep, res2, np.stack([rho, rho]),
                                        np.stack([alpha, alpha]))
    single = tbe.influence_image(tep, tres, rho, alpha)
    assert imgs.shape == (2, 16, 16)
    np.testing.assert_array_equal(imgs[0].numpy(), single.numpy())
    assert not torch.equal(imgs[1], imgs[0])
