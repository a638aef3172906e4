"""Tests of the port that need an NVIDIA GPU (``cuda`` marker).  They skip
without one.  This file imports nothing of JAX, so it also runs on a
machine with the GPU and no JAX:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from smartcal_tpu_torch.ops import dft_imager

RTOL, ATOL = 2e-4, 2e-5      # tests/test_pallas_imager.py


def _case(seed, R, freq=150e6):
    rng = np.random.default_rng(seed)
    uvw = rng.uniform(-2e3, 2e3, size=(R, 3)).astype(np.float32)
    vis = rng.standard_normal((R, 2)).astype(np.float32)
    uv = np.abs(uvw[:, :2] * np.float32(freq / 2.99792458e8)).max()
    return uvw, vis, np.float32(freq), 1.0 / (6.0 * max(float(uv), 1.0))


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """The imager kernel against the direct DFT; npix=100 and R=1001 are
    ragged against the engine's 128-pixel tile and 16-sample stage."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    for npix, R in ((32, 700), (128, 5000), (100, 1001)):
        uvw, vis, freq, cell = _case(npix, R)
        u = torch.from_numpy(uvw).cuda()
        v = torch.from_numpy(vis).cuda()
        before = dft_imager.launches
        out = dft_imager.dirty_image(u, v, freq, cell, npix=npix)
        assert dft_imager.launches == before + 1
        scale = torch.tensor(dft_imager.uv_scale(freq), device="cuda")
        ref = dft_imager.dirty_image_reference(
            (u[:, :2] * scale).contiguous(),
            dft_imager.pixel_grid(npix, cell, "cuda"), v)
        np.testing.assert_allclose(out.reshape(-1).cpu().numpy(),
                                   ref.cpu().numpy(), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
def test_graphed_line_search_matches_eager_on_gpu():
    """The solver's CUDA-graph replay of the quartic line search gives the
    eager search's steps, call after call (the graph's input is refilled)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from smartcal_tpu_torch.cal import solver
    from smartcal_tpu_torch.ops import lbfgs
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    search = solver._QuarticLineSearch(6, torch.float32, dev)
    for _ in range(3):
        c = rng.standard_normal((6, 5)).astype(np.float32)
        c[:, 0] = np.abs(c[:, 0]) + 1.0          # phi(0) > 0
        c[:, 1] = -np.abs(c[:, 1]) - 0.1         # descent: phi'(0) < 0
        c[:, 4] = np.abs(c[:, 4]) + 0.1          # bounded below
        coeffs = torch.from_numpy(c).to(dev)
        want = lbfgs.strong_wolfe_cubic(solver._quartic_phi(coeffs), 6,
                                        device=dev)
        got = search(coeffs)
        assert torch.equal(got, want)


@pytest.mark.cuda
def test_hessian_blocks_kernel_matches_plain_on_gpu():
    """Full sets through the station-pair tiles (N=6: one partial tile;
    N=20, 64, 100: several tiles, partial on both station axes at 20 and
    100; K=5 leaves a partial direction chunk; Td=80 streams R3 per step),
    the same indices and a subset with sentinels through the general
    layout; two launches give the same bits.  The larger cases take atol
    relative to max|ref| (chip_smoke.py's rule): their sums run over
    thousands of products, so round-off near zero grows with them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from smartcal_tpu_torch.cal import kernels
    from smartcal_tpu_torch.ops import hessian_blocks
    rng = np.random.default_rng(4)
    dev = torch.device("cuda")
    for N, K, Td, route, scaled in (
            (6, 3, 4, "full", False), (20, 2, 5, "full", False),
            (64, 5, 3, "full", True), (100, 2, 3, "full", True),
            (20, 2, 80, "full", True), (20, 2, 5, "general", False),
            (20, 3, 2, "subset", False)):
        p, q = np.triu_indices(N, 1)
        if route == "subset":
            p = np.concatenate([p[::3], [N, N]])
            q = np.concatenate([q[::3], [N, N]])
        B = p.size

        def arr(*shape):
            return torch.from_numpy(
                rng.standard_normal(shape).astype(np.float32)).to(dev)

        R3, C5 = arr(Td, B, 2, 2, 2), arr(K, Td, B, 2, 2, 2)
        Jp, Jq = arr(K, B, 2, 2, 2), arr(K, B, 2, 2, 2)
        pi, qi = torch.from_numpy(p).to(dev), torch.from_numpy(q).to(dev)
        sched = (hessian_blocks.full_schedule(N, dev)[0] if route == "full"
                 else None)
        before = hessian_blocks.launches
        off, dsum = hessian_blocks.hessian_block_sums(R3, C5, Jp, Jq, pi, qi,
                                                      N, sched=sched)
        assert hessian_blocks.launches == before + 1
        off2, dsum2 = hessian_blocks.hessian_block_sums(R3, C5, Jp, Jq, pi,
                                                        qi, N, sched=sched)
        assert torch.equal(off, off2) and torch.equal(dsum, dsum2)
        off_ref, dsum_ref = kernels._hessian_block_sums(R3, C5, Jp, Jq, pi,
                                                        qi, N)
        for out, ref in ((off, off_ref), (dsum, dsum_ref)):
            ref = ref.cpu().numpy()
            atol = 2e-5 * (np.abs(ref).max() if scaled else 1.0)
            np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=2e-4,
                                       atol=atol)


@pytest.mark.cuda
def test_factored_imager_kernel_matches_plain_on_gpu():
    """npix and R that are not multiples of the kernel's tiles."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from smartcal_tpu_torch.cal import imager
    from smartcal_tpu_torch.ops import factored_imager
    for npix, R in ((100, 700), (130, 5001)):
        uvw, vis, freq, cell = _case(npix + R, R)
        u = torch.from_numpy(uvw).cuda()
        v = torch.from_numpy(vis).cuda()
        before = factored_imager.launches
        out = imager.dirty_image_factored_large_sr(u, v, freq, cell,
                                                   npix=npix, block_r=256)
        assert factored_imager.launches == before + 1
        ref = imager.dirty_image_factored_blocked_sr(u, v, freq, cell,
                                                     npix=npix, block_r=256)
        ref = ref.cpu().numpy()
        np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=2e-4,
                                   atol=2e-4 * np.abs(ref).max())


@pytest.mark.cuda
def test_factored_imager_bf16_kernel_matches_plain_on_gpu():
    """Kernel 2's bf16 mode against its plain bf16 version at npix and R
    ragged against the 128-pixel tile and the 32-sample stage, within a
    tenth of the bf16 band (both round the same f32 operands; the kernel's
    walked phases, trig ulps and the order of the sum differ); against
    the f32 mode within the band; two launches give the same bits.  The
    cases: npix below one tile (100), npix not a multiple of it (200,
    640), R below one stage (5), R not a multiple of it (1001, 5003), and
    one split of R per SM (100 x 5003: 79 chunks of 2 stages)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from smartcal_tpu_torch.cal import imager
    from smartcal_tpu_torch.ops import factored_imager
    for npix, R in ((200, 1001), (100, 700), (256, 5003), (100, 5),
                    (200, 5), (640, 5003), (100, 5003)):
        uvw, vis, freq, cell = _case(npix + R, R)
        u = torch.from_numpy(uvw).cuda()
        v = torch.from_numpy(vis).cuda()
        before = (factored_imager.launches, factored_imager.launches_bf16)
        out = imager.dirty_image_factored_large_sr(
            u, v, freq, cell, npix=npix, block_r=256, precision="bf16")
        assert (factored_imager.launches, factored_imager.launches_bf16) \
            == (before[0], before[1] + 1)
        again = factored_imager.dirty_image_factored_cuda(
            u, v, freq, cell, npix=npix, precision="bf16")
        assert torch.equal(out, again)
        ref = imager.dirty_image_factored_blocked_sr(
            u, v, freq, cell, npix=npix, block_r=256,
            precision="bf16").cpu().numpy()
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out.cpu().numpy(), ref, rtol=0,
                                   atol=2e-3 * scale)
        f32 = factored_imager.dirty_image_factored_cuda(
            u, v, freq, cell, npix=npix).cpu().numpy()
        assert 0 < np.abs(out.cpu().numpy() - f32).max() < 2e-2 * scale


@pytest.mark.cuda
def test_full_width_learn_step_matches_cpu():
    """One learn step of the calibration agent at full width (128² image,
    M=10, batch 32) on the GPU and on the CPU from the same state, batch
    and noise: losses, alpha, rho and every parameter and Adam moment
    within rtol 1e-4 / atol 1e-5.  The state first takes three steps on
    the GPU, so Adam's moments are not fresh (from fresh moments a
    gradient near 1e-9 moves its weight by lr * g / (|g| + 1e-8), which
    amplifies the two devices' round-off 1e5 times)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smartcal_tpu_torch.rl import sac
    M, npix, B = 10, 128, 32
    cfg = sac.SACConfig(obs_dim=npix * npix + (M + 1) * 7, n_actions=2 * M,
                        batch_size=B, mem_size=B, reward_scale=M,
                        alpha=0.03, hint_threshold=0.01, admm_rho=1.0,
                        use_hint=True, hint_distance="kld",
                        img_shape=(npix, npix))
    rng = np.random.default_rng(0)

    def draw():
        batch = {"state": 1e-3 * rng.standard_normal((B, cfg.obs_dim)),
                 "new_state": 1e-3 * rng.standard_normal((B, cfg.obs_dim)),
                 "action": rng.uniform(-1, 1, (B, 2 * M)),
                 "reward": rng.uniform(0, 30, B),
                 "hint": rng.uniform(-1, 1, (B, 2 * M))}
        batch = {k: torch.from_numpy(v.astype(np.float32))
                 for k, v in batch.items()}
        batch["done"] = torch.zeros(B, dtype=torch.bool)
        noise = tuple(torch.from_numpy(rng.standard_normal(
            (B, 2 * M)).astype(np.float32)) for _ in range(3))
        return batch, noise

    def learn(st, dev, batch, noise):
        return sac.learn_from_batch(
            cfg, st, {k: v.to(dev) for k, v in batch.items()},
            torch.ones(B, device=dev), tuple(n.to(dev) for n in noise))

    gpu = sac.sac_init(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    for _ in range(3):
        learn(gpu, "cuda", *draw())
    cpu = gpu.copy_to("cpu")
    batch, noise = draw()
    m_gpu = learn(gpu, "cuda", batch, noise)
    m_cpu = learn(cpu, "cpu", batch, noise)
    for k in ("critic_loss", "actor_loss", "alpha", "rho"):
        np.testing.assert_allclose(float(m_gpu[k]), float(m_cpu[k]),
                                   rtol=1e-4, atol=1e-5, err_msg=k)
    want, got = cpu.to_host(), gpu.to_host()
    for part in sac.SACState.NETS + sac.SACState.OPTS:
        for field in ("mu", "nu") if part.endswith("_opt") else ("",):
            w = want[part][field] if field else want[part]
            g = got[part][field] if field else got[part]
            for name in w:
                np.testing.assert_allclose(g[name], w[name], rtol=1e-4,
                                           atol=1e-5,
                                           err_msg=f"{part} {field} {name}")


@pytest.mark.cuda
def test_enet_step_stages_match_cpu():
    """The elastic-net step at full width (M = N = 20) on the GPU against
    the CPU, stage by stage on the same inputs: the solve's first 5
    iterations (rtol 1e-4 / atol 1e-6), the influence state on the CPU's
    solution and curvature pairs (rtol 1e-4 / atol 1e-5), and the hint's
    50 MSEs on the CPU's 50 solutions (rtol 1e-5).  End to end the two
    devices part as the two packages do (tests/test_torch_enet.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smartcal_tpu_torch.envs import enet
    cfg = enet.EnetConfig()
    g = torch.Generator().manual_seed(0)
    st, _ = enet.reset(cfg, *enet.reset_draws(cfg, g, "cpu"))
    st = enet.draw_noise(cfg, st, torch.randn(cfg.N, generator=g))
    gst = enet.EnetState(*(v.cuda() for v in st))
    rho, _ = enet.action_to_rho(torch.tensor([0.3, -0.5]))
    short = enet.EnetConfig(lbfgs_iters=5)
    a = enet._solve(short, st.A, st.y, rho)
    b = enet._solve(short, gst.A, gst.y, rho.cuda())
    np.testing.assert_allclose(b.x.cpu().numpy(), a.x.numpy(), rtol=1e-4,
                               atol=1e-6)
    res = enet._solve(cfg, st.A, st.y, rho)
    gres = type(res)(*(type(v)(*(u.cuda() for u in v))
                       if isinstance(v, tuple) else v.cuda() for v in res))
    np.testing.assert_allclose(
        enet._influence(cfg, gst.A, gst.y, rho.cuda(), gres).cpu().numpy(),
        enet._influence(cfg, st.A, st.y, rho, res).numpy(), rtol=1e-4,
        atol=1e-5)
    mses, hres = enet.hint_solve(cfg, st)
    np.testing.assert_allclose(
        enet.hint_mses(cfg, gst, hres.x.cuda()).cpu().numpy(), mses.numpy(),
        rtol=1e-5)


@pytest.mark.cuda
def test_full_width_td3_learn_step_matches_cpu():
    """Three learn steps of the elastic-net TD3 agent (PER, hint ADMM:
    the second step updates the actor) at full width on the GPU and on the
    CPU from the same state with Adam history, batch and draws: every
    parameter, target and Adam moment within rtol 1e-4 / atol 1e-5."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.rl import td3
    cfg = td3.TD3Config(obs_dim=420, n_actions=2, batch_size=64,
                        mem_size=128, prioritized=True, use_hint=True)
    rng = np.random.default_rng(0)
    buf = rp.replay_init(cfg.mem_size, rp.transition_spec(420, 2), "cuda")
    for _ in range(96):
        r = float(rng.uniform(0, 3))
        rp.replay_add(buf, {
            "state": rng.standard_normal(420).astype(np.float32),
            "new_state": rng.standard_normal(420).astype(np.float32),
            "action": rng.uniform(-1, 1, 2).astype(np.float32),
            "reward": r, "done": False,
            "hint": rng.uniform(-1, 1, 2).astype(np.float32)},
            priority=td3.store_priority(cfg, r))
    gpu = td3.td3_init(cfg, torch.Generator("cuda").manual_seed(0), "cuda")
    for _ in range(4):
        td3.learn(cfg, gpu, buf, torch.Generator("cuda").manual_seed(1))
    gpu.learn_counter = 0
    cpu = gpu.copy_to("cpu")
    for i in range(3):
        idx = torch.from_numpy(rng.choice(96, 64, replace=False))
        batch = {k: v[idx.cuda()] for k, v in buf.data.items()}
        w = torch.from_numpy(rng.uniform(0.5, 1, 64).astype(np.float32))
        smooth = torch.tensor(float(rng.standard_normal()))
        for st, dev in ((gpu, "cuda"), (cpu, "cpu")):
            td3.learn_from_batch(cfg, st, {k: v.to(dev) for k, v in
                                           batch.items()}, w.to(dev),
                                 smooth.to(dev))
    want, got = cpu.to_host(), gpu.to_host()
    for part in td3.TD3State.NETS + td3.TD3State.OPTS:
        for field in ("mu", "nu") if part.endswith("_opt") else ("",):
            w = want[part][field] if field else want[part]
            g = got[part][field] if field else got[part]
            for name in w:
                np.testing.assert_allclose(g[name], w[name], rtol=1e-4,
                                           atol=1e-5,
                                           err_msg=f"{part} {field} {name}")


@pytest.mark.cuda
def test_batched_env_reset_and_step_on_gpu():
    """BatchedCalibEnv on the card, reset + one step of 3 lanes, against
    its fused=False oracle on the card (the JAX package's batched
    tolerances), and a prefetching CalibEnv against a plain one."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the batched route runs the CUDA "
                    "kernels and graphs")
    from smartcal_tpu_torch.envs.calib import BatchedCalibEnv, CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    tiny = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
                lbfgs_iters=3, init_iters=5, npix=32, device="cuda")
    acts = np.linspace(-0.5, 0.5, 18).reshape(3, 6).astype(np.float32)
    outs = []
    for fused in (True, False):
        env = BatchedCalibEnv(M=3, n_envs=3, backend=RadioBackend(**tiny),
                              seed=11, fused=fused, device="cuda")
        outs.append((env.reset(), env.step(acts)))
    (fo, (fo2, fr, _, finfo)), (oo, (oo2, orw, _, oinfo)) = outs
    for a, b in ((fo["img"], oo["img"]), (fo2["img"], oo2["img"])):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=2e-5)
    np.testing.assert_allclose(fr, orw, rtol=2e-3, atol=1e-4)
    np.testing.assert_allclose(finfo["sigma_res"], oinfo["sigma_res"],
                               rtol=1e-3)
    assert (finfo["sigma_res"] < finfo["sigma_data"]).all()
    plain, pre = (CalibEnv(M=3, backend=RadioBackend(**tiny), seed=3,
                           device="cuda", prefetch=p) for p in (False, True))
    for _ in range(3):
        a, b = plain.reset(), pre.reset()
        np.testing.assert_array_equal(a["img"], b["img"])
        np.testing.assert_array_equal(a["sky"], b["sky"])
    pre.close()


@pytest.mark.cuda
def test_demixing_on_gpu_matches_cpu():
    """The demixing slice on the GPU at the --small tier (K=3): the episode
    (the same host draws, V within 5e-4 of the CPU's), the hint sweep with
    every selection at admm_iters=2 one mask at a time and as one batch
    (rtol 1e-3, and against the CPU's), the fuzzy priorities against the
    CPU's (atol 1e-3 on 0-100), and the diffuse episode's shapelet add
    against the CPU's on the same uvw (rtol 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.envs.demixing import DemixingEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.models.fuzzy import DemixController
    small = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2,
                 admm_iters=30, lbfgs_iters=3, init_iters=5, npix=32)
    envs = {d: DemixingEnv(K=3, backend=RadioBackend(device=d, **small),
                           seed=0, device=d) for d in ("cuda", "cpu")}
    for env in envs.values():
        env.reset()
    g, c = envs["cuda"], envs["cpu"]
    V = g.ep.V.cpu().numpy()
    assert np.linalg.norm(V - c.ep.V.numpy()) < 5e-4 * np.linalg.norm(V)
    masks, _ = g.hint_masks()
    sig = {b: g.backend.hint_sweep(g.ep, g.rho, masks, admm_iters=2,
                                   batch=b).cpu().numpy() for b in (1, 4)}
    np.testing.assert_allclose(sig[4], sig[1], rtol=1e-3)
    np.testing.assert_allclose(sig[4], c.backend.hint_sweep(
        c.ep, c.rho, masks, admm_iters=2).numpy(), rtol=1e-3)
    rng = np.random.default_rng(0)
    mf = np.sort(rng.uniform(-90, 90, (8, 7, 3, 4)), -1)
    pmf = np.sort(rng.uniform(0, 100, (8, 3, 4)), -1)
    x = rng.uniform(-90, 90, (8, 7))
    np.testing.assert_allclose(
        DemixController(device="cuda").evaluate_batch(mf, pmf, x),
        DemixController(device="cpu").evaluate_batch(mf, pmf, x), atol=1e-3)
    key = prng.split(prng.PRNGKey(3))[1]
    b = RadioBackend(device="cuda", **small)
    ep, mdl = b.new_calib_episode(key, 2, 3, diffuse=True)
    shp = mdl.shapelet
    C = torch.zeros_like(ep.Ccal)
    got = b._add_shapelet(ep.obs, C, shp.coeff, shp.beta, shp.flux)
    cpu_obs = ep.obs._replace(uvw=ep.obs.uvw.cpu(), freqs=ep.obs.freqs.cpu())
    want = RadioBackend(device="cpu", **small)._add_shapelet(
        cpu_obs, C.cpu(), shp.coeff, shp.beta, shp.flux)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-6 * float(want.abs().max()))


@pytest.mark.cuda
def test_featurization_and_transformer_steps_on_gpu_match_cpu():
    """The supervised slice on the GPU at a small shape (N=6, Nf=3, T=8,
    npix=16, K=3): on one shared CPU solve, the perdir influence
    visibilities and each summary field (1e-4 relative norm, the
    influence tolerance) and the features (each unit-norm image block, kernel 1
    against its plain version, within 2e-4 relative; the scalars atol
    1e-4) against the CPU's, with one kernel-1 launch per direction; then
    3 transformer Adam steps from the same state on the same batches
    (rtol 1e-4 / atol 1e-5)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.cal import dataset, influence, solver
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.models.transformer import build_transformer
    from smartcal_tpu_torch.rl.sac import adam_init
    from smartcal_tpu_torch.train.supervised import transformer_step
    K, npix = 3, 16
    b = RadioBackend(device="cpu", n_stations=6, n_freqs=3, n_times=8,
                     tdelta=4, npix=npix, admm_iters=2, lbfgs_iters=3,
                     init_iters=5)
    ep, mdl = b.new_demixing_episode(prng.PRNGKey(2), K)
    res = b.calibrate(ep, mdl.rho, mask=np.ones(K, np.float32))
    freqs = ep.obs.freqs.numpy()
    out = {}
    for d in ("cpu", "cuda"):
        C, J, R = (t.to(d) for t in (ep.Ccal[0], res.J[0], res.residual[0]))
        hadd = influence.consensus_hadd_scalars(
            mdl.rho, np.full(K, 1e-3, np.float32), freqs, ep.f0, 0,
            polytype=0).to(d)
        inf = influence.influence_visibilities(
            solver.residual_to_kernel(R), C, J, hadd, 6, 2, perdir=True)
        summ = influence.perdir_summary(inf.vis, inf.llr, C, J)
        n0 = dft_imager.launches
        x = dataset.perdir_features(R, C, J, mdl.rho, freqs, ep.f0,
                                    ep.obs.uvw, 6, 2, mdl.separations,
                                    mdl.azimuth, mdl.elevation, npix=npix)
        out[d] = (inf.vis.cpu().numpy(), [v.cpu().numpy() for v in summ], x,
                  dft_imager.launches - n0)
    (vc, sc, xc, lc), (vg, sg, xg, lg) = out["cpu"], out["cuda"]
    assert lc == 0 and lg == K
    assert np.linalg.norm(vg - vc) < 1e-4 * np.linalg.norm(vc)
    for a, w in zip(sg, sc):
        assert np.linalg.norm(a - w) <= 1e-4 * np.linalg.norm(w)
    nout = npix * npix + 8
    for ck in range(K):
        blk = slice(ck * nout, ck * nout + npix * npix)
        assert np.linalg.norm(xg[blk] - xc[blk]) < 2e-4
        np.testing.assert_allclose(xg[blk.stop:(ck + 1) * nout],
                                   xc[blk.stop:(ck + 1) * nout], atol=1e-4)
    rng = np.random.default_rng(0)
    xb = torch.from_numpy(rng.standard_normal((3, 4, K * nout))
                          .astype(np.float32))
    yb = torch.from_numpy((rng.random((3, 4, K - 1)) > 0.5)
                          .astype(np.float32))
    models = {}
    for d in ("cpu", "cuda"):
        m = build_transformer(K, npix, 4,
                              generator=torch.Generator().manual_seed(0),
                              device=d)
        opt = adam_init(dict(m.named_parameters()))
        for i in range(3):
            transformer_step(m, opt, xb[i].to(d), yb[i].to(d), 1e-3)
        models[d] = m.state_dict()
    for k, v in models["cpu"].items():
        np.testing.assert_allclose(models["cuda"][k].cpu().numpy(),
                                   v.numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=k)


SERVE_TINY = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2,
                  admm_iters=2, lbfgs_iters=3, init_iters=5, npix=32)


def _serve_jobs(backend, M):
    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.serve import Job

    key = prng.PRNGKey(8)
    jobs = []
    for i, (k, maxiter) in enumerate(((2, 2), (3, 3), (2, 4))):
        key, sub = prng.split(key)
        ep, _ = backend.new_calib_episode(sub, k, M)
        jobs.append(Job(episode=ep, k=k, maxiter=maxiter,
                        rho=np.linspace(0.5 + i, 1.5 + i, k).astype(
                            np.float32)))
    return jobs


@pytest.mark.cuda
def test_served_batch_on_gpu_captures_nothing_and_matches_direct(tmp_path):
    """A warmed CalibServer's heterogeneous batch on the card: no compile
    event (the line search's graph was captured at warmup and is
    replayed), each lane bit for bit the direct batched calls, and within
    1e-3 of the same server on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    from smartcal_tpu_torch import obs
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.serve import CalibServer

    M = 3
    out = {}
    with obs.recording(str(tmp_path / "run.jsonl")):
        obs.install_compile_listener()
        for dev in ("cuda", "cpu"):
            be = RadioBackend(device=dev, **SERVE_TINY)
            srv = CalibServer(be, M=M, lanes=3, cache_dir=str(tmp_path / dev),
                              compile_cache=False)
            warm = srv.warmup(seed=7)
            jobs = _serve_jobs(be, M)
            c0 = obs.counters_snapshot().get("compile_events", 0.0)
            srv.process_once(jobs, timeout=0.01)
            c1 = obs.counters_snapshot().get("compile_events", 0.0)
            got = [j.future.result(timeout=60) for j in jobs]
            out[dev] = np.array([r.sigma_res for r in got])
            if dev == "cuda":
                assert warm["compile_events:cuda_graph"] == 1
                assert c1 - c0 == 0
                rho, mask, alpha, iters, _ = srv._lane_params(jobs)
                res = be.calibrate_batched(srv._bep, rho, mask, iters)
                imgs = be.influence_images_batched(srv._bep, res, rho, alpha)
                sd, sr = be.image_sigmas_batched(srv._bep, res)
                for lane, r in enumerate(got):
                    assert (r.sigma_res, r.sigma_data_img, r.sigma_res_img,
                            r.img_std) == (
                        float(res.sigma_res[lane]), float(sd[lane]),
                        float(sr[lane]),
                        float(np.std(imgs[lane].cpu().numpy())))
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-3)


@pytest.mark.cuda
def test_policy_publication_on_gpu_compiles_nothing(tmp_path):
    """Publications to a warmed policy-armed server on the card export,
    build and capture nothing; a swap to identical weights serves the same
    bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smartcal_tpu_torch import obs
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.serve import CalibServer, PolicyPublisher

    M = 3
    be = RadioBackend(device="cuda", **SERVE_TINY)
    cfg = sac.SACConfig(obs_dim=32 * 32 + (M + 1) * 7, n_actions=2 * M)
    st = sac.sac_init(cfg, torch.Generator(device="cuda").manual_seed(0),
                      "cuda")
    params = {k: v.detach().clone() for k, v in st.actor.state_dict().items()}
    with obs.recording(str(tmp_path / "run.jsonl")):
        obs.install_compile_listener()
        srv = CalibServer(be, M=M, lanes=3, cache_dir=str(tmp_path / "c"),
                          compile_cache=False, policy=(cfg, params))
        srv.warmup(seed=7)
        pub = PolicyPublisher(srv, keep_versions=2)

        def wave():
            jobs = _serve_jobs(be, M)
            for j in jobs:
                j.rho = None
                j.obs_vec = np.full(cfg.obs_dim, 1e-3, np.float32)
            srv.process_once(jobs, timeout=0.01)
            return [j.future.result(timeout=60).sigma_res for j in jobs]

        before = wave()
        c0 = obs.counters_snapshot()
        for v in (1, 2, 3):
            pub.publish(params, v)
        c1 = obs.counters_snapshot()
        assert c1.get("compile_events", 0.0) == c0.get("compile_events", 0.0)
        assert c1.get("export_cache_miss", 0.0) == \
            c0.get("export_cache_miss", 0.0)
        assert srv.policy_version == 3
        assert wave() == before


@pytest.mark.cuda
def test_enet_lbfgs_kernel_matches_plain_on_gpu():
    """Kernel 4 (``csrc/enet_lbfgs.cu``) against its plain version at full
    width (M = N = 20): on one step lane x after 5 iterations from x = 0,
    and on the hint's 50 weighted lanes each of the first 5 iterations from
    the kernel's own previous state (rtol 1e-4 / atol 1e-6, equal
    iteration counts; from x = 0 a lane whose search ends on a flat
    minimum turns float32 round-off into ~1e-5); the same bits over two
    launches; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.ops import enet_lbfgs, lbfgs
    from smartcal_tpu_torch.ops.autodiff import lane_value_and_grad
    cfg = enet.EnetConfig()
    g = torch.Generator().manual_seed(11)
    st, _ = enet.reset(cfg, *enet.reset_draws(cfg, g, "cpu"))
    st = enet.draw_noise(cfg, st, torch.randn(cfg.N, generator=g))
    A, y = st.A[None], st.y[None]
    rho, _ = enet.action_to_rho(torch.tensor([[0.3, -0.5]]))
    step = (A, y, rho[:, 0].contiguous(), rho[:, 1].contiguous(), None)
    dstep = tuple(None if a is None else a.cuda() for a in step)
    before = (enet_lbfgs.launches, enet_lbfgs.device_launches.read())
    got = enet_lbfgs.solve(*dstep[:4], max_iters=5)
    assert (enet_lbfgs.launches,
            enet_lbfgs.device_launches.read()) == (before[0] + 1,
                                                   before[1] + 1)
    want = enet_lbfgs.solve_plain(*step, max_iters=5)
    np.testing.assert_allclose(got.x.cpu().numpy(), want.x.numpy(),
                               rtol=1e-4, atol=1e-6)
    assert torch.equal(got.n_iters.cpu(), want.n_iters)
    lams, test = enet.hint_lanes(cfg, "cpu")
    w = torch.where(test, 0.0, 1.0)
    hint = (A, y, lams[:, 1].contiguous(), lams[:, 0].contiguous(), w)
    dhint = tuple(a.cuda() for a in hint)
    Ae, ye = enet_lbfgs._expand(A, y, 50)
    vag = lane_value_and_grad(lambda x: enet_lbfgs.lane_loss(
        Ae, ye, x, hint[2], hint[3], w))
    for k in range(5):
        prev = enet_lbfgs.solve_cuda(*dhint, max_iters=k)
        prev = type(prev)(*(type(v)(*(u.cpu() for u in v))
                            if isinstance(v, tuple) else v.cpu()
                            for v in prev))
        nxt = enet_lbfgs.solve_cuda(*dhint, max_iters=k + 1)
        ref = lbfgs.lbfgs_resume(vag, prev, 1)
        np.testing.assert_allclose(nxt.x.cpu().numpy(), ref.x.numpy(),
                                   rtol=1e-4, atol=1e-6)
        assert torch.equal(nxt.n_iters.cpu(), ref.n_iters)
    a = enet_lbfgs.solve_cuda(*dhint, max_iters=100)
    b = enet_lbfgs.solve_cuda(*dhint, max_iters=100)
    assert torch.equal(a.x, b.x) and torch.equal(a.n_iters, b.n_iters)


@pytest.mark.cuda
def test_enet_lbfgs_wide_path_matches_plain_on_gpu():
    """Kernel 4's wide path (N = 40 > 32, and a history of 10 > 8): x
    after 5 iterations from x = 0 against the plain version (rtol 1e-4 /
    atol 1e-6, equal iteration counts), the same bits over two
    launches; the wrapper's shared-memory sizes are the kernel's own."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from smartcal_tpu_torch.ops import enet_lbfgs
    lib = enet_lbfgs._lib()
    for N, M, m in ((20, 20, 7), (32, 1, 8), (33, 20, 7), (20, 20, 9),
                    (100, 100, 7)):
        assert lib.enet_lbfgs_smem_bytes(N, M, m) == \
            enet_lbfgs.smem_bytes(N, M, m)
    g = torch.Generator().manual_seed(3)
    for N, M, m in ((40, 24, 7), (20, 20, 10)):
        assert not enet_lbfgs.fast_path(N, M, m)
        args = (torch.randn(1, N, M, generator=g) / N ** 0.5,
                torch.randn(1, N, generator=g), torch.tensor([0.05]),
                torch.tensor([0.01]))
        dargs = tuple(a.cuda() for a in args)
        got = enet_lbfgs.solve(*dargs, max_iters=5, history_size=m)
        want = enet_lbfgs.solve_plain(*args, max_iters=5, history_size=m)
        np.testing.assert_allclose(got.x.cpu().numpy(), want.x.numpy(),
                                   rtol=1e-4, atol=1e-6)
        assert torch.equal(got.n_iters.cpu(), want.n_iters)
        again = enet_lbfgs.solve(*dargs, max_iters=5, history_size=m)
        assert torch.equal(got.x, again.x)


def _chip_smoke():
    """The repository's chip_smoke.py as a module: its inputs for the
    kernels' checks are the ones these tests hold."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
def test_sym_eigvals_kernel_matches_eigvalsh_on_gpu():
    """Kernel 5 (``csrc/sym_eigvals.cu``) against ``eigvalsh`` of the
    symmetric part on 64 random 20 x 20 matrices and on harder inputs
    (diagonal, a repeated eigenvalue, rank 1, zero, eigenvalues from 1e-4
    to 1e4; rtol 1e-5, atol 1e-6 x max|lambda|), ascending, the same bits
    over two launches; one NaN on the diagonal ranks last; odd and the
    largest sizes run too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from smartcal_tpu_torch.ops import sym_eigvals
    g = torch.Generator().manual_seed(13)
    B = torch.randn(64, 20, 20, generator=g).cuda()
    before = (sym_eigvals.launches, sym_eigvals.device_launches.read())
    got = sym_eigvals.sym_eigvals(B)
    assert (sym_eigvals.launches,
            sym_eigvals.device_launches.read()) == (before[0] + 1,
                                                    before[1] + 1)
    want = sym_eigvals.sym_eigvals_plain(B)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-5, atol=1e-6 * scale)
    assert bool((got[:, 1:] >= got[:, :-1]).all())
    assert torch.equal(got, sym_eigvals.sym_eigvals(B))
    for label, Bh in _chip_smoke()._eig_hard_cases(20).items():
        got = sym_eigvals.sym_eigvals(Bh.cuda()).cpu()
        again = sym_eigvals.sym_eigvals(Bh.cuda()).cpu()
        assert torch.equal(got.nan_to_num(7.0), again.nan_to_num(7.0))
        if label == "one NaN":
            assert bool(torch.isnan(got[-1]))
            assert bool(torch.isfinite(got[:-1]).all())
            assert bool((got[1:-1] >= got[:-2]).all())
            continue
        want = sym_eigvals.sym_eigvals_plain(Bh)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(want.abs().max()),
                                   err_msg=label)
    for n in (1, 7, sym_eigvals.MAX_N):      # against float64 eigvalsh
        Bn = torch.randn(3, n, n, generator=g)
        want = sym_eigvals.sym_eigvals_plain(Bn.double()).float()
        np.testing.assert_allclose(
            sym_eigvals.sym_eigvals(Bn.cuda()).cpu().numpy(), want.numpy(),
            rtol=1e-5, atol=1e-6 * float(want.abs().max()))


@pytest.mark.cuda
def test_enet_episode_program_replays_its_eager_body():
    """The enet_sac episode program (M = N = 8, 2 steps, a ring of 16,
    batch 4, the hint) as a CUDA-graph replay against its body run
    eagerly on the card from cloned state, ring and generator: the same
    bits, twice (the second call replays the captured graph).  Kernels 4
    and 5 count their runs on the card: a replay adds as many as the eager
    body's run, and nothing to the host's count."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.train import enet_sac
    from smartcal_tpu_torch.train.blocks import clone_ring
    env = enet.EnetConfig(M=8, N=8)
    cfg = sac.SACConfig(obs_dim=env.obs_dim, n_actions=2, batch_size=4,
                        mem_size=16, use_hint=True)
    gen = torch.Generator("cuda").manual_seed(0)
    st = sac.sac_init(cfg, gen, "cuda")
    buf = rp.replay_init(16, rp.transition_spec(env.obs_dim, 2), "cuda")
    st_e, buf_e = st.copy_to("cuda"), clone_ring(buf)
    g_e = torch.Generator("cuda")
    g_e.set_state(gen.get_state())
    from smartcal_tpu_torch.ops import enet_lbfgs, sym_eigvals
    prog = enet_sac.make_episode_fn(env, cfg, 2, True)
    kernels = (enet_lbfgs, sym_eigvals)

    def counts():
        return [(m.launches, m.device_launches.read()) for m in kernels]

    for i in range(3):
        c0 = counts()
        score = prog(st, buf, enet_sac.Draws(gen, "cuda"))
        c1 = counts()
        eager = prog.program._eager(st_e, buf_e, enet_sac.Draws(g_e, "cuda"))
        c2 = counts()
        for (h0, d0), (h1, d1), (h2, d2) in zip(c0, c1, c2):
            # the first call also warms the body up eagerly: one episode
            replayed = d1 - d0 - (h1 - h0)
            assert h1 - h0 == (h2 - h1 if i == 0 else 0)
            assert replayed == d2 - d1 == h2 - h1 > 0
        assert float(score) == float(eager[0])
        for a, b in zip(sac.state_tensors(st) + [buf.priority],
                        sac.state_tensors(st_e) + [buf_e.priority]):
            assert torch.equal(a, b)
        assert buf.cntr == buf_e.cntr and st.learn_counter == \
            st_e.learn_counter
    assert prog.program.replays == 3 and st.learn_counter == 3


@pytest.mark.cuda
def test_sharded_routes_on_two_positions_of_one_gpu():
    """Two mesh positions on cuda:0 against the single-device route: the
    frequency-sharded solve (N=8, Nf=2) at the CPU tests' tolerances
    (tests/test_sharded_cal.py), and the baseline-sharded influence (B=28
    over 2 positions: one kernel-3 launch per position and interval on
    its baseline slice) at relative norm 1e-5 with the LLR at rtol / atol
    1e-4 (tests/test_nscale_kernels.py), the same bits over two calls."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.cal import influence, solver
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.ops import hessian_blocks
    from smartcal_tpu_torch.parallel import mesh as pm
    from smartcal_tpu_torch.parallel import sharded_cal as sc
    dev = torch.device("cuda", 0)
    N, Ts, K = 8, 4, 3
    be = RadioBackend(n_stations=N, n_freqs=2, n_times=8, tdelta=2,
                      admm_iters=3, lbfgs_iters=3, init_iters=4, npix=16,
                      device=dev)
    ep, mdl = be.new_demixing_episode(prng.PRNGKey(3), K)
    cfg = be._solver_cfg(K)
    rho = torch.as_tensor(np.asarray(mdl.rho, np.float32), device=dev)
    ref = solver.solve_admm(ep.V, ep.Ccal, ep.obs.freqs, ep.f0, rho, cfg,
                            n_chunks=Ts)
    out = sc.solve_admm_sharded(
        pm.make_mesh((2,), (pm.AXIS_FREQ,), devices=[dev] * 2), ep.V,
        ep.Ccal, ep.obs.freqs, ep.f0, rho, cfg, n_chunks=Ts)
    for name in ("J", "Z"):
        np.testing.assert_allclose(getattr(out, name).cpu().numpy(),
                                   getattr(ref, name).cpu().numpy(),
                                   rtol=5e-3, atol=5e-4)
    d = torch.linalg.vector_norm(out.residual - ref.residual)
    assert float(d / torch.linalg.vector_norm(ref.residual)) < 1e-3
    assert float(out.sigma_res) == pytest.approx(float(ref.sigma_res),
                                                 rel=1e-3)

    hadd = influence.consensus_hadd_all(
        np.asarray(mdl.rho, np.float32), np.zeros(K, np.float32),
        ep.obs.freqs, ep.f0, n_poly=be.n_poly, polytype=be.polytype)[0]
    Rk = solver.residual_to_kernel(ref.residual[0])
    want = influence.influence_visibilities(Rk, ep.Ccal[0], ref.J[0], hadd,
                                            N, Ts)
    bp = pm.make_mesh((2,), (pm.AXIS_BASELINE,), devices=[dev] * 2)
    before = hessian_blocks.launches
    got = sc.influence_baseline_sharded(bp, Rk, ep.Ccal[0], ref.J[0], hadd,
                                        N, Ts)
    assert hessian_blocks.launches == before + 2 * Ts
    again = sc.influence_baseline_sharded(bp, Rk, ep.Ccal[0], ref.J[0],
                                          hadd, N, Ts)
    rel = torch.linalg.vector_norm(got.vis - want.vis) \
        / torch.linalg.vector_norm(want.vis)
    assert float(rel) < 1e-5
    np.testing.assert_allclose(got.llr.cpu().numpy(), want.llr.cpu().numpy(),
                               rtol=1e-4, atol=1e-4)
    assert torch.equal(got.vis, again.vis) and torch.equal(got.llr,
                                                           again.llr)
