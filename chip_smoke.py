"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

1. checks for a GPU and prints its name and power limit;
2. builds every CUDA kernel of smartcal_tpu_torch from csrc/ (one nvcc per
   source, all started together);
3. drives the port's main path once: CalibEnv(M=10) on the reference-scale
   RadioBackend (N=62 stations, Nf=3, T=20, tdelta=10, npix=128), reset
   and two steps with the analytic hint, random sky from seed 0, with the
   kernel launch counts zeroed just before and read just after;
   then profiles a third step and one more solve with torch.profiler to
   take the device's idle share (1 - busy device seconds / wall seconds);
4. holds every kernel against its plain PyTorch version on the card, at the
   main path's shapes (the episode's own uvw and data) and at a ragged R,
   and times kernel, plain version and yardstick with CUDA events;
5. checks the outputs (finite, sigma_res < sigma_data, launches on the
   path, a tiny episode on the GPU against the same episode on the CPU);
6. prints the kernel table as one JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Any failed phase raises, so the script exits non-zero and prints no result.
Details go to DIR/chip_smoke.json (default smoke_out/).
"""

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet rates (HBM3 bandwidth, dense FP32) and the SFU rate
# of sm_90 (16 sine/cosine results per clock per SM) at the 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
SFU_PER_CLOCK_PER_SM = 16
BOOST_HZ = 1.98e9

IMAGER_RTOL, IMAGER_ATOL = 2e-4, 2e-5   # tests/test_pallas_imager.py


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def imager_bound_ms(P, R, n_sm):
    """Least time for one direct-DFT image: bytes (uvw and vis read once,
    the image written once) over HBM rate, and operations — 7 FP32 flops
    per (pixel, sample) pair over the FP32 rate, and the 2 sine/cosine per
    pair over the SFU rate.  Returns (ms, bound_by)."""
    t_bytes = (R * 3 * 4 + R * 2 * 4 + P * 4) / HBM_BYTES_PER_S
    t_flops = 7.0 * P * R / FP32_FLOPS_PER_S
    t_sfu = 2.0 * P * R / (SFU_PER_CLOCK_PER_SM * n_sm * BOOST_HZ)
    t_ops = max(t_flops, t_sfu)
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def device_busy_seconds(fn):
    """Run ``fn()`` under torch.profiler (device activity only); returns
    (host seconds, seconds in which at least one device kernel or copy
    ran), or None for the second when the profiler saw no device activity.
    The raw kineto events are read directly: building the profiler's
    Python event tree takes minutes for the ~10^5 launches of a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA)
    if not spans:
        return wall, None
    busy_ns, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_ns += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    return wall, 1e-9 * (busy_ns + cur_e - cur_s)


def check_imager(dft_imager, imager, uvw, vis, freq, cell, npix, label):
    """Kernel vs plain version on the card; returns the error stats."""
    scale = torch.tensor(dft_imager.uv_scale(freq), device=uvw.device)
    uv = (uvw[:, :2] * scale).contiguous()
    lm = dft_imager.pixel_grid(npix, cell, uvw.device)
    vis = vis.contiguous()
    out = dft_imager.dirty_image_cuda(uv, lm, vis)
    ref = dft_imager.dirty_image_reference(uv, lm, vis)
    torch.cuda.synchronize()
    err = (out - ref).abs()
    vscale = float(vis.abs().mean())
    tol = IMAGER_ATOL * vscale + IMAGER_RTOL * ref.abs()
    ok = bool(torch.isfinite(out).all()) and bool((err <= tol).all())
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp(min=1e-30)).max())
    print(f"imager check {label}: npix={npix} R={uv.shape[0]} "
          f"max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol=|d| <= {IMAGER_ATOL}*mean|vis| + {IMAGER_RTOL}*|ref| "
          f"(mean|vis|={vscale:.4g}) -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"dft_imager disagrees with its plain version "
                             f"({label})")
    return uv, lm, vis, max_abs


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="smoke_out",
                    help="directory for chip_smoke.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from smartcal_tpu_torch.cal import imager
    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.ops import build, dft_imager

    report = {}
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {props.name} sms "
          f"{props.multi_processor_count}", flush=True)

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    report["build_seconds"] = time.perf_counter() - t0
    for name, (sec, log) in built.items():
        print(f"built {name} in {sec:.2f} s\n{log.strip()}", flush=True)
    print(f"build total {report['build_seconds']:.2f} s", flush=True)

    # -- main path: reference-scale CalibEnv, reset + 2 steps --------------
    backend = RadioBackend(n_stations=62, n_freqs=3, n_times=20, tdelta=10,
                           n_poly=2, admm_iters=10, lbfgs_iters=8,
                           init_iters=30, npix=128, device=dev)
    env = CalibEnv(M=10, backend=backend, seed=0, provide_hint=True,
                   device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    dft_imager.launches = 0
    t0 = time.perf_counter()
    obs0 = env.reset()
    t_reset = time.perf_counter() - t0
    steps = []
    for _ in range(2):
        t0 = time.perf_counter()
        obs, reward, _done, _hint, info = env.step(env.hint)
        steps.append({"seconds": time.perf_counter() - t0,
                      "reward": float(reward), **info})
    path_launches = dft_imager.launches
    report.update(reset_seconds=t_reset, steps=steps, K=env.K,
                  stage_seconds=dict(backend.stage_seconds),
                  peak_mem_bytes=torch.cuda.max_memory_allocated(dev),
                  dft_imager_launches=path_launches,
                  sigma_data_img=env._sigma_data_img)
    print(f"main path: K={env.K} reset {t_reset:.3f} s, steps "
          + ", ".join(f"{s['seconds']:.3f} s" for s in steps), flush=True)
    for s in steps:
        print(f"  reward {s['reward']:.6f} sigma_res {s['sigma_res']:.6f} "
              f"sigma_data {s['sigma_data']:.6f}", flush=True)
    print("stage seconds (host clock, synchronized): "
          + ", ".join(f"{k} {v:.3f}" for k, v in backend.stage_seconds.items())
          + f"; peak device memory {report['peak_mem_bytes'] / 2**20:.0f} MiB"
          f"; dft_imager launches {path_launches}", flush=True)
    for o in (obs0, obs):
        if not all(np.all(np.isfinite(v)) for v in o.values()):
            raise AssertionError("non-finite observation")
        if o["img"].shape != (128, 128) or o["sky"].shape != (11, 7):
            raise AssertionError("observation shapes")
    for s in steps:
        if not (math.isfinite(s["reward"]) and math.isfinite(s["sigma_res"])):
            raise AssertionError("non-finite reward or sigma_res")
        if not s["sigma_res"] < s["sigma_data"]:
            raise AssertionError("calibration did not reduce the residual")
    if path_launches < 9:
        raise AssertionError(f"dft_imager launched {path_launches} times on "
                             "the main path, expected >= 9")

    # -- device idle share: a third step and its solve, profiled -----------
    # busy = union of device kernel/copy spans; the share is taken against
    # the unprofiled step seconds above (the profiler slows the host)
    t_prof = time.perf_counter()
    step_wall_prof, step_busy = device_busy_seconds(
        lambda: env.step(env.hint))
    mask = np.zeros(env.M, np.float32)
    mask[:env.K] = 1.0
    rho = np.ones(env.M, np.float32)
    rho[:env.K] = env.rho_spectral[:env.K]
    t0 = time.perf_counter()
    backend.calibrate(env.ep, rho, mask=mask)
    solve_wall = time.perf_counter() - t0
    solve_wall_prof, solve_busy = device_busy_seconds(
        lambda: backend.calibrate(env.ep, rho, mask=mask))
    step_wall = float(np.mean([s["seconds"] for s in steps]))
    print(f"idle-share phase {time.perf_counter() - t_prof:.2f} s",
          flush=True)
    idle = {"step_wall_s": step_wall, "step_wall_profiled_s": step_wall_prof,
            "step_device_busy_s": step_busy, "solve_wall_s": solve_wall,
            "solve_wall_profiled_s": solve_wall_prof,
            "solve_device_busy_s": solve_busy}
    if step_busy is None or solve_busy is None:
        print("device idle share: not measured (the profiler saw no device "
              "activity)", flush=True)
    else:
        idle["step_idle_share"] = 1.0 - step_busy / step_wall
        idle["solve_idle_share"] = 1.0 - solve_busy / solve_wall
        print(f"device idle share: step {idle['step_idle_share']:.4f} "
              f"(busy {step_busy:.4f} s of {step_wall:.4f} s; profiled wall "
              f"{step_wall_prof:.4f} s), solve {idle['solve_idle_share']:.4f} "
              f"(busy {solve_busy:.4f} s of {solve_wall:.4f} s; profiled "
              f"wall {solve_wall_prof:.4f} s)", flush=True)
    report["idle"] = idle

    # -- kernel vs plain version at the path's shapes, and a ragged R ------
    ep = env.ep
    uvw = ep.obs.uvw.reshape(-1, 3)
    freq = float(ep.obs.freqs[0])
    cell = imager.default_cell(ep.obs.uvw, float(ep.obs.freqs[-1]))
    vis = imager.stokes_i_vis(ep.V[0])
    uv, lm, visc, err_path = check_imager(dft_imager, imager, uvw, vis, freq,
                                          cell, 128, "path")
    g = torch.Generator(device="cpu").manual_seed(0)
    ru = (torch.rand((1000, 3), generator=g) * 4e3 - 2e3).to(dev)
    rv = torch.randn((1000, 2), generator=g).to(dev)
    _, _, _, err_ragged = check_imager(
        dft_imager, imager, ru, rv, 150e6,
        imager.default_cell(ru, 150e6), 32, "ragged")

    P, R = lm.shape[0], uv.shape[0]
    kernel_ms = cuda_ms(lambda: dft_imager.dirty_image_cuda(uv, lm, visc), 20)
    plain_ms = cuda_ms(lambda: dft_imager.dirty_image_reference(uv, lm, visc),
                       5)
    factored_ms = cuda_ms(lambda: imager.dirty_image_factored_sr(
        uvw, visc, freq, cell, npix=128), 20)
    kernel_ms2 = cuda_ms(lambda: dft_imager.dirty_image_cuda(uv, lm, visc), 20)
    bound_ms, bound_by = imager_bound_ms(P, R, props.multi_processor_count)
    print(f"dft_imager at P={P} R={R}: kernel {kernel_ms:.4f} / "
          f"{kernel_ms2:.4f} ms (median, two runs), plain {plain_ms:.4f} ms, "
          f"factored-imager yardstick {factored_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}; SFU sin/cos at the data-sheet "
          "rate)", flush=True)

    # -- the same tiny episode on the GPU and on the CPU -------------------
    tiny = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
                lbfgs_iters=3, init_iters=5, npix=32)
    outs = []
    for d in (dev, torch.device("cpu")):
        e = CalibEnv(M=3, backend=RadioBackend(device=d, **tiny), seed=0,
                     provide_hint=True, device=d)
        o = e.reset()
        o2, r, _, _, inf = e.step(e.hint)
        outs.append((o["img"], o2["img"], r, inf["sigma_res"]))
    rel = [float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
           for a, b in zip(outs[0][:2], outs[1][:2])]
    rel_r = abs(outs[0][2] - outs[1][2]) / abs(outs[1][2])
    rel_s = abs(outs[0][3] - outs[1][3]) / abs(outs[1][3])
    print(f"tiny episode GPU vs CPU: img rel {rel[0]:.2e}/{rel[1]:.2e}, "
          f"reward rel {rel_r:.2e}, sigma_res rel {rel_s:.2e} "
          "(tolerance 1e-3: f32 reduction order and trig differ)", flush=True)
    if max(rel + [rel_r, rel_s]) > 1e-3:
        raise AssertionError("tiny episode: GPU and CPU disagree")

    kernels = [{
        "name": "dft_imager", "route": "cuda",
        "source": "smartcal_tpu_torch/csrc/dft_imager.cu",
        "replaces": "smartcal_tpu/ops/pallas_imager.py:58",
        "launches": path_launches, "max_abs_err": max(err_path, err_ragged),
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
        "yardstick_factored_ms": factored_ms}]
    report.update(kernels=kernels, card=card, tiny_rel=rel + [rel_r, rel_s])
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=float)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
