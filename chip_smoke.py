"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

1. checks for a GPU and prints its name and power limit;
2. builds every CUDA kernel of smartcal_tpu_torch from csrc/ (one nvcc per
   source, all started together);
2b. drives the demixing slice, before the first torch.profiler session of
   the process (after it launches run slower): a diffuse calibration
   episode (the shapelet sky) at N=62, calibrated, imaged and its
   influence mapped, with kernel 1's launches counted, the shapelet add
   held against its plain CPU computation on the same uvw and kernel 1
   against the direct DFT on the episode's data; DemixingEnv(K=6, hint,
   influence map) on the demixing trainers' default backend (N=14, Nf=3,
   T=20, admm_iters=30, npix=128), reset and two steps with fixed actions
   and the hint, stage seconds, L-BFGS iterations and peak memory, the
   hint's shape and range, and the sweep of all 32 selections one mask at
   a time, 8 and 32 at a time, held at rtol 1e-3 at 4 L-BFGS iterations
   (and the 1-ulp spread at admm_iters=2, 32 at a time, printed: chaotic
   there);
   BatchedDemixingEnv(E=4) fused and through its fused=False oracle,
   reset and one step, its stages held on the oracle's own solves and the
   end-to-end differences printed beside a 1-ulp spread; FuzzyDemixingEnv
   reset and one step, its priorities on the card against the CPU
   (atol 1e-3); the five trainers demix_sac (hint, influence), demix_sac
   --batch-envs 4, demix_td3, demix_fuzzy_sac (hint) and calib_sac
   --light, each 1 episode (one vector episode) of 1 step, their saved
   agent, ring and scores checked and their env-steps/s printed; counts
   zeroed just before and read just after each path (no kernel on the
   demixing paths: their images are 128² at N=14 and their reward is no
   image); the demixing step is profiled at the end (kernels per L-BFGS
   iteration, idle share);
2c. drives the supervised slice (``supervised_phase``), still before the
   first profiler session: the transformer dataset (3 samples on the
   default backend, N=14, npix=128, K=6; kernel 1 x 6 per sample, held
   against the direct DFT at the path's P=16,384, R=1,820), one sample's
   featurization on the card against the CPU on a shared solve, the
   full-width transformer (input 98,352, model_dim 396, 6 heads) trained
   200 steps on the balanced set with a falling loss and 3 Adam steps held
   against the CPU, a demixing episode written as TABLE.sct Measurement
   Sets and ``evaluate.recommend`` on them (kernel 1 x 6, 5 probabilities),
   the hint dataset with the MLP and TSK regressors and their live
   comparison (the hint backend at ADMM 10 of 30, 250 / 500 iterations),
   the TSK influence (one input) and the transformer influence (reduced
   width), ``evaluate_models`` with an untrained SAC agent; counts zeroed
   just before and read just after each path;
3. drives the reference-scale path: CalibEnv(M=10) on RadioBackend (N=62
   stations, Nf=3, T=20, tdelta=10, npix=128; ADMM 5 of its default 10,
   as every N=62 backend the script builds), reset and two steps with the
   analytic hint, random sky from seed 0, with the kernel launch counts
   zeroed just before and read just after; times one more solve, and
   queues a third step under torch.profiler for the device's idle share
   (1 - busy device seconds / unprofiled wall seconds) and its CUDA
   kernels per L-BFGS iteration;
3b. on that path's own episode and the solve it timed (no new solve):
   the host-loop backend's (``vectorized=False``) influence map, the
   oracle chain band by band with kernel 1 imaging each band (counts
   zeroed just before and read just after: Nf launches), held finite,
   within 5e-3 of the optimized route's image on the same operands and
   bit for bit over two calls, timed beside it; kernel 1 held against
   its plain version at the first band's influence operands and timed;
   the host-loop episode build of one key against the vectorized one
   (Ccal bit for bit, V within 1e-5);
4. holds the imager kernel (the separable-grid engine behind dft_imager)
   against its plain version, the direct DFT, over the full N=62 image and
   at ragged npix and R that cross the engine's tile and stage edges, and
   times kernel, plain version and the plain factored-imager yardstick with
   CUDA events;
5. drives the train path: ``train/calib_sac.py`` (1 episode of 1 step
   with the hint, seed 0) on the same N=62 backend, counts zeroed just
   before and read just after; checks the score and the saved ring
   (1 transition, no learn: the agent's learn step is measured on the
   batched trainer's agent, step 6b);
6. drives the elastic-net slice (M = N = 20; its solves are kernel 4,
   its eigenvalues kernel 5): one EnetEnv reset, three steps and a hint,
   timed and broken down (solve, influence state, hint; L-BFGS
   iterations; CUDA kernels per solve and per step by torch.profiler; a
   step's idle share), held
   against the CPU stage by stage; ``train/enet_sac.py`` (2 episodes of
   3 steps with the hint: 6 transitions, no learn at batch 64), its
   saved agent and ring checked, ``enet_eval`` for one game of 2 steps,
   then the ring
   topped up with random transitions and 5 warm-up learns, learn /
   choose_action / store_transition timed, 3 learn steps held against the
   CPU;
   ``train/enet_td3.py`` and ``train/enet_ddpg.py`` for 1 short episode
   and 3 full-width learn steps of each agent held against the CPU;
   ``train/calib_td3.py`` (1 episode of 1 step with the hint) and
   ``train/calib_ddpg.py`` (1 episode of 1 step) at N=62 with the DFT
   kernel's launches counted, and one full-width CNN TD3 learn step held
   against the CPU; counts zeroed just before and read just after each
   path;
6a. drives the whole-episode elastic-net programs (``enet_program_phase``):
   kernel 4 (``csrc/enet_lbfgs.cu``) against its plain version on one
   step lane and the hint's 50 weighted lanes, each of the first 5
   iterations from the kernel's own state and the step's x after 5 (rtol
   1e-4 / atol 1e-6), the full-depth losses (the step lane at rtol 1e-4,
   at least 24 hint lanes that stopped early on both sides at rtol 5e-3),
   the same bits over two launches; kernel 5 (``csrc/sym_eigvals.cu``)
   against eigvalsh on a step's influence matrix and 64 random symmetric
   matrices (rtol 1e-5, atol 1e-6 x max), then on harder inputs
   (diagonal, a fivefold eigenvalue, rank 1, zero, eigenvalues from 1e-4
   to 1e4) at the same tolerances and with one NaN, ranked last; each
   timed beside its plain version and its dependent-step floor; the
   episode programs of enet_sac,
   enet_td3 and enet_ddpg (CUDA-graph replays) against their bodies run
   eagerly on the card (the same bits), the block of 3 against 3
   episodes and again after an in-place restore (the same bits); and
   ``enet_sac --block 20`` and ``--block 1`` at the bench configuration
   (batch 64, ring 1024, 5 steps), without and with ``--use_hint``:
   env-steps/s over the timed programs, capture seconds, peak memory, and
   the runs of kernels 4 and 5 as the kernels count them on the card
   (graph replays included), held to one per step and hint;
6b. drives the batched slice at the N=62 scale (M=10, hint actions):
   ``BatchedCalibEnv(n_envs=4)`` reset and two vector steps, counts zeroed
   just before and read just after (the fused route runs no kernel), with
   stage seconds, L-BFGS iterations (slowest lane and lane mean) per
   vector step, a third step profiled for the idle share and CUDA kernels
   per L-BFGS iteration (beside the N=62 path's single step, profiled in
   step 3); the same 4 lanes through
   the ``fused=False`` oracle (reset and one step): the largest end-to-end
   error against each of the JAX package's batched tolerances is printed
   beside a 1-ulp change of V's effect on lane 0's solve (the solve is
   chaotic in float32), and held are the fused influence, sigmas and
   reward on the oracle's own step solves (those tolerances) and lane 0's
   step solve through the batched route at E=1 (bit for bit);
   ``CalibEnv(prefetch=True)`` against ``prefetch=False`` over 2 resets
   (equal observations, reset seconds, each prefetch taken ready or
   waited on, a solve running while the next episode builds);
   ``train/calib_sac.py --batch-envs 4`` for 2 vector episodes of 4 steps
   (8 finite scores; 32 transitions, 1 learn); loads its agent and
   times learn (batch 32, 128² image, M=10), choose_action and
   store_transition with CUDA events, takes a learn step's idle share,
   and holds 3 learn steps on the card against the CPU from the same
   state, batch indices and noise (rtol 1e-4 / atol 1e-5);
7. drives the SKA-tier path: CalibEnv(M=10) on RadioBackend (N=256, Nf=3,
   T=20, npix=1024: the blocked Hessian and the large-tier factored imager
   chosen by threshold), reset and one step with the hint, counts zeroed
   just before and read just after; the first call of each kernel in the
   step keeps its operands; a second step is profiled for the idle share
   (at the end of the run, as every profiled measurement);
7b. drives the mixed-precision path (``bf16_phase``) on that step's own
   episode and solve (the solve is pinned f32, so no new reset or solve):
   ``RadioBackend(precision="bf16")`` at the SKA tier, its statics those of
   the f32 backend plus ``precision="bf16"``, one influence call with the
   counts zeroed just before and read just after (kernel 2's bf16 mode 3,
   the Hessian 6, kernel 2's f32 mode 0), held to the f32 step's image
   within the bf16 band (max |bf16 - f32| / max|f32| and the std's drift,
   judged by the port's obs/regress) and its band-0 LLR bit for bit; the
   f32 and the bf16 routes timed again on the same operands; kernel 2's
   bf16 mode against its plain bf16 version (2e-3 x max|plain|) at the
   path's operands and at the ragged cases (also R below one 32-sample
   stage and npix 640), against the f32 mode (2e-2 x max), bit for bit
   over two launches, and timed beside its plain version and the cuBLAS
   BF16 GEMM of the planes, with ptxas's registers; then the same influence
   check at N=62 on the step-3 path's episode and solve (no kernel 2
   there: the column means and the factored matmuls in bf16);
8. holds each kernel against its plain version on the card at those
   operands (the imager against the direct DFT on a 4096-pixel subset) and
   at ragged cases, and times kernel, plain version and library yardstick
   with CUDA events; the Hessian also bit for bit over two launches, on
   full sets with partial tiles, with R3 streamed (Td=80) and on a subset
   with sentinels, and its launches alone (``device_ms``: events around
   the C call, schedule and outputs prebuilt); times the pieces of the
   SKA influence chain on the step's own operands (Hessian kernel,
   placement, consensus add + adjoint column means and the solve inside
   them, LLR, the operand preparation and the whole of
   influence_visibilities, the factored imager); counts how many of three
   factored-imager launches torch.profiler records (a check on the idle
   shares);
9. runs two tiny episodes on the GPU and on the CPU (unblocked, and the
   blocked tier forced) and compares them;
9a. drives the rest of the runtime slice (``runtime_rest_phase``), before
   the runtime phase's profiler session: one N=62 episode solved on the
   fused route and under SMARTCAL_HOST_SOLVER=1 (seconds, segments and
   CUDA-graph captures of each, J / sigma_res / residual compared bit for
   bit, else held at admm_iters=2 within JAX's host-vs-fused tolerances);
   the solver ladder reaching its host rung on the tiny tier under a
   non-finite visibility, then SolverDegradedError (its
   solver_degraded events); NativePER beside
   the device ring at the N=62 transition (µs per store, sample with its
   copy to the card, priority update), SACAgent(prioritized,
   replay_backend="native") 20 learns beside the device-ring agent's and
   a save_models / load_models round trip bit for bit; the port's perf
   gate at 3 samples a stage (bless, a clean gate, a gate_solve delay and
   a gate_numeric_imager perturbation each firing on its own stage, over
   the solve, influence and imager stages);
   ``train/demix_fuzzy_sac.py --deterministic`` 2 episodes straight
   against 1 + --resume to 2, bit for bit with 2 learns before the kill,
   the straight run with --diag --metrics holding the card's
   roofline_peak and cost events (flops, bytes) of solve, influence and
   agent_update_sac; the device-ring agent's learn timed with
   deterministic algorithms off and on; kernel counts zeroed before and
   read after;
9a'. drives the distributed-training slice (``fleet_phase``), before the
   runtime phase's profiler session: the enet thread fleet
   (``parallel/learner.train_supervised``, M = N = 20 at 30 L-BFGS
   iterations, 2 actors x 4 lanes, IS-clip 2.0, ERE 0.98, publish every 2,
   4 rounds, actor 1 killed at iteration 1: a restart, learning past it,
   staleness > 0, env-steps/s); the process fleet (2 spawned workers on
   the card, 2 rounds, every worker joined); ``make_parallel_sac`` at 16
   lanes (3 timed vector steps, one learn each, env-steps/s) and
   ``train_distributed`` for 2 episodes; the demixing fleet
   (``train_supervised_demix``, K=6, N=14, npix=128, influence maps, 1
   thread actor x 1 iteration of 1 x 3 steps): kernel 1 launched Nf per
   observation, its first image held against the direct DFT and timed;
   one DSAC learn and one fused sharded step held against the CPU from
   states with Adam history, and the synchronizing CUDA calls of one
   fused step counted;
9a*. drives the multi-process slice (``multiprocess_phase``), after the
   distributed-training slice: 2 ranks spawned on the card
   (``parallel/multihost.launch``, gloo: the ranks share the GPU), the
   kernels built beforehand in this process; in each rank a
   ``process_allgather`` of the rank ids, a psum over an ``fp`` axis of
   the ranks (held bit for bit against the thread form's on the card),
   ``make_parallel_sac`` with 4 lanes over ``dp`` = 2 for 2 train steps
   (kernels 4 and 5 in each rank; one learn) and one ``train_distributed_demix``
   episode with one actor per rank (N=14, npix=128, influence maps:
   kernel 1, Nf per observation), counts zeroed just before and read just
   after each path and summed over the ranks
   (``ops/build.summed_over_ranks``), then each kernel held in its rank
   against its plain version; the replicas' digests equal;
9a''. drives the serving slice (``serve_phase``), before the runtime
   phase's profiler session: one ``CalibServer`` at the N=62 backend, M=10,
   4 lanes, a fresh SAC policy (obs_dim 128² + 11·7): a cold warmup into
   an empty program cache (the policy through ``torch.export``, the solve
   and influence prepared, the line search captured once); one
   ``process_once`` batch of 4 heterogeneous jobs (k 2/5/7/10, a diffuse
   sky, maxiter None/9/12, 2 pinned-rho and 2 policy jobs) with 0 compile
   events, each lane bit for bit ``calibrate_batched`` +
   ``influence_images_batched`` + ``image_sigmas_batched`` on the serving
   buffer; the supervised worker on 8 submitted jobs (2 batches) while
   the breaker thread replays each batch's sentinel lane beside the next
   batch (the overlap read from the run log; no compile event from a
   thread but the breaker's); ``swap_policy`` to version 1 with the same
   weights and the batch again, bit for bit; the exported policy program
   against the eager actor at version 0's weights and at perturbed ones
   (version 2), whose served rho must be the eager forward's and not
   version 0's; one ``sentinel_poll`` whose replay launches kernel 1 six
   times, held against its plain version at those operands and timed; a
   second server on the same cache warms up with the policy program
   loaded from its .pt2, the prepared programs' sidecars found and 0 nvcc
   builds; the stage spans from the run log;
9b. drives the runtime slice (``runtime_phase``): ``train/calib_sac.py``
   at N=62 (2 episodes of 1 step, hint) with --metrics --diag --watchdog
   --ckpt-every 1, and 1 episode plus a --resume to 2, whose last
   checkpoint must equal the straight run's bit for bit (scores,
   parameters, Adam moments, generator, ring and priorities, env key),
   kernel 1's launches counted; ``train/enet_sac.py`` (M = N = 20, 2
   episodes of 2 steps) killed after 1 and resumed, and rolled back from
   a SMARTCAL_FAULTS NaN under --max-recoveries 1; save_checkpoint /
   load_latest of a full 10,000-transition N=62 ring; the run log's stage
   shares beside stage_seconds; a learn step's diag overhead and its
   on/off bit identity; last, a 1-step ``--trace`` run (``--small``) whose
   Chrome trace must hold the spans;
9c. runs the profiled measurements the phases queued (step 3's, the
   enet step's and solve's, the learn steps', the batched step's, the SKA
   step's, the factored kernel's capture count and the demixing step's):
   a torch.profiler session slows every later launch of the process, so
   none runs before the last timed phase; they hold nothing, and one that
   would start more than ``PROFILE_DEADLINE_S`` into the run (a slower
   host) is skipped and says so;
10. prints the kernel table as one JSON line (with each kernel's launches
   on the diffuse, demixing, supervised and bf16 paths; kernel 2's bf16
   mode is an entry of its own), the card line, and last
   {"ok": true, "device": {...}}.

Any failed phase raises, so the script exits non-zero and prints no result.
Details go to DIR/chip_smoke.json (default smoke_out/).

    python3 chip_smoke.py --runtime [--out DIR]
    python3 chip_smoke.py --runtime-rest [--out DIR]
    python3 chip_smoke.py --supervised [--out DIR]
    python3 chip_smoke.py --bf16 [--out DIR]
    python3 chip_smoke.py --fleet [--out DIR]
    python3 chip_smoke.py --serve [--out DIR]

build the kernels and run step 9b (9a, 2c) alone, or one N=62 reset +
step, one SKA reset + step and step 7b on them (details in
DIR/runtime_phase.json, DIR/runtime_rest_phase.json,
DIR/supervised_phase.json, DIR/bf16_phase.json); ``--fleet`` runs step
9a' alone and deeper: the enet solves at 200 L-BFGS iterations, 8 fleet
rounds, and the demixing fleet with 2 actor threads in processes of
their own under a time limit, with and without its CUDA-graph captures
under one lock (DIR/fleet_phase.json); ``--serve`` runs step 9a'' alone
and deeper: the open-loop load generator on the N=62 server at 0.6 and
0.9 of the capacity one batch gives, 200 requests each,
``python -m smartcal_tpu_torch.tools.serve_calib --tier medium --policy``
twice on one cache (the second run loads the policy program, finds the
prepared programs' sidecars, builds nothing with nvcc and records 0
steady-state compile events), ``tools.serve_fleet`` with 2
replica processes on the card and a replica kill (replica 1 warm from the
shared cache with 0 nvcc builds), and ``tools.serve_learn`` with at least
3 publishes and 0 compile events in its window (DIR/serve_phase.json).

    python3 chip_smoke.py --multiprocess [--out DIR]

builds the kernels and runs the deeper multi-process phase
(``mp_deep_phase``): NCCL's answer to two ranks on one GPU; the N=62
full-depth ``solve_admm_sharded`` over 3 ``fp`` ranks beside the fused
solve and the thread route (3 positions) on the same operands, and a
routed CalibEnv reset and step over the 3 ranks; the SKA
``influence_image`` over 2 ``bp`` ranks (kernels 3 and 2 in each rank,
held there) within 1e-4 of the single-device route, beside it and the
thread route; ``python -m smartcal_tpu_torch.parallel.learner`` over 2
ranks with ``--replay-shards 2`` (DIR/multiprocess_deep.json).

    python3 chip_smoke.py --enet-program [--out DIR]

builds the kernels and runs step 6a alone, over twice the episodes and
with the plain solves timed 3 times (DIR/enet_program_phase.json).

    python3 chip_smoke.py --oracle [--out DIR]

builds the kernels and runs CalibEnv(M=10) at N=62, reset + 1 step with
the hint, after one unrecorded reset of each route, on the vectorized and
on the host-loop backend from seed 0 (stage seconds, peak memory, kernel
1's launches: Nf more per influence map on the host loop), with step 3b's
checks between them (DIR/oracle_phase.json).

    python3 chip_smoke.py --ablation [--out DIR]

instead builds the imaging engine (csrc/separable_imager.cuh behind
dft_imager.cu) as shipped and with one design choice undone in each copy
(``ablation_variants``), runs each at the SKA tier's shapes (npix=1024,
R=652,800, random and coherent visibilities) and the N=62 tier's
(npix=128, R=37,820), holds it against the direct DFT on 4096 pixels and
the phase centre and times it with CUDA events; one JSON line per variant
and case, details in DIR/engine_ablation.json.

    python3 chip_smoke.py --bf16-ablation PARENT_CU [--out DIR]

instead builds kernel 2's bf16 mode of commit 5dda491 (PARENT_CU, e.g.
``git show 5dda491:smartcal_tpu_torch/csrc/factored_imager.cu``, on the
unchanged engine header), the shipped one, and copies of the shipped one
with part of its work switched off (``BF16_VARIANTS``: constant operands,
no products; ``BF16_DIAGNOSTICS``: the bf16 pack by integer ops, no
stores, other promotion cadences); holds the shipped one against its
plain bf16 version at the ragged cases first, then each at npix=1024,
R=652,800 on ``--ablation``'s random operands and on a coherent image,
and times each in two turns (forward, then reversed) beside the cuBLAS
BF16 GEMM of the planes; one JSON line per variant (ms, errors,
registers), details in DIR/bf16_ablation.json.

    python3 chip_smoke.py --enet-kernel-ablation PARENT_DIR [--out DIR]

instead builds kernels 4 and 5 of a parent checkout (PARENT_DIR, e.g.
``git archive 0d05980 smartcal_tpu_torch/csrc | tar -x -C DIR``; its
smartcal_tpu_torch/csrc/), the shipped ones and a copy of the shipped
kernel 4 with A in shared memory (``ENET_LEVERS``); holds every kernel 4
as step 6a does, printing each verdict and whether it gives the parent's
bits, then on 32 seeded step lanes each lane's full-depth loss against
the plain version, its iterations and its evaluations; holds kernel 5
against eigvalsh; then times each on the same operands in two turns
(forward, then backward): kernel 4 on the step lane, the hint's 50 lanes
and the seeded lanes (also per evaluation), kernel 5 and eigvalsh on one
and on 64 random 20 x 20 matrices; details in
DIR/enet_kernel_ablation.json.

    python3 chip_smoke.py --hessian-split PARENT_CU [--out DIR]

instead times the Hessian kernels launch by launch at the SKA path's
shapes (K=10, Td=10, N=256), CUDA events around each launch and around 20
back-to-back launches: the two-pass kernel of commit dc0ef65 (PARENT_CU,
e.g. ``git show dc0ef65:smartcal_tpu_torch/csrc/hessian_blocks.cu``) pass
by pass, the shipped kernel's tile pass and combine, and copies of the
shipped kernel with one choice changed (``HESSIAN_VARIANTS``: tile shape,
ring depth, and the copies or the algebra alone); details in
DIR/hessian_split.json.
"""

import argparse
import ctypes
import dataclasses
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM data-sheet rates (HBM3 bandwidth, dense FP32, dense TF32 and
# BF16 tensor cores) and the SFU rate of sm_90 (16 sine/cosine results per
# clock per SM) at the 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
BF16_FLOPS_PER_S = 989e12
SFU_PER_CLOCK_PER_SM = 16
BOOST_HZ = 1.98e9

IMAGER_RTOL, IMAGER_ATOL = 2e-4, 2e-5   # tests/test_pallas_imager.py
# tests/test_nscale_kernels.py: atol is this times max|ref|
FACTORED_RTOL, FACTORED_ATOL = 2e-4, 2e-4
# tests/test_pallas_hessian.py's rtol; the atol is taken relative to
# max|ref| because the path's operands are not unit-scale
HESSIAN_RTOL, HESSIAN_ATOL = 2e-4, 2e-5

SKA = dict(n_stations=256, n_freqs=3, n_times=20, tdelta=10, n_poly=2,
           admm_iters=10, lbfgs_iters=8, init_iters=30, npix=1024)
SKA_STATICS = {"block_baselines": 2048, "imager_block_r": 4096}
TINY = dict(n_stations=6, n_freqs=2, n_times=4, tdelta=2, admm_iters=2,
            lbfgs_iters=3, init_iters=5, npix=32)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    """Median milliseconds of ``fn()`` over ``reps`` runs, CUDA events."""
    for _ in range(warmup):
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


def cuda_ms_batched(fn, n=20, reps=5, warmup=2):
    """Median over ``reps`` of the milliseconds per call of ``n`` calls of
    ``fn()`` between one pair of CUDA events: the device time of
    back-to-back launches, without the host's gap before a lone launch."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return float(np.median(times))


def bound(n_bytes, flops, sfu, n_sm):
    """Least time (ms) for the work: bytes over the HBM rate, against FP32
    flops over the FP32 rate and sine/cosine values over the SFU rate.
    Returns (ms, bound_by)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = max(flops / FP32_FLOPS_PER_S,
                sfu / (SFU_PER_CLOCK_PER_SM * n_sm * BOOST_HZ))
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes > t_ops else "operations")


def separable_bounds(npix, R, n_sm):
    """Least times (ms) for the dirty image on the separable grid, uvw and
    vis read once and the image written once.  ``bound_ms``: at f32
    accuracy, the 4 npix^2 R flops as 3xTF32 (three TF32 products) at the
    dense TF32 tensor-core rate, against the 4 npix R sine/cosine values on
    the SFUs and the bytes; ``bound_fp32_ms``: the same flops in FP32 on the
    CUDA cores; ``bound_direct_ms``: the direct DFT, 2 npix^2 R sine/cosine
    values and 7 FP32 flops per (pixel, sample) pair; ``bound_bf16_ms``:
    the bf16 mode of the factored imager, the flops once at the dense BF16
    tensor-core rate, against the same sine/cosine values and bytes."""
    P = npix * npix
    n_bytes = R * 3 * 4 + R * 2 * 4 + P * 4
    flops = 4.0 * P * R
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_sfu = 4.0 * npix * R / (SFU_PER_CLOCK_PER_SM * n_sm * BOOST_HZ)
    t_ops = max(3.0 * flops / TF32_FLOPS_PER_S, t_sfu)
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_bf16_ms": 1e3 * max(t_bytes, flops / BF16_FLOPS_PER_S,
                                       t_sfu),
            "bound_by": "bytes" if t_bytes > t_ops else "operations",
            "bound_fp32_ms": bound(n_bytes, flops, 4.0 * npix * R, n_sm)[0],
            "bound_direct_ms": bound(n_bytes, 7.0 * P * R, 2.0 * P * R,
                                     n_sm)[0]}


def hessian_bound_ms(args, n_sm):
    """Block sums: every operand read once, off and Dsum written once; the
    kernel's FP32 flops: 192 per (k, t, b) (off 128, the Gram matrix of C
    64) and 384 per (k, b) (Jq^H Jq and Jp^H Jp 128, Sp and Sq from the
    Gram matrix 256)."""
    R3, C5, Jp, Jq, p_idx, q_idx, N = args
    K, Td, B = C5.shape[0], C5.shape[1], C5.shape[2]
    n_in = sum(t.numel() * t.element_size()
               for t in (R3, C5, Jp, Jq, p_idx, q_idx))
    n_out = (K * B * 32 + K * N * 8) * 4
    return bound(n_in + n_out, 192.0 * K * Td * B + 384.0 * K * B, 0.0, n_sm)


# ragged Hessian cases (N, K, Td, subset): full sets with partial tiles on
# both station axes and direction chunks; Td=80, whose R3 tile does not
# fit in shared memory (streamed per step); a subset with sentinels
HESSIAN_RAGGED = ((100, 3, 5, False), (64, 2, 4, False), (20, 2, 80, False),
                  (20, 3, 3, True))


def check_hessian(hessian_blocks, kernels, args, kw, label):
    """Two launches of the Hessian kernel: bit-identical, and within the
    tolerance of the plain version; returns the max abs errors."""
    off, dsum = hessian_blocks.hessian_block_sums_cuda(*args, **kw)
    off2, dsum2 = hessian_blocks.hessian_block_sums_cuda(*args, **kw)
    off_ref, dsum_ref = kernels._hessian_block_sums(*args)
    torch.cuda.synchronize()
    same = torch.equal(off, off2) and torch.equal(dsum, dsum2)
    print(f"hessian_blocks {label}: two launches bit-identical: {same}",
          flush=True)
    if not same:
        raise AssertionError(f"hessian_blocks: two launches differ ({label})")
    return [check_close("hessian_blocks off", label, off, off_ref,
                        HESSIAN_RTOL, HESSIAN_ATOL,
                        float(off_ref.abs().max())),
            check_close("hessian_blocks Dsum", label, dsum, dsum_ref,
                        HESSIAN_RTOL, HESSIAN_ATOL,
                        float(dsum_ref.abs().max()))]


def influence_pieces(chunk_call, vis_call, reps=5):
    """Milliseconds (CUDA events, median of ``reps``) of the pieces of the
    SKA influence chain on the step's own operands (the first call of
    ``_chunk_influence_opt`` and of ``influence_visibilities``).  Per
    chunk: the Hessian kernel, the placement tail, the consensus add plus
    the adjoint column means (with a clone of H), the real solve inside
    the column means alone, the LLR.  Per band: the operand preparation of
    ``influence_visibilities`` (C5 transpose, Jp/Jq gathers, Csum, lhs
    einsum) and the whole function."""
    from smartcal_tpu_torch.cal import creal, influence, kernels
    from smartcal_tpu_torch.ops import hessian_blocks
    (R3, C5, Jp, Jq, lhs, hadd, N, _), _ = chunk_call
    Td, B = C5.shape[1], C5.shape[2]
    sched, p, q = hessian_blocks.full_schedule(N, C5.device)
    off, dsum = hessian_blocks.hessian_block_sums_cuda(R3, C5, Jp, Jq, p, q,
                                                       N, sched=sched)
    H = kernels._hessian_assemble(off, dsum, N, B, Td)
    diag = torch.arange(H.shape[1], device=H.device)
    H_add = H.clone()
    H_add[:, diag, diag, 0] += hadd[:, None]
    W = torch.randn((H.shape[0], H.shape[1], 4, 2), generator=torch.Generator(
        ).manual_seed(5)).to(H.device)

    def colmeans():
        Hc = H.clone()
        Hc[:, diag, diag, 0] += hadd[:, None]
        return kernels._colmeans_adjoint_core_sr(lhs, Hc, N, Td)

    (R, C, J, hadd_f, n_st, n_chunks), vis_kw = vis_call

    def prep():
        K = C.shape[0]
        td = C.shape[1] // B // n_chunks
        C5a = C.reshape(K, n_chunks, td, B, 2, 2, 2).transpose(-3, -2) \
            .movedim(1, 0).contiguous()
        pi, qi = kernels.baseline_indices(n_st, R.device)
        J4 = J.reshape(n_chunks, K, n_st, 2, 2, 2)
        Csum = torch.sum(C5a, dim=2)
        return (J4[:, :, pi], creal.einsum("skbuv,skbwv->skbuw",
                                           J4[:, :, qi], creal.conj(Csum)))

    pieces = {
        "hessian_kernel": lambda: hessian_blocks.hessian_block_sums_cuda(
            R3, C5, Jp, Jq, p, q, N, sched=sched),
        "hessian_assemble": lambda: kernels._hessian_assemble(off, dsum, N,
                                                              B, Td),
        "hadd_colmeans": colmeans,
        "solve_in_colmeans": lambda: creal.solve(H_add.transpose(1, 2), W),
        "llr": lambda: kernels._llr_core_sr(R3, C5, Jp, Jq),
        "visibilities_prep": prep,
        "influence_visibilities": lambda: influence.influence_visibilities(
            R, C, J, hadd_f, n_st, n_chunks, **vis_kw),
    }
    out = {name: cuda_ms(fn, reps, warmup=1) for name, fn in pieces.items()}
    out["n_chunks"] = n_chunks
    return out


def hessian_launcher(hessian_blocks, hargs, sched, lib=None,
                     entry="hessian_blocks_launch"):
    """A closure that launches the Hessian kernel's C entry ``entry`` of
    ``lib`` (default: the shipped library) on prebuilt outputs: operands
    aligned, the schedule built, nothing allocated per launch.  Returns
    (launch, off, dsum)."""
    R3, C5, Jp, Jq, p_idx, q_idx, N = hargs
    K, Td, B = C5.shape[0], C5.shape[1], C5.shape[2]
    dev = C5.device
    R3, C5, Jp, Jq = (hessian_blocks._aligned(t) for t in (R3, C5, Jp, Jq))
    if sched is None:
        sched = hessian_blocks.subset_schedule(p_idx, q_idx, N, dev)
    off = torch.empty((K, B, 4, 4, 2), dtype=torch.float32, device=dev)
    part = torch.empty((K, max(sched.n_rows, 1), 8), dtype=torch.float32,
                       device=dev)
    dsum = torch.empty((K, N, 2, 2, 2), dtype=torch.float32, device=dev)
    fn = getattr(lib or hessian_blocks._lib(), entry)
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 \
        + [ctypes.c_void_p] * 4
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch():
        rc = fn(C5.data_ptr(), R3.data_ptr(), Jp.data_ptr(), Jq.data_ptr(),
                sched.cell_b.data_ptr(), sched.slot_dst.data_ptr(),
                sched.st_off.data_ptr(), K, Td, B, N, sched.cell_b.shape[0],
                sched.n_rows, off.data_ptr(), part.data_ptr(),
                dsum.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"hessian_blocks {entry} failed ({rc})")

    return launch, off, dsum


def device_busy_seconds(fn):
    """Run ``fn()`` under torch.profiler (device activity only); returns
    (host seconds, seconds in which at least one device kernel or copy
    ran, the number of device kernels and copies recorded), with None for
    the second when the profiler saw no device activity.  The raw kineto
    events are read directly: building the profiler's Python event tree
    takes minutes for the ~10^5 launches of a step."""
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
        return wall, None, 0
    busy_ns, cur_s, cur_e = 0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy_ns += cur_e - cur_s
            cur_s = s
        cur_e = max(cur_e, e)
    return wall, 1e-9 * (busy_ns + cur_e - cur_s), len(spans)


def profiler_capture(fn, name_part, reps=3):
    """How many of ``reps`` calls of ``fn`` (one launch each of a kernel
    whose name holds ``name_part``) torch.profiler records, and their mean
    recorded milliseconds: a check on the device spans behind the idle
    shares, which are upper bounds when records go missing."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    durs = [1e-6 * e.duration_ns() for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA and name_part in e.name()]
    return len(durs), (float(np.mean(durs)) if durs else None)


# A torch.profiler session slows every later launch of the process by
# 1.2-1.3x, TEARDOWN_CUPTI=1 or not (PERF.md section 7), so the default run
# queues its profiled measurements and runs them after its timed phases.
DEFERRED = []
# They measure and hold nothing: one that would start later than this
# into the run (a slower host) is skipped, and says so, so that the run
# stays inside its 1200 s.
PROFILE_DEADLINE_S = 800.0


def defer(fn, *args):
    """Queue ``fn(*args)``, a profiled measurement that fills its phase's
    report in place and prints its line, for :func:`run_deferred`."""
    DEFERRED.append((fn, args))


def run_deferred(t_start):
    """Run the queued measurements in order, each only while the run is
    less than ``PROFILE_DEADLINE_S`` past ``t_start``."""
    while DEFERRED:
        fn, args = DEFERRED.pop(0)
        spent = time.perf_counter() - t_start
        if spent > PROFILE_DEADLINE_S:
            print(f"{fn.__name__} skipped: {spent:.1f} s into the run, past "
                  f"the profiles' {PROFILE_DEADLINE_S:g} s", flush=True)
            continue
        fn(*args)


def stamp(t_start):
    """The run's elapsed seconds, on standard output and on standard error
    (whose end is what a run cut at its time limit shows)."""
    line = f"elapsed {time.perf_counter() - t_start:.1f} s"
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)


def learn_profile(label, agent, out):
    """One learn step of ``agent`` profiled: its idle share against the
    unprofiled ``out["learn_ms"]`` and its device kernels, into ``out``."""
    prof_s, busy, kernels = device_busy_seconds(agent.learn)
    out.update(learn_idle_share=idle_share(label, 1e-3 * out["learn_ms"],
                                           busy, prof_s),
               learn_device_busy_s=busy, learn_profiled_wall_s=prof_s,
               learn_device_kernels=kernels)
    print(f"{label}: {kernels} device kernels and copies", flush=True)


def step_profile(label, env, out):
    """One more step of ``env`` on its hint profiled: the idle share against
    the unprofiled ``out["step_wall_s"]`` and its device kernels, into
    ``out``."""
    prof_s, busy, kernels = device_busy_seconds(lambda: env.step(env.hint))
    out.update(step_wall_profiled_s=prof_s, step_device_busy_s=busy,
               step_kernels=kernels,
               step_idle_share=idle_share(label, out["step_wall_s"], busy,
                                          prof_s))


def n62_profiles(env, out):
    """The N=62 path's third step profiled: its idle share against the
    unprofiled ``out["step_wall_s"]`` and its CUDA kernels per L-BFGS
    iteration of its solve (the step's influence and images counted in),
    into ``out``."""
    iters = LbfgsIters()
    try:
        step_profile("N=62 step", env, out)
    finally:
        iters.restore()
    its = iters.since(0)
    out.update(**its, step_kernels_per_iter=out["step_kernels"]
               / max(its["iters_max"], 1))
    print(f"N=62 step profiled: {out['step_kernels']} kernels and copies "
          f"over {its['iters_max']} L-BFGS iterations (slowest lane; lane "
          f"mean {its['iters_mean']:.1f}) = "
          f"{out['step_kernels_per_iter']:.0f} per iteration, the step's "
          "influence and images counted in", flush=True)


def capture_profile(fn, out, event_ms):
    """:func:`profiler_capture` of the factored kernel, into ``out``."""
    seen, seen_ms = profiler_capture(fn, "separable_partial")
    out.update(kernel="separable_partial_kernel", launches=3, recorded=seen,
               recorded_mean_ms=seen_ms, cuda_event_ms=event_ms)
    print(f"torch.profiler recorded {seen} of 3 launches of the factored "
          f"kernel (mean recorded {seen_ms} ms; CUDA events {event_ms:.3f} "
          "ms per call): the idle shares are upper bounds if it missed any",
          flush=True)


class FirstCall:
    """Stands in for ``module.name`` (a module's function or an object's
    method) and keeps the arguments and the result of its first call;
    every call goes through to the wrapped function (which counts its
    launches itself)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.args = self.result = None
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        first = self.args is None
        if first:
            self.args = (args, kw)
        out = self.fn(*args, **kw)
        if first:
            self.result = out
        return out

    def restore(self):
        setattr(self.module, self.name, self.fn)


def launch_counters(counters, factored_imager):
    """(zero_counts, read_counts) over the kernel modules' ``launches``
    counts, kernel 2's bf16 launches (``factored_imager.launches_bf16``)
    read as ``factored_imager_bf16``.  A kernel that counts its own runs
    on the card (``device_launches``: kernels 4 and 5, whose episode
    programs replay CUDA graphs) is read from that count, its host count
    (the launches made outside a capture) beside it as ``<name>_eager``;
    the card's count may not be below the host's."""
    def zero_counts():
        for m in counters.values():
            m.launches = 0
            if hasattr(m, "device_launches"):
                m.device_launches.reset()
        factored_imager.launches_bf16 = 0

    def read_counts():
        out = {}
        for k, m in counters.items():
            if hasattr(m, "device_launches"):
                out[k] = m.device_launches.read()
                out[k + "_eager"] = m.launches
                if out[k] < m.launches:
                    raise AssertionError(
                        f"{k}: {m.launches} launches from the host but "
                        f"{out[k]} runs counted on the card")
            else:
                out[k] = m.launches
        out["factored_imager_bf16"] = factored_imager.launches_bf16
        return out

    return zero_counts, read_counts


def check_close(name, label, out, ref, rtol, atol_scale, atol_ref):
    """Raise unless |out - ref| <= atol_scale * atol_ref + rtol * |ref|
    everywhere and out is finite; returns the max abs error."""
    err = (out - ref).abs()
    tol = atol_scale * atol_ref + rtol * ref.abs()
    ok = bool(torch.isfinite(out).all()) and bool((err <= tol).all())
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp(min=1e-30)).max())
    print(f"{name} check {label}: shape {tuple(out.shape)} max_abs_err="
          f"{max_abs:.3e} max_rel_err={max_rel:.3e} tol=|d| <= {atol_scale}"
          f"*{atol_ref:.4g} + {rtol}*|ref| -> {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version "
                             f"({label})")
    return max_abs


def check_imager(dft_imager, uv, vis, npix, cell, label, gen=None):
    """Imager kernel vs its plain version, the direct DFT, on the card:
    over the whole image, or over 4096 random pixels of it when ``gen``
    is given; returns the max abs error."""
    out = dft_imager.dirty_image_cuda(uv, vis, npix, cell).reshape(-1)
    lm = dft_imager.pixel_grid(npix, cell, uv.device)
    if gen is not None:
        sub = torch.randperm(lm.shape[0], generator=gen)[:4096].to(uv.device)
        out, lm = out[sub], lm[sub]
        label += " (4096-pixel subset)"
    ref = dft_imager.dirty_image_reference(uv, lm, vis)
    torch.cuda.synchronize()
    return check_close("dft_imager", f"{label} npix={npix} R={uv.shape[0]}",
                       out, ref, IMAGER_RTOL, IMAGER_ATOL,
                       float(vis.abs().mean()))


def scaled_uv(dft_imager, uvw, freq):
    scale = torch.tensor(dft_imager.uv_scale(freq), device=uvw.device)
    return (uvw[:, :2] * scale).contiguous()


# ragged (R, npix) cases that cross the engine's 128-pixel tile and
# 16-sample stage edges
RAGGED = ((1001, 100), (777, 200), (100003, 1000))
# the bf16 kernel's further ragged cases (R, npix): R below one 32-sample
# stage, and R not a multiple of it with npix not a multiple of the tile
BF16_RAGGED = RAGGED + ((5, 100), (5003, 640))

#: nvcc's output of each kernel library this process built ({name: log})
BUILD_LOGS = {}


def ptxas_report(log):
    """{entry function: {"registers", "spill_stores"}} from nvcc's
    ``-Xptxas=-v`` output."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = {"registers": None, "spill_stores": None}
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out[name]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def bf16_registers(log):
    """ptxas's registers and spill stores of the bf16 kernel's first pass
    (namespace separable_bf16) in a factored_imager build log, or None."""
    hits = [v for k, v in ptxas_report(log).items()
            if "separable_bf16" in k and "partial_kernel" in k]
    return hits[0] if hits else None


def random_imager_case(seed, R, dev, freq=150e6):
    g = torch.Generator(device="cpu").manual_seed(seed)
    uvw = (torch.rand((R, 3), generator=g) * 4e3 - 2e3).to(dev)
    vis = torch.randn((R, 2), generator=g).to(dev)
    return uvw, vis, freq


def check_outputs(obs_list, steps, npix, K):
    for o in obs_list:
        if not all(np.all(np.isfinite(v)) for v in o.values()):
            raise AssertionError("non-finite observation")
        if o["img"].shape != (npix, npix) or o["sky"].shape != (K + 1, 7):
            raise AssertionError(f"observation shapes {o['img'].shape} "
                                 f"{o['sky'].shape}")
    for s in steps:
        if not (math.isfinite(s["reward"]) and math.isfinite(s["sigma_res"])):
            raise AssertionError("non-finite reward or sigma_res")
        if not s["sigma_res"] < s["sigma_data"]:
            raise AssertionError("calibration did not reduce the residual")


def run_steps(env, n):
    steps = []
    for _ in range(n):
        t0 = time.perf_counter()
        obs, reward, _done, _hint, info = env.step(env.hint)
        steps.append({"seconds": time.perf_counter() - t0,
                      "reward": float(reward), **info})
    return obs, steps


def held_bytes(dev):
    """Device bytes still allocated, much of it what the queued profiles
    hold (their envs and agents): a path's peak includes it."""
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    return torch.cuda.memory_allocated(dev)


def print_path(label, env, backend, t_reset, steps, peak, launches,
               held=0):
    print(f"{label}: K={env.K} reset {t_reset:.3f} s, steps "
          + ", ".join(f"{s['seconds']:.3f} s" for s in steps), flush=True)
    for s in steps:
        print(f"  reward {s['reward']:.6f} sigma_res {s['sigma_res']:.6f} "
              f"sigma_data {s['sigma_data']:.6f}", flush=True)
    print("  stage seconds (host clock, synchronized): "
          + ", ".join(f"{k} {v:.3f}" for k, v in backend.stage_seconds.items())
          + f"; peak device memory {peak / 2**20:.0f} MiB ({held / 2**20:.0f} "
          "MiB of it held by earlier phases); launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)


def idle_share(label, wall, busy, wall_prof):
    if busy is None:
        print(f"{label} idle share: not measured (the profiler saw no device "
              "activity)", flush=True)
        return None
    share = 1.0 - busy / wall
    print(f"{label} idle share {share:.4f} (busy {busy:.4f} s of {wall:.4f} "
          f"s; profiled wall {wall_prof:.4f} s)", flush=True)
    return share


def tiny_gpu_vs_cpu(CalibEnv, RadioBackend, dev, label, **extra):
    """The same tiny episode on the GPU and on the CPU; raises beyond
    1e-3 (f32 reduction order and trig differ)."""
    outs = []
    for d in (dev, torch.device("cpu")):
        e = CalibEnv(M=3, backend=RadioBackend(device=d, **TINY, **extra),
                     seed=0, provide_hint=True, device=d)
        o = e.reset()
        o2, r, _, _, inf = e.step(e.hint)
        outs.append((o["img"], o2["img"], r, inf["sigma_res"]))
    rel = [float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
           for a, b in zip(outs[0][:2], outs[1][:2])]
    rel_r = abs(outs[0][2] - outs[1][2]) / abs(outs[1][2])
    rel_s = abs(outs[0][3] - outs[1][3]) / abs(outs[1][3])
    print(f"tiny episode {label} GPU vs CPU: img rel {rel[0]:.2e}/"
          f"{rel[1]:.2e}, reward rel {rel_r:.2e}, sigma_res rel {rel_s:.2e} "
          "(tolerance 1e-3: f32 reduction order and trig differ)", flush=True)
    if max(rel + [rel_r, rel_s]) > 1e-3:
        raise AssertionError(f"tiny episode {label}: GPU and CPU disagree")
    return rel + [rel_r, rel_s]


# -- the oracle chain: RadioBackend(vectorized=False), the host-loop route -

# tests/test_calib_pipeline.py: the host loop's influence image against the
# optimized routes (relative norm), and its episode build's V against the
# vectorized build's (Ccal: the same bits)
HOST_LOOP_IMG_REL = 5e-3
HOST_LOOP_V_REL = 1e-5


def rel_norm(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()).clamp(min=1e-300))


def oracle_checks(dev, env, backend, res, rho, alpha, zero_counts,
                  read_counts, n_sm):
    """The host-loop route's influence map (the oracle chain band by band,
    each band imaged by kernel 1) on the N=62 phase's own episode and
    solve: finite, within HOST_LOOP_IMG_REL of the optimized route's image
    on the same operands, the same bits over two calls, kernel 1 launched
    Nf times (counted from zero just before the first call) and held
    against its plain version at the first band's influence operands; and
    the host-loop episode build of one key against the vectorized one."""
    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.ops import dft_imager

    t_checks = time.perf_counter()
    oracle = RadioBackend(device=dev, vectorized=False, **N62)
    ep = env.ep
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    spy = FirstCall(dft_imager, "dirty_image_cuda")
    zero_counts()
    t0 = time.perf_counter()
    try:
        img = oracle.influence_image(ep, res, rho, alpha)
        torch.cuda.synchronize(dev)
        first_s = time.perf_counter() - t0
        launches = read_counts()
    finally:
        spy.restore()
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    again = oracle.influence_image(ep, res, rho, alpha)
    torch.cuda.synchronize(dev)
    again_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    opt = backend.influence_image(ep, res, rho, alpha)
    torch.cuda.synchronize(dev)
    opt_s = time.perf_counter() - t0
    img_rel = rel_norm(img, opt)
    print(f"oracle influence at N=62: first call {first_s:.3f} s, again "
          f"{again_s:.3f} s, optimized route {opt_s:.3f} s on the same "
          f"operands; image vs optimized {img_rel:.3e} (bound "
          f"{HOST_LOOP_IMG_REL}); same bits over two calls "
          f"{torch.equal(img, again)}; peak {peak / 2**20:.0f} MiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    if not bool(torch.isfinite(img).all()) or img.shape != opt.shape:
        raise AssertionError("the oracle influence image is not finite")
    if not torch.equal(img, again):
        raise AssertionError("two oracle influence calls differ")
    if not img_rel <= HOST_LOOP_IMG_REL:
        raise AssertionError(f"oracle vs optimized influence image "
                             f"{img_rel:.3e} > {HOST_LOOP_IMG_REL}")
    if launches["dft_imager"] != N62["n_freqs"]:
        raise AssertionError(f"dft_imager launched {launches['dft_imager']} "
                             f"times on the oracle path, expected "
                             f"{N62['n_freqs']}")

    (uv, vis, npix, cell), _ = spy.args
    err = check_imager(dft_imager, uv, vis, npix, cell,
                       "oracle influence (band 0)")
    lm = dft_imager.pixel_grid(npix, cell, dev)
    ms = cuda_ms(lambda: dft_imager.dirty_image_cuda(uv, vis, npix, cell), 20)
    plain_ms = cuda_ms(
        lambda: dft_imager.dirty_image_reference(uv, lm, vis), 5)
    bounds = separable_bounds(npix, uv.shape[0], n_sm)
    print(f"dft_imager at the oracle's influence operands P={npix * npix} "
          f"R={uv.shape[0]}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {bounds['bound_ms']:.4f} ms ({bounds['bound_by']})",
          flush=True)

    key = prng.PRNGKey(5)
    t0 = time.perf_counter()
    ep_v, _ = backend.new_calib_episode(key, env.K, env.M)
    torch.cuda.synchronize(dev)
    build_v = time.perf_counter() - t0
    t0 = time.perf_counter()
    ep_l, _ = oracle.new_calib_episode(key, env.K, env.M)
    torch.cuda.synchronize(dev)
    build_l = time.perf_counter() - t0
    ccal_same = torch.equal(ep_l.Ccal, ep_v.Ccal)
    v_rel = rel_norm(ep_l.V, ep_v.V)
    print(f"host-loop episode build at N=62 (K={env.K}): {build_l:.3f} s "
          f"against {build_v:.3f} s vectorized; Ccal same bits {ccal_same}, "
          f"V {v_rel:.3e} (bound {HOST_LOOP_V_REL})", flush=True)
    if not ccal_same or not v_rel <= HOST_LOOP_V_REL:
        raise AssertionError("the host-loop episode build parts from the "
                             "vectorized one")
    print(f"oracle checks {time.perf_counter() - t_checks:.2f} s",
          flush=True)
    return {"influence_first_s": first_s, "influence_again_s": again_s,
            "optimized_influence_s": opt_s, "img_rel_vs_optimized": img_rel,
            "same_bits": True, "peak_mem_bytes": peak, "launches": launches,
            "kernel": {"shapes": f"P={npix * npix} R={uv.shape[0]}",
                       "ms": ms, "plain_ms": plain_ms, "max_abs_err": err,
                       **{k: v for k, v in bounds.items()
                          if k != "bound_bf16_ms"}},
            "episode_build_s": {"host_loop": build_l, "vectorized": build_v},
            "episode_v_rel": v_rel,
            "checks_seconds": time.perf_counter() - t_checks}


def oracle_phase(dev, out_dir, zero_counts, read_counts, n_sm):
    """``--oracle``: CalibEnv(M=10) at N=62, reset + 1 step with the hint,
    after one unrecorded reset of each route, on the vectorized backend
    and then on the host-loop backend (the
    oracle chain, kernel 1 imaging each band's influence) from the same
    seed: stage seconds, peak memory and kernel 1's launches of each
    (counted from zero just before each reset); between them
    :func:`oracle_checks` on the vectorized step's episode and one more
    solve of it."""
    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend

    t_start = time.perf_counter()
    # one unrecorded reset of each route first: the process's first solve,
    # influence and noise draw pay one-time set-up that would be charged to
    # whichever route ran first
    for vectorized in (True, False):
        CalibEnv(M=10, backend=RadioBackend(device=dev, vectorized=vectorized,
                                            **N62),
                 seed=1, device=dev).reset()
    out = {}
    for name, vectorized in (("vectorized", True), ("host_loop", False)):
        backend = RadioBackend(device=dev, vectorized=vectorized, **N62)
        env = CalibEnv(M=10, backend=backend, seed=0, provide_hint=True,
                       device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        obs0 = env.reset()
        t_reset = time.perf_counter() - t0
        obs, steps = run_steps(env, 1)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        print_path(f"N=62 {name} route", env, backend, t_reset, steps, peak,
                   launches)
        check_outputs((obs0, obs), steps, N62["npix"], env.M)
        out[name] = dict(reset_seconds=t_reset, steps=steps, K=env.K,
                         stage_seconds=dict(backend.stage_seconds),
                         peak_mem_bytes=peak, launches=launches)
        if vectorized:
            mask = np.zeros(env.M, np.float32)
            mask[:env.K] = 1.0
            rho = np.ones(env.M, np.float32)
            rho[:env.K] = env.rho_spectral[:env.K]
            alpha = np.zeros(env.M, np.float32)
            alpha[:env.K] = env.rho_spatial[:env.K]
            res = backend.calibrate(env.ep, rho, mask=mask)
            out["checks"] = oracle_checks(dev, env, backend, res, rho, alpha,
                                          zero_counts, read_counts, n_sm)
            del res
        del env, backend
    extra = (out["host_loop"]["launches"]["dft_imager"]
             - out["vectorized"]["launches"]["dft_imager"])
    if extra != 2 * N62["n_freqs"]:
        raise AssertionError(f"the host loop launched dft_imager {extra} "
                             f"more times than the vectorized route, "
                             f"expected {2 * N62['n_freqs']} (Nf per "
                             "influence map, reset and step)")
    ratios = {k: out["host_loop"]["stage_seconds"][k]
              / out["vectorized"]["stage_seconds"][k]
              for k in ("simulate", "influence")}
    print("host loop / vectorized stage seconds: "
          + ", ".join(f"{k} {v:.2f}x" for k, v in ratios.items()),
          flush=True)
    out["stage_ratio"] = ratios
    out["total_seconds"] = time.perf_counter() - t_start
    return out


# -- the train path: train/calib_sac.py on the N=62 backend ----------------

TRAIN_EPISODES = 1      # the runtime phase runs 2 under --metrics --diag
TRAIN_ARGS = ["--stations", "62", "--episodes", str(TRAIN_EPISODES),
              "--steps", "1", "--use_hint", "--seed", "0", "--quiet"]
TRAIN_RTOL, TRAIN_ATOL = 1e-4, 1e-5     # tests/test_torch_sac.py


class StepTimer:
    """Stands in for ``CalibEnv.step`` and keeps the host seconds of each
    call (the step ends in a device sync: its images come to the host) and
    the env it stepped."""

    def __init__(self, env_cls):
        self.env_cls, self.step = env_cls, env_cls.step
        self.seconds = []
        self.env = None
        timer = self

        def timed(env, action):
            timer.env = env
            t0 = time.perf_counter()
            try:
                return timer.step(env, action)
            finally:
                timer.seconds.append(time.perf_counter() - t0)

        env_cls.step = timed

    def restore(self):
        self.env_cls.step = self.step


def state_diff(a, b):
    """(max abs difference, max of |a - b| / (TRAIN_ATOL + TRAIN_RTOL |b|))
    over two agents' ``to_host`` payloads; raises unless that ratio is at
    most 1 everywhere and every count is equal."""
    worst = [0.0, 0.0]
    for k, va in a.items():
        vb = b[k]
        if isinstance(va, dict):
            worst = [max(x, y) for x, y in zip(worst, state_diff(va, vb))]
        elif isinstance(va, int):
            if va != vb:
                raise AssertionError(f"{k}: {va} against {vb}")
        else:
            err = np.abs(np.asarray(va, np.float64) - vb)
            ratio = float((err / (TRAIN_ATOL + TRAIN_RTOL * np.abs(
                np.asarray(vb, np.float64)))).max())
            if not ratio <= 1.0:
                raise AssertionError(f"{k}: GPU and CPU learn steps "
                                     f"disagree ({ratio:.3g} x tolerance)")
            worst = [max(worst[0], float(err.max())), max(worst[1], ratio)]
    return worst


def learn_gpu_vs_cpu(sac, cfg, state, buf, dev, n_steps=3):
    """``n_steps`` learn steps from ``state`` on the card and from its copy
    on the CPU, with the same batch indices (drawn on the CPU from the ring's
    filled slots) and the same noise; raises beyond TRAIN_RTOL / TRAIN_ATOL
    on the losses, alpha, rho and every parameter and Adam moment.  Returns
    the max abs errors."""
    gpu, cpu = state.copy_to(dev), state.copy_to("cpu")
    g = torch.Generator().manual_seed(7)
    B = cfg.batch_size
    err = {"metrics": 0.0}
    for _ in range(n_steps):
        idx = torch.randperm(buf.filled, generator=g)[:B]
        noise = tuple(torch.randn((B, cfg.n_actions), generator=g)
                      for _ in range(3))
        batch = {k: v[idx.to(dev)] for k, v in buf.data.items()}
        m_gpu = sac.learn_from_batch(cfg, gpu, batch, torch.ones(B,
                                                                 device=dev),
                                     tuple(n.to(dev) for n in noise))
        m_cpu = sac.learn_from_batch(
            cfg, cpu, {k: v.cpu() for k, v in batch.items()}, torch.ones(B),
            noise)
        for k in ("critic_loss", "actor_loss", "alpha", "rho"):
            a, b = float(m_gpu[k]), float(m_cpu[k])
            if not abs(a - b) <= TRAIN_ATOL + TRAIN_RTOL * abs(b):
                raise AssertionError(f"learn step GPU vs CPU: {k} {a} "
                                     f"against {b}")
            err["metrics"] = max(err["metrics"], abs(a - b))
    err["state"], err["state_over_tolerance"] = state_diff(gpu.to_host(),
                                                           cpu.to_host())
    print(f"learn GPU vs CPU ({n_steps} steps, batch {B}): max abs err "
          f"losses/alpha/rho {err['metrics']:.3e}, parameters and Adam "
          f"moments {err['state']:.3e}, at most "
          f"{err['state_over_tolerance']:.3f} of the tolerance (rtol "
          f"{TRAIN_RTOL} / atol {TRAIN_ATOL}) -> ok", flush=True)
    return err


def train_path(dev, out_dir, zero_counts, read_counts):
    """Drive train/calib_sac.py on the card (1 episode of 1 step at the
    N=62 backend: 1 transition, fewer than a batch of 32, so no learn),
    with the kernel counts zeroed just before and read just after; check
    the scores and the saved ring.  The agent's learn step is measured on
    the batched trainer's agent (:func:`batched_train_phase`).  Returns
    the report section."""
    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.train import calib_sac
    prefix = os.path.join(out_dir, "calib_sac_")
    os.makedirs(out_dir, exist_ok=True)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    timer = StepTimer(CalibEnv)
    zero_counts()
    t0 = time.perf_counter()
    try:
        scores = calib_sac.main(TRAIN_ARGS + ["--prefix", prefix])
    finally:
        timer.restore()
    train_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n_episodes, n_steps = TRAIN_EPISODES, len(timer.seconds)
    if len(scores) != n_episodes or not np.all(np.isfinite(scores)):
        raise AssertionError(f"train path scores {scores}")
    if launches["dft_imager"] < 3 * (n_episodes + n_steps):
        raise AssertionError(f"dft_imager launched {launches['dft_imager']} "
                             f"times on the train path, expected >= "
                             f"{3 * (n_episodes + n_steps)}")
    learn_counter, ring_cntr = saved_counters(prefix)
    for name in ("sac_state.pkl", "replaymem_sac.pkl"):   # ~100 MB, read
        os.remove(prefix + name)
    if learn_counter != 0 or ring_cntr != n_steps:
        raise AssertionError(f"train path saved learn_counter "
                             f"{learn_counter}, ring cntr {ring_cntr}; "
                             f"expected 0 and {n_steps}")
    out = {"args": TRAIN_ARGS, "scores": [float(x) for x in scores],
           "train_seconds": train_s, "seconds_per_episode": train_s
           / n_episodes, "env_steps": n_steps,
           "env_step_seconds_mean": float(np.mean(timer.seconds)),
           "env_step_seconds": timer.seconds, "peak_mem_bytes": peak,
           "stage_seconds": dict(timer.env.backend.stage_seconds),
           "launches": launches, "learn_counter": learn_counter,
           "ring_cntr": ring_cntr, "phase_seconds": time.perf_counter() - t0}
    print(f"train path (calib_sac {' '.join(TRAIN_ARGS)}): {train_s:.3f} s, "
          f"{out['seconds_per_episode']:.3f} s per episode, env step mean "
          f"{out['env_step_seconds_mean']:.3f} s over {n_steps}; scores "
          + ", ".join(f"{x:.4f}" for x in scores)
          + "; stage seconds (host clock, synchronized) "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["stage_seconds"].items())
          + f"; learn_counter 0, ring cntr {ring_cntr}; peak device memory "
          f"{peak / 2**20:.0f} MiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    return out


def saved_counters(prefix):
    """(learn_counter, ring cntr) of a trainer's saved agent and ring."""
    import pickle
    with open(prefix + "sac_state.pkl", "rb") as fh:
        learn_counter = pickle.load(fh)["learn_counter"]
    with open(prefix + "replaymem_sac.pkl", "rb") as fh:
        ring_cntr = pickle.load(fh)["cntr"]
    return learn_counter, ring_cntr


def agent_checks(dev, prefix, out, learn_counter, ring_cntr):
    """Load a calibration SAC trainer's saved agent (M=10, 128² image,
    batch 32), check its counters, time save_models, learn,
    choose_action and store_transition (CUDA events), queue a learn step's
    idle share, and hold 3 learn steps on the card against the CPU from
    that state (it has Adam history); all into ``out``.  Deletes the
    ~100 MB pickles."""
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.train import calib_sac
    cfg = calib_sac.agent_config(128, 10, use_hint=True)
    agent = sac.SACAgent(cfg, seed=0, name_prefix=prefix, device=dev)
    if not agent.load_models():
        raise AssertionError("the trainer saved no agent")
    if (agent.state.learn_counter != learn_counter
            or agent.buffer.cntr != ring_cntr):
        raise AssertionError(f"saved agent: learn_counter "
                             f"{agent.state.learn_counter}, ring cntr "
                             f"{agent.buffer.cntr}; expected {learn_counter} "
                             f"and {ring_cntr}")
    t1 = time.perf_counter()
    agent.save_models()             # as train/calib_sac.py does per episode
    save_s = time.perf_counter() - t1
    for name in ("sac_state.pkl", "replaymem_sac.pkl"):   # ~100 MB, read
        os.remove(prefix + name)
    t1 = time.perf_counter()
    gpu_cpu = learn_gpu_vs_cpu(sac, cfg, agent.state, agent.buffer, dev)
    gpu_cpu_s = time.perf_counter() - t1

    flat = agent.buffer.data["state"][0].cpu().numpy()
    hint = agent.buffer.data["hint"][0].cpu().numpy()
    action = agent.choose_action(flat)
    times = {
        "learn_ms": cuda_ms(agent.learn, 20, warmup=3),
        "choose_action_ms": cuda_ms(lambda: agent.choose_action(flat), 20,
                                    warmup=3),
        "store_transition_ms": cuda_ms(lambda: agent.store_transition(
            flat, action, 1.0, flat, False, hint), 20, warmup=3)}
    print(f"  agent (learn_counter {learn_counter}, ring cntr {ring_cntr}): "
          f"save_models {save_s:.3f} s; learn {times['learn_ms']:.3f} ms, "
          f"choose_action {times['choose_action_ms']:.3f} ms, "
          f"store_transition {times['store_transition_ms']:.3f} ms (CUDA "
          "events, median of 20 after 3 warm-ups); GPU vs CPU check "
          f"{gpu_cpu_s:.3f} s", flush=True)
    out.update(save_models_seconds=save_s, **times,
               gpu_vs_cpu_max_abs_err=gpu_cpu, gpu_vs_cpu_seconds=gpu_cpu_s)
    defer(learn_profile, "learn step", agent, out)


# -- the elastic-net slice and the calibration TD3/DDPG trainers ----------

# 6 transitions, fewer than a batch of 64: the learn checks top the ring
# up with random transitions and warm the agent up with 5 learns
ENET_SAC_EPISODES, ENET_SAC_STEPS = 2, 3
ENET_EVAL_STEPS = 2
ENET_WARMUP_LEARNS = 5
ENET_SHORT = ["--episodes", "1", "--steps", "2", "--seed", "0", "--quiet"]
CALIB_TD3_ARGS = ["--stations", "62", "--episodes", "1", "--steps", "1",
                  "--use_hint", "--seed", "0", "--quiet"]
CALIB_DDPG_ARGS = ["--stations", "62", "--episodes", "1", "--steps", "1",
                   "--seed", "0", "--quiet"]
ENET_ITER_RTOL, ENET_ITER_ATOL = 1e-4, 1e-6   # tests/test_torch_enet.py


class Timed:
    """Stands in for ``module.name``: every call runs between two device
    syncs, and its host seconds and result are kept."""

    def __init__(self, module, name, dev):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls = []
        timer = self

        def timed(*args, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = timer.fn(*args, **kw)
            torch.cuda.synchronize(dev)
            timer.calls.append((time.perf_counter() - t0, out))
            return out

        setattr(module, name, timed)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def _to(tree, dev):
    """A NamedTuple of tensors (or of such NamedTuples) on ``dev``."""
    return type(tree)(*(_to(v, dev) if isinstance(v, tuple) else v.to(dev)
                        for v in tree))


def _hold(name, got, want, rtol, atol):
    err = float((got.cpu() - want.cpu()).abs().max())
    ok = bool(torch.allclose(got.cpu(), want.cpu(), rtol=rtol, atol=atol))
    print(f"enet GPU vs CPU {name}: max abs err {err:.3e} (rtol {rtol} / "
          f"atol {atol}) -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"enet GPU vs CPU: {name} disagrees")
    return err


def enet_gpu_vs_cpu(enet, cfg, st, action, noise):
    """The enet step and hint on the card against the CPU, stage by stage
    on the same inputs: the solve's first 5 iterations, the influence
    state on the CPU's solution and curvature pairs, the step around the
    CPU's solve, and the hint's 50 MSEs on the CPU's 50 solutions.  End to
    end the devices part as the two packages do (float32 round-off in the
    L-BFGS trajectories, ROADMAP queue 3): those differences are printed,
    not held.  Returns the report."""
    cpu = _to(st, "cpu")
    rho, _ = enet.action_to_rho(action.cpu())
    out = {}
    short = dataclasses.replace(cfg, lbfgs_iters=5)
    a = enet._solve(short, cpu.A, cpu.y, rho)
    b = enet._solve(short, st.A, st.y, rho.to(st.A.device))
    out["solve_5_iters"] = _hold("solve x after 5 iterations", b.x, a.x,
                                 ENET_ITER_RTOL, ENET_ITER_ATOL)
    if int(a.n_iters[0]) != int(b.n_iters[0]):
        raise AssertionError("enet GPU vs CPU: iteration counts differ")
    res = enet._solve(cfg, cpu.A, cpu.y, rho)
    dres = _to(res, st.A.device)
    out["influence"] = _hold(
        "influence state on one solve",
        enet._influence(cfg, st.A, st.y, rho.to(st.A.device), dres),
        enet._influence(cfg, cpu.A, cpu.y, rho, res), 1e-4, 1e-5)
    mses, hres = enet.hint_solve(cfg, cpu)
    out["hint_mses"] = _hold("hint MSEs on 50 solutions",
                             enet.hint_mses(cfg, st, hres.x.to(
                                 st.A.device)), mses, 1e-5, 0.0)
    # end to end, printed
    g_st, g_obs, g_r, _ = enet.step(cfg, st, action, noise)
    c_st, c_obs, c_r, _ = enet.step(cfg, cpu, action.cpu(), noise.cpu())
    g_mses, _ = enet.hint_solve(cfg, g_st)
    c_mses, _ = enet.hint_solve(cfg, c_st)
    out["end_to_end"] = {
        "x_max_abs": float((g_st.x.cpu() - c_st.x).abs().max()),
        "obs_max_abs": float((g_obs.cpu() - c_obs).abs().max()),
        "reward_rel": abs(float(g_r) / float(c_r) - 1.0),
        "hint_mse_max_rel": float(((g_mses.cpu() - c_mses).abs()
                                   / c_mses.abs()).max())}
    print("enet GPU vs CPU end to end (not held: round-off parts the "
          "L-BFGS trajectories, ROADMAP queue 3): " + ", ".join(
              f"{k} {v:.3e}" for k, v in out["end_to_end"].items()),
          flush=True)
    return out


def enet_step_phase(dev):
    """One EnetEnv (M = N = 20) reset, three steps and one hint on the
    card, each timed and broken down (solve, influence state, hint),
    L-BFGS iterations per solve, CUDA kernels per iteration and per step
    (torch.profiler), a step's idle share, and the GPU-vs-CPU stages."""
    from smartcal_tpu_torch.envs import enet
    env = enet.EnetEnv(seed=0, device=dev)
    cfg = env.cfg
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    # the lane functions the one-env step and hint run at E = 1
    timers = {n: Timed(enet, n, dev) for n in ("_solve_lanes",
                                                "_influence_lanes",
                                                "hint_solve_lanes")}
    rng = np.random.default_rng(0)
    steps = []
    try:
        t0 = time.perf_counter()
        env.reset()
        t_reset = time.perf_counter() - t0
        for i in range(3):
            action = rng.uniform(-1, 1, 2).astype(np.float32)
            t0 = time.perf_counter()
            _, reward, _, _ = env.step(action)
            steps.append({"seconds": time.perf_counter() - t0,
                          "reward": reward})
            if i == 0:
                t0 = time.perf_counter()
                hint = env.get_hint()
                t_hint = time.perf_counter() - t0
    finally:
        for tm in timers.values():
            tm.restore()
    for s, (sec, res), (isec, _) in zip(steps, timers["_solve_lanes"].calls,
                                        timers["_influence_lanes"].calls):
        s.update(solve_seconds=sec, influence_seconds=isec,
                 iters=int(res.n_iters[0]))
    hsec, (_, hres) = timers["hint_solve_lanes"].calls[0]
    h_iters = hres.n_iters.cpu().numpy()
    if not (np.all(np.isfinite([s["reward"] for s in steps]))
            and np.all(np.isfinite(hint))):
        raise AssertionError("enet step: non-finite reward or hint")

    # a step's wall here; its idle share and the kernels per iteration
    # (one solve) and per step are queued (:func:`enet_profiles`)
    st = env.state
    action = torch.tensor([0.3, -0.5], device=dev)
    noise = torch.randn(cfg.N, generator=env.generator, device=dev)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    enet.step(cfg, st, action, noise)
    torch.cuda.synchronize(dev)
    step_wall = time.perf_counter() - t0
    out = {"reset_seconds": t_reset, "steps": steps,
           "hint_seconds": t_hint, "hint_solve_seconds": hsec,
           "hint_iters_max": int(h_iters.max()),
           "hint_iters_mean": float(h_iters.mean()),
           "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    print(f"enet step (M=N=20): reset {t_reset:.3f} s; steps "
          + "; ".join(f"{s['seconds']:.3f} s (solve {s['solve_seconds']:.3f}"
                      f" s, {s['iters']} iterations; influence/eig "
                      f"{s['influence_seconds']:.4f} s)" for s in steps)
          + f"; hint {t_hint:.3f} s (its solve {hsec:.3f} s, lanes' "
          f"iterations max {int(h_iters.max())} mean {h_iters.mean():.1f})"
          f"; peak device memory {out['peak_mem_bytes'] / 2**20:.0f} MiB",
          flush=True)
    out["gpu_vs_cpu"] = enet_gpu_vs_cpu(enet, cfg, st, action, noise)
    defer(enet_profiles, cfg, st, action, noise, step_wall, out)
    return out


def enet_profiles(cfg, st, action, noise, step_wall, out):
    """The enet solve profiled (its CUDA kernels: kernel 4 and the
    wrapper's few), and a step's idle share against its unprofiled
    ``step_wall``; into ``out``."""
    from smartcal_tpu_torch.envs import enet
    rho, _ = enet.action_to_rho(action)
    solved = []
    s_wall, s_busy, s_kernels = device_busy_seconds(
        lambda: solved.append(enet._solve(cfg, st.A, st.y, rho)))
    s_iters = int(solved[0].n_iters[0])
    step_prof, step_busy, step_kernels = device_busy_seconds(
        lambda: enet.step(cfg, st, action, noise))
    out["profiled_solve"] = {
        "iters": s_iters, "wall_s": s_wall, "busy_s": s_busy,
        "kernels": s_kernels}
    out["profiled_step"] = {"wall_s": step_wall, "profiled_wall_s": step_prof,
                            "busy_s": step_busy, "kernels": step_kernels}
    out["step_idle_share"] = idle_share("enet step", step_wall, step_busy,
                                        step_prof)
    print(f"enet solve profiled: {s_kernels} kernels and copies for "
          f"{s_iters} iterations (kernel 4: the whole loop in one launch); "
          f"one step: {step_kernels} kernels and copies", flush=True)


def enet_sac_phase(dev, out_dir, zero_counts, read_counts):
    """Drive train/enet_sac.py on the card (ENET_SAC_EPISODES x
    ENET_SAC_STEPS steps with the hint), counts zeroed just before and read
    just after; check what it saved; run enet_eval for one game of
    ENET_EVAL_STEPS steps on the saved agent; top its
    ring up with random transitions to a batch, learn ENET_WARMUP_LEARNS
    times, then time learn / choose_action / store_transition with CUDA
    events, take a learn step's idle share, and hold 3 learn steps on the
    card against the CPU."""
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.runtime.atomic import strict_pickle_load
    from smartcal_tpu_torch.train import enet_eval, enet_sac
    prefix = os.path.join(out_dir, "enet_sac_")
    args = ["--episodes", str(ENET_SAC_EPISODES), "--steps",
            str(ENET_SAC_STEPS), "--use_hint", "--seed", "0", "--quiet",
            "--prefix", prefix]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    summary = enet_sac.main(args)
    train_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    n = ENET_SAC_EPISODES * ENET_SAC_STEPS
    scores = strict_pickle_load(prefix + "scores.pkl")
    cfg = enet_sac.agent_config(enet.EnetConfig(), use_hint=True)
    agent = sac.SACAgent(cfg, seed=0, name_prefix=prefix, device=dev)
    if not agent.load_models():
        raise AssertionError("enet_sac saved no agent")
    want_learns = max(n - cfg.batch_size + 1, 0)
    if (len(scores) != ENET_SAC_EPISODES or not np.all(np.isfinite(scores))
            or agent.buffer.cntr != n
            or agent.state.learn_counter != want_learns):
        raise AssertionError(f"enet_sac: scores {scores}, ring cntr "
                             f"{agent.buffer.cntr}, learn_counter "
                             f"{agent.state.learn_counter}")
    t1 = time.perf_counter()
    rows = enet_eval.main(["--agent", prefix + "sac_state.pkl", "--games",
                           "1", "--steps", str(ENET_EVAL_STEPS), "--seed",
                           "0"])
    eval_s = time.perf_counter() - t1
    if not (np.isfinite(rows[0]["rl_rel_err"])
            and np.isfinite(rows[0]["grid_rel_err"])):
        raise AssertionError(f"enet_eval: {rows}")
    for name in ("sac_state.pkl", "replaymem_sac.pkl"):       # read
        os.remove(prefix + name)
    rng = np.random.default_rng(0)
    while agent.buffer.cntr < cfg.batch_size + ENET_WARMUP_LEARNS - 1:
        agent.store_transition(
            1e-2 * rng.standard_normal(cfg.obs_dim).astype(np.float32),
            rng.uniform(-1, 1, cfg.n_actions).astype(np.float32),
            float(rng.uniform(0, 3)),
            1e-2 * rng.standard_normal(cfg.obs_dim).astype(np.float32),
            False, rng.uniform(-1, 1, cfg.n_actions).astype(np.float32))
    for _ in range(ENET_WARMUP_LEARNS):      # Adam history for the checks
        agent.learn()
    gpu_cpu = learn_gpu_vs_cpu(sac, cfg, agent.state, agent.buffer, dev)
    flat = agent.buffer.data["state"][0].cpu().numpy()
    hint = agent.buffer.data["hint"][0].cpu().numpy()
    action = agent.choose_action(flat)
    times = {
        "learn_ms": cuda_ms(agent.learn, 20, warmup=3),
        "choose_action_ms": cuda_ms(lambda: agent.choose_action(flat), 20,
                                    warmup=3),
        "store_transition_ms": cuda_ms(lambda: agent.store_transition(
            flat, action, 1.0, flat, False, hint), 20, warmup=3)}
    out = {"args": args, "summary": summary, "scores": list(scores),
           "train_seconds": train_s, "launches": launches,
           "peak_mem_bytes": peak, "ring_cntr": n,
           "learn_counter": want_learns, "eval": rows,
           "eval_seconds": eval_s, **times,
           "gpu_vs_cpu_max_abs_err": gpu_cpu}
    defer(learn_profile, "enet learn step", agent, out)
    print(f"enet_sac ({' '.join(args[:-2])}): {train_s:.3f} s, "
          f"env_steps_per_sec {summary['env_steps_per_sec']} (the trainer's "
          f"JSON), final_avg_score {summary['final_avg_score']:.4f}; ring "
          f"cntr {n}, learn_counter {want_learns}; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; peak device memory {peak / 2**20:.0f} MiB; enet_eval 1 "
          f"game {eval_s:.3f} s (RL rel err {rows[0]['rl_rel_err']:.4f}, "
          f"grid {rows[0]['grid_rel_err']:.4f}); learn "
          f"{times['learn_ms']:.3f} ms, choose_action "
          f"{times['choose_action_ms']:.3f} ms, store_transition "
          f"{times['store_transition_ms']:.3f} ms (CUDA events, median of "
          "20 after 3 warm-ups)", flush=True)
    del agent
    return out


def _random_ring(rp, cfg, n, dev, priority, seed=0):
    """A ring of ``n`` random full-width transitions of ``cfg``'s shape."""
    rng = np.random.default_rng(seed)
    buf = rp.replay_init(cfg.mem_size, rp.transition_spec(
        cfg.obs_dim, cfg.n_actions), dev)
    for _ in range(n):
        r = float(rng.uniform(0, 3))
        rp.replay_add(buf, {
            "state": 1e-2 * rng.standard_normal(cfg.obs_dim).astype(
                np.float32),
            "new_state": 1e-2 * rng.standard_normal(cfg.obs_dim).astype(
                np.float32),
            "action": rng.uniform(-1, 1, cfg.n_actions).astype(np.float32),
            "reward": r, "done": False,
            "hint": rng.uniform(-1, 1, cfg.n_actions).astype(np.float32)},
            priority=priority(r))
    return buf


def learns_gpu_vs_cpu(name, state, buf, dev, learn_step, n_steps, seed=7):
    """``n_steps`` of ``learn_step(state, batch, draws)`` from ``state`` on
    the card and from its copy on the CPU, with the same batch indices
    (drawn on the CPU from the ring's filled slots) and draws; raises
    beyond TRAIN_RTOL / TRAIN_ATOL on any parameter, target, Adam moment
    or counter.  Returns the max abs error and its share of the
    tolerance."""
    gpu, cpu = state.copy_to(dev), state.copy_to("cpu")
    g = torch.Generator().manual_seed(seed)
    for _ in range(n_steps):
        idx = torch.randperm(buf.filled, generator=g)[:64]
        draws = torch.rand(64, generator=g), torch.randn((), generator=g)
        batch = {k: v[idx.to(dev)] for k, v in buf.data.items()}
        learn_step(gpu, batch, tuple(d.to(dev) for d in draws))
        learn_step(cpu, {k: v.cpu() for k, v in batch.items()}, draws)
    err = state_diff(gpu.to_host(), cpu.to_host())
    print(f"{name} GPU vs CPU ({n_steps} learn steps): parameters, targets "
          f"and Adam moments max abs err {err[0]:.3e}, at most {err[1]:.3f} "
          f"of the tolerance (rtol {TRAIN_RTOL} / atol {TRAIN_ATOL}) -> ok",
          flush=True)
    return err


def enet_td3_ddpg_phase(dev, out_dir, zero_counts, read_counts):
    """Drive train/enet_td3.py and train/enet_ddpg.py for 1 short episode
    each (counts zeroed and read around each); then 3 full-width learn
    steps of each agent (TD3 with PER and the hint: the second is the
    delayed ADMM actor step) on the card against the CPU, from a 96-slot
    ring and a state with Adam history; times one learn of each."""
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.rl import ddpg, td3
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.train import enet_ddpg, enet_td3
    out = {}
    for name, main in (("enet_td3", enet_td3.main),
                       ("enet_ddpg", enet_ddpg.main)):
        zero_counts()
        t0 = time.perf_counter()
        summary = main(ENET_SHORT + ["--prefix",
                                     os.path.join(out_dir, name + "_")])
        out[name] = {"summary": summary, "launches": read_counts(),
                     "seconds": time.perf_counter() - t0}
        for f in ("td3_state.pkl", "replaymem_td3.pkl"):  # tens of MB
            path = os.path.join(out_dir, f"{name}_{f}")
            if os.path.exists(path):
                os.remove(path)
        if not np.isfinite(summary["final_avg_score"]):
            raise AssertionError(f"{name}: {summary}")
        print(f"{name} ({' '.join(ENET_SHORT)}): "
              f"{out[name]['seconds']:.3f} s, env_steps_per_sec "
              f"{summary['env_steps_per_sec']}", flush=True)
    env_cfg = enet.EnetConfig()

    tcfg = enet_td3.agent_config(env_cfg)
    buf = _random_ring(rp, tcfg, 96, dev,
                       lambda r: td3.store_priority(tcfg, r))
    st = td3.td3_init(tcfg, torch.Generator(dev).manual_seed(0), dev)
    gen = torch.Generator(dev).manual_seed(1)
    for _ in range(4):                       # Adam history, actor included
        td3.learn(tcfg, st, buf, gen)
    st.learn_counter = 0

    def td3_step(s, batch, draws):
        td3.learn_from_batch(tcfg, s, batch, 0.5 + 0.5 * draws[0], draws[1])

    out["td3_gpu_vs_cpu"] = learns_gpu_vs_cpu("enet TD3 (PER, hint ADMM)",
                                              st, buf, dev, td3_step, 3)
    out["td3_learn_ms"] = cuda_ms(lambda: td3.learn(tcfg, st, buf, gen), 20,
                                  warmup=3)

    dcfg = enet_ddpg.agent_config(env_cfg)
    dbuf = _random_ring(rp, dcfg, 96, dev, lambda r: 1.0)
    dst = ddpg.ddpg_init(dcfg, torch.Generator(dev).manual_seed(0), dev)
    for _ in range(4):
        ddpg.learn(dcfg, dst, dbuf, gen)

    def ddpg_step(s, batch, draws):
        ddpg.learn_from_batch(dcfg, s, batch)

    out["ddpg_gpu_vs_cpu"] = learns_gpu_vs_cpu("enet DDPG", dst, dbuf, dev,
                                               ddpg_step, 3)
    out["ddpg_learn_ms"] = cuda_ms(lambda: ddpg.learn(dcfg, dst, dbuf, gen),
                                   20, warmup=3)
    print(f"enet learn ms (CUDA events, median of 20 after 3 warm-ups, "
          f"batch 64): TD3 {out['td3_learn_ms']:.3f} (alternate calls run "
          f"the 5-step ADMM actor update), DDPG {out['ddpg_learn_ms']:.3f}",
          flush=True)
    return out


# -- the enet episode programs and kernels 4 and 5 ---------------------------

# kernel 4 at full depth: the step lane's final loss at rtol 1e-4; the
# hint lanes that stopped before the cap on both sides at 5e-3, because
# the two sides reach a lane's flat minimum along other float32 paths and
# their stop tests fire at other iterations (up to 1.8e-3 over 24 such
# lanes in a CPU emulation, 1.2e-3 on the card); at least this many held
ENET_FULL_LOSS_RTOL = 1e-4
ENET_FULL_HINT_LOSS_RTOL = 5e-3
ENET_FULL_HINT_MIN_HELD = 24
EIG_RTOL, EIG_ATOL_REL = 1e-5, 1e-6     # x max|lambda|
FMA_LATENCY_CYCLES = 4       # a dependent FP32 FMA on sm_90
# a dependent FP64 operation on sm_90, taken at the FP64 FMA's latency
# (8 cycles, as microbenchmarked from Volta on); division and square root
# take several such operations, so counting each as one keeps a floor
FP64_LATENCY_CYCLES = 8
# one parallel Jacobi round's chain, from the entries a round reads to the
# entries the next round reads, each step counted once at the FP64 rate
# (the kernel takes the angle's steps in float32): a_qq - a_pp, d^2 + e^2
# (2), its square root, |d| + it, the division giving t, 1 + t^2, its
# reciprocal square root, the Newton step, s = t c, then the column mix
# (2) and the row mix (2)
JACOBI_ROUND_CHAIN_OPS = 14
# kernel 4's chain on its fast path, dependent FP32 operations: one
# objective evaluation it performs takes z = x + alpha d, A z (N FMAs in
# a row), the residual and its weights (2), A^T r (M FMAs), the gradient
# element (2), the merged butterfly (5) and the value (2): M + N +
# K4_EVAL_OPS; an iteration's own steps take, per pair in the ring, one
# dot's product, five butterfly adds, rho times it and the update, in
# each of the two loops, then g . d and the step: K4_PAIR_OPS a pair and
# K4_ITER_OPS (see k4_chain_ops)
K4_EVAL_OPS, K4_PAIR_OPS, K4_ITER_OPS = 12, 16, 8
LBFGS_HISTORY = 7                       # ops/lbfgs.LBFGS_HISTORY_DEFAULT
ENET_BLOCK, ENET_BLOCK_STEPS = 20, 5    # bench.py:87,329,448
ENET_BLOCK_EPISODES = 60                # 3 programs of 20: 1 untimed
ENET_BLOCK1_EPISODES = 6                # the episode program: 1 untimed
ENET_EIG_RANDOM = 64
ENET_SEED_LANES = 32                    # the ablation's seeded step lanes


def _enet_problem(enet, cfg, seed):
    """One env's (A, y) after a reset and a noisy draw, on the CPU."""
    g = torch.Generator().manual_seed(seed)
    st, _ = enet.reset(cfg, *enet.reset_draws(cfg, g, "cpu"))
    return enet.draw_noise(cfg, st, torch.randn(cfg.N, generator=g))


def kernel4_iterations(enet_lbfgs, args, dargs, label, n=5):
    """Kernel 4's first ``n`` iterations held one by one: from the
    kernel's own state after k iterations (a launch at max_iters = k), one
    iteration of the plain version (``lbfgs_resume``) against the kernel's
    iteration k + 1, x at ENET_ITER_RTOL / ENET_ITER_ATOL and the
    iteration counts equal.  Returns the max abs error."""
    from smartcal_tpu_torch.ops import lbfgs
    from smartcal_tpu_torch.ops.autodiff import lane_value_and_grad
    A, y, l2, l1, w = args
    Ae, ye = enet_lbfgs._expand(A, y, l2.shape[0])
    vag = lane_value_and_grad(lambda x: enet_lbfgs.lane_loss(Ae, ye, x, l2,
                                                             l1, w))
    worst = 0.0
    for k in range(n):
        prev = _to(enet_lbfgs.solve_cuda(*dargs, max_iters=k), "cpu")
        nxt = enet_lbfgs.solve_cuda(*dargs, max_iters=k + 1)
        ref = lbfgs.lbfgs_resume(vag, prev, 1)
        err = float((nxt.x.cpu() - ref.x).abs().max())
        ok = bool(torch.allclose(nxt.x.cpu(), ref.x, rtol=ENET_ITER_RTOL,
                                 atol=ENET_ITER_ATOL))
        ok = ok and torch.equal(nxt.n_iters.cpu(), ref.n_iters)
        if not ok:
            raise AssertionError(f"kernel 4 ({label}): iteration {k + 1} "
                                 f"disagrees with the plain version's from "
                                 f"the same state (max abs err {err:.3e})")
        worst = max(worst, err)
    print(f"kernel 4 ({label}, {l2.shape[0]} lanes): iterations 1..{n} each "
          f"held from the kernel's own previous state: max abs err "
          f"{worst:.3e} (rtol {ENET_ITER_RTOL} / atol {ENET_ITER_ATOL}) -> "
          "ok", flush=True)
    return worst


def k4_chain_ops(evals, n_iters, M, N, m):
    """Kernel 4's dependent-step chain of one lane, in operations: its
    performed evaluations at M + N + K4_EVAL_OPS each, and each iteration
    i's own steps over the pairs its two-loop reads, at most min(i, m)
    (the ring gains at most one pair an iteration; the count is exact when
    every pair is accepted)."""
    pairs = sum(min(i, m) for i in range(int(n_iters)))
    return (int(evals) * (M + N + K4_EVAL_OPS) + K4_PAIR_OPS * pairs
            + K4_ITER_OPS * int(n_iters))


def _kernel4_cases():
    """Kernel 4's operands on the CPU, {label: ((A, y, l2, l1, w),
    max_iters)}: one step lane and the hint's 50 weighted lanes of one env
    (M = N = 20)."""
    from smartcal_tpu_torch.envs import enet
    cfg = enet.EnetConfig()
    st = _enet_problem(enet, cfg, 11)
    rho, _ = enet.action_to_rho(torch.tensor([[0.3, -0.5]]))
    lams, test = enet.hint_lanes(cfg, "cpu")
    w = torch.where(test, 0.0, 1.0)
    A, y = st.A[None], st.y[None]
    return {"step": ((A, y, rho[:, 0].contiguous(), rho[:, 1].contiguous(),
                      None), cfg.lbfgs_iters),
            "hint": ((A, y, lams[:, 1].contiguous(),
                      lams[:, 0].contiguous(), w), enet.HINT_ITERS)}


def _full_depth_hold(label, res, ref, full):
    """Kernel 4's full-depth hold of ``res`` against the plain ``ref``:
    (loss rel err, lanes that stopped early on both sides, the held rel
    errs, their rtol, the least number held, whether it holds)."""
    rel = ((res.loss.cpu() - ref.loss).abs() / ref.loss.abs())
    if label == "hint":
        early = (res.n_iters.cpu() < full) & (ref.n_iters < full)
        held, rtol, least = rel[early], ENET_FULL_HINT_LOSS_RTOL, \
            ENET_FULL_HINT_MIN_HELD
    else:
        early = torch.ones_like(rel, dtype=torch.bool)
        held, rtol, least = rel, ENET_FULL_LOSS_RTOL, 1
    ok = int(held.numel()) >= least and bool((held <= rtol).all())
    return rel, early, held, rtol, least, ok


def enet_lbfgs_checks(dev, n_sm, plain_reps=1):
    """Kernel 4 against its plain version on one step lane and on the
    hint's 50 weighted lanes of one env (M = N = 20): each of the first 5
    iterations held from the kernel's own state (:func:`kernel4_iterations`),
    and for the step lane x after 5 iterations from x = 0, at
    ENET_ITER_RTOL / ENET_ITER_ATOL with equal iteration counts;
    at full depth (200 / 100 iterations) the step lane's loss held at
    ENET_FULL_LOSS_RTOL, the hint lanes that stopped before the cap on
    both sides at ENET_FULL_HINT_LOSS_RTOL (at least
    ENET_FULL_HINT_MIN_HELD of them), the capped lanes and the x
    difference printed; CUDA-event
    times (median of 20; the plain solve on the card, seconds long, median
    of ``plain_reps``), and per evaluation of the slowest lane; the bound
    of this run's work (the evaluations the kernel performed) and the
    dependent-step floor (:func:`k4_chain_ops`)."""
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.ops import enet_lbfgs
    cfg = enet.EnetConfig()
    out = {}
    for label, (args, full) in _kernel4_cases().items():
        dargs = tuple(None if a is None else a.to(dev) for a in args)
        err5 = kernel4_iterations(enet_lbfgs, args, dargs, label)
        got = enet_lbfgs.solve_cuda(*dargs, max_iters=5)
        want = enet_lbfgs.solve_plain(*args, max_iters=5)
        if not torch.equal(got.n_iters.cpu(), want.n_iters):
            raise AssertionError(f"kernel 4 ({label}): iteration counts "
                                 "differ from the plain version's")
        x5 = float((got.x.cpu() - want.x).abs().max())
        if label == "step":
            err5 = max(err5, _hold("kernel 4 x after 5 iterations (step, 1 "
                                   "lane)", got.x, want.x, ENET_ITER_RTOL,
                                   ENET_ITER_ATOL))
        else:
            print(f"kernel 4 x after 5 iterations from x = 0 ({label}): "
                  f"max abs diff {x5:.3e} (printed: a lane whose search "
                  f"ends on a flat minimum turns float32 round-off into "
                  f"~1e-5; each iteration is held above)", flush=True)
        res, evals = enet_lbfgs.solve_cuda(*dargs, max_iters=full,
                                           with_evals=True)
        again = enet_lbfgs.solve_cuda(*dargs, max_iters=full)
        if not all(torch.equal(getattr(res, f), getattr(again, f))
                   for f in ("x", "loss", "n_iters")):
            raise AssertionError(f"kernel 4 ({label}): two launches differ")
        ref = enet_lbfgs.solve_plain(*args, max_iters=full)
        rel, early, held, rtol, least, loss_ok = _full_depth_hold(
            label, res, ref, full)
        capped = rel[~early]
        x_err = float((res.x.cpu() - ref.x).abs().max())
        print(f"kernel 4 at full depth ({label}, {full} iterations): loss "
              f"rel err held on {int(held.numel())} lanes (at least "
              f"{least}) at rtol {rtol}: max "
              f"{float(held.max()) if held.numel() else float('nan'):.3e} "
              f"-> {'ok' if loss_ok else 'FAIL'}; {int(capped.numel())} "
              f"lanes capped on a side, printed: max "
              f"{float(capped.max()) if capped.numel() else 0.0:.3e}; x "
              f"max abs diff {x_err:.3e} (printed: the trajectories are "
              f"chaotic in float32); iterations kernel "
              f"{res.n_iters.tolist()[:8]}.. plain "
              f"{ref.n_iters.tolist()[:8]}..", flush=True)
        if not loss_ok:
            raise AssertionError(f"kernel 4 ({label}): full-depth losses "
                                 "disagree, or too few lanes held")
        ms = cuda_ms(lambda: enet_lbfgs.solve_cuda(*dargs, max_iters=full),
                     20, warmup=3)
        plain_ms = cuda_ms(lambda: enet_lbfgs.solve_plain(
            *dargs, max_iters=full), plain_reps, warmup=plain_reps // 3)
        n_ev = int(evals.sum())
        flops, nbytes = enet_lbfgs.solve_cost(*dargs, n_ev)
        bound_ms, bound_by = bound(nbytes, flops, 0.0, n_sm)
        chain = max(k4_chain_ops(e, it, cfg.M, cfg.N, LBFGS_HISTORY)
                    for e, it in zip(evals.tolist(), res.n_iters.tolist()))
        floor_ms = (1e3 * chain * FMA_LATENCY_CYCLES / BOOST_HZ)
        # the slowest lane's time per evaluation it performed
        us_per_eval = 1e3 * ms / int(evals.max())
        out[label] = {"lanes": int(args[2].shape[0]), "max_iters": full,
                      "max_abs_err_5_iters": err5, "x_max_abs_full": x_err,
                      "loss_rel_full_max": float(rel.max()),
                      "loss_rel_full_held_max": float(held.max()),
                      "loss_rel_full_rtol": rtol,
                      "lanes_held_full": int(held.numel()),
                      "iters": res.n_iters.tolist(),
                      "evals_total": n_ev, "evals_max": int(evals.max()),
                      "ms": ms, "us_per_eval": us_per_eval,
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "dependent_floor_ms": floor_ms,
                      "dependent_chain_ops": chain,
                      "flops": flops, "bytes": nbytes}
        print(f"kernel 4 ({label}, {out[label]['lanes']} lanes, M=N=20, "
              f"{full} iterations max): {ms:.4f} ms (median of 20; "
              f"{us_per_eval:.3f} us per evaluation of the slowest lane's "
              f"{int(evals.max())}), plain on the card {plain_ms:.1f} ms "
              f"(median of {plain_reps}), bound {bound_ms:.6f} ms "
              f"({bound_by}: {n_ev} evaluations performed), dependent-step "
              f"floor {floor_ms:.4f} ms (the longest lane's chain: "
              f"{cfg.M + cfg.N + K4_EVAL_OPS} dependent operations per "
              f"evaluation, {K4_PAIR_OPS} per pair in the ring and "
              f"{K4_ITER_OPS} per iteration, {chain} in all x "
              f"{FMA_LATENCY_CYCLES} cycles), kernel / floor "
              f"{ms / floor_ms:.1f}", flush=True)
    return out


def _eig_hard_cases(n, seed=17):
    """The harder inputs of kernel 5, each one n x n matrix: diagonal, a
    fivefold eigenvalue, rank 1, zero, eigenvalues from 1e-4 to 1e4, and
    a random matrix with one NaN on the diagonal."""
    g = torch.Generator().manual_seed(seed)
    Q, _ = torch.linalg.qr(torch.randn(n, n, generator=g,
                                       dtype=torch.float64))

    def spectrum(ev):
        return (Q @ torch.diag(ev.double()) @ Q.T).float()

    v = torch.randn(n, generator=g)
    R = torch.randn(n, n, generator=g)
    nan = R + R.T
    nan[n // 3, n // 3] = float("nan")
    return {"diagonal": torch.diag(torch.randn(n, generator=g)),
            "repeated": spectrum(torch.cat([torch.ones(5),
                                            torch.arange(2.0, n - 3)])),
            "rank 1": torch.outer(v, v),
            "zero": torch.zeros(n, n),
            "span 1e-4..1e4": spectrum(torch.logspace(-4, 4, n)),
            "one NaN": nan}


def sym_eigvals_checks(dev, n_sm):
    """Kernel 5 against eigvalsh (its plain version and the library call)
    on one step's influence matrix B (M = N = 20, on the card's own solve)
    and on ENET_EIG_RANDOM random symmetric 20 x 20 matrices, at EIG_RTOL
    and EIG_ATOL_REL x max|lambda|; bit for bit over two launches; CUDA-event
    times (median of 20; over 20 back-to-back launches too); the bound of
    the function's work (B read and the eigenvalues written once, ~4/3 n^3
    flops per matrix, the work of a symmetric eigensolve, at the FP32 rate)
    and the dependent-step floor of this run's sweeps (the slowest
    matrix's rounds, each a chain of JACOBI_ROUND_CHAIN_OPS FP64
    operations).  Then the harder inputs (:func:`_eig_hard_cases`) at the
    same tolerances, two launches each, and the NaN case's NaN ranked last
    (eigvalsh is not asked about a NaN)."""
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.ops import sym_eigvals
    cfg = enet.EnetConfig()
    st = _to(_enet_problem(enet, cfg, 12), dev)
    rho, _ = enet.action_to_rho(torch.tensor([[0.3, -0.5]], device=dev))
    res = enet._solve_lanes(cfg, st.A[None], st.y[None], rho)
    B_step = enet._influence_matrix_lanes(cfg, st.A[None], st.y[None], rho,
                                          res)
    g = torch.Generator().manual_seed(13)
    R = torch.randn(ENET_EIG_RANDOM, cfg.N, cfg.N, generator=g)
    cases = {"step B": B_step, "random": (R + R.mT).to(dev)}
    out = {}
    n = cfg.N
    rounds = n + n % 2 - 1
    for label, Bm in cases.items():
        sweeps = torch.zeros(Bm.shape[0], dtype=torch.int32, device=dev)
        got = sym_eigvals.sym_eigvals_cuda(Bm, sweeps=sweeps)
        if not torch.equal(got, sym_eigvals.sym_eigvals_cuda(Bm)):
            raise AssertionError(f"kernel 5 ({label}): two launches differ")
        want = sym_eigvals.sym_eigvals_plain(Bm)
        scale = float(want.abs().max())
        err = check_close("sym_eigvals", f"{label} ({Bm.shape[0]} x "
                          f"{cfg.N} x {cfg.N})", got, want, EIG_RTOL,
                          EIG_ATOL_REL, scale)
        ms = cuda_ms(lambda: sym_eigvals.sym_eigvals_cuda(Bm), 20, warmup=3)
        lib_ms = cuda_ms(lambda: sym_eigvals.sym_eigvals_plain(Bm), 20,
                         warmup=3)
        ms_b2b = cuda_ms_batched(lambda: sym_eigvals.sym_eigvals_cuda(Bm))
        flops, nbytes = sym_eigvals.eig_cost(Bm)
        bound_ms, bound_by = bound(nbytes, flops, 0.0, n_sm)
        floor_ms = (1e3 * int(sweeps.max()) * rounds
                    * JACOBI_ROUND_CHAIN_OPS * FP64_LATENCY_CYCLES / BOOST_HZ)
        out[label] = {"matrices": int(Bm.shape[0]), "n": n,
                      "max_abs_err": err, "max_abs_eig": scale,
                      "sweeps_max": int(sweeps.max()),
                      "sweeps_total": int(sweeps.sum()), "ms": ms,
                      "ms_back_to_back": ms_b2b,
                      "plain_ms": lib_ms, "library_ms": lib_ms,
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "dependent_floor_ms": floor_ms,
                      "flops": flops, "bytes": nbytes}
        print(f"kernel 5 ({label}): {ms:.4f} ms (median of 20; "
              f"{ms_b2b:.4f} ms each over 20 back to back), eigvalsh "
              f"(plain version and library call) {lib_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms ({bound_by}: 4/3 n^3 FP32 flops per "
              f"matrix, {nbytes:.0f} bytes), dependent-step floor "
              f"{floor_ms:.4f} ms (the slowest matrix's "
              f"{int(sweeps.max())} sweeps x {rounds} rounds x "
              f"{JACOBI_ROUND_CHAIN_OPS} dependent FP64 operations x "
              f"{FP64_LATENCY_CYCLES} cycles), kernel / floor "
              f"{ms / floor_ms:.1f}; {int(sweeps.sum())} sweeps in all",
              flush=True)
    hard = {}
    for label, Bh in _eig_hard_cases(n).items():
        Bh = Bh[None].to(dev)
        sweeps = torch.zeros(1, dtype=torch.int32, device=dev)
        got = sym_eigvals.sym_eigvals_cuda(Bh, sweeps=sweeps)
        again = sym_eigvals.sym_eigvals_cuda(Bh)
        if not torch.equal(got.nan_to_num(7.0), again.nan_to_num(7.0)):
            raise AssertionError(f"kernel 5 ({label}): two launches differ")
        if label == "one NaN":
            v = got[0].cpu()
            ok = (bool(torch.isnan(v[-1])) and bool(torch.isfinite(v[:-1])
                                                    .all())
                  and bool((v[1:-1] >= v[:-2]).all()))
            print(f"kernel 5 ({label}): {v.tolist()} -> NaN ranked last, "
                  f"the rest ascending: {'ok' if ok else 'FAIL'}",
                  flush=True)
            if not ok:
                raise AssertionError("kernel 5: the NaN is not ranked last")
            hard[label] = {"nan_last": True, "sweeps": int(sweeps[0])}
            continue
        want = sym_eigvals.sym_eigvals_plain(Bh)
        scale = float(want.abs().max())
        hard[label] = {"max_abs_err": check_close(
            "sym_eigvals", label, got, want, EIG_RTOL, EIG_ATOL_REL, scale),
            "max_abs_eig": scale, "sweeps": int(sweeps[0])}
    out["hard"] = hard
    return out


def _program_agents(dev):
    """(name, episode-program maker, fresh state maker, ring maker) of the
    three fused trainers at full width (M = N = 20)."""
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.rl import ddpg, sac, td3
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.train import enet_ddpg, enet_sac, enet_td3
    env = enet.EnetConfig()
    scfg = enet_sac.agent_config(env, use_hint=True)
    tcfg = enet_td3.agent_config(env)
    dcfg = enet_ddpg.agent_config(env)
    return [
        ("sac", lambda: enet_sac.make_episode_fn(env, scfg, ENET_BLOCK_STEPS,
                                                 True),
         lambda g: sac.sac_init(scfg, g, dev),
         lambda: _random_ring(rp, scfg, 64, dev, lambda r: 1.0)),
        ("td3", lambda: enet_td3.make_episode_fn(env, tcfg, 4, True),
         lambda g: td3.td3_init(tcfg, g, dev),
         lambda: _random_ring(rp, tcfg, 64, dev,
                              lambda r: td3.store_priority(tcfg, r))),
        ("ddpg", lambda: enet_ddpg.make_episode_fn(env, dcfg,
                                                   ENET_BLOCK_STEPS),
         lambda g: ddpg.ddpg_init(dcfg, g, dev),
         lambda: _random_ring(rp, dcfg, 64, dev, lambda r: 1.0))]


def _same_run(a, b):
    """(same bits?, max abs diff) of two (state, ring, generator) runs."""
    from smartcal_tpu_torch.rl.sac import state_tensors
    (st_a, buf_a, g_a), (st_b, buf_b, g_b) = a, b
    ta = state_tensors(st_a) + [buf_a.priority] + list(buf_a.data.values())
    tb = state_tensors(st_b) + [buf_b.priority] + list(buf_b.data.values())
    same = all(torch.equal(x, y) for x, y in zip(ta, tb))
    same = same and torch.equal(g_a.get_state(), g_b.get_state())
    same = same and (buf_a.cntr, float(buf_a.beta)) == (buf_b.cntr,
                                                        float(buf_b.beta))
    diff = max(float((x.detach().float() - y.detach().float()).abs().max())
               if x.numel() else
               0.0 for x, y in zip(ta, tb))
    return same, diff


def program_checks(dev, zero_counts, read_counts):
    """Each trainer's episode program (enet_sac with the hint, enet_td3,
    enet_ddpg; a 64-transition random ring so the episode learns) replayed
    against the same body run eagerly on the card from cloned state, ring
    and generator: the same bits; then enet_sac's make_episode_block_fn(3)
    against 3 replays of its episode program: the same bits; a replay
    after the captured state, ring and generator are restored in place
    (``load_into``) repeats the first replay's bits."""
    from smartcal_tpu_torch.train import enet_sac
    from smartcal_tpu_torch.train.blocks import (clone_ring, load_into,
                                                 load_ring_into)
    out = {}
    for name, make, init, ring in _program_agents(dev):
        gen = torch.Generator(dev).manual_seed(0)
        st, buf = init(gen), ring()
        st_e, buf_e = st.copy_to(dev), clone_ring(buf)
        g_e = torch.Generator(dev)
        g_e.set_state(gen.get_state())
        prog = make()
        zero_counts()
        t0 = time.perf_counter()
        score = prog(st, buf, enet_sac.Draws(gen, dev))
        first_s = time.perf_counter() - t0
        launches = read_counts()
        eager = prog.program._eager(st_e, buf_e, enet_sac.Draws(g_e, dev))
        same, diff = _same_run((st, buf, gen), (st_e, buf_e, g_e))
        same = same and float(score) == float(eager[0])
        print(f"enet_{name} episode program: capture "
              f"{prog.program.capture_seconds:.3f} s, first call "
              f"{first_s:.3f} s, score {float(score):.6f}; against its "
              f"body run eagerly on the card: "
              f"{'the same bits' if same else f'max abs diff {diff:.3e}'}"
              f"; launches " + ", ".join(f"{k} {v}" for k, v in
                                         launches.items() if v), flush=True)
        if not same:
            raise AssertionError(f"enet_{name}: the program's replay differs "
                                 "from its eager body")
        out[name] = {"capture_s": prog.program.capture_seconds,
                     "first_call_s": first_s, "launches": launches,
                     "score": float(score), "same_bits": same}
    # the block against three chained episodes, and a restore in place
    name, make, init, ring = _program_agents(dev)[0]
    from smartcal_tpu_torch.envs import enet
    env = enet.EnetConfig()
    cfg = enet_sac.agent_config(env, use_hint=True)
    gen = torch.Generator(dev).manual_seed(1)
    st, buf = init(gen), ring()
    st_b, buf_b = st.copy_to(dev), clone_ring(buf)
    g_b = torch.Generator(dev)
    g_b.set_state(gen.get_state())
    ep = make()
    chained = [float(ep(st, buf, enet_sac.Draws(gen, dev)))
               for _ in range(3)]
    blk = enet_sac.make_episode_block_fn(env, cfg, ENET_BLOCK_STEPS, True, 3)
    saved = (st_b.copy_to(dev), clone_ring(buf_b), g_b.get_state())
    blocked = blk(st_b, buf_b, enet_sac.Draws(g_b, dev)).tolist()
    same, diff = _same_run((st, buf, gen), (st_b, buf_b, g_b))
    same = same and blocked == chained
    load_into(st_b, saved[0])
    load_ring_into(buf_b, saved[1])
    g_b.set_state(saved[2])
    again = blk(st_b, buf_b, enet_sac.Draws(g_b, dev)).tolist()
    same_again, _ = _same_run((st, buf, gen), (st_b, buf_b, g_b))
    restored = same_again and again == blocked
    print(f"enet_sac block program (3 episodes) against 3 episode-program "
          f"replays: {'the same bits' if same else f'max abs diff {diff:.3e}'}"
          f" (scores {blocked}); replayed again after an in-place restore: "
          f"{'the same bits' if restored else 'DIFFERENT'}; block capture "
          f"{blk.capture_seconds:.3f} s", flush=True)
    if not (same and restored):
        raise AssertionError("enet_sac: the block program is not the chain "
                             "of episode programs")
    out["block3"] = {"same_bits": True, "scores": blocked,
                     "capture_s": blk.capture_seconds}
    return out


def enet_program_phase(dev, out_dir, zero_counts, read_counts, n_sm,
                       deep=False):
    """Kernels 4 and 5 against their plain versions; the episode programs
    against their eager bodies (:func:`program_checks`); then the bench
    configuration through the trainer a user calls: ``enet_sac --block
    20`` and ``--block 1`` (M = N = 20, batch 64, a 1024-slot ring, 5
    steps; the first program fills the ring past the batch and is not
    timed), without and with ``--use_hint``, each with --metrics:
    env-steps/s from the timed programs' spans, capture seconds from the
    compile events, peak memory, and the runs of kernels 4 and 5 as the
    kernels count them on the card (counts zeroed just before and read
    just after), held to what the run asks for: each episode, the
    capture's eager warm-up episode included, runs kernel 4 once per step
    and once for the hint, kernel 5 once per step."""
    from smartcal_tpu_torch.train import enet_sac
    out = {"kernel4": enet_lbfgs_checks(dev, n_sm, 3 if deep else 1),
           "kernel5": sym_eigvals_checks(dev, n_sm),
           "programs": program_checks(dev, zero_counts, read_counts)}
    for block, hint in ((20, False), (1, False), (20, True), (1, True)):
        n_ep = (ENET_BLOCK_EPISODES if block > 1
                else ENET_BLOCK1_EPISODES) * (2 if deep else 1)
        tag = f"block{block}" + ("_hint" if hint else "")
        log = os.path.join(out_dir, f"enet_{tag}_run.jsonl")
        if os.path.exists(log):
            os.remove(log)
        args = ["--episodes", str(n_ep), "--steps", str(ENET_BLOCK_STEPS),
                "--block", str(block), "--seed", "0", "--quiet",
                "--metrics", log, "--prefix",
                os.path.join(out_dir, f"enet_{tag}_")]
        args += ["--use_hint"] if hint else []
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        summary = enet_sac.main(args)
        wall = time.perf_counter() - t0
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        for f in ("sac_state.pkl", "replaymem_sac.pkl"):
            os.remove(os.path.join(out_dir, f"enet_{tag}_{f}"))
        events = _run_events(log)
        span = "episode_block" if block > 1 else "episode"
        durs = [e["dur_s"] for e in events
                if e["event"] == "span" and e["name"] == span]
        caps = [e["dur_s"] for e in events if e["event"] == "compile"
                and e["key"].startswith("cuda_graph:enet_sac")]
        timed = durs[1:]
        rate = block * ENET_BLOCK_STEPS * len(timed) / sum(timed)
        scores = summary["final_avg_score"]
        per_episode = {"enet_lbfgs": ENET_BLOCK_STEPS + int(hint),
                       "sym_eigvals": ENET_BLOCK_STEPS}
        want = {k: (n_ep + 1) * v for k, v in per_episode.items()}
        got = {k: launches[k] for k in want}
        eager = {k: launches[k + "_eager"] for k in want}
        replayed = {k: got[k] - eager[k] for k in want}
        if not (np.isfinite(scores) and len(durs) == n_ep // block
                and len(caps) == 1 and got == want
                and eager == per_episode):
            raise AssertionError(f"enet_sac {' '.join(args)}: {summary}, "
                                 f"spans {durs}, captures {caps}, kernel "
                                 f"runs {got} (want {want}), from the host "
                                 f"outside a capture {eager} (want "
                                 f"{per_episode}, the warm-up episode)")
        out[tag] = {
            "args": args, "summary": summary, "wall_s": wall,
            "env_steps_per_sec": rate, "program_s": durs,
            "capture_s": caps[0], "launches": launches,
            "launches_replayed": replayed, "peak_mem_bytes": peak}
        print(f"enet_sac --block {block}{' --use_hint' if hint else ''} "
              f"(M=N=20, batch 64, ring 1024, {ENET_BLOCK_STEPS} steps; "
              f"{n_ep} episodes): {rate:.2f} env-steps/s over the "
              f"{len(timed)} timed programs ({np.median(timed):.4f} s "
              f"each, median), the first (capture {caps[0]:.3f} s) "
              f"{durs[0]:.3f} s; the trainer's JSON "
              f"{summary['env_steps_per_sec']} env-steps/s over "
              f"{wall:.2f} s; peak device memory {peak / 2**20:.0f} MiB; "
              f"kernel runs counted on the card " + ", ".join(
                  f"{k} {got[k]} ({replayed[k]} in graph replays, "
                  f"{eager[k]} eager)" for k in want), flush=True)
    return out


ENET_KERNELS = {
    "enet_lbfgs": ("smartcal_tpu_torch/csrc/enet_lbfgs.cu",
                   "no pallas_call: the XLA L-BFGS of the enet step and "
                   "hint, smartcal_tpu/envs/enet.py:125 and :208"),
    "sym_eigvals": ("smartcal_tpu_torch/csrc/sym_eigvals.cu",
                    "no pallas_call: jnp.linalg.eigvalsh of the enet "
                    "state, smartcal_tpu/envs/enet.py:112")}


def enet_kernel_entry(name, report):
    """The ``kernels`` line's entry of kernel 4 or 5: its runs on the
    bench configuration's path (``enet_sac --block 20``) as the kernel
    counts them on the card, how many of them graph replays made, its runs
    on every other path that counted them, the checks' errors and times,
    the bound and the dependent-step floor."""
    ep = report["enet_program"]
    cases = ep["kernel4"] if name == "enet_lbfgs" else ep["kernel5"]
    main = cases["step"] if name == "enet_lbfgs" else cases["step B"]
    by_path = {}
    for k, v in report.items():
        if isinstance(v, dict):
            for sub, w in [(k, v)] + [(f"{k}.{a}", b) for a, b in v.items()
                                      if isinstance(b, dict)]:
                if isinstance(w.get("launches"), dict) \
                        and name in w["launches"]:
                    by_path[sub] = w["launches"][name]
    err_key = "max_abs_err_5_iters" if name == "enet_lbfgs" \
        else "max_abs_err"
    source, replaces = ENET_KERNELS[name]
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": ep["block20"]["launches"][name],
            "launches_replayed": ep["block20"]["launches_replayed"][name],
            "launches_by_path": by_path,
            "max_abs_err": max(
                [c[err_key] for c in cases.values() if err_key in c]
                + [c["max_abs_err"] for c in cases.get("hard", {}).values()
                   if "max_abs_err" in c]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "dependent_floor_ms": main["dependent_floor_ms"],
            "library_ms": main.get("library_ms"),
            "shapes": ("M=N=20, 1 lane, 200 iterations max"
                       if name == "enet_lbfgs" else "1 x 20 x 20"),
            "cases": cases}

def calib_td3_ddpg_phase(dev, out_dir, zero_counts, read_counts):
    """Drive train/calib_td3.py and train/calib_ddpg.py on the N=62 backend
    (counts zeroed just before and read just after each; dft_imager >= 3
    launches per env call), then hold one full-width CNN TD3 learn step
    (batch 32, 128², M=10, an ADMM actor step) on the card against the
    CPU from a state with Adam history."""
    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.rl import td3
    from smartcal_tpu_torch.train import calib_ddpg, calib_td3
    out = {}
    for name, main, args in (("calib_td3", calib_td3.main, CALIB_TD3_ARGS),
                             ("calib_ddpg", calib_ddpg.main,
                              CALIB_DDPG_ARGS)):
        prefix = os.path.join(out_dir, name)
        timer = StepTimer(CalibEnv)
        zero_counts()
        t0 = time.perf_counter()
        try:
            scores = main(args + ["--prefix", prefix])
        finally:
            timer.restore()
        launches = read_counts()
        seconds = time.perf_counter() - t0
        env_calls = 1 + len(timer.seconds)        # one reset per episode
        if not np.all(np.isfinite(scores)) or \
                launches["dft_imager"] < 3 * env_calls:
            raise AssertionError(f"{name}: scores {scores}, launches "
                                 f"{launches} over {env_calls} env calls")
        for f in os.listdir(out_dir):                 # the agent pickles
            if f.startswith(name) and f.endswith(".pkl"):
                os.remove(os.path.join(out_dir, f))
        out[name] = {"args": args, "scores": list(scores),
                     "seconds": seconds, "env_step_seconds": timer.seconds,
                     "launches": launches}
        print(f"{name} ({' '.join(args)}): {seconds:.3f} s, env steps "
              + ", ".join(f"{x:.3f}" for x in timer.seconds)
              + " s; launches " + ", ".join(f"{k} {v}" for k, v in
                                           launches.items()), flush=True)

    cfg = calib_td3.agent_config(128, 10, use_hint=True)
    buf = _random_ring(rp, dataclasses.replace(cfg, mem_size=64), 48, dev,
                       lambda r: 1.0)
    st = td3.td3_init(cfg, torch.Generator(dev).manual_seed(0), dev)
    gen = torch.Generator(dev).manual_seed(1)
    for _ in range(4):
        td3.learn(cfg, st, buf, gen)
    st.learn_counter = 1                  # the compared step updates the actor

    def step(s, batch, draws):
        s_batch = {k: v[:cfg.batch_size] for k, v in batch.items()}
        td3.learn_from_batch(cfg, s, s_batch, torch.ones(
            cfg.batch_size, device=draws[1].device), draws[1])

    out["cnn_td3_gpu_vs_cpu"] = learns_gpu_vs_cpu(
        "calibration TD3 (CNN, hint ADMM)", st, buf, dev, step, 1)
    return out


# -- --ablation: the engine with one design choice undone -----------------

# -- the batched slice: BatchedCalibEnv, prefetch, the
# batched trainer (all at the N=62 reference scale) ------------------------

# RadioBackend's N=62 defaults at half their ADMM depth (10): 70 L-BFGS
# iterations a solve instead of 110, to keep the script inside its limit
# (the trainers' runs keep their own backends' full depth)
N62 = dict(n_stations=62, n_freqs=3, n_times=20, tdelta=10, n_poly=2,
           admm_iters=5, lbfgs_iters=8, init_iters=30, npix=128)
BATCH_M, BATCH_E = 10, 4
# 2 vector episodes of 4 steps: 32 transitions, learning at the 32nd (1
# learn, the Adam history the agent checks start from)
BATCH_TRAIN_EPISODES, BATCH_TRAIN_STEPS = 8, 4
BATCH_TRAIN_ARGS = ["--stations", "62", "--batch-envs", "4", "--episodes",
                    str(BATCH_TRAIN_EPISODES), "--steps",
                    str(BATCH_TRAIN_STEPS), "--use_hint", "--seed", "0",
                    "--quiet"]
PREFETCH_RESETS = 2
# tests/test_batched_radio.py: (rtol, atol) of the fused route against the
# sequential oracle
ORACLE_TOL = {"img": (2e-3, 2e-5), "reward": (2e-3, 1e-4),
              "sigma_res": (1e-3, 0.0)}


class LbfgsIters:
    """Stands in for ``ops.lbfgs.lbfgs_solve`` and keeps each call's
    per-lane iteration counts (as device tensors, read afterwards)."""

    def __init__(self):
        from smartcal_tpu_torch.ops import lbfgs
        self.mod, self.fn = lbfgs, lbfgs.lbfgs_solve
        self.calls = []
        lbfgs.lbfgs_solve = self

    def __call__(self, *args, **kw):
        res = self.fn(*args, **kw)
        self.calls.append(res.n_iters)
        return res

    def restore(self):
        self.mod.lbfgs_solve = self.fn

    def since(self, n0):
        """(loop iterations = sum over inner solves of the slowest lane's,
        sum of the lanes' mean, number of lanes) of the calls from n0."""
        its = [c.cpu().numpy() for c in self.calls[n0:]]
        if not its:
            return {"iters_max": 0, "iters_mean": 0.0, "lanes": 0}
        return {"iters_max": int(sum(int(i.max()) for i in its)),
                "iters_mean": float(sum(float(i.mean()) for i in its)),
                "lanes": int(its[0].size), "inner_solves": len(its)}


def tol_ratio(got, want, rtol, atol):
    """max |got - want| / (atol + rtol |want|): at most 1 within tolerance."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


def check_batched(obs, rewards, info, E, npix, M):
    if obs["img"].shape != (E, npix, npix) or obs["sky"].shape != (E, M + 1,
                                                                   7):
        raise AssertionError(f"batched observation shapes "
                             f"{obs['img'].shape} {obs['sky'].shape}")
    vals = list(obs.values()) + [rewards, info["sigma_res"]]
    if not all(np.all(np.isfinite(v)) for v in vals):
        raise AssertionError("batched env: non-finite output")
    if not np.all(info["sigma_res"] < info["sigma_data"]):
        raise AssertionError("batched env: calibration did not reduce the "
                             "residual")


def batched_env_phase(dev, zero_counts, read_counts, n62_step_s, n62_idle):
    """BatchedCalibEnv(M=10, n_envs=4) at N=62: reset and two vector steps
    on the hint, counts zeroed just before and read just after; stage
    seconds, L-BFGS iterations (slowest lane and mean) per vector step;
    queued, a third step profiled for the idle share and CUDA kernels per
    L-BFGS iteration (beside the N=62 path's single step, in
    ``n62_idle``); then the same 4 lanes through the fused=False oracle,
    reset and one step, held at the JAX package's tolerances."""
    from smartcal_tpu_torch.cal import solver
    from smartcal_tpu_torch.envs import calib, radio
    from smartcal_tpu_torch.envs.calib import BatchedCalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    E = BATCH_E
    held = held_bytes(dev)
    backend = RadioBackend(device=dev, **N62)
    env = BatchedCalibEnv(M=BATCH_M, n_envs=E, backend=backend, seed=0,
                          provide_hint=True, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    iters = LbfgsIters()
    steps = []
    zero_counts()
    try:
        t0 = time.perf_counter()
        obs0 = env.reset()
        t_reset = time.perf_counter() - t0
        reset_stages = dict(backend.stage_seconds)
        reset_iters = iters.since(0)
        hint0 = env.hint.copy()
        for i in range(2):
            before, n0 = dict(backend.stage_seconds), len(iters.calls)
            t0 = time.perf_counter()
            obs, rew, _, _, info = env.step(env.hint)
            sec = time.perf_counter() - t0
            if i == 0:
                first = (obs, rew, info)
            steps.append({
                "seconds": sec, "rewards": rew.tolist(),
                "sigma_res": info["sigma_res"].tolist(),
                "sigma_data": info["sigma_data"].tolist(),
                "stage_seconds": {k: v - before.get(k, 0.0) for k, v in
                                  backend.stage_seconds.items()},
                **iters.since(n0)})
            check_batched(obs, rew, info, E, N62["npix"], BATCH_M)
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated(dev)
        check_batched(obs0, np.zeros(E), info, E, N62["npix"], BATCH_M)
        step_wall = float(np.mean([s["seconds"] for s in steps]))
    finally:
        iters.restore()
    if any(launches.values()):
        raise AssertionError(f"the fused batched route launched {launches}: "
                             "it runs the factored imager's matmuls and the "
                             "unblocked chain at N=62, no kernel")
    out = {"E": E, "M": BATCH_M, "reset_seconds": t_reset,
           "reset_stage_seconds": reset_stages, "reset_iters": reset_iters,
           "steps": steps, "launches": launches, "peak_mem_bytes": peak,
           "held_mem_bytes": held, "env_steps_per_s": E / step_wall,
           "sequential_env_steps_per_s": 1.0 / n62_step_s}
    print(f"batched env (E={E}, M={BATCH_M}, N=62): K={env.K.tolist()} "
          f"reset {t_reset:.3f} s (stages "
          + ", ".join(f"{k} {v:.3f}" for k, v in reset_stages.items())
          + "); vector steps " + "; ".join(
              f"{s['seconds']:.3f} s (" + ", ".join(
                  f"{k} {v:.3f}" for k, v in s["stage_seconds"].items())
              + f"; L-BFGS iterations {s['iters_max']} slowest lane, "
              f"{s['iters_mean']:.1f} mean over {s['lanes']} lanes)"
              for s in steps)
          + f"; {out['env_steps_per_s']:.4f} env-steps/s against the "
          f"sequential N=62 path's {out['sequential_env_steps_per_s']:.4f}; "
          f"peak device memory {peak / 2**20:.0f} MiB ({held / 2**20:.0f} MiB "
          "of it held by earlier phases); launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    defer(batched_profiles, env, step_wall, n62_idle, out)

    # -- the same lanes through the fused=False oracle: reset + one step.
    # The N=62 solve is chaotic in float32 (a 1-ulp change of V moves
    # sigma_res by ~1%, ROADMAP queue 3) and the card's reductions change
    # order with the lane count, so the fused route and the oracle part at
    # round-off end to end: those errors are printed beside the 1-ulp spread
    # of lane 0's own solve.  Held at the JAX package's tolerances: the
    # fused influence, sigmas and reward on the oracle's own step solves;
    # held bit for bit: lane 0's step solve through the batched route at E=1.
    ob = RadioBackend(device=dev, **N62)
    oracle = BatchedCalibEnv(M=BATCH_M, n_envs=E, backend=ob, seed=0,
                             provide_hint=True, fused=False, device=dev)
    calibrate, run_cal, solves, cal_out = (ob.calibrate,
                                           oracle._run_calibration, [], [])

    def keep_solve(*args, **kw):
        solves.append(calibrate(*args, **kw))
        return solves[-1]

    def keep_cal():
        cal_out.append(run_cal())
        return cal_out[-1]

    ob.calibrate, oracle._run_calibration = keep_solve, keep_cal
    zero_counts()
    t0 = time.perf_counter()
    o_obs0 = oracle.reset()
    if not np.array_equal(oracle.hint, hint0):
        raise AssertionError("oracle lanes drew other episodes")
    o_obs, o_rew, _, _, o_info = oracle.step(oracle.hint)
    oracle_s = time.perf_counter() - t0
    oracle_launches = read_counts()
    ob.calibrate = calibrate
    obs1, rew1, info1 = first
    end_to_end = {
        "img_reset": tol_ratio(obs0["img"], o_obs0["img"],
                               *ORACLE_TOL["img"]),
        "img_step": tol_ratio(obs1["img"], o_obs["img"], *ORACLE_TOL["img"]),
        "reward": tol_ratio(rew1, o_rew, *ORACLE_TOL["reward"]),
        "sigma_res": tol_ratio(info1["sigma_res"], o_info["sigma_res"],
                               *ORACLE_TOL["sigma_res"])}
    sigma_res_rel = (np.abs(info1["sigma_res"] - o_info["sigma_res"])
                     / o_info["sigma_res"]).tolist()
    sky_equal = (np.array_equal(obs0["sky"], o_obs0["sky"])
                 and np.array_equal(obs1["sky"], o_obs["sky"]))
    # the fused stages on the oracle's step solves
    step_solves = solves[E:]
    o_imgs, o_sd, o_sr = cal_out[1][:3]
    rho, mask, alpha = oracle._lane_rho_mask()
    bep_o = ob.stack_episodes(oracle.eps)
    stacked = solver.SolveResult(*(torch.stack([getattr(r, f) for r in
                                                step_solves])
                                   for f in solver.SolveResult._fields))
    f_imgs = ob.influence_images_batched(bep_o, stacked, rho,
                                         alpha).cpu().numpy()
    f_sd, f_sr = (t.cpu().numpy() for t in
                  ob.image_sigmas_batched(bep_o, stacked))

    def reward_terms(sr, imgs):
        return (oracle._sigma_data_img / np.maximum(sr, 1e-12)
                + 1e-4 / (imgs.std(axis=(1, 2)) + calib.EPS))

    f_rew = o_rew - reward_terms(o_sr, o_imgs) + reward_terms(f_sr, f_imgs)
    sc = calib.INF_SCALE
    stages = {
        "influence": tol_ratio(f_imgs * sc, o_imgs * sc, *ORACLE_TOL["img"]),
        "sigma_data_img": tol_ratio(f_sd, o_sd, *ORACLE_TOL["sigma_res"]),
        "sigma_res_img": tol_ratio(f_sr, o_sr, *ORACLE_TOL["sigma_res"]),
        "reward": tol_ratio(f_rew, o_rew, *ORACLE_TOL["reward"])}
    one = radio.BatchedEpisode(*(x[:1] if i < 6 else x
                                 for i, x in enumerate(bep_o)))
    r1 = ob.calibrate_batched(one, rho[:1], mask=mask[:1])
    solve_bitwise = bool(torch.equal(r1.J[0], step_solves[0].J)
                         and torch.equal(r1.residual[0],
                                         step_solves[0].residual))
    ep0 = oracle.eps[0]
    r_ulp = ob.calibrate(ep0._replace(V=ep0.V * (1 + 2 ** -23)), rho[0],
                         mask=mask[0])
    ulp_rel = float(abs(r_ulp.sigma_res - step_solves[0].sigma_res)
                    / step_solves[0].sigma_res)
    out["oracle"] = {"seconds": oracle_s, "launches": oracle_launches,
                     "end_to_end_ratios": end_to_end,
                     "sigma_res_rel": sigma_res_rel,
                     "stage_ratios": stages,
                     "lane0_solve_e1_bitwise": solve_bitwise,
                     "lane0_sigma_res_rel_under_1ulp_of_V": ulp_rel,
                     "sky_equal": sky_equal, "tolerances": ORACLE_TOL}
    print("  fused against the fused=False oracle (reset + 1 step, "
          f"{oracle_s:.3f} s; launches "
          + ", ".join(f"{k} {v}" for k, v in oracle_launches.items())
          + "): largest error over its tolerance end to end "
          + ", ".join(f"{k} {v:.4f}" for k, v in end_to_end.items())
          + " (sigma_res relative per lane "
          + ", ".join(f"{v:.2e}" for v in sigma_res_rel)
          + f"; lane 0's own solve moves {ulp_rel:.2e} under a 1-ulp change "
          "of V); the fused stages on the oracle's step solves "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f" (tolerances {ORACLE_TOL}); lane 0's solve at E=1 bit for bit "
          f"{solve_bitwise}; sky tables equal {sky_equal}", flush=True)
    if max(stages.values()) > 1.0 or not (sky_equal and solve_bitwise):
        raise AssertionError("the fused batched route disagrees with its "
                             "oracle on the same solves")
    want = 2 * N62["n_freqs"] * E * 2    # data + residual image per band
    if oracle_launches["dft_imager"] != want:
        raise AssertionError(f"the oracle launched dft_imager "
                             f"{oracle_launches['dft_imager']} times, "
                             f"expected {want}")
    del env, oracle, backend, first, obs0, obs, o_obs0, o_obs, stacked, bep_o
    torch.cuda.empty_cache()

    return out


def batched_profiles(env, step_wall, n62_idle, out):
    """A third vector step of ``env`` profiled: its idle share against the
    unprofiled ``step_wall`` and its CUDA kernels per L-BFGS iteration,
    beside the N=62 path's single step; into ``out``."""
    iters = LbfgsIters()
    try:
        step_prof, step_busy, step_kernels = device_busy_seconds(
            lambda: env.step(env.hint))
    finally:
        iters.restore()
    its = iters.since(0)
    per_iter = step_kernels / max(its["iters_max"], 1)
    single = n62_idle.get("step_kernels_per_iter")
    out.update(
        profiled_step={"wall_s": step_prof, "busy_s": step_busy,
                       "kernels": step_kernels, "kernels_per_iter": per_iter,
                       **its},
        single_step_kernels_per_iter=single,
        step_idle_share=idle_share("batched vector step (E=4)", step_wall,
                                   step_busy, step_prof))
    print(f"  profiled: a vector step {step_kernels} kernels and copies over "
          f"{its['iters_max']} iterations = {per_iter:.0f} per iteration "
          f"(the N=62 path's single step {single} per iteration)",
          flush=True)


def prefetch_phase(dev, zero_counts, read_counts):
    """CalibEnv(M=10) at N=62 with prefetch=False, then True: 2 resets
    each, timed; the observations must be equal bit for bit.  Records, per
    prefetched reset, whether the build was done when taken (hit) or
    waited on (stall), and whether each reset's solve began while the next
    episode's build was still running (it must, at least once: the solve's
    graph capture against the worker's stream)."""
    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    runs = {}
    for pf in (False, True):
        be = RadioBackend(device=dev, **N62)
        env = CalibEnv(M=BATCH_M, backend=be, seed=0, provide_hint=True,
                       device=dev, prefetch=pf)
        calibrate, pending = be.calibrate, []

        def spy(*args, **kw):
            fut = be._prefetched.get(env._pf_tag)
            pending.append(fut is not None and not fut.done())
            return calibrate(*args, **kw)

        be.calibrate = spy
        obs, secs, taken = [], [], []
        zero_counts()
        try:
            for _ in range(PREFETCH_RESETS):
                before = dict(be.prefetch_counts)
                t0 = time.perf_counter()
                obs.append(env.reset())
                secs.append(time.perf_counter() - t0)
                taken.append(next((k for k, v in be.prefetch_counts.items()
                                   if v > before[k]), None))
        finally:
            env.close()
        runs[pf] = {"reset_seconds": secs, "taken": taken,
                    "solve_began_while_building": pending,
                    "stage_seconds": dict(be.stage_seconds),
                    "launches": read_counts(), "obs": obs}
        del env, be
    for a, b in zip(runs[False]["obs"], runs[True]["obs"]):
        for k in a:
            if not np.array_equal(a[k], b[k]):
                raise AssertionError(f"prefetch changed the observation "
                                     f"({k}, max abs diff "
                                     f"{np.abs(a[k] - b[k]).max()})")
    for r in runs.values():
        del r["obs"]
        if r["launches"]["dft_imager"] != PREFETCH_RESETS * N62["n_freqs"]:
            raise AssertionError(f"dft_imager launched {r['launches']} times "
                                 f"over {PREFETCH_RESETS} resets, expected "
                                 f"{PREFETCH_RESETS * N62['n_freqs']}")
    if not any(runs[True]["solve_began_while_building"]):
        raise AssertionError("no solve overlapped a prefetch build")
    print(f"prefetch (CalibEnv M=10, N=62, {PREFETCH_RESETS} resets): "
          "without " + ", ".join(f"{s:.3f}" for s in
                                 runs[False]["reset_seconds"])
          + " s; with " + ", ".join(f"{s:.3f}" for s in
                                    runs[True]["reset_seconds"])
          + f" s (prefetch taken as {runs[True]['taken']}; solve began "
          "while the next build ran "
          f"{runs[True]['solve_began_while_building']}); observations "
          "equal bit for bit; stage seconds without "
          + ", ".join(f"{k} {v:.3f}" for k, v in
                      runs[False]["stage_seconds"].items())
          + "; with " + ", ".join(f"{k} {v:.3f}" for k, v in
                                  runs[True]["stage_seconds"].items()),
          flush=True)
    return {"without": runs[False], "with": runs[True]}


def batched_train_phase(dev, out_dir, zero_counts, read_counts):
    """train/calib_sac.py --batch-envs 4 at N=62 (2 vector episodes of 4
    steps: 32 transitions, one learn per vector step from the 32nd), counts
    zeroed just before and read just after; checks the 8 scores, then
    the saved agent (learn_counter 1, ring 32) through
    :func:`agent_checks`."""
    import pickle

    from smartcal_tpu_torch.train import calib_sac
    prefix = os.path.join(out_dir, "calib_sac_b4_")
    os.makedirs(out_dir, exist_ok=True)
    held = held_bytes(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    scores = calib_sac.main(BATCH_TRAIN_ARGS + ["--prefix", prefix])
    train_s = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    with open(prefix + "_scores.pkl", "rb") as fh:
        saved = pickle.load(fh)
    n_env_steps = BATCH_TRAIN_EPISODES * BATCH_TRAIN_STEPS
    if (len(scores) != BATCH_TRAIN_EPISODES or saved != scores
            or not np.all(np.isfinite(scores))):
        raise AssertionError(f"batched trainer scores {scores} / {saved}")
    if any(launches.values()):
        raise AssertionError(f"the batched trainer launched {launches}")
    out = {"args": BATCH_TRAIN_ARGS, "scores": [float(s) for s in scores],
           "train_seconds": train_s, "env_steps": n_env_steps,
           "env_steps_per_s": n_env_steps / train_s, "peak_mem_bytes": peak,
           "held_mem_bytes": held, "launches": launches}
    print(f"batched trainer (calib_sac {' '.join(BATCH_TRAIN_ARGS)}): "
          f"{train_s:.3f} s, {out['env_steps_per_s']:.4f} env-steps/s; "
          "scores " + ", ".join(f"{s:.4f}" for s in scores)
          + f"; peak device memory {peak / 2**20:.0f} MiB ({held / 2**20:.0f} "
          "MiB of it held by earlier phases)", flush=True)
    agent_checks(dev, prefix, out, learn_counter=1, ring_cntr=n_env_steps)
    return out


# -- the demixing slice: the diffuse calibration episode at N=62, the
# demixing env, its batched form, the fuzzy env and the five trainers.  They
# run before the first torch.profiler session of the process (which slows
# later launches, ROADMAP lever h); the demixing step's profile is taken
# last, by :func:`demix_profile` ------------------------------------------

DIFFUSE_K = 5
# the demixing trainers' default backend (demix_sac.make_backend):
# N=14, Nf=3, T=20, tdelta=10, admm_iters=30, npix=128, hint_batch=8
DEMIX_TIER = argparse.Namespace(small=False, light=False, medium=False,
                                stations=14, npix=128)
DEMIX_K, DEMIX_E = 6, 4
# the sweeps held against one mask at a time: a few L-BFGS iterations,
# where the solve is not chaotic in float32; the backend's own at
# admm_iters=2 are printed beside the 1-ulp spread
SWEEP_HELD = {"init_iters": 2, "lbfgs_iters": 2, "admm_iters": 1}
SWEEP_ITERS, SWEEP_RTOL = 2, 1e-3
FUZZY_ATOL = 1e-3                       # tests/test_torch_fuzzy.py
SHAPELET_RTOL, SHAPELET_ATOL = 1e-4, 1e-6   # tests/test_torch_shapelets.py
DEMIX_COMMON = ["--seed", "0", "--quiet"]
DEMIX_DRIVERS = (
    ("demix_sac", ["--iteration", "1", "--steps", "1", "--warmup", "0",
                   "--use_hint", "--provide_influence"]),
    ("demix_sac_b4", ["--batch-envs", "4", "--iteration", "4", "--steps",
                      "1"]),
    ("demix_td3", ["--iteration", "1", "--steps", "1"]),
    ("demix_fuzzy_sac", ["--iteration", "1", "--steps", "1", "--use_hint"]),
    ("calib_sac_light", ["--light", "--episodes", "1", "--steps", "1"]),
)


def _demix_actions(E, K):
    """Fixed actions: alternating selections, maxiter 5 (lane 0) to 10."""
    a = np.tile(np.where(np.arange(K) % 2 == 0, 0.9, -0.9), (E, 1))
    a[:, -1] = np.linspace(-1.0, -0.6, E)
    return a.astype(np.float32)


def diffuse_phase(dev, zero_counts, read_counts):
    """A diffuse calibration episode (the shapelet sky) at N=62: build,
    calibrate, influence, data and residual images, counts zeroed just
    before and read just after; finite, sigma_res < sigma_data, the
    card's shapelet add against its plain CPU computation on the same
    uvw, kernel 1 held against the direct DFT on the episode's data."""
    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.cal import imager
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.ops import dft_imager
    backend = RadioBackend(device=dev, **N62)
    key = prng.split(prng.PRNGKey(0))[1]
    M = BATCH_M
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t = {}
    t0 = time.perf_counter()
    ep, mdl = backend.new_calib_episode(key, DIFFUSE_K, M, diffuse=True)
    torch.cuda.synchronize(dev)
    t["simulate"] = time.perf_counter() - t0
    rho = np.ones(M, np.float32)
    rho[:DIFFUSE_K] = mdl.rho
    mask = (np.arange(M) < DIFFUSE_K).astype(np.float32)
    alpha = np.zeros(M, np.float32)
    alpha[:DIFFUSE_K] = mdl.rho_spatial
    t0 = time.perf_counter()
    res = backend.calibrate(ep, rho, mask=mask)
    torch.cuda.synchronize(dev)
    t["solve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inf = backend.influence_image(ep, res, rho, alpha).cpu().numpy()
    t["influence"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    data = backend.data_image(ep).cpu().numpy()
    resid = backend.residual_image(ep, res).cpu().numpy()
    t["images"] = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    sig_res, sig_data = float(res.sigma_res), float(res.sigma_data)
    if not all(np.isfinite(x).all() for x in (inf, data, resid)):
        raise AssertionError("diffuse episode: non-finite image")
    if not sig_res < sig_data or not np.std(resid) < np.std(data):
        raise AssertionError(f"diffuse episode: sigma_res {sig_res} against "
                             f"sigma_data {sig_data}")
    want = 2 * N62["n_freqs"]               # data + residual image per band
    if launches["dft_imager"] != want:
        raise AssertionError(f"diffuse path launched dft_imager "
                             f"{launches['dft_imager']} times, expected "
                             f"{want}")
    # the shapelet add on the card against its plain CPU computation, on
    # the path's uvw and on it scaled by 1e-3: the component (beta ~0.1
    # rad) is resolved out on every baseline of the array, so it is seen
    # only at a few wavelengths
    shp = mdl.shapelet
    zeros = torch.zeros_like(ep.Ccal)
    cpu_backend = RadioBackend(device="cpu", **N62)
    shp_err, shp_max = [], []
    for scale in (1.0, 1e-3):
        obs = ep.obs._replace(uvw=ep.obs.uvw * scale)
        got = backend._add_shapelet(obs, zeros, shp.coeff, shp.beta,
                                    shp.flux)
        want_add = cpu_backend._add_shapelet(
            obs._replace(uvw=obs.uvw.cpu(), freqs=obs.freqs.cpu()),
            zeros.cpu(), shp.coeff, shp.beta, shp.flux)
        shp_max.append(float(want_add.abs().max()))
        shp_err.append(check_close(
            "shapelet add", f"diffuse path uvw x {scale} n0="
            f"{shp.coeff.shape[0]} R={ep.Ccal.shape[2]}", got.cpu(),
            want_add, SHAPELET_RTOL, SHAPELET_ATOL, shp_max[-1]))
    if not shp_max[1] > 1.0:
        raise AssertionError("the shapelet add vanished at a few "
                             "wavelengths too")
    # kernel 1 on the diffuse episode's band-0 data, against the direct DFT
    uvw = ep.obs.uvw.reshape(-1, 3)
    cell = imager.default_cell(ep.obs.uvw, float(ep.obs.freqs[-1]))
    visc = imager.stokes_i_vis(ep.V[0]).contiguous()
    dft_err = check_imager(dft_imager, scaled_uv(dft_imager, uvw,
                                                 float(ep.obs.freqs[0])),
                           visc, N62["npix"], cell, "diffuse path")
    out = {"K": DIFFUSE_K, "M": M, "n0": int(shp.coeff.shape[0]),
           "seconds": t, "sigma_res": sig_res, "sigma_data": sig_data,
           "sigma_res_img": float(np.std(resid)),
           "sigma_data_img": float(np.std(data)), "launches": launches,
           "peak_mem_bytes": peak, "shapelet_max_abs_err": shp_err,
           "shapelet_max_abs": shp_max,
           "dft_max_abs_err": dft_err}
    print(f"diffuse episode (N=62, K={DIFFUSE_K}, M={M}, shapelet n0="
          f"{out['n0']}): " + ", ".join(f"{k} {v:.3f} s" for k, v in t.items())
          + f"; sigma_res {sig_res:.5f} < sigma_data {sig_data:.5f}; image "
          f"std residual {out['sigma_res_img']:.5f} data "
          f"{out['sigma_data_img']:.5f}; peak {peak / 2**20:.0f} MiB; "
          "launches " + ", ".join(f"{k} {v}" for k, v in launches.items()),
          flush=True)
    return out


def demix_env_phase(dev, zero_counts, read_counts):
    """DemixingEnv(K=6, provide_hint=True, provide_influence=True) on the
    demixing trainers' default backend: reset and 2 steps with fixed
    actions (the first step computes the hint), counts zeroed just before
    and read just after; stage seconds, L-BFGS iterations per call, peak
    memory; the hint's shape and range; the sweep of every selection at
    a few L-BFGS iterations one mask at a time, 8 and 32 at a time (rtol
    1e-3), and at admm_iters=2 32 at a time beside a 1-ulp change of V
    (printed).  Returns
    (report, env) for :func:`demix_profile`."""
    from smartcal_tpu_torch.envs.demixing import DemixingEnv
    from smartcal_tpu_torch.train import demix_sac
    backend = demix_sac.make_backend(DEMIX_TIER, dev)
    env = DemixingEnv(K=DEMIX_K, provide_hint=True, provide_influence=True,
                      backend=backend, seed=0, device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    iters = LbfgsIters()
    zero_counts()
    steps = []
    try:
        t0 = time.perf_counter()
        obs0 = env.reset()
        t_reset = time.perf_counter() - t0
        reset_stages, reset_iters = dict(backend.stage_seconds), \
            iters.since(0)
        for a in _demix_actions(2, DEMIX_K):
            before, n0 = dict(backend.stage_seconds), len(iters.calls)
            t0 = time.perf_counter()
            obs, reward, done, hint, info = env.step(a)
            sec = time.perf_counter() - t0
            steps.append({"seconds": sec, "maxiter": env.maxiter,
                          "reward": float(reward),
                          "sigma_res": info["sigma_res"],
                          "stage_seconds": {
                              k: v - before.get(k, 0.0) for k, v in
                              backend.stage_seconds.items()},
                          **iters.since(n0)})
            if not (np.isfinite(reward) and all(np.isfinite(v).all()
                                                for v in obs.values())):
                raise AssertionError("demixing env: non-finite step")
            if not info["sigma_res"] < env.std_data:
                raise AssertionError("demixing env: calibration did not "
                                     "reduce the residual")
    finally:
        iters.restore()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    if not all(np.isfinite(v).all() for v in obs0.values()):
        raise AssertionError("demixing env: non-finite reset")
    if obs0["infmap"].shape != (DEMIX_TIER.npix,) * 2 \
            or obs0["metadata"].shape != (3 * DEMIX_K + 2,):
        raise AssertionError("demixing env: observation shapes")
    want_iter = (steps[0]["maxiter"] - 17.5) * (2 / 25)
    if hint.shape != (DEMIX_K,) or not np.isfinite(hint).all() \
            or np.abs(hint).max() > 1.0 \
            or not math.isclose(hint[-1], want_iter, abs_tol=1e-6):
        raise AssertionError(f"demixing hint {hint}")
    # the sweep of every selection, one mask at a time and batched.  Held
    # (rtol 1e-3) at a few L-BFGS iterations (SWEEP_HELD: 2 init + 1 ADMM
    # x 2), where round-off stays round-off: the card's reductions change
    # order with the lane count, and at the backend's 30 init iterations
    # the solve is chaotic even at admm_iters=2 (ROADMAP queue 3).  At
    # admm_iters=2 on the backend itself, 32 at a time, the 1-ulp spread of
    # V is printed, not held.
    masks, valid = env.hint_masks()
    held_backend = demix_sac.make_backend(DEMIX_TIER, dev)
    for k, v in SWEEP_HELD.items():
        setattr(held_backend, k, v)
    sweep, sweep_s, free = {}, {}, {}
    for b in (1, 8, 32):
        t0 = time.perf_counter()
        sweep[b] = held_backend.hint_sweep(env.ep, env.rho, masks,
                                           batch=b).cpu().numpy()
        sweep_s[b] = time.perf_counter() - t0
        if b != 32:     # one at a time: 32 full solves, ~40 s
            continue
        t0 = time.perf_counter()
        free[b] = backend.hint_sweep(env.ep, env.rho, masks,
                                     admm_iters=SWEEP_ITERS,
                                     batch=b).cpu().numpy()
        sweep_s[f"{b}_admm{SWEEP_ITERS}"] = time.perf_counter() - t0
    ulp = backend.hint_sweep(env.ep._replace(V=env.ep.V * (1 + 2 ** -23)),
                             env.rho, masks, admm_iters=SWEEP_ITERS,
                             batch=32).cpu().numpy()
    ratios = {f"batch{b}_vs_batch1": tol_ratio(sweep[b], sweep[1],
                                               SWEEP_RTOL, 0.0)
              for b in (8, 32)}
    ratios["batch32_vs_batch8"] = tol_ratio(sweep[32], sweep[8], SWEEP_RTOL,
                                            0.0)
    free_rel = {"batch32_under_1ulp_of_V": float(np.max(np.abs(
        ulp - free[32]) / free[32]))}
    if launches != read_counts() or any(launches.values()):
        raise AssertionError(f"the demixing env launched {launches}: its "
                             "influence map (N=14, npix=128) reaches no "
                             "kernel threshold and its reward is no image")
    out = {"K": DEMIX_K, "reset_seconds": t_reset,
           "reset_stage_seconds": reset_stages, "reset_iters": reset_iters,
           "steps": steps, "hint": hint.tolist(),
           "hint_seconds": steps[0]["stage_seconds"].get("hint", 0.0),
           "stage_seconds": dict(backend.stage_seconds),
           "launches": launches, "peak_mem_bytes": peak,
           "sweep_held_config": SWEEP_HELD, "sweep_seconds": sweep_s,
           "sweep_masks": int(masks.shape[0]),
           "sweep_valid": int(valid.sum()),
           "sweep_ratios": ratios, "sweep_rtol": SWEEP_RTOL,
           "sweep_admm_iters": SWEEP_ITERS,
           "sweep_free_max_rel": free_rel}
    print(f"demixing env (N={backend.n_stations}, Nf={backend.n_freqs}, "
          f"T={backend.n_times}, K={DEMIX_K}): reset {t_reset:.3f} s "
          f"(L-BFGS iterations {reset_iters['iters_max']}); steps "
          + "; ".join(f"{s['seconds']:.3f} s at maxiter {s['maxiter']} ("
                      + ", ".join(f"{k} {v:.3f}" for k, v in
                                  s["stage_seconds"].items())
                      + f"; L-BFGS iterations {s['iters_max']} over "
                      f"{s.get('inner_solves', 0)} inner solves)"
                      for s in steps)
          + f"; hint {out['hint_seconds']:.3f} s "
          + str(np.round(hint, 4).tolist())
          + "; stage seconds " + ", ".join(
              f"{k} {v:.3f}" for k, v in backend.stage_seconds.items())
          + f"; peak {peak / 2**20:.0f} MiB; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)
    print(f"  hint sweep of {masks.shape[0]} selections ({int(valid.sum())} "
          "valid): " + ", ".join(f"batch {b} {s:.3f} s" for b, s in
                                 sweep_s.items())
          + f"; held at {SWEEP_HELD}, largest difference over rtol 1e-3: "
          + ", ".join(f"{k} {v:.4f}" for k, v in ratios.items())
          + f"; at admm_iters={SWEEP_ITERS} on the backend (not held) "
          "largest relative difference " + ", ".join(
              f"{k} {v:.2e}" for k, v in free_rel.items()), flush=True)
    if max(ratios.values()) > 1.0:
        raise AssertionError("the hint sweep depends on its batch width")
    return out, env


def demix_batched_phase(dev, zero_counts, read_counts):
    """BatchedDemixingEnv(K=6, E=4, provide_influence=True), fused, reset
    and one step with fixed actions, then the same lanes through the
    fused=False oracle.  Held on the oracle's own step solves: the fused
    noise statistic, influence images and rewards (rtol 1e-4 on sigma and
    reward, the image tolerance of tests/test_batched_radio.py).  The
    end-to-end differences are printed beside lane 0's 1-ulp spread and
    not held (the solve is chaotic in float32, ROADMAP queue 3)."""
    from smartcal_tpu_torch.cal import solver
    from smartcal_tpu_torch.envs.demixing import BatchedDemixingEnv
    from smartcal_tpu_torch.train import demix_sac
    E, K = DEMIX_E, DEMIX_K
    acts = _demix_actions(E, K)
    out = {"E": E}
    runs = {}
    for fused in (True, False):
        b = demix_sac.make_backend(DEMIX_TIER, dev)
        env = BatchedDemixingEnv(K=K, n_envs=E, provide_influence=True,
                                 backend=b, seed=0, fused=fused, device=dev)
        solves = []
        if not fused:
            cal = b.calibrate

            def keep(*args, **kw):
                solves.append(cal(*args, **kw))
                return solves[-1]

            b.calibrate = keep
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        t0 = time.perf_counter()
        obs0 = env.reset()
        t_reset = time.perf_counter() - t0
        t0 = time.perf_counter()
        obs, rew, dones, info = env.step(acts)
        t_step = time.perf_counter() - t0
        launches = read_counts()
        if any(launches.values()):
            raise AssertionError(f"batched demixing launched {launches}")
        if not (np.isfinite(rew).all() and all(
                np.isfinite(v).all() for o in (obs0, obs)
                for v in o.values())):
            raise AssertionError("batched demixing: non-finite output")
        runs[fused] = (env, obs, rew, info, solves)
        out["fused" if fused else "oracle"] = {
            "reset_seconds": t_reset, "step_seconds": t_step,
            "env_steps_per_s": E / t_step, "maxiter": env.maxiter.tolist(),
            "stage_seconds": dict(b.stage_seconds), "launches": launches,
            "peak_mem_bytes": torch.cuda.max_memory_allocated(dev)}
    env, obs, rew, info, _ = runs[True]
    oenv, oobs, orew, oinfo, solves = runs[False]
    step_solves = solves[E:]
    b = env.backend
    stacked = solver.SolveResult(*(torch.stack([getattr(r, f) for r in
                                                step_solves])
                                   for f in solver.SolveResult._fields))
    masks = oenv._masks([np.where(s > 0.5)[0].tolist()
                         for s in acts[:, :K - 1] * 0.5 + 0.5])
    sig = b.noise_std_batched(stacked.residual).cpu().numpy()
    rho_eff = oenv.rho * masks + (1 - masks)
    imgs = b.influence_images_batched(oenv.bep, stacked, rho_eff,
                                      np.zeros_like(rho_eff)).cpu().numpy()
    saved = oenv.std_residual
    oenv.std_residual = sig
    f_rew = oenv.calculate_rewards(masks.sum(1)) - oenv.reward0
    oenv.std_residual = saved
    stages = {"sigma_res": tol_ratio(sig, oinfo["sigma_res"], 1e-4, 0.0),
              "influence": tol_ratio(imgs * 1e-3, oobs["infmap"],
                                     *ORACLE_TOL["img"]),
              "reward": tol_ratio(f_rew, orew, 1e-4, 1e-6)}
    end_to_end = {
        "sigma_res_rel": (np.abs(info["sigma_res"] - oinfo["sigma_res"])
                          / oinfo["sigma_res"]).tolist(),
        "reward_abs": np.abs(rew - orew).tolist(),
        "infmap_rel": float(np.linalg.norm(obs["infmap"] - oobs["infmap"])
                            / np.linalg.norm(oobs["infmap"]))}
    ep0 = oenv.eps[0]
    r_ulp = b.calibrate(ep0._replace(V=ep0.V * (1 + 2 ** -23)), oenv.rho[0],
                        mask=masks[0], admm_iters=int(oenv.maxiter[0]))
    ulp_rel = float(abs(float(b.noise_std(r_ulp.residual))
                        - float(oinfo["sigma_res"][0]))
                    / float(oinfo["sigma_res"][0]))
    meta_equal = np.array_equal(obs["metadata"], oobs["metadata"])
    out.update(stage_ratios=stages, end_to_end=end_to_end,
               lane0_sigma_res_rel_under_1ulp_of_V=ulp_rel,
               metadata_equal=meta_equal)
    print(f"batched demixing (E={E}, K={K}): fused reset "
          f"{out['fused']['reset_seconds']:.3f} s, step "
          f"{out['fused']['step_seconds']:.3f} s "
          f"({out['fused']['env_steps_per_s']:.4f} env-steps/s, maxiter "
          f"{out['fused']['maxiter']}); oracle reset "
          f"{out['oracle']['reset_seconds']:.3f} s, step "
          f"{out['oracle']['step_seconds']:.3f} s; on the oracle's step "
          "solves over tolerance " + ", ".join(
              f"{k} {v:.4f}" for k, v in stages.items())
          + "; end to end (not held): sigma_res rel " + ", ".join(
              f"{v:.2e}" for v in end_to_end["sigma_res_rel"])
          + f", infmap rel {end_to_end['infmap_rel']:.2e} (lane 0 moves "
          f"{ulp_rel:.2e} under a 1-ulp change of V); metadata equal "
          f"{meta_equal}", flush=True)
    if max(stages.values()) > 1.0 or not meta_equal:
        raise AssertionError("batched demixing disagrees with its oracle on "
                             "the same solves")
    return out


def demix_fuzzy_phase(dev, zero_counts, read_counts):
    """FuzzyDemixingEnv(K=6) reset and one step on the default controller;
    the priorities of 4 random actions and the hint on the card against
    the CPU (atol 1e-3 on 0-100)."""
    from smartcal_tpu_torch.envs.demixing_fuzzy import FuzzyDemixingEnv
    from smartcal_tpu_torch.models.fuzzy import DemixController
    from smartcal_tpu_torch.train import demix_sac
    env = FuzzyDemixingEnv(K=DEMIX_K, provide_hint=True,
                           backend=demix_sac.make_backend(DEMIX_TIER, dev),
                           seed=0, device=dev)
    zero_counts()
    t0 = time.perf_counter()
    env.reset()
    t_reset = time.perf_counter() - t0
    t0 = time.perf_counter()
    obs, r, _, hint, info = env.step(env.hint)
    t_step = time.perf_counter() - t0
    launches = read_counts()
    if not np.isfinite(r) or any(launches.values()):
        raise AssertionError(f"fuzzy env: reward {r}, launches {launches}")
    rng = np.random.default_rng(0)
    acts = [rng.uniform(-1, 1, env.n_actions).astype(np.float32)
            for _ in range(4)] + [hint]
    gpu = [env.priorities(a)[0] for a in acts]
    env.ctrl = DemixController(device="cpu")
    cpu = [env.priorities(a)[0] for a in acts]
    err = float(np.max(np.abs(np.asarray(gpu) - np.asarray(cpu))))
    print(f"fuzzy env (K={DEMIX_K}): reset {t_reset:.3f} s, step "
          f"{t_step:.3f} s (selected {info['selected']}, priorities "
          + ", ".join(f"{p:.3f}" for p in info["priority"])
          + f"); priorities GPU vs CPU over 5 actions max abs err "
          f"{err:.3e} (atol {FUZZY_ATOL})", flush=True)
    if not err <= FUZZY_ATOL:
        raise AssertionError("fuzzy priorities: GPU and CPU disagree")
    return {"reset_seconds": t_reset, "step_seconds": t_step,
            "priority": list(info["priority"]),
            "selected": info["selected"], "priority_max_abs_err": err,
            "launches": launches}


def demix_drivers_phase(dev, out_dir, zero_counts, read_counts):
    """The five trainers of the slice, each with counts zeroed just before
    and read just after: scores finite, agent, ring and scores saved (the
    pickles are deleted once read: the CNN agent is ~100 MB), env-steps/s
    over the trainer's seconds."""
    import pickle

    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.envs.demixing import (BatchedDemixingEnv,
                                                  DemixingEnv)
    from smartcal_tpu_torch.envs.demixing_fuzzy import FuzzyDemixingEnv
    from smartcal_tpu_torch.train import (calib_sac, demix_fuzzy_sac,
                                          demix_sac, demix_td3)
    mains = {"demix_sac": demix_sac.main, "demix_sac_b4": demix_sac.main,
             "demix_td3": demix_td3.main,
             "demix_fuzzy_sac": demix_fuzzy_sac.main,
             "calib_sac_light": calib_sac.main}
    os.makedirs(out_dir, exist_ok=True)
    out = {}
    for name, args in DEMIX_DRIVERS:
        args = args + DEMIX_COMMON
        prefix = os.path.join(out_dir, name + "_")
        env_cls = (CalibEnv if name.startswith("calib") else
                   FuzzyDemixingEnv if "fuzzy" in name else
                   BatchedDemixingEnv if "--batch-envs" in args else
                   DemixingEnv)
        timer = StepTimer(env_cls)
        zero_counts()
        t0 = time.perf_counter()
        try:
            scores = mains[name](args + ["--prefix", prefix])
        finally:
            timer.restore()
        seconds = time.perf_counter() - t0
        launches = read_counts()
        lanes = 4 if "--batch-envs" in args else 1
        n_steps = lanes * len(timer.seconds)
        kind = "td3" if "td3" in name else "sac"
        files = [prefix + f"{kind}_state.pkl",
                 prefix + f"replaymem_{kind}.pkl", prefix + "_scores.pkl"]
        missing = [f for f in files if not os.path.exists(f)]
        cntr = None
        if not missing:
            with open(files[1], "rb") as fh:
                cntr = pickle.load(fh)["cntr"]
            for f in files[:2]:
                os.remove(f)
        n_scores = len(scores)
        if missing or not np.all(np.isfinite(scores)) or cntr != n_steps \
                or n_scores != lanes:
            raise AssertionError(f"{name}: scores {scores}, missing "
                                 f"{missing}, ring {cntr} of {n_steps}")
        env = timer.env
        n_freqs = env.backend.n_freqs
        if name.startswith("calib"):
            want = n_freqs * (1 + len(timer.seconds))
            if launches["dft_imager"] < want:
                raise AssertionError(f"{name}: dft_imager launched "
                                     f"{launches['dft_imager']} < {want}")
        elif any(launches.values()):
            raise AssertionError(f"{name} launched {launches}")
        out[name] = {"args": args, "scores": [float(s) for s in scores],
                     "seconds": seconds, "env_steps": n_steps,
                     "env_steps_per_s": n_steps / seconds,
                     "env_step_seconds": timer.seconds,
                     "stage_seconds": dict(env.backend.stage_seconds),
                     "launches": launches}
        print(f"{name} ({' '.join(args)}): {seconds:.3f} s, "
              f"{out[name]['env_steps_per_s']:.4f} env-steps/s ({n_steps} "
              "env steps; calls " + ", ".join(f"{s:.3f}" for s in
                                              timer.seconds)
              + " s); stage seconds " + ", ".join(
                  f"{k} {v:.3f}" for k, v in env.backend.stage_seconds.items())
              + "; launches " + ", ".join(f"{k} {v}" for k, v in
                                          launches.items()), flush=True)
    return out


# -- the runtime and observability slice: checkpoint/resume, rollback, the
# run log, update diagnostics, a trace -------------------------------------

# -- the supervised slice: the demixing recommender and the data edge.  It
# runs right after the demixing phases, before the first torch.profiler
# session of the process -------------------------------------------------

SUP_K, SUP_SAMPLES, SUP_EPOCHS = 6, 3, 200
SUP_HINT_SAMPLES, SUP_MLP_ITERS, SUP_TSK_ITERS = 2, 250, 500
SUP_HINT_ADMM = 10       # the hint backend's depth (the env's default 30)
SUP_HINT_BATCH = 32
SUP_TSK_N_AVG = 1        # inputs the TSK influence averages over
# the transformer influence's reduced width: its (P, N) cross derivative
# is ~40.0M x 98,352 floats at the default width (npix 128, model_dim 66)
SUP_INFLUENCE = dict(npix=16, model_dim=6, warmup_epochs=5, samples=12)
SUP_FEATURE_REL = 5e-4   # influence 1e-4 + kernel 1's 2e-4, renormalized
SUP_SCALAR_ATOL = 1e-4   # the log-norms and log|Inf| (test_torch_supervised)


def _features_ok(X, Y, K, npix, label):
    """Finite features, each image block of unit norm, labels in {0, 1}."""
    nout = npix * npix + 8
    if X.shape[1] != K * nout or not np.all(np.isfinite(X)):
        raise AssertionError(f"{label}: features {X.shape} not finite")
    norms = np.linalg.norm(X.reshape(-1, K, nout)[..., :npix * npix],
                           axis=-1)
    if np.abs(norms - 1.0).max() > 1e-4:
        raise AssertionError(f"{label}: image block norms {norms}")
    if Y is not None and not np.all((Y == 0.0) | (Y == 1.0)):
        raise AssertionError(f"{label}: labels {Y}")
    return float(np.abs(norms - 1.0).max())


def _perdir_on(dev, ep, mdl, res, backend):
    """Perdir influence, summary and features of band 0 on ``dev``, from
    one episode's shared solve."""
    from smartcal_tpu_torch.cal import dataset, influence, solver
    K = ep.n_dirs
    C, J, R = (t.to(dev) for t in (ep.Ccal[0], res.J[0], res.residual[0]))
    freqs = ep.obs.freqs.cpu().numpy()
    hadd = influence.consensus_hadd_scalars(
        mdl.rho, np.full(K, 0.001, np.float32), freqs, ep.f0, 0,
        n_poly=backend.n_poly, polytype=backend.polytype).to(dev)
    inf = influence.influence_visibilities(
        solver.residual_to_kernel(R), C, J, hadd, backend.n_stations,
        backend.n_chunks, perdir=True)
    summ = influence.perdir_summary(inf.vis, inf.llr, C, J)
    x = dataset.perdir_features(
        R, C, J, mdl.rho, freqs, ep.f0, ep.obs.uvw.to(dev),
        backend.n_stations, backend.n_chunks, mdl.separations, mdl.azimuth,
        mdl.elevation, npix=backend.npix, n_poly=backend.n_poly,
        polytype=backend.polytype)
    return (inf.vis.cpu().numpy(), inf.llr.cpu().numpy(),
            {f: getattr(summ, f).cpu().numpy() for f in summ._fields}, x)


def _featurization_gpu_vs_cpu(dev, ep, mdl, res, backend):
    """(c): the perdir visibilities and each summary field (1e-4 relative
    norm, tests/test_torch_perdir_influence.py's) and the features (image
    blocks SUP_FEATURE_REL relative, the scalars SUP_SCALAR_ATOL, the
    metadata exact) of one sample on the card against the CPU, on the
    card's solve."""
    vg, lg, sg, xg = _perdir_on(dev, ep, mdl, res, backend)
    vc, lc, sc, xc = _perdir_on(torch.device("cpu"), ep, mdl, res, backend)
    out = {"vis_rel": float(np.linalg.norm(vg - vc) / np.linalg.norm(vc)),
           "llr_rel": float(np.linalg.norm(lg - lc) / np.linalg.norm(lc)),
           **{f"summary_{f}_rel": float(np.linalg.norm(sg[f] - sc[f])
                                         / np.linalg.norm(sc[f]))
              for f in sc}}
    K, npix = ep.n_dirs, backend.npix
    nout = npix * npix + 8
    xg, xc = xg.reshape(K, nout), xc.reshape(K, nout)
    img = slice(0, npix * npix)
    out["image_block_rel"] = float(np.max(np.linalg.norm(
        xg[:, img] - xc[:, img], axis=-1)))
    out["scalars_max_abs"] = float(np.max(np.abs(xg[:, npix * npix:]
                                                 - xc[:, npix * npix:])))
    meta = [npix * npix + i for i in (0, 1, 2, 7)]
    ok = (out["vis_rel"] <= 1e-4 and out["llr_rel"] <= 1e-4
          and max(out[f"summary_{f}_rel"] for f in sc) <= 1e-4
          and out["image_block_rel"] <= SUP_FEATURE_REL
          and np.allclose(xg[:, npix * npix + 3:npix * npix + 7],
                          xc[:, npix * npix + 3:npix * npix + 7],
                          atol=SUP_SCALAR_ATOL,
                          rtol=1e-4)
          and np.array_equal(xg[:, meta], xc[:, meta]))
    print("supervised featurization GPU vs CPU (one sample, the card's "
          "solve): " + ", ".join(f"{k} {v:.3e}" for k, v in out.items())
          + f" -> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError("featurization GPU vs CPU")
    return out


def _transformer_gpu_vs_cpu(dev, model, opt, buf, n_steps=3, seed=7):
    """3 Adam steps (dropout off) of the trained model on the card and of
    its copy on the CPU, from the training's Adam state, on the same
    batches; raises beyond TRAIN_RTOL / TRAIN_ATOL on every parameter and
    moment."""
    from smartcal_tpu_torch.models.transformer import build_transformer
    from smartcal_tpu_torch.rl.sac import AdamState
    from smartcal_tpu_torch.train.supervised import transformer_step
    cpu = build_transformer(model.num_heads, 0, model.model_dim
                            // model.num_heads, input_dim=model.input_dim)
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    copt = AdamState(opt.count,
                     {k: v.cpu().clone() for k, v in opt.mu.items()},
                     {k: v.cpu().clone() for k, v in opt.nu.items()})
    rng = np.random.default_rng(seed)
    n = min(buf.mem_cntr, buf.mem_size)
    losses = []
    for _ in range(n_steps):
        i = rng.choice(n, min(8, n), replace=False)
        xb, yb = torch.from_numpy(buf.x[i]), torch.from_numpy(buf.y[i])
        lg = transformer_step(model, opt, xb.to(dev), yb.to(dev), 1e-3)
        lc = transformer_step(cpu, copt, xb, yb, 1e-3)
        losses.append((float(lg), float(lc)))

    def host(m, o):
        return {"params": {k: v.detach().cpu().numpy()
                           for k, v in m.state_dict().items()},
                "mu": {k: v.cpu().numpy() for k, v in o.mu.items()},
                "nu": {k: v.cpu().numpy() for k, v in o.nu.items()},
                "count": o.count}

    err, ratio = state_diff(host(model, opt), host(cpu, copt))
    loss_err = max(abs(a - b) for a, b in losses)
    if not loss_err <= TRAIN_ATOL + TRAIN_RTOL * max(abs(b) for _, b in
                                                     losses):
        raise AssertionError(f"transformer steps GPU vs CPU: losses {losses}")
    print(f"transformer Adam steps GPU vs CPU ({n_steps} steps, full width, "
          f"from the training's Adam state): max abs err parameters and "
          f"moments {err:.3e}, at most {ratio:.3f} of the tolerance (rtol "
          f"{TRAIN_RTOL} / atol {TRAIN_ATOL}), losses {loss_err:.2e} "
          "apart -> ok", flush=True)
    return {"max_abs_err": err, "max_tolerance_share": ratio,
            "loss_max_abs_err": loss_err}


def supervised_phase(dev, out_dir, zero_counts, read_counts, n_sm):
    """The supervised slice on the card (``train/supervised.py`` and the
    data edge), at the JAX package's default width: (a) the transformer
    dataset, SUP_SAMPLES samples on the default backend (N=14, Nf=3, T=20,
    npix=128, K=6; kernel 1 x 6 per sample, counted); (b) kernel 1 against
    its plain version at the path's own operands; (c) one sample's
    featurization on the card against the CPU on the card's solve; (d)
    class balancing, then the full-width transformer (input 98,352,
    model_dim 396, 6 heads) trained SUP_EPOCHS steps, and 3 Adam steps
    held against the CPU; (e) a demixing episode written as TABLE.sct
    Measurement Sets, then ``evaluate.recommend`` with the trained model
    (kernel 1 x 6, counted); (f) the hint dataset, the MLP and TSK
    regressors and their live comparison; (g) the TSK influence at full
    width and the transformer influence at a reduced width; (h)
    ``evaluate_models.evaluate`` with an untrained SAC agent.  Counts are
    zeroed just before and read just after each path; the model pickles
    and the stores live in a temporary directory, deleted after."""
    import tempfile

    from smartcal_tpu_torch import prng
    from smartcal_tpu_torch.cal import ms_io
    from smartcal_tpu_torch.envs.demixing import DemixingEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.models.transformer import XYBuffer
    from smartcal_tpu_torch.ops import dft_imager
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.train import (evaluate, evaluate_models,
                                          model_influence, supervised)
    t_phase = time.perf_counter()
    K = SUP_K
    rep = {"K": K}

    # (a) the transformer dataset at the default backend
    backend = RadioBackend(device=dev)
    npix = backend.npix
    eps = FirstCall(backend, "new_demixing_episode")
    cal = FirstCall(backend, "calibrate")
    spy = FirstCall(dft_imager, "dirty_image_cuda")
    torch.cuda.synchronize(dev)
    zero_counts()
    t0 = time.perf_counter()
    try:
        buf = supervised.make_transformer_dataset(
            n_iter=SUP_SAMPLES, K=K, backend=backend, seed=0, device=dev)
    finally:
        spy.restore()
        eps.restore()
        cal.restore()
    data_s = time.perf_counter() - t0
    launches = read_counts()
    X, Y = buf.x[:SUP_SAMPLES], buf.y[:SUP_SAMPLES]
    norm_err = _features_ok(X, Y, K, npix, "transformer dataset")
    if launches["dft_imager"] != K * SUP_SAMPLES or \
            launches["hessian_blocks"] or launches["factored_imager"]:
        raise AssertionError(f"the transformer dataset launched {launches}, "
                             f"expected dft_imager x {K * SUP_SAMPLES}")
    stages = dict(backend.stage_seconds)
    rep["dataset"] = {
        "samples": SUP_SAMPLES, "seconds": data_s,
        "seconds_per_sample": data_s / SUP_SAMPLES,
        "stage_seconds_per_sample": {k: v / SUP_SAMPLES
                                     for k, v in stages.items()},
        "launches": launches, "feature_len": int(X.shape[1]),
        "labels": Y.tolist(), "block_norm_max_err": norm_err}
    print(f"supervised dataset ({SUP_SAMPLES} samples, N="
          f"{backend.n_stations}, npix {npix}, K={K}, {X.shape[1]} features "
          f"each): {data_s:.3f} s, per sample "
          + ", ".join(f"{k} {v / SUP_SAMPLES:.3f}" for k, v in stages.items())
          + f" s; labels {Y.tolist()}; launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items()), flush=True)

    # (b) kernel 1 at the path's operands
    (uv, vis, k_npix, cell), _ = spy.args
    P, R = k_npix * k_npix, uv.shape[0]
    err = check_imager(dft_imager, uv, vis, k_npix, cell, "supervised path")
    lm = dft_imager.pixel_grid(k_npix, cell, dev)
    k_ms = cuda_ms(lambda: dft_imager.dirty_image_cuda(uv, vis, k_npix,
                                                       cell), 20)
    plain_ms = cuda_ms(lambda: dft_imager.dirty_image_reference(uv, lm, vis),
                       5)
    k_ms2 = cuda_ms(lambda: dft_imager.dirty_image_cuda(uv, vis, k_npix,
                                                        cell), 20)
    rep["kernel"] = {"P": P, "R": R, "max_abs_err": err, "ms": k_ms,
                     "ms_repeat": k_ms2, "plain_ms": plain_ms,
                     **separable_bounds(k_npix, R, n_sm)}
    print(f"dft_imager at the supervised path's P={P} R={R}: kernel "
          f"{k_ms:.4f} / {k_ms2:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{rep['kernel']['bound_ms']:.4f} ms "
          f"({rep['kernel']['bound_by']})", flush=True)

    # (c) one sample's featurization, card against CPU, on the card's solve
    ep, mdl = eps.result
    rep["gpu_vs_cpu"] = _featurization_gpu_vs_cpu(dev, ep, mdl, cal.result,
                                                  backend)
    del ep, mdl, eps, cal, spy

    # (d) balance, then the full-width transformer
    bal = supervised.balance_xy_buffer(buf, seed=0)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    params, hist = supervised.train_transformer(bal, K=K, epochs=SUP_EPOCHS,
                                                device=dev)
    torch.cuda.synchronize(dev)
    train_s = time.perf_counter() - t0
    model, losses = hist["model"], hist["losses"]
    n_params = sum(p.numel() for p in params.values())
    peak = torch.cuda.max_memory_allocated(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    xb = torch.as_tensor(bal.x[:8], device=dev)
    yb = torch.as_tensor(bal.y[:8], device=dev)
    step_ms = cuda_ms(lambda: supervised.transformer_step(
        model, hist["opt"], xb, yb, 1e-3, generator=g), 10)
    if any(read_counts().values()):
        raise AssertionError(f"training launched {read_counts()}")
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"transformer loss {first} -> {last}")
    rep["train"] = {
        "balanced_samples": int(bal.mem_cntr), "epochs": SUP_EPOCHS,
        "input_dim": model.input_dim, "model_dim": model.model_dim,
        "heads": model.num_heads, "parameters": n_params,
        "seconds": train_s, "ms_per_step": 1e3 * train_s / SUP_EPOCHS,
        "step_ms_cuda_events": step_ms, "peak_mem_bytes": peak,
        "loss_first20": first, "loss_last20": last}
    print(f"transformer (input {model.input_dim}, model_dim "
          f"{model.model_dim}, {model.num_heads} heads, {n_params} "
          f"parameters) on {bal.mem_cntr} balanced samples: {SUP_EPOCHS} "
          f"steps {train_s:.3f} s ({1e3 * train_s / SUP_EPOCHS:.2f} ms per "
          f"step with the init; {step_ms:.2f} ms per step by CUDA events); "
          f"loss {first:.4f} -> {last:.4f}; peak {peak / 2**20:.0f} MiB",
          flush=True)
    rep["train"]["gpu_vs_cpu"] = _transformer_gpu_vs_cpu(
        dev, model, hist["opt"], bal)

    with tempfile.TemporaryDirectory() as tmp:
        # (e) a demixing episode as TABLE.sct stores, then recommend
        ep, _ = backend.new_demixing_episode(prng.PRNGKey(11), K)
        mslist = ms_io.observation_to_ms_set(tmp, ep.obs, ep.V)
        if not all(ms_io.is_sct_ms(m) and not os.path.exists(
                os.path.join(m, ms_io.MAIN)) for m in mslist):
            raise AssertionError(f"the stores are not TABLE.sct: {mslist}")
        times = ep.obs.times.cpu().numpy()
        timesec = float(times[-1] - times[0]) + 1.0     # every slot
        evaluate.save_model(os.path.join(tmp, "net.pkl"), params, K=K,
                            npix=npix, model_dim=66)
        del params, model, hist
        torch.cuda.empty_cache()
        stages = {}
        torch.cuda.synchronize(dev)
        zero_counts()
        t0 = time.perf_counter()
        probs = evaluate.recommend(mslist, timesec,
                                   os.path.join(tmp, "net.pkl"), tdelta=10,
                                   workdir=tmp, device=dev,
                                   stage_seconds=stages)
        rec_s = time.perf_counter() - t0
        rec_launches = read_counts()
    if rec_launches["dft_imager"] != K or probs.shape != (K - 1,) \
            or not np.all((probs >= 0) & (probs <= 1)):
        raise AssertionError(f"recommend: launches {rec_launches}, "
                             f"probabilities {probs}")
    rep["recommend"] = {"seconds": rec_s, "stage_seconds": stages,
                        "launches": rec_launches,
                        "probabilities": probs.tolist(),
                        "stores": "TABLE.sct", "timesec": timesec}
    print(f"recommend on {len(mslist)} TABLE.sct stores: {rec_s:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + f"); probabilities {np.round(probs, 4).tolist()}; launches "
          + ", ".join(f"{k} {v}" for k, v in rec_launches.items()),
          flush=True)

    # (f) the regressors on the hint dataset.  The hint backend is the
    # demixing env's at a third of its depth (SUP_HINT_ADMM) with the
    # sweep's 32 selections in one batched solve (SUP_HINT_BATCH): 4x less
    # than 8 at a time at N=14 (PERF.md section 7), the same algorithm
    hb = RadioBackend(admm_iters=SUP_HINT_ADMM, hint_batch=SUP_HINT_BATCH,
                      device=dev)
    zero_counts()
    t0 = time.perf_counter()
    hbuf = supervised.make_hint_dataset(n_iter=SUP_HINT_SAMPLES, K=K,
                                        backend=hb, seed=0, device=dev)
    hint_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mlp_params, mlp = supervised.train_regressor(hbuf, n_iter=SUP_MLP_ITERS,
                                                 device=dev)
    mlp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    tsk = supervised.train_tsk_on_buffer(hbuf, n_iter=SUP_TSK_ITERS,
                                         device=dev)
    tsk_s = time.perf_counter() - t0
    env = DemixingEnv(K=K, provide_hint=True, backend=hb, seed=1,
                      device=dev)
    t0 = time.perf_counter()
    rewards = supervised.evaluate_tsk_msp(hbuf, mlp_params, mlp["net"],
                                          tsk["params"], env, episodes=1)
    msp_s = time.perf_counter() - t0
    reg_launches = read_counts()
    if not all(np.isfinite(v).all() for v in rewards.values()) or \
            not np.isfinite([mlp["test_mse"], tsk["test_mse"]]).all() or \
            any(reg_launches.values()):
        raise AssertionError(f"regressors: rewards {rewards}, launches "
                             f"{reg_launches}")
    rep["regressors"] = {
        "hint_dataset_seconds": hint_s, "hint_samples": SUP_HINT_SAMPLES,
        "mlp_seconds": mlp_s, "mlp_iters": SUP_MLP_ITERS,
        "mlp_test_mse": mlp["test_mse"], "tsk_seconds": tsk_s,
        "tsk_iters": SUP_TSK_ITERS, "tsk_test_mse": tsk["test_mse"],
        "evaluate_tsk_msp_seconds": msp_s, "rewards": rewards,
        "launches": reg_launches}
    print(f"regressors: hint dataset {SUP_HINT_SAMPLES} samples "
          f"{hint_s:.3f} s; MLP {SUP_MLP_ITERS} iterations {mlp_s:.3f} s "
          f"(test MSE {mlp['test_mse']:.4f}); TSK {SUP_TSK_ITERS} "
          f"iterations {tsk_s:.3f} s (test MSE {tsk['test_mse']:.4f}); "
          f"evaluate_tsk_msp 1 episode {msp_s:.3f} s, rewards "
          + ", ".join(f"{k} {v[0]:.4f}" for k, v in rewards.items()),
          flush=True)

    # (g) the model influences
    rng = np.random.default_rng(0)
    M = 3 * K + 2
    Xi = rng.standard_normal((20, M)).astype(np.float32)
    Yi = np.tanh(Xi[:, :K - 1]).astype(np.float32)
    zero_counts()
    t0 = time.perf_counter()
    tsk_if = model_influence.tsk_influence(tsk["params"], Xi, Yi,
                                           n_avg=SUP_TSK_N_AVG, device=dev)
    tsk_if_s = time.perf_counter() - t0
    red = SUP_INFLUENCE
    rnpix, nout = red["npix"], red["npix"] ** 2 + 8
    ibuf = XYBuffer(red["samples"], (K * nout,), (K - 1,))
    for _ in range(red["samples"]):
        ibuf.store(rng.standard_normal(K * nout).astype(np.float32),
                   (rng.random(K - 1) > 0.5).astype(np.float32))
    t0 = time.perf_counter()
    iparams, ihist = supervised.train_transformer(
        ibuf, K=K, model_dim=red["model_dim"], epochs=30, batch_size=4,
        device=dev)
    If, maps = model_influence.transformer_influence(
        iparams, ihist["model"], ibuf, K=K, npix=rnpix,
        warmup_epochs=red["warmup_epochs"], device=dev)
    tr_if_s = time.perf_counter() - t0
    inf_launches = read_counts()
    if tsk_if.shape != (K - 1, M) or not np.isfinite(tsk_if).all() or \
            If.shape != (K - 1, K * nout) or not np.isfinite(If).all() or \
            any(inf_launches.values()):
        raise AssertionError(f"model influence: {tsk_if.shape} "
                             f"{If.shape}, launches {inf_launches}")
    rep["influence"] = {
        "tsk_seconds": tsk_if_s, "tsk_n_avg": SUP_TSK_N_AVG,
        "tsk_shape": [K - 1, M],
        "transformer_seconds": tr_if_s,
        "transformer_shape": [K - 1, K * nout],
        "transformer_parameters": sum(p.numel() for p in iparams.values()),
        "reduced": {**red, "K": K, "why": "the (P, N) cross derivative is "
                    "~40.0M x 98,352 floats at the default width (npix 128,"
                    " model_dim 66): neither package can hold it"},
        "launches": inf_launches}
    n_p = rep["influence"]["transformer_parameters"]
    print(f"model influence: TSK (M={M}, n_avg {SUP_TSK_N_AVG}) "
          f"{tsk_if_s:.3f} s; "
          f"transformer (reduced: npix {rnpix}, model_dim "
          f"{red['model_dim']}x{K}, {n_p} parameters x {K * nout} inputs, "
          f"{red['warmup_epochs']} warm-up epochs) {tr_if_s:.3f} s",
          flush=True)
    del iparams, ihist, If, maps

    # (h) evaluate_models with an untrained SAC agent
    cfg = sac.SACConfig(obs_dim=npix * npix + M, n_actions=K,
                        batch_size=256, mem_size=4096, alpha=0.03,
                        img_shape=(npix, npix))
    zero_counts()
    t0 = time.perf_counter()
    res = evaluate_models.evaluate(env, {"untrained": sac.SACAgent(
        cfg, device=dev)}, n_steps=1, n_games=1, quiet=True)
    em_s = time.perf_counter() - t0
    em_launches = read_counts()
    if not all(np.isfinite(v).all() for v in res.values()) or \
            any(em_launches.values()):
        raise AssertionError(f"evaluate_models: {res}, {em_launches}")
    rep["evaluate_models"] = {"seconds": em_s, "games": 1, "steps": 1,
                              "results": {k: [float(x) for x in v]
                                          for k, v in res.items()},
                              "launches": em_launches}
    env.close()
    rep["phase_seconds"] = time.perf_counter() - t_phase
    print(f"evaluate_models (1 game x 1 step, untrained SAC): {em_s:.3f} s, "
          + ", ".join(f"{k} {v[0]:.4f}" for k, v in res.items())
          + f"; supervised phase {rep['phase_seconds']:.1f} s", flush=True)
    return rep


RT_N62 = ["--stations", "62", "--steps", "1", "--use_hint", "--seed", "0",
          "--quiet"]
RT_ENET = ["--steps", "2", "--use_hint", "--seed", "0", "--quiet"]
RT_TRACE = ["--small", "--M", "3", "--episodes", "1", "--steps", "1",
            "--use_hint", "--seed", "0", "--quiet"]
# the NaN of the rollback check: update 3 is episode 1's second learn call
RT_FAULT = {"nan_field": "critic_loss", "nan_step": 3}
FULL_RING = 10000                         # calib_sac's mem_size


def _payload_diff(a, b, path=""):
    """The paths at which two checkpoint payloads differ (bit for bit)."""
    if isinstance(a, dict):
        if set(a) != set(b):
            return [f"{path} keys"]
        return [d for k in a for d in _payload_diff(a[k], b[k],
                                                    f"{path}/{k}")]
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return [f"{path} length"]
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in _payload_diff(x, y, f"{path}[{i}]")]
    x, y = np.asarray(a), np.asarray(b)
    if x.shape != y.shape or x.dtype != y.dtype or not np.array_equal(
            x, y, equal_nan=x.dtype.kind == "f"):
        return [path]
    return []


def _run_events(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def _stage_shares(events, stage_seconds):
    """Per backend stage: the run log's span seconds (the ``synced``
    spans) and ``stage_seconds``, each as a share of the episode spans."""
    spans = [e for e in events if e["event"] == "span"]
    episodes = sum(e["dur_s"] for e in spans if e["path"] == "episode")
    by_name = {}
    for e in spans:
        if e.get("synced"):
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur_s"]
    span_of = {"hint": "hint_sweep", "sigmas": "reward"}
    out = {}
    for stage, sec in stage_seconds.items():
        log_s = by_name.get(span_of.get(stage, stage), 0.0)
        out[stage] = {"log_s": log_s, "stage_seconds": sec,
                      "log_share": log_s / episodes if episodes else None,
                      "stage_share": sec / episodes if episodes else None}
    return episodes, out


def diag_agent(dev, mem=256):
    """The calibration SAC agent (128² image, M=10, batch 32) on a ring of
    ``mem`` random transitions, after 3 learns (Adam history)."""
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.train import calib_sac

    cfg = dataclasses.replace(calib_sac.agent_config(128, 10, True),
                              mem_size=mem)
    agent = sac.SACAgent(cfg, seed=0, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    for v in agent.buffer.data.values():
        if v.dtype == torch.bool:
            v.zero_()
        else:
            v.copy_(torch.rand(v.shape, generator=g, device=dev))
    agent.buffer.priority.fill_(1.0)
    agent.buffer.cntr = mem
    for _ in range(3):
        agent.learn()
    return agent


def diag_identity(dev, agent, steps=3):
    """Learn ``steps`` times from copies of ``agent``'s state on the same
    draws: diagnostics off, off again, and on.  Returns whether off equals
    off (the learn step is deterministic) and on equals off, with the
    first paths that part."""
    from smartcal_tpu_torch.rl import sac

    states = []
    for collect in (False, False, True):
        st = agent.state.copy_to(dev)
        gen = torch.Generator(device=dev).manual_seed(9)
        for _ in range(steps):
            sac.learn(agent.cfg, st, agent.buffer, gen, collect_diag=collect)
        states.append(st.to_host())
    straight = _payload_diff(states[0], states[1])
    diag = _payload_diff(states[0], states[2])
    return {"straight_identical": not straight, "straight_diff": straight,
            "diag_identical": not diag, "diag_diff": diag}


def diag_determinism_main():
    """``--diag-determinism``: :func:`diag_identity` under
    ``torch.use_deterministic_algorithms(True)`` (the caller sets
    CUBLAS_WORKSPACE_CONFIG); prints its result as the last line."""
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    out = diag_identity(dev, diag_agent(dev))
    out["cublas_workspace_config"] = os.environ.get(
        "CUBLAS_WORKSPACE_CONFIG")
    print(json.dumps(out))
    return 0


def runtime_phase(dev, out_dir, zero_counts, read_counts):
    """The runtime slice on the card: calib_sac at N=62 (kernel 1) with
    --metrics --diag --watchdog --ckpt-every 1 for 2 episodes of 1 step,
    then 1 episode and a --resume to 2, held against the straight run bit
    for bit (scores, parameters, Adam moments, ring and priorities,
    generator state, env key); enet_sac (M = N = 20) killed and resumed,
    and rolled back from an injected NaN under --max-recoveries 1;
    save_checkpoint / load_latest of a full 10,000-transition N=62 ring;
    the run log's stage shares beside stage_seconds; the diag overhead
    per learn; last, a 1-step --trace run whose trace must hold the
    spans.  Checkpoints, the full ring and the trace go to a temporary
    directory that is removed."""
    import shutil
    import tempfile

    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.obs import costs, diag_to_host
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.runtime import checkpoint, faults
    from smartcal_tpu_torch.train import calib_sac, enet_sac

    tmp = tempfile.mkdtemp(prefix="runtime_phase_")
    out = {}
    t_phase = time.perf_counter()
    try:
        # -- calib_sac at N=62: straight, then killed after 1 and resumed --
        straight = os.path.join(tmp, "straight")
        resumed = os.path.join(tmp, "resumed")
        run_log = os.path.join(out_dir, "runtime_calib_sac_run.jsonl")
        if os.path.exists(run_log):
            os.remove(run_log)
        timer = StepTimer(CalibEnv)
        # --diag counts each stage's cost once (obs.costs, between
        # episodes): timed apart, so the run stays comparable with the
        # runs from before the counts
        flush_s, real_flush = [], costs.flush_pending

        def timed_flush():
            t = time.perf_counter()
            n = real_flush()
            torch.cuda.synchronize(dev)
            flush_s.append(time.perf_counter() - t)
            return n

        costs.flush_pending = timed_flush
        zero_counts()
        t0 = time.perf_counter()
        try:
            s_a = calib_sac.main(RT_N62 + [
                "--episodes", "2", "--prefix", straight + "/c", "--metrics",
                run_log, "--diag", "--watchdog", "--ckpt-every", "1",
                "--ckpt-dir", straight + "/ck"])
        finally:
            timer.restore()
            costs.flush_pending = real_flush
        straight_s = time.perf_counter() - t0
        launches = read_counts()
        # one image per band per env call: the data image of a reset, the
        # residual image of a step
        want = timer.env.backend.n_freqs * (len(timer.seconds) + 2)
        if launches["dft_imager"] < want:
            raise AssertionError(f"dft_imager launched {launches} on the "
                                 f"runtime path, expected >= {want}")
        t0 = time.perf_counter()
        s_b1 = calib_sac.main(RT_N62 + [
            "--episodes", "1", "--prefix", resumed + "/c", "--ckpt-every",
            "1", "--ckpt-dir", resumed + "/ck"])
        s_b = calib_sac.main(RT_N62 + [
            "--episodes", "2", "--prefix", resumed + "/c", "--resume",
            "--ckpt-every", "1", "--ckpt-dir", resumed + "/ck"])
        resume_s = time.perf_counter() - t0
        pa, step_a = checkpoint.load_latest(straight + "/ck")
        pb, step_b = checkpoint.load_latest(resumed + "/ck")
        diff = _payload_diff(pa, pb)
        if step_a != 2 or step_b != 2 or s_a != s_b or s_a[:1] != s_b1:
            raise AssertionError(f"calib_sac N=62 resume: scores {s_a} "
                                 f"against {s_b} (first run {s_b1}), steps "
                                 f"{step_a} {step_b}")
        if diff:
            raise AssertionError(f"calib_sac N=62 resume differs from the "
                                 f"straight run at {diff[:10]}")
        events = _run_events(run_log)
        kinds = {e["event"] for e in events}
        for k in ("run_header", "span", "solver", "diag", "replay_health",
                  "checkpoint", "episode", "run_end"):
            if k not in kinds:
                raise AssertionError(f"runtime run log has no {k} event")
        ep_s, shares = _stage_shares(
            events, dict(timer.env.backend.stage_seconds))
        ckpt_spans = [e["dur_s"] for e in events if e["event"] == "span"
                      and e["name"] == "checkpoint"]
        solver_ev = [e for e in events if e["event"] == "solver"]
        out["calib_sac_n62"] = {
            "args": RT_N62, "scores": s_a, "resumed_scores": s_b,
            "bit_identical": True, "deterministic_algorithms": False,
            "straight_seconds": straight_s,
            "cost_count_seconds": sum(flush_s),
            "straight_seconds_without_cost_counts": straight_s - sum(flush_s),
            "resume_seconds": resume_s,
            "launches": launches, "checkpoint_span_s": ckpt_spans,
            "payload_bytes": json.load(open(os.path.join(
                straight, "ck", "ckpt_000002", "meta.json")))["payload_bytes"],
            "episode_span_s": ep_s, "stage_shares": shares,
            "solver_events": len(solver_ev),
            "phi_evals_per_linesearch": [e["phi_evals_per_linesearch"]
                                         for e in solver_ev],
            "lbfgs_iters_total": [e["lbfgs_iters_total"]
                                  for e in solver_ev]}
        print(f"runtime: calib_sac N=62 straight 2x1 with --metrics --diag "
              f"--watchdog --ckpt-every 1 {straight_s:.3f} s "
              f"({straight_s - sum(flush_s):.3f} s without the "
              f"{sum(flush_s):.3f} s of obs.costs counts), 1 + --resume "
              f"to 2 {resume_s:.3f} s; scores "
              + ", ".join(f"{x:.6f}" for x in s_a)
              + " both ways; checkpoints bit-identical (agent state, Adam "
              "moments, generator, ring + priorities, env key) without "
              f"deterministic algorithms; dft_imager {launches['dft_imager']}"
              f" launches; checkpoint spans "
              + ", ".join(f"{x:.3f}" for x in ckpt_spans) + " s", flush=True)
        print("runtime: stage shares of the episode spans (run log "
              "synced spans | stage_seconds): "
              + ", ".join(f"{k} {v['log_share']:.3f} | "
                          f"{v['stage_share']:.3f}"
                          for k, v in shares.items())
              + f" (episodes {ep_s:.3f} s)", flush=True)
        del pa, pb

        # -- enet_sac M = N = 20: kill/resume, and the NaN rollback --------
        def enet(tag, episodes, extra=()):
            return enet_sac.main(RT_ENET + ["--episodes", str(episodes),
                                            "--prefix", f"{tmp}/{tag}_",
                                            "--ckpt-dir", f"{tmp}/{tag}_ck"]
                                 + list(extra))

        t0 = time.perf_counter()
        e_a = enet("ea", 2, ["--ckpt-every", "2"])
        enet("eb", 1, ["--ckpt-every", "1"])
        e_b = enet("eb", 2, ["--resume", "--ckpt-every", "2"])
        ediff = _payload_diff(checkpoint.load_latest(f"{tmp}/ea_ck")[0],
                              checkpoint.load_latest(f"{tmp}/eb_ck")[0])
        enet_resume_s = time.perf_counter() - t0
        if ediff or e_a["final_avg_score"] != e_b["final_avg_score"]:
            raise AssertionError(f"enet_sac resume differs at {ediff[:10]}")
        enet_log = os.path.join(out_dir, "runtime_enet_rollback_run.jsonl")
        if os.path.exists(enet_log):
            os.remove(enet_log)
        os.environ["SMARTCAL_FAULTS"] = json.dumps(RT_FAULT)
        t0 = time.perf_counter()
        try:
            e_r = enet("er", 2, ["--ckpt-every", "1", "--max-recoveries",
                                 "1", "--recovery-lr-shrink", "1.0",
                                 "--no-recovery-reseed", "--metrics",
                                 enet_log])
        finally:
            del os.environ["SMARTCAL_FAULTS"]
            faults.clear()
        rollback_s = time.perf_counter() - t0
        ev = _run_events(enet_log)
        rec = [e for e in ev if e["event"] == "recovery"]
        eps = [e["episode"] for e in ev if e["event"] == "episode"]
        if (not rec or rec[0]["action"] != "rollback"
                or not any(e["event"] == "watchdog_trip" for e in ev)
                or eps != [0, 1]
                or e_r["final_avg_score"] != e_a["final_avg_score"]):
            raise AssertionError(f"enet NaN rollback: recovery {rec}, "
                                 f"episodes {eps}, score "
                                 f"{e_r['final_avg_score']} against "
                                 f"{e_a['final_avg_score']}")
        out["enet_sac"] = {"resume_bit_identical": True,
                           "resume_seconds": enet_resume_s,
                           "rollback": rec[0], "rollback_episodes": eps,
                           "rollback_seconds": rollback_s,
                           "score": e_a["final_avg_score"]}
        print(f"runtime: enet_sac M=N=20 2x2 killed after 1 and resumed, "
              f"bit-identical ({enet_resume_s:.3f} s for the three runs); "
              f"NaN at update {RT_FAULT['nan_step']} tripped the watchdog, "
              f"rolled back to episode {rec[0]['rollback_step']} and "
              f"finished equal to the run without it (episodes {eps}, "
              f"{rollback_s:.3f} s)", flush=True)

        # -- checkpoint save / load of a full N=62 ring ---------------------
        cfg = dataclasses.replace(calib_sac.agent_config(128, 10, True),
                                  mem_size=FULL_RING)
        agent = sac.SACAgent(cfg, seed=0, device=dev)
        buf = agent.buffer
        g = torch.Generator(device=dev).manual_seed(3)
        for k, v in buf.data.items():
            if v.dtype == torch.bool:
                v.copy_(torch.rand(v.shape, generator=g, device=dev) < 0.1)
            else:
                v.copy_(torch.rand(v.shape, generator=g, device=dev))
        buf.priority.copy_(torch.rand(FULL_RING, generator=g, device=dev))
        buf.cntr = FULL_RING + 7
        torch.cuda.synchronize(dev)
        from smartcal_tpu_torch.train.blocks import pack_agent_loop
        root = os.path.join(tmp, "full_ring")
        t0 = time.perf_counter()
        payload = pack_agent_loop(agent, None, [0.0], 1)
        pack_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        checkpoint.save_checkpoint(root, 1, payload)
        save_s = time.perf_counter() - t0
        nbytes = json.load(open(os.path.join(root, "ckpt_000001",
                                             "meta.json")))["payload_bytes"]
        del payload
        t0 = time.perf_counter()
        loaded, _ = checkpoint.load_latest(root)
        load_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = checkpoint.unpack_replay(loaded["replay"], dev)
        torch.cuda.synchronize(dev)
        unpack_s = time.perf_counter() - t0
        same = (back.cntr == buf.cntr and torch.equal(back.priority,
                                                      buf.priority)
                and all(torch.equal(back.data[k], v)
                        for k, v in buf.data.items()))
        if not same:
            raise AssertionError("the full ring did not survive its "
                                 "checkpoint")
        del loaded, back, buf, agent
        shutil.rmtree(root)
        torch.cuda.empty_cache()
        out["full_ring_checkpoint"] = {
            "transitions": FULL_RING, "payload_bytes": nbytes,
            "pack_s": pack_s, "save_s": save_s, "load_s": load_s,
            "unpack_s": unpack_s}
        print(f"runtime: full N=62 ring ({FULL_RING} transitions, "
              f"{nbytes / 2**30:.3f} GiB payload with the agent): pack "
              f"{pack_s:.3f} s, save_checkpoint (pickle, sha256, fsync) "
              f"{save_s:.3f} s, load_latest (sha256, unpickle) "
              f"{load_s:.3f} s, unpack to the card {unpack_s:.3f} s; "
              "survived bit for bit", flush=True)

        # -- diag overhead per learn and the on/off bit identity -----------
        agent = diag_agent(dev)
        ident = diag_identity(dev, agent)
        if not ident["straight_identical"]:
            # the learn step itself differs run to run on the card: find
            # the first tensors that part, and hold diag on/off under
            # deterministic algorithms in a child process (cuBLAS reads
            # CUBLAS_WORKSPACE_CONFIG when it starts)
            env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
            child = subprocess.run(
                [sys.executable, os.path.abspath(__file__),
                 "--diag-determinism"], capture_output=True, text=True,
                env=env, timeout=600)
            lines = child.stdout.strip().splitlines()
            if child.returncode != 0 or not lines:
                raise AssertionError(f"deterministic diag check failed: "
                                     f"{child.stderr[-2000:]}")
            ident["deterministic"] = json.loads(lines[-1])
            det = ident["deterministic"]
            if not (det["straight_identical"] and det["diag_identical"]):
                raise AssertionError(f"collect_diag changed the learn step "
                                     f"under deterministic algorithms: "
                                     f"{det}")
        elif not ident["diag_identical"]:
            raise AssertionError(f"collect_diag changed the learn step on "
                                 f"the card at {ident['diag_diff'][:10]}")
        print(f"runtime: learn steps from one state, 3 each: diag off "
              f"against off {'bit-identical' if ident['straight_identical'] else 'parted at ' + str(ident['straight_diff'][:6])}"
              f"; diag on against off "
              + ("bit-identical" if ident["diag_identical"] else
                 "parted as above")
              + ("" if ident["straight_identical"] else
                 f"; under torch.use_deterministic_algorithms(True) "
                 f"(CUBLAS_WORKSPACE_CONFIG=:4096:8, child process): off "
                 f"against off and on against off bit-identical"),
              flush=True)

        def learn_plain():
            agent.collect_diag = False
            agent.learn()

        def learn_diag():
            agent.collect_diag = True
            agent.learn()
            diag_to_host(agent.last_diag)      # the run's host sync

        plain_ms = cuda_ms(learn_plain, 20, warmup=3)
        diag_ms = cuda_ms(learn_diag, 20, warmup=3)
        plain_ms2 = cuda_ms(learn_plain, 20, warmup=3)
        diag_ms2 = cuda_ms(learn_diag, 20, warmup=3)
        del agent
        torch.cuda.empty_cache()
        out["diag_overhead"] = {
            "learn_ms": [plain_ms, plain_ms2],
            "learn_diag_ms": [diag_ms, diag_ms2],
            "overhead_ms": min(diag_ms, diag_ms2) - min(plain_ms, plain_ms2),
            "identity": ident}
        print(f"runtime: learn (batch 32, 128² image, M=10) "
              f"{plain_ms:.3f} / {plain_ms2:.3f} ms, with --diag (UpdateDiag "
              f"+ its host sync) {diag_ms:.3f} / {diag_ms2:.3f} ms (CUDA "
              f"events, median of 20, two runs): "
              f"{out['diag_overhead']['overhead_ms']:.3f} ms per learn",
              flush=True)

        # -- last: a 1-step --trace run (the profiler session stays) --------
        trace = os.path.join(tmp, "trace")
        zero_counts()
        t0 = time.perf_counter()
        calib_sac.main(RT_TRACE + ["--prefix", tmp + "/t", "--trace", trace])
        trace_s = time.perf_counter() - t0
        trace_launches = read_counts()
        tpath = os.path.join(trace, "calib_sac_trace.json")
        with open(tpath) as fh:
            names = {e.get("name") for e in json.load(fh).get(
                "traceEvents", [])}
        want = {"episode", "episode_reset", "episode_step", "solve",
                "influence", "images"}
        if not want <= names:
            raise AssertionError(f"the trace lacks spans {want - names}")
        tlog = _run_events(os.path.join(trace, "calib_sac_run.jsonl"))
        if not any(e["event"] == "trace" for e in tlog):
            raise AssertionError("no trace event beside the trace")
        out["trace"] = {"args": RT_TRACE, "seconds": trace_s,
                        "bytes": os.path.getsize(tpath),
                        "spans_found": sorted(want),
                        "launches": trace_launches}
        print(f"runtime: --trace run (calib_sac {' '.join(RT_TRACE)}) "
              f"{trace_s:.3f} s, trace {os.path.getsize(tpath) / 2**20:.1f} "
              f"MiB holds the spans {sorted(want)}; dft_imager "
              f"{trace_launches['dft_imager']} launches", flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = out["calib_sac_n62"]["launches"]
    out["phase_seconds"] = time.perf_counter() - t_phase
    return out


# -- the rest of the runtime slice: the host-segmented solve and the
# ladder, the native replay, the perf gate, --deterministic, stage costs ---

RR_TIER = N62                       # (a): the reference backend
RR_M, RR_K = 10, 5
# (b): the ladder on the tiny tier (a fused solve, one boosted retry and
# the host rung: three solves, then SolverDegradedError)
RR_LADDER = dict(TINY, solver_max_retries=1)
# (c): the N=62 calibration transition (128² image + 11 x 7 sky, 20
# actions); power-of-two rings for the sum tree
RR_PER_SIZE, RR_PER_BATCH, RR_PER_SAMPLES = 2048, 32, 50
RR_AGENT_MEM, RR_LEARNS = 256, 20
# a delay about the tiny solve's ~0.3 s rep, in every timed rep
RR_GATE_DELAY_S = 0.3
# the gate on the card, 3 timed reps a stage (its default 5): a FIRE needs
# the mean 40% up and the bootstrap CI's low end past +15%
RR_GATE_ARGS = ["--samples", "3"]
# (e)/(f): the cheapest trainer that learns: demix_fuzzy_sac on the tiny
# tier with the influence map (the CNN whose cuDNN backward is not
# deterministic by default), batch 1, 2 steps per episode: 2 learns in
# the first episode, then the kill
RR_FUZZY_STEPS = 2
RR_FUZZY = ["--small", "--K", "3", "--batch_size", "1", "--memory", "64",
            "--warmup", "0", "--use_influence", "--steps",
            str(RR_FUZZY_STEPS), "--seed", "0", "--quiet", "--deterministic"]
# the JAX host-vs-fused tolerances (tests/test_cal_backend.py:218-261)
RR_HOST_TOL = {"J": (2e-3, 2e-4), "residual": (2e-3, 2e-3),
               "sigma_res": (1e-3, 0.0)}


def _rr_solve(backend, ep, rho, mask, host, admm_iters=None):
    """One ``backend.calibrate`` on the fused route or, with ``host``, under
    SMARTCAL_HOST_SOLVER=1; returns (result, seconds)."""
    old = os.environ.get("SMARTCAL_HOST_SOLVER")
    os.environ["SMARTCAL_HOST_SOLVER"] = "1" if host else "0"
    try:
        t0 = time.perf_counter()
        res = backend.calibrate(ep, rho, mask=mask, admm_iters=admm_iters)
        return res, time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ["SMARTCAL_HOST_SOLVER"]
        else:
            os.environ["SMARTCAL_HOST_SOLVER"] = old


def _rr_within(name, got, want, rtol, atol):
    err = (got - want).abs()
    ok = bool((err <= atol + rtol * want.abs()).all())
    if not ok:
        raise AssertionError(f"host-segmented {name} beyond rtol {rtol} "
                             f"atol {atol}: max abs {float(err.max())}")
    return float(err.max())


def rr_routes(dev, out_dir):
    """(a) one N=62 episode, fused and host-segmented; (b) the ladder down
    to its host rung and SolverDegradedError under a non-finite
    visibility."""
    from smartcal_tpu_torch import obs, prng
    from smartcal_tpu_torch.cal import solver
    from smartcal_tpu_torch.envs.radio import RadioBackend

    out = {}
    log = os.path.join(out_dir, "runtime_rest_solve_run.jsonl")
    if os.path.exists(log):
        os.remove(log)
    backend = RadioBackend(device=dev, **RR_TIER)
    with obs.recording(log, flush_lines=1):
        obs.install_compile_listener()
        ep, _ = backend.new_calib_episode(prng.PRNGKey(0), RR_K, RR_M)
        mask = np.zeros(RR_M, np.float32)
        mask[:RR_K] = 1.0
        rho = np.ones(RR_M, np.float32)
        solves, turns = {}, {"fused": [], "host_segmented": []}
        # in turns (fused, host, fused): the first solve of a process pays
        # the allocator's growth
        for route in ("fused", "host_segmented", "fused"):
            c0 = obs.counters_snapshot().get("compile_events:cuda_graph", 0)
            res, sec = _rr_solve(backend, ep, rho, mask,
                                 route == "host_segmented")
            c1 = obs.counters_snapshot().get("compile_events:cuda_graph", 0)
            turns[route].append(sec)
            solves[route] = (res, sec, c1 - c0)
    ev = [e for e in _run_events(log) if e["event"] == "solver"]
    if [e["route"] for e in ev] != ["fused", "host_segmented", "fused"]:
        raise AssertionError(f"solver events {[e['route'] for e in ev]}")
    fused, host = solves["fused"][0], solves["host_segmented"][0]
    same = {k: bool(torch.equal(getattr(fused, k), getattr(host, k)))
            for k in ("J", "residual", "sigma_res", "final_cost")}
    diff = {k: float((getattr(fused, k) - getattr(host, k)).abs().max())
            for k in same}
    for r in (fused, host):
        if not (solver.result_finite(r)
                and float(r.sigma_res) < float(r.sigma_data)):
            raise AssertionError("N=62 solve not finite or sigma_res >= "
                                 "sigma_data")
    out["n62"] = {
        "config": RR_TIER, "K": RR_K,
        "seconds": turns,
        "graph_captures": {k: v[2] for k, v in solves.items()},
        "n_segments": {e["route"]: e["n_segments"] for e in ev},
        "lbfgs_iters_total": {e["route"]: e["lbfgs_iters_total"]
                              for e in ev},
        "bit_identical": same, "max_abs_diff": diff,
        "sigma_res": {k: float(v[0].sigma_res) for k, v in solves.items()}}
    print(f"runtime_rest: N=62 solve (K={RR_K} of M={RR_M}) in turns, s: "
          f"fused {turns['fused'][0]:.3f}, host-segmented "
          f"{turns['host_segmented'][0]:.3f}, fused "
          f"{turns['fused'][1]:.3f}; segments "
          f"{out['n62']['n_segments']}, CUDA-graph captures "
          f"{out['n62']['graph_captures']}; sigma_res "
          f"{float(fused.sigma_res):.9g} / {float(host.sigma_res):.9g}; "
          f"bit-identical {same}", flush=True)
    if not all(same.values()):
        # report by how much, then hold at JAX's tolerances where the
        # solve is not chaotic (admm_iters=2)
        held = {}
        pair = [_rr_solve(backend, ep, rho, mask, h, admm_iters=2)[0]
                for h in (False, True)]
        for k, (rtol, atol) in RR_HOST_TOL.items():
            held[k] = _rr_within(k, getattr(pair[1], k),
                                 getattr(pair[0], k), rtol, atol)
        out["n62"]["held_at_admm_iters_2"] = held
        print(f"runtime_rest: not the same bits (max abs {diff}); at "
              f"admm_iters=2 within JAX's host-vs-fused tolerances: {held}",
              flush=True)
    del ep, fused, host, solves, backend

    # (b) the ladder under a non-finite visibility, data that both routes
    # read: the fused solve, one boosted retry, the host rung (the same
    # math, so as non-finite), then SolverDegradedError
    log = os.path.join(out_dir, "runtime_rest_ladder_run.jsonl")
    if os.path.exists(log):
        os.remove(log)
    backend = RadioBackend(device=dev, **RR_LADDER)
    with obs.recording(log, flush_lines=1):
        ep, _ = backend.new_calib_episode(prng.PRNGKey(1), 2, 3)
        V = ep.V.clone()
        V[0, 0, 0, 0, 0, 0] = float("nan")
        t0 = time.perf_counter()
        try:
            backend.calibrate(ep._replace(V=V), np.ones(3, np.float32))
            raised = None
        except solver.SolverDegradedError as e:
            raised = str(e)
        ladder_s = time.perf_counter() - t0
    deg = [e["route"] for e in _run_events(log)
           if e["event"] == "solver_degraded"]
    if deg != ["retry_rho", "host_segmented"] or raised is None:
        raise AssertionError(f"ladder: degraded {deg}, raised {raised}")
    out["ladder"] = {"config": RR_LADDER, "solver_degraded": deg,
                     "raised": raised, "seconds": ladder_s}
    print(f"runtime_rest: ladder on the card ({RR_LADDER}), one "
          f"visibility NaN: solver_degraded {deg}, then SolverDegradedError "
          f"({ladder_s:.3f} s: the host rung gives the fused bits, so it "
          f"cannot rescue a non-finite solve)", flush=True)
    return out


def _rr_transition(rng, obs_dim, n_actions):
    return {"state": rng.random(obs_dim, dtype=np.float32),
            "action": rng.uniform(-1, 1, n_actions).astype(np.float32),
            "reward": np.float32(rng.random()),
            "new_state": rng.random(obs_dim, dtype=np.float32),
            "done": bool(rng.random() < 0.1),
            "hint": np.zeros(n_actions, np.float32)}


def _rr_us(fn, n, dev):
    """Microseconds per call of ``fn(i)`` over ``n`` calls, host clock,
    the device drained before and after."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    torch.cuda.synchronize(dev)
    return 1e6 * (time.perf_counter() - t0) / n


def rr_replay(dev, tmp):
    """(c) NativePER beside the device ring at the N=62 transition spec,
    and the native SAC agent: 20 learns beside the HBM agent's, a save /
    load round trip."""
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.rl.replay_native import NativePER, to_device
    from smartcal_tpu_torch.train import blocks, calib_sac

    base = calib_sac.agent_config(RR_TIER["npix"], RR_M, True)
    spec = rp.transition_spec(base.obs_dim, base.n_actions)
    rng = np.random.default_rng(0)
    trs = [_rr_transition(rng, base.obs_dim, base.n_actions)
           for _ in range(64)]
    nat = NativePER(RR_PER_SIZE, spec)
    ring = rp.replay_init(RR_PER_SIZE, spec, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    srng = np.random.default_rng(1)
    per = {"native": {}, "device": {}}
    per["native"]["store_us"] = _rr_us(
        lambda i: nat.store(trs[i % 64]), RR_PER_SIZE, dev)
    per["device"]["store_us"] = _rr_us(
        lambda i: rp.replay_add(ring, trs[i % 64]), RR_PER_SIZE, dev)
    drawn = []

    def nat_sample(i):
        b, idx, w = nat.sample(RR_PER_BATCH, srng)
        drawn.append(idx)
        to_device(b, w, dev)

    def dev_sample(i):
        drawn.append(rp.replay_sample_per(ring, RR_PER_BATCH, gen)[1])

    per["native"]["sample_us"] = _rr_us(nat_sample, RR_PER_SAMPLES, dev)
    per["device"]["sample_us"] = _rr_us(dev_sample, RR_PER_SAMPLES, dev)
    err = rng.random(RR_PER_BATCH)
    err_t = torch.as_tensor(err, dtype=torch.float32, device=dev)
    per["native"]["update_us"] = _rr_us(
        lambda i: nat.update_priorities(drawn[i], err), RR_PER_SAMPLES, dev)
    per["device"]["update_us"] = _rr_us(
        lambda i: rp.replay_update_priorities(
            ring, drawn[RR_PER_SAMPLES + i], err_t, base.error_clip),
        RR_PER_SAMPLES, dev)
    health = nat.health()
    del nat, ring
    torch.cuda.empty_cache()

    agents = {}
    for name, backend in (("native", "native"), ("hbm", "hbm")):
        cfg = dataclasses.replace(base, prioritized=True,
                                  mem_size=RR_AGENT_MEM,
                                  replay_backend=backend)
        agent = sac.SACAgent(cfg, seed=0, device=dev)
        for t in trs:
            agent.store_transition(t["state"], t["action"], t["reward"],
                                   t["new_state"], t["done"], t["hint"])
        losses = []

        def learn():
            agent.learn()
            losses.append(float(agent.last_metrics["critic_loss"]))

        ms = cuda_ms(learn, RR_LEARNS, warmup=0)
        if len(losses) != RR_LEARNS or not np.all(np.isfinite(losses)):
            raise AssertionError(f"{name} agent: losses {losses}")
        agents[name] = {"learn_ms": ms, "learns": len(losses),
                        "learn_counter": agent.state.learn_counter,
                        "critic_loss_last": losses[-1]}
        if name == "hbm":
            # what deterministic algorithms cost this learn (--deterministic)
            restore = blocks.set_deterministic()
            try:
                agents[name]["learn_ms_deterministic"] = cuda_ms(
                    agent.learn, RR_LEARNS, warmup=2)
            finally:
                restore()
        if name == "native":
            prefix = os.path.join(tmp, "native_")
            agent.save_models(prefix)
            back = sac.SACAgent(cfg, seed=5, device=dev)
            if not back.load_models(prefix):
                raise AssertionError("native agent did not load")
            sd_a, sd_b = agent.buffer.state_dict(), back.buffer.state_dict()
            diff = (_payload_diff(agent.state.to_host(), back.state.to_host())
                    + _payload_diff({k: v for k, v in sd_a.items()
                                     if k != "spec"},
                                    {k: v for k, v in sd_b.items()
                                     if k != "spec"}))
            if diff or sd_a["spec"] != sd_b["spec"]:
                raise AssertionError(f"native save/load differs at "
                                     f"{diff[:10]}")
            for f in os.listdir(tmp):
                os.remove(os.path.join(tmp, f))
            agents[name]["save_load_bit_identical"] = True
            del back
        del agent
        torch.cuda.empty_cache()
    print(f"runtime_rest: PER at the N=62 transition (obs {base.obs_dim}, "
          f"{base.n_actions} actions, {RR_PER_SIZE} slots, batch "
          f"{RR_PER_BATCH}), µs per store / sample / priority update: "
          f"native {per['native']['store_us']:.1f} / "
          f"{per['native']['sample_us']:.1f} / "
          f"{per['native']['update_us']:.1f} (the sample with its copy to "
          f"the card), device ring {per['device']['store_us']:.1f} / "
          f"{per['device']['sample_us']:.1f} / "
          f"{per['device']['update_us']:.1f}; SACAgent(prioritized, "
          f"{RR_AGENT_MEM} slots) {RR_LEARNS} learns: native "
          f"{agents['native']['learn_ms']:.3f} ms, hbm "
          f"{agents['hbm']['learn_ms']:.3f} ms per learn (CUDA events, "
          f"median), hbm under deterministic algorithms "
          f"{agents['hbm']['learn_ms_deterministic']:.3f} ms; native "
          f"save_models / load_models bit-identical",
          flush=True)
    return {"per": per, "per_health": health, "agents": agents,
            "spec": {"obs_dim": base.obs_dim, "n_actions": base.n_actions,
                     "size": RR_PER_SIZE, "batch": RR_PER_BATCH}}


def rr_gate(dev, out_dir):
    """(d) the perf gate on the card: bless, gate clean, then a delay on
    the solve stage and a perturbation of the imager's numeric, each
    firing on its own stage alone."""
    from smartcal_tpu_torch.runtime import faults
    from smartcal_tpu_torch.tools import perf_gate

    store = os.path.join(out_dir, "perf_baselines_gate.json")
    if os.path.exists(store):
        os.remove(store)
    runs = {}

    def gate(tag, extra, fault=None):
        path = os.path.join(out_dir, f"perf_gate_{tag}.json")
        if fault is not None:
            os.environ["SMARTCAL_FAULTS"] = json.dumps(fault)
        t0 = time.perf_counter()
        try:
            rc = perf_gate.main(["--baseline", store, "--out", path]
                                + RR_GATE_ARGS + extra)
        finally:
            os.environ.pop("SMARTCAL_FAULTS", None)
            faults.clear()
        doc = json.load(open(path))
        runs[tag] = {"rc": rc, "seconds": time.perf_counter() - t0,
                     "median_ms": {k: v["median_ms"]
                                   for k, v in doc["stages"].items()},
                     "graph_captures_per_rep": {
                         k: v["graph_captures_per_rep"]
                         for k, v in doc["stages"].items()},
                     "compile_events": {
                         k: v["metrics"]["compile_events"]["value"]
                         for k, v in doc["stages"].items()},
                     "fired": sorted({(f["stage"], f["metric"])
                                      for f in doc["findings"]
                                      if f["verdict"] == "FIRE"})}
        return runs[tag]

    if gate("bless", ["--update-baseline"])["rc"] != 0:
        raise AssertionError(f"perf gate bless: {runs['bless']}")
    clean = gate("clean", [])
    if clean["rc"] != 0 or clean["fired"]:
        raise AssertionError(f"perf gate fired on a clean run: {clean}")
    # what the serve stages guard: a warmed batch and a publication build
    # and capture nothing
    if any(clean["compile_events"][k] for k in ("serve_batch", "publish")):
        raise AssertionError(f"perf gate serve stages compiled: {clean}")
    # both faults in one run over their stages and the influence stage:
    # each must fire on its own stage and the influence stage on none (3
    # samples: a fault is a multiple of the noise, not a fraction)
    k = 3
    hit = gate("faults", ["--samples", str(k), "--stages",
                          "solve,influence,imager"], {
        "delay_stage": "gate_solve", "delay_at": 0, "delay_span": k,
        "delay_s": RR_GATE_DELAY_S, "perturb_stage": "gate_numeric_imager",
        "perturb_at": 0, "perturb_rel": 0.5})
    fired = {}
    for stage, metric in hit["fired"]:
        fired.setdefault(stage, set()).add(metric)
    if hit["rc"] != 1 or fired.get("imager") != {"rel_err"} \
            or "wall_s" not in fired.get("solve", ()) \
            or "influence" in fired or fired.get("solve") - {"wall_s"}:
        raise AssertionError(f"perf gate faults: {hit}")
    print("runtime_rest: perf gate on the card: blessed, clean run 0 FIRE "
          "(stage medians ms "
          + ", ".join(f"{s} {v:.3f}" for s, v in clean["median_ms"].items())
          + f"; graph captures per rep {clean['graph_captures_per_rep']}); "
          f"a gate_solve delay of {RR_GATE_DELAY_S} s and gate_numeric_imager "
          f"x1.5 in one run fired {hit['fired']}; seconds per gate "
          + ", ".join(f"{t} {r['seconds']:.2f}" for t, r in runs.items()),
          flush=True)
    os.remove(store)
    return runs


def rr_deterministic(dev, out_dir, tmp):
    """(e) --deterministic on demix_fuzzy_sac: straight 2 episodes against
    1 killed + resumed to 2, bit for bit, a learn per step before the
    kill; (f)
    the straight run carries --diag --metrics: its run log must hold the
    card's roofline_peak and cost events with flops and bytes for solve,
    influence and agent_update_sac."""
    from smartcal_tpu_torch.runtime import checkpoint
    from smartcal_tpu_torch.runtime.atomic import safe_pickle_load
    from smartcal_tpu_torch.train import demix_fuzzy_sac

    log = os.path.join(out_dir, "runtime_rest_fuzzy_run.jsonl")
    if os.path.exists(log):
        os.remove(log)

    def run(tag, episodes, extra=()):
        t0 = time.perf_counter()
        scores = demix_fuzzy_sac.main(
            RR_FUZZY + ["--iteration", str(episodes), "--prefix",
                        f"{tmp}/{tag}_", "--ckpt-every", "1", "--ckpt-dir",
                        f"{tmp}/{tag}_ck"] + list(extra))
        return scores, time.perf_counter() - t0

    s_a, straight_s = run("a", 2, ["--diag", "--metrics", log])
    s_b1, killed_s = run("b", 1)
    killed_learns = int(safe_pickle_load(
        f"{tmp}/b_sac_state.pkl")["learn_counter"])
    s_b, resumed_s = run("b", 2, ["--resume"])
    # on for each run (its run header), off again after it
    header = [e for e in _run_events(log) if e["event"] == "run_header"]
    if (torch.are_deterministic_algorithms_enabled()
            or header[0].get("meta", {}).get("deterministic") is not True):
        raise AssertionError(f"--deterministic: after the runs "
                             f"{torch.are_deterministic_algorithms_enabled()}"
                             f", run header {header[0].get('meta')}")
    pa, step_a = checkpoint.load_latest(f"{tmp}/a_ck")
    pb, step_b = checkpoint.load_latest(f"{tmp}/b_ck")
    learned = int(pa["agent_state"]["learn_counter"])
    diff = _payload_diff(pa, pb)
    if (step_a != 2 or step_b != 2 or s_a != s_b or s_a[:1] != s_b1
            or killed_learns < RR_FUZZY_STEPS or diff):
        raise AssertionError(f"--deterministic resume: scores {s_a} / "
                             f"{s_b} (killed {s_b1}), steps {step_a} "
                             f"{step_b}, {killed_learns} learns before the "
                             f"kill, differs at {diff[:10]}")
    events = _run_events(log)
    peak = [e for e in events if e["event"] == "roofline_peak"]
    cost = {e["stage"]: e for e in events if e["event"] == "cost"}
    want = ("solve", "influence", "agent_update_sac")
    card = torch.cuda.get_device_name(dev)
    if (not peak or peak[0].get("device_kind") != card
            or not all(cost.get(s, {}).get("flops", 0) > 0
                       and cost.get(s, {}).get("bytes_accessed", 0) > 0
                       for s in want)):
        raise AssertionError(f"--diag run log: roofline_peak {peak}, "
                             f"costs {cost}")
    out = {"args": RR_FUZZY, "scores": s_a, "bit_identical": True,
           "learns_total": learned, "learns_before_kill": killed_learns,
           "seconds": {"straight_diag": straight_s, "killed": killed_s,
                       "resumed": resumed_s},
           "roofline_peak": peak[0],
           "cost": {s: {k: cost[s].get(k) for k in ("flops",
                                                   "bytes_accessed",
                                                   "peak_bytes")}
                    for s in sorted(cost)}}
    print(f"runtime_rest: demix_fuzzy_sac --deterministic 2 episodes x "
          f"{RR_FUZZY_STEPS} steps straight ({straight_s:.3f} s, with "
          "--diag) against 1 + "
          f"--resume to 2 ({killed_s:.3f} + {resumed_s:.3f} s): "
          f"bit-identical, {killed_learns} learns before the kill, "
          f"{learned} in all; the run log's roofline_peak "
          f"{peak[0]['device_kind']} {peak[0].get('power_limit')} and cost "
          + ", ".join(f"{s} {cost[s]['flops']:.4g} flops "
                      f"{cost[s]['bytes_accessed']:.4g} B" for s in want),
          flush=True)
    return out


# --deterministic-sweep: every trainer once under --deterministic on the
# card at the tiny tier, replay batches of 2 and no warmup so that each
# learns; --diag --metrics make every learn a diag event of the run log
DET_SWEEP = [
    ("calib_sac", ["--small", "--episodes", "2", "--steps", "2",
                   "--use_hint"]),
    ("calib_sac", ["--small", "--batch-envs", "2", "--episodes", "2",
                   "--steps", "2", "--use_hint"]),
    ("calib_td3", ["--small", "--episodes", "2", "--steps", "2",
                   "--use_hint"]),
    ("calib_ddpg", ["--small", "--episodes", "2", "--steps", "2"]),
    ("enet_sac", ["--M", "5", "--N", "5", "--episodes", "2", "--steps",
                  "2", "--use_hint"]),
    ("enet_td3", ["--M", "5", "--N", "5", "--episodes", "2", "--steps",
                  "2"]),
    ("enet_ddpg", ["--M", "5", "--N", "5", "--episodes", "2", "--steps",
                   "2"]),
    ("demix_sac", ["--small", "--K", "3", "--iteration", "2", "--steps",
                   "2", "--warmup", "0", "--use_hint"]),
    ("demix_td3", ["--small", "--K", "3", "--iteration", "2", "--steps",
                   "2", "--warmup", "0", "--batch_size", "2"]),
    ("demix_fuzzy_sac", ["--small", "--K", "3", "--iteration", "2",
                         "--steps", "2", "--warmup", "0", "--batch_size",
                         "2", "--use_influence"]),
]


def deterministic_sweep(dev, out_dir, extra=()):
    """``--deterministic-sweep``: each trainer of ``DET_SWEEP`` once with
    ``--deterministic --diag --metrics``, the agents' replay batch cut to
    2 and their warmup to 0; records per run whether it raised, its learns
    (diag events) and seconds, and fails after the sweep if any run raised
    or did not learn."""
    import importlib
    import shutil
    import tempfile

    from smartcal_tpu_torch.rl import ddpg, sac, td3

    def small(init):
        def __init__(self, *a, **kw):
            init(self, *a, **kw)
            object.__setattr__(self, "batch_size", min(self.batch_size, 2))
            if hasattr(self, "warmup"):
                object.__setattr__(self, "warmup", 0)
        return __init__

    classes = (sac.SACConfig, td3.TD3Config, ddpg.DDPGConfig)
    inits = [c.__init__ for c in classes]
    tmp = tempfile.mkdtemp(prefix="det_sweep_")
    runs = []
    try:
        for c, init in zip(classes, inits):
            c.__init__ = small(init)
        for i, (entry, argv) in enumerate(DET_SWEEP):
            mod = importlib.import_module(f"smartcal_tpu_torch.train.{entry}")
            log = os.path.join(tmp, f"{i}_run.jsonl")
            t0 = time.perf_counter()
            try:
                mod.main(argv + ["--deterministic", "--diag", "--metrics",
                                 log, "--quiet", "--prefix",
                                 os.path.join(tmp, f"{i}_")] + list(extra))
                raised = None
            except Exception as e:                  # noqa: BLE001
                raised = f"{type(e).__name__}: {e}"
            events = _run_events(log) if os.path.exists(log) else []
            runs.append({"entry": entry, "args": argv, "raised": raised,
                         "learns": sum(e["event"] == "diag" for e in events),
                         "seconds": time.perf_counter() - t0,
                         "deterministic_after": bool(
                             torch.are_deterministic_algorithms_enabled())})
            print(f"deterministic sweep: {entry} {' '.join(argv)}: "
                  f"{runs[-1]['learns']} learns, {runs[-1]['seconds']:.2f} "
                  f"s, raised {raised}", flush=True)
            torch.use_deterministic_algorithms(False)
    finally:
        for c, init in zip(classes, inits):
            c.__init__ = init
        shutil.rmtree(tmp, ignore_errors=True)
    with open(os.path.join(out_dir, "deterministic_sweep.json"), "w") as fh:
        json.dump(runs, fh, indent=1)
    bad = [r for r in runs if r["raised"] or r["learns"] < 1
           or r["deterministic_after"]]
    if bad:
        raise AssertionError(f"deterministic sweep: {bad}")
    return runs


def runtime_rest_phase(dev, out_dir, zero_counts, read_counts):
    """The rest of the runtime slice on the card, before the first
    torch.profiler session: (a) an N=62 episode solved on the fused and the
    host-segmented route, (b) the ladder's host rung, (c) the native replay
    and its agent, (d) the perf gate, (e) --deterministic kill/resume and
    (f) the --diag run's cost and roofline_peak events.  Kernel counts
    zeroed just before and read just after."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="runtime_rest_")
    t_phase = time.perf_counter()
    out = {}
    try:
        zero_counts()
        out.update(rr_routes(dev, out_dir))
        out["replay"] = rr_replay(dev, tmp)
        out["gate"] = rr_gate(dev, out_dir)
        out["deterministic"] = rr_deterministic(dev, out_dir, tmp)
        out["launches"] = read_counts()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if out["launches"]["dft_imager"] < 1:
        raise AssertionError(f"runtime_rest launched {out['launches']}")
    out["phase_seconds"] = time.perf_counter() - t_phase
    print(f"runtime_rest: phase {out['phase_seconds']:.1f} s, launches "
          f"{out['launches']}", flush=True)
    return out


# -- the mixed-precision slice: RadioBackend(precision="bf16") on the f32
# steps' own episodes and solves, and kernel 2's bf16 mode ----------------

# the bf16 kernel against its plain bf16 version: x max|plain|, a tenth of
# the band (both round the same f32 operands; trig ulps and sum order only)
BF16_PLAIN_ATOL = 2e-3


def spied_steps(env, backend, n):
    """``run_steps(env, n)`` with ``backend.influence_image`` and
    ``influence.influence_visibilities`` spied on: their first call in the
    steps keeps its arguments and its f32 result (the episode and solve of
    the first step, and band 0's visibilities and LLR)."""
    from smartcal_tpu_torch.cal import influence
    spies = {"influence_image": FirstCall(backend, "influence_image"),
             "influence_visibilities": FirstCall(influence,
                                                 "influence_visibilities")}
    try:
        obs, steps = run_steps(env, n)
    finally:
        for s in spies.values():
            s.restore()
    return obs, steps, spies


def bf16_influence(dev, label, cfg, spies, zero_counts, read_counts, store,
                   fp):
    """One influence stage call of ``RadioBackend(precision="bf16")`` on
    the episode and solve that an f32 step passed to its influence_image,
    counts zeroed just before and read just after; held to that step's f32
    image (max |bf16 - f32| / max|f32| and the relative drift of the std,
    judged against the bf16 band by obs/regress) and its band-0 LLR to the
    f32 one bit for bit.  Then the f32 route and the bf16 route again on
    the same operands, timed.  Returns the record and the operands of the
    first kernel-2 launch of the bf16 call (None without one)."""
    from smartcal_tpu_torch.cal import influence
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.obs import baselines, regress
    from smartcal_tpu_torch.ops import factored_imager
    backend = RadioBackend(device=dev, precision="bf16", **cfg)
    statics = backend._influence_statics(cfg["npix"])
    f32_call = spies["influence_image"]
    (args, kw), f32_img = f32_call.args, f32_call.result
    bspies = {"factored": FirstCall(factored_imager,
                                    "dirty_image_factored_cuda"),
              "vis": FirstCall(influence, "influence_visibilities")}
    torch.cuda.synchronize(dev)
    zero_counts()
    t0 = time.perf_counter()
    try:
        img = backend.influence_image(*args, **kw)
        torch.cuda.synchronize(dev)
    finally:
        for s in bspies.values():
            s.restore()
    seconds = time.perf_counter() - t0
    launches = read_counts()
    llr_equal = torch.equal(bspies["vis"].result.llr,
                            spies["influence_visibilities"].result.llr)
    t0 = time.perf_counter()
    f32_again = f32_call.fn(*args, **kw)
    torch.cuda.synchronize(dev)
    f32_seconds = time.perf_counter() - t0
    t0 = time.perf_counter()
    img_again = backend.influence_image(*args, **kw)
    torch.cuda.synchronize(dev)
    seconds_again = time.perf_counter() - t0
    scale = float(f32_img.abs().max())
    rel_img = float((img - f32_img).abs().max()) / scale
    std_b = float(torch.std(img, correction=0))
    std_f = float(torch.std(f32_img, correction=0))
    rel_std = abs(std_b - std_f) / std_f
    findings = regress.compare(
        store, f"influence_bf16_{label}", statics, fp,
        {"rel_err_img": baselines.scalar_metric(rel_img),
         "rel_err_std": baselines.scalar_metric(rel_std)})
    verdict = regress.worst_verdict(findings)
    print(f"bf16 influence at {label} ({statics}): {seconds:.4f} s (again "
          f"{seconds_again:.4f} s; the f32 route on the same operands "
          f"{f32_seconds:.4f} s); launches "
          + ", ".join(f"{k} {v}" for k, v in launches.items())
          + f"; max|bf16 - f32| / max|f32| {rel_img:.4e}, std {std_b:.6g} "
          f"against {std_f:.6g} ({rel_std:.4e}); band-0 LLR bit-identical "
          f"{llr_equal}; f32 route again bit-identical "
          f"{torch.equal(f32_again, f32_img)}; bf16 route again "
          f"bit-identical {torch.equal(img_again, img)}; verdict {verdict}",
          flush=True)
    for f in findings:
        print("  " + f.render(), flush=True)
    if not (bool(torch.isfinite(img).all()) and img.shape == f32_img.shape
            and verdict != regress.FIRE and rel_img > 0 and llr_equal):
        raise AssertionError(f"bf16 influence at {label} fails its checks")
    rec = {"statics": statics, "seconds": seconds,
           "seconds_again": seconds_again, "f32_seconds": f32_seconds,
           "launches": launches, "rel_err_img": rel_img, "std_bf16": std_b,
           "std_f32": std_f, "rel_err_std": rel_std, "verdict": verdict,
           "findings": [f.render() for f in findings],
           "llr_bit_identical": llr_equal,
           "f32_again_bit_identical": torch.equal(f32_again, f32_img),
           "bf16_again_bit_identical": torch.equal(img_again, img)}
    return rec, bspies["factored"].args


def bf16_kernel(dev, f_args, n_sm):
    """Kernel 2's bf16 mode on the SKA path's operands (band 0's bf16
    influence visibilities): against its plain bf16 version within
    BF16_PLAIN_ATOL x max|plain| at full size and at the ragged cases,
    against the f32 mode within the band, the same bits over two launches;
    kernel, plain version and the cuBLAS BF16 GEMM of the planes timed with
    CUDA events."""
    from smartcal_tpu_torch.cal import imager
    from smartcal_tpu_torch.obs.baselines import BF16_REL_BAND
    from smartcal_tpu_torch.ops import factored_imager
    (uvw, vis, freq, cell), kw = f_args
    npix, R = kw["npix"], uvw.shape[0]
    if kw.get("precision") != "bf16":
        raise AssertionError(f"kernel 2 was called with {kw} on the bf16 "
                             "path")

    def kernel():
        return factored_imager.dirty_image_factored_cuda(
            uvw, vis, freq, cell, npix=npix, precision="bf16")

    def plain():
        return imager.dirty_image_factored_blocked_sr(
            uvw, vis, freq, cell, npix=npix,
            block_r=SKA_STATICS["imager_block_r"], precision="bf16")

    out, again, ref = kernel(), kernel(), plain()
    f32 = factored_imager.dirty_image_factored_cuda(uvw, vis, freq, cell,
                                                    npix=npix)
    torch.cuda.synchronize(dev)
    if not torch.equal(out, again):
        raise AssertionError("factored_imager_bf16: two launches differ")
    lab = f"SKA path npix={npix} R={R}"
    err = [check_close("factored_imager_bf16", lab + " vs plain bf16", out,
                       ref, 0.0, BF16_PLAIN_ATOL, float(ref.abs().max()))]
    err_f32 = check_close("factored_imager_bf16", lab + " vs the f32 mode",
                          out, f32, 0.0, BF16_REL_BAND,
                          float(f32.abs().max()))
    del out, again, ref, f32
    for r_n, r_npix in BF16_RAGGED:
        ru, rv, rf = random_imager_case(r_n, r_n, dev)
        rc = imager.default_cell(ru, rf)
        o_k = factored_imager.dirty_image_factored_cuda(
            ru, rv, rf, rc, npix=r_npix, precision="bf16")
        o_r = imager.dirty_image_factored_blocked_sr(
            ru, rv, rf, rc, npix=r_npix, block_r=4096, precision="bf16")
        err.append(check_close("factored_imager_bf16",
                               f"ragged npix={r_npix} R={r_n}", o_k, o_r,
                               0.0, BF16_PLAIN_ATOL, float(o_r.abs().max())))
    k_ms = cuda_ms(kernel, 5, warmup=1)
    plain_ms = cuda_ms(plain, 3, warmup=1)
    # library yardstick: one cuBLAS BF16 GEMM of the precomputed planes
    p1, p2, cb, sb = imager._factored_planes(uvw, vis, freq, cell, npix)
    lhs = torch.cat([p1, p2], 1).to(torch.bfloat16)
    del p1, p2
    rhs = torch.cat([cb, sb], 1).to(torch.bfloat16).T
    del cb, sb
    lib_ms = cuda_ms(lambda: torch.matmul(lhs, rhs), 3, warmup=1)
    del lhs, rhs
    torch.cuda.empty_cache()
    k_ms2 = cuda_ms(kernel, 5, warmup=1)
    bounds = separable_bounds(npix, R, n_sm)
    regs = bf16_registers(BUILD_LOGS.get("factored_imager", ""))
    print(f"factored_imager_bf16 at npix={npix} R={R}: kernel {k_ms:.3f} / "
          f"{k_ms2:.3f} ms (median of 5, two runs), plain {plain_ms:.3f} "
          f"ms, library (cuBLAS BF16 GEMM of the planes) {lib_ms:.3f} ms, "
          f"bound {bounds['bound_bf16_ms']:.3f} ms (operations; f32 mode's "
          f"{bounds['bound_ms']:.3f}); ptxas {regs}", flush=True)
    return {"max_abs_err": max(err), "max_abs_err_vs_f32": err_f32,
            "ms": k_ms, "ms_repeat": k_ms2, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bounds["bound_bf16_ms"],
            "bound_by": "operations", "shapes": f"npix={npix} R={R}",
            "bit_identical": True, "ptxas": regs}


def bf16_main(dev, out_dir, zero_counts, read_counts):
    """``--bf16``: one N=62 reset + step and one SKA reset + step of
    CalibEnv(M=10) with the hint (the default run's configurations), then
    the bf16 phase on their operands."""
    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    t0 = time.perf_counter()
    spies = {}
    for name, cfg in (("n62", N62), ("ska", SKA)):
        backend = RadioBackend(device=dev, **cfg)
        env = CalibEnv(M=10, backend=backend, seed=0, provide_hint=True,
                       device=dev)
        env.reset()
        _, steps, spies[name] = spied_steps(env, backend, 1)
        check_outputs([], steps, cfg["npix"], env.M)
        print(f"{name} reset + step {time.perf_counter() - t0:.1f} s",
              flush=True)
        del env, backend
    out = bf16_phase(dev, zero_counts, read_counts, n_sm, out_dir,
                     spies["ska"], spies["n62"])
    out["total_seconds"] = time.perf_counter() - t0
    return out


def bf16_phase(dev, zero_counts, read_counts, n_sm, out_dir, ska_spies,
               n62_spies):
    """The bf16 influence path on the SKA step's and the N=62 step's own
    episodes and solves (no new reset or solve: the solve is pinned f32,
    so the f32 step's solve is the bf16 backend's), and kernel 2's bf16
    mode at the SKA path's operands.  The drift is judged by obs/regress
    against a store of this run's own (no baseline: the band applies)."""
    from smartcal_tpu_torch.obs import baselines
    t_phase = time.perf_counter()
    store = baselines.BaselineStore(os.path.join(out_dir,
                                                 "bf16_baselines.json"))
    fp = baselines.host_fingerprint()
    out = {"fingerprint": fp}
    out["ska"], f_args = bf16_influence(dev, "ska", SKA, ska_spies,
                                        zero_counts, read_counts, store, fp)
    want = dict(SKA_STATICS, precision="bf16")
    got = {k: out["ska"]["launches"][k] for k in (
        "factored_imager_bf16", "factored_imager", "hessian_blocks",
        "dft_imager")}
    n_bands = SKA["n_freqs"]
    if out["ska"]["statics"] != want or got != {
            "factored_imager_bf16": n_bands, "factored_imager": 0,
            "hessian_blocks": 2 * n_bands, "dft_imager": 0}:
        raise AssertionError(f"bf16 SKA influence: statics "
                             f"{out['ska']['statics']} (want {want}), "
                             f"launches {got}")
    out["kernel"] = bf16_kernel(dev, f_args, n_sm)
    out["n62"], _ = bf16_influence(dev, "n62", N62, n62_spies, zero_counts,
                                   read_counts, store, fp)
    if any(out["n62"]["launches"][k] for k in ("factored_imager_bf16",
                                                "factored_imager",
                                                "hessian_blocks")) or \
            out["n62"]["statics"] != {"block_baselines": 0,
                                      "imager_block_r": 0,
                                      "precision": "bf16"}:
        raise AssertionError(f"bf16 N=62 influence: {out['n62']}")
    out["phase_seconds"] = time.perf_counter() - t_phase
    print(f"bf16 phase: {out['phase_seconds']:.1f} s", flush=True)
    return out


def demix_profile(env, out):
    """The demixing env's step profiled (after every timed phase): CUDA
    kernels per L-BFGS iteration of its solve, and its idle share against
    the same step unprofiled; into ``out``."""
    a = _demix_actions(2, DEMIX_K)[1]
    t0 = time.perf_counter()
    env.step(a)
    wall = time.perf_counter() - t0
    iters = LbfgsIters()
    try:
        wall_prof, busy, kernels = device_busy_seconds(lambda: env.step(a))
    finally:
        iters.restore()
    its = iters.since(0)
    out.update(step_wall_s=wall, step_wall_profiled_s=wall_prof,
               step_device_busy_s=busy, kernels=kernels, **its,
               kernels_per_iter=kernels / max(its["iters_max"], 1),
               step_idle_share=idle_share("demixing step", wall, busy,
                                          wall_prof))
    print(f"demixing step profiled: {kernels} kernels and copies over "
          f"{its['iters_max']} L-BFGS iterations = "
          f"{out['kernels_per_iter']:.0f} per iteration", flush=True)


IEEE_REDUCE = """__device__ __forceinline__ float reduce_2pi(float x) {
  return x - kTwoPi * rintf(x / kTwoPi);
}"""
CVT_SPLIT = """__device__ __forceinline__ void split_tf32(float x, float& big,
                                           float& small) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  big = __uint_as_float(r);
  small = x - big;
}"""


def ablation_variants(header):
    """{name: engine header}: as shipped; ``ieee_div``, the range reduction
    with the IEEE division and rintf of the earlier SIMT kernels;
    ``cvt_rna``, the 3xTF32 split by cvt.rna.tf32 (integer pipe) in place
    of Veltkamp's; ``promote_2`` and ``no_promotion``, the tensor-core
    partial sum added into the f32 registers every 2 stages, or never
    (the whole R chunk in the tensor cores' accumulator)."""
    def fn(pattern):
        return re.search(pattern, header, re.S).group(0)

    reduce_fn = fn(r"__device__ __forceinline__ float reduce_2pi.*?\n\}")
    split_fn = fn(r"__device__ __forceinline__ void split_tf32.*?\n\}")
    promote = fn(r"constexpr int kPromote = \d+;")
    return {"shipped": header,
            "ieee_div": header.replace(reduce_fn, IEEE_REDUCE),
            "cvt_rna": header.replace(split_fn, CVT_SPLIT),
            "promote_2": header.replace(promote,
                                        "constexpr int kPromote = 2;"),
            "no_promotion": header.replace(
                promote, "constexpr int kPromote = 1 << 30;")}


def ablation(out_dir, card):
    """Build every variant (one nvcc each, all at once) under _build/,
    run and hold each against the direct DFT; returns the rows."""
    from smartcal_tpu_torch.cal import imager
    from smartcal_tpu_torch.ops import build, dft_imager
    src = (build.CSRC / "dft_imager.cu").read_text()
    header = (build.CSRC / "separable_imager.cuh").read_text()
    procs = {}
    for name, text in ablation_variants(header).items():
        d = build.BUILD_DIR / "ablation" / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "separable_imager.cuh").write_text(text)
        (d / "dft_imager.cu").write_text(src)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o",
               str(d / "libablation.so"), str(d / "dft_imager.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       d / "libablation.so")
    libs = {}
    for name, (proc, path) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = re.findall(r"Used (\d+) registers", log)
        print(f"built {name}: registers {regs}", flush=True)
        libs[name] = dft_imager.bind(ctypes.CDLL(str(path)), "dft_image")
    dev = torch.device("cuda", 0)
    rows = []
    for case, npix, R in (("ska", 1024, 652800), ("ska_coherent", 1024,
                                                  652800),
                          ("n62", 128, 37820)):
        g = torch.Generator().manual_seed(npix + R)
        uvw = (torch.rand((R, 3), generator=g) * 4e3 - 2e3).to(dev)
        vis = torch.randn((R, 2), generator=g).to(dev)
        if case == "ska_coherent":     # a source at the phase centre
            vis = 0.01 * vis
            vis[:, 0] += 1.0
        cell = imager.default_cell(uvw, 150e6)
        uv = scaled_uv(dft_imager, uvw, 150e6)
        sub = torch.randperm(npix * npix, generator=g)[:4096].to(dev)
        sub[0] = (npix // 2) * npix + npix // 2
        ref = dft_imager.dirty_image_reference(
            uv, dft_imager.pixel_grid(npix, cell, dev)[sub], vis)
        tol = IMAGER_ATOL * float(vis.abs().mean()) + IMAGER_RTOL * ref.abs()
        for name, lib in libs.items():
            def run():
                return dft_imager.engine_image(lib, "dft_image", uv, vis,
                                               npix, cell)

            err = (run().reshape(-1)[sub] - ref).abs()
            row = {"variant": name, "case": case, "npix": npix, "R": R,
                   "ms": cuda_ms(run, 5 if npix == 1024 else 20),
                   "max_err_over_tol": float((err / tol).max()),
                   "centre_rel_err": float(err[0] / ref[0].abs()),
                   "card": card}
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "engine_ablation.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return rows


# -- --hessian-split: the Hessian kernels' launches timed apart ------------

# appended to the two-pass source (csrc/hessian_blocks.cu up to commit
# dc0ef65): each pass behind a C entry of its own
PARENT_PASS_ENTRIES = """
extern "C" int split_pass1(const float* C5, const float* R3, const float* Jp,
                           const float* Jq, int K, int Td, int B, float* off,
                           float* spsq, void* stream) {
  const dim3 grid1((B + kThreads - 1) / kThreads, K);
  hessian_pass1_kernel<<<grid1, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      C5, R3, Jp, Jq, Td, B, off, spsq);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int split_pass2(const float* spsq, const int* p_perm,
                           const int* p_off, const int* q_perm,
                           const int* q_off, int K, int B, int N,
                           float* dsum, void* stream) {
  const int64_t n2 = static_cast<int64_t>(K) * N * 8;
  hessian_pass2_kernel<<<static_cast<unsigned>((n2 + 255) / 256), 256, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      spsq, p_perm, p_off, q_perm, q_off, K, B, N, dsum);
  return static_cast<int>(cudaGetLastError());
}
"""


def parent_csr(n_stations, dev):
    """The two-pass kernel's station lists of the full baseline set:
    (p_perm, p_off, q_perm, q_off), int32, baselines sorted stably by
    station and the start of each station's run."""
    out = []
    for idx in np.triu_indices(n_stations, 1):
        perm = np.argsort(idx, kind="stable").astype(np.int32)
        offsets = np.zeros(n_stations + 1, np.int32)
        offsets[1:] = np.cumsum(np.bincount(idx, minlength=n_stations))
        out += [torch.from_numpy(perm).to(dev),
                torch.from_numpy(offsets).to(dev)]
    return out


# appended to the shipped source: its tile pass and its combine alone, with
# the signature of hessian_blocks_launch
SHIPPED_PASS_ENTRIES = """
extern "C" int split_tiles(const float* C5, const float* R3, const float* Jp,
                           const float* Jq, const int* cell_b,
                           const int* slot_dst, const int* st_off, int K,
                           int Td, int B, int N, int n_tiles, int n_rows,
                           float* off, float* part, float* dsum,
                           void* stream) {
  const bool resident = smem_bytes(Td, true) <= kMaxSmem;
  const size_t smem = smem_bytes(Td, resident);
  cudaError_t err = cudaFuncSetAttribute(
      hessian_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  hessian_tiles_kernel<<<n_tiles, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      C5, R3, Jp, Jq, cell_b, slot_dst, K, Td, B, n_rows, resident ? 1 : 0,
      off, part);
  return static_cast<int>(cudaGetLastError());
}
extern "C" int split_combine(const float* C5, const float* R3,
                             const float* Jp, const float* Jq,
                             const int* cell_b, const int* slot_dst,
                             const int* st_off, int K, int Td, int B, int N,
                             int n_tiles, int n_rows, float* off,
                             float* part, float* dsum, void* stream) {
  const int64_t n2 = static_cast<int64_t>(K) * N * 8;
  hessian_combine_kernel<<<static_cast<unsigned>((n2 + 255) / 256), 256, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      part, st_off, K, N, n_rows, dsum);
  return static_cast<int>(cudaGetLastError());
}
"""


def _tile(rows, cols):
    return ((r"constexpr int kRows = \d+;", f"constexpr int kRows = {rows};"),
            (r"constexpr int kCols = \d+;", f"constexpr int kCols = {cols};"))


# name: (replacements in the shipped source, tile shape or None for the
# shipped one)
HESSIAN_VARIANTS = {
    # other tile shapes of 64 cells: longer runs of consecutive baselines
    "tile4x16": (_tile(4, 16), (4, 16)),
    "tile2x32": (_tile(2, 32), (2, 32)),
    "stages4": (((r"constexpr int kStages = \d+;",
                  "constexpr int kStages = 4;"),), None),
    # diagnostics, wrong results: the copies alone (no 2x2 algebra), and
    # the algebra alone (no C5 copies, on whatever shared memory holds)
    "copies_only": (((r"if \(live\) \{\n(\s+const float\* cs)",
                      r"if (live && K < 0) {\n\1"),), None),
    "algebra_only": (((r"if \(b >= 0 && k < K\) \{\n(\s+const float\* src)",
                       r"if (b >= 0 && k < 0) {\n\1"),), None),
}
DIAGNOSTIC_VARIANTS = ("copies_only", "algebra_only")


def shipped_variants(src):
    """{name: source}: the shipped Hessian kernel and the copies of
    ``HESSIAN_VARIANTS``, each with some constants or lines replaced."""
    out = {"shipped": src}
    for name, (subs, _) in HESSIAN_VARIANTS.items():
        text = src
        for pattern, value in subs:
            text, n = re.subn(pattern, value, text)
            if n == 0:
                raise AssertionError(f"{name}: pattern {pattern} not found")
        out[name] = text
    return out


def build_split_libs(sources, subdir="hessian_split"):
    """nvcc each {name: source text} into _build/<subdir>/, all at once,
    with csrc/ on the include path; returns {name: (library, registers
    reported by ptxas)} and keeps each log in BUILD_LOGS["<subdir>/<name>"].
    """
    from smartcal_tpu_torch.ops import build
    d = build.BUILD_DIR / subdir
    d.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        (d / f"{name}.cu").write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(d / f"lib{name}.so"), str(d / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        BUILD_LOGS[f"{subdir}/{name}"] = log
        regs = re.findall(r"Used (\d+) registers", log)
        spills = re.findall(r"(\d+) bytes spill stores", log)
        stack = re.findall(r"(\d+) bytes stack frame", log)
        warn = [ln.strip() for ln in log.splitlines() if "arning" in ln]
        print(f"built {name}: registers {regs} spill stores {spills} "
              f"stack frames {stack} warnings {warn}", flush=True)
        libs[name] = (ctypes.CDLL(str(d / f"lib{name}.so")), regs)
    return libs


def hessian_split(out_dir, card, parent_src, reps=50):
    """Time the Hessian kernels launch by launch at the SKA path's shapes
    (K=10, Td=10, N=256, B=32,640; random operands from seed 0), CUDA
    events around each launch, outputs and host tables prebuilt: the
    two-pass kernel of ``parent_src`` (pass 1, pass 2, both), the shipped
    kernel (tile pass, combine, both) and its variants (both); in two
    turns, the second in reverse order.  Each is held against the plain
    version, the shipped ones also bit for bit over two launches."""
    from smartcal_tpu_torch.cal import kernels
    from smartcal_tpu_torch.ops import build, hessian_blocks
    dev = torch.device("cuda", 0)
    K, Td, N = 10, 10, 256
    B = N * (N - 1) // 2
    g = torch.Generator().manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev)

    R3, C5 = rnd(Td, B, 2, 2, 2), rnd(K, Td, B, 2, 2, 2)
    Jp, Jq = rnd(K, B, 2, 2, 2), rnd(K, B, 2, 2, 2)
    p_idx, q_idx = kernels.baseline_indices(N, dev)
    off_ref, dsum_ref = kernels._hessian_block_sums(R3, C5, Jp, Jq, p_idx,
                                                    q_idx, N)
    stream = torch.cuda.current_stream(dev).cuda_stream
    P, I = ctypes.c_void_p, ctypes.c_int

    src = (build.CSRC / "hessian_blocks.cu").read_text()
    libs = build_split_libs(
        {"parent": Path(parent_src).read_text() + PARENT_PASS_ENTRIES,
         **{name: text + SHIPPED_PASS_ENTRIES
            for name, text in shipped_variants(src).items()}})
    lib, regs = libs.pop("parent")
    lib.split_pass1.argtypes = [P, P, P, P, I, I, I, P, P, P]
    lib.split_pass2.argtypes = [P, P, P, P, P, I, I, I, P, P]
    lib.hessian_blocks_launch.argtypes = [P, P, P, P, P, P, P, P, I, I, I,
                                          I, P, P, P, P]
    p_perm, p_off, q_perm, q_off = parent_csr(N, dev)
    off = torch.empty((K, B, 4, 4, 2), device=dev)
    spsq = torch.empty((2, K, B, 8), device=dev)
    dsum = torch.empty((K, N, 2, 2, 2), device=dev)
    ptr = [t.data_ptr() for t in (C5, R3, Jp, Jq, p_perm, p_off, q_perm,
                                  q_off, off, spsq, dsum)]

    def checked(rc):
        if rc != 0:
            raise RuntimeError(f"hessian split launch failed ({rc})")

    runs = {
        "parent_pass1": (lambda: checked(lib.split_pass1(
            *ptr[:4], K, Td, B, ptr[8], ptr[9], stream)), regs),
        "parent_pass2": (lambda: checked(lib.split_pass2(
            ptr[9], *ptr[4:8], K, B, N, ptr[10], stream)), regs),
        "parent_both": (lambda: checked(lib.hessian_blocks_launch(
            *ptr[:8], K, Td, B, N, ptr[8], ptr[9], ptr[10], stream)), regs),
    }
    runs["parent_both"][0]()
    torch.cuda.synchronize()
    for name, out, ref in (("off", off, off_ref), ("Dsum", dsum, dsum_ref)):
        check_close("hessian_blocks parent " + name, "SKA shapes", out, ref,
                    HESSIAN_RTOL, HESSIAN_ATOL, float(ref.abs().max()))

    hargs = (R3, C5, Jp, Jq, p_idx, q_idx, N)
    p_np, q_np = np.triu_indices(N, 1)
    for name, (vlib, vregs) in libs.items():
        shape = HESSIAN_VARIANTS.get(name, ((), None))[1]
        sched = (hessian_blocks.full_schedule(N, dev)[0] if shape is None
                 else hessian_blocks.to_schedule(
                     hessian_blocks.full_cells(N, shape), p_np, q_np, N, dev,
                     shape))
        both, v_off, v_dsum = hessian_launcher(hessian_blocks, hargs, sched,
                                               lib=vlib)
        both()
        first = (v_off.clone(), v_dsum.clone())
        both()
        torch.cuda.synchronize()
        for part, out, ref, again in (("off", v_off, off_ref, first[0]),
                                      ("Dsum", v_dsum, dsum_ref, first[1])):
            if name in DIAGNOSTIC_VARIANTS:
                continue
            check_close(f"hessian_blocks {name} {part}", "SKA shapes", out,
                        ref, HESSIAN_RTOL, HESSIAN_ATOL,
                        float(ref.abs().max()))
            if not torch.equal(out, again):
                raise AssertionError(f"hessian_blocks {name}: two launches "
                                     f"differ in {part}")
        runs[f"{name}_both"] = (both, vregs)
        if name == "shipped":
            for entry in ("tiles", "combine"):
                runs[f"shipped_{entry}"] = (hessian_launcher(
                    hessian_blocks, hargs, sched, lib=vlib,
                    entry=f"split_{entry}")[0], vregs)
    # yardstick of the card's streaming rate: one PyTorch copy that reads
    # and writes as many bytes as the kernel must move
    n_move = sum(t.numel() for t in (R3, C5, Jp, Jq)) + K * B * 32 + K * N * 8
    copy_src = torch.empty(n_move // 2, device=dev).normal_()
    copy_dst = torch.empty_like(copy_src)
    runs["stream_copy_same_bytes"] = (lambda: copy_dst.copy_(copy_src), [])
    rows = []
    for turn in range(2):
        order = list(runs) if turn == 0 else list(runs)[::-1]
        for name in order:
            fn, r = runs[name]
            row = {"run": name, "turn": turn, "ms": cuda_ms(fn, reps),
                   "ms_batched": cuda_ms_batched(fn),
                   "registers": r, "card": card,
                   "shapes": f"K={K} Td={Td} B={B} N={N}"}
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "hessian_split.json"), "w") as fh:
        json.dump(rows, fh, indent=1)
    return rows


# -- --bf16-ablation: kernel 2's bf16 mode against its parent, and ceilings

# copies of the shipped bf16 kernel with one part of its work switched off:
# the tensor cores and the pipeline alone (constant operands stored as
# before), and the operand production alone (no products)
_MAKE = ("constexpr bool kMakeOperands = true;",
         "constexpr bool kMakeOperands = false;")
_STORES = """    st_shared_v2(off1 + j * kStride * kRowBytes, w0, w1);
    st_shared_v2(off2 + j * kStride * kRowBytes, w2, w3);
"""
BF16_VARIANTS = {
    "new": (),
    "constant_operands": (_MAKE,),
    "no_wgmma": (("constexpr bool kIssueWgmma = true;",
                  "constexpr bool kIssueWgmma = false;"),),
}
# diagnostic copies: the bf16 pack by integer adds and a byte permute
# (round half up) in place of cvt.rn.bf16x2; constant operands and no
# stores (the products and the barriers alone); the tensor-core sum never
# promoted, and promoted every 4 stages as the parent kernel does (their
# error on a coherent image)
BF16_DIAGNOSTICS = {
    "int_round": (('  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\\n" : "=r"(r) : '
                   '"f"(hi), "f"(lo));',
                   "  r = __byte_perm(__float_as_uint(lo) + 0x8000u, "
                   "__float_as_uint(hi) + 0x8000u, 0x7632);"),),
    "no_stores": (_MAKE, (_STORES, "")),
    "no_promotion": (("constexpr int kPromote = 256;",
                      "constexpr int kPromote = 1 << 30;"),),
    "promote_4": (("constexpr int kPromote = 256;",
                   "constexpr int kPromote = 4;"),),
}
BF16_CHECKED = ("parent", "new", "int_round")


def watched(fn, seconds, label):
    """``fn()``, then wait at most ``seconds`` for the device: a launch
    that has not finished by then (a pipeline that deadlocks) ends the
    process, and the exit tears its context down."""
    out = fn()
    done = torch.cuda.Event()
    done.record()
    t0 = time.perf_counter()
    while not done.query():
        if time.perf_counter() - t0 > seconds:
            print(f"{label}: not finished after {seconds} s", flush=True)
            os._exit(5)
        time.sleep(0.005)
    return out


def bf16_ablation(out_dir, card, parent_src, reps=5, npix=1024, R=652800,
                  dev=None):
    """Build the parent bf16 kernel (``parent_src``: factored_imager.cu of
    commit 5dda491, on the unchanged engine header), the shipped one and
    its copies of BF16_VARIANTS, one nvcc each, all at once.  The shipped
    kernel is first held against its plain bf16 version at the ragged
    cases under a watchdog; then each is run at npix=1024, R=652,800 on
    ``--ablation``'s random operands, held (``BF16_CHECKED``) within
    BF16_PLAIN_ATOL x max|plain| and bit for bit over two launches (the
    others' errors are recorded: a coherent image shows the promotion
    cadence's), and timed with CUDA events in two turns (the parent, the
    variants, the diagnostics, the cuBLAS BF16 GEMM of the planes; then
    the reverse).  One JSON line per variant; DIR/bf16_ablation.json."""
    from smartcal_tpu_torch.cal import imager
    from smartcal_tpu_torch.ops import build, dft_imager, factored_imager
    src = (build.CSRC / "factored_imager.cu").read_text()
    sources = {"parent": Path(parent_src).read_text()}
    for name, subs in {**BF16_VARIANTS, **BF16_DIAGNOSTICS}.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise AssertionError(f"{name}: '{old}' not in the source")
            text = text.replace(old, new)
        sources[name] = text
    libs = build_split_libs(sources, "bf16_ablation")
    for lib, _ in libs.values():
        dft_imager.bind(lib, "factored_image_bf16")
    dev = dev or torch.device("cuda", 0)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def image(name, uv, vis, npix, cell):
        plan = (dft_imager.split_plan if name == "parent"
                else factored_imager._bf16_split)
        return dft_imager.engine_image(libs[name][0], "factored_image_bf16",
                                       uv, vis, npix, cell, plan=plan)

    ragged = []
    for r_n, r_npix in BF16_RAGGED:
        ru, rv, rf = random_imager_case(r_n, r_n, dev)
        rc = imager.default_cell(ru, rf)
        ruv = scaled_uv(dft_imager, ru, rf)
        got = watched(lambda: image("new", ruv, rv, r_npix, rc), 60,
                      f"new at npix={r_npix} R={r_n}")
        ref = imager.dirty_image_factored_blocked_sr(
            ru, rv, rf, rc, npix=r_npix, block_r=4096, precision="bf16")
        scale = float(ref.abs().max())
        err = check_close("factored_imager_bf16 new", f"ragged npix={r_npix}"
                          f" R={r_n}", got, ref, 0.0, BF16_PLAIN_ATOL, scale)
        ragged.append({"npix": r_npix, "R": r_n, "max_abs_err": err,
                       "rel_err": err / scale})

    freq = 150e6
    g = torch.Generator().manual_seed(npix + R)
    uvw = (torch.rand((R, 3), generator=g) * 4e3 - 2e3).to(dev)
    vis = torch.randn((R, 2), generator=g).to(dev)
    cell = imager.default_cell(uvw, freq)
    uv = scaled_uv(dft_imager, uvw, freq)
    coherent = 0.01 * vis              # a source at the phase centre
    coherent[:, 0] += 1.0
    refs = {k: imager.dirty_image_factored_blocked_sr(
        uvw, v, freq, cell, npix=npix, block_r=4096, precision="bf16")
        for k, v in (("random", vis), ("coherent", coherent))}
    rows, runs = {}, {}
    for name in libs:
        def run(name=name, v=vis):
            return image(name, uv, v, npix, cell)

        out = watched(run, 120, f"{name} at npix={npix} R={R}")
        again = run()
        torch.cuda.synchronize()
        rows[name] = {"variant": name,
                      "bit_identical": torch.equal(out, again),
                      "ptxas": bf16_registers(
                          BUILD_LOGS[f"bf16_ablation/{name}"]),
                      "checked": name in BF16_CHECKED}
        for case, got in (("random", out),
                          ("coherent", run(v=coherent))):
            ref = refs[case]
            scale = float(ref.abs().max())
            err = float((got - ref).abs().max())
            rows[name][f"max_abs_err_{case}"] = err
            rows[name][f"rel_err_{case}"] = err / scale
            if name in BF16_CHECKED:
                check_close(f"factored_imager_bf16 {name}",
                            f"{case} npix={npix} R={R}", got, ref, 0.0,
                            BF16_PLAIN_ATOL, scale)
        if name in BF16_CHECKED and not rows[name]["bit_identical"]:
            raise AssertionError(f"bf16 {name}: two launches differ")
        runs[name] = run
        del out, again
    del refs
    p1, p2, cb, sb = imager._factored_planes(uvw, vis, freq, cell, npix)
    lhs = torch.cat([p1, p2], 1).to(torch.bfloat16)
    del p1, p2
    rhs = torch.cat([cb, sb], 1).to(torch.bfloat16).T
    del cb, sb
    runs["library"] = lambda: torch.matmul(lhs, rhs)
    rows["library"] = {"variant": "library", "what": "one cuBLAS BF16 GEMM "
                       "of the precomputed planes (torch.matmul)"}
    order = ["parent", *BF16_VARIANTS, *BF16_DIAGNOSTICS, "library"]
    for turn in range(2):
        for name in (order if turn == 0 else order[::-1]):
            rows[name].setdefault("ms_turns", []).append(
                cuda_ms(runs[name], reps, warmup=1))
    bound = separable_bounds(npix, R, n_sm)["bound_bf16_ms"]
    for name in order:
        rows[name].update(ms=float(np.median(rows[name]["ms_turns"])),
                          bound_ms=bound, card=card,
                          shapes=f"npix={npix} R={R}")
        print(json.dumps(rows[name]), flush=True)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "bf16_ablation.json"), "w") as fh:
        json.dump({"variants": rows, "ragged_new": ragged, "card": card},
                  fh, indent=1)
    return rows


# -- the distributed-training slice (fleet_phase) ---------------------------
#: copies of the shipped kernel 4 (csrc/enet_lbfgs.cu) with a switch
#: changed: A back in shared memory
ENET_LEVERS = {"smem_a": {"ENET_A_REGISTERS": 0}}


def _kernel4_seed_lanes(n=ENET_SEED_LANES, seed=21):
    """``n`` step lanes, each its own env problem (seeds 1000..) and a
    uniform random action: ((A, y, l2, l1, None), max_iters), on the
    CPU."""
    from smartcal_tpu_torch.envs import enet
    cfg = enet.EnetConfig()
    sts = [_enet_problem(enet, cfg, 1000 + s) for s in range(n)]
    act = torch.rand(n, 2, generator=torch.Generator().manual_seed(seed))
    rho, _ = enet.action_to_rho(act * 2 - 1)
    return ((torch.stack([st.A for st in sts]),
             torch.stack([st.y for st in sts]), rho[:, 0].contiguous(),
             rho[:, 1].contiguous(), None), cfg.lbfgs_iters)


def _parent_eig(lib, B):
    """One launch of the parent kernel 5 (no schedule argument) on a
    contiguous float32 (L, n, n) B; returns (L, n)."""
    L, n = B.shape[0], B.shape[-1]
    out = torch.empty((L, n), dtype=torch.float32, device=B.device)
    rc = lib.sym_eigvals_launch(B.data_ptr(), L, n, out.data_ptr(), 0, 0,
                                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent sym_eigvals launch failed: {rc}")
    return out


class _Kernel4Lib:
    """Within the block, ``enet_lbfgs``'s wrappers launch ``lib``."""

    def __init__(self, enet_lbfgs, lib):
        self.mod, self.lib = enet_lbfgs, lib

    def __enter__(self):
        self.saved = self.mod._lib
        self.mod._lib = lambda: self.lib

    def __exit__(self, *exc):
        self.mod._lib = self.saved


def enet_kernel_ablation(out_dir, card, parent_dir, reps=20):
    """Kernels 4 and 5 of the parent checkout ``parent_dir`` (its
    smartcal_tpu_torch/csrc/), the shipped ones and copies of the shipped
    kernel 4 with a switch changed (ENET_LEVERS), one nvcc each, all at
    once.  Every kernel 4 copy is held as enet_lbfgs_checks holds the
    shipped one (the first 5 iterations from its own state, the full-depth
    losses), printed and not raised, and its full-depth results compared
    bit for bit with the parent's; then on ENET_SEED_LANES seeded step
    lanes (:func:`_kernel4_seed_lanes`, one launch) each lane's full-depth
    loss against the plain version run lane by lane, and its iterations
    and evaluations beside the plain version's; then each is timed at the
    step lane, the hint's 50 lanes and the seeded lanes (at their depths
    and at max_iters = 0, and per evaluation the slowest lane performed),
    and kernel 5 (parent, shipped, eigvalsh) on one random 20 x 20 matrix
    and on 64, all on the same operands, in two turns (forward, then
    backward), CUDA events, median of ``reps`` (kernel 5 also per launch
    over 20 back to back).  DIR/enet_kernel_ablation.json."""
    from smartcal_tpu_torch.ops import build, enet_lbfgs, sym_eigvals
    parent = Path(parent_dir) / "smartcal_tpu_torch" / "csrc"
    k4 = (build.CSRC / "enet_lbfgs.cu").read_text()
    sources = {"k4_parent": (parent / "enet_lbfgs.cu").read_text(),
               "k4_shipped": k4,
               "k5_parent": (parent / "sym_eigvals.cu").read_text(),
               "k5_shipped": (build.CSRC / "sym_eigvals.cu").read_text()}
    for name, switches in ENET_LEVERS.items():
        sources[f"k4_{name}"] = "".join(
            f"#define {k} {v}\n" for k, v in switches.items()) + k4
    libs = build_split_libs(sources, "enet_kernel_ablation")
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, (lib, _) in libs.items():
        if name.startswith("k4_"):
            enet_lbfgs.bind(lib)
        elif name == "k5_shipped":
            sym_eigvals.bind(lib)
        else:
            lib.sym_eigvals_launch.argtypes = [p, i, i, p, p, p, p]
            lib.sym_eigvals_launch.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    report = {"card": card, "parent": str(parent_dir), "registers": {
        n: r for n, (_, r) in libs.items()}, "kernel4": {}, "kernel5": {}}
    k4_names = [n for n in libs if n.startswith("k4_")]
    cases = _kernel4_cases()
    refs = {label: enet_lbfgs.solve_plain(*args, max_iters=full)
            for label, (args, full) in cases.items()}
    holds, parent_runs = {}, {}
    for name in k4_names:
        holds[name] = {}
        with _Kernel4Lib(enet_lbfgs, libs[name][0]):
            for label, (args, full) in cases.items():
                dargs = tuple(None if a is None else a.to(dev) for a in args)
                try:
                    kernel4_iterations(enet_lbfgs, args, dargs,
                                       f"{name}, {label}")
                    iters_ok = True
                except AssertionError as e:
                    print(f"{name}: {e}", flush=True)
                    iters_ok = False
                res, evals = enet_lbfgs.solve_cuda(*dargs, max_iters=full,
                                                   with_evals=True)
                again = enet_lbfgs.solve_cuda(*dargs, max_iters=full)
                same = torch.equal(res.x, again.x)
                # the algorithm's results; the evaluation counts differ
                # where the phi(0) of a search is reused
                run = [res.x, res.loss, res.grad, res.n_iters, res.hist.s,
                       res.hist.y, res.hist.gamma]
                if name == "k4_parent":
                    parent_runs[label] = run
                as_parent = all(torch.equal(a, b) for a, b in
                                zip(run, parent_runs[label]))
                _, _, held, rtol, least, loss_ok = _full_depth_hold(
                    label, res, refs[label], full)
                holds[name][label] = {
                    "iterations_held": iters_ok, "full_depth_held": loss_ok,
                    "same_bits": same, "parent_bits": as_parent,
                    "lanes_held": int(held.numel()),
                    "held_rel_max": float(held.max()) if held.numel()
                    else None, "iters": res.n_iters.tolist(),
                    "evals_max": int(evals.max()),
                    "evals_total": int(evals.sum())}
                print(f"{name} ({label}): first 5 iterations "
                      f"{'held' if iters_ok else 'NOT held'}; full depth "
                      f"{'held' if loss_ok else 'NOT held'} "
                      f"({int(held.numel())} lanes, max "
                      f"{holds[name][label]['held_rel_max']} at rtol "
                      f"{rtol}); two launches "
                      f"{'the same bits' if same else 'DIFFER'}; "
                      f"{'the' if as_parent else 'NOT the'} parent's bits; "
                      f"iterations {res.n_iters.tolist()[:6]}, evaluations "
                      f"max {int(evals.max())}", flush=True)
    # the seeded step lanes: the plain version lane by lane (as the step
    # lane is held), every kernel 4 on all of them in one launch
    seed_args, seed_full = _kernel4_seed_lanes()
    A, y, l2, l1, _ = seed_args
    plain = [enet_lbfgs.solve_plain(A[k:k + 1], y[k:k + 1], l2[k:k + 1],
                                    l1[k:k + 1], max_iters=seed_full)
             for k in range(A.shape[0])]
    p_loss = torch.cat([r.loss for r in plain])
    p_iters = torch.cat([r.n_iters for r in plain])
    dseed = tuple(None if a is None else a.to(dev) for a in seed_args)
    seeds = {}
    for name in k4_names:
        with _Kernel4Lib(enet_lbfgs, libs[name][0]):
            res, evals = enet_lbfgs.solve_cuda(*dseed, max_iters=seed_full,
                                               with_evals=True)
        rel = ((res.loss.cpu() - p_loss).abs() / p_loss.abs())
        its, ev = res.n_iters.cpu(), evals.cpu()
        seeds[name] = {
            "loss_rel": rel.tolist(), "iters": its.tolist(),
            "evals": ev.tolist(), "plain_iters": p_iters.tolist(),
            "held": int((rel <= ENET_FULL_LOSS_RTOL).sum()),
            "loss_rel_max": float(rel.max()),
            "loss_rel_median": float(rel.median()),
            "iters_mean": float(its.float().mean()),
            "plain_iters_mean": float(p_iters.float().mean()),
            "fewer_iters": int((its < p_iters).sum()),
            "more_iters": int((its > p_iters).sum()),
            "evals_mean": float(ev.float().mean()),
            "evals_per_iter": float(ev.sum() / its.sum().clamp(min=1))}
        z = seeds[name]
        print(f"{name} (seeded step lanes, {A.shape[0]} problems): loss "
              f"within rtol {ENET_FULL_LOSS_RTOL} of the plain version's on "
              f"{z['held']} lanes, rel err max {z['loss_rel_max']:.3e} "
              f"median {z['loss_rel_median']:.3e}; iterations mean "
              f"{z['iters_mean']:.2f} (plain {z['plain_iters_mean']:.2f}; "
              f"fewer on {z['fewer_iters']} lanes, more on "
              f"{z['more_iters']}); evaluations performed mean "
              f"{z['evals_mean']:.2f}, {z['evals_per_iter']:.3f} an "
              f"iteration", flush=True)
    report["kernel4_seeds"] = seeds
    cases = dict(cases, seeds=(seed_args, seed_full))
    # the wide path (N > 32, or a history above 8): x after 5 iterations
    g = torch.Generator().manual_seed(3)
    with _Kernel4Lib(enet_lbfgs, libs["k4_shipped"][0]):
        for N, M, m in ((40, 24, 7), (20, 20, 10)):
            args = (torch.randn(1, N, M, generator=g) / N ** 0.5,
                    torch.randn(1, N, generator=g), torch.tensor([0.05]),
                    torch.tensor([0.01]))
            got = enet_lbfgs.solve_cuda(*(a.to(dev) for a in args),
                                        max_iters=5, history_size=m)
            want = enet_lbfgs.solve_plain(*args, max_iters=5,
                                          history_size=m)
            if not torch.equal(got.n_iters.cpu(), want.n_iters):
                raise AssertionError("kernel 4's wide path: iteration "
                                     "counts differ")
            report["wide_path_" + f"{N}x{M}_m{m}"] = _hold(
                f"kernel 4's wide path (N={N}, M={M}, history {m}) x after "
                "5 iterations", got.x, want.x, ENET_ITER_RTOL,
                ENET_ITER_ATOL)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # each case at its depth, and at max_iters = 0: the launch, the
    # wrapper's host work and one evaluation
    runs = [(label, full) for label, (_, full) in cases.items()] + [
        (label, 0) for label in cases]
    times = {n: {f"{label}@{it}": [] for label, it in runs}
             for n in k4_names}
    for turn in (k4_names, k4_names[::-1]):
        for name in turn:
            lib = libs[name][0]
            for label, it in runs:
                A, y, l2, l1, w = (None if a is None else
                                   a.to(dev).contiguous()
                                   for a in cases[label][0])
                times[name][f"{label}@{it}"].append(cuda_ms(
                    lambda: enet_lbfgs.launch(
                        lib, A, y, l2, l1, w, it, 7, 1e-5, 1e-9, stream),
                    reps, warmup=3))
    for name in k4_names:
        # per evaluation the slowest lane performed
        most = {label: h["evals_max"] for label, h in holds[name].items()}
        most["seeds"] = max(seeds[name]["evals"])
        per_eval = {label: [1e3 * t / most[label] for t in
                            times[name][f"{label}@{full}"]]
                    for label, (_, full) in cases.items()}
        report["kernel4"][name] = {"holds": holds[name],
                                   "ms": times[name],
                                   "us_per_eval": per_eval,
                                   "evals_slowest_lane": most}
        print(f"kernel 4 {name}: " + "; ".join(
            f"{label} {', '.join(f'{t:.4f}' for t in ts)} ms"
            for label, ts in times[name].items()) + "; per evaluation "
            "of the slowest lane: " + "; ".join(
            f"{label} {', '.join(f'{t:.3f}' for t in ts)} us "
            f"({most[label]})" for label, ts in per_eval.items()),
            flush=True)
    g = torch.Generator().manual_seed(13)
    R = torch.randn(ENET_EIG_RANDOM, 20, 20, generator=g)
    eig_cases = {"1 x 20 x 20": (R[:1] + R[:1].mT).to(dev),
                 "64 x 20 x 20": (R + R.mT).to(dev)}
    sched = sym_eigvals.round_robin(20).to(dev)
    eig_fns = {
        "k5_parent": lambda B: _parent_eig(libs["k5_parent"][0], B),
        "k5_shipped": lambda B: sym_eigvals.launch(libs["k5_shipped"][0],
                                                   B, sched, stream),
        "eigvalsh": sym_eigvals.sym_eigvals_plain}
    for label, B in eig_cases.items():
        want = sym_eigvals.sym_eigvals_plain(B)
        for name in ("k5_parent", "k5_shipped"):
            check_close(name, label, eig_fns[name](B), want, EIG_RTOL,
                        EIG_ATOL_REL, float(want.abs().max()))
    t5 = {n: {label: [] for label in eig_cases} for n in eig_fns}
    b2b = {n: {label: [] for label in eig_cases} for n in eig_fns}
    names5 = list(eig_fns)
    for turn in (names5, names5[::-1]):
        for name in turn:
            for label, B in eig_cases.items():
                fn = functools.partial(eig_fns[name], B)
                t5[name][label].append(cuda_ms(fn, reps, warmup=3))
                b2b[name][label].append(cuda_ms_batched(fn))
    for name in names5:
        report["kernel5"][name] = {"ms": t5[name],
                                   "ms_back_to_back": b2b[name]}
        print(f"kernel 5 {name}: " + "; ".join(
            f"{label} {', '.join(f'{t:.4f}' for t in t5[name][label])} ms "
            f"({', '.join(f'{t:.4f}' for t in b2b[name][label])} back to "
            f"back)" for label in eig_cases), flush=True)
    with open(os.path.join(out_dir, "enet_kernel_ablation.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=float)
    return report


FLEET_ENET = {"M": 20, "N": 20}        # full width; the inner solve's depth
FLEET_LBFGS = 30                       # default run (200 under --fleet)
FLEET_ROUNDS = 6                       # thread fleet rounds (8 under --fleet)
FLEET_PROC_ROUNDS = 4                  # process fleet rounds, 2 past warm-up
FLEET_LANES = 16                       # make_parallel_sac lanes
FLEET_PAR_STEPS = 3                    # its timed vector steps
FLEET_DEMIX = dict(n_stations=14, npix=128)   # the demixing trainers'
FLEET_K = 6


def _fleet_events(path):
    return [json.loads(ln) for ln in open(path) if ln.strip()]


def _graph_captures(events):
    """(count, seconds) of the run's CUDA-graph captures (the solve's
    line search, ROADMAP lever g)."""
    caps = [e["dur_s"] for e in events if e.get("event") == "compile"
            and str(e.get("key", "")).startswith("cuda_graph")]
    return len(caps), float(sum(caps))


def _host_ring(rp, buf):
    """A copy of a flat or sharded ring on the CPU."""
    return type(buf)({k: v.cpu().clone() for k, v in buf.data.items()},
                     buf.priority.cpu().clone(), buf.cntr, buf.beta)


def fleet_gpu_vs_cpu(dev, backend):
    """(a) one DSAC learn at the demixing fleet's width (128^2 map, K=6)
    and (b) one fused sharded step (store 32 versioned transitions into a
    4-shard ring, PER + ERE sample, IS-clipped SAC learn, priority update)
    at the enet width, each from a state with Adam history (3 learns on
    the card), on the card and from copies on the CPU with the same
    draws; held at TRAIN_RTOL / TRAIN_ATOL.  Also counts the
    synchronizing CUDA calls of one fused step on the card
    (``torch.cuda.set_sync_debug_mode``): those of the sample, learn and
    priority update, and those of the store of the host block apart."""
    import warnings

    from smartcal_tpu_torch.parallel import demix_learner
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.rl import replay_sharded as rps
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.rl import sac_discrete as dsac

    out = {}
    rng = np.random.default_rng(0)
    dcfg = demix_learner._demix_agent_cfg(
        backend, FLEET_K, True, 0.0, 1.0, {"batch_size": 8, "mem_size": 64})
    g = torch.Generator(device=dev).manual_seed(0)
    st = dsac.dsac_init(dcfg, g, dev)
    ring = rp.replay_init(dcfg.mem_size, dsac.transition_spec(dcfg.obs_dim),
                          dev)
    n = 24
    rp.replay_add_batch(ring, {
        "state": 1e-2 * rng.standard_normal((n, dcfg.obs_dim)).astype(
            np.float32),
        "new_state": 1e-2 * rng.standard_normal((n, dcfg.obs_dim)).astype(
            np.float32),
        "action": rng.integers(0, dcfg.n_actions, n).astype(np.int32),
        "reward": rng.uniform(-1, 1, n).astype(np.float32),
        "done": np.zeros(n, bool)})
    for _ in range(3):
        dsac.learn(dcfg, st, ring, g)
    cpu_st, cpu_ring = st.copy_to("cpu"), _host_ring(rp, ring)
    u = torch.rand(dcfg.batch_size, generator=torch.Generator().manual_seed(1))
    dsac.learn(dcfg, st, ring, sample_noise=u.to(dev))
    dsac.learn(dcfg, cpu_st, cpu_ring, sample_noise=u)
    out["dsac"] = state_diff(st.to_host(), cpu_st.to_host())
    print(f"DSAC learn GPU vs CPU (128^2 map, K={FLEET_K}, batch 8, Adam "
          f"history): max abs err {out['dsac'][0]:.3e}, at most "
          f"{out['dsac'][1]:.3f} of the tolerance -> ok", flush=True)

    obs_dim = FLEET_ENET["M"] + FLEET_ENET["M"] * FLEET_ENET["N"]
    cfg = sac.SACConfig(obs_dim=obs_dim, n_actions=2, prioritized=True,
                        is_clip=2.0, ere_eta=0.98, batch_size=32,
                        mem_size=256)
    spec = rp.versioned_spec(rp.transition_spec(obs_dim, 2))
    st = sac.sac_init(cfg, g, dev)
    buf = rps.replay_init(cfg.mem_size, spec, 4, device=dev)

    def block(seed, version):
        r = np.random.default_rng(seed)
        s = r.standard_normal((32, obs_dim)).astype(np.float32)
        return {"state": s, "new_state": s + 0.1,
                "action": r.uniform(-1, 1, (32, 2)).astype(np.float32),
                "reward": r.uniform(0, 3, 32).astype(np.float32),
                "done": np.zeros(32, bool),
                "hint": np.zeros((32, 2), np.float32),
                "version": np.full(32, version, np.int32),
                "behavior_logp": r.uniform(-3, 1, 32).astype(np.float32)}

    for i in range(3):
        rps.replay_add_batch(buf, block(i, i))
        sac.learn(cfg, st, buf, g, learner_version=3)
    cpu_st, cpu_buf = st.copy_to("cpu"), _host_ring(rps, buf)
    cg = torch.Generator().manual_seed(2)
    u = torch.rand(cfg.batch_size, generator=cg)
    noise = tuple(torch.randn((cfg.batch_size, 2), generator=cg)
                  for _ in range(3))
    nb = block(9, 2)
    u_d, noise_d = u.to(dev), tuple(x.to(dev) for x in noise)
    torch.cuda.synchronize(dev)

    def syncs_of(fn):
        """fn's result and the synchronizing CUDA calls it made."""
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                res = fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return res, [str(w.message) for w in caught
                     if "called a synchronizing" in str(w.message)]

    # the store copies the actor's host block to the card; the sample,
    # learn and priority update must not go back to the host
    _, store_syncs = syncs_of(lambda: rps.replay_add_batch(buf, nb))
    m, syncs = syncs_of(lambda: sac.learn(cfg, st, buf, sample_noise=u_d,
                                          noise=noise_d, learner_version=4))
    torch.cuda.synchronize(dev)
    rps.replay_add_batch(cpu_buf, nb)
    m_cpu = sac.learn(cfg, cpu_st, cpu_buf, sample_noise=u, noise=noise,
                      learner_version=4)
    for k in ("critic_loss", "actor_loss", "staleness_mean",
              "is_clip_mean"):
        a, b = float(m[k]), float(m_cpu[k])
        if not abs(a - b) <= TRAIN_ATOL + TRAIN_RTOL * abs(b):
            raise AssertionError(f"fused step GPU vs CPU: {k} {a} against "
                                 f"{b}")
    out["fused"] = state_diff(st.to_host(), cpu_st.to_host())
    p_err = float((buf.priority.cpu() - cpu_buf.priority).abs().max())
    if not torch.allclose(buf.priority.cpu(), cpu_buf.priority,
                          rtol=TRAIN_RTOL, atol=TRAIN_ATOL):
        raise AssertionError("fused step GPU vs CPU: priorities disagree")
    out["fused_priority_max_abs_err"] = p_err
    out["fused_step_syncs"] = len(syncs)
    out["fused_store_syncs"] = len(store_syncs)
    print(f"fused sharded step GPU vs CPU (4 shards, PER + ERE 0.98 + "
          f"IS-clip 2, batch 32, Adam history): max abs err "
          f"{out['fused'][0]:.3e}, at most {out['fused'][1]:.3f} of the "
          f"tolerance, priorities {p_err:.3e} -> ok; synchronizing CUDA "
          f"calls on the card: {len(syncs)} in the sample, learn and "
          f"priority update, {len(store_syncs)} in the store of the host "
          f"block ({len(nb)} fields and 2 index vectors copied to the "
          f"card)", flush=True)
    return out


def demix_two_threads(out_dir, caps1, limit_s=300):
    """The demixing fleet's CLI as a user runs it, with its default 2
    actor threads on the card (``python -m smartcal_tpu_torch.parallel.
    demix_learner --supervised``; 2 rounds of 1 x 3 steps, K=6, N=14,
    npix=128, influence maps), in a process of its own under a time limit:
    every solve captures its line search graph anew (lever g), two threads
    capture by turns under the solver's capture lock.  Fails unless the
    CLI exits 0 after both rounds with no actor death.  Returns its
    seconds and the graph captures of its run log."""
    run = os.path.join(out_dir, "fleet_demix2_run.jsonl")
    cmd = [sys.executable, "-m", "smartcal_tpu_torch.parallel.demix_learner",
           "--supervised", "--episodes", "2", "--K", str(FLEET_K),
           "--stations", str(FLEET_DEMIX["n_stations"]), "--npix",
           str(FLEET_DEMIX["npix"]), "--provide_influence",
           "--rollout_epochs", "1", "--rollout_steps", "3", "--metrics", run,
           "--quiet"]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=limit_s)
        rc, err = proc.returncode, proc.stderr.strip().splitlines()[-3:]
    except subprocess.TimeoutExpired:
        rc, err = None, ["timed out"]
    wall = time.perf_counter() - t0
    events = _fleet_events(run) if os.path.exists(run) else []
    downs = [e["reason"][:160] for e in events
             if e.get("event") in ("actor_down", "actor_failed")]
    rounds = sum(e.get("event") == "episode" for e in events)
    caps = _graph_captures(events)
    res = dict(rc=rc, wall_s=wall, rounds=rounds, stderr_tail=err,
               actor_deaths=downs, graph_captures=caps[0],
               graph_capture_s=caps[1])
    print(f"demix fleet CLI, 2 actor threads (its default), 2 rounds: rc "
          f"{rc}, {wall:.1f} s (process start included), {rounds} rounds, "
          f"{len(downs)} actor deaths, {caps[0]} graph captures in "
          f"{caps[1]:.3f} s ({caps[1] / max(caps[0], 1):.4f} s each; 1 "
          f"thread: {caps1[1] / max(caps1[0], 1):.4f} s)", flush=True)
    if rc != 0 or downs or rounds != 2:
        raise AssertionError(f"demix fleet CLI with 2 actor threads: rc "
                             f"{rc}, {rounds} rounds, deaths {downs}, "
                             f"stderr {err}")
    return res


def fleet_phase(dev, out_dir, zero_counts, read_counts, n_sm, deep=False):
    """The distributed-training slice on the card, counts zeroed just before
    and read just after each path:

    1. the enet thread fleet (``parallel/learner.train_supervised``) at
       M = N = 20: 2 actor threads x 4 env lanes, IS-clip 2.0, ERE 0.98,
       publish every 2 rounds, a fault plan killing actor 1 at iteration
       1, restarted with no backoff: at least one restart, learning past
       the kill, staleness > 0;
    2. the process fleet: 2 spawned workers on the card for 4 rounds
       (env-steps/s over the 2 past warm-up), every worker joined at
       stop;
    3. ``make_parallel_sac``: 16 lanes, timed vector steps with one learn
       each (env-steps/s); ``train_distributed`` for 2 episodes;
    4. the demixing fleet (``train_supervised_demix``): K=6, N=14,
       npix=128, influence maps, 1 thread actor x 1 iteration (1 epoch x
       3 steps): kernel 1 launches Nf per observation, its first image
       held against the plain version at its operands and timed;
    5. one DSAC learn and one fused sharded step held against the CPU
       (``fleet_gpu_vs_cpu``), and the fused step's synchronizing calls.

    ``deep`` (``--fleet``): the enet solves at their 200 L-BFGS iterations,
    8 thread-fleet rounds, and the demixing fleet with 2 actor threads in
    a process of its own under a time limit, which must run both rounds
    with no actor death (``demix_two_threads``: the CUDA-graph captures
    under threaded actors, ROADMAP lever g)."""
    from smartcal_tpu_torch.envs import enet
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.ops import dft_imager
    from smartcal_tpu_torch.parallel import (demix_learner, learner,
                                             make_mesh, make_parallel_sac)
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.runtime import (BackoffPolicy, FaultPlan,
                                            clear_faults, install_faults)

    t_phase = time.perf_counter()
    env_kw = dict(FLEET_ENET, lbfgs_iters=200 if deep else FLEET_LBFGS)
    rounds = 8 if deep else FLEET_ROUNDS
    backoff = BackoffPolicy(base_s=0.05, factor=2.0, max_s=0.2, jitter=0.0)
    fleet_kw = dict(seed=0, n_actors=2, env_kwargs=env_kw,
                    agent_kwargs={"batch_size": 16}, rollout_epochs=1,
                    rollout_steps=2, batch_envs=4, is_clip=2.0,
                    ere_eta=0.98, publish_every=2, quiet=True,
                    restart_backoff=backoff, device=dev)
    out = {"enet": dict(env_kw), "deep": deep}

    # 1. the thread fleet with a kill.  The learner restarts a dead actor
    # only in a supervision pass (one per round) once its backoff is over;
    # a round takes tens of ms on the card, so a backoff of 0.05 s could
    # outlast the run's last rounds and leave the kill unrestarted.  With
    # no backoff the pass that sees the death restarts the actor, and the
    # rounds after actor 1's first block leave room for it and for
    # learning past it.
    run = os.path.join(out_dir, "fleet_thread_run.jsonl")
    install_faults(FaultPlan(kill_actor=1, kill_at=1))
    zero_counts()
    t0 = time.perf_counter()
    try:
        (st, buf), scores, summ = learner.train_supervised(
            episodes=rounds, metrics=run, **dict(
                fleet_kw, restart_backoff=BackoffPolicy(
                    base_s=0.0, factor=2.0, max_s=0.0, jitter=0.0)))
    finally:
        clear_faults()
    wall = time.perf_counter() - t0
    launches = read_counts()
    events = _fleet_events(run)
    kinds = [e["event"] for e in events]
    if summ["restarts"] < 1 or "actor_restart" not in kinds:
        raise AssertionError(f"thread fleet: no restart after the kill "
                             f"({summ})")
    after = kinds[kinds.index("actor_restart"):]
    if st.learn_counter < 1 or "episode" not in after:
        raise AssertionError("thread fleet: no learning past the kill")
    if not summ.get("transition_staleness_mean", 0.0) > 0.0:
        raise AssertionError(f"thread fleet: no staleness ({summ})")
    if len(scores) != rounds or not np.all(np.isfinite(scores)):
        raise AssertionError(f"thread fleet scores {scores}")
    out["thread"] = dict(summary=summ, wall_s=wall, rounds=len(scores),
                         learn_counter=st.learn_counter, ring=buf.cntr,
                         launches=launches)
    print(f"enet thread fleet (2 actors x 4 lanes, M={env_kw['M']} "
          f"N={env_kw['N']}, L-BFGS {env_kw['lbfgs_iters']}, {rounds} rounds, kill actor 1 at "
          f"iteration 1): {wall:.1f} s, restarts {summ['restarts']}, learns "
          f"{st.learn_counter}, env-steps/s {summ['env_steps_per_s']} "
          f"(steady, after 2 rounds), staleness "
          f"{summ['transition_staleness_mean']}, clip saturation "
          f"{summ['is_clip_saturation']}", flush=True)
    del st, buf

    # 2. the process fleet: 2 spawned workers on the card
    run = os.path.join(out_dir, "fleet_process_run.jsonl")
    zero_counts()
    t0 = time.perf_counter()
    (st, buf), scores, summ = learner.train_supervised(
        episodes=FLEET_PROC_ROUNDS, metrics=run, actor_mode="process",
        **fleet_kw)
    wall = time.perf_counter() - t0
    if summ["alive_at_exit"] != 0:
        raise AssertionError(f"process fleet: {summ['alive_at_exit']} "
                             "worker(s) not joined at stop")
    if len(scores) != FLEET_PROC_ROUNDS or not np.all(np.isfinite(scores)):
        raise AssertionError(f"process fleet scores {scores}")
    if not summ["env_steps_per_s"]:
        raise AssertionError(f"process fleet: no steady rounds ({summ})")
    out["process"] = dict(summary=summ, wall_s=wall, ring=buf.cntr,
                          rounds=len(scores), launches=read_counts())
    print(f"enet process fleet (2 workers on the card, {FLEET_PROC_ROUNDS} "
          f"rounds): {wall:.1f} s (worker start included), env-steps/s "
          f"{summ['env_steps_per_s']} (steady, after 2 rounds; thread "
          f"fleet {out['thread']['summary']['env_steps_per_s']}), every "
          f"worker joined", flush=True)
    del st, buf

    # 3. make_parallel_sac: FLEET_LANES lanes as one program
    mesh = make_mesh(devices=[dev])
    ecfg = enet.EnetConfig(**env_kw)
    # a batch of two vector steps: one learn per timed step
    acfg = sac.SACConfig(obs_dim=ecfg.obs_dim, n_actions=2,
                         batch_size=2 * FLEET_LANES, prioritized=True)
    init, step, _ = make_parallel_sac(ecfg, acfg, mesh, FLEET_LANES)
    gen = torch.Generator(device=dev).manual_seed(0)
    zero_counts()
    pst = init(gen)
    pst, m = step(pst, gen)
    float(m["mean_reward"])
    t0 = time.perf_counter()
    for _ in range(FLEET_PAR_STEPS):
        pst, m = step(pst, gen)
        float(m["mean_reward"])
    wall = time.perf_counter() - t0
    if pst.agent.learn_counter != FLEET_PAR_STEPS:
        raise AssertionError(f"make_parallel_sac learned "
                             f"{pst.agent.learn_counter} times")
    par = FLEET_LANES * FLEET_PAR_STEPS / wall
    dst, dscores = learner.train_distributed(
        seed=0, episodes=2, n_actors=2, env_kwargs=env_kw,
        agent_kwargs={"batch_size": 8}, rollout_epochs=1, rollout_steps=2,
        quiet=True, device=dev)
    if dst.buf.cntr != 8 or not np.all(np.isfinite(dscores)):
        raise AssertionError(f"train_distributed: {dst.buf.cntr} stored, "
                             f"scores {dscores}")
    out["parallel_sac"] = dict(lanes=FLEET_LANES, steps=FLEET_PAR_STEPS,
                               wall_s=wall, env_steps_per_s=par,
                               launches=read_counts(),
                               train_distributed_scores=dscores)
    print(f"make_parallel_sac ({FLEET_LANES} lanes, {FLEET_PAR_STEPS} vector "
          f"steps with one learn each): {wall:.2f} s, env-steps/s "
          f"{par:.2f}; train_distributed 2 episodes -> ok", flush=True)
    del pst, dst

    # 4. the demixing fleet, kernel 1 on its influence maps
    backend = RadioBackend(device=dev, **FLEET_DEMIX)
    demix_kw = dict(seed=0, episodes=1, K=FLEET_K, backend=backend,
                    provide_influence=True, rollout_epochs=1,
                    rollout_steps=3, quiet=True, device=dev,
                    agent_kwargs={"batch_size": 2})
    spy = FirstCall(dft_imager, "dirty_image_cuda")
    # the actor rolls on while the learner ingests, and its next iteration
    # would end before the fleet joins it: a fault plan stops the actor
    # at iteration 1, so the path is 1 actor x 1 iteration; the rollouts
    # are counted all the same
    rollouts = {"n": 0}
    lanes_rollout = demix_learner._lanes_rollout

    def counted_rollout(*a, **kw):
        rollouts["n"] += 1
        return lanes_rollout(*a, **kw)

    demix_learner._lanes_rollout = counted_rollout
    run = os.path.join(out_dir, "fleet_demix_run.jsonl")
    install_faults(FaultPlan(kill_actor=0, kill_at=1))
    zero_counts()
    t0 = time.perf_counter()
    try:
        (dst, dbuf), dscores, dsumm = demix_learner.train_supervised_demix(
            n_actors=1, metrics=run, **demix_kw)
    finally:
        spy.restore()
        demix_learner._lanes_rollout = lanes_rollout
        clear_faults()
    wall = time.perf_counter() - t0
    demix_launches = read_counts()
    n_obs = (1 + 3) * rollouts["n"]       # r0's observation + 3 steps
    want = backend.n_freqs * n_obs
    if demix_launches["dft_imager"] != want:
        raise AssertionError(f"demix fleet: kernel 1 launched "
                             f"{demix_launches['dft_imager']} times, "
                             f"expected {want} (Nf per observation)")
    if dbuf.cntr != 3 or not np.all(np.isfinite(dscores)):
        raise AssertionError(f"demix fleet: {dbuf.cntr} stored, scores "
                             f"{dscores}")
    caps = _graph_captures(_fleet_events(run))
    (uv, vis, npix, cell), _ = spy.args
    err = check_imager(dft_imager, uv, vis, npix, cell, "demix fleet path")
    lm = dft_imager.pixel_grid(npix, cell, dev)
    k_ms = cuda_ms(lambda: dft_imager.dirty_image_cuda(uv, vis, npix, cell),
                   20)
    plain_ms = cuda_ms(lambda: dft_imager.dirty_image_reference(uv, lm, vis),
                       5)
    bnd = separable_bounds(npix, uv.shape[0], n_sm)
    out["demix"] = dict(wall_s=wall, launches=demix_launches,
                        observations=n_obs, rollouts=rollouts["n"],
                        summary=dsumm,
                        graph_captures=caps[0], graph_capture_s=caps[1],
                        kernel=dict(P=npix * npix, R=uv.shape[0],
                                    max_abs_err=err, ms=k_ms,
                                    plain_ms=plain_ms, **bnd))
    print(f"demix fleet (K={FLEET_K}, N={backend.n_stations}, npix={npix}, "
          f"1 actor x 1 epoch x 3 "
          f"steps, influence maps): {wall:.1f} s, kernel 1 launched "
          f"{demix_launches['dft_imager']} times (Nf={backend.n_freqs} x "
          f"{n_obs} observations of {rollouts['n']} rollout(s)), {caps[0]} "
          f"CUDA-graph captures "
          f"in "
          f"{caps[1]:.3f} s; kernel 1 at P={npix * npix} R={uv.shape[0]}: "
          f"{k_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
    del dst, dbuf
    if deep:
        out["demix_two_threads"] = demix_two_threads(out_dir, caps)

    # 5. GPU against CPU, and the fused step's syncs
    out["gpu_vs_cpu"] = fleet_gpu_vs_cpu(dev, backend)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"fleet phase {out['seconds']:.1f} s", flush=True)
    return out



# -- the serving slice (serve_phase) -----------------------------------------
SERVE_M, SERVE_LANES = 10, 4           # the reference backend's M, 4 lanes
# (k, diffuse, maxiter, pinned rho?) per job of the heterogeneous batch
SERVE_JOBS = ((2, False, None, True), (5, True, 9, False),
              (7, False, 12, True), (10, False, None, False))
# 2 batches: the sentinel's replay of the first runs beside the second
SERVE_WORKER_JOBS = 8
SERVE_CALIB = ["--tier", "medium", "--M", "4", "--lanes", "4", "--rates",
               "4", "--duration", "0.5", "--pool", "1", "--seed", "0",
               "--policy", "--quiet"]
# --serve: the open-loop load at two fractions of the capacity that step
# (2)'s batch gives (lanes / batch seconds), 200 requests at each
SERVE_LOAD_FRACTIONS = (0.6, 0.9)
SERVE_LOAD_JOBS = 200
SERVE_FLEET = ["--tier", "medium", "--M", "4", "--lanes", "4", "--replicas",
               "2", "--kill", "--rate-per-replica", "1.5", "--duration", "6",
               "--pool", "4", "--quiet"]
# a medium-tier batch takes ~4.6 s on the card: 1 job/s keeps the queue
# short; one held-out eval at the start and one at the end (an eval waits
# for its jobs and would hold the learner loop)
SERVE_LEARN = ["--tier", "medium", "--M", "4", "--lanes", "4", "--rate", "1",
               "--duration", "30", "--pool", "6", "--eval-pool", "2",
               "--eval-every-s", "1000", "--publish-every", "2",
               "--batch-size", "8", "--mem-size", "256", "--quiet"]


def _compile_delta(c0, c1):
    keys = ("compile_events", "compile_events:nvcc",
            "compile_events:cuda_graph", "compile_secs",
            "serve_oracle_compile_events",
            "serve_oracle_captures", "serve_oracle_capture_secs")
    return {k: c1.get(k, 0.0) - c0.get(k, 0.0) for k in keys}


def _serve_jobs(backend, obs_dim, Job, prng):
    """The heterogeneous batch: k in {2, 5, 7, 10}, one diffuse episode,
    maxiter None / 9 / 12, two pinned-rho jobs and two policy jobs with an
    obs_vec."""
    key = prng.PRNGKey(11)
    rng = np.random.default_rng(11)
    eps = []
    for k, diffuse, _, _ in SERVE_JOBS:
        key, sub = prng.split(key)
        eps.append(backend.new_calib_episode(sub, k, SERVE_M,
                                             diffuse=diffuse)[0])
    ovecs = [(1e-3 * rng.standard_normal(obs_dim)).astype(np.float32)
             for _ in SERVE_JOBS]

    def make():
        return [Job(episode=ep, k=k, maxiter=mi,
                    rho=(np.linspace(0.5 + i, 2.0 + i, k).astype(np.float32)
                         if pinned else None),
                    obs_vec=None if pinned else ov)
                for i, ((k, _, mi, pinned), ep, ov) in enumerate(
                    zip(SERVE_JOBS, eps, ovecs))]

    return make


def _served_vs_direct(srv, backend, jobs):
    """Each served lane against ``calibrate_batched`` +
    ``influence_images_batched`` + ``image_sigmas_batched`` on the serving
    buffer and the batch's lane parameters: (bit_identical, per-lane
    largest relative difference)."""
    bep = srv._bep
    with srv._lock:
        policy, prog = srv._policy, srv._programs.get("policy")
    rho, mask, alpha, iters, _ = srv._lane_params(jobs, 0, policy, prog)
    res = backend.calibrate_batched(bep, rho, mask, iters)
    imgs = backend.influence_images_batched(bep, res, rho, alpha)
    sd, sr = backend.image_sigmas_batched(bep, res)
    sig = res.sigma_res.cpu().numpy()
    imgs, sd, sr = imgs.cpu().numpy(), sd.cpu().numpy(), sr.cpu().numpy()
    same, rels = True, []
    for lane, job in enumerate(jobs):
        got = job.future.result(timeout=5)
        want = (float(sig[lane]), float(sd[lane]), float(sr[lane]),
                float(np.std(imgs[lane])))
        have = (got.sigma_res, got.sigma_data_img, got.sigma_res_img,
                got.img_std)
        same &= have == want
        rels.append(max(abs(a - b) / max(abs(b), 1e-30)
                        for a, b in zip(have, want)))
    return same, rels


def _sentinel_beside_worker(events, window):
    """From the serve phase's run log: the sentinel replays on the breaker
    thread whose span overlaps a later ``serve_batch`` span, and the
    breaker's line-search captures that ran during a batch.  Raises unless
    at least one replay overlapped a later batch, or if any compile event
    in the worker's ``window`` (wall-clock seconds) came from another
    thread than the breaker's."""
    def interval(e):
        return float(e["t"]) - float(e["dur_s"]), float(e["t"])

    batches = [(e.get("batch"), interval(e)) for e in events
               if e.get("event") == "span" and e.get("name") == "serve_batch"
               and window[0] <= float(e["t"]) <= window[1]]

    def during_batch(a0, a1, after=-1):
        return [b for b, (b0, b1) in batches
                if b > after and min(a1, b1) - max(a0, b0) > 0]

    overlaps = []
    for e in events:
        if e.get("event") == "span" and e.get("name") == "serve_sentinel" \
                and e.get("thread") == "serve-breaker":
            a0, a1 = interval(e)
            for b in during_batch(a0, a1, after=e["batch"]):
                overlaps.append({"replay_of": e["batch"], "beside": b,
                                 "replay_s": e["dur_s"]})
    comp = [e for e in events if e.get("event") == "compile"
            and window[0] <= float(e["t"]) <= window[1]]
    foreign = [e for e in comp if e.get("thread") != "serve-breaker"]
    captures = [e["dur_s"] for e in comp
                if e.get("thread") == "serve-breaker"
                and str(e.get("key", "")).startswith("cuda_graph")
                and during_batch(*interval(e))]
    if not overlaps or foreign:
        raise AssertionError(f"serve sentinel beside the worker: overlaps "
                             f"{overlaps}, compile events off the breaker "
                             f"thread {foreign}")
    return {"overlaps": overlaps, "captures_s": captures}


def _results(jobs):
    return [(r.sigma_res, r.sigma_data_img, r.sigma_res_img, r.img_std)
            for r in (j.future.result(timeout=5) for j in jobs)]


def _tool(module, args, timeout):
    """``python -m module args`` in a process of its own: (rc, seconds,
    stdout tail)."""
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", module] + args,
                       capture_output=True, text=True, timeout=timeout)
    secs = time.perf_counter() - t0
    if p.returncode != 0:
        raise AssertionError(f"{module} rc {p.returncode}:\n"
                             f"{p.stdout[-3000:]}\n{p.stderr[-3000:]}")
    return secs, p.stdout


def serve_calib_restart(out_dir):
    """Step 7: ``tools.serve_calib --tier medium --policy`` twice against
    one cache directory: the second run must load the exported policy
    program from its ``.pt2`` (one ``export_cache_hit``, no miss), find the
    prepared programs' sidecars (``source == "cache"``), build nothing with
    nvcc and record 0 steady-state compile events."""
    import shutil

    cache = os.path.join(out_dir, "serve_calib_cache")
    shutil.rmtree(cache, ignore_errors=True)
    path = os.path.join(out_dir, "serve_calib.json")
    if os.path.exists(path):
        os.remove(path)
    secs = []
    for _ in range(2):
        s, _ = _tool("smartcal_tpu_torch.tools.serve_calib",
                     SERVE_CALIB + ["--cache-dir", cache, "--out", path], 600)
        secs.append(s)
    doc = json.load(open(path))
    cold, warm = doc["runs"][0], doc["runs"][-1]
    ww = warm["warmup"]
    bad = [k for k, v in ww["sources"].items() if v != "cache"]
    if bad or "policy" not in ww["sources"] \
            or ww["export_cache_hit"] != 1 or ww["export_cache_miss"] \
            or ww["compile_events:nvcc"] \
            or warm["steady_compile_events"] \
            or cold["steady_compile_events"]:
        raise AssertionError(f"serve_calib warm restart: sources "
                             f"{ww['sources']}, policy loads "
                             f"{ww['export_cache_hit']:g} (misses "
                             f"{ww['export_cache_miss']:g}), nvcc builds "
                             f"{ww['compile_events:nvcc']}, "
                             f"steady compile events "
                             f"{cold['steady_compile_events']} / "
                             f"{warm['steady_compile_events']}")
    rate = warm["rates"][0]
    out = dict(process_seconds=secs, restart=doc["restart"],
               cold_sources=cold["warmup"]["sources"],
               warm_sources=warm["warmup"]["sources"],
               cold_nvcc_builds=cold["warmup"]["compile_events:nvcc"],
               cold_graph_captures=cold["warmup"][
                   "compile_events:cuda_graph"],
               warm_graph_captures=warm["warmup"][
                   "compile_events:cuda_graph"],
               warm_rate=rate)
    shutil.rmtree(cache, ignore_errors=True)
    print(f"serve_calib --tier medium twice (processes {secs[0]:.1f} s, "
          f"{secs[1]:.1f} s): warmup cold {doc['restart']['cold_warmup_s']} "
          f"s ({out['cold_nvcc_builds']:g} nvcc builds, sources "
          f"{out['cold_sources']}), warm {doc['restart']['warm_warmup_s']} s "
          f"(0 nvcc builds, the policy program loaded from its .pt2, "
          f"the prepared programs' sidecars found, "
          f"{out['warm_graph_captures']:g} line-search captures at warmup), "
          f"steady compile events 0 and 0; warm run {rate['completed']}/"
          f"{rate['submitted']} jobs at {rate['offered_rate']} jobs/s, p50 "
          f"{rate.get('latency_p50_s')} s", flush=True)
    return out


def serve_phase(dev, out_dir, zero_counts, read_counts, n_sm, deep=False):
    """The serving slice: one CalibServer at the reference backend (N=62),
    M=10, 4 lanes, a fresh SAC policy armed (obs_dim 128^2 + 11*7):
    (1) a cold warmup into an empty cache; (2) one heterogeneous
    ``process_once`` batch, 0 compile events, each lane bit for bit the
    direct batched calls; (3) the worker serves 12 submitted jobs (3
    batches), the breaker thread replaying each batch's sentinel lane while
    the worker serves the next (the overlap is read from the run log, and
    no compile event may come from a thread but the breaker's); (4)
    ``swap_policy`` to version 1 with the same weights, the same batch again
    bit for bit; the policy program against the eager actor at version 0's
    weights, then ``swap_policy`` to perturbed weights (version 2): the
    served rho is the eager forward's of those weights and not version
    0's; (5) ``sentinel_poll``: kernel 1 launched by the replay and held
    against its plain version at the replay's operands; (6) stop, and a
    second server on the same cache warms up from it (the policy program
    loaded from its .pt2, the prepared programs' sidecars found, 0 nvcc
    builds).  ``deep`` (``--serve``) adds the open-loop load generator at
    two fractions of the capacity, 200 requests each, (7)
    ``tools.serve_calib --tier medium`` twice on one cache, the replica
    fleet (2 processes, a kill) and the online lifecycle."""
    import copy
    import shutil

    from smartcal_tpu_torch import obs, prng
    from smartcal_tpu_torch.envs import calib as calib_env
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.ops import dft_imager
    from smartcal_tpu_torch.rl import sac
    from smartcal_tpu_torch.serve import CalibServer, Job, loadgen

    t_phase = time.perf_counter()
    out = {}
    backend = RadioBackend(device=dev, **N62)
    obs_dim = backend.npix * backend.npix + (SERVE_M + 1) * 7
    cfg = sac.SACConfig(obs_dim=obs_dim, n_actions=2 * SERVE_M)
    st = sac.sac_init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    params = {k: v.detach().clone() for k, v in st.actor.state_dict().items()}
    cache = os.path.join(out_dir, "serve_cache")
    shutil.rmtree(cache, ignore_errors=True)
    run = os.path.join(out_dir, "serve_run.jsonl")
    if os.path.exists(run):
        os.remove(run)
    make_jobs = _serve_jobs(backend, obs_dim, Job, prng)
    with obs.recording(run, meta={"entry": "chip_smoke.serve_phase"}):
        obs.install_compile_listener()
        srv = CalibServer(backend, M=SERVE_M, lanes=SERVE_LANES,
                          cache_dir=cache, policy=(cfg, params),
                          compile_cache=False, max_wait_s=0.05,
                          poll_s=0.05)
        # (1) cold warmup
        t0 = time.perf_counter()
        warm = srv.warmup(seed=0)
        cold_s = time.perf_counter() - t0
        if warm["sources"] != {"solve": "export", "influence": "export",
                               "policy": "export"}:
            raise AssertionError(f"serve warmup into an empty cache: "
                                 f"{warm['sources']}")
        # (2) one heterogeneous batch
        jobs = make_jobs()
        zero_counts()
        c0 = obs.counters_snapshot()
        t0 = time.perf_counter()
        n = srv.process_once(jobs, timeout=0.01)
        batch_s = time.perf_counter() - t0
        d_batch = _compile_delta(c0, obs.counters_snapshot())
        batch_launches = read_counts()
        if n != SERVE_LANES or d_batch["compile_events"]:
            raise AssertionError(f"serve batch: {n} jobs, compile events "
                                 f"{d_batch}")
        v0 = _results(jobs)
        same, rels = _served_vs_direct(srv, backend, jobs)
        if not same:
            raise AssertionError(f"served lanes differ from the direct "
                                 f"batched calls: relative {rels}")
        print(f"serve (N=62, M={SERVE_M}, {SERVE_LANES} lanes, policy "
              f"armed): cold warmup {cold_s:.2f} s "
              f"({warm['export_cache_miss']:g} cache misses, "
              f"{warm['compile_events:cuda_graph']:g} line-search captures, "
              f"{warm['compile_events:nvcc']:g} nvcc "
              f"builds); one heterogeneous batch (k 2/5/7/10, a diffuse "
              f"sky, maxiter None/9/12, 2 pinned + 2 policy jobs) "
              f"{batch_s:.2f} s, 0 compile events, every lane bit for bit "
              f"the direct batched calls", flush=True)
        # (3) the supervised worker, every batch's sentinel lane replayed
        # on the breaker thread while the worker serves the next batch
        srv.sentinel_every = 1
        srv.start()
        c0 = obs.counters_snapshot()
        t0 = time.perf_counter()
        t_worker = time.time()
        futs = [srv.submit(j) for _ in range(SERVE_WORKER_JOBS // 4)
                for j in make_jobs()]
        res = [f.result(timeout=600) for f in futs]
        worker_s = time.perf_counter() - t0
        time.sleep(0.2)
        # the sentinel replays on the breaker thread: wait for the last
        deadline = time.monotonic() + 300
        while srv._sentinel_pending is not None \
                and time.monotonic() < deadline:
            time.sleep(0.1)
        srv.stop(timeout=120)           # joins a replay still running
        t_worker = (t_worker, time.time())
        d_worker = _compile_delta(c0, obs.counters_snapshot())
        wst = srv.stats()
        if not all(np.isfinite(r.sigma_res) for r in res) \
                or wst["failed"] or wst["circuit_open"] \
                or wst["sentinel"]["replayed"] < SERVE_WORKER_JOBS // 4:
            raise AssertionError(f"serve worker: compile events {d_worker}, "
                                 f"stats {wst}")
        per_batch = worker_s / max(1, wst["batches"] - 2)
        print(f"serve worker: {len(res)} jobs in {worker_s:.2f} s over "
              f"{wst['batches'] - 2} batches ({per_batch:.2f} s per batch), "
              f"sentinel replays on the breaker thread: "
              f"{wst['sentinel']['replayed']} "
              f"({d_worker['serve_oracle_captures']:g} per-solve line-search "
              f"captures, {d_worker['serve_oracle_capture_secs']:.3f} s)",
              flush=True)
        # (4) swap to version 1 with the same weights, the batch again
        srv.sentinel_every = 1
        swap = srv.swap_policy(params, 1)
        jobs1 = make_jobs()
        c0 = obs.counters_snapshot()
        srv.process_once(jobs1, timeout=0.01)
        d_swap = _compile_delta(c0, obs.counters_snapshot())
        v1 = _results(jobs1)
        if v1 != v0 or d_swap["compile_events"]:
            raise AssertionError(f"version-1 batch differs from version 0 "
                                 f"({v0} vs {v1}) or compiled {d_swap}")
        # (4b) the policy program against the eager actor at the batch's
        # 4-lane operands, at version 0's weights and at perturbed ones
        # (version 2): a program that baked in its example weights fails
        ovec = np.zeros((SERVE_LANES, obs_dim), np.float32)
        for lane, j in enumerate(jobs1):
            if j.obs_vec is not None:
                ovec[lane] = j.obs_vec
        policy_lanes = [i for i, j in enumerate(jobs1) if j.rho is None]
        gen = torch.Generator(device=dev).manual_seed(2)
        params2 = {k: v + 0.05 * torch.randn(v.shape, generator=gen,
                                             device=dev, dtype=v.dtype)
                   for k, v in params.items()}

        def eager_heads(actor_params):
            actor = copy.deepcopy(st.actor)
            actor.load_state_dict(actor_params)
            return [a.cpu().numpy() for a in sac.policy_heads(
                cfg, actor, torch.as_tensor(ovec, device=dev))]

        def served(jobs):
            with srv._lock:
                pol, prog = srv._policy, srv._programs["policy"]
            heads = srv._policy_forward(prog, pol[1], ovec)
            return prog, heads, srv._lane_params(jobs, 0, pol, prog)[0]

        def eager_rho(heads):
            lo, hi = calib_env.LOW, calib_env.HIGH
            return np.clip(heads[0] * (hi - lo) / 2 + (hi + lo) / 2, lo, hi)

        prog0, heads0, rho0 = served(jobs1)
        err0 = max(float(np.max(np.abs(a - b)))
                   for a, b in zip(heads0, eager_heads(params)))
        swap2 = srv.swap_policy(params2, 2)
        jobs2 = make_jobs()
        prog2, heads2, rho2 = served(jobs2)
        e2 = eager_heads(params2)
        err2 = max(float(np.max(np.abs(a - b))) for a, b in zip(heads2, e2))
        want2 = eager_rho(e2)
        rho_err = max(float(np.max(np.abs(rho2[i, :j.k] - want2[i, :j.k])
                                    / want2[i, :j.k]))
                      for i, j in enumerate(jobs2) if i in policy_lanes)
        rho_moved = min(float(np.max(np.abs(rho2[i] - rho0[i]) / rho0[i]))
                        for i in policy_lanes)
        c0 = obs.counters_snapshot()
        srv.process_once(jobs2, timeout=0.01)
        d_swap2 = _compile_delta(c0, obs.counters_snapshot())
        v2 = _results(jobs2)
        if prog2 is not prog0 or err0 > 1e-5 or err2 > 1e-5 \
                or rho_err > 1e-5 or rho_moved < 1e-2 \
                or d_swap2["compile_events"] \
                or any(v2[i] == v0[i] for i in policy_lanes) \
                or not all(np.isfinite(v2).ravel()):
            raise AssertionError(
                f"policy program vs the eager actor: heads max abs "
                f"{err0:.3e} (v0) / {err2:.3e} (v2), served rho vs eager "
                f"{rho_err:.3e}, moved {rho_moved:.3e} from v0, compile "
                f"{d_swap2}, v2 {v2} vs v0 {v0}")
        print(f"serve policy program vs the eager actor (4 lanes): heads "
              f"max abs {err0:.3e} at v0's weights, {err2:.3e} at "
              f"perturbed weights (v2, swap {swap2['swap_s'] * 1e3:.2f} ms, "
              f"the same program); served rho vs eager {rho_err:.3e} "
              f"relative, moved {rho_moved:.3e} from v0's on every policy "
              f"lane; the v2 batch's policy lanes differ from v0's, 0 "
              f"compile events (tolerance 1e-5)", flush=True)
        # (5) the sentinel's replay: kernel 1's launches and operands
        spy = FirstCall(dft_imager, "dirty_image_cuda")
        zero_counts()
        c0 = obs.counters_snapshot()
        t0 = time.perf_counter()
        try:
            ev = srv.sentinel_poll()
        finally:
            spy.restore()
        sent_s = time.perf_counter() - t0
        sent_launches = read_counts()
        d_sent = _compile_delta(c0, obs.counters_snapshot())
        want = 2 * backend.n_freqs          # data + residual, Nf bands each
        if ev is None or sent_launches["dft_imager"] != want:
            raise AssertionError(f"sentinel replay: event {ev}, launches "
                                 f"{sent_launches} (expected {want})")
        (uv, vis, npix, cell), _ = spy.args
        err = check_imager(dft_imager, uv, vis, npix, cell,
                           "serve sentinel replay")
        lm = dft_imager.pixel_grid(npix, cell, dev)
        k_ms = cuda_ms(lambda: dft_imager.dirty_image_cuda(uv, vis, npix,
                                                           cell), 20)
        plain_ms = cuda_ms(lambda: dft_imager.dirty_image_reference(
            uv, lm, vis), 5)
        bnd = separable_bounds(npix, uv.shape[0], n_sm)
        print(f"serve swap to v1 (same weights): {swap['swap_s'] * 1e3:.2f} "
              f"ms, the batch bit for bit version 0's, 0 compile events; "
              f"sentinel replay {sent_s:.2f} s, kernel 1 launched "
              f"{sent_launches['dft_imager']} times, "
              f"{d_sent['compile_events:cuda_graph']:g} line-search "
              f"captures ({d_sent['compile_secs']:.3f} s); "
              f"relative errors solve {ev['rel_err_solve']:.3e} influence "
              f"{ev['rel_err_influence']:.3e} sigma {ev['rel_err_sigma']:.3e}"
              f" (reported, not judged: the full-depth solve is chaotic in "
              f"float32); kernel 1 at P={npix * npix} R={uv.shape[0]}: "
              f"{k_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bnd['bound_ms']:.4f} ms ({bnd['bound_by']})", flush=True)
        if deep:
            out["loadgen"] = serve_loadgen(srv, backend, loadgen,
                                           SERVE_LANES / batch_s)
        srv.stop()
        # a warm restart in this process: a second server on the same
        # cache loads every program (the line search is captured again)
        srv2 = CalibServer(backend, M=SERVE_M, lanes=SERVE_LANES,
                           cache_dir=cache, policy=(cfg, params),
                           compile_cache=False)
        t0 = time.perf_counter()
        warm2 = srv2.warmup(seed=0)
        warm_s = time.perf_counter() - t0
        if set(warm2["sources"].values()) != {"cache"} \
                or warm2["export_cache_hit"] != 1 \
                or warm2["export_cache_miss"] \
                or warm2["export_cache_prepared_hit"] != 2 \
                or warm2["compile_events:nvcc"]:
            raise AssertionError(f"serve warm restart: {warm2}")
        print(f"serve warm restart on the same cache: warmup {warm_s:.2f} s "
              f"(cold {cold_s:.2f} s), the policy program loaded from its "
              f".pt2 (1 hit, 0 misses), the 2 prepared programs' sidecars "
              f"found, 0 nvcc builds, "
              f"{warm2['compile_events:cuda_graph']:g} line-search "
              f"capture", flush=True)
        del srv2
        obs.flush_counters()
    events = _fleet_events(run)
    spans = {}
    for e in events:
        if e.get("event") == "span" and str(e.get("name", "")).startswith(
                "serve_"):
            spans.setdefault(e["name"], []).append(float(e["dur_s"]))
    span_ms = {k: {"n": len(v), "median_ms": 1e3 * float(np.median(v))}
               for k, v in spans.items()}
    print("serve spans (median ms): " + ", ".join(
        f"{k} {v['median_ms']:.1f} (n={v['n']})"
        for k, v in sorted(span_ms.items())), flush=True)
    beside = _sentinel_beside_worker(events, t_worker)
    print(f"serve sentinel beside the worker (run log): "
          f"{len(beside['overlaps'])} replays overlapped a later batch "
          f"({beside['overlaps']}); line-search captures on the breaker "
          f"thread during a batch {beside['captures_s']} s; compile events "
          f"from the worker's thread 0", flush=True)
    out.update(warmup=warm, cold_warmup_s=cold_s, warm_restart=warm2,
               warm_warmup_s=warm_s, batch_s=batch_s,
               batch_compile=d_batch, batch_launches=batch_launches,
               worker=dict(jobs=len(res), seconds=worker_s,
                           seconds_per_batch=per_batch, stats=wst,
                           compile=d_worker, sentinel_beside=beside),
               swap=dict(swap, compile=d_swap, bit_identical=True),
               policy_check=dict(heads_err_v0=err0, heads_err_v2=err2,
                                 rho_err_v2=rho_err, rho_moved=rho_moved,
                                 swap_v2=swap2, compile=d_swap2),
               sentinel=dict(event=ev, seconds=sent_s, compile=d_sent,
                             launches=sent_launches),
               spans=span_ms, launches=sent_launches,
               kernel=dict(P=npix * npix, R=uv.shape[0], max_abs_err=err,
                           ms=k_ms, plain_ms=plain_ms, **bnd))
    del srv
    shutil.rmtree(cache, ignore_errors=True)
    torch.cuda.empty_cache()
    if deep:
        # the restart (~55 s of two processes) would take the default run
        # past ~900 s on a slow host: it runs under --serve
        out["serve_calib"] = serve_calib_restart(out_dir)
        out["fleet"] = serve_fleet_run(out_dir)
        out["lifecycle"] = serve_learn_run(out_dir)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"serve phase {out['seconds']:.1f} s", flush=True)
    return out


def serve_loadgen(srv, backend, loadgen, capacity):
    """--serve: the open-loop load generator on the N=62 server (its worker
    restarted), a pool of 4 heterogeneous episodes, at two fractions of
    ``capacity`` (jobs/s: lanes over one batch's seconds), each long enough
    for ``SERVE_LOAD_JOBS`` requests, so that the p99 rests on some
    hundreds of requests in a steady queue rather than on a handful."""
    pool = loadgen.build_job_pool(backend, SERVE_M, 4, seed=1)
    srv.sentinel_every = 0
    srv.start()
    rates = []
    try:
        for frac in SERVE_LOAD_FRACTIONS:
            rate = frac * capacity
            b0 = srv.stats()["batches"]
            gen = loadgen.OpenLoopLoadGen(
                srv, pool, rate=rate, duration_s=SERVE_LOAD_JOBS / rate,
                seed=0, maxiter_choices=(None, 9, 12))
            r = gen.run(drain_timeout_s=600.0)
            if r["accounted"] != r["submitted"] or r["failed"]:
                raise AssertionError(f"load generator at {rate}: {r}")
            r.update(capacity_jobs_s=capacity, fraction=frac,
                     batches=srv.stats()["batches"] - b0)
            rates.append(r)
            print(f"serve load {frac} x capacity ({rate:.4f} jobs/s of "
                  f"{capacity:.4f}) for {r['duration_s']:.1f} s: "
                  f"{r['completed']}/{r['submitted']} completed in "
                  f"{r['batches']} batches, shed {r['shed']}, "
                  f"{r.get('achieved_jobs_s')} jobs/s, latency p50 "
                  f"{r.get('latency_p50_s')} s p99 {r.get('latency_p99_s')} "
                  f"s, queue wait p50 {r.get('queue_wait_p50_s')} s p99 "
                  f"{r.get('queue_wait_p99_s')} s", flush=True)
    finally:
        srv.stop(timeout=120)
    return rates


def serve_fleet_run(out_dir):
    """--serve: ``tools.serve_fleet`` with 2 replica processes on the card
    (medium tier), a replica killed mid-run and requeued; the second
    replica warm-starts off the shared cache and builds nothing."""
    import shutil

    root = os.path.join(out_dir, "serve_fleet")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    path = os.path.join(root, "fleet.json")
    secs, _ = _tool("smartcal_tpu_torch.tools.serve_fleet",
                    SERVE_FLEET + ["--cache-dir", os.path.join(root, "cache"),
                                   "--trace-dir", os.path.join(root, "tr"),
                                   "--out", path], 900)
    rec = json.load(open(path))["runs"][-1]
    pt, kill = rec["scaling"][0], rec["kill"]
    builds = {}
    for name in sorted(os.listdir(os.path.join(root, "tr", "scale2x1"))):
        if name.startswith("replica") and name.endswith(".jsonl"):
            ev = _fleet_events(os.path.join(root, "tr", "scale2x1", name))
            builds[name] = sum(1 for e in ev if e.get("event") == "compile"
                               and str(e.get("key", "")).startswith("nvcc"))
    warm1 = pt["warm_sources"].get("1") or pt["warm_sources"].get(1)
    if warm1 != ["cache"] or builds.get("replica1-g0.jsonl", 1) \
            or pt["steady_compile_events_fleet"] \
            or kill["summary"]["completed"] != kill["summary"]["submitted"] \
            or kill["replica_restarts"] < 1:
        raise AssertionError(f"serve fleet: warm sources {pt['warm_sources']}"
                             f", nvcc builds {builds}, steady "
                             f"{pt['steady_compile_events_fleet']}, kill "
                             f"{kill}")
    s = pt["summary"]
    print(f"serve fleet (2 replica processes, medium tier, {secs:.1f} s): "
          f"boot {pt['boot_s']} s, replica 1 all from the cache with 0 nvcc "
          f"builds ({builds}), {s.get('achieved_jobs_s')} jobs/s at "
          f"{pt['offered_rate']} offered, p99 {s.get('latency_p99_s')} s, "
          f"fleet steady compile events 0; kill: "
          f"{kill['summary']['completed']}/{kill['summary']['submitted']} "
          f"completed, requeued {kill['requeued']}, recovered in "
          f"{kill['recover_s']} s", flush=True)
    shutil.rmtree(os.path.join(root, "cache"), ignore_errors=True)
    return dict(record=rec, nvcc_builds=builds, seconds=secs)


def serve_learn_run(out_dir):
    """--serve: ``tools.serve_learn`` (medium tier): >= 3 publishes, 0
    compile events in the serving window."""
    import shutil

    root = os.path.join(out_dir, "serve_learn")
    shutil.rmtree(root, ignore_errors=True)
    path = os.path.join(root, "learn.json")
    secs, _ = _tool("smartcal_tpu_torch.tools.serve_learn",
                    SERVE_LEARN + ["--cache-dir", os.path.join(root, "cache"),
                                   "--out", path], 900)
    rec = json.load(open(path))
    life, serving = rec["lifecycle"], rec["serving"]
    if life["swaps"] < 3 or serving["steady_compile_events"] \
            or serving["failed"]:
        raise AssertionError(f"serve_learn: swaps {life['swaps']}, compile "
                             f"events {serving['steady_compile_events']}, "
                             f"failed {serving['failed']}")
    print(f"serve_learn (medium tier, {secs:.1f} s): {life['swaps']} "
          f"publishes (p50 {life['publish_ms_p50']} ms), 0 compile events "
          f"in the window, {serving['completed']}/{serving['submitted']} "
          f"jobs, p99 {serving['latency_p99_s']} s, sigma_res "
          f"{[s['sigma_res_mean'] for s in life['sigma_res_trajectory']]}",
          flush=True)
    shutil.rmtree(os.path.join(root, "cache"), ignore_errors=True)
    return dict(record=rec, seconds=secs)


# -- the sharded calibration routes: k positions on the one card ------------

SHARD_FP, SHARD_SP, SHARD_BP, SHARD_LANES = 3, 2, 4, 4
# the held solve's depth: tests/test_sharded_cal.py's shallow L-BFGS (init 4,
# 3 per outer iteration) at 2 ADMM iterations; with the N=62 phase's 30 init
# iterations the float32 solve is chaotic already (a 1-ulp change of V moves
# it as far as the psum's reassociation does), so that depth is reported
# beside the 1-ulp spread, not held
SHARD_SHALLOW = {"init_iters": 4, "lbfgs_iters": 3, "admm_iters": 2}
SHARD_SHALLOW_ADMM = SHARD_SHALLOW["admm_iters"]
ULP = 1 + 2 ** -23
# tests/test_sharded_cal.py: J and Z (rtol, atol), the residual's relative
# norm, sigma_res relative; tests/test_mesh_compose.py: the composed images
SHARD_SOLVE_TOL = {"J": (5e-3, 5e-4), "Z": (5e-3, 5e-4), "residual": 1e-3,
                   "sigma_res": 1e-3}
SHARD_INFL_REL = 1e-4
# (rtol, atol): the atol is this times max|ref| (the rule of the script's
# large cases): the images' far pixels are near zero while their centre
# reaches ~1e3, so an absolute 2e-5 would hold round-off to ~1e-8 relative
SHARD_COMPOSE_TOL = (2e-3, 2e-5)
SHARD_COMPOSE = (2, 2)            # (lanes, baselines) at N=256, E=2


class positions:
    """``parallel/mesh.default_devices`` replaced by ``k`` positions on
    ``dev`` for a block: the backend's routes lay their meshes over them
    (the port's way to run a mesh of k on one card)."""

    def __init__(self, dev, k):
        self.devices = [dev] * k

    def __enter__(self):
        from smartcal_tpu_torch.parallel import mesh
        self.mesh, self.orig = mesh, mesh.default_devices
        mesh.default_devices = lambda device=None: list(self.devices)
        return self

    def __exit__(self, *exc):
        self.mesh.default_devices = self.orig


class ThreadCalls:
    """Stands in for ``module.name`` and keeps the arguments of the first
    call each thread makes (a sharded route's positions call from threads
    of their own), keyed by thread name."""

    def __init__(self, module, name):
        import threading
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.calls, self.lock = {}, threading.Lock()
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        import threading
        with self.lock:
            self.calls.setdefault(threading.current_thread().name,
                                  (args, kw))
        return self.fn(*args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def timed_s(fn):
    """(fn(), seconds), the device synchronized before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def solve_gap(got, want):
    """The sharded solve against another: J and Z as tolerance ratios
    (<= 1 within ``SHARD_SOLVE_TOL``), the residual's relative norm and
    sigma_res's relative difference."""
    out = {k: tol_ratio(getattr(got, k).cpu(), getattr(want, k).cpu(),
                        *SHARD_SOLVE_TOL[k]) for k in ("J", "Z")}
    out["residual"] = rel_norm(got.residual, want.residual)
    out["sigma_res"] = abs(float(got.sigma_res) / float(want.sigma_res) - 1)
    out["held"] = (out["J"] <= 1 and out["Z"] <= 1
                   and out["residual"] < SHARD_SOLVE_TOL["residual"]
                   and out["sigma_res"] < SHARD_SOLVE_TOL["sigma_res"])
    return out


def span_routes(path):
    """(name, route, shards) of the solve and influence spans of a run
    log."""
    out = []
    for line in open(path):
        ev = json.loads(line)
        if ev.get("event") == "span" and ev.get("name") in ("solve",
                                                            "influence"):
            out.append((ev["name"], ev.get("route"),
                        ev.get("shards", ev.get("baseline_shards"))))
    return out


def sharded_n62_checks(dev, ep, backend, res, res_s, rho, mask, alpha):
    """The frequency and chunk routes on the N=62 phase's episode and fused
    solve (``res``, which took ``res_s`` seconds), ``SHARD_FP`` fp
    positions on the card: a shallow ``solve_admm_sharded``
    (``SHARD_SHALLOW``) held against ``solve_admm`` at the CPU tests'
    tolerances; the full-depth one held finite with sigma_res <
    sigma_data, its gap to the fused solve reported beside the gap of
    ``solve_admm`` under a 1-ulp change of V to the fused solve (the solve
    is chaotic in float32 at the N=62 depth); ``influence_images_sharded`` and
    a ``SHARD_SP``-position ``influence_sharded`` (band 0) on the fused
    solve against the single-device influence (relative norm 1e-4, the
    same bits twice).  Each beside the single-device route's seconds."""
    from smartcal_tpu_torch.cal import influence, solver
    from smartcal_tpu_torch.parallel import mesh as pm
    from smartcal_tpu_torch.parallel import sharded_cal as sc
    cfg = backend._solver_cfg(ep.n_dirs)
    C = ep.Ccal * torch.as_tensor(mask, device=dev)[None, :, None, None,
                                                    None]
    r = torch.as_tensor(rho, device=dev)
    n_ch, N, npix = backend.n_chunks, backend.n_stations, backend.npix
    fp = pm.make_mesh((SHARD_FP,), (pm.AXIS_FREQ,), devices=[dev] * SHARD_FP)
    sp = pm.make_mesh((SHARD_SP,), (pm.AXIS_CHUNK,),
                      devices=[dev] * SHARD_SP)
    out = {"positions": {"fp": SHARD_FP, "sp": SHARD_SP}}

    def single(c=cfg, V=ep.V, **kw):
        return solver.solve_admm(V, C, ep.obs.freqs, ep.f0, r, c,
                                 n_chunks=n_ch, **kw)

    def sharded(c=cfg, **kw):
        return sc.solve_admm_sharded(fp, ep.V, C, ep.obs.freqs, ep.f0, r, c,
                                     n_chunks=n_ch, **kw)

    def gap_text(g):
        return (f"J {g['J']:.3f}, Z {g['Z']:.3f} of the tolerance, residual "
                f"rel {g['residual']:.3e}, sigma_res rel {g['sigma_res']:.3e}")

    shallow = cfg._replace(init_iters=SHARD_SHALLOW["init_iters"],
                           lbfgs_iters=SHARD_SHALLOW["lbfgs_iters"])
    adm = {"admm_iters": SHARD_SHALLOW_ADMM}
    ref, t_ref = timed_s(lambda: single(shallow, **adm))
    got, t_got = timed_s(lambda: sharded(shallow, **adm))
    gap = solve_gap(got, ref)
    ulp = solve_gap(single(shallow, ep.V * ULP, **adm), ref)
    print(f"sharded solve (N=62, {SHARD_FP} fp positions, {SHARD_SHALLOW}): "
          f"{t_got:.3f} s against solve_admm's {t_ref:.3f} s; "
          f"{gap_text(gap)} -> {'ok' if gap['held'] else 'FAIL'} (a 1-ulp "
          f"change of V moves solve_admm by {gap_text(ulp)})", flush=True)
    if not gap["held"]:
        raise AssertionError("the shallow sharded solve is outside the CPU "
                             "tests' tolerances of solve_admm")
    out["shallow"] = dict(gap, seconds=t_got, single_seconds=t_ref,
                          depth=SHARD_SHALLOW, ulp_spread=ulp)
    del got, ref
    full, t_full = timed_s(sharded)
    ulp = solve_gap(single(V=ep.V * ULP), res)
    ok = (solver.result_finite(full)
          and float(full.sigma_res) < float(full.sigma_data))
    gap = solve_gap(full, res)
    print(f"sharded solve at full depth: {t_full:.3f} s against the fused "
          f"solve's {res_s:.3f} s; finite with sigma_res "
          f"{float(full.sigma_res):.6f} < sigma_data "
          f"{float(full.sigma_data):.6f}: {ok}; gap to the fused solve: "
          f"{gap_text(gap)} (solve_admm under a 1-ulp change of V: "
          f"{gap_text(ulp)})", flush=True)
    if not ok:
        raise AssertionError("the full-depth sharded solve is not finite or "
                             "did not reduce the residual")
    out["full"] = dict(gap, seconds=t_full, fused_seconds=res_s,
                       sigma_res=float(full.sigma_res),
                       sigma_data=float(full.sigma_data), ulp_spread=ulp)
    del full

    statics = backend._influence_statics(npix)
    hadd_all = influence.consensus_hadd_all(
        np.asarray(rho, np.float32), np.asarray(alpha, np.float32),
        ep.obs.freqs, ep.f0, n_poly=backend.n_poly,
        polytype=backend.polytype)
    uvw = ep.obs.uvw.reshape(-1, 3)
    cell = backend._cell(ep)
    img_ref, t_img_ref = timed_s(lambda: backend.influence_image(
        ep, res, rho, alpha))

    def freq_image():
        return sc.influence_images_sharded(
            fp, res.residual, ep.Ccal, res.J, hadd_all, ep.obs.freqs, uvw,
            cell, N, n_ch, npix, **statics)

    img, t_img = timed_s(freq_image)
    img2, t_img2 = timed_s(freq_image)
    Rk = solver.residual_to_kernel(res.residual[0])
    kw = {"block_baselines": statics["block_baselines"],
          "precision": statics["precision"]}
    vis_ref, t_vis_ref = timed_s(lambda: influence.influence_visibilities(
        Rk, ep.Ccal[0], res.J[0], hadd_all[0], N, n_ch, **kw))

    def chunk_vis():
        return sc.influence_sharded(sp, Rk, ep.Ccal[0], res.J[0],
                                    hadd_all[0], N, n_ch, **kw)

    vis, t_vis = timed_s(chunk_vis)
    vis2, _ = timed_s(chunk_vis)
    e_img, e_vis = rel_norm(img, img_ref), rel_norm(vis.vis, vis_ref.vis)
    e_llr = rel_norm(vis.llr, vis_ref.llr)
    same = (torch.equal(img, img2) and torch.equal(vis.vis, vis2.vis)
            and torch.equal(vis.llr, vis2.llr))
    print(f"influence_images_sharded ({SHARD_FP} fp positions): {t_img:.4f} "
          f"/ {t_img2:.4f} s against the single-device route's "
          f"{t_img_ref:.4f} s, image rel {e_img:.3e}; influence_sharded "
          f"({SHARD_SP} sp positions, band 0): {t_vis:.4f} s against "
          f"{t_vis_ref:.4f} s, vis rel {e_vis:.3e}, llr rel {e_llr:.3e}; "
          f"the same bits twice: {same}", flush=True)
    if not (max(e_img, e_vis, e_llr) <= SHARD_INFL_REL and same):
        raise AssertionError("a sharded influence route disagrees with the "
                             "single-device one, or with itself")
    out["influence"] = {
        "freq_sharded_s": [t_img, t_img2], "single_s": t_img_ref,
        "image_rel": e_img, "chunk_sharded_s": t_vis,
        "chunk_single_s": t_vis_ref, "vis_rel": e_vis, "llr_rel": e_llr,
        "same_bits": same}
    return out


def sharded_ska_checks(dev, backend, ep, res, rho, alpha, zero_counts,
                       read_counts, n_sm, ref=None):
    """The baseline route at the SKA tier, ``SHARD_BP`` bp positions on the
    card: ``influence_image`` routed ``baseline_sharded`` against the
    single-device route (relative norm 1e-4; ``ref`` the path's own image
    too), its launches counted (kernel 3 once per position, interval and
    band; kernel 2 once per band, on the gathered visibilities), and each
    position's first kernel-3 launch (the subset layout, B/4 baselines)
    timed beside the single-device launch (the full-set layout) and held
    against the plain version."""
    from smartcal_tpu_torch.cal import kernels
    from smartcal_tpu_torch.ops import hessian_blocks
    full = FirstCall(hessian_blocks, "hessian_block_sums_cuda")
    try:
        single, t_single = timed_s(lambda: backend.influence_image(
            ep, res, rho, alpha))
    finally:
        full.restore()
    calls = ThreadCalls(hessian_blocks, "hessian_block_sums_cuda")
    try:
        with positions(dev, SHARD_BP):
            zero_counts()
            img, t_img = timed_s(lambda: backend.influence_image(
                ep, res, rho, alpha))
            launches = read_counts()
    finally:
        calls.restore()
    e_img = rel_norm(img, single)
    e_ref = rel_norm(img, ref) if ref is not None else None
    want = {"hessian_blocks": SHARD_BP * backend.n_chunks * backend.n_freqs,
            "factored_imager": backend.n_freqs}
    print(f"baseline-sharded influence_image (SKA, {SHARD_BP} bp "
          f"positions): {t_img:.3f} s against the single-device route's "
          f"{t_single:.3f} s; image rel {e_img:.3e} (to the step's own "
          f"{e_ref}); launches {launches} (want {want})", flush=True)
    if not (e_img <= SHARD_INFL_REL
            and (e_ref is None or e_ref <= SHARD_INFL_REL)):
        raise AssertionError("the baseline-sharded influence disagrees with "
                             "the single-device route")
    if any(launches[k] != v for k, v in want.items()):
        raise AssertionError(f"baseline-sharded launches {launches}, "
                             f"expected {want}")
    fargs, fkw = full.args
    f_ms = cuda_ms(lambda: hessian_blocks.hessian_block_sums_cuda(
        *fargs, **fkw), 20)
    f_bound = hessian_bound_ms(fargs, n_sm)
    pos = []
    for name in sorted(calls.calls):
        a, kw = calls.calls[name]
        err = check_hessian(hessian_blocks, kernels, a, kw,
                            f"sharded SKA position {name} B={a[1].shape[2]}")
        pos.append({"thread": name, "B": int(a[1].shape[2]),
                    "ms": cuda_ms(lambda: hessian_blocks.
                                  hessian_block_sums_cuda(*a, **kw), 20),
                    "bound_ms": hessian_bound_ms(a, n_sm)[0],
                    "max_abs_err": max(err)})
    B = fargs[1].shape[2]
    print(f"kernel 3 per position (subset layout, {pos[0]['B']} baselines): "
          + ", ".join(f"{p['ms']:.4f}" for p in pos)
          + f" ms (bound {pos[0]['bound_ms']:.4f}); the single-device "
          f"launch (full set, {B} baselines) {f_ms:.4f} ms (bound "
          f"{f_bound[0]:.4f}): per baseline "
          f"{1e6 * np.mean([p['ms'] for p in pos]) / pos[0]['B']:.3f} ns "
          f"against {1e6 * f_ms / B:.3f} ns", flush=True)
    return {"positions": SHARD_BP, "seconds": t_img,
            "single_seconds": t_single, "image_rel": e_img,
            "image_rel_to_step": e_ref, "launches": launches,
            "kernel3_positions": pos, "kernel3_single_ms": f_ms,
            "kernel3_single_bound_ms": f_bound[0]}


def sharded_phase(dev, out_dir, zero_counts, read_counts, n_sm):
    """``--sharded``: the backend's routes with k positions on the card.
    A routed N=62 CalibEnv reset and step (``SHARD_FP`` positions: the
    ``sharded`` solve and the ``freq_sharded`` influence, the tags read
    from the run log's spans) beside the same seed unsharded; the N=62
    checks of the default run on its episode; BatchedCalibEnv(E=4) reset
    and step with ``SHARD_LANES`` positions (``batched_sharded``) beside
    the unsharded one; at N=256, E=2 lanes solved, then the composed lane x
    baseline influence (``batched_lane_bshard``, ``SHARD_COMPOSE``) against
    the vmap route, the composed solve beside the vmap one (shallow), and
    lane 0's ``baseline_sharded`` influence image (the default run's SKA
    checks)."""
    from smartcal_tpu_torch import obs, prng
    from smartcal_tpu_torch.cal import solver
    from smartcal_tpu_torch.envs.calib import BatchedCalibEnv, CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    report = {}
    log = os.path.join(out_dir, "sharded_run.jsonl")

    def routed(k, fn):
        rl = obs.activate(obs.RunLog(log, flush_lines=1))
        try:
            with positions(dev, k):
                zero_counts()
                out = fn()
                launches = read_counts()
        finally:
            obs.deactivate(rl)
            rl.close()
        return out, launches, span_routes(log)

    def env_run(env):
        t0 = time.perf_counter()
        obs0 = env.reset()
        t_reset = time.perf_counter() - t0
        obs1, steps = run_steps(env, 1)
        return obs0, obs1, t_reset, steps

    plain = CalibEnv(M=10, backend=RadioBackend(device=dev, **N62), seed=0,
                     provide_hint=True, device=dev)
    p0, p1, p_reset, p_steps = env_run(plain)
    if os.path.exists(log):
        os.remove(log)
    renv = CalibEnv(M=10, backend=RadioBackend(device=dev, **N62), seed=0,
                    provide_hint=True, device=dev)
    (r0, r1, r_reset, r_steps), launches, routes = routed(
        SHARD_FP, lambda: env_run(renv))
    check_outputs((r0, r1), r_steps, N62["npix"], renv.M)
    want = [("solve", "sharded", SHARD_FP),
            ("influence", "freq_sharded", SHARD_FP)]
    print(f"routed N=62 CalibEnv ({SHARD_FP} positions): reset {r_reset:.3f} "
          f"s, step {r_steps[0]['seconds']:.3f} s (unsharded {p_reset:.3f} / "
          f"{p_steps[0]['seconds']:.3f} s); reward {r_steps[0]['reward']:.6f} "
          f"(unsharded {p_steps[0]['reward']:.6f}); spans {routes}; "
          f"launches {launches}", flush=True)
    if not all(w in routes for w in want):
        raise AssertionError(f"routed N=62 spans {routes}, expected {want}")
    report["n62_env"] = {"positions": SHARD_FP, "reset_s": r_reset,
                         "step_s": r_steps[0]["seconds"],
                         "plain_reset_s": p_reset,
                         "plain_step_s": p_steps[0]["seconds"],
                         "reward": r_steps[0]["reward"],
                         "plain_reward": p_steps[0]["reward"],
                         "routes": routes, "launches": launches}
    env = plain
    mask = np.zeros(env.M, np.float32)
    mask[:env.K] = 1.0
    rho = np.ones(env.M, np.float32)
    rho[:env.K] = env.rho_spectral[:env.K]
    alpha = np.zeros(env.M, np.float32)
    alpha[:env.K] = env.rho_spatial[:env.K]
    res, res_s = timed_s(lambda: env.backend.calibrate(env.ep, rho,
                                                      mask=mask))
    report["n62"] = sharded_n62_checks(dev, env.ep, env.backend, res, res_s,
                                       rho, mask, alpha)
    del plain, renv, env, res

    def batched_run(env):
        t0 = time.perf_counter()
        env.reset()
        t_reset = time.perf_counter() - t0
        t0 = time.perf_counter()
        obs1, rew, _, _, info = env.step(env.hint)
        sec = time.perf_counter() - t0
        check_batched(obs1, rew, info, SHARD_LANES, N62["npix"], BATCH_M)
        return t_reset, sec, rew

    b_reset, b_step, b_rew = batched_run(BatchedCalibEnv(
        M=BATCH_M, n_envs=SHARD_LANES, backend=RadioBackend(device=dev, **N62),
        seed=0, provide_hint=True, device=dev))
    os.remove(log)
    (s_reset, s_step, s_rew), launches, routes = routed(
        SHARD_LANES, lambda: batched_run(BatchedCalibEnv(
            M=BATCH_M, n_envs=SHARD_LANES,
            backend=RadioBackend(device=dev, **N62), seed=0,
            provide_hint=True, device=dev)))
    print(f"lane-sharded BatchedCalibEnv (E={SHARD_LANES}, {SHARD_LANES} "
          f"positions): reset {s_reset:.3f} s, step {s_step:.3f} s "
          f"(unsharded {b_reset:.3f} / {b_step:.3f} s); rewards "
          f"{np.round(s_rew, 6).tolist()} (unsharded "
          f"{np.round(b_rew, 6).tolist()}); spans {routes}", flush=True)
    if ("solve", "batched_sharded", SHARD_LANES) not in routes:
        raise AssertionError(f"lane-sharded spans {routes}")
    report["batched"] = {"E": SHARD_LANES, "reset_s": s_reset,
                         "step_s": s_step, "plain_reset_s": b_reset,
                         "plain_step_s": b_step, "rewards": s_rew.tolist(),
                         "plain_rewards": b_rew.tolist(), "routes": routes,
                         "launches": launches}

    # the composed lane x baseline route at the SKA tier, E=2
    sb = RadioBackend(device=dev, **SKA)
    M, Kc = 10, 5
    eps, rhos, alphas = [], [], []
    t0 = time.perf_counter()
    for i in range(2):
        ep, mdl = sb.new_calib_episode(prng.PRNGKey(40 + i), Kc, M)
        eps.append(ep)
        r = np.ones(M, np.float32)
        r[:Kc] = mdl.rho
        a = np.zeros(M, np.float32)
        a[:Kc] = mdl.rho_spatial
        rhos.append(r)
        alphas.append(a)
    bep = sb.stack_episodes(eps)
    rho, alpha = np.stack(rhos), np.stack(alphas)
    mask = np.zeros((2, M), np.float32)
    mask[:, :Kc] = 1.0
    t_eps = time.perf_counter() - t0
    res, t_solve = timed_s(lambda: sb.calibrate_batched(bep, rho, mask=mask))
    ref, t_ref = timed_s(lambda: sb.influence_images_batched(
        bep, res, rho, alpha, compose=(0, 0)))
    with positions(dev, SHARD_COMPOSE[0] * SHARD_COMPOSE[1]):
        zero_counts()
        img, t_img = timed_s(lambda: sb.influence_images_batched(
            bep, res, rho, alpha, compose=SHARD_COMPOSE))
        c_launches = read_counts()
    ratio = tol_ratio(img.cpu(), ref.cpu(), SHARD_COMPOSE_TOL[0],
                      SHARD_COMPOSE_TOL[1] * float(ref.abs().max()))
    e_img = rel_norm(img, ref)
    # a position holds E / n_lane lanes: per lane and band one kernel-2
    # image of its baselines and one kernel-3 launch per interval
    per_pos = SHARD_COMPOSE[1] * len(eps) * sb.n_freqs
    want = {"hessian_blocks": per_pos * sb.n_chunks,
            "factored_imager": per_pos}
    print(f"composed lane x baseline influence (N=256, E=2, {SHARD_COMPOSE}"
          f"): {t_img:.3f} s against the vmap route's {t_ref:.3f} s; "
          f"{ratio:.3f} of the tolerance {SHARD_COMPOSE_TOL} (atol x "
          f"max|ref|), image rel {e_img:.3e}; launches "
          f"{c_launches} (want {want}); two episodes built in {t_eps:.1f} s, "
          f"solved (vmap) in {t_solve:.1f} s", flush=True)
    if ratio > 1 or any(c_launches[k] != v for k, v in want.items()):
        raise AssertionError("the composed route disagrees with the vmap "
                             "route or launched the wrong kernels")
    shallow = {"admm_iters": SHARD_SHALLOW_ADMM}
    v_res, t_v = timed_s(lambda: sb.calibrate_batched(
        bep, rho, mask=mask, compose=(0, 0), **shallow))
    with positions(dev, SHARD_COMPOSE[0] * SHARD_COMPOSE[1]):
        c_res, t_c = timed_s(lambda: sb.calibrate_batched(
            bep, rho, mask=mask, compose=SHARD_COMPOSE, **shallow))
    ok = (solver.result_finite(c_res)
          and bool((c_res.sigma_res < c_res.sigma_data).all()))
    j_gap = tol_ratio(c_res.J.cpu(), v_res.J.cpu(), *SHARD_SOLVE_TOL["J"])
    print(f"composed solve (N=256, E=2, admm_iters {SHARD_SHALLOW_ADMM}): "
          f"{t_c:.3f} s against the vmap route's {t_v:.3f} s; finite with "
          f"sigma_res < sigma_data: {ok}; J {j_gap:.3f} of the tolerance",
          flush=True)
    if not ok:
        raise AssertionError("the composed solve is not finite or did not "
                             "reduce the residual")
    report["composed"] = {
        "shape": SHARD_COMPOSE, "seconds": t_img, "vmap_seconds": t_ref,
        "tol_ratio": ratio, "image_rel": e_img, "launches": c_launches,
        "solve_seconds": t_c, "solve_vmap_seconds": t_v, "solve_J": j_gap,
        "episodes_s": t_eps, "full_solve_s": t_solve}
    ep0 = eps[0]
    res0 = solver.SolveResult(*(x[0] for x in res))
    report["ska"] = sharded_ska_checks(dev, sb, ep0, res0, rho[0], alpha[0],
                                       zero_counts, read_counts, n_sm,
                                       ref=ref[0])
    return report


# -- the multi-process slice (multiprocess_phase, --multiprocess) -------------
MP_RANKS = 2                   # ranks of the default phase, on the one card
MP_ENVS, MP_STEPS = 4, 2       # make_parallel_sac lanes (dp = 2) and steps:
#                                the second step's learn is the first
MP_ENET_AGENT = {"batch_size": 8, "mem_size": 256}
MP_DEMIX_AGENT = {"batch_size": 2, "mem_size": 16}
MP_DEMIX_OBS = 2               # an actor's observations: r0's and 1 step's
MP_JOIN_S = 600.0              # a job's whole run, the build excluded
MP_FP, MP_BP = 3, 2            # --multiprocess: N=62 fp ranks, SKA bp ranks
MP_LEARNER = ["--episodes", "1", "--n-actors", "2", "--replay-shards", "2",
              "--seed", "0", "--quiet"]


class PsumTimer:
    """Stands in for ``collectives.psum`` and keeps, per call, the operand's
    bytes (0 for a Python number) and the call's host seconds with the
    device synchronised before and after (the wait for the other ranks
    included)."""

    def __init__(self):
        from smartcal_tpu_torch.ops import collectives
        self.module, self.fn = collectives, collectives.psum
        self.calls = []
        collectives.psum = self

    def __call__(self, x, axis_name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.fn(x, axis_name)
        torch.cuda.synchronize()
        nbytes = (x.numel() * x.element_size()
                  if isinstance(x, torch.Tensor) else 0)
        self.calls.append((nbytes, time.perf_counter() - t0))
        return out

    def restore(self):
        self.module.psum = self.fn

    def summary(self):
        return {"calls": len(self.calls),
                "bytes": int(sum(b for b, _ in self.calls)),
                "largest_bytes": int(max((b for b, _ in self.calls),
                                         default=0)),
                "seconds": float(sum(t for _, t in self.calls))}


def mp_operand(rank):
    """Rank ``rank``'s psum operand (host, seeded)."""
    return torch.from_numpy(np.random.default_rng(rank).standard_normal(
        1 << 16).astype(np.float32) * np.float32(10.0) ** rank)


def mp_counters():
    """(zero_counts, read_counts) of this process's kernel counts."""
    from smartcal_tpu_torch.ops import (dft_imager, enet_lbfgs,
                                        factored_imager, hessian_blocks,
                                        sym_eigvals)
    return launch_counters(
        {"dft_imager": dft_imager, "hessian_blocks": hessian_blocks,
         "factored_imager": factored_imager, "enet_lbfgs": enet_lbfgs,
         "sym_eigvals": sym_eigvals}, factored_imager)


def mp_save(out_dir, name, obj):
    torch.save(obj, os.path.join(out_dir, name))


def mp_load(out_dir, name):
    return torch.load(os.path.join(out_dir, name), weights_only=False,
                      map_location="cpu")


def mp_rank(rank, out_dir):
    """One rank of the default multi-process phase (the job's device is
    this rank's share of the card, over gloo): a ``process_allgather`` of
    the rank ids and a psum over an ``fp`` axis of the ranks;
    ``make_parallel_sac`` with ``MP_ENVS`` lanes over ``dp`` = 2 (this
    rank's lanes: kernels 4 and 5) for ``MP_STEPS`` train steps; one
    ``train_distributed_demix`` episode with one actor per rank, one epoch
    of one step, influence maps (kernel 1, Nf launches per observation);
    the counts zeroed just before and read just after each path, then
    summed over the ranks; then each kernel held in the rank against its
    plain version at the path's first operands (launches not counted)."""
    from smartcal_tpu_torch.envs import enet, radio
    from smartcal_tpu_torch.ops import (build, collectives, dft_imager,
                                        enet_lbfgs, sym_eigvals)
    from smartcal_tpu_torch.parallel import (demix_learner, make_parallel_sac,
                                             multihost)
    from smartcal_tpu_torch.parallel import mesh as pm
    from smartcal_tpu_torch.parallel.trainer import agent_digest
    from smartcal_tpu_torch.rl import sac
    t_rank = time.perf_counter()
    dev = multihost.local_device()
    zero_counts, read_counts = mp_counters()
    res = {"summary": multihost.runtime_summary(),
           "ids": collectives.process_allgather(
               np.asarray([rank])).reshape(-1).tolist()}
    with collectives.on_mesh(pm.make_mesh((MP_RANKS,), (pm.AXIS_FREQ,))):
        res["psum"] = collectives.psum(mp_operand(rank).to(dev),
                                       pm.AXIS_FREQ).cpu()

    cfg = enet.EnetConfig(**FLEET_ENET, lbfgs_iters=FLEET_LBFGS)
    acfg = sac.SACConfig(obs_dim=cfg.obs_dim, n_actions=2, prioritized=True,
                         **MP_ENET_AGENT)
    k4 = FirstCall(enet_lbfgs, "solve_cuda")
    k5 = FirstCall(enet, "sym_eigvals")
    zero_counts()
    t0 = time.perf_counter()
    try:
        init, step, _ = make_parallel_sac(cfg, acfg, pm.make_mesh(), MP_ENVS)
        gen = torch.Generator(device=dev).manual_seed(0)
        st = init(gen)
        rewards = []
        for _ in range(MP_STEPS):
            st, m = step(st, gen)
            rewards.append(float(m["mean_reward"]))
        torch.cuda.synchronize(dev)
    finally:
        k4.restore()
        k5.restore()
    res["trainer"] = {"seconds": time.perf_counter() - t0,
                      "launches": read_counts(), "rewards": rewards,
                      "digest": agent_digest(st.agent),
                      "learns": st.agent.learn_counter,
                      "stored": st.buf.cntr}
    del st

    backend = radio.RadioBackend(device=dev, **FLEET_DEMIX)
    k1 = FirstCall(dft_imager, "dirty_image_cuda")
    zero_counts()
    t0 = time.perf_counter()
    try:
        dst, dscores = demix_learner.train_distributed_demix(
            seed=0, episodes=1, n_actors=MP_RANKS, K=FLEET_K,
            backend=backend, provide_influence=True, rollout_epochs=1,
            rollout_steps=1, quiet=True, device=dev,
            agent_kwargs=MP_DEMIX_AGENT)
        torch.cuda.synchronize(dev)
    finally:
        k1.restore()
    res["demix"] = {"seconds": time.perf_counter() - t0,
                    "launches": read_counts(), "scores": dscores,
                    "digest": agent_digest(dst.agent),
                    "learns": dst.agent.learn_counter,
                    "stored": dst.buf.cntr, "n_freqs": backend.n_freqs}
    del dst
    for path in ("trainer", "demix"):
        res[path]["launches_all_ranks"] = build.summed_over_ranks(
            res[path]["launches"])

    a4, _ = k4.args
    holds = {"enet_lbfgs": kernel4_iterations(
        enet_lbfgs, tuple(None if x is None else x.cpu() for x in a4), a4,
        f"rank {rank} trainer path")}
    (B,), _ = k5.args
    want = sym_eigvals.sym_eigvals_plain(B)
    holds["sym_eigvals"] = check_close(
        "sym_eigvals", f"rank {rank} trainer path ({B.shape[0]} x "
        f"{B.shape[1]} x {B.shape[2]})", sym_eigvals.sym_eigvals_cuda(B),
        want, EIG_RTOL, EIG_ATOL_REL, float(want.abs().max()))
    (uv, vis, npix, cell), _ = k1.args
    holds["dft_imager"] = check_imager(dft_imager, uv, vis, npix, cell,
                                       f"rank {rank} demix path")
    res["holds"] = holds
    res["kernel1_shapes"] = {"P": npix * npix, "R": int(uv.shape[0])}
    res["seconds"] = time.perf_counter() - t_rank
    mp_save(out_dir, f"rank{rank}.pt", res)


def thread_psum_on(dev, xs):
    """The thread form's psum of ``xs`` over ``len(xs)`` positions on
    ``dev``."""
    from smartcal_tpu_torch.ops import collectives
    from smartcal_tpu_torch.parallel import mesh as pm
    from smartcal_tpu_torch.parallel import sharded_cal
    mesh = pm.make_mesh((len(xs),), (pm.AXIS_FREQ,), devices=[dev] * len(xs))
    f = sharded_cal.shard_map(lambda x: collectives.psum(x[0], pm.AXIS_FREQ),
                              mesh, (pm.P(pm.AXIS_FREQ),), pm.P())
    return f(torch.stack(xs).to(dev)).cpu()


def multiprocess_phase(dev):
    """The default run's multi-process phase: ``MP_RANKS`` spawned ranks on
    the card over gloo (``mp_rank``), the kernels built beforehand in this
    process.  Holds every rank's ``runtime_summary`` and rank ids, its
    psum against the thread form's on the card (the same bits), the
    replicas' digests (trainer and demix agents) and rewards equal, kernels
    4 and 5 launched in each rank's trainer path and kernel 1 Nf times per
    observation in each rank's demix path (counts summed over the ranks
    beside each rank's), and each kernel's hold in its rank.  A rank that
    fails fails the phase."""
    import shutil
    import tempfile

    from smartcal_tpu_torch.parallel import multihost
    d = tempfile.mkdtemp(prefix="mp_phase_")
    try:
        t0 = time.perf_counter()
        multihost.launch(mp_rank, MP_RANKS, args=(d,),
                         join_timeout=MP_JOIN_S)
        wall = time.perf_counter() - t0
        ranks = [mp_load(d, f"rank{r}.pt") for r in range(MP_RANKS)]
    finally:
        shutil.rmtree(d, ignore_errors=True)
    want = thread_psum_on(dev, [mp_operand(r) for r in range(MP_RANKS)])
    for r, res in enumerate(ranks):
        s = res["summary"]
        if (s["process_index"], s["process_count"], s["backend"]) != \
                (r, MP_RANKS, "gloo") or res["ids"] != list(range(MP_RANKS)):
            raise AssertionError(f"rank {r}: summary {s}, ids {res['ids']}")
        if not torch.equal(res["psum"], want):
            raise AssertionError(f"rank {r}: the process psum differs from "
                                 "the thread form's")
        tl, dl = res["trainer"]["launches"], res["demix"]["launches"]
        if tl["enet_lbfgs"] < 1 or tl["sym_eigvals"] < 1:
            raise AssertionError(f"rank {r}: trainer path launches {tl}")
        if dl["dft_imager"] != res["demix"]["n_freqs"] * MP_DEMIX_OBS:
            raise AssertionError(f"rank {r}: demix path launches {dl}, "
                                 f"expected Nf x {MP_DEMIX_OBS}")
    for path in ("trainer", "demix"):
        digests = {res[path]["digest"] for res in ranks}
        if len(digests) != 1:
            raise AssertionError(f"the replicas' {path} agents differ")
        if ranks[0][path]["learns"] < 1:
            raise AssertionError(f"{path}: no learn step ran")
    if ranks[0]["trainer"]["rewards"] != ranks[1]["trainer"]["rewards"]:
        raise AssertionError("the ranks' trainer rewards differ")
    summed = {k: ranks[0]["trainer"]["launches_all_ranks"][k]
              + ranks[0]["demix"]["launches_all_ranks"][k]
              for k in ranks[0]["trainer"]["launches_all_ranks"]}
    out = {"ranks": MP_RANKS, "backend": "gloo", "seconds": wall,
           "launches": summed,
           "per_rank": [{"trainer_launches": res["trainer"]["launches"],
                         "demix_launches": res["demix"]["launches"],
                         "trainer_s": res["trainer"]["seconds"],
                         "demix_s": res["demix"]["seconds"],
                         "rank_s": res["seconds"], "holds": res["holds"]}
                        for res in ranks],
           "kernel1_shapes": ranks[0]["kernel1_shapes"],
           "max_abs_err": {k: max(res["holds"][k] for res in ranks)
                           for k in ranks[0]["holds"]},
           "digest_trainer": ranks[0]["trainer"]["digest"],
           "digest_demix": ranks[0]["demix"]["digest"],
           "rewards": ranks[0]["trainer"]["rewards"],
           "demix_scores": ranks[0]["demix"]["scores"]}
    print(f"multiprocess phase: {MP_RANKS} ranks on {dev} over gloo, "
          f"{wall:.1f} s (ranks {[round(r['seconds'], 1) for r in ranks]} s "
          f"after start-up; make_parallel_sac {MP_ENVS} lanes x {MP_STEPS} "
          f"steps {[round(r['trainer']['seconds'], 2) for r in ranks]} s, "
          f"demix episode {[round(r['demix']['seconds'], 2) for r in ranks]}"
          f" s); psum = the thread form's bits; the replicas' digests "
          f"equal; launches per rank "
          f"{[dict(r['trainer']['launches'], **{'dft_imager': r['demix']['launches']['dft_imager']}) for r in ranks]}"
          f", summed {summed}; holds {out['max_abs_err']} -> ok",
          flush=True)
    return out


def mp_nccl_rank(rank, port, out_dir):
    """Ask NCCL for two ranks on one GPU and keep its answer."""
    import datetime

    import torch.distributed as dist
    try:
        torch.cuda.set_device(0)
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                                rank=rank, world_size=2,
                                timeout=datetime.timedelta(seconds=60))
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        answer = f"no error: all_reduce gave {float(x)}"
    except Exception as e:                  # noqa: BLE001 — kept
        answer = f"{type(e).__name__}: {e}"
    with open(os.path.join(out_dir, f"nccl{rank}.txt"), "w") as fh:
        fh.write(answer)


def nccl_one_gpu(out_dir):
    """NCCL's answer to two ranks on one GPU (each rank's, verbatim)."""
    import torch.multiprocessing as mp
    from smartcal_tpu_torch.parallel import multihost
    ctx = mp.start_processes(mp_nccl_rank, args=(multihost.free_port(),
                                                 out_dir),
                             nprocs=2, join=False, start_method="spawn")
    t0 = time.monotonic()
    while not ctx.join(timeout=1.0):
        if time.monotonic() - t0 > 180:
            for p in ctx.processes:
                p.kill()
            break
    answers = []
    for r in range(2):
        path = os.path.join(out_dir, f"nccl{r}.txt")
        answers.append(open(path).read() if os.path.exists(path)
                       else "no answer within 180 s (killed)")
    print(f"NCCL, two ranks on one GPU: {answers}", flush=True)
    return answers


def mp_n62_rank(rank, out_dir):
    """``--multiprocess``, N=62 over ``MP_FP`` fp ranks: the full-depth
    ``solve_admm_sharded`` on the parent's operands, twice; then a routed
    CalibEnv(M=10) reset and step (the backend's mesh over the ranks, the
    routes read from this rank's run log)."""
    from smartcal_tpu_torch import obs
    from smartcal_tpu_torch.cal import solver
    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.parallel import multihost
    from smartcal_tpu_torch.parallel import mesh as pm
    from smartcal_tpu_torch.parallel import sharded_cal as sc
    dev = multihost.local_device()
    ops = torch.load(os.path.join(out_dir, "n62_ops.pt"), map_location=dev,
                     weights_only=False)
    fp = pm.make_mesh((MP_FP,), (pm.AXIS_FREQ,))
    cfg = solver.SolverConfig(*ops["cfg"])

    def solve():
        return sc.solve_admm_sharded(fp, ops["V"], ops["C"], ops["freqs"],
                                     ops["f0"], ops["rho"], cfg,
                                     n_chunks=ops["n_chunks"])

    first, t_first = timed_s(solve)
    psums = PsumTimer()
    try:
        again, t_again = timed_s(solve)
    finally:
        psums.restore()
    res = {"solve_s": [t_first, t_again], "psums": psums.summary(),
           "solve": solver.SolveResult(*(x.cpu() for x in again)),
           "same_bits_twice": all(torch.equal(a, b)
                                  for a, b in zip(first, again))}
    del first, again, ops
    log = os.path.join(out_dir, "n62_env.jsonl")
    env = CalibEnv(M=10, backend=RadioBackend(device=dev, **N62), seed=0,
                   provide_hint=True, device=dev)
    rl = obs.activate(obs.RunLog(log, flush_lines=1))
    try:
        t0 = time.perf_counter()
        o0 = env.reset()
        t_reset = time.perf_counter() - t0
        o1, steps = run_steps(env, 1)
    finally:
        obs.deactivate(rl)
        rl.close()
    check_outputs((o0, o1), steps, N62["npix"], env.M)
    res.update(reset_s=t_reset, step_s=steps[0]["seconds"],
               reward=steps[0]["reward"],
               routes=span_routes(multihost.rank_path(log)),
               stage_seconds=dict(env.backend.stage_seconds))
    mp_save(out_dir, f"n62_rank{rank}.pt", res)


def mp_ska_rank(rank, out_dir):
    """``--multiprocess``, SKA over ``MP_BP`` bp ranks: the parent's step
    operands through ``influence_image`` routed ``baseline_sharded`` (the
    backend's mesh over the ranks), twice, counts zeroed just before and
    read just after the first; this rank's first kernel-3 launch (its
    baselines, the subset layout) and first kernel-2 launch held against
    their plain versions (launches not counted)."""
    from smartcal_tpu_torch.cal import imager, kernels
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.ops import build, factored_imager, hessian_blocks
    from smartcal_tpu_torch.parallel import multihost
    dev = multihost.local_device()
    zero_counts, read_counts = mp_counters()
    ops = torch.load(os.path.join(out_dir, "ska_ops.pt"), map_location=dev,
                     weights_only=False)
    backend = RadioBackend(device=dev, **SKA)
    k3 = FirstCall(hessian_blocks, "hessian_block_sums_cuda")
    k2 = FirstCall(factored_imager, "dirty_image_factored_cuda")
    zero_counts()
    try:
        img, t_img = timed_s(lambda: backend.influence_image(
            ops["ep"], ops["res"], ops["rho"], ops["alpha"]))
        launches = read_counts()
    finally:
        k3.restore()
        k2.restore()
    psums = PsumTimer()
    try:
        again, t_again = timed_s(lambda: backend.influence_image(
            ops["ep"], ops["res"], ops["rho"], ops["alpha"]))
    finally:
        psums.restore()
    a3, kw3 = k3.args
    err3 = check_hessian(hessian_blocks, kernels, a3, kw3,
                         f"rank {rank} SKA B={a3[1].shape[2]}")
    (u, v, f, c), kw2 = k2.args
    want = imager.dirty_image_factored_blocked_sr(
        u, v, f, c, npix=kw2["npix"], block_r=SKA_STATICS["imager_block_r"])
    err2 = check_close("factored_imager", f"rank {rank} SKA npix="
                       f"{kw2['npix']} R={u.shape[0]}",
                       factored_imager.dirty_image_factored_cuda(
                           u, v, f, c, npix=kw2["npix"]),
                       want, FACTORED_RTOL, FACTORED_ATOL,
                       float(want.abs().max()))
    mp_save(out_dir, f"ska_rank{rank}.pt", {
        "image": img.cpu(), "seconds": [t_img, t_again],
        "same_bits_twice": torch.equal(img, again), "launches": launches,
        "psums": psums.summary(),
        "launches_all_ranks": build.summed_over_ranks(launches),
        "kernel3_B": int(a3[1].shape[2]), "max_abs_err": {
            "hessian_blocks": max(err3), "factored_imager": err2}})


def mp_learner_rank(rank, out_dir):
    """``--multiprocess``: the learner's CLI with ``MP_LEARNER`` (the ring
    sharded over an ``rp`` axis of the ranks), timed."""
    from smartcal_tpu_torch.parallel import learner
    t0 = time.perf_counter()
    scores = learner.main(MP_LEARNER)
    torch.cuda.synchronize()
    mp_save(out_dir, f"learner_rank{rank}.pt",
            {"seconds": time.perf_counter() - t0, "scores": scores})


def mp_deep_phase(dev):
    """``--multiprocess``: NCCL's answer to two ranks on one GPU; at N=62
    the full-depth ``solve_admm_sharded`` over ``MP_FP`` fp ranks beside
    the fused solve and the thread route (``MP_FP`` positions) on the same
    operands, and a routed CalibEnv reset and step over the ranks beside
    the unsharded one; at the SKA tier ``influence_image`` over ``MP_BP``
    bp ranks (kernels 3 and 2 in each rank) held within 1e-4 of the
    single-device route, beside it and the thread route (``MP_BP``
    positions); the learner's CLI over 2 ranks with the ring sharded over
    them.  Seconds for each; a failed rank fails the phase.  The ranks'
    operands and results go through a temporary directory."""
    import shutil
    import tempfile
    d = tempfile.mkdtemp(prefix="mp_deep_")
    try:
        return _mp_deep(dev, d)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _mp_deep(dev, d):
    """:func:`mp_deep_phase` with the ranks' files in ``d``."""
    from smartcal_tpu_torch.cal import solver
    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.parallel import mesh as pm
    from smartcal_tpu_torch.parallel import multihost
    from smartcal_tpu_torch.parallel import sharded_cal as sc
    report = {"nccl_one_gpu": nccl_one_gpu(d)}

    # N=62: the fused solve, the thread route, then the ranks (the
    # single-device references shard over no card the machine has)
    env = CalibEnv(M=10, backend=RadioBackend(device=dev, shard=False,
                                              **N62),
                   seed=0, provide_hint=True, device=dev)
    t0 = time.perf_counter()
    env.reset()
    p_reset = time.perf_counter() - t0
    _, p_steps = run_steps(env, 1)
    backend, ep = env.backend, env.ep
    mask = np.zeros(env.M, np.float32)
    mask[:env.K] = 1.0
    rho = np.ones(env.M, np.float32)
    rho[:env.K] = env.rho_spectral[:env.K]
    cfg = backend._solver_cfg(ep.n_dirs)
    C = ep.Ccal * torch.as_tensor(mask, device=dev)[None, :, None, None,
                                                    None]
    r = torch.as_tensor(rho, device=dev)
    n_ch = backend.n_chunks
    fused, t_fused = timed_s(lambda: solver.solve_admm(
        ep.V, C, ep.obs.freqs, ep.f0, r, cfg, n_chunks=n_ch))
    threads = pm.make_mesh((MP_FP,), (pm.AXIS_FREQ,), devices=[dev] * MP_FP)
    thr, t_thr = timed_s(lambda: sc.solve_admm_sharded(
        threads, ep.V, C, ep.obs.freqs, ep.f0, r, cfg, n_chunks=n_ch))
    thr2, t_thr2 = timed_s(lambda: sc.solve_admm_sharded(
        threads, ep.V, C, ep.obs.freqs, ep.f0, r, cfg, n_chunks=n_ch))
    cards = None
    if torch.cuda.device_count() >= MP_FP:
        # on a machine with a card per position, the thread route over them
        over = pm.make_mesh((MP_FP,), (pm.AXIS_FREQ,), devices=[
            torch.device("cuda", i) for i in range(MP_FP)])
        for _ in range(2):
            thr_c, t_c = timed_s(lambda: sc.solve_admm_sharded(
                over, ep.V, C, ep.obs.freqs, ep.f0, r, cfg, n_chunks=n_ch))
            cards = [t_c] if cards is None else cards + [t_c]
        cards_bits = all(torch.equal(a, b) for a, b in zip(thr_c, thr))
        del thr_c
    torch.save({"V": ep.V, "C": C, "freqs": ep.obs.freqs, "f0": ep.f0,
                "rho": r, "cfg": tuple(cfg), "n_chunks": n_ch},
               os.path.join(d, "n62_ops.pt"))
    del env, backend, ep, C, r, thr2
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    multihost.launch(mp_n62_rank, MP_FP, args=(d,), join_timeout=MP_JOIN_S)
    job_s = time.perf_counter() - t0
    n62 = [mp_load(d, f"n62_rank{r}.pt") for r in range(MP_FP)]
    got = n62[0]["solve"]
    gap = solve_gap(got, solver.SolveResult(*(x.cpu() for x in fused)))
    same_threads = all(torch.equal(a, b.cpu()) for a, b in zip(got, thr))
    ok = (solver.result_finite(got)
          and float(got.sigma_res) < float(got.sigma_data)
          and all(all(torch.equal(a, b) for a, b in zip(x["solve"], got))
                  for x in n62))
    want = [("solve", "sharded", MP_FP), ("influence", "freq_sharded",
                                         MP_FP)]
    routed = all(all(w in x["routes"] for w in want) for x in n62)
    print(f"N=62 full-depth solve_admm_sharded over {MP_FP} fp ranks: "
          f"{[round(x, 3) for x in n62[0]['solve_s']]} s (first, second) "
          f"against the fused solve's {t_fused:.3f} s and the thread route's "
          f"{t_thr:.3f} / {t_thr2:.3f} s ({MP_FP} positions), the same run; "
          f"finite, sigma_res < sigma_data, the same on every rank: {ok}; "
          f"the thread route's bits: {same_threads}; gap to the fused "
          f"solve J {gap['J']:.3f} Z {gap['Z']:.3f} of the tolerance; "
          f"routed CalibEnv over the ranks reset {n62[0]['reset_s']:.3f} s, "
          f"step {n62[0]['step_s']:.3f} s (unsharded {p_reset:.3f} / "
          f"{p_steps[0]['seconds']:.3f} s), spans {n62[0]['routes']}; "
          f"psums of the second solve {[x['psums'] for x in n62]}; "
          f"job {job_s:.1f} s"
          + (f"; the thread route over {MP_FP} cards {cards} s, the "
             f"one-card thread route's bits: {cards_bits}" if cards else ""),
          flush=True)
    if not (ok and routed):
        raise AssertionError("the N=62 process routes failed their checks")
    report["n62"] = {
        "ranks": MP_FP, "process_solve_s": n62[0]["solve_s"],
        "process_solve_s_by_rank": [x["solve_s"] for x in n62],
        "fused_solve_s": t_fused, "thread_solve_s": [t_thr, t_thr2],
        "same_bits_as_threads": same_threads, "gap_to_fused": gap,
        "process_same_bits_twice": n62[0]["same_bits_twice"],
        "env_reset_s": [x["reset_s"] for x in n62],
        "env_step_s": [x["step_s"] for x in n62],
        "plain_env_reset_s": p_reset,
        "plain_env_step_s": p_steps[0]["seconds"],
        "routes": n62[0]["routes"], "job_s": job_s,
        "thread_cards_solve_s": cards,
        "thread_cards_same_bits": cards_bits if cards else None,
        "psums_second_solve": [x["psums"] for x in n62]}
    del fused, thr
    torch.cuda.empty_cache()

    # SKA: the single device, the thread route, then the ranks
    ska = CalibEnv(M=10, backend=RadioBackend(device=dev, shard=False,
                                              **SKA),
                   seed=0, provide_hint=True, device=dev)
    spy = FirstCall(ska.backend, "influence_image")
    try:
        ska.reset()
    finally:
        spy.restore()
    (s_ep, s_res, s_rho, s_alpha), _ = spy.args
    single, t_single = timed_s(lambda: ska.backend.influence_image(
        s_ep, s_res, s_rho, s_alpha))
    routed = RadioBackend(device=dev, **SKA)
    with positions(dev, MP_BP):
        thr_img, t_thr_img = timed_s(lambda: routed.influence_image(
            s_ep, s_res, s_rho, s_alpha))
    torch.save({"ep": s_ep, "res": s_res, "rho": s_rho, "alpha": s_alpha},
               os.path.join(d, "ska_ops.pt"))
    single, e_thr = single.cpu(), rel_norm(thr_img, single)
    del ska, spy, s_ep, s_res, thr_img, routed
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    multihost.launch(mp_ska_rank, MP_BP, args=(d,), join_timeout=MP_JOIN_S)
    job_s = time.perf_counter() - t0
    sk = [mp_load(d, f"ska_rank{r}.pt") for r in range(MP_BP)]
    errs = [rel_norm(x["image"], single) for x in sk]
    n_freqs, n_chunks = SKA["n_freqs"], SKA["n_times"] // SKA["tdelta"]
    want = {"hessian_blocks": MP_BP * n_chunks * n_freqs,
            "factored_imager": MP_BP * n_freqs}
    summed = sk[0]["launches_all_ranks"]
    print(f"SKA influence_image over {MP_BP} bp ranks: "
          f"{[[round(t, 3) for t in x['seconds']] for x in sk]} s (first, "
          f"second, by rank) against the single-device route's "
          f"{t_single:.3f} s and the thread route's {t_thr_img:.3f} s "
          f"({MP_BP} positions, rel {e_thr:.3e}), the same run; image rel "
          f"{errs}; launches by rank {[x['launches'] for x in sk]}, summed "
          f"{summed} (want {want}); holds "
          f"{[x['max_abs_err'] for x in sk]}; psums of the second call "
          f"{[x['psums'] for x in sk]}; job {job_s:.1f} s", flush=True)
    if max(errs) > SHARD_INFL_REL or any(summed[k] != v
                                         for k, v in want.items()):
        raise AssertionError("the SKA process route disagrees with the "
                             "single-device route or launched "
                             f"{summed}, expected {want}")
    report["ska"] = {
        "ranks": MP_BP, "process_s": [x["seconds"] for x in sk],
        "single_s": t_single, "thread_s": t_thr_img,
        "thread_image_rel": e_thr, "image_rel": errs,
        "same_bits_twice": [x["same_bits_twice"] for x in sk],
        "launches": summed, "per_rank_launches": [x["launches"] for x in sk],
        "kernel3_B_per_rank": sk[0]["kernel3_B"],
        "max_abs_err": {k: max(x["max_abs_err"][k] for x in sk)
                        for k in sk[0]["max_abs_err"]}, "job_s": job_s,
        "psums_second_call": [x["psums"] for x in sk]}

    t0 = time.perf_counter()
    multihost.launch(mp_learner_rank, 2, args=(d,), join_timeout=MP_JOIN_S)
    job_s = time.perf_counter() - t0
    ln = [mp_load(d, f"learner_rank{r}.pt") for r in range(2)]
    if ln[0]["scores"] != ln[1]["scores"] or not np.all(
            np.isfinite(ln[0]["scores"])):
        raise AssertionError(f"learner scores {[x['scores'] for x in ln]}")
    print(f"learner {' '.join(MP_LEARNER)} over 2 ranks: "
          f"{[round(x['seconds'], 2) for x in ln]} s (by rank), scores "
          f"{ln[0]['scores']}; job {job_s:.1f} s", flush=True)
    report["learner"] = {"args": MP_LEARNER, "seconds": [x["seconds"]
                                                        for x in ln],
                         "scores": ln[0]["scores"], "job_s": job_s}
    return report


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="smoke_out",
                    help="directory for chip_smoke.json")
    ap.add_argument("--ablation", action="store_true",
                    help="time the imaging engine's design variants instead")
    ap.add_argument("--runtime", action="store_true",
                    help="build the kernels and run the runtime phase "
                         "alone (checkpoint/resume, rollback, run log, "
                         "diag, trace)")
    ap.add_argument("--runtime-rest", dest="runtime_rest",
                    action="store_true",
                    help="build the kernels and run the rest of the runtime "
                         "slice alone (host-segmented solve and ladder, "
                         "native replay, perf gate, --deterministic, stage "
                         "costs)")
    ap.add_argument("--deterministic-sweep", dest="deterministic_sweep",
                    action="store_true",
                    help="build the kernels and run every trainer once "
                         "under --deterministic at the tiny tier")
    ap.add_argument("--fleet", action="store_true",
                    help="build the kernels and run the distributed-training "
                         "phase alone, deeper (200 L-BFGS iterations, 8 "
                         "fleet rounds, the demixing fleet with 1 and 2 "
                         "actor threads)")
    ap.add_argument("--serve", action="store_true",
                    help="build the kernels and run the serving phase "
                         "alone, deeper (the load generator at two rates, "
                         "the replica fleet with a kill, the online "
                         "lifecycle)")
    ap.add_argument("--supervised", action="store_true",
                    help="build the kernels and run the supervised phase "
                         "alone (dataset, transformer, recommend, "
                         "regressors, model influence)")
    ap.add_argument("--bf16", action="store_true",
                    help="build the kernels and run one N=62 reset + step, "
                         "one SKA reset + step and the bf16 phase on them "
                         "alone")
    ap.add_argument("--oracle", action="store_true",
                    help="build the kernels and run CalibEnv(M=10) at N=62, "
                         "reset + 1 step, on the host-loop backend (the "
                         "oracle chain) beside the vectorized one")
    ap.add_argument("--enet-program", dest="enet_program",
                    action="store_true",
                    help="build the kernels and run the elastic-net "
                         "programs' phase alone, deeper (kernels 4 and 5, "
                         "the programs against their eager bodies, "
                         "enet_sac at --block 20 and 1 over twice the "
                         "episodes)")
    ap.add_argument("--sharded", action="store_true",
                    help="build the kernels and run the sharded routes' "
                         "phase alone (a routed N=62 CalibEnv, the "
                         "lane-sharded E=4 batched step, the composed lane x "
                         "baseline route at N=256 E=2)")
    ap.add_argument("--multiprocess", action="store_true",
                    help="build the kernels and run the deeper multi-process "
                         "phase alone (NCCL on one GPU, the N=62 sharded "
                         "solve and a routed CalibEnv over 3 fp ranks, the "
                         "SKA influence over 2 bp ranks, the learner over 2 "
                         "ranks with its ring sharded over them)")
    ap.add_argument("--diag-determinism", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("--hessian-split", metavar="PARENT_CU",
                    help="time the Hessian kernels' launches apart instead: "
                         "PARENT_CU is the two-pass hessian_blocks.cu of "
                         "commit dc0ef65")
    ap.add_argument("--enet-kernel-ablation", dest="enet_kernel_ablation",
                    metavar="PARENT_DIR",
                    help="time kernels 4 and 5 against a parent checkout's "
                         "and kernel 4's copies with one lever off "
                         "instead: PARENT_DIR holds the parent's "
                         "smartcal_tpu_torch/csrc/")
    ap.add_argument("--bf16-ablation", metavar="PARENT_CU",
                    help="time kernel 2's bf16 mode against its parent "
                         "and its ceilings instead: PARENT_CU is the "
                         "factored_imager.cu of commit 5dda491")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.diag_determinism:
        return diag_determinism_main()
    if (args.runtime or args.runtime_rest or args.supervised or args.bf16
            or args.deterministic_sweep or args.fleet or args.serve
            or args.oracle or args.enet_program or args.sharded
            or args.multiprocess):
        from smartcal_tpu_torch.ops import (build, dft_imager, enet_lbfgs,
                                            factored_imager, hessian_blocks,
                                            sym_eigvals)
        card = card_line()
        print(card, flush=True)
        BUILD_LOGS.update({n: log for n, (_, log) in build.build().items()})
        os.makedirs(args.out, exist_ok=True)
        zero, read = launch_counters(
            {"dft_imager": dft_imager, "hessian_blocks": hessian_blocks,
             "factored_imager": factored_imager, "enet_lbfgs": enet_lbfgs,
             "sym_eigvals": sym_eigvals}, factored_imager)
        dev = torch.device("cuda", 0)
        if args.enet_program:
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            name, out = "enet_program_phase", enet_program_phase(
                dev, args.out, zero, read, n_sm, deep=True)
        elif args.sharded:
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            name, out = "sharded_phase", sharded_phase(dev, args.out, zero,
                                                       read, n_sm)
        elif args.multiprocess:
            name, out = "multiprocess_deep", mp_deep_phase(dev)
        elif args.runtime:
            name, out = "runtime_phase", runtime_phase(dev, args.out, zero,
                                                       read)
        elif args.runtime_rest:
            name, out = "runtime_rest_phase", runtime_rest_phase(
                dev, args.out, zero, read)
        elif args.bf16:
            name, out = "bf16_phase", bf16_main(dev, args.out, zero, read)
        elif args.deterministic_sweep:
            name, out = "deterministic_sweep", deterministic_sweep(
                dev, args.out)
        elif args.oracle:
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            name, out = "oracle_phase", oracle_phase(dev, args.out, zero,
                                                     read, n_sm)
        elif args.fleet:
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            name, out = "fleet_phase", fleet_phase(dev, args.out, zero, read,
                                                   n_sm, deep=True)
        elif args.serve:
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            name, out = "serve_phase", serve_phase(dev, args.out, zero, read,
                                                   n_sm, deep=True)
        else:
            n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
            name, out = "supervised_phase", supervised_phase(
                dev, args.out, zero, read, n_sm)
        with open(os.path.join(args.out, f"{name}.json"), "w") as fh:
            json.dump(out, fh, indent=1, default=float)
        print(card)
        return 0
    if (args.ablation or args.hessian_split or args.bf16_ablation
            or args.enet_kernel_ablation):
        card = card_line()
        print(card, flush=True)
        os.makedirs(args.out, exist_ok=True)
        if args.ablation:
            ablation(args.out, card)
        elif args.enet_kernel_ablation:
            enet_kernel_ablation(args.out, card, args.enet_kernel_ablation)
        elif args.hessian_split:
            hessian_split(args.out, card, args.hessian_split)
        else:
            bf16_ablation(args.out, card, args.bf16_ablation)
        print(card)
        return 0
    from smartcal_tpu_torch.cal import imager, influence, kernels
    from smartcal_tpu_torch.envs.calib import CalibEnv
    from smartcal_tpu_torch.envs.radio import RadioBackend
    from smartcal_tpu_torch.ops import (build, dft_imager, enet_lbfgs,
                                        factored_imager, hessian_blocks,
                                        sym_eigvals)

    t_start = time.perf_counter()
    counters = {"dft_imager": dft_imager, "hessian_blocks": hessian_blocks,
                "factored_imager": factored_imager, "enet_lbfgs": enet_lbfgs,
                "sym_eigvals": sym_eigvals}
    zero_counts, read_counts = launch_counters(counters, factored_imager)

    report = {}
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    props = torch.cuda.get_device_properties(dev)
    n_sm = props.multi_processor_count
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} device {props.name} sms {n_sm}",
          flush=True)

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    built = build.build()
    BUILD_LOGS.update({n: log for n, (_, log) in built.items()})
    report["build_seconds"] = time.perf_counter() - t0
    for name, (sec, log) in built.items():
        print(f"built {name} in {sec:.2f} s\n{log.strip()}", flush=True)
    print(f"build total {report['build_seconds']:.2f} s", flush=True)
    missing = set(counters) - set(build.sources())
    if missing:
        raise AssertionError(f"no CUDA source for {sorted(missing)}")

    # -- the demixing slice, before the first profiler session --------------
    report["diffuse"] = diffuse_phase(dev, zero_counts, read_counts)
    report["demix_env"], demix_env = demix_env_phase(dev, zero_counts,
                                                     read_counts)
    report["demix_batched"] = demix_batched_phase(dev, zero_counts,
                                                  read_counts)
    report["demix_fuzzy"] = demix_fuzzy_phase(dev, zero_counts, read_counts)
    report["demix_drivers"] = demix_drivers_phase(dev, args.out, zero_counts,
                                                  read_counts)
    stamp(t_start)

    # -- the supervised slice, still before the first profiler session -----
    report["supervised"] = supervised_phase(dev, args.out, zero_counts,
                                            read_counts, n_sm)
    stamp(t_start)

    # -- reference-scale path: CalibEnv(M=10) at N=62, reset + 2 steps ------
    backend = RadioBackend(device=dev, **N62)
    env = CalibEnv(M=10, backend=backend, seed=0, provide_hint=True,
                   device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    obs0 = env.reset()
    t_reset = time.perf_counter() - t0
    obs, steps, n62_spies = spied_steps(env, backend, 2)
    n62_launches = read_counts()
    peak = torch.cuda.max_memory_allocated(dev)
    print_path("N=62 path", env, backend, t_reset, steps, peak, n62_launches)
    check_outputs((obs0, obs), steps, 128, env.M)
    if n62_launches["dft_imager"] < 9:
        raise AssertionError(f"dft_imager launched {n62_launches} times on "
                             "the N=62 path, expected >= 9")
    report["n62"] = dict(reset_seconds=t_reset, steps=steps, K=env.K,
                         stage_seconds=dict(backend.stage_seconds),
                         peak_mem_bytes=peak, launches=n62_launches,
                         sigma_data_img=env._sigma_data_img)

    # one more solve timed here, for the oracle and sharded checks; a third
    # step profiled at the end, its idle share taken against the unprofiled
    # seconds (the profiler slows the host)
    mask = np.zeros(env.M, np.float32)
    mask[:env.K] = 1.0
    rho = np.ones(env.M, np.float32)
    rho[:env.K] = env.rho_spectral[:env.K]
    t0 = time.perf_counter()
    n62_res = backend.calibrate(env.ep, rho, mask=mask)
    solve_wall = time.perf_counter() - t0
    report["n62"]["idle"] = {
        "step_wall_s": float(np.mean([s["seconds"] for s in steps])),
        "solve_wall_s": solve_wall}
    defer(n62_profiles, env, report["n62"]["idle"])

    # -- the oracle chain on this episode and solve (no new solve) ---------
    alpha = np.zeros(env.M, np.float32)
    alpha[:env.K] = env.rho_spatial[:env.K]
    report["n62"]["oracle"] = oracle_checks(
        dev, env, backend, n62_res, rho, alpha, zero_counts, read_counts,
        n_sm)

    # -- the frequency and chunk routes on this episode and solve, with
    # positions on the card --------------------------------------------------
    report["n62"]["sharded"] = sharded_n62_checks(
        dev, env.ep, backend, n62_res, solve_wall, rho, mask, alpha)
    del n62_res

    # -- imager kernel at the N=62 path's shapes, and ragged cases ---------
    ep = env.ep
    uvw = ep.obs.uvw.reshape(-1, 3)
    freq = float(ep.obs.freqs[0])
    cell = imager.default_cell(ep.obs.uvw, float(ep.obs.freqs[-1]))
    visc = imager.stokes_i_vis(ep.V[0]).contiguous()
    uv = scaled_uv(dft_imager, uvw, freq)
    g = torch.Generator(device="cpu").manual_seed(1)
    dft_err = [check_imager(dft_imager, uv, visc, 128, cell, "N=62 path")]
    for r_n, r_npix in RAGGED:
        ru, rv, rf = random_imager_case(r_n, r_n, dev)
        dft_err.append(check_imager(
            dft_imager, scaled_uv(dft_imager, ru, rf), rv, r_npix,
            imager.default_cell(ru, rf), "ragged",
            gen=g if r_npix * r_npix > 4 * 4096 else None))
    lm = dft_imager.pixel_grid(128, cell, dev)
    P, R = lm.shape[0], uv.shape[0]

    def dft_kernel():
        return dft_imager.dirty_image_cuda(uv, visc, 128, cell)

    dft_ms = cuda_ms(dft_kernel, 20)
    dft_plain_ms = cuda_ms(
        lambda: dft_imager.dirty_image_reference(uv, lm, visc), 5)
    factored_ms = cuda_ms(lambda: imager.dirty_image_factored_sr(
        uvw, visc, freq, cell, npix=128), 20)
    dft_ms2 = cuda_ms(dft_kernel, 20)
    dft_bounds = separable_bounds(128, R, n_sm)
    print(f"dft_imager at P={P} R={R}: kernel {dft_ms:.4f} / {dft_ms2:.4f} "
          f"ms (median, two runs), plain {dft_plain_ms:.4f} ms, "
          f"plain factored-imager yardstick {factored_ms:.4f} ms, bounds "
          + ", ".join(f"{k} {v}" for k, v in dft_bounds.items()), flush=True)
    del env, backend, ep, uvw, visc, uv, lm

    # -- train path: train/calib_sac.py on the N=62 backend, 2 episodes ----
    report["train"] = train_path(dev, args.out, zero_counts, read_counts)
    stamp(t_start)

    # -- the elastic-net slice: one step measured, then the trainers --------
    print(f"enet phases: step path reset + 3 steps + 1 hint; enet_sac "
          f"{ENET_SAC_EPISODES} episodes x {ENET_SAC_STEPS} steps with the "
          f"hint; enet_td3 / enet_ddpg {' '.join(ENET_SHORT)}; calib_td3 "
          f"{' '.join(CALIB_TD3_ARGS)}; calib_ddpg "
          f"{' '.join(CALIB_DDPG_ARGS)}", flush=True)
    zero_counts()
    report["enet_step"] = enet_step_phase(dev)
    report["enet_step"]["launches"] = read_counts()
    report["enet_sac"] = enet_sac_phase(dev, args.out, zero_counts,
                                        read_counts)
    report["enet_td3_ddpg"] = enet_td3_ddpg_phase(dev, args.out, zero_counts,
                                                  read_counts)
    report["enet_program"] = enet_program_phase(dev, args.out, zero_counts,
                                                read_counts, n_sm)
    stamp(t_start)
    report["calib_td3_ddpg"] = calib_td3_ddpg_phase(dev, args.out,
                                                    zero_counts, read_counts)
    stamp(t_start)

    # -- the batched slice at N=62: BatchedCalibEnv (E=4) and its oracle,
    # prefetch, the batched trainer -----------------------------------------
    n62_step_s = float(np.mean([s["seconds"] for s in report["n62"]["steps"]]))
    report["batched"] = batched_env_phase(
        dev, zero_counts, read_counts, n62_step_s, report["n62"]["idle"])
    stamp(t_start)
    report["prefetch"] = prefetch_phase(dev, zero_counts, read_counts)
    report["batched_train"] = batched_train_phase(dev, args.out, zero_counts,
                                                  read_counts)
    stamp(t_start)

    # -- SKA-tier path: CalibEnv(M=10) at N=256, npix=1024, reset + step ---
    ska_held = held_bytes(dev)
    ska_backend = RadioBackend(device=dev, **SKA)
    statics = ska_backend._influence_statics(SKA["npix"])
    if statics != dict(SKA_STATICS, precision="f32"):
        raise AssertionError(f"SKA statics {statics}, expected "
                             f"{SKA_STATICS} in f32")
    ska_env = CalibEnv(M=10, backend=ska_backend, seed=0, provide_hint=True,
                       device=dev)
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    t0 = time.perf_counter()
    ska_obs0 = ska_env.reset()
    t_ska_reset = time.perf_counter() - t0
    spies = {"dft_imager": FirstCall(dft_imager, "dirty_image_cuda"),
             "hessian_blocks": FirstCall(hessian_blocks,
                                         "hessian_block_sums_cuda"),
             "factored_imager": FirstCall(factored_imager,
                                          "dirty_image_factored_cuda"),
             "_chunk_influence_opt": FirstCall(influence,
                                               "_chunk_influence_opt"),
             "influence_visibilities": FirstCall(influence,
                                                 "influence_visibilities"),
             "influence_image": FirstCall(ska_backend, "influence_image")}
    ska_obs, ska_steps = run_steps(ska_env, 1)
    for s in spies.values():
        s.restore()
    ska_launches = read_counts()
    ska_peak = torch.cuda.max_memory_allocated(dev)
    print_path("SKA path (N=256, npix=1024)", ska_env, ska_backend,
               t_ska_reset, ska_steps, ska_peak, ska_launches, ska_held)
    check_outputs((ska_obs0, ska_obs), ska_steps, SKA["npix"], ska_env.M)
    for name, least in (("hessian_blocks", 12), ("factored_imager", 6),
                        ("dft_imager", 6)):
        if ska_launches[name] < least:
            raise AssertionError(f"{name} launched {ska_launches[name]} "
                                 f"times on the SKA path, expected >= "
                                 f"{least}")
    report["ska"] = dict(config=SKA, statics=statics,
                         reset_seconds=t_ska_reset, steps=ska_steps,
                         K=ska_env.K,
                         stage_seconds=dict(ska_backend.stage_seconds),
                         peak_mem_bytes=ska_peak, held_mem_bytes=ska_held,
                         launches=ska_launches,
                         sigma_data_img=ska_env._sigma_data_img)
    report["ska"]["idle"] = {"step_wall_s": ska_steps[0]["seconds"]}
    defer(step_profile, "SKA step", ska_env, report["ska"]["idle"])
    stamp(t_start)

    # -- the bf16 influence path on the SKA and N=62 steps' own operands,
    # kernel 2's bf16 mode at the SKA path's ------------------------------
    report["bf16"] = bf16_phase(dev, zero_counts, read_counts, n_sm,
                                args.out, spies, n62_spies)
    del n62_spies

    # -- the baseline route on the SKA step's own operands, with positions
    # on the card ----------------------------------------------------------
    (ska_ep, ska_res, ska_rho, ska_alpha), _ = spies["influence_image"].args
    report["ska"]["sharded"] = sharded_ska_checks(
        dev, ska_backend, ska_ep, ska_res, ska_rho, ska_alpha, zero_counts,
        read_counts, n_sm, ref=spies["influence_image"].result)
    del spies["influence_image"], ska_ep, ska_res
    stamp(t_start)

    # -- hessian_blocks: path operands (band 0, chunk 0 of the step) -------
    hargs, hkw = spies["hessian_blocks"].args
    R3, C5, Jp, Jq, p_idx, q_idx, N = hargs
    if hkw.get("sched") is None:
        raise AssertionError("the SKA path's Hessian call did not take the "
                             "full-set schedule")
    h_lab = (f"SKA path K={C5.shape[0]} Td={C5.shape[1]} B={C5.shape[2]} "
             f"N={N}")
    h_err = check_hessian(hessian_blocks, kernels, hargs, hkw, h_lab)
    for n_st, k_r, td_r, subset in HESSIAN_RAGGED:
        p, q = kernels.baseline_indices(n_st, dev)
        if subset:                    # every third baseline + 2 sentinels
            p = torch.cat([p[::3], p.new_full((2,), n_st)])
            q = torch.cat([q[::3], q.new_full((2,), n_st)])
        nb = p.numel()

        def rnd(*shape):
            return torch.randn(shape, generator=g).to(dev)

        rargs = (rnd(td_r, nb, 2, 2, 2), rnd(k_r, td_r, nb, 2, 2, 2),
                 rnd(k_r, nb, 2, 2, 2), rnd(k_r, nb, 2, 2, 2), p, q, n_st)
        rkw = {} if subset else {
            "sched": hessian_blocks.full_schedule(n_st, dev)[0]}
        h_err += check_hessian(
            hessian_blocks, kernels, rargs, rkw,
            f"ragged N={n_st} K={k_r} Td={td_r} B={nb}"
            + (" subset+sentinels" if subset else " full set"))

    def h_kernel():
        return hessian_blocks.hessian_block_sums_cuda(*hargs, **hkw)

    h_launch = hessian_launcher(hessian_blocks, hargs, hkw["sched"])[0]
    h_ms = cuda_ms(h_kernel, 20)
    h_dev_ms = cuda_ms_batched(h_launch)
    h_dev_one = cuda_ms(h_launch, 20)
    h_plain_ms = cuda_ms(lambda: kernels._hessian_block_sums(*hargs), 5)
    h_dev_ms2 = cuda_ms_batched(h_launch)
    h_ms2 = cuda_ms(h_kernel, 20)
    h_bound, h_bound_by = hessian_bound_ms(hargs, n_sm)
    print(f"hessian_blocks at {h_lab}: kernel {h_ms:.4f} / {h_ms2:.4f} ms "
          f"(median, two runs; wrapper included), device {h_dev_ms:.4f} / "
          f"{h_dev_ms2:.4f} ms (tile pass + combine alone, 20 back-to-back "
          f"launches; one launch between events {h_dev_one:.4f} ms), plain "
          f"{h_plain_ms:.4f} ms, bound {h_bound:.4f} ms ({h_bound_by})",
          flush=True)
    del hargs, hkw, R3, C5, Jp, Jq, h_launch

    # -- where the SKA influence stage goes: its pieces on the step's own
    # operands (band 0, chunk 0), CUDA events, median of 5 -----------------
    infl = influence_pieces(spies["_chunk_influence_opt"].args,
                            spies["influence_visibilities"].args)
    del spies["_chunk_influence_opt"], spies["influence_visibilities"]

    # -- factored_imager: path operands (band-0 influence visibilities) ----
    (f_uvw, f_vis, f_freq, f_cell), f_kw = spies["factored_imager"].args
    npix = f_kw["npix"]
    f_out = factored_imager.dirty_image_factored_cuda(f_uvw, f_vis, f_freq,
                                                      f_cell, npix=npix)
    f_ref = imager.dirty_image_factored_blocked_sr(
        f_uvw, f_vis, f_freq, f_cell, npix=npix,
        block_r=SKA_STATICS["imager_block_r"])
    torch.cuda.synchronize()
    f_R = f_uvw.shape[0]
    f_err = [check_close("factored_imager", f"SKA path npix={npix} R={f_R}",
                         f_out, f_ref, FACTORED_RTOL, FACTORED_ATOL,
                         float(f_ref.abs().max()))]
    del f_out, f_ref
    for r_n, r_npix in RAGGED:
        ru, rv, rf = random_imager_case(r_n, r_n, dev)
        rc = imager.default_cell(ru, rf)
        o_k = factored_imager.dirty_image_factored_cuda(ru, rv, rf, rc,
                                                        npix=r_npix)
        o_r = imager.dirty_image_factored_blocked_sr(ru, rv, rf, rc,
                                                     npix=r_npix, block_r=4096)
        f_err.append(check_close("factored_imager",
                                 f"ragged npix={r_npix} R={r_n}", o_k, o_r,
                                 FACTORED_RTOL, FACTORED_ATOL,
                                 float(o_r.abs().max())))
    def f_kernel():
        return factored_imager.dirty_image_factored_cuda(
            f_uvw, f_vis, f_freq, f_cell, npix=npix)

    f_ms = cuda_ms(f_kernel, 5, warmup=1)
    f_plain_ms = cuda_ms(lambda: imager.dirty_image_factored_blocked_sr(
        f_uvw, f_vis, f_freq, f_cell, npix=npix,
        block_r=SKA_STATICS["imager_block_r"]), 3, warmup=1)
    # library yardstick: one cuBLAS SGEMM of the precomputed planes
    p1, p2, cb, sb = imager._factored_planes(f_uvw, f_vis, f_freq, f_cell,
                                             npix)
    lhs = torch.cat([p1, p2], 1)
    rhs = torch.cat([cb, sb], 1).T
    del p1, p2, cb, sb
    f_lib_ms = cuda_ms(lambda: torch.matmul(lhs, rhs), 3, warmup=1)
    del lhs, rhs
    torch.cuda.empty_cache()
    f_ms2 = cuda_ms(f_kernel, 5, warmup=1)
    report["profiler_capture"] = {}
    defer(capture_profile, functools.partial(
        factored_imager.dirty_image_factored_cuda, f_uvw, f_vis, f_freq,
        f_cell, npix=npix), report["profiler_capture"], f_ms2)
    f_bounds = separable_bounds(npix, f_R, n_sm)
    print(f"factored_imager at npix={npix} R={f_R}: kernel {f_ms:.3f} / "
          f"{f_ms2:.3f} ms (median, two runs), plain {f_plain_ms:.3f} ms, "
          f"library (cuBLAS SGEMM of the planes) {f_lib_ms:.3f} ms, bounds "
          + ", ".join(f"{k} {v}" for k, v in f_bounds.items()), flush=True)
    if not max(f_ms, f_ms2) < f_lib_ms:
        raise AssertionError("factored_imager is not faster than the cuBLAS "
                             "SGEMM yardstick")

    # one influence stage call = Nf bands, each influence_visibilities (the
    # preparation, then n_chunks chunks) and one factored image
    infl["factored_imager"] = f_ms
    n_calls = report["ska"]["launches"]["factored_imager"] // SKA["n_freqs"]
    infl["stage_s_per_call"] = (report["ska"]["stage_seconds"]["influence"]
                                / max(n_calls, 1))
    infl["bands_estimate_s"] = SKA["n_freqs"] * 1e-3 * (
        infl["influence_visibilities"] + f_ms)
    report["ska"]["influence_pieces_ms"] = infl
    print("SKA influence pieces (ms, CUDA events, median of 5, step's own "
          "operands): per chunk (x" + str(infl["n_chunks"]) + " per band): "
          + ", ".join(f"{k} {infl[k]:.4f}" for k in (
              "hessian_kernel", "hessian_assemble", "hadd_colmeans",
              "solve_in_colmeans", "llr"))
          + f"; per band (x{SKA['n_freqs']} per call): visibilities_prep "
          f"{infl['visibilities_prep']:.4f}, influence_visibilities "
          f"{infl['influence_visibilities']:.4f}, factored_imager "
          f"{f_ms:.4f}; bands estimate {infl['bands_estimate_s']:.4f} s "
          f"against the stage's {infl['stage_s_per_call']:.4f} s per call",
          flush=True)

    # -- dft_imager at the SKA path's shapes, held on a pixel subset -------
    (s_uv, s_vis, s_npix, s_cell), _ = spies["dft_imager"].args
    s_err = check_imager(dft_imager, s_uv, s_vis, s_npix, s_cell, "SKA path",
                         gen=g)

    def s_kernel():
        return dft_imager.dirty_image_cuda(s_uv, s_vis, s_npix, s_cell)

    s_ms = cuda_ms(s_kernel, 3, warmup=1)
    s_ms2 = cuda_ms(s_kernel, 3, warmup=1)
    s_P, s_R = s_npix * s_npix, s_uv.shape[0]
    s_bounds = separable_bounds(s_npix, s_R, n_sm)
    print(f"dft_imager at P={s_P} R={s_R}: kernel {s_ms:.3f} / {s_ms2:.3f} "
          "ms (median of 3, two runs), bounds "
          + ", ".join(f"{k} {v}" for k, v in s_bounds.items()), flush=True)
    if max(s_ms, s_ms2) > 150.0 or max(dft_ms, dft_ms2) > factored_ms:
        raise AssertionError("dft_imager slower than its limits: 150 ms at "
                             "the SKA shapes, the plain factored imager at "
                             "N=62")
    del ska_env, ska_backend, spies, s_uv, s_vis
    torch.cuda.empty_cache()

    # -- the same tiny episodes on the GPU and on the CPU ------------------
    tiny_rel = tiny_gpu_vs_cpu(CalibEnv, RadioBackend, dev, "unblocked")
    tiny_blk_rel = tiny_gpu_vs_cpu(CalibEnv, RadioBackend, dev,
                                   "blocked tier", block_baselines=4,
                                   imager_block_r=256)

    report["demix_env"]["profile"] = {}
    defer(demix_profile, demix_env, report["demix_env"]["profile"])
    del demix_env

    # -- the rest of the runtime slice, before the first profiler session
    # (the runtime phase's --trace run) ---------------------------------------
    report["runtime_rest"] = runtime_rest_phase(dev, args.out, zero_counts,
                                                read_counts)
    stamp(t_start)

    # -- the distributed-training slice, before the first profiler session
    report["fleet"] = fleet_phase(dev, args.out, zero_counts, read_counts,
                                  n_sm)
    stamp(t_start)

    # -- the multi-process slice: ranks spawned on the card ---------------
    report["multiprocess"] = multiprocess_phase(dev)
    stamp(t_start)

    # -- the serving slice, before the first profiler session -------------
    report["serve"] = serve_phase(dev, args.out, zero_counts, read_counts,
                                  n_sm)
    stamp(t_start)

    # -- the runtime slice, the last timed phase: its final run holds a
    # profiler session ------------------------------------------------------
    report["runtime"] = runtime_phase(dev, args.out, zero_counts,
                                      read_counts)
    stamp(t_start)

    # -- the profiled measurements the phases queued ----------------------
    run_deferred(t_start)
    stamp(t_start)

    sup = report["supervised"]
    orc = report["n62"]["oracle"]
    shd = report["ska"]["sharded"]
    fl = report["fleet"]["demix"]
    sv = report["serve"]
    bf, bfk = report["bf16"], report["bf16"]["kernel"]

    def bf16_launches(name):
        """The f32 kernel's launches on the bf16 influence paths."""
        return {"ska": bf["ska"]["launches"][name],
                "n62": bf["n62"]["launches"][name]}

    def f32_bounds(bounds):
        return {k: v for k, v in bounds.items() if k != "bound_bf16_ms"}

    def new_paths(name):
        """The kernel's launches on the batched, demixing and supervised
        slices' paths."""
        demix = [report["demix_env"]["launches"],
                 report["demix_fuzzy"]["launches"]] + [
            report["demix_batched"][k]["launches"] for k in ("fused",
                                                             "oracle")] + [
            v["launches"] for k, v in report["demix_drivers"].items()
            if k.startswith("demix")]
        return {"launches_diffuse_path":
                report["diffuse"]["launches"][name],
                "launches_demix_paths": sum(d[name] for d in demix),
                "launches_calib_sac_light_path":
                report["demix_drivers"]["calib_sac_light"]["launches"][name],
                "launches_batched_path":
                report["batched"]["launches"][name],
                "launches_batched_oracle":
                report["batched"]["oracle"]["launches"][name],
                "launches_prefetch_path":
                report["prefetch"]["with"]["launches"][name],
                "launches_batched_train_path":
                report["batched_train"]["launches"][name],
                "launches_supervised_dataset_path":
                sup["dataset"]["launches"][name],
                "launches_recommend_path": sup["recommend"]["launches"][name],
                "launches_supervised_other_paths": sum(
                    sup[k]["launches"][name] for k in (
                        "regressors", "influence", "evaluate_models"))}

    kernels_line = [
        {"name": "dft_imager", "route": "cuda",
         "source": "smartcal_tpu_torch/csrc/dft_imager.cu",
         "engine": "smartcal_tpu_torch/csrc/separable_imager.cuh",
         "replaces": "smartcal_tpu/ops/pallas_imager.py:58",
         "launches": ska_launches["dft_imager"],
         "launches_n62_path": n62_launches["dft_imager"],
         "launches_oracle_path": orc["launches"]["dft_imager"],
         "oracle_shapes": orc["kernel"]["shapes"],
         "oracle_ms": orc["kernel"]["ms"],
         "oracle_plain_ms": orc["kernel"]["plain_ms"],
         "oracle_bound_ms": orc["kernel"]["bound_ms"],
         "oracle_bound_by": orc["kernel"]["bound_by"],
         "oracle_max_abs_err": orc["kernel"]["max_abs_err"],
         "launches_train_path": report["train"]["launches"]["dft_imager"],
         "launches_calib_td3_path":
             report["calib_td3_ddpg"]["calib_td3"]["launches"]["dft_imager"],
         "launches_calib_ddpg_path":
             report["calib_td3_ddpg"]["calib_ddpg"]["launches"][
                 "dft_imager"],
         "launches_enet_paths": sum(
             report[k]["launches"]["dft_imager"] for k in ("enet_step",
                                                           "enet_sac")),
         "launches_runtime_path":
             report["runtime"]["launches"]["dft_imager"],
         "launches_runtime_rest_path":
             report["runtime_rest"]["launches"]["dft_imager"],
         "launches_bf16_paths": bf16_launches("dft_imager"),
         "max_abs_err": max(dft_err + [report["diffuse"]["dft_max_abs_err"],
                                       orc["kernel"]["max_abs_err"],
                                       sup["kernel"]["max_abs_err"],
                                       fl["kernel"]["max_abs_err"],
                                       sv["kernel"]["max_abs_err"]]),
         "ms": dft_ms,
         "plain_ms": dft_plain_ms, **f32_bounds(dft_bounds),
         "library_ms": None,
         "shapes": f"P={P} R={R}", "yardstick_factored_ms": factored_ms,
         "ska_ms": s_ms, "ska_bound_ms": s_bounds["bound_ms"],
         "ska_bound_fp32_ms": s_bounds["bound_fp32_ms"],
         "ska_bound_direct_ms": s_bounds["bound_direct_ms"],
         "ska_shapes": f"P={s_P} R={s_R}", "ska_max_abs_err_subset": s_err,
         "supervised_shapes": f"P={sup['kernel']['P']} R="
                              f"{sup['kernel']['R']}",
         "supervised_ms": sup["kernel"]["ms"],
         "supervised_plain_ms": sup["kernel"]["plain_ms"],
         "supervised_bound_ms": sup["kernel"]["bound_ms"],
         "supervised_bound_by": sup["kernel"]["bound_by"],
         "supervised_max_abs_err": sup["kernel"]["max_abs_err"],
         "launches_demix_fleet_path": fl["launches"]["dft_imager"],
         "demix_fleet_observations": fl["observations"],
         "demix_fleet_shapes": f"P={fl['kernel']['P']} R={fl['kernel']['R']}",
         "demix_fleet_ms": fl["kernel"]["ms"],
         "demix_fleet_plain_ms": fl["kernel"]["plain_ms"],
         "demix_fleet_bound_ms": fl["kernel"]["bound_ms"],
         "demix_fleet_bound_by": fl["kernel"]["bound_by"],
         "demix_fleet_max_abs_err": fl["kernel"]["max_abs_err"],
         "launches_serve_batch_path":
             sv["batch_launches"]["dft_imager"],
         "launches_serve_sentinel_replay": sv["launches"]["dft_imager"],
         "serve_shapes": f"P={sv['kernel']['P']} R={sv['kernel']['R']}",
         "serve_ms": sv["kernel"]["ms"],
         "serve_plain_ms": sv["kernel"]["plain_ms"],
         "serve_bound_ms": sv["kernel"]["bound_ms"],
         "serve_bound_by": sv["kernel"]["bound_by"],
         "serve_max_abs_err": sv["kernel"]["max_abs_err"],
         **new_paths("dft_imager")},
        {"name": "hessian_blocks", "route": "cuda",
         "source": "smartcal_tpu_torch/csrc/hessian_blocks.cu",
         "replaces": "smartcal_tpu/ops/pallas_hessian.py:60",
         "launches": ska_launches["hessian_blocks"],
         "launches_bf16_paths": bf16_launches("hessian_blocks"),
         "launches_sharded_ska_path": shd["launches"]["hessian_blocks"],
         "sharded_positions": shd["positions"],
         "sharded_position_shapes": [f"B={p['B']} (subset layout)"
                                     for p in shd["kernel3_positions"]],
         "sharded_position_ms": [p["ms"] for p in
                                 shd["kernel3_positions"]],
         "sharded_position_bound_ms": [p["bound_ms"] for p in
                                       shd["kernel3_positions"]],
         "sharded_single_ms": shd["kernel3_single_ms"],
         "max_abs_err": max(h_err + [p["max_abs_err"] for p in
                                     shd["kernel3_positions"]]),
         "ms": h_ms, "device_ms": h_dev_ms,
         "plain_ms": h_plain_ms, "bound_ms": h_bound, "bound_by": h_bound_by,
         "device_ms_one_launch": h_dev_one, "library_ms": None,
         "shapes": h_lab, "bit_identical": True,
         **new_paths("hessian_blocks")},
        {"name": "factored_imager", "route": "cuda",
         "source": "smartcal_tpu_torch/csrc/factored_imager.cu",
         "engine": "smartcal_tpu_torch/csrc/separable_imager.cuh",
         "replaces": "smartcal_tpu/ops/pallas_imager.py:159",
         "launches": ska_launches["factored_imager"],
         "launches_bf16_paths": bf16_launches("factored_imager"),
         "launches_sharded_ska_path": shd["launches"]["factored_imager"],
         "max_abs_err": max(f_err), "ms": f_ms, "plain_ms": f_plain_ms,
         **f32_bounds(f_bounds), "library_ms": f_lib_ms,
         "shapes": f"npix={npix} R={f_R}", **new_paths("factored_imager")},
        {"name": "factored_imager_bf16", "route": "cuda",
         "source": "smartcal_tpu_torch/csrc/factored_imager.cu",
         "entry": "factored_image_bf16_launch",
         "replaces": "smartcal_tpu/ops/pallas_imager.py:159",
         "mode": "precision='bf16': bf16 operands, f32 accumulation",
         "launches": bf["ska"]["launches"]["factored_imager_bf16"],
         "launches_n62_bf16_path":
             bf["n62"]["launches"]["factored_imager_bf16"],
         "launches_f32_paths": {"n62": n62_launches["factored_imager_bf16"],
                                "ska": ska_launches["factored_imager_bf16"]},
         "max_abs_err": bfk["max_abs_err"],
         "max_abs_err_vs_f32": bfk["max_abs_err_vs_f32"], "ms": bfk["ms"],
         "plain_ms": bfk["plain_ms"], "bound_ms": bfk["bound_ms"],
         "bound_by": bfk["bound_by"], "library_ms": bfk["library_ms"],
         "shapes": bfk["shapes"], "bit_identical": bfk["bit_identical"],
         "ptxas": bfk["ptxas"], **new_paths("factored_imager_bf16")},
        enet_kernel_entry("enet_lbfgs", report),
        enet_kernel_entry("sym_eigvals", report)]
    mp = report["multiprocess"]
    for entry in kernels_line:
        if entry["name"] in mp["max_abs_err"]:
            entry["launches_multiprocess_path"] = \
                mp["launches"][entry["name"]]
            entry["multiprocess_max_abs_err"] = \
                mp["max_abs_err"][entry["name"]]
    report.update(kernels=kernels_line, card=card, tiny_rel=tiny_rel,
                  tiny_blocked_rel=tiny_blk_rel,
                  kernel_ms_repeats={"dft_imager": [dft_ms, dft_ms2],
                                     "dft_imager_ska": [s_ms, s_ms2],
                                     "hessian_blocks": [h_ms, h_ms2],
                                     "hessian_blocks_device": [h_dev_ms,
                                                               h_dev_ms2],
                                     "factored_imager": [f_ms, f_ms2],
                                     "factored_imager_bf16": [
                                         bfk["ms"], bfk["ms_repeat"]]},
                  total_seconds=time.perf_counter() - t_start)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1, default=float)
    print(f"total {report['total_seconds']:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels_line}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
