"""PyTorch/CUDA port of smartcal_tpu for one NVIDIA H100.

The layout mirrors the JAX package module for module
(``smartcal_tpu_torch/cal/solver.py`` is the counterpart of
``smartcal_tpu/cal/solver.py``):

* ``cal/``, ``envs/``: the calibration episode (simulate, consensus ADMM,
  influence map, images, reward), ``CalibEnv`` (with episode prefetch),
  ``BatchedCalibEnv`` (E episodes as one batched pass), the demixing
  envs (``DemixingEnv`` with its exhaustive hint sweep,
  ``BatchedDemixingEnv``, ``FuzzyDemixingEnv``; the A-team and shapelet
  skies) and the elastic-net ``EnetEnv``;
* ``models/``: the demixing fuzzy controller;
* ``ops/``: the hand-written CUDA kernels of the JAX package's three TPU
  kernels, built from ``csrc/`` on first use: the direct-DFT imager
  (``csrc/dft_imager.cu``) and the rank-factored imager
  (``csrc/factored_imager.cu``), two entry points of one tensor-core
  engine (``csrc/separable_imager.cuh``), and the blocked Hessian
  (``csrc/hessian_blocks.cu``); the lane-batched L-BFGS and the
  ``torch.func`` autodiff tools;
* ``rl/``: the SAC, TD3 and DDPG agents, their networks, the device
  replay ring and the host-side native prioritized replay;
* ``train/``: the calibration SAC/TD3/DDPG trainers, the demixing
  SAC/TD3/fuzzy-SAC trainers, the elastic-net SAC/TD3/DDPG trainers and
  evaluation, and the plumbing they need (run log, checkpoints, resume,
  the watchdog's rollback);
* ``obs/``, ``utils/metrics.py``: the run log, spans, counters, update
  diagnostics, the divergence watchdog, per-stage flops and bytes
  (``obs/costs.py``) and the fingerprinted baselines and detector;
* ``tools/``: the perf gate (``python -m
  smartcal_tpu_torch.tools.perf_gate``);
* ``runtime/``: crash-safe saves, the checkpoint store, fault injection
  and the recovery policy.

Every entry point takes an explicit ``device`` that defaults to ``"cuda"``
and raises when no GPU is present; the CPU runs the same code only when
the caller asks for it (the parity tests do).  Outside the kernels the
math is plain tensor code, as it is plain XLA in the JAX package.

This package imports neither ``jax`` nor anything of ``smartcal_tpu``:
what it needs from there it keeps as its own copy.
"""

import torch

# TF32 off everywhere: the JAX policy pins the ``admm``, ``hessian`` and
# ``solve_4n`` rows to full f32 (smartcal_tpu/cal/precision.py:31-35 —
# bf16-level narrowing there measurably breaks the sigma_res band), and
# TF32 matmuls would quietly keep only ~10 mantissa bits on those same
# contractions.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises for a CUDA device when
    no GPU is visible (the port never falls back to the CPU on its own)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "smartcal_tpu_torch: CUDA device requested but no GPU is "
            "available; pass device='cpu' explicitly to run on the CPU")
    return dev
