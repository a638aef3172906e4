"""bf16/f32 mixed-precision policy of the physics kernels (counterpart of
smartcal_tpu/cal/precision.py).

Precision is a per-kernel policy, not a global switch.  Under
``precision="bf16"`` only the two post-solve linear contractions of the
influence chain narrow their operands to bf16, with f32 accumulation:

* ``imager_matmul``: the factored imager's (npix, R) @ (R, npix) matmuls
  (``cal/imager``, and kernel 2's bf16 mode, ``ops/factored_imager``);
* ``colmeans_contract``: the Yr x Lr gather-contraction of the adjoint
  column means (``cal/kernels._colmeans_adjoint_core_sr``).

The ``hessian``, ``solve_4n`` and ``admm`` rows are pinned to f32 under
every policy: the solve and the 4N x 4N factorizations carry conditioning
constants far below bf16's resolution (the JAX package measured a bf16
Hessian breaking the sigma_res band).  The data and residual images stay
f32 as well.  TF32 is switched off at package import
(``smartcal_tpu_torch/__init__.py``), so every f32 contraction is full
f32.

A bf16 contraction here rounds its operands to bf16 (round to nearest
even) and contracts the rounded values in f32 (:func:`narrow`).  A
product of two bf16 values is exact in f32, so this computes what XLA's
``preferred_element_type=f32`` contraction computes, up to the order of
the f32 sum.  A contraction of bf16 tensors in PyTorch would round its
sum to bf16 as well, which is a different result.
"""

import torch

#: valid values of the ``precision=`` argument
POLICIES = ("f32", "bf16")

#: the f32 dtype of the pinned sites (coordinates, accumulators, solves)
F32 = torch.float32

#: per-kernel dtype class under the mixed ("bf16") policy; "f32" rows are
#: pinned: the policy never narrows them
KERNEL_DTYPES = {
    "imager_matmul": "bf16",
    "colmeans_contract": "bf16",
    "hessian": "f32",
    "solve_4n": "f32",
    "admm": "f32",
}


def check(precision: str) -> str:
    """Validate a ``precision=`` value; raises ValueError on an unknown
    one, so a typo fails at the call site, not as a silent f32 run."""
    if precision not in POLICIES:
        raise ValueError(
            f"precision={precision!r}: expected one of {POLICIES}")
    return precision


def contraction_dtype(kernel: str, precision: str = "f32"):
    """The operand dtype of ``kernel``'s big contraction under
    ``precision``: ``torch.bfloat16`` or :data:`F32`.  Accumulation stays
    f32 at every call site.  An unknown kernel raises KeyError: a new
    kernel takes an explicit row, never one by accident."""
    check(precision)
    if precision == "bf16" and KERNEL_DTYPES[kernel] == "bf16":
        return torch.bfloat16
    return F32


def dtype_name(dtype) -> str:
    """Short name for telemetry tags ("bf16" / "f32")."""
    return "bf16" if dtype == torch.bfloat16 else "f32"


def narrow(x, dtype):
    """``x`` rounded to ``dtype`` (round to nearest even) and held in f32,
    the operand form of an f32-accumulated contraction; ``x`` itself when
    ``dtype`` is f32 (the same bits)."""
    if dtype == F32:
        return x
    return x.to(dtype).to(F32)
