"""f32 precision policy (counterpart of smartcal_tpu/cal/precision.py).

Only the f32 rows are ported: the calibration episode path runs every
contraction in float32 (TF32 is switched off at package import, see
``smartcal_tpu_torch/__init__.py``).  The bf16 rows of the JAX policy, and
the ``precision=`` option that selects them, belong to the SKA-scale slice
and are still to be ported.
"""

import torch

F32 = torch.float32
