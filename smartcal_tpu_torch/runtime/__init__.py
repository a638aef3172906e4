"""Fault-tolerant training runtime of the port (counterpart of
smartcal_tpu/runtime):

* :mod:`~smartcal_tpu_torch.runtime.atomic`: crash-safe writes and
  corruption-tolerant loads;
* :mod:`~smartcal_tpu_torch.runtime.checkpoint`: the versioned,
  sha256-validated checkpoint store (``ckpt_<step>/``, ``LATEST``,
  retain-K) and the payload forms of the replay ring and the envs;
* :mod:`~smartcal_tpu_torch.runtime.backoff`: deterministic backoff;
* :mod:`~smartcal_tpu_torch.runtime.faults`: deterministic fault
  injection (``SMARTCAL_FAULTS``);
* :mod:`~smartcal_tpu_torch.runtime.recovery`: the watchdog's
  rollback-and-retry policy;
* :mod:`~smartcal_tpu_torch.runtime.supervisor`: heartbeat-monitored
  actor slots (threads or spawned worker processes) with restart on
  death, for the parallel learners;
* :mod:`~smartcal_tpu_torch.runtime.ipc`: the framed, CRC-checked pickle
  transport of the process fleet (the JAX package's frames, byte for
  byte).

Standard library and numpy at import; torch is imported by the functions
that move tensors.
"""

from .atomic import (CorruptStateError, atomic_pickle,       # noqa: F401
                     atomic_write_bytes, atomic_write_text,
                     safe_pickle_load, sha256_file, strict_pickle_load)
from .backoff import Backoff, BackoffPolicy                  # noqa: F401
from .checkpoint import (Checkpointer, load_latest,          # noqa: F401
                         pack_env_state, pack_replay, restore_env_state,
                         save_checkpoint, unpack_replay)
from .faults import (FaultInjected, FaultPlan,               # noqa: F401
                     clear as clear_faults, install as install_faults,
                     plan_from_env)
from .recovery import (RecoveryAction, RecoveryManager,      # noqa: F401
                       RecoveryPolicy)
from .ipc import (CorruptPayloadError, frame_payload,        # noqa: F401
                  unframe_payload)
from .supervisor import Fleet                                # noqa: F401
