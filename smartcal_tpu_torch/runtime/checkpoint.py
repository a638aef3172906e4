"""Versioned, checksummed run checkpoints with atomic publication
(counterpart of smartcal_tpu/runtime/checkpoint.py, same layout).

Layout under a run's checkpoint root::

    <root>/
      ckpt_000040/
        payload.pkl      # ONE pickle: the whole host-side run state
        meta.json        # {"step", "sha256", "payload_bytes", ...}
      ckpt_000080/
      LATEST             # json {"step", "dir", "sha256"}

Publication: the payload pickles into a hidden temp dir next to the
target, ``meta.json`` (with the payload's sha256) lands beside it, ONE
``os.replace`` renames the dir to ``ckpt_<step>``, ``LATEST`` updates
atomically, and retention prunes to the newest K.  ``load_latest``
validates the sha256 before unpickling and falls back to the next older
checkpoint (a corrupt LATEST degrades to a directory scan).

A payload holds numpy arrays and Python values only, never a CUDA tensor:
a checkpoint written on the card loads on a CPU host.  :func:`pack_replay`
/ :func:`unpack_replay` give the device replay ring (``rl/replay.py``) its
payload form (the filled prefix, ``cntr``, ``beta`` and the PER
priorities); :func:`pack_env_state` / :func:`restore_env_state` the envs'
episode RNG state.
"""

import json
import os
import re
import shutil
import tempfile
import time
from typing import Optional, Tuple

import numpy as np

from .atomic import atomic_pickle, atomic_write_text, sha256_file

CKPT_PREFIX = "ckpt_"
LATEST = "LATEST"
PAYLOAD = "payload.pkl"
META = "meta.json"
_DIR_RE = re.compile(r"^ckpt_(\d+)$")


def _ckpt_dirname(step: int) -> str:
    return f"{CKPT_PREFIX}{int(step):06d}"


def list_checkpoints(root: str) -> "list[Tuple[int, str]]":
    """[(step, absolute dir)] sorted ascending by step."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        m = _DIR_RE.match(name)
        if m and os.path.isdir(os.path.join(root, name)):
            out.append((int(m.group(1)), os.path.join(root, name)))
    return sorted(out)


def save_checkpoint(root: str, step: int, payload: dict,
                    keep: int = 3, fsync: bool = True) -> str:
    """Write ``payload`` as ``ckpt_<step>`` (see module doc); returns the
    published directory path.  ``payload`` must be host data: numpy arrays,
    Python values and CPU tensors; a CUDA tensor raises, so a checkpoint
    written on the card loads on a host without one."""
    _check_host(payload)
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, _ckpt_dirname(step))
    tmp = tempfile.mkdtemp(prefix=f".{_ckpt_dirname(step)}.", dir=root)
    try:
        nbytes = atomic_pickle(payload, os.path.join(tmp, PAYLOAD),
                               fsync=fsync)
        sha = sha256_file(os.path.join(tmp, PAYLOAD))
        meta = {"step": int(step), "sha256": sha, "payload_bytes": nbytes,
                "wrote_unix": round(time.time(), 3),
                "fields": sorted(payload) if isinstance(payload, dict)
                else None}
        atomic_write_text(os.path.join(tmp, META), json.dumps(meta),
                          fsync=fsync)
        if os.path.isdir(final):
            # re-checkpointing the same step (a rolled-back run walking
            # past it again): retire the old dir first so the rename
            # can't collide.  LATEST still points at a valid older
            # checkpoint throughout.
            shutil.rmtree(final)
        os.replace(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    atomic_write_text(os.path.join(root, LATEST),
                      json.dumps({"step": int(step),
                                  "dir": _ckpt_dirname(step),
                                  "sha256": sha}), fsync=fsync)
    _prune(root, keep, protect=final)
    _log_event("checkpoint", root=root, step=int(step), bytes=nbytes,
               kept=keep)
    return final


def _prune(root: str, keep: int, protect: str) -> None:
    if keep <= 0:
        return
    entries = list_checkpoints(root)
    for step, path in entries[:-keep]:
        if os.path.abspath(path) != os.path.abspath(protect):
            shutil.rmtree(path, ignore_errors=True)
    # stale hidden temp dirs from killed writers
    for name in os.listdir(root):
        if name.startswith(f".{CKPT_PREFIX}"):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def _validate(path: str) -> bool:
    """True when ``path`` holds a complete, checksum-clean checkpoint."""
    payload, meta = os.path.join(path, PAYLOAD), os.path.join(path, META)
    try:
        with open(meta) as f:
            m = json.load(f)
        return sha256_file(payload) == m.get("sha256")
    except (OSError, ValueError):
        return False


def load_latest(root: str) -> Optional[Tuple[dict, int]]:
    """(payload, step) of the newest VALID checkpoint, or None.

    The LATEST pointer is the fast path; a corrupt pointer or a failed
    checksum falls back to scanning ``ckpt_*`` newest-first.
    """
    import pickle

    candidates = []
    latest = os.path.join(root, LATEST)
    if os.path.exists(latest):
        try:
            with open(latest) as f:
                rec = json.load(f)
            candidates.append((int(rec["step"]),
                               os.path.join(root, rec["dir"])))
        except (OSError, ValueError, KeyError, TypeError):
            pass
    for step, path in reversed(list_checkpoints(root)):
        if (step, path) not in candidates:
            candidates.append((step, path))
    for step, path in candidates:
        if not _validate(path):
            continue
        try:
            with open(os.path.join(path, PAYLOAD), "rb") as f:
                # checksum-validated above + except->older-candidate
                # fallback IS this loader's corruption guard
                return pickle.load(f), step
        except Exception:
            continue
    return None


def _log_event(event: str, **fields) -> None:
    from smartcal_tpu_torch import obs
    rl = obs.active()
    if rl is not None:
        rl.log(event, **fields)


def _check_host(obj, where="payload") -> None:
    """Raise TypeError for a tensor off the CPU anywhere in ``obj``."""
    if isinstance(obj, dict):
        for k, v in obj.items():
            _check_host(v, f"{where}[{k!r}]")
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _check_host(v, f"{where}[{i}]")
    elif getattr(obj, "is_cuda", False) or (
            hasattr(obj, "device") and hasattr(obj, "detach")
            and str(obj.device) != "cpu"):
        raise TypeError(f"{where} is a tensor on {obj.device}: checkpoint "
                        "payloads hold host data only")


# ---------------------------------------------------------------------------
# Replay-ring and env-state payload forms
# ---------------------------------------------------------------------------

def pack_replay(buf: object) -> dict:
    """Host form of a replay buffer for the checkpoint payload.  A device
    ring: the filled prefix of every field and of the priorities, ``cntr``
    (the cursor is ``cntr % size``), ``beta`` and the ring size
    (``rl.replay.replay_to_host``).  A native ring (``NativePER``, JAX
    runtime/checkpoint.py:174-220): its ``state_dict`` (ring arrays, the
    tree's leaves, cursor and fill, beta), so priorities round-trip bit
    for bit."""
    from smartcal_tpu_torch.rl import replay as rp
    from smartcal_tpu_torch.rl import replay_sharded as rps
    from smartcal_tpu_torch.rl.replay_native import NativePER

    if isinstance(buf, rps.ShardedReplayState):
        return {"kind": "device_sharded", "state": rps.replay_to_host(buf)}
    if isinstance(buf, rp.ReplayState):
        return {"kind": "device_ring", "state": rp.replay_to_host(buf)}
    if isinstance(buf, NativePER):
        return {"kind": "native", "state": buf.state_dict()}
    raise TypeError(f"unsupported replay buffer {type(buf)!r}")


def unpack_replay(obj: dict, device="cuda") -> object:
    """The buffer of a :func:`pack_replay` payload: a full-size ring on
    ``device`` (the slots past the prefix are zero, as in the ring that was
    packed), or a host ``NativePER``."""
    from smartcal_tpu_torch.rl import replay as rp

    kind = obj.get("kind")
    if kind == "device_ring":
        return rp.replay_from_host(obj["state"], device)
    if kind == "device_sharded":
        from smartcal_tpu_torch.rl import replay_sharded as rps
        return rps.replay_from_host(obj["state"], device)
    if kind == "native":
        from smartcal_tpu_torch.rl.replay_native import NativePER
        return NativePER.from_state_dict(obj["state"])
    raise ValueError(f"unknown replay payload kind {kind!r}")


def pack_env_state(env: object) -> Optional[dict]:
    """Host form of an env's episode RNG state: the batched envs'
    ``state_dict()`` (per-lane key array and counters), else the
    sequential envs' single numpy threefry key ``_key``; None for an env
    with neither."""
    if hasattr(env, "state_dict"):
        return {"kind": "env_state_dict", "state": env.state_dict()}
    if hasattr(env, "_key"):
        return {"kind": "env_key", "key": np.array(env._key, np.uint32)}
    return None


def restore_env_state(env: object, obj: Optional[dict]) -> None:
    """Inverse of :func:`pack_env_state`: no-op on None; a payload whose
    kind does not fit the env raises ValueError.  A pending episode
    prefetch is discarded first: it was built for a key of the walk being
    abandoned, and must never be taken."""
    if obj is None or env is None:
        return
    tag = getattr(env, "_pf_tag", None)
    if tag is not None:
        env.backend.discard_prefetched(tag)
        env._pf_tag = None
    kind = obj.get("kind")
    if kind == "env_state_dict" and hasattr(env, "load_state_dict"):
        env.load_state_dict(obj["state"])
    elif kind == "env_key" and hasattr(env, "_key"):
        env._key = np.array(obj["key"], np.uint32)
    else:
        raise ValueError(
            f"env payload kind {kind!r} does not match env {type(env)!r}")


class Checkpointer:
    """Bound (root, keep) pair with cadence bookkeeping for a run."""

    def __init__(self, root: str, keep: int = 3, every: int = 0):
        self.root = root
        self.keep = max(1, int(keep))
        self.every = max(0, int(every))
        self.last_step: Optional[int] = None

    def due(self, step: int) -> bool:
        # a rolled-back run re-crossing an already-saved step SHOULD
        # re-save: post-mitigation state differs from the poisoned walk
        return self.every > 0 and step > 0 and step % self.every == 0

    def save(self, step: int, payload: dict) -> str:
        path = save_checkpoint(self.root, step, payload, keep=self.keep)
        self.last_step = int(step)
        return path

    def load_latest(self) -> Optional[Tuple[dict, int]]:
        return load_latest(self.root)
