"""Flops and bytes accounting of the hot paths, and the card's roofline
peak (counterpart of smartcal_tpu/obs/costs.py, with its API and its
``cost`` / ``roofline_peak`` event schema, so ``tools/obs_report.py`` joins
the port's events unchanged).

The counting is the port's own.  XLA counts a lowered program without
running it; PyTorch has no such program, so :func:`stage_cost` runs the
stage once under a ``TorchDispatchMode`` that counts, per aten op:

* 2·M·N·K flops for each matrix product (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``; a convolution 2 × output elements × its reduction size,
  its backward twice that);
* one flop per output element for the pointwise and reduction ops;
* the bytes of the op's tensor inputs plus its outputs as
  ``bytes_accessed`` (views move nothing and count nothing);
* the most bytes that tensors made during the call held at once as
  ``peak_bytes``.

A kernel launched through ctypes is invisible to the dispatcher, so each
kernel wrapper (``ops/dft_imager``, ``ops/factored_imager`` through
``cal/imager``, ``ops/hessian_blocks``) adds its analytic per-launch count
with :func:`kernel_cost`, on the card and on its CPU plain path alike
(whose ops are then not counted twice).  A CUDA graph replay is not an op
either: while a count runs, the solver's quartic line search runs eagerly
(:func:`counting`).

Collection is off unless enabled (the trainers' ``--diag``).  Results are
cached per (stage, shape signature); a failure is logged as a ``cost``
event with ``error`` and cached, never raised.  Call sites inside a timed
span pass ``defer=True`` and ``TrainObs`` runs the queue between
episodes (:func:`flush_pending`), so the counted run never inflates the
spans the report divides by.  Counting runs the stage: a stage that
mutates its arguments is handed copies by its call site.

torch is read from ``sys.modules``: importing this never initialises a
device.
"""

import math
import subprocess
import sys
import threading
import weakref
from typing import Callable, Optional

from .runlog import active

_lock = threading.Lock()
_enabled = False
_cache: dict = {}      # (stage, signature) -> result dict
_pending: list = []    # deferred (sig, stage, fn, args, kwargs, dtype,
                       # shards)
_local = threading.local()

#: Published dense peaks (NVIDIA's H100 SXM data sheet, 700 W): bf16 on
#: the tensor cores and FP32 outside them, the rate the split-real solver
#: contends with.  Matched against the CUDA device name; any other card,
#: and the CPU, has no entry (fraction-of-peak then prints dashes).
PEAK_FLOPS = {
    "H100": {"bf16": 989e12, "fp32_est": 67e12, "chip": "H100"},
}

_MATMUL = {"mm", "bmm", "addmm", "baddbmm", "addbmm"}


def set_enabled(on: bool) -> None:
    """Globally arm or disarm cost recording (the trainers' ``--diag``)."""
    global _enabled
    _enabled = bool(on)


def enabled() -> bool:
    return _enabled


def reset_cache() -> None:
    with _lock:
        _cache.clear()
        _pending.clear()


class _Count:
    """One count in progress: flops, bytes, and the bytes held by tensors
    the call made (``live``, its high-water mark ``peak``)."""

    def __init__(self):
        self.flops = 0.0
        self.bytes_accessed = 0.0
        self.live = 0
        self.peak = 0
        self.suspended = 0

    def _freed(self, n):
        self.live -= n

    def hold(self, t):
        n = t.untyped_storage().nbytes()
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._freed, n)


def _active_count() -> Optional[_Count]:
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


def counting() -> bool:
    """True while this thread runs a stage under :func:`stage_cost`."""
    return _active_count() is not None


def kernel_cost(flops: float, nbytes: float):
    """Context of one hand-written kernel's call (or its plain version's):
    adds the kernel's analytic ``flops`` and ``nbytes`` to the running
    count, and counts none of the ops inside.  A no-op context when no
    count runs."""
    return _KernelCost(flops, nbytes)


def uncounted():
    """Context whose ops the running count skips (a probe's set-up, such
    as copying the state it then updates)."""
    return _KernelCost(0.0, 0.0)


class _KernelCost:
    def __init__(self, flops, nbytes):
        self.count = _active_count()
        self.flops, self.nbytes = float(flops), float(nbytes)

    def __enter__(self):
        c = self.count
        if c is not None:
            c.flops += self.flops
            c.bytes_accessed += self.nbytes
            c.suspended += 1
        return self

    def __exit__(self, *exc):
        if self.count is not None:
            self.count.suspended -= 1
        return False


def _tensors(x, out):
    """Append the tensors of ``x`` (a tensor, or nested lists, tuples and
    dicts of them) to ``out``."""
    if isinstance(x, sys.modules["torch"].Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            _tensors(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _tensors(v, out)
    return out


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _op_kind(func):
    """How an aten op counts: None (a view: nothing), "matmul", "conv",
    "conv_backward", "elementwise" (pointwise and reductions: one flop
    per output element) or "move" (bytes only)."""
    torch = sys.modules["torch"]
    if func.is_view:
        return None
    name = func.overloadpacket.__name__
    if name in _MATMUL:
        return "matmul"
    if name == "convolution":
        return "conv"
    if name == "convolution_backward":
        return "conv_backward"
    tags = func.tags
    if torch.Tag.pointwise in tags or torch.Tag.reduction in tags:
        return "elementwise"
    return "move"


def _op_flops(kind, func, args, outs):
    """Flops of one aten op by the rules of the module doc."""
    if kind == "matmul":
        name = func.overloadpacket.__name__
        a, b = (args[1], args[2]) if name in ("addmm", "baddbmm",
                                              "addbmm") else args[:2]
        batch = _numel(a.shape[:-2])
        return 2.0 * batch * a.shape[-2] * a.shape[-1] * b.shape[-1]
    if kind == "conv":                            # (input, weight, ...)
        return 2.0 * outs[0].numel() * _numel(args[1].shape[1:])
    if kind == "conv_backward":                   # (grad_out, input, w)
        return 4.0 * args[0].numel() * _numel(args[2].shape[1:])
    return float(sum(t.numel() for t in outs
                     if t.is_floating_point() or t.is_complex()))


def _counter_mode(count: _Count):
    """A ``TorchDispatchMode`` instance feeding ``count``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    kinds = {}

    class CountingMode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if count.suspended:
                return out
            kind = kinds.get(func, 0)
            if kind == 0:
                kind = kinds[func] = _op_kind(func)
            if kind is None:
                return out
            ins = _tensors(args, [])
            if kwargs:
                _tensors(kwargs, ins)
            outs = _tensors(out, [])
            if kind != "move":
                count.flops += _op_flops(kind, func, args, outs)
            nbytes = 0
            for t in ins:
                nbytes += t.numel() * t.element_size()
            in_ptrs = {t.untyped_storage().data_ptr() for t in ins}
            for t in outs:
                nbytes += t.numel() * t.element_size()
                if t.untyped_storage().data_ptr() not in in_ptrs:
                    count.hold(t)
            count.bytes_accessed += nbytes
            return out

    return CountingMode()


def stage_cost(fn: Callable, *args: object, **kwargs: object) -> dict:
    """Run ``fn(*args, **kwargs)`` once under the counting mode:
    ``{"flops", "bytes_accessed", "peak_bytes"}`` (floats).  The call runs
    for real, on the arguments' device; the result is dropped."""
    torch = sys.modules.get("torch")
    if torch is None:
        raise RuntimeError("torch not imported")
    count = _Count()
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    stack.append(count)
    try:
        with _counter_mode(count):
            out = fn(*args, **kwargs)
        del out
    finally:
        stack.pop()
    return {"flops": float(count.flops),
            "bytes_accessed": float(count.bytes_accessed),
            "peak_bytes": float(count.peak)}


def _signature(args, kwargs) -> str:
    """Shape signature: tensor and array shapes and dtypes, ints, bools,
    strings and None by value (they choose shapes and branches), other
    leaves, floats included, by type (a float is data, as a traced scalar
    is in JAX)."""
    torch = sys.modules.get("torch")
    parts = []

    def walk(x):
        if torch is not None and isinstance(x, torch.Tensor):
            parts.append(f"{tuple(x.shape)}:{x.dtype}:{x.device.type}")
        elif hasattr(x, "shape") and hasattr(x, "dtype"):    # numpy
            parts.append(f"{tuple(x.shape)}:{x.dtype}")
        elif isinstance(x, (list, tuple)):
            parts.append("(")
            for v in x:
                walk(v)
            parts.append(")")
        elif isinstance(x, dict):
            for k in sorted(x, key=str):
                parts.append(f"{k}=")
                walk(x[k])
        elif x is None or isinstance(x, (bool, int, str)):
            parts.append(repr(x))
        else:
            parts.append(type(x).__name__)

    walk(args)
    walk(kwargs)
    return ";".join(parts)


def _shard_footprint(cost, shards):
    """``cost`` with the per-shard footprint of a sharded route (the JAX
    package's accounting): the counted run is the single-device equivalent,
    so the peak per position is its peak over the shards; a ``{axis:
    size}`` mapping divides by the product and also logs each axis alone."""
    axes = None
    if isinstance(shards, dict):
        axes = {str(a): int(n) for a, n in shards.items() if int(n) > 1}
        shards = math.prod(axes.values())
    if not shards or shards <= 1 or "peak_bytes" not in cost:
        return cost
    cost = dict(cost, shards=int(shards),
                peak_bytes_per_shard=cost["peak_bytes"] / shards)
    if axes:
        cost["shard_axes"] = axes
        cost["peak_bytes_per_axis"] = {a: cost["peak_bytes"] / n
                                       for a, n in axes.items()}
    return cost


def _compute_and_log(stage, fn, args, kwargs, compute_dtype=None,
                     shards=1) -> dict:
    rl = active()
    try:
        cost = stage_cost(fn, *args, **kwargs)
    except Exception as e:  # noqa: BLE001 — never kill the observed run
        cost = {"error": f"{type(e).__name__}: {e}"}
    cost = _shard_footprint(cost, shards)
    if compute_dtype is not None:
        cost = dict(cost, compute_dtype=str(compute_dtype))
    if rl is not None:
        rl.log("cost", stage=stage, counted_on="torch dispatch count",
               **cost)
    return cost


def record_stage_cost(stage: str, fn: Callable, *args: object,
                      defer: bool = False,
                      compute_dtype: Optional[str] = None,
                      shards=1, **kwargs: object) -> Optional[dict]:
    """Log the ``cost`` event of ``stage`` once per shape signature.

    A strict no-op unless a RunLog is active and collection is enabled.
    Failures are logged (a ``cost`` event with ``error``) and cached, never
    raised.  ``defer=True`` (call sites inside a timed span) queues the
    counted run for :func:`flush_pending`.  ``compute_dtype`` tags the
    event with the stage's policy dtype ("bf16"/"f32") for the report's
    choice of peak; it is not passed to ``fn``.  ``shards`` (an int or
    ``{axis: size}``, not passed to ``fn`` either) marks a sharded route's
    count of its single-device equivalent: the event adds the per-shard
    peak.  Returns the cost dict, or
    None (always None for a just-deferred signature)."""
    rl = active()
    if rl is None or not _enabled:
        return None
    sig = (stage, _signature(args, kwargs))
    with _lock:
        if sig in _cache:
            return _cache[sig]
        _cache[sig] = None               # claim: concurrent callers skip
        if defer:
            _pending.append((sig, stage, fn, args, kwargs, compute_dtype,
                             shards))
            return None
    cost = _compute_and_log(stage, fn, args, kwargs, compute_dtype, shards)
    with _lock:
        _cache[sig] = cost
    return cost


def flush_pending() -> int:
    """Run the deferred counts (outside any timed span: ``TrainObs`` calls
    it between episodes and at close).  Returns how many ran."""
    n = 0
    while True:
        with _lock:
            if not _pending:
                return n
            sig, stage, fn, args, kwargs, compute_dtype, shards = \
                _pending.pop(0)
        cost = _compute_and_log(stage, fn, args, kwargs, compute_dtype,
                                shards)
        with _lock:
            _cache[sig] = cost
        n += 1


def _power_limit() -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` prints it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_peak() -> Optional[dict]:
    """The published peak of the current CUDA card (``PEAK_FLOPS``) with
    its name and power limit, or None (no CUDA, another card)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available():
        return None
    kind = torch.cuda.get_device_name()
    for sub, peak in PEAK_FLOPS.items():
        if sub in kind:
            return {"platform": "gpu", "device_kind": kind,
                    "power_limit": _power_limit(), **peak}
    return None


def log_roofline_peak() -> Optional[dict]:
    """One ``roofline_peak`` event (the report's fraction-of-peak
    denominator) when the card has a known peak; None otherwise."""
    rl = active()
    if rl is None:
        return None
    peak = device_peak()
    if peak is not None:
        rl.log("roofline_peak", **peak)
    return peak
