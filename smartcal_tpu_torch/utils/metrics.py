"""JSONL metrics stream and profiler hook (counterpart of
smartcal_tpu/utils/metrics.py).

``JsonlLogger`` is the thin compatibility shim over
:class:`smartcal_tpu_torch.obs.RunLog`: headerless, one flushed line per
event, non-finite values written as null, ``None`` path disables.

:func:`profiler_trace` wraps a region in a ``torch.profiler`` session when
a directory is given and writes its Chrome trace there (the spans of
``obs.span`` appear in it as ``record_function`` ranges); no-op
otherwise.  :func:`start_trace` / :func:`stop_trace` are the same session
split in two, for a run handle that opens and closes it.
"""

import contextlib
import os
from typing import Optional

from smartcal_tpu_torch.obs import RunLog

TRACE_FILE = "trace.json"


class JsonlLogger:
    """Back-compat shim over :class:`RunLog`: headerless, flush per line,
    sanitized."""

    def __init__(self, path: Optional[str]):
        self._run = RunLog(path, header=False, flush_lines=1,
                           flush_interval=0.0)

    def log(self, event: str, **fields):
        self._run.log(event, **fields)

    def close(self):
        self._run.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def start_trace(trace_dir: str):
    """Start a ``torch.profiler`` session (CPU, and CUDA when a card is
    visible) that :func:`stop_trace` writes under ``trace_dir``."""
    import torch

    os.makedirs(trace_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def stop_trace(prof, trace_dir: str, name: str = TRACE_FILE) -> str:
    """Stop a :func:`start_trace` session and write its Chrome trace as
    ``trace_dir/name``; returns the path."""
    prof.stop()
    path = os.path.join(trace_dir, name)
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def profiler_trace(trace_dir: Optional[str]):
    """A ``torch.profiler`` session over the region, its Chrome trace
    written as ``trace_dir/trace.json``, when ``trace_dir`` is set; no-op
    otherwise."""
    if not trace_dir:
        yield None
        return
    prof = start_trace(trace_dir)
    try:
        yield prof
    finally:
        stop_trace(prof, trace_dir)
