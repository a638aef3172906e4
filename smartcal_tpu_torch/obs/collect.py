"""Fleet timeline collection: merge per-process JSONL trees into one run
(the port's copy of smartcal_tpu/obs/collect.py, same semantics).

A fleet run writes one RunLog stream per process — the router's own
stream plus ``replica<rid>-g<attempt>.jsonl`` per replica generation,
each possibly rotated into ``.1``/``.2`` segments — and each process
stamps events with ITS wall clock.  This module reassembles the run:

* :func:`discover_streams` groups a directory's segments per stream
  (rotation-aware, black-box dumps excluded);
* :class:`TimelineMerger` loads streams, reads the ``clock_offset``
  events the router's pump emitted (min over IPC frames of
  ``recv_wall - send_wall`` — the handshake in serve/fleet.py), applies
  each peer's offset to its stream, and merges everything into one
  time-ordered, process-tagged event list;
* :func:`assemble_traces` groups the merged stream by ``trace`` id;
* :func:`request_paths` reconstructs each request's cross-process
  chain — ``fleet_dispatch`` (router) -> ``serve_admit`` (replica) ->
  ``serve_request`` (replica) -> ``fleet_result`` (router) — and joins
  the replica's per-batch stage spans (``serve_pack`` .. ``serve_sigma``
  share one batch across member requests, so they are keyed by
  ``(process, batch)``, not by trace) into a per-request critical-path
  record: queue wait vs IPC vs pack vs policy vs solve vs influence;
* :func:`completeness` scores the run: the fraction of COMPLETED
  requests whose full span tree reconstructed (the >=99% acceptance
  bar of the tracing work).

Stdlib only, by the obs-package rule: importing this can never
initialize an accelerator backend (and the collector runs on a host
with no accelerator at all).
"""

from __future__ import annotations

import json
import os
import re
import threading
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

# span name -> critical-path column (serve/server.py batch stages)
STAGE_COLUMNS: Dict[str, str] = {
    "serve_pack": "pack_s",
    "serve_policy": "policy_s",
    "serve_solve": "solve_s",
    "serve_influence": "influence_s",
    "serve_sigma": "sigma_s",
}

_SEGMENT_RE = re.compile(r"^(?P<base>.+\.jsonl)(?:\.(?P<n>\d+))?$")


def discover_streams(directory: str) -> Dict[str, List[str]]:
    """Map stream name (base filename) -> ordered segment paths.

    Rotated segments (``<base>.jsonl.1`` .. ``.N``) come before the
    live ``<base>.jsonl`` tail, matching write order.  Flight-recorder
    dumps (``blackbox_*``) are a different artifact class and are
    excluded."""
    streams: Dict[str, List[Tuple[int, str]]] = {}
    try:
        names = sorted(os.listdir(directory))
    except OSError:
        return {}
    for name in names:
        if name.startswith("blackbox_"):
            continue
        m = _SEGMENT_RE.match(name)
        if m is None:
            continue
        seq = int(m.group("n")) if m.group("n") else 10 ** 9
        streams.setdefault(m.group("base"), []).append(
            (seq, os.path.join(directory, name)))
    return {base: [p for (_, p) in sorted(segs)]
            for base, segs in sorted(streams.items())}


def read_stream(paths: Sequence[str]) -> Tuple[str, List[Dict[str, Any]],
                                               int]:
    """Load one stream's segments in order; returns ``(proc, events,
    n_corrupt)``.  ``proc`` comes from the first ``run_header``'s
    run_id (the fleet names replica streams ``replica<rid>``), falling
    back to the first segment's filename stem.  Corrupt lines — a
    crashed writer's torn tail — are counted, never fatal."""
    events: List[Dict[str, Any]] = []
    proc: Optional[str] = None
    n_corrupt = 0
    for path in paths:
        try:
            fh = open(path, "r")
        except OSError:
            n_corrupt += 1
            continue
        with fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    n_corrupt += 1
                    continue
                if not isinstance(rec, dict):
                    n_corrupt += 1
                    continue
                if proc is None and rec.get("event") == "run_header":
                    rid = rec.get("run_id")
                    if isinstance(rid, str) and rid:
                        proc = rid
                events.append(rec)
    if proc is None:
        stem = os.path.basename(paths[0]) if paths else "stream"
        proc = stem.split(".jsonl")[0]
    return proc, events, n_corrupt


class TimelineMerger:
    """Accumulates per-process streams and merges them onto one clock.

    Thread-safe: a live tailer may ``add_stream`` from a reader thread
    while a reporter calls ``merge``/``stats`` — all shared merge state
    (streams, offsets, corrupt counter) mutates under ``_lock``."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._streams: Dict[str, List[Dict[str, Any]]] = {}
        self._offsets: Dict[str, float] = {}
        self._n_corrupt = 0

    def add_stream(self, proc: str,
                   events: Iterable[Dict[str, Any]],
                   n_corrupt: int = 0) -> None:
        """Add (or extend) one process's event stream.  Any
        ``clock_offset`` events in it update the peer offset table —
        each logged value is the sender's running minimum-delay
        estimate, so the last one per peer wins."""
        evs = list(events)
        with self._lock:
            self._streams.setdefault(proc, []).extend(evs)
            self._n_corrupt += int(n_corrupt)
            for rec in evs:
                if rec.get("event") != "clock_offset":
                    continue
                peer = rec.get("peer")
                off = rec.get("offset_s")
                if isinstance(peer, str) and isinstance(off, (int, float)):
                    self._offsets[peer] = float(off)

    def add_directory(self, directory: str) -> None:
        """Discover and load every stream under ``directory``."""
        for _base, paths in discover_streams(directory).items():
            proc, events, bad = read_stream(paths)
            self.add_stream(proc, events, bad)

    def offsets(self) -> Dict[str, float]:
        """Peer process -> seconds to ADD to its wall timestamps to
        land on the router's clock."""
        with self._lock:
            return dict(self._offsets)

    def procs(self) -> List[str]:
        with self._lock:
            return sorted(self._streams)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"procs": len(self._streams),
                    "events": sum(len(v) for v in self._streams.values()),
                    "offsets": dict(self._offsets),
                    "corrupt_lines": self._n_corrupt}

    def merge(self) -> List[Dict[str, Any]]:
        """One time-ordered event list for the whole run.  Every event
        gains ``proc`` (its stream) and ``t_corr`` (its wall time
        shifted by the stream's clock offset, if any); within one
        stream the original write order breaks timestamp ties."""
        with self._lock:
            streams = {p: list(evs) for p, evs in self._streams.items()}
            offsets = dict(self._offsets)
        tagged: List[Tuple[float, str, int, Dict[str, Any]]] = []
        for proc, evs in streams.items():
            off = offsets.get(proc, 0.0)
            for i, rec in enumerate(evs):
                t = rec.get("t")
                base = float(t) if isinstance(t, (int, float)) else 0.0
                out = dict(rec)
                out["proc"] = proc
                out["t_corr"] = round(base + off, 6)
                tagged.append((out["t_corr"], proc, i, out))
        tagged.sort(key=lambda item: (item[0], item[1], item[2]))
        return [rec for (_, _, _, rec) in tagged]


def merge_directory(directory: str) -> List[Dict[str, Any]]:
    """Convenience: discover + load + merge one fleet run directory."""
    m = TimelineMerger()
    m.add_directory(directory)
    return m.merge()


def assemble_traces(events: Iterable[Dict[str, Any]]
                    ) -> Dict[str, List[Dict[str, Any]]]:
    """Group a merged stream by ``trace`` id (events without a trace
    field — gauges, beats, headers — are not request-scoped and are
    skipped)."""
    out: Dict[str, List[Dict[str, Any]]] = {}
    for rec in events:
        tid = rec.get("trace")
        if isinstance(tid, str) and tid:
            out.setdefault(tid, []).append(rec)
    return out


def _stage_spans(events: Iterable[Dict[str, Any]]
                 ) -> Dict[Tuple[str, int], Dict[str, float]]:
    """(proc, batch) -> {stage column: dur_s} for the batch stage
    spans.  One batch serves several requests, so stage spans join to
    member requests by batch id, never by trace id."""
    out: Dict[Tuple[str, int], Dict[str, float]] = {}
    for rec in events:
        if rec.get("event") != "span":
            continue
        col = STAGE_COLUMNS.get(str(rec.get("name")))
        batch = rec.get("batch")
        if col is None or not isinstance(batch, int):
            continue
        dur = rec.get("dur_s")
        if isinstance(dur, (int, float)):
            key = (str(rec.get("proc", "")), batch)
            out.setdefault(key, {})[col] = float(dur)
    return out


def request_paths(events: Sequence[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """Reconstruct each request's cross-process critical path from a
    MERGED stream (``merge()`` output: proc-tagged, skew-corrected).

    Per trace: the router's ``fleet_dispatch``, the replica's
    ``serve_admit`` + ``serve_request``, the router's ``fleet_result``,
    and the (proc, batch)-joined stage durations.  A requeued job keeps
    its original trace id, so its record uses the LAST admit/serve pair
    (the one that actually served) and carries the requeue count."""
    spans = _stage_spans(events)
    paths: List[Dict[str, Any]] = []
    for tid, evs in assemble_traces(events).items():
        dispatches = [e for e in evs if e.get("event") == "fleet_dispatch"]
        admits = [e for e in evs if e.get("event") == "serve_admit"]
        serves = [e for e in evs if e.get("event") == "serve_request"]
        results = [e for e in evs if e.get("event") == "fleet_result"]
        if not dispatches:
            continue
        first_d = dispatches[0]
        admit = admits[-1] if admits else None
        serve = serves[-1] if serves else None
        rec: Dict[str, Any] = {
            "trace": tid,
            "job_id": first_d.get("job_id"),
            "replica": (admit or {}).get("replica"),
            "proc": (serve or admit or {}).get("proc"),
            "t_dispatch": first_d.get("t_corr"),
            "requeues": max(
                [int(e.get("requeues") or 0) for e in admits] or [0]),
            "requeued": any(e.get("requeue") for e in dispatches),
            "dispatches": len(dispatches),
            "completed": bool(results),
        }
        if admit is not None:
            ipc = (float(admit["t_corr"])
                   - float(dispatches[-1]["t_corr"]))
            rec["ipc_s"] = round(max(0.0, ipc), 6)
        if serve is not None:
            for k_src, k_dst in (("queue_wait_s", "queue_s"),
                                 ("service_s", "service_s"),
                                 ("total_s", "total_s")):
                v = serve.get(k_src)
                if isinstance(v, (int, float)):
                    rec[k_dst] = float(v)
            batch = serve.get("batch")
            if isinstance(batch, int):
                rec["batch"] = batch
                rec.update(spans.get((str(serve.get("proc", "")), batch),
                                     {}))
        rec["complete"] = bool(admits and serves)
        paths.append(rec)
    paths.sort(key=lambda r: (r.get("t_dispatch") or 0.0))
    return paths


def completeness(paths: Sequence[Dict[str, Any]],
                 require_stages: bool = False) -> Dict[str, Any]:
    """Score a run's trace reconstruction: among COMPLETED requests
    (those whose router saw a result), what fraction rebuilt the full
    cross-process chain?  ``require_stages`` additionally demands at
    least the solve-stage span joined in (real-CalibServer fleets; the
    sleep-stub's minimal instrumentation has solve only)."""
    done = [p for p in paths if p.get("completed")]
    ok = [p for p in done
          if p.get("complete")
          and (not require_stages or "solve_s" in p)]
    return {"n_requests": len(paths),
            "n_completed": len(done),
            "n_complete_trees": len(ok),
            "fraction": round(len(ok) / len(done), 6) if done else 0.0}
