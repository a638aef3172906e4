"""The port's process fleet: its IPC frames against the JAX package's, and
a two-worker process fleet on the CPU.

* ``runtime/ipc`` frames are byte for byte the JAX package's for the same
  numpy payload (plain and traced), and each package unframes the other's;
* a corrupt frame (truncated header, truncated body, bad magic, flipped
  byte, non-pickle body) raises ``CorruptPayloadError``;
* two spawned workers (``worker_spec["device"] = "cpu"``) echo, their
  results are collected, a published snapshot reaches them, a killed
  worker is restarted by ``Fleet.poll`` and ``stop`` joins every worker.

The fleet waits on conditions with generous deadlines (the first result
waits out a worker's interpreter start), never on short wall-clock loops.
The factory is ``tests/fleet_proc_worker.py``'s stdlib-only echo.
"""

import time
import zlib

import numpy as np
import pytest

from smartcal_tpu.runtime import ipc as jipc
from smartcal_tpu_torch.parallel import multihost
from smartcal_tpu_torch.runtime import (BackoffPolicy, Fleet, clear_faults,
                                        ipc)
from smartcal_tpu_torch.runtime import supervisor as sup
from smartcal_tpu_torch.runtime.atomic import CorruptStateError

ECHO = {"factory": "fleet_proc_worker:make_echo", "kwargs": {"scale": 3},
        "device": "cpu"}
DEADLINE_S = 180.0


@pytest.fixture(autouse=True)
def cleanup():
    yield
    clear_faults()


def payload():
    rng = np.random.default_rng(0)
    return ("result", 3, 7, {"state": rng.standard_normal((4, 5)).astype(
        np.float32), "reward": np.arange(4, dtype=np.float32),
        "done": np.zeros(4, bool), "tag": "x"})


def test_frames_byte_equal_to_jax():
    obj = payload()
    assert ipc.frame_payload(obj) == jipc.frame_payload(obj)
    trace = {"trace": "abc", "span": "s1", "t": 1.5}
    assert ipc.frame_payload(obj, trace=trace) == \
        jipc.frame_payload(obj, trace=trace)
    assert ipc.MAGIC == jipc.MAGIC and ipc.TRACED_MAGIC == jipc.TRACED_MAGIC


def test_each_package_unframes_the_other():
    obj = payload()
    for blob, unframe in ((jipc.frame_payload(obj), ipc.unframe_payload),
                          (ipc.frame_payload(obj), jipc.unframe_payload)):
        got = unframe(blob)
        assert got[:3] == obj[:3]
        for k, v in obj[3].items():
            np.testing.assert_array_equal(got[3][k], v)
    got, tr = ipc.unframe_payload_traced(jipc.frame_payload(
        obj, trace={"trace": "t1"}))
    assert tr == {"trace": "t1"} and got[1] == 3


def test_corrupt_frames_raise():
    blob = ipc.frame_payload(payload())
    assert issubclass(ipc.CorruptPayloadError, CorruptStateError)
    with pytest.raises(ipc.CorruptPayloadError, match="truncated"):
        ipc.unframe_payload(blob[:6])
    with pytest.raises(ipc.CorruptPayloadError, match="length mismatch"):
        ipc.unframe_payload(blob[:-3])
    with pytest.raises(ipc.CorruptPayloadError, match="bad magic"):
        ipc.unframe_payload(b"XXXX" + blob[4:])
    flipped = bytearray(blob)
    flipped[-1] ^= 0xFF
    with pytest.raises(ipc.CorruptPayloadError, match="CRC"):
        ipc.unframe_payload(bytes(flipped))
    body = b"not a pickle at all"
    bad = ipc._HEADER.pack(ipc.MAGIC, len(body), zlib.crc32(body)) + body
    with pytest.raises(ipc.CorruptPayloadError, match="unpicklable"):
        ipc.unframe_payload(bad)
    traced = bytearray(ipc.frame_payload(payload(), trace={"trace": "t9"}))
    traced[-1] ^= 0xFF
    with pytest.raises(ipc.CorruptPayloadError) as e:
        ipc.unframe_payload(bytes(traced))
    assert e.value.trace == {"trace": "t9"}


def test_to_host_never_ships_tensors():
    import torch

    w = {"a": torch.ones(2), "b": [torch.zeros(1)], "c": 3}
    h = sup._to_host(w)
    assert isinstance(h["a"], np.ndarray) and isinstance(h["b"][0],
                                                         np.ndarray)
    assert h["c"] == 3


def test_multihost_is_one_process(monkeypatch):
    for v in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        monkeypatch.delenv(v, raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False
    # more than one process is a multi-process job now
    # (tests/test_torch_multihost.py); without this process's id it raises
    with pytest.raises(ValueError, match="process's id"):
        multihost.initialize("localhost:1234", 2)
    assert multihost.attach_simulated(1, 2) == {
        "simulated": True, "host_id": 1, "n_hosts": 2}


def wait_for(cond, fleet, what):
    """Poll the fleet until ``cond()`` holds; fail after DEADLINE_S."""
    deadline = time.monotonic() + DEADLINE_S
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        fleet.poll()
        time.sleep(0.05)


def test_process_fleet_echo_publish_restart_stop():
    fleet = Fleet(2, None, name="echo", actor_mode="process",
                  worker_spec=ECHO, hosts=2, heartbeat_timeout=DEADLINE_S,
                  backoff=BackoffPolicy(base_s=0.01, factor=2.0, max_s=0.05,
                                        jitter=0.0))
    got = []
    try:
        fleet.start({"w": 2})
        wait_for(lambda: got.extend(fleet.collect(4, timeout=0.5)) or
                 {g[0] for g in got} == {0, 1}, fleet, "both workers")
        assert all(g[3]["scaled"] == 6 and g[2] == 1 for g in got)
        assert {g[3]["sim_host"] for g in got} == {"0/2", "1/2"}
        # a new snapshot reaches every worker
        fleet.set_weights({"w": 5})
        seen = set()

        def published():
            for g in fleet.collect(4, timeout=0.5):
                if g[3]["w"] == 5:
                    assert g[3]["scaled"] == 15 and g[2] == 2
                    seen.add(g[0])
            return seen == {0, 1}

        wait_for(published, fleet, "the published weights")
        # kill worker 1: poll notices, restarts it after the backoff (the
        # ingest queues are drained meanwhile: a full queue holds its pump)
        victim = fleet._actors[1].proc
        victim.kill()
        wait_for(lambda: fleet.collect(4, timeout=0.1) is not None
                 and fleet.restarts_total() >= 1
                 and fleet._actors[1].proc is not victim
                 and fleet._actors[1].is_alive(), fleet, "the restart")
        seen.clear()

        def restarted_echoes():
            seen.update(g[0] for g in fleet.collect(4, timeout=0.5)
                        if g[0] == 1)
            return seen == {1}

        wait_for(restarted_echoes, fleet, "the restarted worker's result")
    finally:
        joined = fleet.stop(join=True, timeout=60.0)
    assert joined == 2
    assert all(not a.is_alive() for a in fleet._actors.values())
    assert all(not a.proc.is_alive() for a in fleet._actors.values())
