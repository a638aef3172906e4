"""Multi-process runs (counterpart of smartcal_tpu/parallel/multihost.py).

The JAX package brings hosts together with ``jax.distributed.initialize``;
the port brings processes together with ``torch.distributed``.  Every
process of a job calls :func:`initialize` with the same coordinator
address and process count and its own process id (the arguments, else the
``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` / ``JAX_PROCESS_ID``
variables the JAX package reads); one process is a no-op.  From then on a
mesh laid over :func:`~smartcal_tpu_torch.parallel.mesh.default_devices`
has one position per process (rank), and the collectives of
``ops/collectives.py`` run between the processes.

The ranks first meet at a ``TCPStore`` on the coordinator's address, where
each publishes its host name and CUDA device count; from that every rank
derives the same choice:

* each rank's device: ``cuda:(local rank mod device count)``, the local
  rank its place among the ranks of its host, or the CPU when the caller
  asks for it;
* the backend: ``nccl`` only when the ranks' devices are CUDA devices and
  no two ranks share one; ranks that share a GPU (every rank on one card)
  and ranks on the CPU take ``gloo``.  The choice is printed, and nothing
  is retried under another backend.

``torch.distributed.init_process_group`` then runs on that store with the
job's timeout, which bounds every collective's wait.

:func:`launch` starts a job of ``nprocs`` ranks on this host with the
``spawn`` start method (CUDA forbids ``fork``), each rank with one intra-op
thread on the CPU, and raises if any rank fails.

The simulated multi-host rehearsal of the process fleet is ported as is:
each spawned actor records its ``(host_id, n_hosts)`` in
``SMARTCAL_SIM_HOST`` and nothing is initialised.
"""

import datetime
import os
import socket
import sys
from typing import Optional

SIM_HOST_ENV = "SMARTCAL_SIM_HOST"

#: seconds a collective (and the ranks' meeting) waits before it raises
TIMEOUT_S = 900.0

_state = {}


def _config(coordinator, num_processes, process_id):
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    return coordinator, num_processes, process_id


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout: float = TIMEOUT_S) -> bool:
    """Bring up ``torch.distributed`` when more than one process is
    configured; returns True then, False for a one-process run (no
    configuration, or ``num_processes`` 1).  ``coordinator`` is
    ``host:port`` (rank 0 listens there), ``device`` "cpu" puts this rank on
    the CPU (default: a CUDA device, as every entry point of the port), and
    ``timeout`` bounds each collective's wait.  A second call is a no-op
    that returns True."""
    import torch
    import torch.distributed as dist

    if _state:
        return True
    coordinator, num_processes, process_id = _config(
        coordinator, num_processes, process_id)
    if num_processes is None or int(num_processes) <= 1:
        return False
    if coordinator is None or process_id is None:
        raise ValueError(
            f"a {num_processes}-process run needs the coordinator address "
            f"(got {coordinator!r}) and this process's id (got "
            f"{process_id!r}) on every process")
    n, rank = int(num_processes), int(process_id)
    if not 0 <= rank < n:
        raise ValueError(f"process_id {rank} is not in [0, {n})")
    host, port = coordinator.rsplit(":", 1)
    wait = datetime.timedelta(seconds=float(timeout))
    store = dist.TCPStore(host, int(port), n, is_master=rank == 0,
                          timeout=wait)
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise RuntimeError(
            "smartcal_tpu_torch: CUDA device requested but no GPU is "
            "available; pass device='cpu' explicitly to run on the CPU")
    n_cuda = 0 if on_cpu else torch.cuda.device_count()
    store.set(f"smartcal/rank/{rank}", f"{socket.gethostname()}|{n_cuda}")
    peers = [store.get(f"smartcal/rank/{r}").decode().rsplit("|", 1)
             for r in range(n)]
    hosts = [h for h, _ in peers]
    local = [sum(h == hosts[r] for h in hosts[:r]) for r in range(n)]
    counts = [int(c) for _, c in peers]
    if any(c == 0 for c in counts) and any(counts):
        raise RuntimeError(
            f"ranks {[r for r in range(n) if counts[r] == 0]} run on the "
            f"CPU and ranks {[r for r in range(n) if counts[r]]} on GPUs; "
            "every rank of a job takes the same device kind")
    if not any(counts):
        devices = ["cpu"] * n
        backend, why = "gloo", "ranks on the CPU"
    else:
        devices = [f"cuda:{local[r] % counts[r]}" for r in range(n)]
        shared = len(set(zip(hosts, devices))) < n
        backend = "gloo" if shared else "nccl"
        why = ("ranks share a GPU" if shared
               else "every rank owns a different GPU")
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    print(f"multihost: rank {rank}/{n} on {dev} ({hosts[rank]}), backend "
          f"{backend}: {why}", file=sys.stderr, flush=True)
    dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                            timeout=wait)
    _state.update(rank=rank, size=n, device=dev, backend=backend,
                  devices=[torch.device(d) for d in devices],
                  timeout=float(timeout))
    return True


def shutdown() -> None:
    """Leave the job (``destroy_process_group``); the process is a
    one-process run again.  A no-op when nothing was initialised."""
    if not _state:
        return
    import torch.distributed as dist

    from smartcal_tpu_torch.ops import collectives

    collectives.forget_groups()
    _state.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def is_initialized() -> bool:
    """True inside a job of more than one process."""
    return bool(_state)


def process_index() -> int:
    return _state.get("rank", 0)


def process_count() -> int:
    return _state.get("size", 1)


def backend() -> Optional[str]:
    """The job's ``torch.distributed`` backend (None outside a job)."""
    return _state.get("backend")


def timeout() -> float:
    return _state.get("timeout", TIMEOUT_S)


def local_device():
    """This rank's device (None outside a job)."""
    return _state.get("device")


def global_devices() -> list:
    """Every rank's device, by rank (empty outside a job)."""
    return list(_state.get("devices", []))


def rank_path(path: str) -> str:
    """``path`` with this rank's suffix in a job of several processes
    (``run.jsonl`` -> ``run.rank1.jsonl``, ``ckpt`` -> ``ckpt.rank1``), so
    two ranks never write one file; ``path`` itself otherwise."""
    if not _state or not path:
        return path
    root, ext = os.path.splitext(path.rstrip(os.sep))
    return f"{root}.rank{_state['rank']}{ext}"


def simulated_host_env(host_id: int, n_hosts: int) -> dict:
    """The environment form of a simulated host assignment."""
    return {SIM_HOST_ENV: f"{int(host_id)}/{int(n_hosts)}"}


def attach_simulated(host_id: Optional[int] = None,
                     n_hosts: Optional[int] = None) -> dict:
    """Attach this process to the simulated multi-host runtime: record
    ``(host_id, n_hosts)`` (or the inherited ``SMARTCAL_SIM_HOST``) in the
    environment and return a summary.  Nothing is initialised: there is
    one real host."""
    if host_id is None:
        raw = os.environ.get(SIM_HOST_ENV, "").strip()
        if raw:
            try:
                host_id, n_hosts = (int(x) for x in raw.split("/", 1))
            except ValueError:
                host_id = None
    if host_id is None:
        return {"simulated": False, "host_id": 0, "n_hosts": 1}
    n_hosts = int(n_hosts or 1)
    host_id = int(host_id)
    os.environ.update(simulated_host_env(host_id, n_hosts))
    return {"simulated": n_hosts > 1, "host_id": host_id,
            "n_hosts": n_hosts}


def simulated_summary() -> dict:
    return attach_simulated()


def add_cli_args(parser) -> None:
    """The multi-process flags of the parallel CLIs (the reference's
    --master_addr/--world_size/--rank): every process passes the same
    ``--coordinator`` and ``--num_processes`` and its own
    ``--process_id``."""
    parser.add_argument("--coordinator", default=None,
                        help="coordinator host:port (all processes pass the "
                             "same value; process 0 listens there)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="total participating processes")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank in [0, num_processes)")


def initialize_from_args(args) -> bool:
    """:func:`initialize` from the CLI flags, on the device of
    ``args.device`` when the CLI has one."""
    return initialize(coordinator=getattr(args, "coordinator", None),
                      num_processes=getattr(args, "num_processes", None),
                      process_id=getattr(args, "process_id", None),
                      device=getattr(args, "device", None))


def runtime_summary() -> dict:
    """One-line view of the process's place in the job: its rank, the
    number of ranks, its devices (one per rank), every rank's, and the
    platform."""
    import torch

    if _state:
        dev = _state["device"]
        return {"process_index": _state["rank"],
                "process_count": _state["size"], "local_devices": 1,
                "global_devices": _state["size"],
                "platform": "gpu" if dev.type == "cuda" else "cpu",
                "backend": _state["backend"], "device": str(dev)}
    cuda = torch.cuda.is_available()
    n = torch.cuda.device_count() if cuda else 1
    return {"process_index": 0, "process_count": 1, "local_devices": n,
            "global_devices": n, "platform": "gpu" if cuda else "cpu"}


def free_port() -> int:
    """A TCP port free on this host now (for a job's coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, nprocs, coordinator, device, timeout, args):
    import torch

    torch.set_num_threads(1)
    initialize(coordinator, nprocs, rank, device=device, timeout=timeout)
    try:
        fn(rank, *args)
    finally:
        shutdown()


def launch(fn, nprocs: int, args=(), device=None,
           timeout: float = TIMEOUT_S, join_timeout=None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` spawned processes that form one
    job over ``127.0.0.1`` (``device`` as in :func:`initialize`).  ``fn``
    must be importable by name; results travel through files.  Raises when
    a rank raises or dies (the others are then stopped), or when the job
    outlives ``join_timeout`` seconds."""
    import time

    import torch.multiprocessing as mp

    coordinator = f"127.0.0.1:{free_port()}"
    ctx = mp.start_processes(
        _rank_main, args=(fn, nprocs, coordinator, device, timeout,
                          tuple(args)),
        nprocs=nprocs, join=False, start_method="spawn")
    t0 = time.monotonic()
    try:
        while not ctx.join(timeout=1.0):
            if join_timeout is not None and \
                    time.monotonic() - t0 > join_timeout:
                raise TimeoutError(f"{nprocs}-rank job still running after "
                                   f"{join_timeout:g} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(5)
            if p.is_alive():
                p.kill()
                p.join()
