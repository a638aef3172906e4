"""Multi-host edge of the port (counterpart of
smartcal_tpu/parallel/multihost.py).

The JAX package brings hosts together with ``jax.distributed.initialize``.
The port runs one process, its meshes over the local GPUs
(``parallel/mesh.py``); a multi-process route (a ``torch.distributed``
form of ``ops/collectives.py``) is not part of it yet, so
:func:`initialize` asked for more than one process raises instead of
running as one process without saying so.  The simulated
multi-host rehearsal of the process fleet is ported as is: each spawned
actor records its ``(host_id, n_hosts)`` in ``SMARTCAL_SIM_HOST``.

Standard library only.
"""

import os
from typing import Optional

SIM_HOST_ENV = "SMARTCAL_SIM_HOST"


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Returns False for a one-process run (no configuration, or
    ``num_processes`` 1); raises ``NotImplementedError`` when more than one
    process is configured by argument or by ``JAX_COORDINATOR_ADDRESS`` /
    ``JAX_NUM_PROCESSES`` (the variables the JAX package reads)."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and os.environ.get("JAX_NUM_PROCESSES"):
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and os.environ.get("JAX_PROCESS_ID"):
        process_id = int(os.environ["JAX_PROCESS_ID"])
    if num_processes is None or int(num_processes) <= 1:
        if coordinator is None or num_processes is not None:
            return False
    raise NotImplementedError(
        f"multi-process runs (coordinator={coordinator!r}, "
        f"num_processes={num_processes!r}, process_id={process_id!r}) are "
        "not part of the port: it runs one process on one GPU.  Use the "
        "simulated hosts of the process fleet (--sim-hosts) to rehearse "
        "the topology")


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
    """The multi-host flags of the parallel CLIs (the reference's
    --master_addr/--world_size/--rank); more than one process raises."""
    parser.add_argument("--coordinator", default=None,
                        help="coordinator host:port (multi-process runs "
                             "are not part of the port: raises)")
    parser.add_argument("--num_processes", type=int, default=None,
                        help="participating processes (1 only)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this process's rank (0 only)")


def initialize_from_args(args) -> bool:
    return initialize(coordinator=getattr(args, "coordinator", None),
                      num_processes=getattr(args, "num_processes", None),
                      process_id=getattr(args, "process_id", None))


def runtime_summary() -> dict:
    """One-line view of the process's place in the job."""
    import torch

    cuda = torch.cuda.is_available()
    return {"process_index": 0, "process_count": 1,
            "local_devices": torch.cuda.device_count() if cuda else 1,
            "platform": "gpu" if cuda else "cpu"}
