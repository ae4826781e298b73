"""repro_torch.fleet: the multi-process distribution layer over the Channel
seams (counterpart of ``repro.fleet``), with every host on the card.

`DiffusionRuntime` keeps all scheduling in one process and talks to its
executors only through two Channels (task dispatch, index updates) --
`repro_torch.core.channel`.  This package swaps those channels for a
length-prefixed socket wire protocol (`wire`), runs executors as threads
inside spawned host processes (`host`, managed by `manager.HostManager`),
and exposes the result as `FleetRuntime`: same Dispatcher, same policies,
same byte ledger -- N GILs, real sockets between peer caches, and each
host's executor caches and task fns on ``device`` (default ``"cuda"``;
``device="cpu"`` runs the hosts on the CPU).

    rt = FleetRuntime(hosts=4, threads_per_host=2)
    rt.put_object(obj, payload)            # replicated to every host
    rt.submit(tasks); rt.wait()            # identical surface
    rt.manager.kill_host("h0")             # SIGKILL failure injection
    rt.shutdown()

The experiment layer binds it through ``ExperimentSpec(hosts=...,
threads_per_host=...)`` on the runtime engine.  The trace-replay parity
contract: fleet == single-process on every scheduling-determined RunReport
field (``reports_scheduling_equal``).
"""
from .host import TASK_FNS, register_task_fn, resolve_task_fn
from .manager import HostHandle, HostManager
from .runtime import (SCHEDULING_DETERMINED_FIELDS, FleetRuntime, fleet_task,
                      reports_scheduling_equal)
from .wire import (HAVE_MSGPACK, MAX_FRAME, PeerGone, SocketChannel,
                   WireError, decode, encode, recv_msg, send_msg)

__all__ = [
    "FleetRuntime",
    "HAVE_MSGPACK",
    "HostHandle",
    "HostManager",
    "MAX_FRAME",
    "PeerGone",
    "SCHEDULING_DETERMINED_FIELDS",
    "SocketChannel",
    "TASK_FNS",
    "WireError",
    "decode",
    "encode",
    "fleet_task",
    "recv_msg",
    "register_task_fn",
    "reports_scheduling_equal",
    "resolve_task_fn",
    "send_msg",
]
