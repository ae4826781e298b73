"""HostManager: spawn / monitor / reap fleet host processes.

The central process owns a listening socket; each spawned host (a
``multiprocessing`` *spawn*-context process -- fork would duplicate the
central's live threads and locks, and a CUDA context does not survive a
fork at all) connects back, sends ``hello`` with its peer-server port, and
from then on the connection carries the fleet's channel pair: central->host
is the dispatch channel, host->central the update channel (see
wire.SocketChannel).  Under spawn a host re-imports the parent's
``__main__`` as ``__mp_main__``, so a script that builds a fleet keeps its
top level free of side effects (``if __name__ == "__main__"``).

Each host is given the central's device and task-fn name; a host that
exits before its ``hello`` (no device, a task fn that does not import)
fails its spawn at once with the exit code, its traceback on its stderr.

Liveness: one receiver thread per host drains the update channel (updates,
completions, heartbeats); a SIGKILLed host's socket EOFs, which the
receiver turns into ``runtime._on_host_dead`` immediately.  A monitor
thread additionally sweeps for stale heartbeats and dead PIDs (a wedged
host whose socket stays open).  Both paths are idempotent -- the runtime
marks the handle dead under its own lock before requeueing, so the
receiver/monitor race resolves to exactly one ``executor_left`` pass.

Lock order: runtime._lock may be held when manager state is read
(`live_handles` inside the DRP driver's snapshot), so the manager NEVER
calls back into the runtime while holding its own lock.
"""
from __future__ import annotations

import multiprocessing
import os
import signal
import socket
import threading
import time
from typing import Any, Optional

from repro_torch.obs.metrics import ClusterView

from repro_torch.core.channel import ChannelClosed

from .host import host_main
from .wire import SocketChannel, _resolve_codec, recv_msg


class HostHandle:
    """Central-side view of one host process."""

    def __init__(self, host_id: str, proc, chan: SocketChannel,
                 peer_host: str, peer_port: int) -> None:
        self.host_id = host_id
        self.proc = proc
        self.chan = chan
        self.peer_host = peer_host
        self.peer_port = peer_port
        self.eids: list[str] = []        # executors spawned on this host
        self.last_hb = time.monotonic()
        self.dead = False                # set under runtime._lock
        self.frames_sent = 0             # wire frames down to this host
        self.msgs_sent = 0               # logical messages inside them
        self.frames_recv = 0             # frames up from this host (not hb)
        self.msgs_recv = 0

    def send(self, msg: Any) -> None:
        """Dispatch-channel send; a broken pipe is not an error here -- the
        receiver thread will surface the death through _on_host_dead."""

        try:
            self.chan.send(msg)
        except ChannelClosed:
            return
        self.frames_sent += 1
        self.msgs_sent += (len(msg["msgs"])
                           if isinstance(msg, dict) and msg.get("t") == "batch"
                           else 1)

    def send_batch(self, msgs: list, max_batch: int = 64) -> None:
        """Send many messages as bounded batch frames, preserving order.
        A chunk of one goes bare, so ``max_batch=1`` reproduces the
        one-frame-per-message wire exactly."""
        max_batch = max(int(max_batch), 1)
        for i in range(0, len(msgs), max_batch):
            chunk = msgs[i:i + max_batch]
            self.send(chunk[0] if len(chunk) == 1
                      else {"t": "batch", "msgs": chunk})


class HostManager:
    def __init__(self, rt, *, codec: str = "auto",
                 task_fn_name: Optional[str] = None,
                 hb_interval_s: float = 0.25,
                 hb_timeout_s: float = 3.0,
                 spawn_timeout_s: float = 60.0,
                 bind_host: str = "127.0.0.1",
                 wire_batch: int = 64,
                 local_dispatch: bool = False,
                 observe_capacity: int = 0,
                 metrics_interval_s: float = 0.0,
                 device: str = "cuda") -> None:
        self.rt = rt
        self.codec = _resolve_codec(codec)
        self.task_fn_name = task_fn_name
        self.hb_interval_s = hb_interval_s
        self.hb_timeout_s = hb_timeout_s
        self.spawn_timeout_s = spawn_timeout_s
        self.bind_host = bind_host
        self.wire_batch = wire_batch
        self.local_dispatch = local_dispatch
        # >0: spawned hosts record lifecycle events into a ring of this
        # capacity and forward them upstream (0 = recording off, free)
        self.observe_capacity = observe_capacity
        # >0: spawned hosts sample their own MetricsRegistry every this
        # many seconds and ship {"t": "stats"} frames; the cluster view
        # holds the latest snapshot per host (0 = telemetry off, free)
        self.metrics_interval_s = metrics_interval_s
        # every host runs on this device (the central resolved it)
        self.device = device
        self.cluster = ClusterView()
        self._ctx = multiprocessing.get_context("spawn")
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self.handles: dict[str, HostHandle] = {}
        self._pending: dict[str, dict] = {}   # host_id -> handshake slot
        self._next_host = 0
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((bind_host, 0))
        self.listener.listen(64)
        self.addr = self.listener.getsockname()
        threading.Thread(target=self._accept_loop, daemon=True,
                         name="fleet-accept").start()
        self._monitor = threading.Thread(target=self._monitor_loop,
                                         daemon=True, name="fleet-monitor")
        self._monitor.start()

    # ------------------------------------------------------------------
    def spawn_host(self) -> HostHandle:
        """Start one host process; blocks until its hello arrives."""
        return self.spawn_hosts(1)[0]

    def spawn_hosts(self, n: int) -> list[HostHandle]:
        """Start ``n`` host processes at once, then wait for every hello,
        in host order: each process's start-up (the interpreter, torch, the
        device) overlaps the others'.  If one fails, all ``n`` are
        stopped and the error raised."""
        if self._stop.is_set():
            raise RuntimeError("HostManager is shut down")
        started = []
        for _ in range(n):
            with self._lock:
                host_id = f"h{self._next_host}"
                self._next_host += 1
                slot = {"event": threading.Event(), "sock": None,
                        "hello": None}
                self._pending[host_id] = slot
            proc = self._ctx.Process(
                target=host_main,
                args=(self.addr[0], self.addr[1], host_id, self.codec,
                      self.task_fn_name, self.hb_interval_s, self.bind_host,
                      self.wire_batch, self.local_dispatch,
                      self.observe_capacity, self.metrics_interval_s,
                      self.device),
                daemon=True, name=f"fleet-{host_id}")
            proc.start()
            started.append((host_id, slot, proc))
        deadline = time.monotonic() + self.spawn_timeout_s
        try:
            for host_id, slot, proc in started:
                while not slot["event"].wait(0.05):
                    if proc.exitcode is not None:
                        raise RuntimeError(
                            f"host {host_id} exited with code "
                            f"{proc.exitcode} before connecting (its "
                            f"traceback is on its stderr)")
                    if time.monotonic() > deadline:
                        raise RuntimeError(
                            f"host {host_id} did not connect within "
                            f"{self.spawn_timeout_s}s")
        except Exception:
            for host_id, slot, proc in started:
                with self._lock:
                    self._pending.pop(host_id, None)
                if slot["sock"] is not None:
                    slot["sock"].close()
                if proc.is_alive():
                    proc.terminate()
                    proc.join(1.0)
            raise
        handles = []
        for host_id, slot, proc in started:
            hello = slot["hello"]
            handle = HostHandle(host_id, proc,
                                SocketChannel(slot["sock"], self.codec),
                                # the host advertises the address its peer
                                # server bound (multi-machine seam); older
                                # hellos without it mean shared-loopback
                                peer_host=hello.get("peer_host") or "127.0.0.1",
                                peer_port=int(hello["peer_port"]))
            with self._lock:
                self.handles[host_id] = handle
            threading.Thread(target=self._receive, args=(handle,),
                             daemon=True,
                             name=f"fleet-recv-{host_id}").start()
            handles.append(handle)
        return handles

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._handshake, args=(conn,),
                             daemon=True, name="fleet-handshake").start()

    def _handshake(self, conn: socket.socket) -> None:
        try:
            hello = recv_msg(conn, self.codec, timeout=self.spawn_timeout_s)
            conn.settimeout(None)
            if hello.get("t") != "hello":
                raise ValueError(f"expected hello, got {hello!r}")
            with self._lock:
                slot = self._pending.pop(hello["host_id"], None)
        except Exception:  # noqa: BLE001 - stray/late connection
            conn.close()
            return
        if slot is None:   # unknown host id: refuse
            conn.close()
            return
        slot["sock"], slot["hello"] = conn, hello
        slot["event"].set()

    # ------------------------------------------------------------------
    def _receive(self, handle: HostHandle) -> None:
        """Per-host update-channel consumer (the recv side of the pair).
        Processes messages in wire order, which is what guarantees a
        task's index updates are applied before its completion."""

        while True:
            try:
                msg = handle.chan.recv()
            except ChannelClosed:
                if not self._stop.is_set():
                    self.rt._on_host_dead(handle)
                return
            kind = msg["t"]
            handle.last_hb = time.monotonic()
            if kind == "hb":
                continue
            handle.frames_recv += 1
            if kind == "batch":
                # unwrap in list order: exactly equivalent to the messages
                # arriving as consecutive frames (ordering contract)
                inner = msg["msgs"]
                handle.msgs_recv += len(inner)
                self.rt._on_remote_batch(handle, inner)
            else:
                handle.msgs_recv += 1
                self.rt._on_remote_batch(handle, [msg])

    def _monitor_loop(self) -> None:
        period = max(self.hb_interval_s / 2, 0.05)
        while not self._stop.wait(period):
            now = time.monotonic()
            for handle in self.live_handles():
                if (not handle.proc.is_alive()
                        or now - handle.last_hb > self.hb_timeout_s):
                    self.rt._on_host_dead(handle)

    # ------------------------------------------------------------------
    def live_handles(self) -> list[HostHandle]:
        with self._lock:
            return [h for h in self.handles.values() if not h.dead]

    def broadcast(self, msg: Any) -> None:
        for h in self.live_handles():
            h.send(msg)

    def kill_host(self, host_id: str) -> int:
        """SIGKILL a host process (failure-injection surface for tests /
        benchmarks).  Returns the killed pid."""
        with self._lock:
            handle = self.handles[host_id]
        pid = handle.proc.pid
        os.kill(pid, signal.SIGKILL)
        return pid

    def reap(self, handle: HostHandle, graceful: bool = False) -> None:
        """Tear one host down.  Callers mark ``handle.dead`` (under the
        runtime lock) first; this only releases OS resources."""
        if graceful:
            handle.send({"t": "shutdown"})
        handle.chan.close()
        if handle.proc.is_alive():
            handle.proc.join(2.0 if graceful else 0.5)
            if handle.proc.is_alive():
                handle.proc.terminate()
                handle.proc.join(1.0)
        with self._lock:
            self.handles.pop(handle.host_id, None)
        self.cluster.drop(handle.host_id)

    def shutdown(self) -> None:
        self._stop.set()
        try:
            self.listener.close()
        except OSError:
            pass
        for handle in self.live_handles():
            # the dead flag's one-flip invariant lives under the RUNTIME
            # lock (see _on_host_dead): flipping it unlocked here would
            # let a mid-sweep monitor run a full requeue pass against the
            # tearing-down fleet
            with self.rt._lock:
                if handle.dead:
                    continue
                handle.dead = True
            self.reap(handle, graceful=True)
        # anything already marked dead but not yet reaped
        with self._lock:
            leftovers = list(self.handles.values())
        for handle in leftovers:
            self.reap(handle)
