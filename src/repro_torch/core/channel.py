"""The Channel abstraction: the two RPC seams of the threaded runtime.

`DiffusionRuntime` keeps every scheduling decision (placement, hints,
retries, membership) in one authoritative `Dispatcher`/`LocationIndex`
stack; executors only ever talk to it through two message streams:

  dispatch channel   dispatcher -> executor: `Dispatch` records (task +
                     location hints).  One channel per executor; messages
                     for one executor are totally ordered.
  update channel     executor -> dispatcher: `IndexUpdate` records (cache
                     admissions/evictions) and attempt completions.  Updates
                     for one attempt are sent *before* its completion, so a
                     consumer that processes the stream in order sees a
                     task's cache effects no later than its completion.

Everything else the runtime does is shared-nothing, which makes these two
seams exactly the cut points where the single-process runtime becomes a
multi-process fleet (`repro_torch.fleet`): swap the queue-backed channels
below for socket-backed ones and the same dispatcher drives executors in
other OS processes without a single scheduling-logic change.

In-process implementations:

  `LocalChannel`     a `queue.Queue` with the Channel interface -- the
                     per-worker dispatch inbox.
  `CallbackChannel`  a synchronous send-side-only channel: `send` invokes
                     the consumer inline (the dispatcher applying an index
                     update under its own lock).  This is what "the update
                     seam, in process" degenerates to; the fleet replaces
                     it with a socket and a receiver thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Optional


class ChannelClosed(Exception):
    """recv() on a channel whose peer is gone / send() after close()."""


class Channel:
    """One-directional ordered message stream (see module docstring)."""

    def send(self, msg: Any) -> None:
        raise NotImplementedError

    def recv(self, timeout: Optional[float] = None) -> Any:
        raise NotImplementedError

    def close(self) -> None:
        raise NotImplementedError


#: sentinel a closing LocalChannel enqueues so a blocked recv() wakes up
_CLOSED = object()


class LocalChannel(Channel):
    """In-process Channel over a `queue.Queue` (the worker dispatch inbox)."""

    def __init__(self) -> None:
        self._q: "queue.Queue[Any]" = queue.Queue()
        self._closed = threading.Event()

    def send(self, msg: Any) -> None:
        if self._closed.is_set():
            raise ChannelClosed("send on closed LocalChannel")
        self._q.put(msg)

    def recv(self, timeout: Optional[float] = None) -> Any:
        try:
            msg = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("LocalChannel.recv timed out") from None
        if msg is _CLOSED:
            # wake any other blocked reader, then report closure
            self._q.put(_CLOSED)
            raise ChannelClosed("LocalChannel closed")
        return msg

    def close(self) -> None:
        if not self._closed.is_set():
            self._closed.set()
            self._q.put(_CLOSED)

    def empty(self) -> bool:
        """Best-effort emptiness probe (racy by nature -- callers use it
        as an idleness *hint*, never as a correctness gate)."""
        return self._q.empty()


class CallbackChannel(Channel):
    """Send-only synchronous channel: `send(msg)` runs the handler inline.

    The in-process form of the update seam -- an executor thread "sending"
    an index update simply calls into the dispatcher (which serialises
    under its own lock).  `recv` is meaningless here by construction: the
    consumer IS the handler.
    """

    def __init__(self, handler: Callable[[Any], None]) -> None:
        self._handler = handler
        self._closed = False

    def send(self, msg: Any) -> None:
        if self._closed:
            raise ChannelClosed("send on closed CallbackChannel")
        self._handler(msg)

    def recv(self, timeout: Optional[float] = None) -> Any:
        raise ChannelClosed("CallbackChannel delivers synchronously; "
                            "there is nothing to recv")

    def close(self) -> None:
        self._closed = True


class BatchingChannel(Channel):
    """Coalesce messages into bounded batches on another Channel.

    Buffers sends and delivers them downstream as one
    ``{"t": "batch", "msgs": [...]}`` frame once ``max_batch`` messages
    have accumulated, or immediately when a send is marked ``flush=True``
    (a single buffered message is forwarded bare -- no batch wrapper -- so
    ``max_batch=1`` degenerates to the inner channel exactly).

    Ordering contract (DESIGN.md §8/§9): the buffer append and the inner
    ``send`` happen under ONE lock.  Flushing outside the lock would let
    two concurrent flushes swap buffers and then race their inner sends,
    which can reorder one thread's update *after* its own completion
    across batch boundaries -- precisely the inversion the updates-
    before-done contract forbids.  Holding the lock across the inner
    send serialises batch emission in buffer order, so wire order is a
    legal interleaving of the per-thread send orders, batched or not.
    """

    def __init__(self, inner: Channel, max_batch: int = 64) -> None:
        self.inner = inner
        self.max_batch = max(int(max_batch), 1)
        self._buf: list[Any] = []
        self._lock = threading.Lock()
        self.batches_sent = 0
        self.msgs_sent = 0

    def send(self, msg: Any, flush: bool = False) -> None:
        with self._lock:
            self._buf.append(msg)
            if flush or len(self._buf) >= self.max_batch:
                self._flush_locked()

    def flush(self) -> None:
        with self._lock:
            if self._buf:
                self._flush_locked()

    def _flush_locked(self) -> None:
        buf, self._buf = self._buf, []
        self.msgs_sent += len(buf)
        self.batches_sent += 1
        if len(buf) == 1:
            self.inner.send(buf[0])
        else:
            self.inner.send({"t": "batch", "msgs": buf})

    def recv(self, timeout: Optional[float] = None) -> Any:
        raise ChannelClosed("BatchingChannel is send-side only")

    def close(self) -> None:
        self.flush()
        self.inner.close()
