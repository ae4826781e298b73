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
seams exactly the cut points where the single-process runtime would become
a multi-process fleet: swap the queue-backed channels below for
socket-backed ones and the same dispatcher drives executors in other OS
processes without a single scheduling-logic change.

In-process implementations:

  `LocalChannel`     a `queue.Queue` with the Channel interface -- the
                     per-worker dispatch inbox.
  `CallbackChannel`  a synchronous send-side-only channel: `send` invokes
                     the consumer inline (the dispatcher applying an index
                     update under its own lock).  This is what "the update
                     seam, in process" degenerates to.
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
