"""Fleet wire protocol: length-prefixed frames of msgpack-or-JSON messages.

Framing
-------
Every message is one frame: a 4-byte big-endian unsigned length followed by
that many payload bytes.  Frames on one TCP stream are totally ordered,
which the fleet relies on (a host sends a task's index updates *before* its
completion; the central receiver applies them in arrival order -- the
Channel seam contract, DESIGN.md §8).

Codec
-----
Messages are plain dict/list/str/int/float/bool/None trees plus three
payload-bearing leaf types that need tagging:

  tensors        {"__wire__": "ndarray", dtype, shape, data: <bytes>}
                 (numpy's dtype string and the C-contiguous bytes of
                 ``t.detach().cpu()``: the reference's frame for a numpy
                 array of the same values, byte for byte, in both codecs.
                 A numpy array is encoded the same way.  Decoding gives a
                 CPU tensor; admission into an executor cache moves it to
                 the host's device.  A dtype numpy lacks, such as
                 bfloat16, raises WireError.)
  bytes          native in msgpack; {"__wire__": "bytes", b64} under JSON
  SHAPE_ONLY_PAYLOAD
                 {"__wire__": "shape_only"} -- the runtime's shape-only
                 store sentinel: it must cross the wire as itself,
                 NOT as None, because a None payload reads as a cache miss.

Tuples are encoded as lists (consumers re-tuple where the runtime cares).
``msgpack`` is used when importable, JSON (with base64 bytes) otherwise;
the tests exercise both by forcing ``codec="json"``.  Both ends of a
connection must agree, so the codec is fixed per fleet: the central
process picks it and passes it to every host at spawn time.

Batched frames (DESIGN.md §9)
-----------------------------
A frame may carry one logical message or a bounded batch wrapper
``{"t": "batch", "msgs": [...]}``; receivers unwrap and process the inner
messages in list order, so a batch is exactly equivalent to its messages
sent as consecutive frames -- the updates-before-done ordering contract
holds within and across batches because batching (core.channel.
BatchingChannel / HostHandle.send_batch) never reorders the buffer.

Observability frames (DESIGN.md §10)
------------------------------------
When event recording is on, hosts additionally send
``{"t": "events", "host": host_id, "events": [...]}`` upstream: the
host-side `repro_torch.obs.Recorder` ring drained into one message.  Events
ride the SAME BatchingChannel buffer as everything else -- a host
enqueues them (buffered) immediately before each flushed ``done`` and
before each heartbeat -- so an attempt's input/exec events arrive in the
frame that carries its completion, and recording piggybacks on the
updates-before-done contract instead of adding a side channel that could
reorder the seam.  Receivers that don't record simply drop the kind.
"""
from __future__ import annotations

import base64
import json
import socket
import struct
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.channel import ChannelClosed
from repro_torch.core.runtime import SHAPE_ONLY_PAYLOAD

try:  # msgpack where installed; JSON is the no-dependency fallback
    import msgpack  # type: ignore
    HAVE_MSGPACK = True
except ImportError:  # pragma: no cover - exercised by forcing codec="json"
    msgpack = None
    HAVE_MSGPACK = False

#: frames larger than this are a protocol error, not a payload (guards a
#: desynchronised stream from allocating garbage-length buffers)
MAX_FRAME = 1 << 30

_TAG = "__wire__"


class WireError(Exception):
    """Framing/codec violation (desync, oversized frame, unknown tag)."""


class PeerGone(Exception):
    """The other end of the stream closed (EOF mid-frame or on a read)."""


# --------------------------------------------------------------------------
# structure transform: tag payload leaves the codecs can't carry natively
# --------------------------------------------------------------------------

def _host_array(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as a numpy array in host memory.  ``.cpu()`` of a
    device tensor waits for the work queued on its stream, so a payload
    another executor is still producing is read finished."""
    try:
        return t.detach().cpu().numpy()
    except TypeError as e:   # a dtype numpy has no counterpart of
        raise WireError(f"tensor of dtype {t.dtype} cannot cross the wire "
                        f"({e})") from None


def _pack(obj: Any, *, binary: bool) -> Any:
    if obj is SHAPE_ONLY_PAYLOAD:
        return {_TAG: "shape_only"}
    if isinstance(obj, torch.Tensor):
        obj = _host_array(obj)
    if isinstance(obj, np.ndarray):
        return {_TAG: "ndarray", "dtype": obj.dtype.str,
                "shape": list(obj.shape),
                "data": _pack(np.ascontiguousarray(obj).tobytes(),
                              binary=binary)}
    if isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        if binary:
            return b
        return {_TAG: "bytes", "b64": base64.b64encode(b).decode("ascii")}
    if isinstance(obj, (list, tuple)):
        return [_pack(v, binary=binary) for v in obj]
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if not isinstance(k, str):
                raise WireError(f"wire dict keys must be str, got {k!r}")
            if k == _TAG:
                raise WireError(f"reserved key {_TAG!r} in message")
            out[k] = _pack(v, binary=binary)
        return out
    if obj is None or isinstance(obj, (str, int, float, bool)):
        return obj
    raise WireError(f"unserialisable wire value of type {type(obj).__name__}")


def _unpack(obj: Any) -> Any:
    if isinstance(obj, dict):
        tag = obj.get(_TAG)
        if tag == "shape_only":
            return SHAPE_ONLY_PAYLOAD
        if tag == "ndarray":
            data = _unpack(obj["data"])
            arr = np.frombuffer(data, dtype=np.dtype(obj["dtype"]))
            arr = arr.reshape(tuple(obj["shape"])).copy()
            try:
                return torch.from_numpy(arr)
            except TypeError as e:   # a numpy dtype torch lacks
                raise WireError(f"wire array of dtype {arr.dtype} has no "
                                f"tensor counterpart ({e})") from None
        if tag == "bytes":
            return base64.b64decode(obj["b64"])
        if tag is not None:
            raise WireError(f"unknown wire tag {tag!r}")
        return {k: _unpack(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_unpack(v) for v in obj]
    return obj


def encode(obj: Any, codec: str = "auto") -> bytes:
    codec = _resolve_codec(codec)
    if codec == "msgpack":
        return msgpack.packb(_pack(obj, binary=True), use_bin_type=True)
    return json.dumps(_pack(obj, binary=False),
                      separators=(",", ":")).encode("utf-8")


def decode(data: bytes, codec: str = "auto") -> Any:
    codec = _resolve_codec(codec)
    if codec == "msgpack":
        return _unpack(msgpack.unpackb(data, raw=False))
    return _unpack(json.loads(data.decode("utf-8")))


def _resolve_codec(codec: str) -> str:
    if codec == "auto":
        return "msgpack" if HAVE_MSGPACK else "json"
    if codec == "msgpack" and not HAVE_MSGPACK:
        raise WireError("msgpack codec requested but msgpack is missing")
    if codec not in ("msgpack", "json"):
        raise WireError(f"unknown codec {codec!r}")
    return codec


# --------------------------------------------------------------------------
# framed socket I/O
# --------------------------------------------------------------------------

def send_msg(sock: socket.socket, obj: Any, codec: str = "auto") -> int:
    """Frame + send one message; returns bytes put on the wire (header
    included -- a bandwidth ledger counts real socket bytes)."""
    payload = encode(obj, codec)
    if len(payload) > MAX_FRAME:
        raise WireError(f"frame of {len(payload)} bytes exceeds MAX_FRAME")
    frame = struct.pack(">I", len(payload)) + payload
    sock.sendall(frame)
    return len(frame)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            # socket.timeout IS an OSError (TimeoutError) on 3.10+:
            # re-raise before the peer-death translation below, or a
            # quiet interval on a healthy connection reads as the peer
            # dying (recv_msg documents timeouts pass through untouched)
            raise
        except (ConnectionError, OSError) as e:
            raise PeerGone(str(e)) from None
        if not chunk:
            raise PeerGone("EOF")
        buf += chunk
    return bytes(buf)


def recv_msg(sock: socket.socket, codec: str = "auto",
             timeout: Optional[float] = None) -> Any:
    """Read one framed message (blocking; ``timeout`` uses the socket
    timeout and raises ``socket.timeout`` untouched so pollers can spin)."""
    if timeout is not None:
        sock.settimeout(timeout)
    header = _recv_exact(sock, 4)
    (length,) = struct.unpack(">I", header)
    if length > MAX_FRAME:
        raise WireError(f"incoming frame of {length} bytes exceeds MAX_FRAME "
                        f"(stream desync?)")
    return decode(_recv_exact(sock, length), codec)


class SocketChannel:
    """`repro_torch.core.Channel` over one direction of a framed TCP stream.

    The fleet's channel *pair* is the two directions of one connection:
    central->host carries dispatches (central holds the send side), and
    host->central carries updates/completions/heartbeats (central holds
    the recv side).  ``send`` is locked (many executor threads share the
    host's upstream); ``recv`` assumes a single consumer thread, which is
    exactly the receiver-thread-per-host structure in manager.py.
    """

    def __init__(self, sock: socket.socket, codec: str = "auto") -> None:
        import threading

        self.sock = sock
        self.codec = _resolve_codec(codec)
        self._send_lock = threading.Lock()
        self._closed = False
        self.bytes_sent = 0
        self.frames_sent = 0

    def send(self, msg: Any) -> None:
        if self._closed:
            raise ChannelClosed("send on closed SocketChannel")
        try:
            with self._send_lock:
                self.bytes_sent += send_msg(self.sock, msg, self.codec)
                self.frames_sent += 1
        except (PeerGone, ConnectionError, OSError) as e:
            raise ChannelClosed(str(e)) from None

    def recv(self, timeout: Optional[float] = None) -> Any:
        if self._closed:
            raise ChannelClosed("recv on closed SocketChannel")
        try:
            return recv_msg(self.sock, self.codec, timeout)
        except socket.timeout:
            raise TimeoutError("SocketChannel.recv timed out") from None
        except PeerGone as e:
            raise ChannelClosed(str(e)) from None

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            try:
                self.sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self.sock.close()
