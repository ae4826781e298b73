"""The port's fleet wire (``repro_torch.fleet.wire``), its batched channel,
the central receive path, and the scheduling hooks the fleet drives
(``ShardedIndex``/``apply_wire``, ``lease_next``/``bind_claim``/
``requeue_leased``) -- each against the JAX package's counterpart.

Counterparts of every test in ``tests/test_fleet_wire.py``, with tensors
where the reference ships numpy arrays, plus:

  * frames byte-identical across the two packages, in both codecs, for a
    numpy array on the reference's side and a tensor of the same values on
    the port's (float32, int64, uint8, bool, empty, non-contiguous), and
    each package decoding the other's frames;
  * a dtype numpy lacks (bfloat16) refused with ``WireError``;
  * the index replica and the lease/claim hooks giving the reference's
    states and recorded events for the same operation sequences.

No process is spawned here: the fleet end to end is in
``tests/test_torch_fleet.py``.
"""
from __future__ import annotations

import json
import random
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from repro.core import Task as JaxTask
from repro.core.index import ShardedIndex as JaxShardedIndex
from repro.core.policies import DispatchPolicy as JaxPolicy
from repro.core.runtime import SHAPE_ONLY_PAYLOAD as JAX_SHAPE_ONLY
from repro.core.scheduler import Dispatcher as JaxDispatcher
from repro.fleet import wire as jax_wire
from repro.obs import Recorder as JaxRecorder
from repro_torch.core import Task
from repro_torch.core.channel import (BatchingChannel, ChannelClosed,
                                      LocalChannel)
from repro_torch.core.index import LocationIndex, ShardedIndex
from repro_torch.core.policies import DispatchPolicy
from repro_torch.core.runtime import SHAPE_ONLY_PAYLOAD
from repro_torch.core.scheduler import Dispatcher
from repro_torch.fleet import FleetRuntime, wire
from repro_torch.fleet.manager import HostHandle
from repro_torch.fleet.runtime import _RemoteExecutor
from repro_torch.fleet.wire import (MAX_FRAME, PeerGone, SocketChannel,
                                    WireError, decode, encode, recv_msg,
                                    send_msg)
from repro_torch.obs import Recorder

CODECS = ["msgpack", "json"] if wire.HAVE_MSGPACK else ["json"]


@pytest.fixture(params=CODECS)
def codec(request):
    return request.param


def rt(obj, codec):
    return decode(encode(obj, codec), codec)


def _same_tensor(got, want: torch.Tensor) -> None:
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got, want)


# --------------------------------------------------------------------------
# codec round-trips
# --------------------------------------------------------------------------

def test_scalars_and_structures(codec):
    msg = {"t": "task", "n": 3, "f": 1.5, "flag": True, "none": None,
           "nested": {"deep": [1, "two", 3.0, False, None]}}
    assert rt(msg, codec) == msg


def test_tuples_become_lists(codec):
    assert rt({"inputs": ("a", "b")}, codec) == {"inputs": ["a", "b"]}


def test_bytes_round_trip(codec):
    for b in (b"", b"\x00\xff" * 100, bytes(range(256))):
        assert rt({"payload": b}, codec) == {"payload": b}


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "uint8",
                                   "complex64", "bool"])
def test_tensor_round_trip(codec, dtype):
    arr = (np.arange(24).reshape(2, 3, 4) % 2).astype(dtype)
    t = torch.from_numpy(arr)
    _same_tensor(rt(t, codec), t)
    # a numpy array crosses as the same frame and decodes to a tensor
    assert encode(arr, codec) == encode(t, codec)
    _same_tensor(rt(arr, codec), t)


def test_tensor_empty_and_noncontiguous(codec):
    empty = torch.zeros((0, 5), dtype=torch.float32)
    _same_tensor(rt(empty, codec), empty)
    base = torch.arange(36, dtype=torch.int64).reshape(6, 6)
    sliced = base[::2, ::3]          # non-contiguous view
    assert not sliced.is_contiguous()
    _same_tensor(rt(sliced, codec), sliced.contiguous())


def test_tensor_that_requires_grad_crosses_as_its_values(codec):
    t = torch.linspace(0, 1, 7, requires_grad=True)
    got = rt({"p": t}, codec)["p"]
    _same_tensor(got, t.detach())
    assert not got.requires_grad


def test_bfloat16_raises_wire_error(codec):
    with pytest.raises(WireError, match="bfloat16"):
        encode({"payload": torch.ones(3, dtype=torch.bfloat16)}, codec)


def test_shape_only_sentinel_is_identity(codec):
    """The shape-only sentinel must cross the wire as ITSELF: the runtime's
    cache-hit test is `payload is not None`, and the hosts' store replicas
    hold whatever decode() returns."""
    out = rt({"payload": SHAPE_ONLY_PAYLOAD}, codec)
    assert out["payload"] is SHAPE_ONLY_PAYLOAD


def test_k_input_task_message(codec):
    """A realistic 3-input dispatch with hints + routes survives."""
    msg = {"t": "task", "eid": "w3", "tid": "wl-17",
           "inputs": [["a", 100], ["b", 200], ["a", 100]],   # dup oids stay
           "outputs": [["wl-17.out", 64]],
           "hints": {"a": ["w0", "w3"], "b": ["w1"]},
           "routes": {"w0": ["127.0.0.1", 4242], "w1": ["127.0.0.1", 4243]}}
    out = rt(msg, codec)
    assert out["inputs"] == msg["inputs"]
    assert out["hints"] == msg["hints"]
    assert out["routes"]["w0"] == ["127.0.0.1", 4242]


def test_empty_payloads(codec):
    assert rt({}, codec) == {}
    assert rt([], codec) == []
    assert rt({"payload": b""}, codec) == {"payload": b""}


def test_reserved_and_bad_keys_hard_error(codec):
    with pytest.raises(WireError):
        encode({"__wire__": "nope"}, codec)
    with pytest.raises(WireError):
        encode({1: "int key"}, codec)
    with pytest.raises(WireError):
        encode({"fn": object()}, codec)


def test_unknown_tag_hard_errors(codec):
    data = encode({"x": 1}, codec)
    bad = json.dumps({"__wire__": "martian"}).encode()
    with pytest.raises(WireError):
        decode(bad, "json")
    assert decode(data, codec) == {"x": 1}


# --------------------------------------------------------------------------
# frames across the two packages
# --------------------------------------------------------------------------

def _cross_cases():
    base = np.arange(36, dtype=np.int64).reshape(6, 6)
    rng = np.random.default_rng(0)
    return {
        "float32": rng.normal(size=(8, 10, 10)).astype(np.float32),
        "int64": np.arange(-5, 7, dtype=np.int64).reshape(3, 4),
        "uint8": rng.integers(0, 256, 300).astype(np.uint8),
        "bool": rng.random((4, 5)) > 0.5,
        "empty": np.zeros((0, 5), dtype=np.float32),
        "noncontiguous": base[::2, ::3],
    }


@pytest.mark.parametrize("case", list(_cross_cases()))
def test_frames_byte_identical_across_packages(codec, case):
    arr = _cross_cases()[case]
    t = torch.from_numpy(np.array(arr))          # a tensor of the same values
    if case == "noncontiguous":
        t = torch.arange(36, dtype=torch.int64).reshape(6, 6)[::2, ::3]
        assert not t.is_contiguous()
    jmsg = {"t": "put", "oid": "img7", "size": 320_000, "payload": arr,
            "blob": b"\x00\x01", "sentinel": JAX_SHAPE_ONLY}
    pmsg = {"t": "put", "oid": "img7", "size": 320_000, "payload": t,
            "blob": b"\x00\x01", "sentinel": SHAPE_ONLY_PAYLOAD}
    frame = jax_wire.encode(jmsg, codec)
    assert encode(pmsg, codec) == frame
    # each package decodes the other's frame into its own types
    got = decode(jax_wire.encode(jmsg, codec), codec)
    _same_tensor(got["payload"], t.contiguous())
    assert got["sentinel"] is SHAPE_ONLY_PAYLOAD and got["blob"] == b"\x00\x01"
    back = jax_wire.decode(encode(pmsg, codec), codec)
    assert isinstance(back["payload"], np.ndarray)
    assert back["payload"].dtype == arr.dtype
    np.testing.assert_array_equal(back["payload"], arr)
    assert back["sentinel"] is JAX_SHAPE_ONLY


def test_framed_socket_bytes_identical_across_packages(codec):
    a, b = socket.socketpair()
    try:
        msg_t = {"t": "done", "payload": torch.ones(4, dtype=torch.float32)}
        msg_n = {"t": "done", "payload": np.ones(4, dtype=np.float32)}
        n_port = send_msg(a, msg_t, codec)
        n_ref = jax_wire.send_msg(a, msg_n, codec)
        assert n_port == n_ref
        raw = b.recv(n_port + n_ref, socket.MSG_WAITALL)
        assert raw[:n_port] == raw[n_port:]
    finally:
        a.close()
        b.close()


# --------------------------------------------------------------------------
# framing over real sockets
# --------------------------------------------------------------------------

def _pair():
    a, b = socket.socketpair()
    return a, b


def test_framed_messages_preserve_order(codec):
    a, b = _pair()
    msgs = [{"i": i, "data": b"x" * i} for i in range(50)]

    def send():
        for m in msgs:
            send_msg(a, m, codec)
    th = threading.Thread(target=send)
    th.start()
    got = [recv_msg(b, codec) for _ in range(50)]
    th.join(30)
    assert got == [decode(encode(m, codec), codec) for m in msgs]
    a.close()
    b.close()


def test_large_frame(codec):
    a, b = _pair()
    t = torch.from_numpy(np.random.default_rng(0).random(200_000))  # 1.6 MB
    th = threading.Thread(target=send_msg, args=(a, {"arr": t}, codec))
    th.start()
    out = recv_msg(b, codec)
    th.join(30)
    _same_tensor(out["arr"], t)
    a.close()
    b.close()


def test_oversized_frame_header_rejected():
    a, b = _pair()
    a.sendall(struct.pack(">I", MAX_FRAME + 1))
    with pytest.raises(WireError):
        recv_msg(b)
    a.close()
    b.close()


def test_eof_raises_peer_gone(codec):
    a, b = _pair()
    a.close()
    with pytest.raises(PeerGone):
        recv_msg(b, codec)
    b.close()


def test_eof_mid_frame_raises_peer_gone(codec):
    a, b = _pair()
    payload = encode({"x": 1}, codec)
    a.sendall(struct.pack(">I", len(payload)) + payload[:1])
    a.close()
    with pytest.raises(PeerGone):
        recv_msg(b, codec)
    b.close()


def test_socket_channel_pair(codec):
    a, b = _pair()
    ca, cb = SocketChannel(a, codec), SocketChannel(b, codec)
    ca.send({"hello": 1})
    assert cb.recv() == {"hello": 1}
    assert ca.bytes_sent > 4
    ca.close()
    with pytest.raises(ChannelClosed):
        cb.recv()
    with pytest.raises(ChannelClosed):
        ca.send({"x": 1})
    cb.close()


# --------------------------------------------------------------------------
# batched wire: BatchingChannel units + batch-frame codec round-trips
# --------------------------------------------------------------------------

class TestBatchingChannel:
    def test_threshold_flush_preserves_order(self):
        inner = LocalChannel()
        ch = BatchingChannel(inner, max_batch=3)
        for i in range(5):
            ch.send(i)
        assert inner.recv() == {"t": "batch", "msgs": [0, 1, 2]}
        assert inner.empty()            # 3, 4 still buffered
        ch.flush()
        assert inner.recv() == {"t": "batch", "msgs": [3, 4]}
        assert ch.batches_sent == 2 and ch.msgs_sent == 5

    def test_single_message_flush_goes_bare(self):
        inner = LocalChannel()
        ch = BatchingChannel(inner, max_batch=8)
        ch.send({"t": "done", "tid": "x"}, flush=True)
        assert inner.recv() == {"t": "done", "tid": "x"}   # no wrapper

    def test_max_batch_one_degenerates_to_inner_channel(self):
        inner = LocalChannel()
        ch = BatchingChannel(inner, max_batch=1)
        for i in range(4):
            ch.send(i)
            assert inner.recv() == i    # forwarded immediately, bare

    def test_send_side_only(self):
        with pytest.raises(ChannelClosed):
            BatchingChannel(LocalChannel(), max_batch=4).recv()

    def test_close_flushes_pending_then_closes_inner(self):
        inner = LocalChannel()
        ch = BatchingChannel(inner, max_batch=8)
        ch.send("u")
        ch.send("d")
        ch.close()
        assert inner.recv() == {"t": "batch", "msgs": ["u", "d"]}
        with pytest.raises(ChannelClosed):
            inner.recv()

    def test_updates_before_done_across_batch_boundaries(self):
        """The ordering contract batched: an attempt's updates precede its
        done in the FLATTENED frame stream even when the boundary falls
        between them."""
        inner = LocalChannel()
        ch = BatchingChannel(inner, max_batch=2)
        sent = [{"t": "updates", "n": 0}, {"t": "updates", "n": 1},
                {"t": "done"}]
        for m in sent[:-1]:
            ch.send(m)
        ch.send(sent[-1], flush=True)
        flat = []
        while not inner.empty():
            f = inner.recv()
            flat.extend(f["msgs"] if isinstance(f, dict)
                        and f.get("t") == "batch" else [f])
        assert flat == sent


def test_batch_frame_round_trip(codec):
    frame = {"t": "batch", "msgs": [
        {"t": "updates", "eid": "w0", "added": ["a", "b"], "removed": ["c"]},
        {"t": "done", "eid": "w0", "tid": "t1", "ok": True,
         "ledger": {"bytes_local": 5, "bytes_cache_to_cache": 0,
                    "bytes_store": 7, "cache_hits": 1, "peer_hits": 0,
                    "cache_misses": 1}},
        {"t": "hb", "host": "h0"}]}
    assert rt(frame, codec) == frame


# --------------------------------------------------------------------------
# fake-host harness: the REAL _on_remote_batch receive path, no sockets
# --------------------------------------------------------------------------

class _FakeProc:
    """Process stand-in so HostManager monitor/reap accept the handle."""
    pid = 0
    exitcode = None

    def is_alive(self):
        return True

    def terminate(self):
        pass

    def join(self, timeout=None):
        pass


def _fake_fleet(n_hosts=2, tph=2, wire_batch=64, **rt_kw):
    """A hosts=0 FleetRuntime on the CPU with fake in-process host handles:
    dispatch frames land in a LocalChannel per host, and the test feeds
    replies straight into the production `_on_remote_batch`."""
    rt_ = FleetRuntime(hosts=0, threads_per_host=tph, wire_batch=wire_batch,
                       heartbeat_timeout_s=60.0, device="cpu", **rt_kw)
    handles = []
    for h in range(n_hosts):
        handle = HostHandle(f"h{h}", _FakeProc(), LocalChannel(),
                            peer_host="127.0.0.1", peer_port=0)
        with rt_._lock:
            for _ in range(tph):
                eid = f"w{rt_._next_worker_id}"
                rt_._next_worker_id += 1
                rt_.workers[eid] = _RemoteExecutor(eid, handle, rt_)
                handle.eids.append(eid)
                rt_.dispatcher.executor_joined(eid, time.monotonic())
        rt_.manager.handles[handle.host_id] = handle
        handles.append(handle)
    return rt_, handles


def _drain_dispatched(handles):
    """Unwrap every frame queued on the fake hosts' dispatch channels,
    returning (handle, task_msg) pairs in wire order."""
    out = []
    for h in handles:
        while not h.chan.empty():
            m = h.chan.recv()
            inner = (m["msgs"] if isinstance(m, dict)
                     and m.get("t") == "batch" else [m])
            for msg in inner:
                if isinstance(msg, dict) and msg.get("t") == "task":
                    out.append((h, msg))
    return out


def _reply_msgs(msg, caches, peer_every=0, counter=None):
    """Scripted host reply for one task msg: LRU-churn one coalesced
    updates frame + the done frame.  Every ``peer_every``-th miss is
    served cache-to-cache (peer hit) instead of from the store."""
    counter = counter if counter is not None else [0]
    eid = msg["eid"]
    cache = caches.setdefault(eid, [])
    before = set(cache)
    led = {"bytes_local": 0, "bytes_cache_to_cache": 0, "bytes_store": 0,
           "cache_hits": 0, "peer_hits": 0, "cache_misses": 0}
    for oid, size in msg["inputs"]:
        if oid in cache:
            cache.remove(oid)
            cache.append(oid)
            led["cache_hits"] += 1
            led["bytes_local"] += size
            continue
        led["cache_misses"] += 1
        counter[0] += 1
        if peer_every and counter[0] % peer_every == 0:
            led["peer_hits"] += 1
            led["bytes_cache_to_cache"] += size
        else:
            led["bytes_store"] += size
        cache.append(oid)
        while len(cache) > 4:
            cache.pop(0)
    added = [o for o in cache if o not in before]
    removed = sorted(before - set(cache))
    replies = []
    if added or removed:
        replies.append({"t": "updates", "eid": eid,
                        "added": added, "removed": removed})
    replies.append({"t": "done", "eid": eid, "tid": msg["tid"],
                    "ok": True, "ledger": led})
    return replies


def _ledger_conserves(rt_):
    lg, d = rt_.ledger, rt_.dispatcher
    sums = [0] * 6
    for t in d.completed:
        sums[0] += t.bytes_local
        sums[1] += t.bytes_cache_to_cache
        sums[2] += t.bytes_store
        sums[3] += t.cache_hits
        sums[4] += t.peer_hits
        sums[5] += t.cache_misses - t.peer_hits
    assert sums == [lg.bytes_local, lg.bytes_c2c, lg.bytes_store,
                    lg.local_hits, lg.peer_hits, lg.store_reads]


def test_randomized_interleavings_complete_and_conserve(codec):
    """Random frame chunkings of updates/done/hb streams -- round-tripped
    through the codec exactly like the real wire -- drive every task to
    completion exactly once with an exactly-conserved ledger."""
    rng = random.Random(0xD15BA7C4)
    for trial in range(3):
        rt_, handles = _fake_fleet(wire_batch=rng.choice([1, 4, 64]))
        try:
            n, n_oids = 60, 16
            with rt_._lock:
                for i in range(n_oids):
                    rt_.dispatcher.sizes[f"o{i}"] = 1000
            oids = [f"o{i}" for i in range(n_oids)]
            rt_.submit(Task(inputs=tuple(rng.sample(oids, 2)))
                       for _ in range(n))
            caches, outbox = {}, {h.host_id: [] for h in handles}
            counter = [0]
            spins = 0
            while len(rt_.dispatcher.completed) < n:
                spins += 1
                assert spins < 10_000, "drive loop wedged"
                for h, msg in _drain_dispatched(handles):
                    outbox[h.host_id].extend(
                        _reply_msgs(msg, caches, peer_every=5,
                                    counter=counter))
                    if rng.random() < 0.3:
                        outbox[h.host_id].append({"t": "hb",
                                                  "host": h.host_id})
                for h in handles:
                    buf = outbox[h.host_id]
                    while buf:
                        k = rng.randint(1, min(6, len(buf)))
                        chunk = [buf.pop(0) for _ in range(k)]
                        frame = (chunk[0] if len(chunk) == 1
                                 else {"t": "batch", "msgs": chunk})
                        frame = decode(encode(frame, codec), codec)
                        inner = (frame["msgs"]
                                 if frame.get("t") == "batch" else [frame])
                        rt_._on_remote_batch(h, inner)
            d = rt_.dispatcher
            assert len(d.completed) == n and not d.failed
            assert rt_.ledger.peer_hits > 0      # the peer term is live
            _ledger_conserves(rt_)
            for eid, cache in caches.items():
                if eid in rt_.workers:
                    assert rt_.dispatcher.index.holdings(eid) == set(cache)
        finally:
            rt_.shutdown()


def test_dead_host_frames_cannot_resurrect_index_entries():
    """Late updates/done frames from a declared-dead host are dropped by
    the membership guard: no index resurrection, no double accounting,
    and the re-queued task still runs exactly once (elsewhere)."""
    rt_, (h0, h1) = _fake_fleet(n_hosts=2, tph=1)
    try:
        with rt_._lock:
            rt_.dispatcher.sizes["a"] = 10
        eid0, eid1 = h0.eids[0], h1.eids[0]
        rt_._on_remote_batch(h0, [{"t": "updates", "eid": eid0,
                                   "added": ["a"], "removed": []}])
        assert eid0 in rt_.dispatcher.index.lookup("a")
        # an update claiming ANOTHER host's executor is refused outright
        rt_._on_remote_batch(h0, [{"t": "updates", "eid": eid1,
                                   "added": ["a"], "removed": []}])
        assert eid1 not in rt_.dispatcher.index.lookup("a")

        rt_.submit([Task(inputs=("a",))])
        inflight = [(h, m) for h, m in _drain_dispatched((h0, h1))
                    if m["eid"] == eid0]
        rt_._on_host_dead(h0)
        assert eid0 not in rt_.dispatcher.index.lookup("a")
        assert eid0 not in rt_.workers

        rt_._on_remote_batch(h0, [{"t": "updates", "eid": eid0,
                                   "added": ["a"], "removed": []}])
        assert eid0 not in rt_.dispatcher.index.lookup("a")
        before = rt_.ledger.store_reads
        for h, m in inflight:
            for reply in _reply_msgs(m, {}):
                rt_._on_remote_batch(h0, [reply])
        assert rt_.ledger.store_reads == before
        assert not rt_.dispatcher.completed

        caches = {}
        for h, m in _drain_dispatched((h1,)):
            rt_._on_remote_batch(h1, _reply_msgs(m, caches))
        assert [t.executor for t in rt_.dispatcher.completed] == [eid1]
        _ledger_conserves(rt_)
    finally:
        rt_.shutdown()


def test_unleased_claim_is_a_conflict():
    """A claim frame with no backing lease (or from a dead handle) falls
    back to central authority: counted as a conflict, never bound."""
    rt_, (h0,) = _fake_fleet(n_hosts=1, tph=1)
    try:
        eid = h0.eids[0]
        rt_._on_remote_batch(h0, [{"t": "claim", "eid": eid,
                                   "tid": "ghost"}])
        st = rt_.dispatch_stats()
        assert st["claim_conflicts"] == 1 and st["claims"] == 0
        h0.dead = True
        rt_._on_remote_batch(h0, [{"t": "claim", "eid": eid,
                                   "tid": "ghost"}])
        assert rt_.dispatch_stats()["claim_conflicts"] == 2
    finally:
        h0.dead = False
        rt_.shutdown()


def test_lease_grants_claims_and_reclaims_through_the_receive_path():
    """A backlog on a local-dispatch fake fleet grants lease frames; a claim
    binds the leased task to the claiming executor, and the host's death
    returns the unclaimed rest to the queue front in lease order."""
    rt_, (h0,) = _fake_fleet(n_hosts=1, tph=1, local_dispatch=True,
                             lease_depth=2)
    try:
        rt_.submit(Task(inputs=(), tid=f"t{i}") for i in range(5))
        frames = []
        while not h0.chan.empty():
            m = h0.chan.recv()
            frames.extend(m["msgs"] if m.get("t") == "batch" else [m])
        leases = [t["tid"] for m in frames if m["t"] == "lease"
                  for t in m["tasks"]]
        assert leases == ["t1", "t2"]           # t0 dispatched centrally
        rt_._on_remote_batch(h0, [{"t": "claim", "eid": h0.eids[0],
                                   "tid": "t2"}])
        assert rt_.dispatch_stats()["claims"] == 1
        assert rt_.dispatcher.tasks["t2"].executor == h0.eids[0]
        with rt_._lock:
            rt_._drop_host_locked(h0, failed=True)
        assert [t.tid for t in rt_.dispatcher.queue][:1] == ["t1"]
    finally:
        rt_.shutdown()


# --------------------------------------------------------------------------
# the scheduling hooks against the reference
# --------------------------------------------------------------------------

def _index_script(seed: int):
    rng = random.Random(seed)
    oids = [f"o{i}" for i in range(30)]
    eids = [f"w{i}" for i in range(5)]
    ops = []
    for _ in range(300):
        r = rng.random()
        if r < 0.7:
            ops.append(("wire", [[rng.choice(eids),
                                  rng.sample(oids, rng.randint(0, 4)),
                                  rng.sample(oids, rng.randint(0, 2))]
                                 for _ in range(rng.randint(1, 3))]))
        elif r < 0.9:
            ops.append(("lookup", rng.choice(oids)))
        else:
            ops.append(("drop", rng.choice(eids)))
    return oids, eids, ops


def _index_states(index, oids, eids, ops):
    out = []
    for kind, arg in ops:
        if kind == "wire":
            index.apply_wire(arg)
        elif kind == "lookup":
            out.append(sorted(index.lookup(arg)))
        else:
            out.append(index.drop_executor(arg))
    out.append({o: sorted(index.lookup(o)) for o in oids})
    out.append({e: sorted(index.holdings(e)) for e in eids})
    out.append((len(index), index.n_inserts, index.n_removes))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sharded_index_apply_wire_matches_reference(seed):
    oids, eids, ops = _index_script(seed)
    want = _index_states(JaxShardedIndex(n_shards=4), oids, eids, ops)
    assert _index_states(ShardedIndex(n_shards=4), oids, eids, ops) == want
    # the unsharded index reaches the same locations through apply_wire
    flat = _index_states(LocationIndex(), oids, eids, ops)
    assert flat[:-1] == want[:-1]
    with pytest.raises(ValueError):
        ShardedIndex(n_shards=0)


def _lease_script(Dispatcher_, Policy, Task_, Recorder_, seed: int):
    """Submit a backlog, lease some of it, claim some leases, requeue the
    rest, dispatch what is left: the dispatcher's queue, bindings and the
    recorded lifecycle events after each step."""
    rng = random.Random(seed)
    rec = Recorder_(clock=lambda: 0.0)
    d = Dispatcher_(Policy("max-compute-util"))
    d.recorder = rec
    for e in ("e0", "e1"):
        d.executor_joined(e, 0.0)
    for i in range(6):
        d.sizes[f"o{i}"] = 1000 * (i + 1)
    tasks = [Task_(inputs=tuple(rng.sample([f"o{i}" for i in range(6)], 2)),
                   tid=f"t{i}") for i in range(12)]
    d.submit(tasks[:2], 0.0)
    # e0, e1 busy with the first two; the rest waits and gets leased
    states = [[(x.task.tid, x.executor) for x in d.next_dispatches(1.0)]]
    d.apply_index_updates([])
    d.submit(tasks[2:], 1.0)
    leased = [d.lease_next() for _ in range(5)]
    states.append([(t.tid, t.state.name, t.location_hints) for t in leased])
    states.append([t.tid for t in d.queue])
    claimed = [leased[i] for i in (1, 3)]
    for t, eid in zip(claimed, ("e0", "e1")):
        disp = d.bind_claim(t, eid, 2.0)
        states.append((disp.task.tid, disp.executor, disp.hints))
    d.requeue_leased([leased[i] for i in (0, 2, 4)])
    states.append([(t.tid, t.state.name) for t in d.queue])
    for t in claimed + tasks[:2]:
        d.task_finished(t, 3.0, ok=True)
    states.append([(x.task.tid, x.executor)
                   for x in d.next_dispatches(4.0)])
    assert d.lease_next() is not None or not d.queue
    states.append(d.n_decisions)
    events = [(e["kind"], e.get("tid"), e.get("eid"), e.get("reason"))
              for e in rec.events()]
    return states, events


@pytest.mark.parametrize("seed", [0, 3])
def test_lease_claim_requeue_match_reference(seed):
    want = _lease_script(JaxDispatcher, JaxPolicy, JaxTask, JaxRecorder,
                         seed)
    got = _lease_script(Dispatcher, DispatchPolicy, Task, Recorder, seed)
    assert got == want
    kinds = {k for k, *_ in got[1]}
    assert {"task_leased", "task_claimed", "task_requeued"} <= kinds
