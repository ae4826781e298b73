"""The port's CUDA kernels against their plain versions, on the card.

These tests need a CUDA card (a CUDA kernel has no CPU mode): they are
marked ``cuda`` and skip where ``torch.cuda.is_available()`` is False.  This
file imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q tests/test_torch_kernels_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mamba_scan import mamba_scan as ms
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref
from repro_torch.kernels.stacking import ops, stacking
from repro_torch.kernels.stacking.ref import stack_rois_ref

pytestmark = pytest.mark.cuda

SHAPES = [(8, 16, 16), (37, 24, 40), (100, 100, 100), (3, 8, 8),
          (8, 100, 100), (32, 100, 100), (300, 20, 33)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels are CUDA C++ "
                    "with no CPU mode")
    # the plain versions' fp32 products must be full fp32, not TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(n, h, w, seed, dev):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(500, 100, (n, h, w)), rng.normal(0, 10, n),
            rng.uniform(0.5, 1.5, n), rng.uniform(0, 1, n),
            rng.uniform(0, 1, n))
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("N,H,W", SHAPES)
def test_stacking_kernel_matches_plain(cuda, N, H, W, mean):
    arrs = _inputs(N, H, W, seed=N + H, dev=cuda)
    before = stacking.launches.value
    got = ops.stack_rois(*arrs, mean=mean)
    torch.cuda.synchronize()
    assert stacking.launches.value == before + 1
    assert got.device == cuda and got.dtype == torch.float32
    want = stack_rois_ref(*arrs)
    if mean:
        want = want / N
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_stacking_kernel_exact_sum_without_shift(cuda):
    rois = torch.arange(2 * 4 * 4, dtype=torch.float32,
                        device=cuda).reshape(2, 4, 4)
    z, o = torch.zeros(2, device=cuda), torch.ones(2, device=cuda)
    got = ops.stack_rois(rois, z, o, z, z, mean=False)
    assert torch.equal(got, rois.sum(0))


#: ROI counts around the kernel's group of 8 and its splits of N across
#: thread rows (1 group, 2, 4 or 8 rows), by image shapes around its
#: 64-pixel blocks and the edge rows and columns
GRID_N = [1, 7, 8, 9, 32, 33, 300]
GRID_HW = [(1, 1), (1, 100), (100, 1), (100, 100), (24, 40), (129, 257)]


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("H,W", GRID_HW)
@pytest.mark.parametrize("N", GRID_N)
def test_stacking_kernel_grid_matches_plain(cuda, N, H, W, mean):
    arrs = _inputs(N, H, W, seed=N + H + W, dev=cuda)
    got = stacking.stack_rois_fwd(*arrs, mean=mean)
    want = stack_rois_ref(*arrs)
    if mean:
        want = want / N
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


@pytest.mark.parametrize("shift", [0.0, 0.5])
@pytest.mark.parametrize("H,W", GRID_HW)
def test_stacking_kernel_edges_repeat_row_and_column_zero(cuda, H, W, shift):
    """One hot pixel in each corner and one on the last pixel of every
    64-pixel block (the next block reads it as a neighbour): with dy = dx
    in {0, 1/2} every weight and sum is exact in fp32, so the kernel must
    give the plain version's bits, row 0 and column 0 repeated at the
    edge."""
    roi = torch.zeros(1, H, W, device=cuda)
    for r, c in ((0, 0), (0, W - 1), (H - 1, 0), (H - 1, W - 1)):
        roi[0, r, c] = 1.0
    roi.view(-1)[63::64] = 1.0
    z, o = torch.zeros(1, device=cuda), torch.ones(1, device=cuda)
    f = torch.full((1,), shift, device=cuda)
    got = stacking.stack_rois_fwd(roi, z, o, f, f)
    want = stack_rois_ref(roi, z, o, f, f)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_stacking_kernel_refuses_mixed_devices(cuda):
    arrs = _inputs(3, 8, 8, seed=0, dev=cuda)
    arrs[1] = arrs[1].cpu()
    with pytest.raises(ValueError, match="sky"):
        stacking.stack_rois_fwd(*arrs)


def test_flat_path_launches_once_per_task(cuda):
    from repro_torch.apps import astro
    from repro_torch.experiments import RuntimeEngine

    eng = RuntimeEngine(device="cuda").prepare(astro.flat_spec(64, 4, 8))
    try:
        before = stacking.launches.value
        one_call = stacking.coadd_calls.value
        rep = eng.run(task_fn=astro.stack_object,
                      payload_factory=astro.make_tiles, timeout=120.0)
        torch.cuda.synchronize()
        assert stacking.launches.value - before == rep.n_completed == 64
        assert stacking.coadd_calls.value - one_call == 64
        for w in eng.runtime.workers.values():
            assert all(p.device == cuda for p in w.payloads.values())
    finally:
        eng.shutdown()


#: (N, H, W, file ids) of the one-call coadd: one tile, the CLI's file,
#: the benchmark's file, one prep launch's worth of tiles and one more, a
#: 2-file join, a plane the prep kernel reads one float at a time, and a
#: join of many files (17 prep launches)
COADD_CASES = [(1, 100, 100, [5]), (8, 100, 100, [17]),
               (150, 100, 100, [4647]), (256, 16, 16, [9]),
               (257, 16, 16, [10]), (300, 100, 100, [4647, 9295]),
               (150, 21, 33, [3]), (4100, 16, 16, list(range(41)))]


def _scratch(out, n):
    """sky, cal, dy, dx as the one-call coadd left them after its output."""
    h, w = out.shape
    flat = torch.empty(0, device=out.device).set_(out.untyped_storage())
    return flat[h * w:h * w + 4 * n].view(4, n)


@pytest.mark.parametrize("N,H,W,ids", COADD_CASES)
def test_one_call_coadd_matches_the_launches_it_replaces(cuda, N, H, W, ids):
    """The one-call coadd against the same coadd made the former way
    (``coadd_params`` and the stacking kernel) and against the plain
    version, at the kernel's tolerance; its scratch holds the sky means,
    unit cals and the request's exact shifts, across prep launches too; it
    counts one stacking launch and one one-call coadd."""
    from repro_torch.apps import astro

    tiles = _inputs(N, H, W, seed=N + H, dev=cuda)[0]
    counters = (stacking.launches, stacking.coadd_calls)
    before = [c.value for c in counters]
    got = stacking.coadd_fwd(tiles, astro.draw_shifts(ids, N),
                             astro.SKY_FRACTION)
    after = [c.value for c in counters]
    assert [a - b for a, b in zip(after, before)] == [1, 1]
    params = astro.coadd_params(tiles, ids)
    former = ops.stack_rois(tiles, *params)
    plain = stack_rois_ref(tiles, *params) / N
    torch.cuda.synchronize()
    assert got.shape == (H, W) and got.dtype == torch.float32
    for want in (former, plain):
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    sky, cal, dy, dx = _scratch(got, N)
    torch.testing.assert_close(sky, params[0], rtol=1e-5, atol=0)
    assert torch.equal(cal, params[1])
    assert torch.equal(dy, params[2]) and torch.equal(dx, params[3])


def test_one_call_coadd_takes_its_sky_fraction(cuda):
    """The sky fraction is the caller's: 0 leaves the tiles uncalibrated,
    and another fraction gives that fraction of each mean."""
    from repro_torch.apps import astro

    tiles = _inputs(40, 24, 24, seed=2, dev=cuda)[0]
    shifts = astro.draw_shifts([2], 40)
    means = tiles.mean(dim=(1, 2))
    for fraction in (0.0, 0.35):
        got = stacking.coadd_fwd(tiles, shifts, fraction)
        sky = _scratch(got, 40)[0]
        torch.testing.assert_close(sky, means * fraction, rtol=1e-5, atol=0)
        dy, dx = torch.from_numpy(shifts).to(cuda)
        want = stack_rois_ref(tiles, means * fraction, torch.ones_like(dy),
                              dy, dx) / 40
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))


def test_stack_object_on_the_card_never_synchronises(cuda):
    """``stack_object`` on the card under the sync debug mode's "error":
    no synchronising call, at one file and at a 2-file join (two prep
    launches).  The former coadd, whose shifts were a blocking
    copy from pageable memory, raises under the same mode."""
    from repro_torch.apps import astro

    tiles = _inputs(150, 100, 100, seed=1, dev=cuda)[0]
    stacking._coadd_entry()          # the build and load, outside the mode
    astro.stack_object({"img7": tiles})
    torch.cuda.synchronize()
    before = (stacking.launches.value, stacking.coadd_calls.value)
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = [astro.stack_object({f"img{i}": tiles}) for i in range(8)]
        joined = astro.stack_object({"img8": tiles, "img9": tiles})
        with pytest.raises(RuntimeError, match="synchroniz"):
            ops.stack_rois(tiles, *astro.coadd_params(tiles, [7]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert (stacking.launches.value - before[0],
            stacking.coadd_calls.value - before[1]) == (9, 9)
    for i, got in enumerate(outs):
        want = stack_rois_ref(tiles, *astro.coadd_params(tiles, [i])) / 150
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    both = torch.cat([tiles, tiles])
    want = stack_rois_ref(both, *astro.coadd_params(both, [8, 9])) / 300
    torch.testing.assert_close(joined, want, rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_elastic_release_gives_device_memory_back(cuda):
    """The provisioner grows a one-executor pool under a burst of stacking
    tasks; then every idle executor but one is released, and the card's
    allocated memory falls by at least the bytes of the storages only
    those executors cached."""
    import time

    from repro_torch.apps import astro
    from repro_torch.experiments import ProvisionerSpec, RuntimeEngine

    prov = ProvisionerSpec(policy="exponential", min_executors=1,
                           max_executors=8, queue_threshold=1,
                           idle_timeout_s=60.0, trigger_cooldown_s=0.0,
                           period_s=0.02)
    spec = astro.elastic_spec(200, 40, {"kind": "BatchArrivals", "at_s": 0.0},
                              prov)
    eng = RuntimeEngine(device="cuda").prepare(spec)
    try:
        before = stacking.launches.value
        rep = eng.run(task_fn=astro.decode_and_stack,
                      payload_factory=astro.make_tiles, timeout=120.0)
        torch.cuda.synchronize()
        rt = eng.runtime
        assert rep.n_completed == 200 and rep.n_failed == 0
        assert rep.n_allocated > 0 and len(rt.workers) > 1
        assert eng.provision_failures == []
        assert (stacking.launches.value - before
                == rep.n_completed + rt.dropped_attempts)
        with rt._lock:
            idle = rt.provision_idle(time.monotonic(), 0.0)
        release = idle[:len(idle) - 1]
        freed = rt.exclusive_cache_bytes(release)
        allocated = torch.cuda.memory_allocated()
        rt.provision_release(release)
        assert len(rt.workers) == 1 and freed > 0
        assert allocated - torch.cuda.memory_allocated() >= freed
    finally:
        eng.shutdown()


def test_release_while_a_stacking_task_runs_reruns_it(cuda):
    """An executor released while its stacking task runs: the dispatcher
    re-queues the task, the retry completes on the other executor, and the
    released attempt still launches the kernel, so the kernel launches
    once per completed task plus once per dropped attempt; the coadd is
    the plain version's."""
    import time

    from repro_torch.core.objects import DataObject, Task
    from repro_torch.core.runtime import DiffusionRuntime

    tiles, sky, cal, dy, dx = _inputs(8, 100, 100, seed=7, dev="cpu")

    def slow_stack(inputs):
        time.sleep(0.3)
        return ops.stack_rois(inputs["a"], *(t.to(cuda)
                                              for t in (sky, cal, dy, dx)),
                              mean=False)

    rt = DiffusionRuntime(n_executors=2, device="cuda")
    try:
        rt.put_object(DataObject("a", tiles.numel() * 4), tiles.numpy())
        before = stacking.launches.value
        task = Task(inputs=("a",), fn=slow_stack)
        rt.submit([task])
        deadline = time.monotonic() + 10.0
        running = []
        while not running and time.monotonic() < deadline:
            time.sleep(0.01)
            with rt._lock:
                running = [e for e, st in rt.dispatcher.executors.items()
                           if task.tid in st.running]
        assert running, "the task never started"
        rt.remove_executor(running[0])
        assert rt.wait(30.0)
        while rt.dropped_attempts < 1 and time.monotonic() < deadline:
            time.sleep(0.01)     # the released attempt runs on to its end
        torch.cuda.synchronize()
        completed = len(rt.dispatcher.completed)
        assert completed == 1 and rt.dropped_attempts >= 1
        assert (stacking.launches.value - before
                == completed + rt.dropped_attempts)
        want = stack_rois_ref(*(t.to(cuda) for t in (tiles, sky, cal, dy,
                                                      dx)))
        got = task.result
        assert got.device == cuda
        torch.testing.assert_close(got, want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
    finally:
        rt.shutdown()


def test_fleet_runs_stacking_in_its_hosts_on_the_card(cuda):
    """A 2 x 2 fleet on the card runs stacking tasks inside its host
    processes: every host launches the kernel once per task it completed
    (its own counter, read through its stats frames), and each coadd,
    fetched from the cache of the executor that ran it through its host's
    peer server, equals the plain version on the card."""
    import dataclasses

    from repro_torch.apps import astro
    from repro_torch.experiments import ObserveSpec, RuntimeEngine
    from repro_torch.fleet.host import PeerClient

    base = astro.flat_spec(32, 4, 4)
    spec = dataclasses.replace(
        base, hosts=2, threads_per_host=2,
        workload=dataclasses.replace(base.workload,
                                     output_bytes=astro.H * astro.W * 4),
        observe=ObserveSpec(metrics=True, metrics_interval_s=0.25))
    eng = RuntimeEngine(task_fn_name="repro_torch.apps.astro:stack_object",
                        device="cuda").prepare(spec)
    client = PeerClient(eng.runtime.manager.codec)
    try:
        rep = eng.run(payload_factory=astro.make_tiles, timeout=180.0)
        rt = eng.runtime
        assert rep.n_completed == 32 and rep.n_failed == 0
        hosts = rt.manager.cluster.per_host()
        launched = sum(h["metrics"]["gauges"]["kernel.stack_rois.launches"]
                       for h in hosts.values())
        assert len(hosts) == 2 and launched == rep.n_completed
        assert all(h["metrics"]["gauges"]["device.memory_allocated"] > 0
                   for h in hosts.values())
        for t in rt.dispatcher.completed:
            host = rt.workers[t.executor].host
            got = client.fetch((host.peer_host, host.peer_port), t.executor,
                               f"{t.tid}.out").to(cuda)
            tiles = torch.cat([rt.store.get(oid)[1].to(cuda)
                               for oid in t.inputs])
            want = stack_rois_ref(
                tiles, *astro.coadd_params(tiles, [int(o[3:])
                                                   for o in t.inputs]))
            want = want / tiles.shape[0]
            torch.testing.assert_close(got, want, rtol=1e-5,
                                       atol=1e-5 * float(want.abs().max()))
    finally:
        client.close()
        eng.shutdown()


def test_fleet_refuses_cuda_where_there_is_none():
    """Runs on every machine: without a card, a fleet on the default
    device raises at construction, before any host is spawned."""
    from repro_torch.fleet import FleetRuntime

    if torch.cuda.is_available():
        rt = FleetRuntime(hosts=0)        # the default device is the card
        try:
            assert rt.device.type == "cuda"
        finally:
            rt.shutdown()
        return
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        FleetRuntime(hosts=2, threads_per_host=2, device="cuda")


def test_serve_over_diffusion_holds_stamped_pages_on_the_card(cuda):
    """A small sessions binding through the serve engine on the card, each
    KV page a host ``uint8`` tensor stamped with its index: every input a
    request reads is on the card, has the page's bytes and its stamp; the
    replicas' caches hold device tensors; kv_summary and placements are
    the CPU shape-only run's."""
    from repro_torch.experiments import build_workload
    from repro_torch.serve.diffusion import (ServeDiffusionEngine,
                                             kv_summary, session_spec)

    binding = {"kind": "chat", "n_sessions": 24, "turns_per_session": 3,
               "kv_bytes_per_token": 256, "block": 16, "think_time_s": 0.0,
               "turn_seconds": 0.0,
               "arrivals": {"kind": "BatchArrivals", "at_s": 0.0}}
    spec = session_spec("card-pages", binding, n_replicas=3,
                        replica_cache_bytes=24 * 4096, seed=1)
    objects = build_workload(spec.workload).objects
    index = {ob.oid: i for i, ob in enumerate(objects)}
    page = objects[0].size_bytes

    def make_page(ob):
        t = torch.zeros(ob.size_bytes, dtype=torch.uint8)
        t[:16] = torch.tensor(list(index[ob.oid].to_bytes(16, "little")),
                              dtype=torch.uint8)
        return t

    def check(inputs):
        for oid, t in inputs.items():
            assert t.device == cuda and t.numel() == page
            assert int.from_bytes(bytes(t[:16].tolist()), "little") \
                == index[oid]

    runs = {}
    for device in ("cuda", "cpu"):
        eng = ServeDiffusionEngine(device=device)
        try:
            eng.prepare(spec)
            if device == "cuda":
                rep = eng.run(task_fn=check, payload_factory=make_page,
                              barrier_every=1, timeout=120.0)
                # batch-synchronous, an all-idle pool places each request
                # on the replica caching most of it: the caches that hold
                # pages hold them on the card
                held = [p for w in eng.runtime.workers.values()
                        for p in w.payloads.values()]
                assert held and all(p.device == cuda and p.numel() == page
                                    for p in held)
            else:
                rep = eng.run(barrier_every=1, timeout=120.0)
            runs[device] = (rep, {t.tid: t.executor for t in
                                  eng.runtime.dispatcher.completed})
        finally:
            eng.shutdown()
    (rep, placed), (cpu_rep, cpu_placed) = runs["cuda"], runs["cpu"]
    assert rep.n_failed == 0 and rep.n_completed == 72
    assert kv_summary(rep) == kv_summary(cpu_rep)
    assert placed == cpu_placed


# --------------------------- flash attention ---------------------------------

FA_CASES = [
    # (B, S, H, KV, D, causal, window, softcap, dtype): the reference's
    # eight (tests/test_kernels.py), then the serving path's shape, then
    # widths and lengths the reference does not reach
    (2, 64, 4, 2, 16, True, 0, 0.0, torch.float32),
    (1, 128, 8, 2, 32, True, 32, 0.0, torch.float32),
    (2, 64, 4, 4, 24, True, 0, 50.0, torch.float32),
    (1, 256, 4, 1, 16, True, 0, 0.0, torch.float32),
    (2, 96, 4, 2, 16, True, 0, 0.0, torch.float32),
    (1, 64, 4, 2, 16, False, 0, 0.0, torch.float32),
    (2, 64, 4, 2, 16, True, 16, 30.0, torch.float32),
    (2, 64, 8, 8, 16, True, 0, 0.0, torch.bfloat16),
    (8, 96, 32, 8, 120, True, 4096, 0.0, torch.bfloat16),
    (1, 100, 4, 2, 120, True, 0, 0.0, torch.float32),
    (1, 77, 2, 1, 256, False, 0, 0.0, torch.float32),
    (2, 200, 4, 2, 64, True, 50, 30.0, torch.bfloat16),
    (1, 300, 2, 2, 1, False, 70, 0.0, torch.float32),
    # bf16 that the tensor-core kernel does not take: the SIMT kernel's
    # bf16 instantiation (head_dim not a multiple of 8, or above 128)
    (1, 77, 4, 2, 20, True, 0, 0.0, torch.bfloat16),
    (2, 130, 4, 1, 136, True, 64, 30.0, torch.bfloat16),
    (1, 90, 2, 2, 256, False, 0, 0.0, torch.bfloat16),
]


def _fa_inputs(b, s, h, kv, d, dtype, dev, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, np.float32))
            .to(dev, dtype) for shape in ((b, s, h, d), (b, s, kv, d),
                                          (b, s, kv, d))]


@pytest.mark.parametrize("B,S,H,KV,D,causal,window,softcap,dtype", FA_CASES)
def test_flash_kernel_matches_plain(cuda, B, S, H, KV, D, causal, window,
                                    softcap, dtype):
    q, k, v = _fa_inputs(B, S, H, KV, D, dtype, cuda, seed=S + D)
    path = fa.kernel_path(*(t.transpose(1, 2) for t in (q, k, v)))
    assert path == ("simt" if dtype == torch.float32 or D % 8 or D > 128
                    else "wgmma")
    before = fa.launches.value
    before_path = fa.path_launches[path].value
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    torch.cuda.synchronize()
    assert fa.launches.value == before + 1
    assert fa.path_launches[path].value == before_path + 1
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         softcap=softcap).transpose(1, 2)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_flash_kernel_rows_without_a_valid_key_are_zero(cuda):
    """Sq > Sk under a causal window: rows q >= Sk + window - 1 see no key."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32)).to(cuda)
               for s in ((1, 4, 130, 40), (1, 2, 40, 40), (1, 2, 40, 40)))
    got = fa.flash_attention_fwd(q, k, v, causal=True, window=16)
    want = attention_ref(q, k, v, causal=True, window=16)
    torch.cuda.synchronize()
    assert bool((want[:, :, 55:] == 0).all())
    torch.testing.assert_close(got, want, atol=2e-5, rtol=2e-5)


# the tensor-core kernel: bf16, head_dim a multiple of 8 up to 128
TC_D = [64, 120, 128]
TC_S = [1, 63, 96, 200, 1000]
TC_GROUP = [1, 4, 8]
TC_WINDOW = [0, 32, 4096]          # 4096 >= every S: the window never binds
TC_SOFTCAP = [0.0, 50.0]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("softcap", TC_SOFTCAP)
@pytest.mark.parametrize("window", TC_WINDOW)
@pytest.mark.parametrize("group", TC_GROUP)
@pytest.mark.parametrize("S", TC_S)
@pytest.mark.parametrize("D", TC_D)
def test_flash_tensor_core_kernel_matches_plain(cuda, D, S, group, window,
                                                softcap, causal):
    kv = 2
    q, k, v = _fa_inputs(2, S, kv * group, kv, D, torch.bfloat16, cuda,
                         seed=S * 7 + D + group)
    args = [t.transpose(1, 2) for t in (q, k, v)]
    assert fa.kernel_path(*args) == "wgmma"
    before = fa.path_launches["wgmma"].value
    got = fa.flash_attention_fwd(*args, causal=causal, window=window,
                                 softcap=softcap)
    torch.cuda.synchronize()
    assert fa.path_launches["wgmma"].value == before + 1
    want = attention_ref(*args, causal=causal, window=window,
                         softcap=softcap)
    assert got.dtype == torch.bfloat16 and got.stride() == args[0].stride()
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_tensor_core_rows_without_a_valid_key_are_zero(cuda):
    """bf16 at head_dim 128, Sq > Sk under a causal window: rows
    q >= Sk + window - 1 see no key and are exactly 0."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               .to(cuda, torch.bfloat16)
               for s in ((1, 4, 300, 128), (1, 2, 40, 128), (1, 2, 40, 128)))
    assert fa.kernel_path(q, k, v) == "wgmma"
    got = fa.flash_attention_fwd(q, k, v, causal=True, window=16)
    want = attention_ref(q, k, v, causal=True, window=16)
    torch.cuda.synchronize()
    assert bool((got[:, :, 55:] == 0).all())
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_tensor_core_takes_strided_views_uncopied(cuda):
    """q, k, v as head slices of one fused (B,S,H+2KV,D) projection go in
    as they are: the kernel reads them in place (a write to the projection
    shows in the result) and matches the plain version."""
    qkv = _fa_inputs(2, 150, 8 + 2 * 2, 1, 120, torch.bfloat16, cuda,
                     seed=11)[0]
    q, k, v = (qkv[:, :, a:b].transpose(1, 2)
               for a, b in ((0, 8), (8, 10), (10, 12)))
    assert not q.is_contiguous() and fa.kernel_path(q, k, v) == "wgmma"
    got = fa.flash_attention_fwd(q, k, v, causal=True, window=64)
    torch.testing.assert_close(
        got.float(), attention_ref(q, k, v, causal=True, window=64).float(),
        atol=2e-2, rtol=2e-2)
    qkv[:, :, 10:12] = 0            # v = 0: the output must follow
    torch.testing.assert_close(
        fa.flash_attention_fwd(q, k, v, causal=True, window=64).float(),
        torch.zeros(q.shape, device=cuda), atol=0, rtol=0)


def _misaligned(t):
    """t's values in a copy whose storage starts one element (2 bytes)
    past a 16-byte boundary, as a (B,H,S,D) view of (B,S,H,D)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out.transpose(1, 2)


@pytest.mark.parametrize("layout", ["misaligned", "broadcast kv"])
def test_flash_kernel_bf16_that_tma_cannot_read_takes_simt(cuda, layout):
    """bf16 at head_dim 120 that TMA cannot read as it lies -- a storage
    offset off 16 bytes, or k and v expanded along the batch (stride 0)
    -- goes to the SIMT kernel uncopied and matches the plain version."""
    q, k, v = _fa_inputs(3, 150, 8, 2, 120, torch.bfloat16, cuda, seed=12)
    if layout == "misaligned":
        args = [_misaligned(t) for t in (q, k, v)]
        assert all(t.data_ptr() % 16 for t in args)
    else:
        args = [q.transpose(1, 2)] + [
            t[:1].transpose(1, 2).expand(3, -1, -1, -1) for t in (k, v)]
        assert args[1].stride(0) == 0
    assert fa.kernel_path(*args) == "simt"
    before = fa.path_launches["simt"].value
    got = fa.flash_attention_fwd(*args, causal=True, window=64,
                                 softcap=30.0)
    torch.cuda.synchronize()
    assert fa.path_launches["simt"].value == before + 1
    want = attention_ref(*args, causal=True, window=64, softcap=30.0)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_kernel_path_counters_move(cuda):
    """A bf16 call at head_dim 120 counts as wgmma, an fp32 one as simt;
    both count in ``launches``."""
    before = {p: c.value for p, c in fa.path_launches.items()}
    total = fa.launches.value
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = _fa_inputs(1, 70, 4, 2, 120, dtype, cuda)
        fa_ops.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert fa.path_launches["wgmma"].value == before["wgmma"] + 1
    assert fa.path_launches["simt"].value == before["simt"] + 1
    assert fa.launches.value == total + 2


def test_flash_kernel_q_chunked_plain_version_agrees(cuda):
    q, k, v = _fa_inputs(1, 1000, 4, 2, 120, torch.bfloat16, cuda, seed=9)
    args = [t.transpose(1, 2) for t in (q, k, v)]
    whole = attention_ref(*args, causal=True, window=300)
    chunked = attention_ref(*args, causal=True, window=300, q_chunk=256)
    got = fa.flash_attention_fwd(*args, causal=True, window=300)
    torch.testing.assert_close(chunked, whole, atol=0, rtol=0)
    torch.testing.assert_close(got.float(), whole.float(), atol=2e-2,
                               rtol=2e-2)


def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _fa_inputs(1, 8, 2, 1, 16, torch.float32, cuda)
    args = [t.transpose(1, 2) for t in (q, k, v)]
    with pytest.raises(ValueError, match="k is on cpu"):
        fa.flash_attention_fwd(args[0], args[1].cpu(), args[2])
    with pytest.raises(TypeError, match="float16"):
        fa.flash_attention_fwd(*(t.half() for t in args))
    big = torch.zeros(1, 2, 8, 264, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_fwd(big, big[:, :1], big[:, :1])


@pytest.mark.parametrize("causal,window,softcap",
                         [(True, 0, 0.0), (True, 32, 30.0), (False, 0, 0.0)])
def test_flash_op_takes_fp16_as_the_reference(cuda, causal, window, softcap):
    """fp16 q/k/v: the op runs them in fp32 (the SIMT kernel) and returns
    fp16, as the reference's kernel does.  Held to the plain version on the
    same inputs at the fp32 tolerance, plus one fp16 rounding of each side
    (rtol 2e-5 + 2^-10)."""
    q, k, v = _fa_inputs(2, 96, 8, 2, 64, torch.float16, cuda, seed=4)
    before = {p: c.value for p, c in fa.path_launches.items()}
    got = fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                 softcap=softcap)
    torch.cuda.synchronize()
    assert {p: c.value - before[p] for p, c in fa.path_launches.items()} \
        == {"wgmma": 0, "simt": 1}
    assert got.dtype == torch.float16 and got.shape == q.shape
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=causal, window=window,
                         softcap=softcap).transpose(1, 2)
    assert want.dtype == torch.float16
    torch.testing.assert_close(got.float(), want.float(), atol=2e-5,
                               rtol=2e-5 + 2.0 ** -10)


def test_kernels_refuse_inputs_that_require_grad(cuda):
    """Both forward-only kernels raise on a tensor that requires grad while
    grad mode is on, and run under no_grad."""
    q, k, v = (t.transpose(1, 2) for t in
               _fa_inputs(1, 8, 2, 1, 16, torch.float32, cuda))
    q.requires_grad_()
    with pytest.raises(RuntimeError, match="q require grad"):
        fa.flash_attention_fwd(q, k, v)
    with torch.no_grad():
        fa.flash_attention_fwd(q, k, v)
    arrs = _ms_inputs(1, 8, 16, 4, cuda, seed=6)
    arrs["dt"].requires_grad_()
    with pytest.raises(RuntimeError, match="dt require grad"):
        ms.mamba_scan_fwd(**arrs)
    with torch.no_grad():
        ms.mamba_scan_fwd(**arrs)
    torch.cuda.synchronize()


def test_train_step_on_the_card_trains_the_attention_weights(cuda):
    """A one-layer h2o-danube-3-4b (reduced widths, bf16) on the card: the
    loss's backward launches the flash kernel twice (the forward and the
    remat recompute, both on tensor cores), every attention weight gets a
    finite, non-zero gradient that agrees with the plain ``ref``
    attention's within 2e-2 of its max|g|, and a train step runs."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import make_loss_fn, make_train_step
    from repro_torch.train import adamw

    cfg = get_config("h2o-danube-3-4b").reduced().with_(n_layers=1,
                                                        attn_impl="flash")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda,
                           dtype=torch.int32)
    names = ("wq", "wk", "wv", "wo")
    leaves = [params["blocks"]["sub0"][n].requires_grad_() for n in names]
    grads = {}
    for impl in ("flash", "ref"):
        before = fa.launches.value
        before_tc = fa.path_launches["wgmma"].value
        loss = make_loss_fn(cfg.with_(attn_impl=impl))(params,
                                                       {"tokens": tokens})
        grads[impl] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        n = 2 if impl == "flash" else 0
        assert fa.launches.value - before == n
        assert fa.path_launches["wgmma"].value - before_tc == n
    for name, g, want in zip(names, grads["flash"], grads["ref"]):
        assert g.dtype == torch.bfloat16
        assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, \
            name
        torch.testing.assert_close(g.float(), want.float(), rtol=0,
                                   atol=2e-2 * float(want.abs().max()))
    opt = adamw(1e-3, warmup=1, total=10)
    state, metrics = make_train_step(cfg, opt)(opt.init(params),
                                               {"tokens": tokens})
    assert bool(torch.isfinite(metrics["loss"])) and int(metrics["step"]) == 1
    for n in names:
        assert float(state.m["blocks"]["sub0"][n].abs().max()) > 0, n


def test_serve_forward_launches_flash_once_per_layer(cuda):
    """The bf16 forward of reduced h2o-danube-3-4b launches the flash
    kernel once per layer, each time on the tensor-core path; its logits
    agree with the plain ``ref`` attention's within 2e-2 of max|logit|, and
    each layer's attention block, flash against ref on the flash forward's
    own hidden states, within 2e-2 of max|output|."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_forward
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg = get_config("h2o-danube-3-4b").reduced().with_(attn_impl="flash")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda)
    before = fa.launches.value
    before_tc = fa.path_launches["wgmma"].value
    logits, _ = make_forward(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert fa.launches.value - before == cfg.n_layers
    assert fa.path_launches["wgmma"].value - before_tc == cfg.n_layers
    ref, _ = make_forward(cfg.with_(attn_impl="ref"))(params,
                                                      {"tokens": tokens})
    scale = float(ref.abs().max())
    torch.testing.assert_close(logits, ref, atol=2e-2 * scale, rtol=0)
    spec = cfg.pattern[0]
    with torch.inference_mode():
        x = T.embed_inputs(cfg, params, {"tokens": tokens})
        pos = torch.arange(x.shape[1], device=cuda)
        for i in range(cfg.n_blocks):
            p = T._layer(params["blocks"]["sub0"], i)
            h = T._norm(cfg, x, p, "ln1")
            var = T._variant(cfg, spec)
            got, want = (L.attention_block(h, p, pos, var, cfg.rope_theta,
                                           impl=impl)
                         for impl in ("flash", "ref"))
            torch.testing.assert_close(
                got, want, atol=2e-2 * float(want.abs().max()), rtol=0)
            x, _ = T._apply_sub(cfg, spec, x, p, pos)


def test_encdec_forward_launches_flash_per_self_attention(cuda, monkeypatch):
    """The bf16 forward of reduced whisper-base with flash launches the
    kernel once per encoder layer (unmasked) and once per decoder layer
    (causal), each on the tensor-core path, and never for the
    cross-attention, which takes the plain path as in the reference; its
    logits agree with the plain ``ref`` attention's within 2e-2 of
    max|logit|."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_forward

    cfg = get_config("whisper-base").reduced().with_(attn_impl="flash")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    gen = torch.Generator(cuda).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     device=cuda, generator=gen),
             "frame_embeds": torch.randn(
                 (2, 150, cfg.d_model), device=cuda, generator=gen,
                 dtype=torch.bfloat16) / cfg.vocab_size ** 0.5}
    masks = []
    real = fa_ops.flash_attention_fwd

    def recording(q, k, v, causal=True, **kw):
        masks.append(causal)
        return real(q, k, v, causal=causal, **kw)
    monkeypatch.setattr(fa_ops, "flash_attention_fwd", recording)
    before = fa.launches.value
    before_tc = fa.path_launches["wgmma"].value
    logits, _ = make_forward(cfg)(params, batch)
    torch.cuda.synchronize()
    n = cfg.enc_layers + cfg.n_layers
    assert fa.launches.value - before == n
    assert fa.path_launches["wgmma"].value - before_tc == n
    assert masks == [False] * cfg.enc_layers + [True] * cfg.n_layers
    ref, _ = make_forward(cfg.with_(attn_impl="ref"))(params, batch)
    scale = float(ref.abs().max())
    torch.testing.assert_close(logits, ref, atol=2e-2 * scale, rtol=0)


def test_vision_forward_launches_flash_once_per_layer(cuda):
    """The bf16 forward of reduced llava-next-mistral-7b with its patch
    embeddings spliced in launches the kernel once per layer on the
    tensor-core path, and agrees with the plain ``ref`` attention's
    within 2e-2 of max|logit|."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_forward

    cfg = get_config("llava-next-mistral-7b").reduced().with_(
        attn_impl="flash")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    gen = torch.Generator(cuda).manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 24),
                                     device=cuda, generator=gen),
             "image_embeds": torch.randn(
                 (2, cfg.num_frontend_tokens, cfg.d_model), device=cuda,
                 generator=gen, dtype=torch.bfloat16) / cfg.vocab_size ** 0.5}
    before = fa.launches.value
    before_tc = fa.path_launches["wgmma"].value
    logits, _ = make_forward(cfg)(params, batch)
    torch.cuda.synchronize()
    assert fa.launches.value - before == cfg.n_layers
    assert fa.path_launches["wgmma"].value - before_tc == cfg.n_layers
    ref, _ = make_forward(cfg.with_(attn_impl="ref"))(params, batch)
    torch.testing.assert_close(logits, ref, atol=2e-2 * float(
        ref.abs().max()), rtol=0)


def test_serve_engine_forward_matches_decode_replay(cuda):
    """The launcher's traffic on reduced h2o-danube-3-4b in fp32 on the
    card: one flash launch per layer per wave, and each wave's forward
    logits equal the decode replay's at every request's last prompt
    position (at full width the random weights are too sharp for an end
    to end comparison; here they are not)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch

    cfg = get_config("h2o-danube-3-4b").reduced().with_(
        attn_impl="flash", dtype="float32")
    before = fa.launches.value
    eng, done = launch.serve(cfg, 16, 2, "max-compute-util", 4, 0, cuda)
    torch.cuda.synchronize()
    assert fa.launches.value - before == cfg.n_layers * len(eng.waves) == 4
    assert all(len(r.output) == 4 for r in done)
    for w in eng.waves:
        scale = float(w.prefill_logits.abs().max())
        torch.testing.assert_close(w.replay_logits, w.prefill_logits,
                                   atol=1e-4 * scale, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_block_matches_onehot_on_the_card(cuda, dtype):
    """qwen3's router (128 experts, top-8) at narrow widths on a padded
    wave's 768 tokens: the sort+gather ``moe_block`` drops the pairs the
    one-hot formulation drops and matches it (within 1e-5 of max|output|
    in fp32, 2e-2 in bf16), with the same aux loss."""
    from repro_torch.models import moe as M

    g = torch.Generator(cuda).manual_seed(5)
    tdt = getattr(torch, dtype)
    E, D, F, k = 128, 256, 64, 8
    x = torch.randn(8, 96, D, generator=g, device=cuda)
    x[:, 40:] = x[:, 40:41]          # padding: one repeated token per row
    p = {"w_router": torch.randn(D, E, generator=g, device=cuda),
         "w_gate": torch.randn(E, D, F, generator=g, device=cuda) / 16,
         "w_up": torch.randn(E, D, F, generator=g, device=cuda) / 16,
         "w_down": torch.randn(E, F, D, generator=g, device=cuda) / 8}
    x = x.to(tdt)
    p = {n: (t if n == "w_router" else t.to(tdt)) for n, t in p.items()}
    got, aux = M.moe_block(x, p, k)
    want, aux1 = M.moe_block_onehot(x, p, k)
    tol = 1e-5 if dtype == "float32" else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=0,
                               atol=tol * float(want.float().abs().max()))
    torch.testing.assert_close(aux, aux1, rtol=1e-6, atol=0)
    xt = x.reshape(-1, D)
    gates, idx = M.router_probs(xt, p["w_router"], k)
    cap = M.capacity(xt.shape[0], E, k, 1.25)
    _, (_, _, in_cap) = M._local_route(xt, gates, idx, E, cap)
    onehot = torch.nn.functional.one_hot(idx, E).reshape(-1, E)
    pos = ((onehot.cumsum(0) - onehot) * onehot).sum(-1)
    assert torch.equal(in_cap, pos < cap)
    assert int((~in_cap).sum()) > 0     # the padding overflows capacity


def test_moe_serve_engine_forward_matches_decode_replay(cuda):
    """Reduced qwen3-moe in fp32 on the card, through the launcher's code
    path, at a capacity factor that drops no pair in the forward or in
    decode: one flash launch per layer per wave, and each wave's forward
    logits equal the decode replay's (so with no drop, MoE serving is as
    exact as the dense model's)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch

    cfg = get_config("qwen3-moe-30b-a3b").reduced().with_(
        attn_impl="flash", dtype="float32", capacity_factor=4.0)
    before = fa.launches.value
    eng, done = launch.serve(cfg, 16, 2, "max-compute-util", 4, 0, cuda)
    torch.cuda.synchronize()
    assert fa.launches.value - before == cfg.n_layers * len(eng.waves) == 4
    assert all(len(r.output) == 4 for r in done)
    for w in eng.waves:
        scale = float(w.prefill_logits.abs().max())
        torch.testing.assert_close(w.replay_logits, w.prefill_logits,
                                   atol=1e-4 * scale, rtol=1e-4)


def test_hybrid_forward_matches_plain_on_the_card(cuda):
    """Reduced jamba in fp32 (attention, Mamba, dense and MoE sub-layers):
    the forward with the flash and scan kernels launches each once per
    layer of its kind and gives the plain path's logits (ref attention,
    chunked scan) within 1e-3 of max|logit|."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_forward

    cfg = get_config("jamba-1.5-large-398b").reduced().with_(
        attn_impl="flash", use_mamba_kernel=True, dtype="float32")
    params = init_params(cfg, torch.Generator(cuda).manual_seed(1), cuda)
    toks = torch.randint(0, cfg.vocab_size, (4, 40), device=cuda,
                         generator=torch.Generator(cuda).manual_seed(2))
    fa0, ms0 = fa.launches.value, ms.launches.value
    with torch.inference_mode():
        got, aux = make_forward(cfg)(params, {"tokens": toks})
        torch.cuda.synchronize()
        n_fa, n_ms = fa.launches.value - fa0, ms.launches.value - ms0
        want, aux1 = make_forward(cfg.with_(
            attn_impl="ref", use_mamba_kernel=False))(params, {"tokens": toks})
    assert (n_fa, n_ms) == (2, 14)
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-3 * float(want.abs().max()))
    assert float(aux) > 0 and abs(float(aux) - float(aux1)) <= 1e-3 * float(
        aux1)


# --------------------------- selective scan ----------------------------------

MS_CASES = [
    # (B, S, I, N): the reference's four (tests/test_kernels.py), the
    # serving forward's shape at falcon-mamba-7b's widths, then one step,
    # a state size that is no power of two, and the largest state
    (1, 32, 16, 4),
    (2, 96, 48, 8),
    (2, 128, 64, 16),
    (1, 50, 24, 4),
    (8, 96, 8192, 16),
    (3, 1, 100, 16),
    (2, 70, 130, 5),
    (2, 33, 64, 32),
]
MS_TOL = dict(atol=2e-4, rtol=1e-3)   # the reference's (tests/test_kernels.py)


def _ms_inputs(b, s, i, n, dev, seed, h0=True):
    """The reference test's distributions: u, dt = softplus(normal),
    A = -exp(0.5·normal), Bm, Cm, D, and h0 = 0.05."""
    g = torch.Generator(dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev)

    arrs = {"u": normal(b, s, i),
            "dt": torch.nn.functional.softplus(normal(b, s, i)),
            "A": -torch.exp(normal(i, n) * 0.5), "Bm": normal(b, s, n),
            "Cm": normal(b, s, n), "D": normal(i)}
    if h0:
        arrs["h0"] = torch.full((b, i, n), 0.05, device=dev)
    return arrs


def _ms_close(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        torch.testing.assert_close(g, w, **MS_TOL)


@pytest.mark.parametrize("B,S,I,N", MS_CASES)
def test_scan_kernel_matches_plain(cuda, B, S, I, N):
    arrs = _ms_inputs(B, S, I, N, cuda, seed=S + I)
    before = ms.launches.value
    got = ms_ops.mamba_scan(**arrs)
    torch.cuda.synchronize()
    assert ms.launches.value == before + 1
    assert all(t.device == cuda and t.is_contiguous() for t in got)
    _ms_close(got, mamba_scan_ref(**arrs))


def test_scan_kernel_takes_column_slices_of_the_projection(cuda):
    """Bm and Cm as the model passes them: column slices of the fp32
    projection (B, S, R + 2N), uncopied; u a slice of a wider tensor."""
    b, s, i, n, r = 2, 40, 96, 16, 6
    arrs = _ms_inputs(b, s, i, n, cuda, seed=3)
    proj = torch.randn(b, s, r + 2 * n, device=cuda)
    wide = torch.randn(b, s, 2 * i, device=cuda)
    views = dict(arrs, u=wide[..., :i], Bm=proj[..., r: r + n],
                 Cm=proj[..., r + n:])
    assert not any(views[k].is_contiguous() for k in ("u", "Bm", "Cm"))
    got = ms.mamba_scan_fwd(**views)
    want = mamba_scan_ref(**{k: v.contiguous() for k, v in views.items()})
    torch.cuda.synchronize()
    _ms_close(got, want)


def test_scan_kernel_without_h0_is_a_zero_state(cuda):
    arrs = _ms_inputs(2, 77, 200, 16, cuda, seed=4, h0=False)
    got = ms.mamba_scan_fwd(**arrs)
    zero = ms.mamba_scan_fwd(**arrs, h0=torch.zeros(2, 200, 16, device=cuda))
    torch.cuda.synchronize()
    for g, z in zip(got, zero):
        assert torch.equal(g, z)
    _ms_close(got, mamba_scan_ref(**arrs))


def test_scan_kernel_state_chaining(cuda):
    """The two halves with h_last carried over as h0 give the whole."""
    arrs = _ms_inputs(1, 64, 16, 8, cuda, seed=5, h0=False)
    y_full, h_full = ms.mamba_scan_fwd(**arrs)
    first = {k: (v[:, :32] if v.dim() == 3 else v) for k, v in arrs.items()}
    second = {k: (v[:, 32:] if v.dim() == 3 else v) for k, v in arrs.items()}
    y1, h1 = ms.mamba_scan_fwd(**first)
    y2, h2 = ms.mamba_scan_fwd(**second, h0=h1)
    torch.cuda.synchronize()
    _ms_close((torch.cat([y1, y2], 1), h2), (y_full, h_full))


#: lengths around the kernel's 16-step chunks and long prefills, state
#: sizes of each template (and one that is no power of two), one batch row
#: and eight.  I leaves a ragged block on both paths: 99 with one row (u
#: and dt rows not 16-byte multiples, so copied 4 bytes at a time), 100
#: with eight (16 bytes at a time)
GRID_S = [1, 15, 16, 17, 96, 2047, 2048, 2049, 4100]
GRID_STATE = [4, 8, 13, 16, 32]
SCAN_PATHS = ["pair", "quad"]


@pytest.mark.parametrize("path", SCAN_PATHS)
@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("N", GRID_STATE)
@pytest.mark.parametrize("S", GRID_S)
def test_scan_kernel_grid_matches_plain_on_each_path(cuda, monkeypatch, S, N,
                                                     B, path):
    monkeypatch.setattr(ms, "kernel_path", lambda b, i: path)
    arrs = _ms_inputs(B, S, 99 if B == 1 else 100, N, cuda, seed=S + N + B)
    before = ms.path_launches[path].value
    got = ms.mamba_scan_fwd(**arrs)
    torch.cuda.synchronize()
    assert ms.path_launches[path].value == before + 1
    _ms_close(got, mamba_scan_ref(**arrs))


@pytest.mark.parametrize("path", SCAN_PATHS)
def test_scan_kernel_without_h0_is_a_zero_state_on_each_path(
        cuda, monkeypatch, path):
    monkeypatch.setattr(ms, "kernel_path", lambda b, i: path)
    arrs = _ms_inputs(8, 77, 200, 13, cuda, seed=8, h0=False)
    got = ms.mamba_scan_fwd(**arrs)
    zero = ms.mamba_scan_fwd(**arrs, h0=torch.zeros(8, 200, 13, device=cuda))
    torch.cuda.synchronize()
    for g, z in zip(got, zero):
        assert torch.equal(g, z)


@pytest.mark.parametrize("first,second", [("pair", "quad"),
                                          ("quad", "pair")])
def test_scan_kernel_state_chains_across_paths(cuda, monkeypatch, first,
                                               second):
    """A first part on one path, h_last carried over as h0 into the rest
    on the other, gives the whole."""
    arrs = _ms_inputs(2, 200, 300, 16, cuda, seed=9, h0=False)
    parts = [{k: (v[:, sl] if v.dim() == 3 else v) for k, v in arrs.items()}
             for sl in (slice(0, 77), slice(77, 200))]
    monkeypatch.setattr(ms, "kernel_path", lambda b, i: first)
    y1, h1 = ms.mamba_scan_fwd(**parts[0])
    monkeypatch.setattr(ms, "kernel_path", lambda b, i: second)
    y2, h2 = ms.mamba_scan_fwd(**parts[1], h0=h1)
    torch.cuda.synchronize()
    _ms_close((torch.cat([y1, y2], 1), h2), mamba_scan_ref(**arrs))


@pytest.mark.parametrize("B,S,path", [(8, 96, "pair"), (1, 300, "quad")])
def test_scan_kernel_path_counters_move(cuda, B, S, path):
    """falcon-mamba-7b's widths (I=8192, N=16): the serving waves take the
    two-lane layout, a one-row prefill the four-lane one; each launch
    counts once in ``launches`` and once under its path."""
    arrs = _ms_inputs(B, S, 8192, 16, cuda, seed=10, h0=False)
    assert ms.kernel_path(B, 8192) == path
    before = {p: c.value for p, c in ms.path_launches.items()}
    total = ms.launches.value
    got = ms_ops.mamba_scan(**arrs)
    torch.cuda.synchronize()
    assert ms.launches.value == total + 1
    assert {p: c.value - before[p] for p, c in ms.path_launches.items()} \
        == {p: int(p == path) for p in SCAN_PATHS}
    _ms_close(got, mamba_scan_ref(**arrs))


def test_scan_kernel_refuses_what_it_does_not_take(cuda):
    arrs = _ms_inputs(1, 8, 16, 4, cuda, seed=6)
    with pytest.raises(ValueError, match="Bm is on cpu"):
        ms.mamba_scan_fwd(**dict(arrs, Bm=arrs["Bm"].cpu()))
    with pytest.raises(TypeError, match="bfloat16"):
        ms.mamba_scan_fwd(**dict(arrs, dt=arrs["dt"].bfloat16()))
    with pytest.raises(ValueError, match="Cm must be"):
        ms.mamba_scan_fwd(**dict(arrs, Cm=arrs["Cm"][:, :4]))
    with pytest.raises(ValueError, match="last dim"):
        ms.mamba_scan_fwd(**dict(arrs, A=arrs["A"].t().contiguous().t()))
    big = _ms_inputs(1, 8, 16, 33, cuda, seed=7)
    with pytest.raises(ValueError, match="state size"):
        ms.mamba_scan_fwd(**big)


@pytest.mark.parametrize("low", ["u", "dt"])
def test_scan_op_takes_bf16_as_the_reference(cuda, low):
    """A bf16 u or dt: the op casts to fp32 for the kernel and returns y in
    u's dtype and h_last in fp32, as the reference does.  h_last, and a
    fp32 y, at the reference's tolerance; a bf16 y at it plus one bf16
    rounding of each side (rtol 1e-3 + 2^-7)."""
    arrs = _ms_inputs(2, 96, 48, 8, cuda, seed=21)
    arrs[low] = arrs[low].bfloat16()
    before = ms.launches.value
    y, h = ms_ops.mamba_scan(**arrs)
    torch.cuda.synchronize()
    assert ms.launches.value == before + 1
    want_y, want_h = mamba_scan_ref(**arrs)
    assert y.dtype == want_y.dtype == arrs["u"].dtype
    assert h.dtype == want_h.dtype == torch.float32
    torch.testing.assert_close(h, want_h, **MS_TOL)
    if low == "u":
        torch.testing.assert_close(y.float(), want_y.float(),
                                   atol=MS_TOL["atol"],
                                   rtol=MS_TOL["rtol"] + 2.0 ** -7)
    else:
        torch.testing.assert_close(y, want_y, **MS_TOL)


def test_ssm_forward_launches_scan_once_per_layer(cuda):
    from repro_torch.configs import get_config
    from repro_torch.models import init_params, make_forward

    cfg = get_config("falcon-mamba-7b").reduced().with_(
        dtype="float32", use_mamba_kernel=True)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 24), device=cuda)
    before = ms.launches.value
    logits, _ = make_forward(cfg)(params, {"tokens": tokens})
    torch.cuda.synchronize()
    assert ms.launches.value - before == cfg.n_layers
    plain, _ = make_forward(cfg.with_(use_mamba_kernel=False))(
        params, {"tokens": tokens})
    scale = float(plain.abs().max())
    torch.testing.assert_close(logits, plain, atol=1e-4 * scale, rtol=1e-4)


def test_ssm_serve_engine_forward_matches_decode_replay(cuda):
    """The launcher's traffic on reduced falcon-mamba-7b in fp32 on the
    card: one scan launch per layer per wave, and each wave's forward
    logits equal the decode replay's at every request's last prompt
    position."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve as launch

    cfg = get_config("falcon-mamba-7b").reduced().with_(
        dtype="float32", use_mamba_kernel=True)
    before = ms.launches.value
    eng, done = launch.serve(cfg, 16, 2, "max-compute-util", 4, 0, cuda)
    torch.cuda.synchronize()
    assert ms.launches.value - before == cfg.n_layers * len(eng.waves) == 4
    assert all(len(r.output) == 4 for r in done)
    for w in eng.waves:
        scale = float(w.prefill_logits.abs().max())
        torch.testing.assert_close(w.replay_logits, w.prefill_logits,
                                   atol=1e-4 * scale, rtol=1e-4)


def _ms_close_as(dtype, got, want):
    """y and h_last at the kernel's tolerance; a bf16 y at it plus one
    bf16 rounding (as ``test_scan_op_takes_bf16_as_the_reference``)."""
    (y, h), (y_w, h_w) = got, want
    rtol = MS_TOL["rtol"] + (2.0 ** -7 if dtype == "bfloat16" else 0.0)
    torch.testing.assert_close(y.float(), y_w.float(), atol=MS_TOL["atol"],
                               rtol=rtol)
    torch.testing.assert_close(h, h_w, **MS_TOL)


def _scan_grads(fn, arrs, gy, gh, chunk):
    """y, h_last and the gradients of <y, gy> + <h_last, gh> with respect
    to every input, through ``fn`` (the op, or the plain chunked scan on
    fp32 casts of the inputs)."""
    ins = {k: v.detach().clone().requires_grad_() for k, v in arrs.items()}
    y, h = fn(**ins, chunk=chunk)
    grads = torch.autograd.grad([y, h], list(ins.values()),
                                [gy.to(y.dtype), gh])
    return (y, h), dict(zip(ins, grads))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,I,N", MS_CASES)
def test_scan_ref_vjp_gradients_match_the_plain_scan(cuda, B, S, I, N,
                                                     dtype):
    """The op with gradients at the reference's scan cases, in chunks of
    32 steps: one kernel launch, y and h_last at the kernel's tolerance,
    and the gradient of every input equal to autograd's through the plain
    chunked scan on the card (fp32: within 1e-5 of each max|g|; bf16 u,
    dt, Bm and Cm, whose gradients come back in bf16: within 2^-7)."""
    from repro_torch.kernels.mamba_scan.ref import ssm_scan_chunked

    arrs = _ms_inputs(B, S, I, N, cuda, seed=S + I + 1)
    if dtype == "bfloat16":
        for k in ("u", "dt", "Bm", "Cm"):
            arrs[k] = arrs[k].bfloat16()
    g = torch.Generator(cuda).manual_seed(S)
    gy = torch.randn(B, S, I, generator=g, device=cuda)
    gh = torch.randn(B, I, N, generator=g, device=cuda)

    def plain(chunk, **ins):
        return ssm_scan_chunked(**{k: v.float() for k, v in ins.items()},
                                chunk=chunk)
    before = ms.launches.value
    (y, h), got = _scan_grads(ms_ops.mamba_scan_with_ref_vjp, arrs, gy, gh,
                              32)
    torch.cuda.synchronize()
    assert ms.launches.value == before + 1
    (y_p, h_p), want = _scan_grads(lambda chunk, **ins: plain(chunk, **ins),
                                   arrs, gy, gh, 32)
    assert ms.launches.value == before + 1
    _ms_close_as(dtype, (y, h), (y_p, h_p))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for k, w in want.items():
        assert got[k].dtype == arrs[k].dtype and got[k].shape == w.shape, k
        err = float((got[k].float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (k, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scan_ref_vjp_chained_halves_give_the_whole(cuda, dtype):
    """Two halves through the op, the first's h_last fed to the second as
    h0: y, h_last and every gradient (through h0 into the first half)
    equal the whole sequence's through the op, within 1e-5 of each
    max|g| in fp32 and 2^-7 with bf16 u and dt."""
    arrs = _ms_inputs(2, 64, 16, 8, cuda, seed=11, h0=False)
    if dtype == "bfloat16":
        arrs["u"], arrs["dt"] = arrs["u"].bfloat16(), arrs["dt"].bfloat16()
    g = torch.Generator(cuda).manual_seed(12)
    gy = torch.randn(2, 64, 16, generator=g, device=cuda)
    gh = torch.randn(2, 16, 8, generator=g, device=cuda)
    (y, h), want = _scan_grads(ms_ops.mamba_scan_with_ref_vjp, arrs, gy, gh,
                               16)

    def halves(chunk, **ins):
        first = {k: (v[:, :32] if v.dim() == 3 else v)
                 for k, v in ins.items()}
        second = {k: (v[:, 32:] if v.dim() == 3 else v)
                  for k, v in ins.items()}
        y1, h1 = ms_ops.mamba_scan_with_ref_vjp(**first, chunk=chunk)
        y2, h2 = ms_ops.mamba_scan_with_ref_vjp(**second, h0=h1,
                                                chunk=chunk)
        return torch.cat([y1, y2], 1), h2
    (y2, h2), got = _scan_grads(halves, arrs, gy, gh, 16)
    torch.cuda.synchronize()
    _ms_close_as(dtype, (y2, h2), (y, h))
    tol = 1e-5 if dtype == "float32" else 2.0 ** -7
    for k, w in want.items():
        err = float((got[k].float() - w.float()).abs().max())
        assert err <= tol * float(w.float().abs().max()), (k, err)


def test_mamba_block_under_autograd_launches_the_kernel(cuda):
    """Reduced falcon-mamba-7b in fp32, a loss and its gradient on the
    card with the kernel route (remat full): the scan kernel launches
    twice per layer (the forward and the recompute), every gradient leaf
    is within 2e-2 of its max|g| of the plain path's, and a direct
    forward-only call on inputs that require grad still raises."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.model import make_loss_fn
    from repro_torch.models.transformer import flatten

    cfg = get_config("falcon-mamba-7b").reduced().with_(
        dtype="float32", use_mamba_kernel=True, ssm_chunk=16)
    params = init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    pairs = flatten(params)
    leaves = [p.requires_grad_() for _, p in pairs]
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device=cuda)
    grads = {}
    for kernel in (True, False):
        before = ms.launches.value
        loss = make_loss_fn(cfg.with_(use_mamba_kernel=kernel))(
            params, {"tokens": tokens})
        grads[kernel] = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        assert ms.launches.value - before == (2 * cfg.n_layers if kernel
                                              else 0)
    for (path, _), gk, gp in zip(pairs, grads[True], grads[False]):
        assert bool(torch.isfinite(gk).all()), path
        scale = float(gp.abs().max())
        assert float((gk - gp).abs().max()) <= 2e-2 * scale, path
    arrs = _ms_inputs(1, 8, 16, 4, cuda, seed=13)
    arrs["u"].requires_grad_()
    with pytest.raises(RuntimeError, match="u require grad"):
        ms_ops.mamba_scan(**arrs)


def test_a_kernel_launched_in_a_span_starts_after_it_on_the_shared_clock(
        cuda):
    """The recorder's realtime anchors put its spans on torch.profiler's
    clock: a kernel launched inside a span starts on the card after the
    span's start and within 5 ms of it."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs import Recorder

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):   # the first session
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    rec = Recorder()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(8):
            torch.cuda.synchronize()
            rec.anchor()
            t0 = rec.clock()
            torch.cuda._sleep(20_000)
            rec.span("launch", t0, rec.clock() - t0, kernel="sleep")
        torch.cuda.synchronize()
    rec.anchor()
    kernels = sorted(
        e.start_ns() for e in prof.profiler.kineto_results.events()
        if e.device_type() == torch.autograd.DeviceType.CUDA
        and not e.is_user_annotation()
        and not e.name().startswith(("Memcpy", "Memset")))
    launches = [rec.to_epoch_ns(s["t"]) for s in rec.spans()]
    assert len(kernels) == len(launches) == 8
    delays = [k - t for k, t in zip(kernels, launches)]
    print("launch span start to kernel start (ns):", delays)
    assert all(0 < d < 5_000_000 for d in delays), delays
