"""The slice as a whole: SDSS stacking through the port's RuntimeEngine
against the JAX package's, on the CPU, plus the app's stdout and the state
converters."""
import contextlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.objects import DataObject as JaxDataObject
from repro.core.runtime import ObjectStore as JaxObjectStore
from repro.experiments import CacheSpec as JaxCacheSpec
from repro.experiments import ClusterSpec as JaxClusterSpec
from repro.experiments import ExperimentSpec as JaxExperimentSpec
from repro.experiments import RuntimeEngine as JaxRuntimeEngine
from repro.experiments import WorkloadSpec as JaxWorkloadSpec
from repro.experiments.report import IDENTITY_FIELDS
from repro_torch import convert
from repro_torch.apps import astro
from repro_torch.experiments import RuntimeEngine

ROOT = Path(__file__).resolve().parents[1]

#: RunReport fields read off the wall clock (everything else must agree)
CLOCK_FIELDS = ("makespan_s", "t_first_dispatch", "t_last_complete",
                "busy_span_s", "tasks_per_second", "read_bandwidth_bps",
                "moved_bandwidth_bps", "efficiency", "avg_slowdown",
                "p95_slowdown", "performance_index", "executor_seconds",
                "slowdown_from_arrival", "slowdown_from_ready",
                "dispatch_stats")


def _example():
    """examples/astronomy_stacking.py as a module (its ``_coadd`` is the
    reference task math, run through the Pallas kernel in interpret mode)."""
    spec = importlib.util.spec_from_file_location(
        "astronomy_stacking_example", ROOT / "examples" / "astronomy_stacking.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = _example()


def _jax_stack_or_mosaic(inputs):
    oids = list(inputs)
    if all(o.split(".")[-1].startswith("stack") for o in oids):
        tiles = np.stack([np.asarray(v) for v in inputs.values()])
        zeros = np.zeros(tiles.shape[0], np.float32)
        return np.asarray(EX.st_ops.stack_rois(
            tiles, zeros, np.ones(tiles.shape[0], np.float32), zeros, zeros))
    tiles = np.concatenate([np.asarray(v) for v in inputs.values()], axis=0)
    return EX._coadd(tiles, [int(o.split(".")[2][1:]) for o in oids])


def _jax_stack_object(inputs):
    tiles = np.concatenate(list(inputs.values()), axis=0)
    return EX._coadd(tiles, [int(oid[3:]) for oid in inputs])


def _jax_spec(pt_spec):
    """The reference spec with the port spec's fields (same names)."""
    d = pt_spec.to_dict()
    return JaxExperimentSpec(
        name=d["name"], cluster=JaxClusterSpec(**d["cluster"]),
        cache=JaxCacheSpec(**d["cache"]), policy=d["policy"], seed=d["seed"],
        workload=JaxWorkloadSpec(**d["workload"]))


def _run_both(pt_spec, jax_task, pt_task, barrier):
    jeng = JaxRuntimeEngine().prepare(_jax_spec(pt_spec))
    peng = RuntimeEngine(device="cpu").prepare(pt_spec)
    try:
        jrep = jeng.run(task_fn=jax_task, payload_factory=EX_make_tiles,
                        barrier_every=barrier, timeout=300.0)
        prep = peng.run(task_fn=pt_task, payload_factory=astro.make_tiles,
                        barrier_every=barrier, timeout=300.0)
        jdone = {t.tid: t for t in jeng.runtime.dispatcher.completed}
        pdone = {t.tid: t for t in peng.runtime.dispatcher.completed}
        jsplit = sorted((t.tid, t.executor, t.cache_hits, t.peer_hits,
                         t.cache_misses) for t in jdone.values())
        psplit = sorted((t.tid, t.executor, t.cache_hits, t.peer_hits,
                         t.cache_misses) for t in pdone.values())
    finally:
        jeng.shutdown()
        peng.shutdown()
    return jrep, prep, jdone, pdone, jsplit, psplit


def EX_make_tiles(ob):
    """The reference's file content: the port's ``make_tiles`` is checked
    against the example's own formula (numpy, same seeds)."""
    if ob.oid.startswith("img"):
        rng = np.random.default_rng([EX.SEED, int(ob.oid[3:])])
    else:
        g, k = ob.oid.split(".")[1:]
        rng = np.random.default_rng([EX.SEED, int(g[1:]), int(k[1:])])
    return rng.normal(500, 100, size=(EX.TILES_PER_FILE, EX.H, EX.W)) \
        .astype(np.float32)


def _assert_reports_agree(jrep, prep):
    skip = set(IDENTITY_FIELDS) | set(CLOCK_FIELDS)
    for name in jrep.schema():
        if name in skip:
            continue
        assert getattr(prep, name) == getattr(jrep, name), name
    assert prep.schema() == jrep.schema()


def _assert_pixels_close(got, want):
    assert isinstance(got, torch.Tensor) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=np.abs(want).max() * 1e-5)


def test_pipeline_matches_reference_engine():
    """The example's own pipeline: 8 stacks of 4 files, one mosaic, 4 hosts."""
    spec = astro.pipeline_spec(groups=8, group_size=4, hosts=4)
    jrep, prep, jdone, pdone, jsplit, psplit = _run_both(
        spec, _jax_stack_or_mosaic, astro.stack_or_mosaic, barrier=4)
    _assert_reports_agree(jrep, prep)
    assert psplit == jsplit
    assert prep.n_completed == 9 and prep.cache_hit_ratio == 8 / 40
    for tid, jt in jdone.items():
        _assert_pixels_close(pdone[tid].result, jt.result)


def test_flat_matches_reference_engine():
    spec = astro.flat_spec(objects=24, locality=3, hosts=2)
    jrep, prep, jdone, pdone, jsplit, psplit = _run_both(
        spec, _jax_stack_object, astro.stack_object, barrier=2)
    _assert_reports_agree(jrep, prep)
    assert psplit == jsplit
    assert prep.n_completed == 24 and prep.store_reads == 8
    for tid, jt in jdone.items():
        _assert_pixels_close(pdone[tid].result, jt.result)


def test_make_tiles_matches_reference_content():
    from repro_torch.core import DataObject

    for oid in ("img0", "img17", "astro.g3.o1"):
        np.testing.assert_array_equal(
            astro.make_tiles(DataObject(oid, 1)),
            EX_make_tiles(JaxDataObject(oid, 1)))


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        assert fn(argv) == 0
    # the slowdown line reads the wall clock; every other line is
    # deterministic
    return [ln for ln in buf.getvalue().splitlines()
            if "slowdown:" not in ln]


@pytest.mark.parametrize("argv", [
    ["--groups", "3", "--group-size", "2", "--hosts", "2"],
    ["--flat", "--objects", "20", "--locality", "5", "--hosts", "1"],
])
def test_app_main_prints_what_the_example_prints(argv):
    argv = argv + ["--time-scale", "0"]
    want = _stdout(EX.main, argv)
    got = _stdout(astro.main, argv + ["--device", "cpu"])
    assert got == want
    assert len(got) == 4


def test_app_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        astro.main(["--groups", "1", "--group-size", "1", "--hosts", "1",
                    "--time-scale", "0"])


def test_task_fn_resolves_by_module_attr():
    spec = astro.pipeline_spec(groups=2, group_size=1, hosts=2)
    eng = RuntimeEngine(task_fn_name="repro_torch.apps.astro:stack_or_mosaic",
                        device="cpu").prepare(spec)
    try:
        rep = eng.run(payload_factory=astro.make_tiles, barrier_every=2)
        mosaic = next(t.result for t in eng.runtime.dispatcher.completed
                      if t.tid == "astro-mosaic")
    finally:
        eng.shutdown()
    assert rep.n_completed == 3 and tuple(mosaic.shape) == (100, 100)


# --------------------------------------------------------------------------
# carrying the reference's state across
# --------------------------------------------------------------------------

def test_store_from_numpy_takes_reference_catalog():
    jstore = JaxObjectStore()
    for i in range(3):
        ob = JaxDataObject(f"img{i}", 320_000)
        jstore.put(ob, EX_make_tiles(ob))
    store = convert.store_from_numpy(
        (ob.oid, ob.size_bytes, arr) for ob, arr in jstore.items())
    for ob, arr in jstore.items():
        meta, t = store.get(ob.oid)
        assert meta.size_bytes == ob.size_bytes
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), arr)
    assert store.bytes_read == 3 * 320_000


def test_spec_from_json_loads_reference_spec(tmp_path):
    for pt_spec in (astro.pipeline_spec(8, 4, 4),
                    astro.flat_spec(96, 10, 4, stack_width=2)):
        path = tmp_path / "spec.json"
        _jax_spec(pt_spec).save(path)
        assert convert.spec_from_json(path) == pt_spec


def test_spec_from_json_refuses_features_the_port_lacks(tmp_path):
    base = _jax_spec(astro.pipeline_spec(2, 2, 2))
    path = tmp_path / "spec.json"
    JaxExperimentSpec(**{**base.__dict__, "hosts": 2}).save(path)
    with pytest.raises(ValueError, match="hosts"):
        convert.spec_from_json(path)
