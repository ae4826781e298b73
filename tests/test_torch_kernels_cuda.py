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
        rep = eng.run(task_fn=astro.stack_object,
                      payload_factory=astro.make_tiles, timeout=120.0)
        torch.cuda.synchronize()
        assert stacking.launches.value - before == rep.n_completed == 64
        for w in eng.runtime.workers.values():
            assert all(p.device == cuda for p in w.payloads.values())
    finally:
        eng.shutdown()
