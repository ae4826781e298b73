"""The port's stacking op against the JAX reference (kernel in interpret mode
and its jnp oracle), on the CPU.  The CUDA kernel itself runs only on the
card: tests/test_torch_kernels_cuda.py holds it to this plain version."""
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.stacking import ops as jax_ops
from repro.kernels.stacking.ref import stack_rois_ref as jax_stack_rois_ref
from repro_torch.kernels.build import LaunchCounter
from repro_torch.kernels.stacking import ops
from repro_torch.kernels.stacking import stacking
from repro_torch.kernels.stacking.ref import stack_rois_ref

SHAPES = [(8, 16, 16), (37, 24, 40), (100, 100, 100), (3, 8, 8)]


def _inputs(n, h, w, seed):
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.normal(500, 100, (n, h, w)), rng.normal(0, 10, n),
        rng.uniform(0.5, 1.5, n), rng.uniform(0, 1, n), rng.uniform(0, 1, n))]


def _assert_stack_close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=np.abs(ref).max() * 1e-5)


@pytest.mark.parametrize("mean", [False, True])
@pytest.mark.parametrize("N,H,W", SHAPES)
def test_stack_rois_matches_jax(N, H, W, mean):
    arrs = _inputs(N, H, W, seed=N * 1000 + H)
    jax_kernel = np.asarray(jax_ops.stack_rois(*map(jnp.asarray, arrs),
                                               mean=mean))
    jax_ref = np.asarray(jax_stack_rois_ref(*map(jnp.asarray, arrs)))
    if mean:
        jax_ref = jax_ref / N
    got = ops.stack_rois(*map(torch.from_numpy, arrs), mean=mean).numpy()
    _assert_stack_close(got, jax_kernel)
    _assert_stack_close(got, jax_ref)


def test_stack_rois_integer_shift_is_exact_sum():
    """dy=dx=0 must be an exact calibrated sum (no interpolation blur)."""
    rois = np.arange(2 * 4 * 4, dtype=np.float32).reshape(2, 4, 4)
    z, o = np.zeros(2, np.float32), np.ones(2, np.float32)
    got = ops.stack_rois(*map(torch.from_numpy, (rois, z, o, z, z)),
                         mean=False).numpy()
    np.testing.assert_array_equal(got, rois.sum(0))
    jax_out = np.asarray(jax_ops.stack_rois(*map(jnp.asarray,
                                                 (rois, z, o, z, z)),
                                            mean=False))
    np.testing.assert_array_equal(got, jax_out)


def test_stack_rois_edge_repeat_hand_computed():
    """One 3x3 ROI shifted by (dy, dx) = (0.5, 0.25): each output pixel
    blends the pixel, its left neighbour (``right``), the pixel above
    (``down``) and the one above-left, with row 0 / column 0 repeated."""
    img = np.array([[1., 2., 4.], [8., 16., 32.], [64., 128., 256.]],
                   np.float32)
    dy, dx = 0.5, 0.25
    w00, w01 = (1 - dy) * (1 - dx), (1 - dy) * dx
    w10, w11 = dy * (1 - dx), dy * dx
    expect = np.empty((3, 3), np.float64)
    for r in range(3):
        for c in range(3):
            ru, cl = max(r - 1, 0), max(c - 1, 0)
            expect[r, c] = (w00 * img[r, c] + w01 * img[r, cl]
                            + w10 * img[ru, c] + w11 * img[ru, cl])
    # corner (0, 0) repeats itself in every shift
    assert expect[0, 0] == img[0, 0]
    args = [torch.from_numpy(img[None]), torch.zeros(1), torch.ones(1),
            torch.tensor([dy]), torch.tensor([dx])]
    got = ops.stack_rois(*args, mean=False).numpy()
    np.testing.assert_allclose(got, expect, rtol=1e-6)
    jax_got = np.asarray(jax_ops.stack_rois(
        *(jnp.asarray(a.numpy()) for a in args), mean=False))
    np.testing.assert_allclose(got, jax_got, rtol=1e-6)


def test_cpu_call_takes_plain_version_and_counts_no_launch():
    arrs = [torch.from_numpy(a) for a in _inputs(8, 16, 16, seed=3)]
    before = stacking.launches.value
    got = ops.stack_rois(*arrs, mean=True)
    assert stacking.launches.value == before
    torch.testing.assert_close(got, stack_rois_ref(*arrs) / 8,
                               rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it refuses CPU tensors
    before touching the compiler or the card."""
    arrs = [torch.from_numpy(a) for a in _inputs(3, 8, 8, seed=4)]
    before = stacking.launches.value
    with pytest.raises(ValueError, match="CUDA"):
        stacking.stack_rois_fwd(*arrs)
    assert stacking.launches.value == before


def test_one_call_coadd_refuses_cpu_tiles():
    """The one-call coadd never computes on the CPU either: CPU tiles are
    refused before the library is loaded, and nothing is counted."""
    tiles = torch.from_numpy(_inputs(3, 8, 8, seed=5)[0])
    shifts = np.zeros((2, 3), np.float32)
    counters = (stacking.launches, stacking.coadd_calls)
    before = [c.value for c in counters]
    with pytest.raises(ValueError, match="CUDA"):
        stacking.coadd_fwd(tiles, shifts, 0.1)
    with pytest.raises(ValueError, match="N, H, W"):
        stacking.coadd_fwd(tiles[0], shifts, 0.1)
    assert [c.value for c in counters] == before


def test_launch_counter_loses_no_count_across_threads():
    """Executor threads launch concurrently; every add must count."""
    counter = LaunchCounter()

    def add_many():
        for _ in range(2000):
            counter.add()

    threads = [threading.Thread(target=add_many) for _ in range(16)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert counter.value == 16 * 2000
    counter.reset()
    assert counter.value == 0
