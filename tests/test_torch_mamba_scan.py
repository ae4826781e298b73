"""The port's selective-scan op against the JAX reference (the Pallas kernel
in interpret mode and its jnp oracle), on the CPU, where the op takes its
plain version.  The CUDA kernel itself runs only on the card:
tests/test_torch_kernels_cuda.py holds it to this plain version.

Tolerance: atol 2e-4, rtol 1e-3 on y and h_last, the reference's own
(tests/test_kernels.py); the port's plain version is fp32 throughout."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.mamba_scan import ops as jax_ops
from repro.kernels.mamba_scan.ref import mamba_scan_ref as jax_scan_ref
from repro_torch.kernels.mamba_scan import mamba_scan as ms
from repro_torch.kernels.mamba_scan import ops
from repro_torch.kernels.mamba_scan.ref import mamba_scan_ref

#: (B, S, I, N, block_i, chunk): the reference's cases (tests/test_kernels.py)
MS_CASES = [
    (1, 32, 16, 4, 16, 16),
    (2, 96, 48, 8, 16, 32),    # I % block, S % chunk nontrivial
    (2, 128, 64, 16, 32, 64),
    (1, 50, 24, 4, 16, 32),    # ragged S (padding path)
]
TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops spend most of their time waking threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, i, n, seed, h0=True):
    """The reference test's distributions, drawn with numpy: u, dt =
    softplus(normal), A = -exp(0.5·normal), Bm, Cm, D and h0 = 0.05."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    arrs = {
        "u": rng.standard_normal((b, s, i), f32),
        "dt": np.log1p(np.exp(rng.standard_normal((b, s, i), f32))),
        "A": -np.exp(rng.standard_normal((i, n), f32) * 0.5),
        "Bm": rng.standard_normal((b, s, n), f32),
        "Cm": rng.standard_normal((b, s, n), f32),
        "D": rng.standard_normal(i, f32),
    }
    if h0:
        arrs["h0"] = np.full((b, i, n), 0.05, f32)
    return {k: v.astype(f32) for k, v in arrs.items()}


def _port(arrs, **kw):
    y, h = ops.mamba_scan(**{k: torch.from_numpy(v) for k, v in arrs.items()},
                          **kw)
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    return y.numpy(), h.numpy()


def _close(got, want):
    for g, w in zip(got, want):
        assert g.shape == np.shape(w)
        np.testing.assert_allclose(g, np.asarray(w), **TOL)


@pytest.mark.parametrize("B,S,I,N,bi,ck", MS_CASES)
def test_mamba_scan_matches_jax(B, S, I, N, bi, ck):
    arrs = _inputs(B, S, I, N, seed=S + I)
    jarrs = {k: jnp.asarray(v) for k, v in arrs.items()}
    got = _port(arrs)
    _close(got, jax_ops.mamba_scan(**jarrs, block_i=bi, chunk=ck))
    _close(got, jax_scan_ref(**jarrs))


def test_mamba_scan_state_chaining():
    """The two halves with h_last carried over as h0 give the whole."""
    arrs = _inputs(1, 64, 16, 8, seed=7, h0=False)
    y_full, h_full = _port(arrs)
    first = {k: (v[:, :32] if v.ndim == 3 else v) for k, v in arrs.items()}
    second = {k: (v[:, 32:] if v.ndim == 3 else v) for k, v in arrs.items()}
    y1, h1 = _port(first)
    y2, h2 = _port(second, h0=torch.from_numpy(h1))
    _close((np.concatenate([y1, y2], 1), h2), (y_full, h_full))
    jarrs = {k: jnp.asarray(v) for k, v in arrs.items()}
    _close((y_full, h_full), jax_ops.mamba_scan(**jarrs, chunk=16))


def test_mamba_scan_without_h0_is_a_zero_state():
    arrs = _inputs(2, 40, 24, 16, seed=8, h0=False)
    got = _port(arrs)
    jarrs = {k: jnp.asarray(v) for k, v in arrs.items()}
    _close(got, jax_ops.mamba_scan(**jarrs, block_i=16, chunk=16))
    zero = dict(arrs, h0=np.zeros((2, 24, 16), np.float32))
    for g, w in zip(got, _port(zero)):
        np.testing.assert_array_equal(g, w)


def test_mamba_scan_one_step():
    """S = 1 (the reference pads it to a chunk): one recurrence step."""
    arrs = _inputs(3, 1, 20, 4, seed=9)
    got = _port(arrs)
    jarrs = {k: jnp.asarray(v) for k, v in arrs.items()}
    _close(got, jax_ops.mamba_scan(**jarrs, block_i=8, chunk=8))
    a = arrs
    h = np.exp(a["dt"][:, 0, :, None] * a["A"][None]) * a["h0"] \
        + (a["dt"][:, 0] * a["u"][:, 0])[..., None] * a["Bm"][:, 0, None, :]
    y = np.einsum("bin,bn->bi", h, a["Cm"][:, 0]) + a["u"][:, 0] * a["D"]
    _close(got, (y[:, None], h))


def test_cpu_call_takes_plain_version_and_counts_no_launch():
    arrs = {k: torch.from_numpy(v) for k, v in
            _inputs(1, 8, 8, 4, seed=10).items()}
    before = ms.launches.value
    got = ops.mamba_scan(**arrs)
    assert ms.launches.value == before
    want = mamba_scan_ref(**arrs)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it refuses CPU tensors
    before touching the compiler or the card."""
    arrs = {k: torch.from_numpy(v) for k, v in
            _inputs(1, 8, 8, 4, seed=11).items()}
    before = ms.launches.value
    with pytest.raises(ValueError, match="CUDA"):
        ms.mamba_scan_fwd(**arrs)
    assert ms.launches.value == before


def test_kernel_path_takes_four_lanes_only_where_channels_are_few():
    """The lane layout is a pure function of B and I: falcon-mamba-7b's
    serving waves (B=8, I=8192) take two lanes per channel, a one-row
    prefill four; the threshold is the constant."""
    assert ms.kernel_path(8, 8192) == "pair"
    assert ms.kernel_path(1, 8192) == "quad"
    edge = ms.QUAD_BELOW_CHANNELS
    assert ms.kernel_path(1, edge) == ms.kernel_path(2, edge // 2) == "pair"
    assert ms.kernel_path(1, edge - 1) == "quad"
    assert set(ms.path_launches) == set(ms.LANES) == {"pair", "quad"}
    assert ms.LANES == {"pair": 2, "quad": 4}


@pytest.mark.parametrize("u_dtype,dt_dtype", [("bfloat16", "float32"),
                                              ("float32", "bfloat16"),
                                              ("bfloat16", "bfloat16")])
def test_op_returns_the_reference_dtypes(u_dtype, dt_dtype):
    """bf16 u or dt: the reference computes in fp32 and returns y in u's
    dtype and h_last in fp32; so does the port's op (on the CPU, its plain
    version), with the reference's values."""
    a = _inputs(1, 8, 16, 4, seed=12)
    dts = {"u": u_dtype, "dt": dt_dtype}
    jargs = {k: jnp.asarray(v, dts.get(k, "float32")) for k, v in a.items()}
    jy, jh = jax_ops.mamba_scan(**jargs)
    y, h = ops.mamba_scan(**{k: torch.from_numpy(np.array(
        v.astype(jnp.float32))).to(getattr(torch, dts.get(k, "float32")))
        for k, v in jargs.items()})
    assert y.dtype == getattr(torch, str(jy.dtype)) == getattr(torch, u_dtype)
    assert h.dtype == getattr(torch, str(jh.dtype)) == torch.float32
    tol = 2.0 ** -7 if u_dtype == "bfloat16" else 1e-5
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(jy.astype(jnp.float32)), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=1e-5,
                               atol=1e-5)
