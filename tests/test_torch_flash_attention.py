"""The port's flash-attention op against the JAX reference (the Pallas
kernel in interpret mode and its jnp oracle), on the CPU, where the op takes
its plain version.  The CUDA kernel itself runs only on the card:
tests/test_torch_kernels_cuda.py holds it to this plain version."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention import ops as jax_ops
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import attention_ref

FA_CASES = [
    # (B, S, H, KV, D, causal, window, softcap, dtype): tests/test_kernels.py
    (2, 64, 4, 2, 16, True, 0, 0.0, "float32"),
    (1, 128, 8, 2, 32, True, 32, 0.0, "float32"),      # SWA
    (2, 64, 4, 4, 24, True, 0, 50.0, "float32"),       # softcap, odd Dh
    (1, 256, 4, 1, 16, True, 0, 0.0, "float32"),       # MQA
    (2, 96, 4, 2, 16, True, 0, 0.0, "float32"),        # ragged seq (pad)
    (1, 64, 4, 2, 16, False, 0, 0.0, "float32"),       # bidirectional
    (2, 64, 4, 2, 16, True, 16, 30.0, "float32"),      # SWA + softcap
    (2, 64, 8, 8, 16, True, 0, 0.0, "bfloat16"),       # MHA bf16
    # bf16 at the dense models' head dims (the tensor-core kernel's inputs
    # on the card), GQA group 4
    (1, 64, 8, 2, 120, True, 32, 0.0, "bfloat16"),     # window 32
    (2, 96, 8, 2, 128, True, 0, 50.0, "bfloat16"),     # softcap 50
    (2, 96, 8, 2, 120, True, 0, 0.0, "bfloat16"),
    (1, 64, 8, 2, 128, True, 32, 50.0, "bfloat16"),    # window + softcap
]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops spend most of their time waking threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, s, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((b, s, h, d), (b, s, kv, d), (b, s, kv, d))]


def _torch(a, dtype):
    return torch.from_numpy(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("B,S,H,KV,D,causal,window,softcap,dtype", FA_CASES)
def test_flash_attention_matches_jax(B, S, H, KV, D, causal, window, softcap,
                                     dtype):
    if not causal and S % 32:
        pytest.skip("non-causal ragged falls back to ref in the reference")
    arrs = _inputs(B, S, H, KV, D, seed=S * 100 + D)
    jq, jk, jv = (jnp.asarray(a).astype(getattr(jnp, dtype)) for a in arrs)
    jax_kernel = jax_ops.flash_attention(jq, jk, jv, causal=causal,
                                         window=window, softcap=softcap,
                                         block_q=32, block_k=32)
    jax_ref = jnp.swapaxes(jax_attention_ref(
        jnp.swapaxes(jq, 1, 2), jnp.swapaxes(jk, 1, 2),
        jnp.swapaxes(jv, 1, 2), causal=causal, window=window,
        softcap=softcap), 1, 2)
    q, k, v = (_torch(a, dtype) for a in arrs)
    got = ops.flash_attention(q, k, v, causal=causal, window=window,
                              softcap=softcap)
    assert got.shape == q.shape and got.dtype == q.dtype
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    got = got.float().numpy()
    for want in (jax_kernel, jax_ref):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def test_plain_version_zeroes_rows_without_a_valid_key():
    """Sq > Sk under a causal window: rows q >= Sk + window - 1 see no key
    and output 0, as the reference's oracle does."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal(s, np.float32)
               for s in ((1, 4, 70, 8), (1, 2, 40, 8), (1, 2, 40, 8)))
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), causal=True,
                        window=16).numpy()
    want = np.asarray(jax_attention_ref(*map(jnp.asarray, (q, k, v)),
                                        causal=True, window=16))
    assert (got[:, :, 55:] == 0).all()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("q_chunk", [1, 7, 64])
def test_plain_version_in_query_chunks_is_the_same(q_chunk):
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 100, 4, 2, 24, 3))
    args = [t.transpose(1, 2) for t in (q, k, v)]
    whole = attention_ref(*args, causal=True, window=20, softcap=30.0)
    chunked = attention_ref(*args, causal=True, window=20, softcap=30.0,
                            q_chunk=q_chunk)
    torch.testing.assert_close(chunked, whole, atol=1e-6, rtol=1e-6)


def test_cpu_call_takes_plain_version_and_counts_no_launch():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 8, 4))
    before = fa.launches.value
    got = ops.flash_attention(q, k, v, causal=True, window=4)
    assert fa.launches.value == before
    want = attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=True,
                         window=4).transpose(1, 2)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper never computes on the CPU: it refuses CPU tensors
    before touching the compiler or the card."""
    q, k, v = (torch.from_numpy(a).transpose(1, 2)
               for a in _inputs(1, 16, 4, 2, 8, 6))
    before = fa.launches.value
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)
    assert fa.launches.value == before


def _model_layout(b, s, h, kv, d, dtype=torch.bfloat16):
    """(B,S,H,D) tensors seen as (B,H,S,D), as the model hands them over."""
    return [torch.empty(b, s, n, d, dtype=dtype).transpose(1, 2)
            for n in (h, kv, kv)]


@pytest.mark.parametrize("d", [120, 128])
def test_kernel_path_takes_tensor_cores_for_model_layout_bf16(d):
    assert fa.kernel_path(*_model_layout(8, 96, 32, 8, d)) == "wgmma"
    assert fa.kernel_path(*_model_layout(1, 1, 4, 1, d)) == "wgmma"


def test_kernel_path_keeps_fp32_on_simt():
    assert fa.kernel_path(*_model_layout(8, 96, 32, 8, 128,
                                         torch.float32)) == "simt"


@pytest.mark.parametrize("d", [20, 136])
def test_kernel_path_keeps_other_head_dims_on_simt(d):
    assert fa.kernel_path(*_model_layout(2, 64, 8, 2, d)) == "simt"


def test_kernel_path_keeps_misaligned_storage_on_simt():
    """A storage offset of one element breaks TMA's 16-byte alignment."""
    q, k, v = _model_layout(2, 64, 8, 2, 128)
    flat = torch.empty(q.numel() + 1, dtype=torch.bfloat16)
    shifted = flat[1:].view(2, 64, 8, 128).transpose(1, 2)
    assert fa.kernel_path(shifted, k, v) == "simt"
    assert fa.kernel_path(q, k, v) == "wgmma"


def test_kernel_path_keeps_broadcast_kv_on_simt():
    """k and v expanded along the batch dim (stride 0) cannot be a TMA
    map's stride; the SIMT kernel takes them."""
    q, k, v = _model_layout(4, 64, 8, 2, 128)
    k1, v1 = (t[:1].expand(4, -1, -1, -1) for t in (k, v))
    assert k1.stride(0) == 0
    assert fa.kernel_path(q, k1, v1) == "simt"
    assert fa.kernel_path(q[:1], k1[:1], v1[:1]) == "wgmma"


def test_kernel_path_takes_strided_views_of_a_fused_projection():
    """q, k, v as head slices of one (B,S,H+2KV,D) projection: non-contiguous
    views whose strides and offsets stay 16-byte multiples."""
    qkv = torch.empty(2, 64, 8 + 2 * 2, 120, dtype=torch.bfloat16)
    q, k, v = (qkv[:, :, a:b_].transpose(1, 2)
               for a, b_ in ((0, 8), (8, 10), (10, 12)))
    assert not q.is_contiguous()
    assert fa.kernel_path(q, k, v) == "wgmma"


@pytest.mark.parametrize("dtype", ["float16", "bfloat16", "float32"])
def test_op_returns_the_reference_dtype(dtype):
    """The reference casts q, k and v to fp32 in its kernel and returns q's
    dtype; so does the port's op (on the CPU, its plain version)."""
    arrs = _inputs(1, 32, 4, 2, 16, seed=3)
    want = jax_ops.flash_attention(*(jnp.asarray(a, dtype) for a in arrs))
    got = ops.flash_attention(*(_torch(a, dtype) for a in arrs))
    assert got.dtype == getattr(torch, str(want.dtype)) == getattr(torch,
                                                                   dtype)
    tol = {"float16": 2e-3, "bfloat16": 2e-2, "float32": 2e-5}[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)
