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
