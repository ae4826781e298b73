"""The port's decoder against the JAX reference, on the CPU.

Layer by layer in fp32 and bf16, then the whole forward (attention impl
flash, blocked and ref; the Mamba scan through the kernel's op or the
plain chunked path) and the one-token decode on the ``reduced()`` form of
the four dense configs, falcon-mamba-7b and the MoE configs (qwen3-moe,
mixtral and the hybrid jamba, whose pattern mixes attention, Mamba, dense
and MoE sub-layers), with the reference's own ``init_params`` weights
carried over by ``convert.params_from_jax``.  JAX runs as its own tests
run it: the Pallas kernels in interpret mode.

Tolerances: fp32 atol = rtol = 1e-4 (the reference's own flash-vs-ref gap
is about 2e-5 at these sizes: its wrapper pads head_dim and rescales q);
bf16 2e-2 of max|logit| (the two frameworks round bf16 at other places).
The whole model in bf16 is held sub-layer by sub-layer (see below why).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import mamba as JM
from repro.models import transformer as JT
from repro.models.model import make_forward as jax_make_forward
from repro.models.model import make_prefill as jax_make_prefill
from repro.models.model import make_serve_step as jax_make_serve_step
from repro_torch.configs import REGISTRY, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import (init_cache, init_params, make_forward,
                                make_prefill, make_serve_step, param_defs)
from repro_torch.models import LayerSpec, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import transformer as T
from repro_torch.models.transformer import flatten

DENSE = sorted(k for k, c in REGISTRY.items() if c.family == "dense")
SSM = "falcon-mamba-7b"
MOE = sorted(k for k, c in REGISTRY.items() if c.family in ("moe", "hybrid"))
DTYPES = ["float32", "bfloat16"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops spend most of their time waking threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    """``x`` as a writable fp32 numpy array (torch shares its buffer)."""
    return np.array(jnp.asarray(x, jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same numbers as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a).astype(getattr(jnp, dtype))
    return j, torch.from_numpy(_np(j)).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, dtype: str, rel: bool = False):
    want = _np(want)
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        scale = np.abs(want).max() if rel else 1.0
        np.testing.assert_allclose(got, want, atol=2e-2 * scale, rtol=2e-2)


def _rng(seed=0):
    return np.random.default_rng(seed)


# --------------------------- layers ------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("plus_one", [False, True])
def test_rms_norm(dtype, plus_one):
    r = _rng(1)
    jx, tx = _pair(r.standard_normal((2, 5, 64)).astype(np.float32) * 3, dtype)
    w = r.standard_normal(64).astype(np.float32) * 0.1 + (0 if plus_one else 1)
    want = JL.rms_norm(jx, jnp.asarray(w), plus_one=plus_one)
    got = L.rms_norm(tx, torch.from_numpy(w), plus_one=plus_one)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_layer_norm(dtype):
    r = _rng(2)
    jx, tx = _pair(r.standard_normal((2, 5, 64)).astype(np.float32) * 2 + 1,
                   dtype)
    w = r.standard_normal(64).astype(np.float32) * 0.1 + 1
    b = r.standard_normal(64).astype(np.float32) * 0.1
    want = JL.layer_norm(jx, jnp.asarray(w), jnp.asarray(b))
    got = L.layer_norm(tx, torch.from_numpy(w), torch.from_numpy(b))
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("theta", [1e4, 1e5])
def test_apply_rope(dtype, theta):
    jx, tx = _pair(_rng(3).standard_normal((2, 9, 4, 16)).astype(np.float32),
                   dtype)
    pos = np.arange(3, 12)
    want = JL.apply_rope(jx, jnp.asarray(pos, jnp.int32), theta)
    got = L.apply_rope(tx, torch.from_numpy(pos), theta)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


VARIANTS = [
    dict(kind="full"),
    dict(kind="swa", window=5),
    dict(kind="full", softcap=20.0),
    dict(kind="swa", window=3, softcap=10.0),
    dict(kind="full", causal=False),
]


def _qkv(b, s, h, kv, dh, dtype, seed):
    r = _rng(seed)
    return [_pair(r.standard_normal(shape).astype(np.float32), dtype)
            for shape in ((b, s, h, dh), (b, s, kv, dh), (b, s, kv, dh))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", VARIANTS, ids=str)
def test_gqa_and_blocked_attention(variant, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 20, 4, 2, 16, dtype, 4)
    jvar, tvar = JL.AttnVariant(**variant), L.AttnVariant(**variant)
    jpos, tpos = jnp.arange(20), torch.arange(20)
    want = JL.gqa_attention(jq, jk, jv, jpos, jpos, jvar)
    _close(L.gqa_attention(tq, tk, tv, tpos, tpos, tvar), want, dtype)
    # block_k 8 does not divide 20: the padded keys must never win
    want_b = JL.blocked_attention(jq, jk, jv, jpos, jpos, jvar, block_k=8)
    got_b = L.blocked_attention(tq, tk, tv, tpos, tpos, tvar, block_k=8)
    _close(got_b, want_b, dtype)


def test_gqa_attention_with_key_validity():
    (jq, tq), (jk, tk), (jv, tv) = _qkv(2, 6, 4, 2, 8, "float32", 5)
    valid = np.array([[1, 1, 1, 0, 1, 1], [1, 0, 1, 1, 1, 1]], bool)
    want = JL.gqa_attention(jq, jk, jv, jnp.arange(6), jnp.arange(6),
                            JL.AttnVariant(), jnp.asarray(valid))
    got = L.gqa_attention(tq, tk, tv, torch.arange(6), torch.arange(6),
                          L.AttnVariant(), torch.from_numpy(valid))
    _close(got, want, "float32")


def _attn_params(d, h, kv, dh, dtype, seed):
    r = _rng(seed)
    shapes = {"wq": (d, h, dh), "wk": (d, kv, dh), "wv": (d, kv, dh),
              "wo": (h, dh, d)}
    pairs = {k: _pair(r.standard_normal(s).astype(np.float32) / np.sqrt(s[0]),
                      dtype) for k, s in shapes.items()}
    return ({k: j for k, (j, _) in pairs.items()},
            {k: t for k, (_, t) in pairs.items()})


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("impl", ["ref", "blocked", "flash"])
@pytest.mark.parametrize("variant", VARIANTS[:4], ids=str)
def test_attention_block(variant, impl, dtype):
    jp, tp = _attn_params(32, 4, 2, 16, dtype, 6)
    jx, tx = _pair(_rng(7).standard_normal((2, 12, 32)).astype(np.float32),
                   dtype)
    want = JL.attention_block(jx, jp, jnp.arange(12), JL.AttnVariant(**variant),
                              1e4, impl=impl)
    got = L.attention_block(tx, tp, torch.arange(12), L.AttnVariant(**variant),
                            1e4, impl=impl)
    assert got.dtype == tx.dtype
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", [dict(kind="full"),
                                     dict(kind="swa", window=4),
                                     dict(kind="swa", window=4, softcap=5.0)],
                         ids=str)
def test_attention_decode_ring_buffer(variant, dtype):
    """Eleven steps through a 6-slot cache: SWA wraps the ring."""
    jp, tp = _attn_params(32, 4, 2, 16, dtype, 8)
    r = _rng(9)
    jdt = getattr(jnp, dtype)
    jck = jcv = jnp.zeros((2, 6, 2, 16), jdt)
    tck = torch.zeros((2, 6, 2, 16), dtype=getattr(torch, dtype))
    tcv = tck.clone()
    for pos in range(11):
        jx, tx = _pair(r.standard_normal((2, 1, 32)).astype(np.float32), dtype)
        want, jck, jcv = JL.attention_decode(
            jx, jp, jck, jcv, jnp.int32(pos), JL.AttnVariant(**variant), 1e4)
        got, tck, tcv = L.attention_decode(
            tx, tp, tck, tcv, pos, L.AttnVariant(**variant), 1e4)
        _close(got, want, dtype)
        _close(tck, jck, dtype)
        _close(tcv, jcv, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False), ("relu2", False)])
def test_mlp_block(act, gated, dtype):
    r = _rng(10)
    shapes = {"w_up": (32, 64), "w_down": (64, 32)}
    if gated:
        shapes["w_gate"] = (32, 64)
    pairs = {k: _pair(r.standard_normal(s).astype(np.float32) / np.sqrt(s[0]),
                      dtype) for k, s in shapes.items()}
    jx, tx = _pair(r.standard_normal((2, 5, 32)).astype(np.float32), dtype)
    want = JL.mlp_block(jx, {k: j for k, (j, _) in pairs.items()}, act)
    got = L.mlp_block(tx, {k: t for k, (_, t) in pairs.items()}, act)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("scale,softcap", [(False, 0.0), (True, 30.0)])
def test_embed_and_unembed(scale, softcap, dtype):
    r = _rng(11)
    jt, tt = _pair(r.standard_normal((50, 32)).astype(np.float32), dtype)
    toks = r.integers(0, 50, (2, 7))
    jx = JL.embed(jnp.asarray(toks), jt, scale_by_sqrt_dim=scale)
    tx = L.embed(torch.from_numpy(toks), tt, scale_by_sqrt_dim=scale)
    assert tx.dtype == tt.dtype
    _close(tx, jx, dtype)
    want = JL.unembed(jx * 4, jt, softcap)
    got = L.unembed(tx * 4, tt, softcap)
    assert got.dtype == torch.float32
    _close(got, want, dtype, rel=True)


def _mamba_params(d, i, n, k, r, dtype, seed):
    """One mamba layer's leaves as (JAX, torch) dicts: the matrices
    normal·1/√fan_in in ``dtype``; A_log, D, dt_bias and conv_b in fp32,
    drawn (the reference initialises the last three to zero)."""
    rng = _rng(seed)
    jp, tp = {}, {}
    for name, shape in M.mamba_param_shapes(d, i, n, k, r).items():
        a = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 2 and name != "A_log":
            a /= np.sqrt(shape[0])
        elif name != "A_log":
            a *= 0.5
        jp[name], tp[name] = _pair(
            a, "float32" if name in T._MAMBA_FP32 else dtype)
    return jp, tp


def _close_mamba(got, want, dtype):
    """fp32 at 1e-5; bf16 at 2e-2 of max|want|."""
    want = _np(want)
    got = got.float().numpy()
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    else:
        np.testing.assert_allclose(got, want, atol=2e-2 * np.abs(want).max(),
                                   rtol=2e-2)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_block(dtype, use_kernel, with_state):
    """Both branches of ``use_kernel`` (the reference's Pallas kernel in
    interpret mode; the port's op takes its plain version on the CPU), the
    plain one in ragged chunks of 8 over S = 20, from a zero or a carried
    conv and ssm state."""
    jp, tp = _mamba_params(32, 64, 8, 4, 2, dtype, 20)
    r = _rng(21)
    jx, tx = _pair(r.standard_normal((2, 20, 32)).astype(np.float32), dtype)
    states = {}
    if with_state:
        (jc, tc), (jh, th) = (
            _pair(r.standard_normal((2, 3, 64)).astype(np.float32), dtype),
            _pair(r.standard_normal((2, 64, 8)).astype(np.float32) * 0.5,
                  "float32"))
        states = dict(conv_state=(jc, tc), ssm_state=(jh, th))
    want = JM.mamba_block(jx, jp, None, return_state=True,
                          use_kernel=use_kernel, chunk=8,
                          **{k: j for k, (j, _) in states.items()})
    got = M.mamba_block(tx, tp, return_state=True, use_kernel=use_kernel,
                        chunk=8, **{k: t for k, (_, t) in states.items()})
    assert got[0].dtype == tx.dtype and got[2].dtype == torch.float32
    for g, w in zip(got, want):
        _close_mamba(g, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba_decode(dtype):
    """Six one-token steps, each from the reference's conv and ssm state:
    the output and both new states."""
    jp, tp = _mamba_params(32, 64, 8, 4, 2, dtype, 22)
    r = _rng(23)
    jconv = jnp.zeros((2, 3, 64), getattr(jnp, dtype))
    jssm = jnp.zeros((2, 64, 8), jnp.float32)
    for _ in range(6):
        jx, tx = _pair(r.standard_normal((2, 1, 32)).astype(np.float32),
                       dtype)
        conv, ssm = _to_port(jconv, dtype), _to_port(jssm, "float32")
        got = M.mamba_decode(tx, tp, conv, ssm)
        want = JM.mamba_decode(jx, jp, jconv, jssm)
        assert got[0].dtype == tx.dtype and got[2].dtype == torch.float32
        for g, w in zip(got, want):
            _close_mamba(g, w, dtype)
        _, jconv, jssm = want


# --------------------------- parameters --------------------------------------

def _jax_params(cfg, seed=0):
    return jax.tree.map(lambda a: np.asarray(a),
                        jax_init_params(cfg, jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("arch", DENSE + [SSM] + MOE)
def test_param_tree_matches_the_reference(arch):
    """Same leaf paths, shapes and dtypes; the port's own draw has the
    reference's init rules (normal·1/√fan_in, zeros, ones)."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jtree = dict(flatten(_jax_params(jcfg)))
    port = dict(flatten(init_params(cfg, torch.Generator().manual_seed(0),
                                    "cpu")))
    defs = dict(flatten(param_defs(cfg)))
    assert set(port) == set(jtree) == set(defs)
    for path, t in port.items():
        a = jtree[path]
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).removeprefix("torch.") == a.dtype.name, path
        if defs[path].init != "normal":
            np.testing.assert_array_equal(t.float().numpy(),
                                          a.astype(np.float32))
        else:
            fan_in = a.shape[-2]
            std = float(t.float().std())
            assert abs(std * np.sqrt(fan_in) - 1) < 0.1, (path, std)


@pytest.mark.parametrize("arch", DENSE + [SSM] + MOE)
def test_param_defs_match_abstract_params_at_full_size(arch):
    """At the published widths, with nothing allocated: the reference's
    ``abstract_params`` leaf for leaf (names, shapes, dtypes)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    want = {path: (tuple(a.shape), a.dtype.name)
            for path, a in flatten(JT.abstract_params(jcfg))}
    got = {path: (d.shape, "float32" if d.dtype == "float32" else cfg.dtype)
           for path, d in flatten(param_defs(cfg))}
    assert got == want


def test_params_from_jax_checks_leaves():
    cfg = get_config("h2o-danube-3-4b").reduced()
    tree = _jax_params(jax_get_config("h2o-danube-3-4b").reduced())
    port = params_from_jax(cfg, tree, device="cpu")
    # bf16 leaves come over bit for bit; norms stay fp32
    wq = port["blocks"]["sub0"]["wq"]
    assert wq.dtype == torch.bfloat16 and port["final_scale"].dtype == \
        torch.float32
    np.testing.assert_array_equal(wq.float().numpy(),
                                  tree["blocks"]["sub0"]["wq"].astype(
                                      np.float32))
    bad = dict(tree, embed=tree["embed"][:-1])
    with pytest.raises(ValueError, match="embed: shape"):
        params_from_jax(cfg, bad, device="cpu")
    missing = {k: v for k, v in tree.items() if k != "final_scale"}
    with pytest.raises(ValueError, match="final_scale"):
        params_from_jax(cfg, missing, device="cpu")
    if not torch.cuda.is_available():
        # the default device is the card: no silent fall back to the CPU
        with pytest.raises(RuntimeError, match="device='cpu'"):
            params_from_jax(cfg, tree)


# --------------------------- the whole model ---------------------------------
#
# fp32: the whole forward and decode step against the reference's, end to
# end.  bf16: sub-layer by sub-layer, each fed the reference's own input
# (and, in decode, its cache), then the final norm and unembedding.  End to
# end in bf16 the reduced configs amplify one-ulp rounding differences
# through their sharp attention (the reference's init draws wq with fan-in
# H, which puts q·k logits near 16): the reference's own jit and op-by-op
# runs of the same bf16 forward disagree beyond 2e-2 of max|logit| on
# gemma2 and starcoder2, so an end-to-end bf16 bar of 2e-2 would measure
# that amplification, not the port.

def _both(arch, dtype, impl="blocked", use_mamba_kernel=False):
    kw = dict(dtype=dtype, attn_impl=impl, use_mamba_kernel=use_mamba_kernel)
    jcfg = jax_get_config(arch).reduced().with_(**kw)
    cfg = get_config(arch).reduced().with_(**kw)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jcfg, cfg, jparams, params


IMPLS = ["flash", "blocked", "ref"]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax_fp32(arch, impl):
    """forward_lm and make_prefill, end to end."""
    jcfg, cfg, jparams, params = _both(arch, "float32", impl)
    toks = _rng(12).integers(0, 256, (2, 16))
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    want, _ = jax.jit(jax_make_forward(jcfg))(jparams, jbatch)
    want_last = jax.jit(jax_make_prefill(jcfg))(jparams, jbatch)
    with torch.inference_mode():
        got, aux = make_forward(cfg)(params, {"tokens": torch.from_numpy(toks)})
        got_last = make_prefill(cfg)(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, "float32")
    _close(got_last, want_last, "float32")


@pytest.mark.parametrize("use_mamba_kernel", [True, False])
def test_ssm_forward_matches_jax_fp32(use_mamba_kernel):
    """Reduced falcon-mamba-7b, forward_lm and make_prefill end to end,
    against the reference with the same ``use_mamba_kernel`` (its Pallas
    scan in interpret mode, or its chunked plain scan)."""
    jcfg, cfg, jparams, params = _both(SSM, "float32",
                                       use_mamba_kernel=use_mamba_kernel)
    toks = _rng(12).integers(0, 256, (2, 16))
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    want, _ = jax.jit(jax_make_forward(jcfg))(jparams, jbatch)
    want_last = jax.jit(jax_make_prefill(jcfg))(jparams, jbatch)
    with torch.inference_mode():
        got, aux = make_forward(cfg)(params, {"tokens": torch.from_numpy(toks)})
        got_last = make_prefill(cfg)(params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    _close(got, want, "float32")
    _close(got_last, want_last, "float32")


@pytest.mark.parametrize("arch", DENSE + [SSM] + MOE)
def test_decode_step_matches_jax_fp32(arch):
    """Twelve decode steps into a 12-token cache (SWA configs keep a ring
    of 8 slots, so it wraps); logits and caches (k and v, or the conv
    window and the ssm state) against the reference."""
    jcfg, cfg, jparams, params = _both(arch, "float32")
    toks = _rng(13).integers(0, 256, (2, 12))
    jcache = jax_init_cache(jcfg, 2, 12)
    cache = init_cache(cfg, 2, 12, device="cpu")
    assert {k: {n: tuple(t.shape) for n, t in v.items()}
            for k, v in cache.items()} == \
        {k: {n: tuple(a.shape) for n, a in v.items()}
         for k, v in jcache.items()}
    jstep = jax.jit(jax_make_serve_step(jcfg))
    step = make_serve_step(cfg)
    with torch.inference_mode():
        for t in range(12):
            want, jcache = jstep(jparams, jcache,
                                 {"token": jnp.asarray(toks[:, t:t + 1],
                                                       jnp.int32),
                                  "pos": jnp.int32(t)})
            got, cache = step(params, cache,
                              {"token": torch.from_numpy(toks[:, t:t + 1]),
                               "pos": t})
            _close(got, want, "float32")
    # the cached k/v are activations (up to ~10 in gemma2): atol scales
    # with their max
    for sub in cache:
        for name in cache[sub]:
            want = _np(jcache[sub][name])
            np.testing.assert_allclose(cache[sub][name].numpy(), want,
                                       atol=1e-4 * np.abs(want).max(),
                                       rtol=1e-4)


def _to_port(a, dtype="bfloat16"):
    return torch.from_numpy(_np(a)).to(getattr(torch, dtype))


def _close_rel(got: torch.Tensor, want, label):
    want = _np(want)
    err = np.abs(got.float().numpy() - want).max() / np.abs(want).max()
    assert err <= 2e-2, (label, err)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax_bf16_sublayer_by_sublayer(arch, impl):
    """Each sub-layer of forward_lm fed the reference's input: its output
    within 2e-2 of max|output|; then the final norm and unembedding within
    2e-2 of max|logit|."""
    _forward_bf16_sublayer_by_sublayer(arch, impl)


@pytest.mark.parametrize("use_mamba_kernel", [True, False])
def test_ssm_forward_matches_jax_bf16_sublayer_by_sublayer(use_mamba_kernel):
    """As above, on reduced falcon-mamba-7b with either scan."""
    _forward_bf16_sublayer_by_sublayer(SSM, "blocked", use_mamba_kernel)


def _forward_bf16_sublayer_by_sublayer(arch, impl, use_mamba_kernel=False):
    jcfg, cfg, jparams, params = _both(arch, "bfloat16", impl,
                                       use_mamba_kernel)
    toks = _rng(12).integers(0, 256, (2, 16))
    jx = JT.embed_inputs(jcfg, jparams, {"tokens": jnp.asarray(toks,
                                                               jnp.int32)})
    with torch.inference_mode():
        x = T.embed_inputs(cfg, params, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_array_equal(x.float().numpy(), _np(jx))
    jpos, pos = jnp.arange(16), torch.arange(16)
    for i in range(cfg.n_blocks):
        for j, spec in enumerate(cfg.pattern):
            jp = jax.tree.map(lambda a: a[i], jparams["blocks"][f"sub{j}"])
            jy, _ = jax.jit(lambda x, p, spec=spec: JT._apply_sub(
                jcfg, spec, x, p, jpos, None))(jx, jp)
            with torch.inference_mode():
                y, _ = T._apply_sub(cfg, spec, _to_port(jx),
                                    T._layer(params["blocks"][f"sub{j}"], i),
                                    pos)
            _close_rel(y, jy, f"block {i} sub {j}")
            jx = jy
    jh = JT._norm(jcfg, jx, jparams, "final")
    table = jparams["embed"] if jcfg.tie_embeddings else jparams["unembed"]
    want = JL.unembed(jh, table, jcfg.final_softcap)
    with torch.inference_mode():
        got = T._unembed(cfg, params, T._norm(cfg, _to_port(jx), params,
                                              "final"))
    _close_rel(got, want, "logits")


def _jax_decode_sub(jcfg, spec, x, p, c, pos):
    """The reference's decode scan body for one sub-layer
    (repro/models/transformer.py decode_step_lm), from its own functions;
    ``c`` holds this layer's cache slices, and the new ones come back."""
    h = JT._norm(jcfg, x, p, "ln1")
    if spec.kind == "attn":
        h, ck, cv = JL.attention_decode(h, p, c["k"], c["v"], pos,
                                        JT._variant(jcfg, spec),
                                        jcfg.rope_theta,
                                        use_rope=jcfg.use_rope)
        c = {"k": ck, "v": cv}
    else:
        h, conv, ssm = JM.mamba_decode(h, p, c["conv"], c["ssm"])
        c = {"conv": conv, "ssm": ssm}
    if jcfg.post_norms:
        h = JT._norm(jcfg, h, p, "post_ln1")
    x = x + h
    if spec.mlp != "none":
        h = JT._norm(jcfg, x, p, "ln2")
        h = JL.mlp_block(h, p, jcfg.mlp_act, None)
        if jcfg.post_norms:
            h = JT._norm(jcfg, h, p, "post_ln2")
        x = x + h
    return x, c


@pytest.mark.parametrize("arch", DENSE + [SSM])
def test_decode_step_matches_jax_bf16_sublayer_by_sublayer(arch):
    """Twelve decode steps through a 12-token cache (the SWA ring wraps):
    at every step each sub-layer is fed the reference's input and cache,
    and its output and updated cache slices are held within 2e-2 of their
    max; the step's logits, from the reference's last hidden state, too."""
    jcfg, cfg, jparams, params = _both(arch, "bfloat16")
    toks = _rng(13).integers(0, 256, (2, 12))
    jcache = jax_init_cache(jcfg, 2, 12)
    jsub = jax.jit(_jax_decode_sub, static_argnums=(0, 1))
    for t in range(12):
        tok = toks[:, t:t + 1]
        jx = JL.embed(jnp.asarray(tok, jnp.int32), jparams["embed"], None,
                      jcfg.embed_scale)
        for i in range(cfg.n_blocks):
            for j, spec in enumerate(cfg.pattern):
                jp = jax.tree.map(lambda a: a[i],
                                  jparams["blocks"][f"sub{j}"])
                jc = jcache[f"sub{j}"]
                c = {name: _to_port(a[i], a.dtype.name)
                     for name, a in jc.items()}
                jy, jnew = jsub(jcfg, spec, jx, jp,
                                {name: a[i] for name, a in jc.items()},
                                jnp.int32(t))
                with torch.inference_mode():
                    y = T._decode_sub(cfg, spec, _to_port(jx),
                                      T._layer(params["blocks"][f"sub{j}"], i),
                                      c, t)
                label = f"step {t} block {i} sub {j}"
                _close_rel(y, jy, label)
                for name in jc:
                    _close_rel(c[name], jnew[name], f"{label} {name}")
                jcache[f"sub{j}"] = {name: a.at[i].set(jnew[name])
                                     for name, a in jc.items()}
                jx = jy
        jh = JT._norm(jcfg, jx, jparams, "final")
        table = jparams["embed"] if jcfg.tie_embeddings else \
            jparams["unembed"]
        want = JL.unembed(jh, table, jcfg.final_softcap)
        with torch.inference_mode():
            got = T._unembed(cfg, params, T._norm(cfg, _to_port(jx), params,
                                                  "final"))
        _close_rel(got, want, f"step {t} logits")


@pytest.mark.parametrize("arch", DENSE + [SSM])
def test_decode_replay_matches_forward(arch):
    """The decode step at each position gives the forward's logits there."""
    cfg = get_config(arch).reduced().with_(dtype="float32", attn_impl="flash",
                                           use_mamba_kernel=True)
    params = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    toks = torch.from_numpy(_rng(14).integers(0, 256, (2, 10)))
    with torch.inference_mode():
        full, _ = make_forward(cfg)(params, {"tokens": toks})
        cache = init_cache(cfg, 2, 10, device="cpu")
        for t in range(10):
            lg, cache = make_serve_step(cfg)(
                params, cache, {"token": toks[:, t:t + 1], "pos": t})
            torch.testing.assert_close(lg[:, 0], full[:, t], atol=1e-4,
                                       rtol=1e-4)


@pytest.mark.parametrize("arch", ["whisper-base", "jamba-1.5-large-398b",
                                  "qwen3-moe-30b-a3b", "llava-next-mistral-7b"])
def test_other_families_name_their_slice(arch):
    """The reference's other families, built field for field in the port's
    schema, are the port's own configs and give the reference's fp32
    logits (and MoE aux) within 1e-4 on the reference's weights: the MoE
    families (qwen3-moe, and jamba's hybrid) on tokens, the
    encoder-decoder on tokens and frame embeddings, the vision model on
    tokens and patch embeddings (the stubs at the scale of the embedding
    table's rows).  The name is the test's from before the encoder-decoder
    and vision slice, when those two were refused."""
    jcfg = jax_get_config(arch).reduced()
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["pattern"] = tuple(LayerSpec(**dataclasses.asdict(s))
                              for s in jcfg.pattern)
    cfg = ModelConfig(**fields)
    assert cfg == get_config(arch).reduced()
    jcfg, cfg = jcfg.with_(dtype="float32"), cfg.with_(dtype="float32")
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(2))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    r = _rng(17)
    batch = {"tokens": r.integers(0, 256, (2, 12)).astype(np.int32)}
    stub = 1 / np.sqrt(cfg.vocab_size)
    if cfg.is_encdec:
        batch["frame_embeds"] = (r.standard_normal((2, 16, cfg.d_model))
                                 * stub).astype(np.float32)
    if cfg.frontend == "vision":
        batch["image_embeds"] = (r.standard_normal(
            (2, cfg.num_frontend_tokens, cfg.d_model)) * stub
        ).astype(np.float32)
    want, jaux = jax.jit(jax_make_forward(jcfg))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    with torch.inference_mode():
        got, aux = make_forward(cfg)(
            params, {k: torch.from_numpy(v) for k, v in batch.items()})
    _close(got, want, "float32")
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4)
