"""The port's MoE layer against the JAX reference, on the CPU.

The router, the sort+gather dispatch and combine (``_local_route``,
``_combine``) and ``moe_block`` on the same seeded inputs, in fp32: at the
configs' capacity factor 1.25 and at 0.5, where many (token, choice) pairs
fall past capacity.  The port must drop exactly the pairs the reference
drops (its cumsum over the pairs in token-major order) and match its
outputs and aux loss within 1e-5 relative.  ``moe_block_onehot``, the
reference's one-hot formulation in the port, is the plain version that
``moe_block`` is held against on the card; here it equals ``moe_block``
and the reference.  Then the MoE models whole: the ``reduced()`` forms of
qwen3-moe, mixtral and jamba on the reference's own weights.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import init_params as jax_init_params
from repro.models import moe as JM
from repro.models.model import make_forward as jax_make_forward
from repro.models.model import make_prefill as jax_make_prefill
from repro_torch.configs import REGISTRY, get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import make_forward, make_prefill
from repro_torch.models import moe as M
from repro_torch.models import transformer as T

MOE = sorted(k for k, c in REGISTRY.items() if c.family in ("moe", "hybrid"))

#: (B, S, D, E, F, top_k): the reduced configs' router, and a wider one
SHAPES = [(2, 12, 32, 4, 48, 2), (3, 16, 64, 16, 40, 4)]
CAPACITY_FACTORS = [1.25, 0.5]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops spend most of their time waking threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(shape, gated=True, seed=0):
    """Seeded x and one MoE layer's parameters, as numpy arrays."""
    B, S, D, E, F, _ = shape
    rng = np.random.default_rng(seed)
    p = {"w_router": rng.standard_normal((D, E)).astype(np.float32),
         "w_up": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(
             np.float32),
         "w_down": (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(
             np.float32)}
    if gated:
        p["w_gate"] = (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(
            np.float32)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    return x, p


def _torch(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def _jax(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


def _rel(got, want):
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


def _reference_drops(idx: np.ndarray, E: int, cap: int) -> np.ndarray:
    """The reference's kept (token, choice) pairs, (T, k) bool: its queue
    position is the count of earlier pairs (token-major) on the same
    expert."""
    flat = np.eye(E, dtype=np.int64)[idx.reshape(-1)]
    pos = ((np.cumsum(flat, 0) - flat) * flat).sum(-1)
    return (pos < cap).reshape(idx.shape)


def test_capacity_is_the_reference_formula():
    for T, E, k, cf in [(768, 128, 8, 1.25), (8, 128, 8, 1.25),
                        (24, 4, 2, 0.5), (1, 16, 2, 0.1), (100, 7, 3, 1.0)]:
        want = int(max(k * cf * ((T + E - 1) // E), 1))
        assert M.capacity(T, E, k, cf) == want


def test_moe_param_shapes_match_the_reference():
    for gated in (True, False):
        want = {k: shape for k, (shape, _) in
                JM.moe_param_shapes(48, 96, 8, gated).items()}
        assert M.moe_param_shapes(48, 96, 8, gated) == want


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_router_probs_matches_reference(shape):
    x, p = _case(shape)
    k = shape[-1]
    xt = x.reshape(-1, x.shape[-1])
    jg, ji = JM.router_probs(jnp.asarray(xt), jnp.asarray(p["w_router"]), k)
    g, i = M.router_probs(torch.from_numpy(xt),
                          torch.from_numpy(p["w_router"]), k)
    assert g.dtype == torch.float32
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(g.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_local_route_and_combine_match_reference(shape, cf):
    """On the reference's own routing: the same dispatch tensor bit for
    bit, the same expert, slot and in-capacity flag for every pair, and
    the same combine within 1e-5 relative."""
    x, p = _case(shape, seed=1)
    B, S, D, E, _, k = shape
    T = B * S
    xt = x.reshape(T, D)
    jg, ji = JM.router_probs(jnp.asarray(xt), jnp.asarray(p["w_router"]), k)
    cap = M.capacity(T, E, k, cf)
    jdisp, jinfo = JM._local_route(jnp.asarray(xt), jg, ji, E, cap)
    g, i = torch.from_numpy(np.array(jg)), torch.from_numpy(
        np.array(ji)).long()
    disp, info = M._local_route(torch.from_numpy(xt), g, i, E, cap)
    np.testing.assert_array_equal(disp.numpy(), np.asarray(jdisp))
    for got, want in zip(info, jinfo):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(info[2].numpy().reshape(T, k),
                                  _reference_drops(np.asarray(ji), E, cap))
    ex_out = np.random.default_rng(2).standard_normal(
        (E, cap, D)).astype(np.float32)
    want = JM._combine(jnp.asarray(ex_out), jinfo, jg, T, k)
    got = M._combine(torch.from_numpy(ex_out), info, g, T, k)
    assert _rel(got.numpy(), want) <= 1e-5


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_moe_block_drops_and_matches_reference(shape, cf, act, gated):
    """moe_block in fp32: the dropped set equals the reference's exactly
    (and is not empty at cf 0.5), the output and aux within 1e-5
    relative."""
    x, p = _case(shape, gated, seed=3)
    B, S, D, E, _, k = shape
    T = B * S
    want, jaux = JM.moe_block(jnp.asarray(x), _jax(p), k, act, cf)
    got, aux = M.moe_block(torch.from_numpy(x), _torch(p), k, act, cf)
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= 1e-5
    assert aux.dim() == 0 and aux.dtype == torch.float32
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    # the drops: the reference's from its routing, the port's from its own
    _, ji = JM.router_probs(jnp.asarray(x.reshape(T, D)),
                            jnp.asarray(p["w_router"]), k)
    cap = M.capacity(T, E, k, cf)
    xt = torch.from_numpy(x.reshape(T, D))
    g, i = M.router_probs(xt, torch.from_numpy(p["w_router"]), k)
    _, (_, _, in_cap) = M._local_route(xt, g, i, E, cap)
    kept = _reference_drops(np.asarray(ji), E, cap)
    np.testing.assert_array_equal(in_cap.numpy().reshape(T, k), kept)
    if cf < 1:
        assert (~kept).sum() > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_moe_block_onehot_equals_moe_block(cf, dtype):
    """The one-hot formulation and the sort+gather one on the same inputs:
    the same aux bit for bit, outputs within 1e-6 of max|output| in fp32
    (the combine sums in another order) and 1e-2 in bf16; in fp32 the
    one-hot one also matches the reference within 1e-5 relative."""
    shape = SHAPES[1]
    x, p = _case(shape, seed=4)
    k = shape[-1]
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    tp = {n: (t if n == "w_router" else t.to(tdt))
          for n, t in _torch(p).items()}
    got, aux = M.moe_block(tx, tp, k, "silu", cf)
    want, aux1 = M.moe_block_onehot(tx, tp, k, "silu", cf)
    assert got.dtype == want.dtype == tdt
    assert float(aux) == float(aux1)
    tol = 1e-6 if dtype == "float32" else 1e-2
    assert _rel(got.float().numpy(), want.float().numpy()) <= tol
    if dtype == "float32":
        jwant, _ = JM.moe_block(jnp.asarray(x), _jax(p), k, "silu", cf)
        assert _rel(want.numpy(), jwant) <= 1e-5


def test_moe_block_gradients_match_reference():
    """d(sum(out · w) + aux)/d(x, every parameter) in fp32 at cf 0.5
    (pairs dropped): within 1e-5 of each leaf's max|g| of the
    reference's."""
    import jax

    shape = SHAPES[0]
    x, p = _case(shape, seed=5)
    k = shape[-1]
    w = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)

    def jloss(x, p):
        out, aux = JM.moe_block(x, p, k, "silu", 0.5)
        return jnp.sum(out * w) + aux
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), _jax(p))
    tx = torch.from_numpy(x).requires_grad_()
    tp = {n: t.requires_grad_() for n, t in _torch(p).items()}
    out, aux = M.moe_block(tx, tp, k, "silu", 0.5)
    names = sorted(tp)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum() + aux,
                                [tx] + [tp[n] for n in names])
    for label, got, want in zip(["x"] + names, grads,
                                [jgx] + [jgp[n] for n in names]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=label)


# --------------------------- the MoE models ----------------------------------

def _both(arch, dtype):
    """Both packages' ``reduced()`` config in ``dtype``, and the
    reference's weights in each."""
    jcfg = jax_get_config(arch).reduced().with_(dtype=dtype)
    cfg = get_config(arch).reduced().with_(dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(1))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("impl", ["flash", "blocked"])
@pytest.mark.parametrize("arch", MOE)
def test_moe_forward_matches_jax_fp32(arch, impl):
    """Reduced qwen3-moe, mixtral and jamba, forward_lm and make_prefill end
    to end against the reference (blocked attention, plain scan): logits
    and the routers' aux loss within 1e-4.  The port runs ``impl``, and
    with flash also the scan op (on the CPU both take their plain
    versions).  Jamba's MoE layers drop (token, choice) pairs at this
    size (21 of its 8 x 64 routed pairs), so its drops are held too."""
    jcfg, cfg, jparams, params = _both(arch, "float32")
    cfg = cfg.with_(attn_impl=impl, use_mamba_kernel=impl == "flash")
    toks = np.random.default_rng(15).integers(0, 256, (2, 16))
    jbatch = {"tokens": jnp.asarray(toks, jnp.int32)}
    want, jaux = jax.jit(jax_make_forward(jcfg))(jparams, jbatch)
    want_last = jax.jit(jax_make_prefill(jcfg))(jparams, jbatch)
    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(toks)}
        got, aux = make_forward(cfg)(params, batch)
        got_last = make_prefill(cfg)(params, batch)
    assert aux.dtype == torch.float32 and aux.dim() == 0
    assert float(jaux) > 0
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-4)
    for a, b in ((got, want), (got_last, want_last)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-4)


def test_moe_block_in_the_model_matches_jax_bf16():
    """Reduced qwen3-moe in bf16, each layer's MoE block (the reference's
    ``moe_block_sharded`` without a mesh) on the reference's own normed
    input: within 2e-2 of max|output|, aux within 1e-2 relative."""
    jcfg, cfg, jparams, params = _both("qwen3-moe-30b-a3b", "bfloat16")
    x = np.random.default_rng(16).standard_normal((2, 16, cfg.d_model))
    jx = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)
    for i in range(cfg.n_blocks):
        jp = jax.tree.map(lambda a: a[i], jparams["blocks"]["sub0"])
        jy, jaux = JM.moe_block_sharded(jx, jp, jcfg, None)
        with torch.inference_mode():
            y, aux = M.moe_block_sharded(
                tx, T._layer(params["blocks"]["sub0"], i), cfg)
        assert y.dtype == torch.bfloat16
        assert _rel(y.float().numpy(), jy.astype(jnp.float32)) <= 2e-2, i
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-2)
