"""The port's training path against the JAX reference, on the CPU: the
schedule and the optimizer (one AdamW or factored step on the same seeded
params and grads), the loss and the train step (dense and MoE), the first
losses of the reference's TINY model and of the ``moe-30m`` preset trained
through the diffusion pipeline from the reference's weights, the flash
op's gradients, checkpoints that each package restores from the other,
and the launchers."""
import contextlib
import dataclasses
import io
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.policies import DispatchPolicy as JDispatchPolicy
from repro.data.dataset import ShardSpec as JShardSpec
from repro.data.pipeline import DiffusionDataPipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.launch import train as jax_launch
from repro.models import init_params as jax_init_params
from repro.models import make_loss_fn as jax_make_loss_fn
from repro.models import make_train_step as jax_make_train_step
from repro.models.config import LayerSpec as JLayerSpec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model import lm_loss as jax_lm_loss
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import adamw as jax_adamw
from repro.train import train as jax_train
from repro.train.optimizer import Optimizer as JOptimizer
from repro.train.optimizer import _global_norm as jax_global_norm
from repro.train.schedule import constant as jax_constant
from repro.train.schedule import warmup_cosine as jax_warmup_cosine
from repro_torch.convert import params_from_jax
from repro_torch.core.policies import DispatchPolicy
from repro_torch.data import DiffusionDataPipeline, PipelineConfig, ShardSpec
from repro_torch.kernels.flash_attention import flash_attention as fa
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.mamba_scan import mamba_scan as ms
from repro_torch.launch import train as launch
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.model import lm_loss, make_loss_fn, make_train_step
from repro_torch.models.transformer import flatten
from repro_torch.train import (CheckpointManager, Optimizer, TrainState,
                               adamw, constant, train, warmup_cosine)
from repro_torch.train.optimizer import global_norm

#: tests/test_pipeline_and_train.py's TINY
TINY_FIELDS = dict(name="tiny", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=256,
                   head_dim=8)
TINY = ModelConfig(**TINY_FIELDS)
JTINY = JModelConfig(**TINY_FIELDS)
#: TINY with an MoE MLP of 4 experts, top-2, in every layer
MOE_FIELDS = dict(TINY_FIELDS, name="tiny-moe", family="moe", n_experts=4,
                  top_k=2)
RTOL = 1e-6   # one optimizer step: fp32 rounding


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops spend most of their time waking threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port_tree(tree):
    """A nested dict of numpy arrays (tuples kept) as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _port_tree(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_port_tree(v) for v in tree)
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _close(got: torch.Tensor, want, rtol=RTOL, atol=0.0, label=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=label)


# --------------------------- schedule and optimizer --------------------------

@pytest.mark.parametrize("warmup,total", [(10, 100), (0, 50), (5, 5)])
def test_schedule_matches_reference(warmup, total):
    mine = warmup_cosine(3e-4, warmup, total)
    ref = jax_warmup_cosine(3e-4, warmup, total)
    for s in sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 1,
                     (warmup + total) // 2, total, total + 7}):
        got = mine(torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        _close(got, ref(jnp.asarray(s, jnp.int32)), label=f"step {s}")
    _close(constant(0.25)(torch.tensor(3)), jax_constant(0.25)(jnp.asarray(3)))


def _opt_case(seed, grad_scale):
    """Seeded params (a layer stack, a matrix, a stacked norm, a vector)
    and grads; ``grad_scale`` sets the global norm (above 1 clips)."""
    rng = np.random.default_rng(seed)
    shapes = {"blocks": {"w": (3, 5, 6), "ln": (3, 6)}, "embed": (7, 6),
              "final_scale": (6,)}

    def draw(tree, scale):
        return {k: draw(v, scale) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in tree.items()}
    params = draw(shapes, 0.5)
    grads = draw(shapes, grad_scale)
    return params, grads


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("grad_scale", [0.01, 1.0], ids=["no-clip", "clip"])
def test_optimizer_steps_match_reference(factored, grad_scale):
    """Two ``apply`` steps (bias corrections at steps 1 and 2) on the same
    params and grads: params, m and v equal the reference's to fp32
    rounding, in the clip branch (gnorm > 1) and out of it."""
    params, grads = _opt_case(3, grad_scale)
    kw = dict(factored=factored)
    jopt = JOptimizer(lr=jax_warmup_cosine(1e-2, 1, 10), **kw)
    opt = Optimizer(lr=warmup_cosine(1e-2, 1, 10), **kw)
    jstate = jopt.init(jax.tree.map(jnp.asarray, params))
    state = opt.init(_port_tree(params))
    gn = float(global_norm(_port_tree(grads)))
    assert (gn > 1.0) == (grad_scale == 1.0)
    np.testing.assert_allclose(gn, float(jax_global_norm(grads)), rtol=RTOL)
    for _ in range(2):
        jstate = jopt.apply(jstate, jax.tree.map(jnp.asarray, grads))
        state = opt.apply(state, _port_tree(grads))
    assert int(state.step) == int(jstate.step) == 2
    assert state.step.dtype == torch.int32
    for (path, got), (_, want) in zip(flatten(state.params),
                                      flatten(_np(jstate.params))):
        _close(got, want, label=f"params/{path}")
    for tree, jtree in ((state.m, jstate.m), (state.v, jstate.v)):
        for (path, got), (_, want) in zip(flatten(tree), flatten(_np(jtree))):
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            for g, w in pairs:
                _close(g, w, atol=1e-12, label=path)


def test_optimizer_updates_bf16_params_as_the_reference():
    """bf16 params and grads: the fp32 update is cast back to bf16, as the
    reference's is; each value equals the reference's or lies one bf16
    step from it (the fp32 results agree to rounding, and a rounding
    boundary between them is rare)."""
    params, grads = _opt_case(5, 0.1)

    def bf16(tree):
        return jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                            tree)
    jopt, opt = jax_adamw(1e-2, 1, 10), adamw(1e-2, 1, 10)
    jstate = jopt.apply(jopt.init(bf16(params)), bf16(grads))
    state = opt.apply(opt.init(_port_tree(bf16(params))),
                      _port_tree(bf16(grads)))
    for (path, got), (_, want) in zip(flatten(state.params),
                                      flatten(_np(jstate.params))):
        assert got.dtype == torch.bfloat16
        _close(got, np.asarray(want, np.float32), rtol=2.0 ** -7,
               label=path)


# --------------------------- loss and train step ------------------------------

def _tiny_weights(cfg_fields, seed=0, dtype="float32", moe=False):
    """Both packages' configs from ``cfg_fields`` (with ``moe``, an MoE MLP
    in every layer), and the reference's weights in each."""
    jkw, kw = (({"pattern": (JLayerSpec(mlp="moe"),)},
                {"pattern": (LayerSpec(mlp="moe"),)}) if moe else ({}, {}))
    jcfg = JModelConfig(**cfg_fields, **jkw).with_(dtype=dtype)
    cfg = ModelConfig(**cfg_fields, **kw).with_(dtype=dtype)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return cfg, jcfg, jparams, params_from_jax(cfg, _np(jparams),
                                               device="cpu")


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


def test_lm_loss_matches_reference():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 9, 17)).astype(np.float32)
    tokens = _tokens(2, 9, 17)
    got = lm_loss(TINY, torch.from_numpy(logits), torch.from_numpy(tokens),
                  torch.zeros(()))
    want = jax_lm_loss(JTINY, jnp.asarray(logits), jnp.asarray(tokens),
                       jnp.zeros(()))
    _close(got, want, rtol=1e-6)


@pytest.mark.parametrize("seq_chunk", [0, 7])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_loss_fn_matches_reference(seq_chunk, softcap):
    """The chunked-vocab CE, one chunk (the adaptive rule at this size)
    and ragged chunks of 7 (the last one shorter), with and without the
    final softcap."""
    fields = dict(TINY_FIELDS, final_softcap=softcap, tie_embeddings=False)
    cfg, jcfg, jparams, params = _tiny_weights(fields)
    tokens = _tokens(2, 19, cfg.vocab_size, seed=4)
    got = make_loss_fn(cfg, seq_chunk=seq_chunk)(
        params, {"tokens": torch.from_numpy(tokens)})
    want = jax_make_loss_fn(jcfg, seq_chunk=seq_chunk)(
        jparams, {"tokens": jnp.asarray(tokens)})
    _close(got, want, rtol=2e-6)


@pytest.mark.parametrize("remat", ["full", "none", "dots"])
@pytest.mark.parametrize("impl", ["blocked", "flash", "ref"])
def test_train_step_matches_reference(impl, remat):
    """One train step in fp32 from the reference's weights: the loss and
    the grad norm agree with the reference's (blocked attention, remat
    full) to 1e-5, whichever attention and remat the port runs, and so does
    every gradient, read from m after the step (m = 0.1 · clip scale · g),
    within 1e-4 of its leaf's max|m| (observed: about 1e-5).  (The parameters themselves are not
    compared here: a first AdamW step moves each by lr·g/(|g|+eps), which
    turns a rounding difference in a gradient near eps into a visible one;
    the optimizer's own tests hold its update to fp32 rounding.)"""
    cfg, jcfg, jparams, params = _tiny_weights(TINY_FIELDS)
    cfg = cfg.with_(attn_impl=impl, remat=remat)
    tokens = _tokens(4, 33, cfg.vocab_size, seed=2)
    opt, jopt = adamw(1e-2, 1, 10), jax_adamw(1e-2, 1, 10)
    jstate, jm = jax_make_train_step(jcfg, jopt)(
        jopt.init(jparams), {"tokens": jnp.asarray(tokens)})
    state, m = make_train_step(cfg, opt)(
        opt.init(params), {"tokens": torch.from_numpy(tokens)})
    assert set(m) == set(jm) == {"loss", "grad_norm", "step"}
    _close(m["loss"], jm["loss"], rtol=1e-5)
    _close(m["grad_norm"], jm["grad_norm"], rtol=1e-5)
    assert int(m["step"]) == int(jm["step"]) == 1
    for (path, got), (_, want) in zip(flatten(state.m),
                                      flatten(_np(jstate.m))):
        _close(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()),
               label=path)


@pytest.mark.parametrize("remat", ["full", "none", "dots"])
def test_moe_train_step_matches_reference(remat):
    """One train step of TINY with an MoE MLP (4 experts, top-2) in every
    layer, in fp32 from the reference's weights (its remat full): the loss
    (with the routers' aux loss) and the grad norm within 1e-5 relative,
    every gradient, read from m, within 1e-4 of its leaf's max|m|; the
    routers' gradients are not zero."""
    cfg, jcfg, jparams, params = _tiny_weights(MOE_FIELDS, moe=True)
    cfg = cfg.with_(attn_impl="flash", remat=remat)
    tokens = _tokens(4, 33, cfg.vocab_size, seed=3)
    opt, jopt = adamw(1e-2, 1, 10), jax_adamw(1e-2, 1, 10)
    jstate, jm = jax_make_train_step(jcfg, jopt)(
        jopt.init(jparams), {"tokens": jnp.asarray(tokens)})
    state, m = make_train_step(cfg, opt)(
        opt.init(params), {"tokens": torch.from_numpy(tokens)})
    _close(m["loss"], jm["loss"], rtol=1e-5)
    _close(m["grad_norm"], jm["grad_norm"], rtol=1e-5)
    for (path, got), (_, want) in zip(flatten(state.m),
                                      flatten(_np(jstate.m))):
        _close(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()),
               label=path)
    router = state.m["blocks"]["sub0"]["w_router"]
    assert all(float(r.abs().max()) > 0 for r in router)


def test_remat_recomputes_each_block_in_the_backward(monkeypatch):
    """remat full runs each block's forward twice per step (the forward,
    then the recompute in the backward); remat none once."""
    cfg, _, _, params = _tiny_weights(TINY_FIELDS)
    tokens = torch.from_numpy(_tokens(2, 9, cfg.vocab_size))
    calls = []
    real = fa_ops.flash_attention

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(fa_ops, "flash_attention", counting)
    embed = params["embed"].requires_grad_()
    for remat, per_layer in (("full", 2), ("none", 1)):
        calls.clear()
        loss = make_loss_fn(cfg.with_(attn_impl="flash", remat=remat))(
            params, {"tokens": tokens})
        torch.autograd.grad(loss, [embed])
        assert len(calls) == per_layer * cfg.n_layers, remat


def _count_products(fn) -> dict:
    """How many ``bmm`` calls ``fn`` makes, by batch: 1 (a product without
    batch dimensions, as ``torch.einsum`` lowers a projection) or more
    (the attention's and the experts' products)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {"batch 1": 0, "batched": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.bmm.default:
                counts["batch 1" if args[0].shape[0] == 1
                       else "batched"] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        fn()
    return counts


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
def test_remat_dots_recomputes_only_the_batched_products(moe):
    """A loss and its gradient under each remat: ``dots`` runs no product
    without batch dimensions again in the backward (as many as remat
    none) and every batched product again (the attention's, and the
    experts' with MoE: remat none's count plus the forward's); ``full``
    reruns both kinds."""
    cfg, _, _, params = _tiny_weights(MOE_FIELDS if moe else TINY_FIELDS,
                                      moe=moe)
    cfg = cfg.with_(attn_impl="ref")
    tokens = torch.from_numpy(_tokens(2, 9, cfg.vocab_size))
    embed = params["embed"].requires_grad_()

    def step(remat):
        loss = make_loss_fn(cfg.with_(remat=remat))(params,
                                                    {"tokens": tokens})
        torch.autograd.grad(loss, [embed])
    with torch.no_grad():
        forward = _count_products(
            lambda: make_loss_fn(cfg)(params, {"tokens": tokens}))
    none, dots, full = (_count_products(lambda: step(r))
                        for r in ("none", "dots", "full"))
    assert forward["batched"] > 0 and forward["batch 1"] > 0
    assert dots == {"batch 1": none["batch 1"],
                    "batched": none["batched"] + forward["batched"]}
    assert full["batched"] == dots["batched"]
    assert full["batch 1"] > none["batch 1"]


@pytest.mark.parametrize("arch", ["whisper-base", "llava-next-mistral-7b"])
def test_encdec_and_vision_training_name_their_slices(arch):
    """The reference's encoder-decoder and vision configs, built field for
    field in the port's schema, are the port's own; since their slice they
    train: one step in fp32 from the reference's weights, on the
    reference loop's batch with its frontend stub (zero frames, zero
    patches), the loss within 1e-5 relative of the reference's; the grad
    norm within 1e-5 relative and every gradient, read from m, within 1e-4
    of its leaf's max|m|, or for whisper, whose fp32 step is
    ill-conditioned, within twice the reference's own spread under one-ulp
    weight noise where that is larger (as in
    ``tests/test_torch_encdec.py``).  The name is the test's from before
    that slice, when the step was refused."""
    from repro_torch.configs import get_config
    from repro_torch.train.loop import train_batch

    jcfg = jax_get_config(arch).reduced()
    fields = {f.name: getattr(jcfg, f.name)
              for f in dataclasses.fields(jcfg)}
    fields["pattern"] = tuple(LayerSpec(**dataclasses.asdict(sp))
                              for sp in jcfg.pattern)
    cfg = ModelConfig(**fields)
    assert cfg == get_config(arch).reduced()
    jcfg, cfg = jcfg.with_(dtype="float32"), cfg.with_(dtype="float32")
    np_params = _np(jax_init_params(jcfg, jax.random.PRNGKey(4)))
    params = params_from_jax(cfg, np_params, device="cpu")
    batch = train_batch(cfg, torch.from_numpy(
        _tokens(2, 17, cfg.vocab_size, seed=5)))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    jopt = jax_adamw(1e-2, 1, 10)
    jstep = jax.jit(jax_make_train_step(jcfg, jopt))

    def gaps(m, moments, jm, jmoments):
        gn = abs(float(m["grad_norm"]) - float(jm["grad_norm"])) / float(
            jm["grad_norm"])
        return gn, max(float(np.abs(np.asarray(a, np.float64) - b).max()
                             / np.abs(b).max())
                       for a, b in zip(moments, jmoments))
    jstate, jm = jstep(jopt.init(jax.tree.map(jnp.asarray, np_params)),
                       jbatch)
    jmoments = [w for _, w in flatten(_np(jstate.m))]
    opt = adamw(1e-2, 1, 10)
    state, m = make_train_step(cfg.with_(attn_impl="flash"), opt)(
        opt.init(params), batch)
    _close(m["loss"], jm["loss"], rtol=1e-5)
    gn_bar, m_bar = 1e-5, 1e-4
    if cfg.is_encdec:
        rng = np.random.default_rng(5)
        for _ in range(2):
            noisy = jax.tree.map(lambda a: jnp.asarray(
                (a * (1 + 2.0 ** -23 * rng.standard_normal(a.shape))
                 ).astype(a.dtype)), np_params)
            nstate, nm = jstep(jopt.init(noisy), jbatch)
            gn, mm = gaps(nm, [w for _, w in flatten(_np(nstate.m))], jm,
                          jmoments)
            gn_bar, m_bar = max(gn_bar, 2 * gn), max(m_bar, 2 * mm)
    gn_gap, m_gap = gaps(m, [t.numpy() for _, t in flatten(state.m)], jm,
                         jmoments)
    assert gn_gap <= gn_bar, (gn_gap, gn_bar)
    assert m_gap <= m_bar, (m_gap, m_bar)


# --------------------------- flash gradients ---------------------------------

@pytest.mark.parametrize("causal,window,softcap",
                         [(True, 0, 0.0), (True, 5, 0.0), (True, 0, 30.0),
                          (False, 0, 0.0)])
def test_flash_ref_vjp_gradients_equal_attention_ref(causal, window, softcap):
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(s, np.float32))
               for s in ((2, 11, 4, 8), (2, 11, 2, 8), (2, 11, 2, 8)))
    g = torch.from_numpy(rng.standard_normal((2, 11, 4, 8), np.float32))
    kw = dict(causal=causal, window=window, softcap=softcap)

    def grads(fn):
        ins = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*ins)
        return [out, *torch.autograd.grad(out, ins, g)]

    got = grads(lambda *a: fa_ops.flash_attention_with_ref_vjp(*a, **kw))
    want = grads(lambda q, k, v: attention_ref(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        **kw).transpose(1, 2))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got[0].grad_fn is not None


def test_kernel_wrappers_refuse_inputs_that_require_grad():
    """The forward-only kernels raise (before anything else) where grad
    mode is on and an input requires grad; under no_grad they go on to
    their checks (here: the tensors are not on a card)."""
    q = torch.zeros(1, 2, 4, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention_fwd(q, q[:, :1], q[:, :1])
    with torch.no_grad(), pytest.raises(ValueError, match="on cpu"):
        fa.flash_attention_fwd(q, q[:, :1], q[:, :1])
    u = torch.zeros(1, 4, 8, requires_grad=True)
    A, bc = torch.zeros(8, 2), torch.zeros(1, 4, 2)
    with pytest.raises(RuntimeError, match="u, dt require grad"):
        ms.mamba_scan_fwd(u, u, A, bc, bc, torch.zeros(8))
    with torch.no_grad(), pytest.raises(ValueError, match="on cpu"):
        ms.mamba_scan_fwd(u, u, A, bc, bc, torch.zeros(8))


# --------------------------- training through the pipeline -------------------

def _pipelines(seed=0, vocab_size=256):
    kw = dict(global_batch=4, seq_len=32, n_hosts=3, host_cache_bytes=1 << 24,
              seed=seed)
    spec = dict(n_shards=4, tokens_per_shard=4096, vocab_size=vocab_size,
                seed=seed)
    return (JPipeline(JPipelineConfig(policy=JDispatchPolicy.MAX_COMPUTE_UTIL,
                                      **kw), JShardSpec(**spec)),
            DiffusionDataPipeline(
                PipelineConfig(policy=DispatchPolicy.MAX_COMPUTE_UTIL, **kw),
                ShardSpec(**spec), device="cpu"))


def _train_both(dtype, n_steps, impl="blocked", seed=0):
    cfg, jcfg, jparams, params = _tiny_weights(TINY_FIELDS, seed, dtype)
    jpipe, pipe = _pipelines()
    try:
        ref = jax_train(jcfg, jpipe, n_steps, seed=seed, log=lambda s: None)
        got = train(cfg.with_(attn_impl=impl), pipe, n_steps, seed=seed,
                    log=lambda s: None, params=params, device="cpu")
    finally:
        jpipe.close()
        pipe.close()
    return got, ref


@pytest.mark.parametrize("impl", ["blocked", "flash"])
def test_first_losses_match_reference_fp32(impl):
    """TINY in fp32 from the reference's weights, through both pipelines
    (the same batches): the first 5 losses agree at rtol 1e-4 (observed:
    at most 8.6e-8 relative, blocked or flash)."""
    got, ref = _train_both("float32", 5, impl)
    assert got.steps_run == ref.steps_run == 5
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    assert got.pipeline_stats == ref.pipeline_stats


def test_first_loss_matches_reference_bf16():
    """TINY in bf16 (its configured dtype): the first loss agrees at
    2e-2 relative (observed: 7.2e-5)."""
    got, ref = _train_both("bfloat16", 1)
    np.testing.assert_allclose(got.losses[0], ref.losses[0], rtol=2e-2)


def _example(name: str):
    """``examples/<name>`` imported as a module."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / name
    spec = importlib.util.spec_from_file_location(f"_ref_{path.stem}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_moe_30m_preset_first_losses_match_reference_fp32():
    """The app's ``moe-30m`` preset, which is ``examples/train_lm.py``'s, in
    fp32 from the reference's weights, with the example's optimizer, both
    trained through their pipelines (the same batches, 4 x 32 tokens of its
    vocabulary).  The port runs its flash attention (on the CPU the plain
    attention, whose autograd is its backward on the card too): its first
    5 losses agree at rtol 1e-4 with the reference's on the same
    arithmetic, its plain ``ref`` attention (observed: at most 4.5e-5).
    Against the example's default ``blocked`` attention they sit within
    twice the reference's own blocked-vs-ref gap: at this preset's random
    init the first AdamW steps amplify rounding, and that gap passes 1e-4
    by step 4 (observed: 5.5e-4)."""
    from repro_torch.apps import train_lm

    example = _example("train_lm.py")
    assert dataclasses.asdict(train_lm.PRESETS["moe-30m"]) == \
        dataclasses.asdict(example.PRESETS["moe-30m"])
    jcfg = example.PRESETS["moe-30m"].with_(dtype="float32")
    cfg = train_lm.PRESETS["moe-30m"].with_(dtype="float32")
    params = params_from_jax(
        cfg, _np(jax_init_params(jcfg, jax.random.PRNGKey(0))), device="cpu")
    ref, got = {}, None
    for impl in ("ref", "blocked"):
        jpipe, pipe = _pipelines(vocab_size=cfg.vocab_size)
        try:
            ref[impl] = jax_train(jcfg.with_(attn_impl=impl), jpipe, 5,
                                  seed=0, log=lambda s: None,
                                  optimizer=jax_adamw(3e-4, warmup=20,
                                                      total=5)).losses
            if got is None:
                got = train(cfg.with_(attn_impl="flash"), pipe, 5, seed=0,
                            log=lambda s: None, params=params, device="cpu",
                            optimizer=adamw(3e-4, warmup=20, total=5))
        finally:
            jpipe.close()
            pipe.close()
    assert got.steps_run == 5
    np.testing.assert_allclose(got.losses, ref["ref"], rtol=1e-4)
    blocked = np.asarray(ref["blocked"])
    self_gap = np.abs(np.asarray(ref["ref"]) - blocked).max() / blocked.max()
    gap = np.abs(np.asarray(got.losses) - blocked).max() / blocked.max()
    assert gap <= 2 * self_gap, (gap, self_gap)


def test_train_loss_decreases_and_ledger_populated():
    _, pipe = _pipelines()
    try:
        res = train(TINY, pipe, n_steps=20, log=lambda s: None,
                    optimizer=adamw(5e-3, warmup=2, total=20), device="cpu")
    finally:
        pipe.close()
    assert res.steps_run == 20 and len(res.step_seconds) == 20
    # window means: single-step losses are noisy at batch 4
    assert np.mean(res.losses[-5:]) < np.mean(res.losses[:5])
    assert res.pipeline_stats["bytes_store"] > 0


def test_train_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    _, pipe = _pipelines()
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train(TINY, pipe, 1, log=lambda s: None)
    finally:
        pipe.close()


# --------------------------- checkpoints --------------------------------------

def test_checkpoint_restart_reproduces_uninterrupted_run(tmp_path):
    """Kill-and-restart fault tolerance: losses after resume match the
    uninterrupted run (the schedule is a pure function of step)."""
    def run(steps, ckpt):
        _, pipe = _pipelines(seed=1)
        logs = []
        try:
            return train(TINY, pipe, n_steps=steps, ckpt_dir=str(ckpt),
                         ckpt_every=4, seed=7, log=logs.append,
                         device="cpu"), logs
        finally:
            pipe.close()

    full, _ = run(8, tmp_path / "a")
    run(4, tmp_path / "b")                     # "crash" after 4 (checkpointed)
    resumed, logs = run(8, tmp_path / "b")     # restart picks up at step 4
    assert resumed.resumed_from == 4
    assert logs[0] == "[train] resumed from checkpoint step 4"
    np.testing.assert_allclose(resumed.losses, full.losses[4:], rtol=1e-5)


def test_checkpoint_atomicity_and_retention(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones((2, 2))}}
    for s in (1, 2, 3):
        mgr.save(s, tree)
    assert mgr.steps() == [2, 3]                    # retention
    # a torn save (tmp dir without manifest rename) must be invisible
    (tmp_path / "step_9.tmp").mkdir()
    assert mgr.steps() == [2, 3]
    step, restored = mgr.restore_latest(tree)
    assert step == 3
    torch.testing.assert_close(restored["a"], tree["a"], rtol=0, atol=0)
    torch.testing.assert_close(restored["b"]["c"], tree["b"]["c"], rtol=0,
                               atol=0)


def test_async_checkpoint_snapshots_before_the_state_moves(tmp_path):
    mgr = CheckpointManager(tmp_path, async_save=True)
    tree = {"w": torch.ones(3)}
    mgr.save(1, tree)
    tree["w"].add_(5.0)              # the loop updates in place at once
    mgr.wait()
    _, restored = mgr.restore_latest(tree)
    assert restored["w"].tolist() == [1.0, 1.0, 1.0]


def _states(factored):
    """The reference's and the port's TrainState after one step of TINY
    in bf16 (bf16 params, fp32 moments; factored v as pairs)."""
    cfg, jcfg, jparams, params = _tiny_weights(TINY_FIELDS, 3, "bfloat16")
    tokens = _tokens(2, 17, cfg.vocab_size, seed=3)
    jopt = jax_adamw(1e-2, 1, 10, factored=factored)
    jstate, _ = jax_make_train_step(jcfg, jopt)(
        jopt.init(jparams), {"tokens": jnp.asarray(tokens)})
    opt = adamw(1e-2, 1, 10, factored=factored)
    state, _ = make_train_step(cfg, opt)(
        opt.init(params), {"tokens": torch.from_numpy(tokens)})
    return jstate, state


def _leaves(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for f in tree._fields for x in _leaves(getattr(tree, f))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bits(x) -> np.ndarray:
    """The raw bytes of a leaf, whichever package holds it."""
    if isinstance(x, torch.Tensor):
        t = x.detach().contiguous()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("factored", [False, True])
def test_checkpoints_cross_between_the_packages(tmp_path, factored):
    """The port restores the reference's checkpoint of a TrainState, and
    the reference restores the port's, bit for bit (bf16 leaves included),
    and the two write the same leaf names in the same order."""
    jstate, state = _states(factored)
    JCheckpointManager(tmp_path / "jax").save(1, jstate)
    CheckpointManager(tmp_path / "port").save(1, state)
    jl, pl = (json.loads((tmp_path / d / "step_1" / "manifest.json")
                         .read_text())["leaves"] for d in ("jax", "port"))
    assert [(e["name"], e["dtype"], e["shape"]) for e in jl] == \
        [(e["name"], e["dtype"], e["shape"]) for e in pl]
    assert jl[0]["name"] == ".step"
    assert any(e["dtype"] == "bfloat16" for e in jl)
    # the port reads the reference's
    _, got = CheckpointManager(tmp_path / "jax").restore_latest(state)
    assert isinstance(got, TrainState)
    for a, b in zip(_leaves(got), _leaves(jstate)):
        assert a.dtype == (torch.bfloat16 if np.asarray(b).dtype.name ==
                           "bfloat16" else a.dtype)
        np.testing.assert_array_equal(_bits(a), _bits(b))
    # the reference reads the port's
    _, back = JCheckpointManager(tmp_path / "port").restore_latest(jstate)
    for a, b in zip(_leaves(back), _leaves(state)):
        np.testing.assert_array_equal(_bits(a), _bits(b))


# --------------------------- launchers ----------------------------------------

_DONE = re.compile(r"^\[train\] done: 2 steps, final loss \d+\.\d{4}$")


def test_launcher_prints_the_reference_lines():
    """``--reduced --device cpu --steps 2``: the reference's [train] lines
    (the loss differs: each package draws its own weights; the ledger is
    the same), then the times line."""
    argv = ["--arch", "h2o-danube-3-4b", "--reduced", "--steps", "2"]
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert jax_launch.main(argv) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert launch.main(argv + ["--device", "cpu"]) == 0
    jlines, lines = jout.getvalue().splitlines(), out.getvalue().splitlines()
    assert len(jlines) == 2 and len(lines) == 3
    assert _DONE.match(jlines[0]) and _DONE.match(lines[0])
    assert lines[1] == jlines[1]
    assert lines[1].startswith("[train] diffusion ledger: {'bytes_local'")
    assert lines[2].startswith("[train] on cpu") and "tokens/s" in lines[2]


def test_10m_preset_logits_and_first_loss_match_reference():
    """The app's ``10m`` preset (examples/train_lm.py's) in fp32 from the
    reference's weights.  At 4 layers these random weights amplify fp32
    rounding: the reference's own blocked and ref attention part by about
    1.4e-4 of max|logit|.  The port's logits sit no further from the
    reference's than twice that gap, and the loss agrees at 1e-5
    relative."""
    from repro.models import make_forward as jax_make_forward
    from repro_torch.apps import train_lm
    from repro_torch.models import make_forward

    fields = dict(name="lm-10m", family="dense", n_layers=4, d_model=256,
                  n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=8192,
                  head_dim=32)
    assert train_lm.PRESETS["10m"] == ModelConfig(**fields)
    cfg, jcfg, jparams, params = _tiny_weights(fields)
    tokens = _tokens(2, 33, cfg.vocab_size, seed=6)
    batch, jbatch = ({"tokens": torch.from_numpy(tokens)},
                     {"tokens": jnp.asarray(tokens)})
    with torch.no_grad():
        logits, _ = make_forward(cfg)(params, batch)
        loss = make_loss_fn(cfg)(params, batch)
    jlogits = np.asarray(jax_make_forward(jcfg)(jparams, jbatch)[0])
    jref = np.asarray(jax_make_forward(jcfg.with_(attn_impl="ref"))(
        jparams, jbatch)[0])
    scale = float(np.abs(jlogits).max())
    self_gap = float(np.abs(jref - jlogits).max()) / scale
    gap = float(np.abs(logits.numpy() - jlogits).max()) / scale
    assert 0 < self_gap < 1e-3
    assert gap <= 2 * self_gap, (gap, self_gap)
    _close(loss, jax_make_loss_fn(jcfg)(jparams, jbatch), rtol=1e-5)


def test_train_lm_app_runs_and_resumes(tmp_path):
    from repro_torch.apps import train_lm

    argv = ["--device", "cpu", "--global-batch", "2",
            "--seq-len", "16", "--shards", "2", "--ckpt-dir", str(tmp_path)]
    for steps, resumed in (("2", "None"), ("3", "2"), ("3", "3")):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert train_lm.main(argv + ["--steps", steps]) == 0
        lines = out.getvalue().splitlines()
        assert lines[0].startswith("training lm-10m: ")
        assert f"resumed from checkpoint: {resumed}" in lines
    assert train_lm.DEFAULT_CKPT_DIR.parts[-2:] == ("build", "train_lm_ckpt")
    # the moe-30m preset trains too
    argv[-1] = str(tmp_path / "moe")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert train_lm.main(argv + ["--preset", "moe-30m", "--steps",
                                     "2"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("training lm-moe-30m: ")
    assert "resumed from checkpoint: None" in lines
    assert any(line.startswith("final loss: ") for line in lines)
