"""The port's encoder-decoder (whisper-base) and vision model
(llava-next-mistral-7b) against the JAX reference, on the CPU.

Each test runs the reference's function (attention ``blocked``, as the
reference's own tests run it) and the port's counterpart on the same
inputs, made from numpy seeds, in fp32 at the configs' ``reduced()``
widths, with the reference's weights carried over by
``convert.params_from_jax``.  The port runs its plain attention here, under
``attn_impl`` ``blocked`` and ``flash`` (on the CPU the flash op is the
kernel's plain version).

The stub frontends' embeddings (whisper's frames, llava's patches) are
drawn at the scale of the embedding table's rows (1/√V, the reference's
init), the scale of the token embeddings beside them.  At unit scale these
random weights are ill-conditioned: the port's encoder output differs from
the reference's by fp32 rounding (about 1e-5 of its max, after a final
LayerNorm over a residual stream 20x larger), and the reference's own
decoder amplifies such a change of its input 8-10x (observed up to 1.03e-4
of max|logit| end to end at seed 3), where at the table's scale the gap
is about 1.2e-5.

Tolerances: ``_sinusoid`` 1e-6; cross-attention 1e-5; ``encode`` 1e-5 of
max|x|; logits 1e-4 of max|logit|; the splice exact; the train steps the
rule of ``tests/test_torch_train.py`` (loss and grad norm 1e-5 relative,
each gradient, read from the first moment, within 1e-4 of its leaf's
max|m|), whisper's gradients within twice the reference's own spread
where that is larger (``test_train_step_matches_reference``).
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve_launch
from repro.launch import train as jax_train_launch
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import make_train_step as jax_make_train_step
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.models.model import make_forward as jax_make_forward
from repro.models.model import make_hidden_forward as jax_make_hidden
from repro.models.model import make_prefill as jax_make_prefill
from repro.models.model import make_serve_step as jax_make_serve_step
from repro.train import adamw as jax_adamw
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.launch import serve as serve_launch
from repro_torch.launch import train as train_launch
from repro_torch.models import (init_cache, init_params, make_forward,
                                make_prefill, make_serve_step,
                                make_train_step, param_defs)
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.model import make_hidden_forward, make_loss_fn
from repro_torch.models.transformer import flatten
from repro_torch.train import adamw, loop

WHISPER, LLAVA = "whisper-base", "llava-next-mistral-7b"
IMPLS = ["blocked", "flash"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops spend most of their time waking threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x) -> np.ndarray:
    """``x`` as a writable fp32 numpy array."""
    return np.array(jnp.asarray(x, jnp.float32))


def _rel_close(got: torch.Tensor, want, rel: float, label: str = ""):
    """``got`` within ``rel`` of max|want| of ``want``."""
    want = _np(want)
    got = got.detach().float().numpy()
    assert got.shape == want.shape, label
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * float(np.abs(want).max()),
                               err_msg=label)


def _both(arch, impl="blocked", seed=0, **kw):
    """The reduced fp32 config in each package (the port's with ``impl``)
    and the reference's weights in each."""
    jcfg = jax_get_config(arch).reduced().with_(dtype="float32", **kw)
    cfg = get_config(arch).reduced().with_(dtype="float32", attn_impl=impl,
                                           **kw)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")


def _stub(cfg, shape, seed):
    """Frontend embeddings at the scale of the embedding table's rows."""
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) / np.sqrt(cfg.vocab_size)
            ).astype(np.float32)


def _batches(cfg, b=2, s=12, s_enc=20, seed=0):
    """The same batch for both packages: tokens, and the config's stub
    frontend embeddings (frames (B, S_enc, D) for the encoder-decoder,
    patches (B, T, D) for the vision model)."""
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)
    batch = {"tokens": toks}
    if cfg.is_encdec:
        batch["frame_embeds"] = _stub(cfg, (b, s_enc, cfg.d_model), seed + 1)
    if cfg.frontend == "vision":
        batch["image_embeds"] = _stub(
            cfg, (b, cfg.num_frontend_tokens, cfg.d_model), seed + 1)
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


# --------------------------- configs and parameters -------------------------

@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_param_defs_are_the_references(arch, reduced):
    """The reference's leaves and shapes, and its parameter count."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    want = [(path, d.shape, d.init, d.dtype)
            for path, d in flatten(JT.param_defs(jcfg))]
    got = [(path, d.shape, d.init, d.dtype)
           for path, d in flatten(param_defs(cfg))]
    assert got == want
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_params_from_jax_takes_the_references_tree(arch):
    """Every leaf of the reference's reduced tree arrives bit for bit,
    and ``init_params`` draws the same leaves with the same shapes."""
    jcfg, cfg = jax_get_config(arch).reduced(), get_config(arch).reduced()
    jparams = jax.tree.map(np.asarray,
                           jax_init_params(jcfg, jax.random.PRNGKey(5)))
    params = params_from_jax(cfg, jparams, device="cpu")
    drawn = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = dict(flatten(jparams))
    assert [p for p, _ in flatten(params)] == sorted(want)
    for path, t in flatten(params):
        np.testing.assert_array_equal(
            t.float().numpy(), np.asarray(want[path], np.float32),
            err_msg=path)
    assert {p: (tuple(t.shape), t.dtype) for p, t in flatten(drawn)} == \
        {p: (tuple(t.shape), t.dtype) for p, t in flatten(params)}


def test_the_two_configs_have_their_published_widths():
    w, v = get_config(WHISPER), get_config(LLAVA)
    assert (w.enc_layers, w.n_layers, w.d_model, w.n_heads, w.head_dim_,
            w.d_ff, w.vocab_size, w.max_learned_pos) == \
        (6, 6, 512, 8, 64, 2048, 51_865, 32_769)
    assert (w.norm, w.mlp_act, w.use_rope, w.tie_embeddings) == \
        ("layer", "gelu", False, True)
    assert (v.n_layers, v.d_model, v.n_heads, v.n_kv_heads, v.head_dim_,
            v.d_ff, v.vocab_size, v.rope_theta) == \
        (32, 4096, 32, 8, 128, 14_336, 32_000, 1e6)
    assert (v.tie_embeddings, v.num_frontend_tokens, v.frontend_offset) == \
        (False, 576, 1)


# --------------------------- layers ------------------------------------------

@pytest.mark.parametrize("S,D", [(16, 64), (448, 512), (1500, 512)])
def test_sinusoid_matches_reference(S, D):
    got = T._sinusoid(S, D)
    assert got.dtype == torch.float32 and got.shape == (S, D)
    np.testing.assert_allclose(got.numpy(), _np(JT._sinusoid(S, D)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("sq", [7, 1])
def test_cross_attention_block_matches_reference(sq):
    """Sq > 1 takes blocked attention, Sq == 1 the plain GQA attention,
    both unmasked over an encoder output of 37 positions (4 heads over 2
    kv heads)."""
    rng = np.random.default_rng(3)
    D, H, KV, dh = 32, 4, 2, 8
    p = {"wq": rng.standard_normal((D, H, dh)), "wk":
         rng.standard_normal((D, KV, dh)), "wv":
         rng.standard_normal((D, KV, dh)), "wo":
         rng.standard_normal((H, dh, D))}
    p = {k: (v / np.sqrt(v.shape[-2])).astype(np.float32)
         for k, v in p.items()}
    x = rng.standard_normal((2, sq, D)).astype(np.float32)
    enc = rng.standard_normal((2, 37, D)).astype(np.float32)
    want = JL.cross_attention_block(jnp.asarray(x), jnp.asarray(enc),
                                    {k: jnp.asarray(v) for k, v in p.items()})
    got = L.cross_attention_block(torch.from_numpy(x), torch.from_numpy(enc),
                                  {k: torch.from_numpy(v)
                                   for k, v in p.items()})
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-5)


# --------------------------- the vision splice ------------------------------

@pytest.mark.parametrize("S,offset", [(9, 1), (6, 1), (5, 3), (4, 1),
                                      (7, 0)],
                         ids=["S=offset+T+4", "S<offset+T", "clamped-3",
                              "S=T", "offset0"])
def test_splice_places_the_image_as_the_reference(S, offset):
    """``embed_inputs`` with 4 patch embeddings at ``frontend_offset``:
    the reference's exact placement, including where the start is clamped
    so that the image fits (at S − T)."""
    jcfg, cfg, jparams, params = _both(LLAVA, frontend_offset=offset)
    rng = np.random.default_rng(S)
    toks = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    img = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    want = JT.embed_inputs(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                           "image_embeds": jnp.asarray(img)})
    got = T.embed_inputs(cfg, params, {"tokens": torch.from_numpy(toks),
                                       "image_embeds": torch.from_numpy(img)})
    np.testing.assert_array_equal(got.numpy(), _np(want))
    start = min(offset, S - 4)
    np.testing.assert_array_equal(got[:, start:start + 4].numpy(), img)


def test_splice_refuses_an_image_longer_than_the_sequence():
    """The reference raises (``dynamic_update_slice``'s shape check); so
    does the port."""
    jcfg, cfg, jparams, params = _both(LLAVA)
    toks = np.zeros((2, 3), np.int32)
    img = np.zeros((2, 4, cfg.d_model), np.float32)
    with pytest.raises(TypeError):
        JT.embed_inputs(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                        "image_embeds": jnp.asarray(img)})
    with pytest.raises(TypeError, match="image_embeds"):
        T.embed_inputs(cfg, params, {"tokens": torch.from_numpy(toks),
                                     "image_embeds": torch.from_numpy(img)})


@pytest.mark.parametrize("arch", [LLAVA, WHISPER])
def test_inputs_embeds_replace_the_token_embeddings(arch):
    """``inputs_embeds`` are taken as they are (in ``cfg.dtype``), plus the
    learned positions where the config has them (whisper)."""
    jcfg, cfg, jparams, params = _both(arch)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    emb = rng.standard_normal((2, 6, cfg.d_model)).astype(np.float32)
    want = JT.embed_inputs(jcfg, jparams, {"tokens": jnp.asarray(toks),
                                           "inputs_embeds": jnp.asarray(emb)})
    got = T.embed_inputs(cfg, params, {"tokens": torch.from_numpy(toks),
                                       "inputs_embeds": torch.from_numpy(emb)})
    np.testing.assert_array_equal(got.numpy(), _np(want))


def test_splice_keeps_the_gradient_of_the_token_embeddings():
    """Under autograd the image overwrites no tensor autograd saved: the
    embedding table gets gradients at the text positions only, the image
    at its own."""
    _, cfg, _, params = _both(LLAVA)
    table = params["embed"].requires_grad_()
    img = torch.zeros((1, 4, cfg.d_model), requires_grad=True)
    toks = torch.tensor([[3, 5, 7, 9, 11, 13, 15]])
    x = T.embed_inputs(cfg, params, {"tokens": toks, "image_embeds": img})
    g_table, g_img = torch.autograd.grad(x.sum(), [table, img])
    assert float(g_img.sum()) == 4 * cfg.d_model
    hit = g_table.abs().sum(-1) > 0
    assert hit.nonzero().flatten().tolist() == [3, 13, 15]


# --------------------------- encoder-decoder --------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_encode_matches_reference(impl):
    jcfg, cfg, jparams, params = _both(WHISPER, impl)
    jb, b = _batches(cfg)
    want = JT.encode(jcfg, jparams, jb["frame_embeds"])
    with torch.inference_mode():
        got = T.encode(cfg, params, b["frame_embeds"])
    _rel_close(got, want, 1e-5)


@pytest.mark.parametrize("impl", IMPLS)
def test_forward_encdec_matches_reference(impl):
    """``make_forward``, ``make_prefill`` and the hidden forward (the loss's
    input), from the reference's weights."""
    jcfg, cfg, jparams, params = _both(WHISPER, impl)
    jb, b = _batches(cfg, seed=1)
    want, jaux = jax.jit(jax_make_forward(jcfg))(jparams, jb)
    want_last = jax.jit(jax_make_prefill(jcfg))(jparams, jb)
    want_hidden, _ = jax.jit(jax_make_hidden(jcfg))(jparams, jb)
    with torch.inference_mode():
        got, aux = make_forward(cfg)(params, b)
        last = make_prefill(cfg)(params, b)
        hidden, _ = make_hidden_forward(cfg)(params, b)
    _rel_close(got, want, 1e-4, "logits")
    _rel_close(last, want_last, 1e-4, "prefill")
    _rel_close(hidden, want_hidden, 1e-4, "hidden")
    assert float(aux) == float(jaux) == 0.0


def test_decode_step_encdec_matches_reference_over_ten_steps():
    """The serve step replayed over 10 tokens against the encoder's output
    (``enc_out``): each step's logits are the reference's, and the
    forward's at that position."""
    jcfg, cfg, jparams, params = _both(WHISPER)
    jb, b = _batches(cfg, s=10, seed=2)
    enc = JT.encode(jcfg, jparams, jb["frame_embeds"])
    full, _ = JT.decode_train(jcfg, jparams, enc, jb["tokens"])
    jstep = jax.jit(jax_make_serve_step(jcfg))
    jcache = jax_init_cache(jcfg, 2, 10)
    cache = init_cache(cfg, 2, 10, dtype="float32", device="cpu")
    enc_t = torch.from_numpy(_np(enc))
    step = make_serve_step(cfg)
    for t in range(10):
        want, jcache = jstep(jparams, jcache, {
            "token": jb["tokens"][:, t:t + 1], "pos": jnp.int32(t),
            "enc_out": enc})
        with torch.inference_mode():
            got, cache = step(params, cache, {
                "token": b["tokens"][:, t:t + 1], "pos": t, "enc_out": enc_t})
        _rel_close(got, want, 1e-4, f"step {t}")
        _rel_close(got[:, 0], full[:, t], 1e-4, f"step {t} vs forward")
    for name in ("k", "v"):
        _rel_close(cache["sub0"][name], jcache["sub0"][name], 1e-5, name)


def test_decode_step_lm_adds_the_learned_positions():
    """A decoder-only config with learned positions (no RoPE): the decode
    step adds ``pos_embed`` at ``pos``, as the reference's does, and
    replays the forward."""
    fields = dict(name="tiny-learned", family="dense", n_layers=2,
                  d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
                  vocab_size=64, head_dim=8, use_rope=False,
                  max_learned_pos=16, dtype="float32")
    jcfg, cfg = JModelConfig(**fields), ModelConfig(**fields)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams),
                             device="cpu")
    assert "pos_embed" in params
    toks = np.random.default_rng(6).integers(0, 64, (2, 9)).astype(np.int32)
    full, _ = jax.jit(jax_make_forward(jcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    jcache = jax_init_cache(jcfg, 2, 9)
    cache = init_cache(cfg, 2, 9, device="cpu")
    jstep, step = jax.jit(jax_make_serve_step(jcfg)), make_serve_step(cfg)
    for t in range(9):
        want, jcache = jstep(jparams, jcache, {
            "token": jnp.asarray(toks[:, t:t + 1]), "pos": jnp.int32(t)})
        with torch.inference_mode():
            got, cache = step(params, cache, {
                "token": torch.from_numpy(toks[:, t:t + 1]), "pos": t})
        _rel_close(got, want, 1e-4, f"step {t}")
        _rel_close(got[:, 0], full[:, t], 1e-4, f"step {t} vs forward")


def test_cross_attention_stays_off_the_flash_kernel(monkeypatch):
    """Under ``attn_impl="flash"`` the flash op runs each self-attention
    (the encoder's unmasked, the decoder's causal) once, and never the
    cross-attention, as in the reference; under remat full a backward
    runs each again, in the encoder as in the decoder."""
    _, cfg, _, params = _both(WHISPER, "flash")
    _, b = _batches(cfg)
    calls = []
    real = fa_ops.flash_attention

    def counting(q, k, v, causal=True, **kw):
        calls.append(causal)
        return real(q, k, v, causal=causal, **kw)
    # the op with gradients calls this one for its forward
    monkeypatch.setattr(fa_ops, "flash_attention", counting)
    with torch.inference_mode():
        make_forward(cfg)(params, b)
    assert calls == [False] * cfg.enc_layers + [True] * cfg.n_layers
    leaves = [t.requires_grad_() for _, t in flatten(params)]
    for remat, per_layer in (("full", 2), ("none", 1)):
        calls.clear()
        loss = make_loss_fn(cfg.with_(remat=remat))(params, b)
        torch.autograd.grad(loss, leaves)
        assert calls.count(False) == per_layer * cfg.enc_layers, remat
        assert calls.count(True) == per_layer * cfg.n_layers, remat


# --------------------------- the vision model -------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_vision_forward_matches_reference(impl):
    """``make_forward`` and ``make_prefill`` with ``image_embeds``."""
    jcfg, cfg, jparams, params = _both(LLAVA, impl)
    jb, b = _batches(cfg, s=12, seed=3)
    want, _ = jax.jit(jax_make_forward(jcfg))(jparams, jb)
    want_last = jax.jit(jax_make_prefill(jcfg))(jparams, jb)
    with torch.inference_mode():
        got, _ = make_forward(cfg)(params, b)
        last = make_prefill(cfg)(params, b)
    _rel_close(got, want, 1e-4, "logits")
    _rel_close(last, want_last, 1e-4, "prefill")


def test_vision_forward_needs_image_embeds():
    """As in the reference, the vision model's forward reads
    ``image_embeds``: without them it raises ``KeyError``."""
    jcfg, cfg, jparams, params = _both(LLAVA)
    toks = np.zeros((1, 8), np.int32)
    with pytest.raises(KeyError, match="image_embeds"):
        jax_make_forward(jcfg)(jparams, {"tokens": jnp.asarray(toks)})
    with pytest.raises(KeyError, match="image_embeds"):
        make_forward(cfg)(params, {"tokens": torch.from_numpy(toks)})


# --------------------------- training ---------------------------------------

def _step_gaps(state, m, jstate, jm) -> tuple[float, float]:
    """(grad norm gap relative to the reference's, the largest gap of a
    first-moment leaf relative to its max|m|)."""
    gn = abs(float(m["grad_norm"]) - float(jm["grad_norm"])) / float(
        jm["grad_norm"])
    worst = max(
        float(np.abs(got.detach().double().numpy() - want).max()
              / max(np.abs(want).max(), 1e-30))
        for (_, got), (_, want) in zip(
            flatten(state.m), flatten(jax.tree.map(np.asarray, jstate.m))))
    return gn, worst


def _reference_spread(jcfg, jparams, jbatch, jstate, jm) -> tuple[float,
                                                                  float]:
    """How far the reference's own first step moves (grad norm, moments,
    as :func:`_step_gaps` reads them) under two draws of one-ulp noise on
    its weights (relative 2^-23, normal)."""
    jopt = jax_adamw(1e-2, 1, 10)
    step = jax.jit(jax_make_train_step(jcfg, jopt))
    rng = np.random.default_rng(5)
    gaps = []
    for _ in range(2):
        noisy = jax.tree.map(lambda a: jnp.asarray(
            (np.asarray(a) * (1 + 2.0 ** -23 * rng.standard_normal(a.shape))
             ).astype(np.asarray(a).dtype)), jparams)
        nstate, nm = step(jopt.init(noisy), jbatch)
        gaps.append(_step_gaps(
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), nstate),
            nm, jstate, jm))
    return max(g for g, _ in gaps), max(w for _, w in gaps)


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_train_step_matches_reference(arch, remat):
    """One train step in fp32 from the reference's weights (the reference
    at its remat full, blocked attention; the port with flash under
    ``remat``), on the reference loop's batch with its frontend stub (zero
    frames or zero patches): the loss within 1e-5 relative; the grad norm
    within 1e-5 relative and every gradient, read from m, within 1e-4 of
    its leaf's max|m| (llava; observed 5e-6 and 7e-6).

    The reduced whisper's fp32 step is ill-conditioned: its encoder's
    gradients are small differences of large terms (cancellation through
    the cross-attention), and one-ulp noise on the weights moves the
    reference's own grad norm by 5e-6 to 8e-5 and its moments by 1.2e-4
    to 4.8e-4 of their max (seeds 0-5).  So whisper's grad norm and
    moments are held within the larger of that rule and twice the
    reference's own spread under two such draws, measured here."""
    jcfg, cfg, jparams, params = _both(arch, "flash")
    cfg = cfg.with_(remat=remat)
    toks = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (4, 17)).astype(np.int32)
    batch = loop.train_batch(cfg, torch.from_numpy(toks))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    assert set(batch) == {"tokens", {WHISPER: "frame_embeds",
                                     LLAVA: "image_embeds"}[arch]}
    opt, jopt = adamw(1e-2, 1, 10), jax_adamw(1e-2, 1, 10)
    jstate, jm = jax_make_train_step(jcfg, jopt)(jopt.init(jparams), jbatch)
    state, m = make_train_step(cfg, opt)(opt.init(params), batch)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    gn_bar, m_bar = 1e-5, 1e-4
    if arch == WHISPER:
        spread = _reference_spread(jcfg, jparams, jbatch, jstate, jm)
        gn_bar, m_bar = max(gn_bar, 2 * spread[0]), max(m_bar, 2 * spread[1])
    gn_gap, m_gap = _step_gaps(state, m, jstate, jm)
    assert gn_gap <= gn_bar, (gn_gap, gn_bar)
    assert m_gap <= m_bar, (m_gap, m_bar)


# --------------------------- launchers --------------------------------------

def _run(main, argv) -> tuple[int, list[str]]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue().splitlines()


def test_serve_launcher_prints_the_references_encdec_line():
    argv = ["--arch", WHISPER, "--reduced"]
    jrc, jlines = _run(jax_serve_launch.main, argv)
    rc, lines = _run(serve_launch.main, argv + ["--device", "cpu"])
    assert rc == jrc == 0
    assert lines == jlines and len(lines) == 1
    assert lines[0].startswith("[serve] enc-dec serving demo")


def test_serve_launcher_fails_on_llava_as_the_reference_does():
    """Both engines pass only tokens to the vision model's forward: both
    raise, naming ``image_embeds``."""
    argv = ["--arch", LLAVA, "--reduced", "--requests", "2"]
    with pytest.raises(KeyError, match="image_embeds"):
        _run(jax_serve_launch.main, argv)
    with pytest.raises(KeyError, match="image_embeds"):
        _run(serve_launch.main, argv + ["--device", "cpu"])


def test_train_launcher_matches_the_references_losses(monkeypatch):
    """``launch.train --arch whisper-base --reduced --steps 3`` from the
    reference's weights (the port's loop takes them through
    ``params_from_jax`` in place of its own draw): the same ledger line,
    and the final loss of the reference's launcher within 2e-2 relative,
    the bar of the bf16 first-loss test (the reduced config trains in
    bf16; observed: 5.6926 against 5.6943)."""
    argv = ["--arch", WHISPER, "--reduced", "--steps", "3"]
    jrc, jlines = _run(jax_train_launch.main, argv)

    def reference_weights(cfg, generator, device):
        jcfg = jax_get_config(WHISPER).reduced()
        return params_from_jax(cfg, jax.tree.map(
            np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0))),
            device=device)
    monkeypatch.setattr(loop, "init_params", reference_weights)
    rc, lines = _run(train_launch.main, argv + ["--device", "cpu"])
    assert rc == jrc == 0
    assert len(jlines) == 2 and len(lines) == 3
    assert lines[1] == jlines[1]
    jloss, loss = (float(x[0].rsplit(" ", 1)[1]) for x in (jlines, lines))
    assert lines[0].startswith("[train] done: 3 steps, final loss ")
    np.testing.assert_allclose(loss, jloss, rtol=2e-2)
    assert lines[2].startswith("[train] on cpu")
