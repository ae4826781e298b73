"""The port's counterpart of tests/test_arch_smoke.py, on the CPU: every
config in the port's registry, at its ``reduced()`` widths and in its own
dtype, runs a forward, one train step and one decode step with the
reference's shapes and finite values, from the reference's weights
(``convert.params_from_jax``); the train step's loss is the reference's
on those weights within 2e-2 relative, the bar of the bf16 first-loss
test (observed: at most 2.1e-3, starcoder2-15b).  The registry is the
reference's, all ten configs; the batches carry the frontend stubs the
reference's smoke test builds (patch embeddings for the vision model,
frame embeddings and an encoder output for the encoder-decoder)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JAX_REGISTRY
from repro.models import init_params as jax_init_params
from repro.models import make_train_step as jax_make_train_step
from repro.train import adamw as jax_adamw
from repro_torch.configs import REGISTRY
from repro_torch.convert import params_from_jax
from repro_torch.models import (init_cache, make_forward, make_serve_step,
                                make_train_step)
from repro_torch.models.transformer import torch_dtype
from repro_torch.train import adamw

ARCHS = sorted(REGISTRY)


def _batch(cfg, tokens: np.ndarray) -> dict:
    """tokens (B, S) and the stub frontend embeddings of
    tests/test_arch_smoke.py's ``_batch``, 0.01 everywhere: (B, T, D)
    patches for the vision model, (B, S, D) frames for the
    encoder-decoder (numpy, fp32; each package casts them to the config's
    dtype)."""
    B, S = tokens.shape
    batch = {"tokens": tokens}
    if cfg.frontend == "vision":
        batch["image_embeds"] = np.full(
            (B, cfg.num_frontend_tokens, cfg.d_model), 0.01, np.float32)
    if cfg.is_encdec:
        batch["frame_embeds"] = np.full((B, S, cfg.d_model), 0.01,
                                        np.float32)
    return batch


def _jax_batch(cfg, batch: dict) -> dict:
    return {k: jnp.asarray(v) if k == "tokens" else
            jnp.asarray(v).astype(jnp.dtype(cfg.dtype))
            for k, v in batch.items()}


def _port_batch(cfg, batch: dict) -> dict:
    return {k: torch.from_numpy(v) if k == "tokens" else
            torch.from_numpy(v).to(torch_dtype(cfg.dtype))
            for k, v in batch.items()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops spend most of their time waking threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(arch, seed):
    """The reduced config in each package, the reference's weights and
    the port's copy of them on the CPU."""
    jcfg, cfg = JAX_REGISTRY[arch].reduced(), REGISTRY[arch].reduced()
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jparams, params_from_jax(
        cfg, jax.tree.map(np.asarray, jparams), device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_forward_and_train_step(arch):
    jcfg, cfg, jparams, params = _both(arch, 0)
    B, S = 2, 16
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    np_batch = _batch(cfg, tokens)
    batch = _port_batch(cfg, np_batch)
    with torch.inference_mode():
        logits, aux = make_forward(cfg)(params, batch)
    assert logits.shape == (B, S, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all()), f"{arch}: non-finite logits"
    assert bool(torch.isfinite(aux))
    jopt, opt = jax_adamw(1e-3, 2, 10), adamw(1e-3, 2, 10)
    _, jm = jax.jit(jax_make_train_step(jcfg, jopt))(
        jopt.init(jparams), _jax_batch(jcfg, np_batch))
    state, metrics = make_train_step(cfg, opt)(opt.init(params), batch)
    loss = float(metrics["loss"])
    assert np.isfinite(loss), f"{arch}: non-finite loss"
    assert int(metrics["step"]) == 1
    np.testing.assert_allclose(loss, float(jm["loss"]), rtol=2e-2)
    assert all(bool(torch.isfinite(t).all()) for t in
               jax.tree.leaves(state.params))


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_decode_step(arch):
    _, cfg, _, params = _both(arch, 1)
    B, S_cache = 2, 8
    cache = init_cache(cfg, B, S_cache, device="cpu")
    shapes = jax.tree.map(lambda t: tuple(t.shape), cache)
    token = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, 1)))
    batch = {"token": token, "pos": 0}
    if cfg.is_encdec:   # the reference's: an encoder output of 8 positions
        batch["enc_out"] = torch.full((B, 8, cfg.d_model), 0.01,
                                      dtype=torch_dtype(cfg.dtype))
    with torch.inference_mode():
        logits, new_cache = make_serve_step(cfg)(params, cache, batch)
    assert logits.shape == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert jax.tree.map(lambda t: tuple(t.shape), new_cache) == shapes


def test_registry_is_the_references_but_encdec_and_vision():
    """Since the encoder-decoder and vision slice, the registry is the
    reference's, all ten configs in its order (the name is the test's
    from before that slice, when it held the two out)."""
    assert list(REGISTRY) == list(JAX_REGISTRY)
    assert len(REGISTRY) == 10
