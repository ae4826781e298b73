"""The port's serving layer against the JAX reference, on the CPU: the
prefix-page oids and the router (copies, which must decide exactly as the
reference's), the engine on TINY and on reduced falcon-mamba-7b,
qwen3-moe and jamba with the reference's weights (exactly the reference
engine's tokens and router state), the launcher's traffic and the
``serve_lm`` app."""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.core.cache import EvictionPolicy as JEvictionPolicy
from repro.core.policies import DispatchPolicy as JDispatchPolicy
from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_launch
from repro.models.config import ModelConfig as JModelConfig
from repro.serve import PrefixAwareRouter as JRouter
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro.serve.kvcache import kv_bytes_per_token as jax_kv_bytes_per_token
from repro.serve.kvcache import prefix_chain as jax_prefix_chain
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.cache import EvictionPolicy
from repro_torch.core.policies import DispatchPolicy
from repro_torch.launch import serve as launch
from repro_torch.models import make_forward
from repro_torch.models.config import ModelConfig
from repro_torch.serve import PrefixAwareRouter, Request, ServeEngine
from repro_torch.serve.kvcache import (PrefixEntry, kv_bytes_per_token,
                                       prefix_chain, prefix_oid)

TINY_FIELDS = dict(name="tiny-serve", family="dense", n_layers=2, d_model=32,
                   n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128,
                   head_dim=8, dtype="float32")
TINY = ModelConfig(**TINY_FIELDS)
JTINY = JModelConfig(**TINY_FIELDS)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops spend most of their time waking threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------- kvcache and router ------------------------------

def test_prefix_chain_is_block_aligned_and_content_addressed():
    toks = list(range(200))
    chain = prefix_chain(toks, block=64)
    assert len(chain) == 3                       # 64, 128, 192
    assert chain[0] == prefix_oid(toks[:64])
    # content addressing: same prefix -> same oid, different -> different
    assert prefix_oid(toks[:64]) == prefix_oid(list(range(64)))
    assert prefix_oid(toks[:64]) != prefix_oid([1] + toks[1:64])
    # the reference's oids, byte for byte
    assert chain == jax_prefix_chain(toks, block=64)
    entry = PrefixEntry(chain[0], tuple(toks[:64]), None, 4096)
    assert entry.as_object().oid == chain[0]
    assert entry.as_object().size_bytes == 4096


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "gemma2-27b",
                                  "starcoder2-15b", "nemotron-4-15b",
                                  "falcon-mamba-7b"])
def test_kv_bytes_per_token_matches_reference(arch):
    assert kv_bytes_per_token(get_config(arch)) == \
        jax_kv_bytes_per_token(jax_get_config(arch))


def _drive(router, n_prompts=32, n_bases=4):
    rng = np.random.default_rng(0)
    bases = [list(rng.integers(0, 100, 64)) for _ in range(n_bases)]
    reused = 0
    total = 0
    inflight = []
    routes = []
    for i in range(n_prompts):
        prompt = bases[i % n_bases] + list(rng.integers(0, 100, 16))
        r = router.route(prompt)
        routes.append((r.replica, r.reused_prefix_tokens, r.reused_bytes,
                       r.hints))
        reused += r.reused_prefix_tokens
        total += len(prompt)
        inflight.append((prompt, r))
        if len(inflight) >= 6:   # completions lag routing: replicas stay
            pr, rr = inflight.pop(0)      # busy, availability matters
            router.complete(pr, rr)
    for pr, rr in inflight:
        router.complete(pr, rr)
    return reused / total, router, routes


def _port_router(policy):
    return PrefixAwareRouter(4, DispatchPolicy(policy), EvictionPolicy.LRU,
                             replica_cache_bytes=1 << 24,
                             kv_bytes_per_token=64, block=16,
                             slots_per_replica=2)


def _jax_router(policy):
    return JRouter(4, JDispatchPolicy(policy), JEvictionPolicy.LRU,
                   replica_cache_bytes=1 << 24, kv_bytes_per_token=64,
                   block=16, slots_per_replica=2)


def test_data_aware_routing_beats_data_unaware():
    """The paper's Figure-3 ordering, serving edition: the data-aware
    policies reuse more prefix KV than first-available."""
    frac_fa, _, _ = _drive(_port_router("first-available"))
    frac_mcu, _, _ = _drive(_port_router("max-compute-util"))
    frac_mch, _, _ = _drive(_port_router("max-cache-hit"))
    assert frac_mch >= frac_fa + 0.08
    assert frac_mcu >= frac_fa - 1e-9


@pytest.mark.parametrize("policy", ["first-available", "first-cache-available",
                                    "max-cache-hit", "max-compute-util"])
def test_router_decides_exactly_as_the_reference(policy):
    frac, router, routes = _drive(_port_router(policy), n_prompts=64,
                                  n_bases=16)
    jfrac, jrouter, jroutes = _drive(_jax_router(policy), n_prompts=64,
                                     n_bases=16)
    assert routes == jroutes
    assert frac == jfrac
    assert router.stats() == jrouter.stats()
    for rid, rep in router.replicas.items():
        assert rep.cache.contents() == jrouter.replicas[rid].cache.contents()


def test_router_eviction_keeps_index_coherent():
    _, router, _ = _drive(_port_router("max-compute-util"), n_prompts=64,
                          n_bases=16)
    for rid, rep in router.replicas.items():
        for oid in rep.cache.contents():
            assert rid in router.index.lookup(oid)
        for oid, size in router.sizes.items():
            if rid in router.index.lookup(oid):
                assert oid in rep.cache


# --------------------------- the engine --------------------------------------

def _engines(impl="blocked", max_seq=64, n_replicas=2, jcfg=JTINY,
             cfg=TINY):
    """The reference engine (its default blocked attention and plain scan)
    and the port's, on the reference's weights, with the port's forward
    running ``impl`` (and ``cfg``'s scan)."""
    jeng = JServeEngine(jcfg, n_replicas=n_replicas,
                        policy=JDispatchPolicy.MAX_COMPUTE_UTIL,
                        max_seq=max_seq)
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jeng.params),
                             device="cpu")
    eng = ServeEngine(cfg.with_(attn_impl=impl), n_replicas=n_replicas,
                      policy=DispatchPolicy.MAX_COMPUTE_UTIL,
                      max_seq=max_seq, device="cpu", params=params)
    return jeng, eng


def _waves(seed=1):
    rng = np.random.default_rng(seed)
    base = [int(t) for t in rng.integers(2, 100, 32)]
    return [[base + [int(t) for t in rng.integers(2, 100, 4)]
             for _ in range(4)] for _ in range(2)]


@pytest.mark.parametrize("impl,arch", [
    ("blocked", None), ("flash", None), ("ref", None),
    ("flash", "qwen3-moe-30b-a3b"), ("flash", "jamba-1.5-large-398b")],
    ids=["blocked", "flash", "ref", "qwen3-moe-30b-a3b",
         "jamba-1.5-large-398b"])
def test_engine_serves_exactly_as_the_reference(impl, arch):
    """Two waves of four requests sharing a 32-token base: the same output
    tokens, prefill and reused token counts, and router state.  The
    reference engine runs blocked attention (its default); the port's
    forward runs ``impl``.  On TINY, and on reduced qwen3-moe and jamba in
    fp32 (their MoE layers drop pairs in the padded forward and, with 4
    experts, in decode too: both packages alike), with the port's scan
    op."""
    if arch is None:
        _serve_both(*_engines(impl))
        return
    jcfg = jax_get_config(arch).reduced().with_(dtype="float32")
    cfg = get_config(arch).reduced().with_(dtype="float32",
                                          use_mamba_kernel=True)
    _serve_both(*_engines(impl, jcfg=jcfg, cfg=cfg))


@pytest.mark.parametrize("use_mamba_kernel", [True, False])
def test_ssm_engine_serves_exactly_as_the_reference(use_mamba_kernel):
    """As above on reduced falcon-mamba-7b in fp32 (its O(1) state cache
    in decode); the port's forward runs the scan op or the plain chunked
    path, and its forward logits equal its decode replay's."""
    jcfg = jax_get_config("falcon-mamba-7b").reduced().with_(dtype="float32")
    cfg = get_config("falcon-mamba-7b").reduced().with_(
        dtype="float32", use_mamba_kernel=use_mamba_kernel)
    jeng, eng = _engines(jcfg=jcfg, cfg=cfg)
    _serve_both(jeng, eng)
    for w in eng.waves:
        torch.testing.assert_close(w.replay_logits, w.prefill_logits,
                                   atol=1e-4, rtol=1e-4)


def _serve_both(jeng, eng):
    for w, prompts in enumerate(_waves()):
        jreqs = [JRequest(rid=10 * w + i, prompt=p, max_new_tokens=4)
                 for i, p in enumerate(prompts)]
        reqs = [Request(rid=10 * w + i, prompt=p, max_new_tokens=4)
                for i, p in enumerate(prompts)]
        jeng.generate(jreqs)
        out = eng.generate(reqs)
        assert [r.output for r in out] == [r.output for r in jreqs]
        assert [r.replica for r in out] == [r.replica for r in jreqs]
        assert [r.reused_tokens for r in out] == \
            [r.reused_tokens for r in jreqs]
        assert all(len(r.output) == 4 for r in out)
    assert eng.prefill_tokens == jeng.prefill_tokens
    assert eng.reused_tokens == jeng.reused_tokens > 0   # wave 2 hits caches
    assert eng.router.stats() == jeng.router.stats()


def test_engine_greedy_matches_forward():
    """serve_step replay == forward logits => generation is trustworthy."""
    eng = ServeEngine(TINY, n_replicas=1, max_seq=16, device="cpu")
    prompt = list(range(2, 10))
    req = Request(rid=0, prompt=prompt, max_new_tokens=1)
    eng.generate([req])
    toks = torch.zeros((1, 16), dtype=torch.long)
    toks[0, : len(prompt)] = torch.tensor(prompt)
    with torch.inference_mode():
        logits, _ = make_forward(TINY)(eng.params, {"tokens": toks})
    expect = int(torch.argmax(logits[0, len(prompt) - 1]))
    assert req.output[0] == expect


def test_wave_record_holds_forward_and_replay_logits():
    """Prompts of different lengths in one wave: each request's forward
    logits at its last prompt position equal the replay's there."""
    eng = ServeEngine(TINY.with_(attn_impl="flash"), n_replicas=2,
                      max_seq=24, device="cpu", seed=3)
    reqs = [Request(rid=i, prompt=list(range(2, 2 + n)), max_new_tokens=3)
            for i, n in enumerate((5, 9, 12))]
    eng.generate(reqs)
    (w,) = eng.waves
    assert w.lens == [5, 9, 12] and w.replay_steps == 12
    assert w.decode_steps == 3 and w.prefill_logits.shape == (3, 128)
    torch.testing.assert_close(w.replay_logits, w.prefill_logits,
                               atol=1e-5, rtol=1e-5)
    assert min(w.forward_s, w.replay_s, w.decode_s) > 0


def test_engine_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(TINY)


# --------------------------- the launcher ------------------------------------

def test_launcher_prints_the_reference_lines():
    """The reference launcher's traffic on reduced h2o-danube-3-4b: the port
    prints the reference's three [serve] lines, then its times."""
    argv = ["--arch", "h2o-danube-3-4b", "--reduced", "--requests", "8",
            "--max-new", "2"]
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert jax_launch.main(argv) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert launch.main(argv + ["--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[:3] == jout.getvalue().splitlines()
    assert len(lines) == 4 and lines[3].startswith("[serve] on cpu")
    assert "attention flash" in lines[3]


def test_launcher_prints_the_reference_lines_ssm():
    """The same on reduced falcon-mamba-7b; the times line says which scan
    ran (the plain version: the tensors lie on the CPU)."""
    argv = ["--arch", "falcon-mamba-7b", "--reduced", "--requests", "8",
            "--max-new", "2"]
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert jax_launch.main(argv) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert launch.main(argv + ["--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[:3] == jout.getvalue().splitlines()
    assert len(lines) == 4 and lines[3].startswith("[serve] on cpu")
    assert "selective scan plain in the forward" in lines[3]
    assert "attention" not in lines[3]


def test_launcher_prints_the_reference_lines_moe():
    """The same on reduced qwen3-moe; the times line names the MoE layers'
    experts and top-k."""
    argv = ["--arch", "qwen3-moe-30b-a3b", "--reduced", "--requests", "8",
            "--max-new", "2"]
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert jax_launch.main(argv) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert launch.main(argv + ["--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[:3] == jout.getvalue().splitlines()
    assert len(lines) == 4 and lines[3].startswith("[serve] on cpu")
    assert "attention flash, MoE 4 experts top-2 in the forward" in lines[3]


def test_serve_lm_app_prints_the_reference_lines():
    """``apps.serve_lm`` against ``examples/serve_lm.py`` with the same
    flags: every line but ``sample output:`` (each package draws its own
    weights) is the reference's."""
    import dataclasses
    import importlib.util
    from pathlib import Path

    from repro_torch.apps import serve_lm

    path = Path(__file__).resolve().parents[1] / "examples" / "serve_lm.py"
    spec = importlib.util.spec_from_file_location("_ref_serve_lm", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    assert dataclasses.asdict(serve_lm.TINY) == \
        dataclasses.asdict(example.TINY)
    argv = ["--requests", "16", "--replicas", "3", "--max-new", "2"]
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert example.main(argv) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert serve_lm.main(argv + ["--device", "cpu"]) == 0
    jlines, lines = jout.getvalue().splitlines(), out.getvalue().splitlines()
    assert len(lines) == len(jlines) == 6
    assert lines[:5] == jlines[:5]
    assert lines[0] == ("served 16 requests x 2 tokens on 3 replicas, "
                        "policy=max-compute-util")
    assert lines[5].startswith("  sample output: [")
    assert len(eval(lines[5].split(": ", 1)[1])) == 2


def test_launcher_with_zero_requests_prints_the_reference_lines():
    """No request means no wave: the port prints the reference's three
    [serve] lines and a times line that has no time to report, with no
    division by the zero step count."""
    argv = ["--arch", "h2o-danube-3-4b", "--reduced", "--requests", "0"]
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert jax_launch.main(argv) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert launch.main(argv + ["--device", "cpu"]) == 0
    lines = out.getvalue().splitlines()
    assert lines[:3] == jout.getvalue().splitlines()
    assert lines[0].startswith("[serve] served 0 requests")
    assert len(lines) == 4 and lines[3].startswith("[serve] on cpu")
    assert "no wave served" in lines[3]


def test_launcher_requests_are_the_reference_prompts():
    cfg = get_config("h2o-danube-3-4b").reduced()
    reqs = launch.make_requests(cfg, 16, 8, seed=0)
    rng = np.random.default_rng(0)
    bases = [list(rng.integers(2, cfg.vocab_size, 32)) for _ in range(4)]
    for i, r in enumerate(reqs):
        tail = list(rng.integers(2, cfg.vocab_size, 8))
        assert r.prompt == [int(t) for t in bases[i % 4] + tail]
        assert r.max_new_tokens == 8 and len(r.prompt) == 40
