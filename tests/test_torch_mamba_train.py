"""Training the port's Mamba layers against the JAX reference, on the CPU:
the plain ``mamba_block`` and the kernel route under autograd against
``jax.grad`` of the reference's block, ``mamba_scan_with_ref_vjp`` against
autograd through the plain chunked scan and ``jax.vjp`` of the reference's
checkpointed chunked scan, one train step of the ``reduced()``
falcon-mamba-7b and jamba under every remat and both scan routes, the
first losses of a few steps through the pipelines, and the launcher.

Everything is fp32.  On the CPU the kernel route's forward is the kernel's
plain version (``mamba_scan_ref``, the kernel's order ``(dt·u)·B``); its
backward is the plain chunked scan's on every device.

The reduced jamba's train step is ill-conditioned in fp32: one-ulp noise
on the weights (relative 6e-8) moves the reference's own grad norm by
1e-5 to 9.5e-5 and its moments by up to 2.5e-4 of their max, so no fp32
implementation that rounds otherwise holds 1e-5 there.  Its loss is held
at 1e-5; its grad norm and moments within the reference's own spread
under two such draws, measured in the test (observed: 3.2e-5 against
8.4e-5, and 8.0e-5 against 1.45e-4).  falcon-mamba-7b holds 1e-5 and
1e-4 (observed: 6.1e-7 and 3.3e-6)."""
import contextlib
import functools
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.dataset import ShardSpec as JShardSpec
from repro.data.pipeline import DiffusionDataPipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.core.policies import DispatchPolicy as JDispatchPolicy
from repro.launch import train as jax_launch
from repro.models import init_params as jax_init_params
from repro.models import make_train_step as jax_make_train_step
from repro.models import mamba as JM
from repro.train import adamw as jax_adamw
from repro.train import train as jax_train
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.core.policies import DispatchPolicy
from repro_torch.data import DiffusionDataPipeline, PipelineConfig, ShardSpec
from repro_torch.kernels.mamba_scan import ops as ms_ops
from repro_torch.kernels.mamba_scan.ref import ssm_scan_chunked
from repro_torch.launch import train as launch
from repro_torch.models import mamba as M
from repro_torch.models.model import make_train_step
from repro_torch.models.transformer import flatten
from repro_torch.train import adamw, train

ARCHS = ["falcon-mamba-7b", "jamba-1.5-large-398b"]
#: the train steps' scan chunk: 33 tokens cross two chunk boundaries and
#: end in a chunk of one step
CHUNK = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny CPU ops spend most of their time waking threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_max(got: torch.Tensor, want) -> float:
    """max|got - want| / max|want| (max|got - want| where want is 0)."""
    want = np.asarray(want, np.float64)
    err = float(np.abs(got.detach().double().numpy() - want).max())
    scale = float(np.abs(want).max())
    return err / scale if scale > 0 else err


# --------------------------- the block and the op ----------------------------

def _mamba_leaves(d, i, n, k, r, seed):
    """One mamba layer's leaves in fp32 as numpy arrays: the matrices
    normal·1/√fan_in; A_log, D, dt_bias and conv_b drawn too (the
    reference initialises the last three to zero)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape in M.mamba_param_shapes(d, i, n, k, r).items():
        a = rng.standard_normal(shape).astype(np.float32)
        if len(shape) == 2 and name != "A_log":
            a /= np.sqrt(shape[0])
        elif name != "A_log":
            a *= 0.5
        out[name] = a
    return out


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_mamba_block_gradients_match_reference(use_kernel, with_state):
    """d_model 64, I 128, N 4, S 37 in chunks of 8 (ragged, the state
    carried across four boundaries), from a zero or a given ssm state: the
    gradient of <out, g> + <h_last, g_h> with respect to every leaf, x and
    the state, against ``jax.grad`` of the reference's plain block, within
    1e-5 of each one's max|g|."""
    d, i, n, k, r, s = 64, 128, 4, 4, 4, 37
    leaves = _mamba_leaves(d, i, n, k, r, 30)
    rng = np.random.default_rng(31)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    h0 = (rng.standard_normal((2, i, n)).astype(np.float32) * 0.5
          if with_state else None)
    g_out = rng.standard_normal((2, s, d)).astype(np.float32)
    g_h = rng.standard_normal((2, i, n)).astype(np.float32)

    def jax_loss(x, p, h0):
        out, _, h = JM.mamba_block(x, p, None, ssm_state=h0,
                                   return_state=True, chunk=8)
        return jnp.sum(out * g_out) + jnp.sum(h * g_h)
    want = jax.grad(jax_loss, argnums=(0, 1, 2) if with_state else (0, 1))(
        jnp.asarray(x), {kk: jnp.asarray(v) for kk, v in leaves.items()},
        None if h0 is None else jnp.asarray(h0))

    tx = torch.from_numpy(x).requires_grad_()
    tp = {kk: torch.from_numpy(v).requires_grad_() for kk, v in leaves.items()}
    th = None if h0 is None else torch.from_numpy(h0).requires_grad_()
    out, _, h = M.mamba_block(tx, tp, ssm_state=th, return_state=True,
                              use_kernel=use_kernel, chunk=8)
    loss = (out * torch.from_numpy(g_out)).sum() \
        + (h * torch.from_numpy(g_h)).sum()
    names = sorted(leaves)
    wrt = [tx] + [tp[kk] for kk in names] + ([th] if with_state else [])
    got = torch.autograd.grad(loss, wrt)
    want_flat = [want[0]] + [want[1][kk] for kk in names] + \
        ([want[2]] if with_state else [])
    for label, g, w in zip(["x"] + names + ["ssm_state"], got, want_flat):
        assert g.shape == w.shape, label
        assert _rel_max(g, w) <= 1e-5, (label, _rel_max(g, w))


def _scan_inputs(b, s, i, n, seed, h0):
    """u, dt = softplus(normal), A = -exp(0.5·normal), Bm, Cm, D and an
    optional h0, drawn with numpy."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, s, i)),
            np.log1p(np.exp(rng.standard_normal((b, s, i)))),
            -np.exp(rng.standard_normal((i, n)) * 0.5),
            rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n)),
            rng.standard_normal(i)]
    if h0:
        arrs.append(rng.standard_normal((b, i, n)) * 0.5)
    return [a.astype(np.float32) for a in arrs]


def _jax_chunked_scan(u, dt, A, Bm, Cm, D, h0, chunk):
    """The reference's plain path of ``mamba_block``: ``_ssm_scan`` under
    ``jax.checkpoint`` over chunks, the state carried."""
    scan_ck = jax.checkpoint(JM._ssm_scan)
    h, ys = h0, []
    for s0 in range(0, u.shape[1], chunk):
        sl = slice(s0, s0 + chunk)
        y_c, h = scan_ck(u[:, sl], dt[:, sl], A, Bm[:, sl], Cm[:, sl], D,
                         h0=h)
        ys.append(y_c)
    return jnp.concatenate(ys, axis=1), h


@pytest.mark.parametrize("cotangent", ["y", "h_last", "both"])
@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("chunk", [8, 40])
def test_scan_ref_vjp_gradients_equal_the_plain_chunked_scan(chunk, h0,
                                                             cotangent):
    """B 2, S 37, I 16, N 4, in chunks of 8 (ragged) or one chunk: the
    op's gradients for a cotangent on y alone (h_last's is None, as in
    training), on h_last alone, or on both.  Against autograd through the
    port's plain chunked scan the same arithmetic: within 1e-6 of each
    gradient's max|g| (observed: 0); against ``jax.vjp`` of the
    reference's checkpointed chunked scan within 1e-5.  The op's own y is
    the kernel order's, within 1e-5 of the plain scan's."""
    arrs = _scan_inputs(2, 37, 16, 4, 40 + chunk, h0)
    rng = np.random.default_rng(41)
    gy = rng.standard_normal((2, 37, 16)).astype(np.float32)
    gh = rng.standard_normal((2, 16, 4)).astype(np.float32)
    cot = {"y": (gy, np.zeros_like(gh)), "h_last": (np.zeros_like(gy), gh),
           "both": (gy, gh)}[cotangent]

    def port(fn):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
        if not h0:
            ins.append(None)
        y, h = fn(*ins[:6], h0=ins[6], chunk=chunk)
        outs = {"y": [y], "h_last": [h], "both": [y, h]}[cotangent]
        gs = {"y": [gy], "h_last": [gh], "both": [gy, gh]}[cotangent]
        got = torch.autograd.grad(outs, [t for t in ins if t is not None],
                                  [torch.from_numpy(g) for g in gs],
                                  allow_unused=True, materialize_grads=True)
        return (y, h), got

    (y_op, h_op), got = port(ms_ops.mamba_scan_with_ref_vjp)
    (y_pl, h_pl), want = port(ssm_scan_chunked)
    ja = [jnp.asarray(a) for a in arrs] + ([] if h0 else [None])
    (jy, jh), vjp = jax.vjp(
        lambda *a: _jax_chunked_scan(*a[:6], a[6] if h0 else None, chunk),
        *[a for a in ja if a is not None])
    jgrads = vjp((jnp.asarray(cot[0]), jnp.asarray(cot[1])))
    for k, (g, w, j) in enumerate(zip(got, want, jgrads)):
        assert g.shape == w.shape == j.shape
        assert float((g - w).abs().max()) <= 1e-6 * float(w.abs().max()), k
        assert _rel_max(g, j) <= 1e-5, (k, _rel_max(g, j))
    assert _rel_max(y_op, y_pl.detach()) <= 1e-5
    assert _rel_max(h_op, h_pl.detach()) <= 1e-5
    assert y_op.grad_fn is not None


# --------------------------- train steps -------------------------------------

def _weights(arch, seed=0):
    """Both packages' reduced configs in fp32 with ``CHUNK`` and the
    reference's weights in each (the port's on the CPU)."""
    jcfg = jax_get_config(arch).reduced().with_(dtype="float32",
                                                ssm_chunk=CHUNK)
    cfg = get_config(arch).reduced().with_(dtype="float32", ssm_chunk=CHUNK)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    np_params = jax.tree.map(np.asarray, jparams)
    return cfg, jcfg, np_params


def _tokens(b, s, seed=2):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


@functools.cache
def _reference_step(arch):
    """The reference's first step on 4 x 33 tokens (its plain scan, remat
    full): (loss, grad norm, moments), and the same at two one-ulp
    perturbations of the weights (relative 6e-8 normal noise)."""
    _, jcfg, np_params = _weights(arch)
    tokens = {"tokens": jnp.asarray(_tokens(4, 33))}
    jopt = jax_adamw(1e-2, 1, 10)
    step = jax.jit(jax_make_train_step(jcfg, jopt))
    rng = np.random.default_rng(5)

    def run(p):
        state, m = step(jopt.init(jax.tree.map(jnp.asarray, p)), tokens)
        return (float(m["loss"]), float(m["grad_norm"]),
                [np.asarray(w) for _, w in flatten(jax.tree.map(np.asarray,
                                                                state.m))])
    runs = [run(np_params)]
    for _ in range(2):
        runs.append(run(jax.tree.map(
            lambda a: (a * (1 + 6e-8 * rng.standard_normal(a.shape))
                       ).astype(a.dtype), np_params)))
    return runs


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
@pytest.mark.parametrize("use_mamba_kernel", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch, use_mamba_kernel, remat):
    """One train step of the reduced config in fp32 from the reference's
    weights, on 4 x 33 tokens with the scan in chunks of 16: the loss
    within 1e-5 relative; the grad norm within 1e-5 relative and every
    gradient, read from m, within 1e-4 of its leaf's max|m| (falcon), or
    both no further from the reference's than one-ulp weight noise moves
    the reference's own (jamba; module docstring)."""
    cfg, _, np_params = _weights(arch)
    cfg = cfg.with_(use_mamba_kernel=use_mamba_kernel, remat=remat)
    (jloss, jgn, jm), *noisy = _reference_step(arch)
    params = params_from_jax(cfg, np_params, device="cpu")
    opt = adamw(1e-2, 1, 10)
    state, m = make_train_step(cfg, opt)(
        opt.init(params), {"tokens": torch.from_numpy(_tokens(4, 33))})
    assert int(m["step"]) == 1
    assert abs(float(m["loss"]) - jloss) <= 1e-5 * abs(jloss)
    gn_gap = abs(float(m["grad_norm"]) - jgn) / jgn
    m_gaps = [_rel_max(g, w) for (_, g), w in zip(flatten(state.m), jm)]
    if arch == "falcon-mamba-7b":
        gn_bar, m_bar = 1e-5, 1e-4
    else:
        gn_bar = max(abs(gn - jgn) / jgn for _, gn, _ in noisy)
        m_bar = max(max(float(np.abs(a - b).max() / np.abs(b).max())
                        for a, b in zip(mm, jm)) for _, _, mm in noisy)
        assert 0 < gn_bar < 1e-3 and 0 < m_bar < 1e-3
    assert gn_gap <= gn_bar, (gn_gap, gn_bar)
    assert max(m_gaps) <= m_bar, (max(m_gaps), m_bar)
    mamba = [path for path, _ in flatten(state.m) if "A_log" in path]
    assert mamba and all(float(g.abs().max()) > 0 for path, g in
                         flatten(state.m) if path in mamba)


def _pipelines(seed=0):
    kw = dict(global_batch=4, seq_len=32, n_hosts=3, host_cache_bytes=1 << 24,
              seed=seed)
    spec = dict(n_shards=4, tokens_per_shard=4096, vocab_size=256, seed=seed)
    return (JPipeline(JPipelineConfig(policy=JDispatchPolicy.MAX_COMPUTE_UTIL,
                                      **kw), JShardSpec(**spec)),
            DiffusionDataPipeline(
                PipelineConfig(policy=DispatchPolicy.MAX_COMPUTE_UTIL, **kw),
                ShardSpec(**spec), device="cpu"))


@pytest.mark.parametrize("arch", ARCHS)
def test_first_losses_match_reference_fp32(arch):
    """The reduced config in fp32 from the reference's weights, 3 steps
    through both pipelines (the same batches), the port on the kernel
    route: the losses agree at rtol 1e-4 and the ledgers are equal."""
    cfg, jcfg, np_params = _weights(arch)
    cfg = cfg.with_(use_mamba_kernel=True)
    jpipe, pipe = _pipelines()
    try:
        ref = jax_train(jcfg, jpipe, 3, seed=0, log=lambda s: None)
        got = train(cfg, pipe, 3, seed=0, log=lambda s: None,
                    params=params_from_jax(cfg, np_params, device="cpu"),
                    device="cpu")
    finally:
        jpipe.close()
        pipe.close()
    assert got.steps_run == ref.steps_run == 3
    np.testing.assert_allclose(got.losses, ref.losses, rtol=1e-4)
    assert got.pipeline_stats == ref.pipeline_stats


# --------------------------- the launcher ------------------------------------

_DONE = re.compile(r"^\[train\] done: 2 steps, final loss \d+\.\d{4}$")


@pytest.mark.parametrize("extra,route", [
    ([], "selective scan plain"),
    (["--no-mamba-kernel", "--remat", "dots"], "selective scan plain")])
def test_launcher_prints_the_reference_lines(extra, route):
    """``--arch falcon-mamba-7b --reduced --device cpu --steps 2``: the
    reference's two [train] lines (the loss differs: each package draws
    its own weights; the ledger is the same), then the times line, which
    names the scan the forward took (on the CPU the plain version, with
    the kernel route or without)."""
    argv = ["--arch", "falcon-mamba-7b", "--reduced", "--steps", "2"]
    jout = io.StringIO()
    with contextlib.redirect_stdout(jout):
        assert jax_launch.main(argv) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert launch.main(argv + ["--device", "cpu"] + extra) == 0
    jlines, lines = jout.getvalue().splitlines(), out.getvalue().splitlines()
    assert len(jlines) == 2 and len(lines) == 3
    assert _DONE.match(jlines[0]) and _DONE.match(lines[0])
    assert lines[1] == jlines[1]
    assert lines[2].startswith("[train] on cpu") and "tokens/s" in lines[2]
    assert lines[2].endswith(f"({route} in the forward)")

