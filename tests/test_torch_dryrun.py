"""The port's one-card dry run on the CPU: ``run_cell`` on the meta device
for a reduced config of every family (dense, ssm, moe, hybrid, encdec,
vlm) in every mode, its byte accounting against the meta tensors, its
depth fit against a full-depth meta pass, the temp bytes of a train and
a decode step against counts worked out by hand, the storage tracker,
and the ``dryrun`` command's files and summary line."""
import json

import pytest
import torch

from repro_torch import configs
from repro_torch.configs import ShapeSpec
from repro_torch.launch import cellrun, dryrun
from repro_torch.launch.mesh import make_card_mesh
from repro_torch.models import (abstract_cache, abstract_params, input_specs,
                                transformer as T)
from repro_torch.train import adamw

#: one config of each family, reduced, cut to 4 blocks so the depth fit
#: (depths 2 and 3) is used and checked against a full-depth pass
FAMILIES = {"dense": "h2o-danube-3-4b", "ssm": "falcon-mamba-7b",
            "moe": "qwen3-moe-30b-a3b", "hybrid": "jamba-1.5-large-398b",
            "encdec": "whisper-base", "vlm": "llava-next-mistral-7b"}
MODES = ["train", "prefill", "decode"]
SEQ, BATCH = 32, 2


def _cfg(family: str):
    return cellrun._depth_variant(
        configs.get_config(FAMILIES[family]).reduced(), 4)


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t.device.type == "meta")


def _argument_bytes(cfg, shape) -> int:
    """What the cell's arguments hold, from the stand-ins alone:
    parameters, their fp32 AdamW m and v (train), the cache (decode) and
    the inputs."""
    params = [t for _, t in T.flatten(abstract_params(cfg))]
    total = _bytes(params)
    if shape.mode == "train":
        total += 2 * sum(4 * t.numel() for t in params)
    if shape.mode == "decode":
        total += _bytes(t for _, t in T.flatten(
            abstract_cache(cfg, shape.global_batch, shape.seq_len)))
    return total + _bytes(input_specs(cfg, shape.seq_len, shape.global_batch,
                                      shape.mode).values())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_run_cell_fit_and_bytes(family, mode):
    cfg = _cfg(family)
    shape = ShapeSpec(f"test_{mode}", SEQ, BATCH, mode)
    mesh = make_card_mesh()
    fit = cellrun.run_cell(cfg, shape, mesh, "one_card", verbose=False,
                           memory_bytes=80e9)
    full = cellrun.run_cell(cfg, shape, mesh, "one_card", verbose=False,
                            loop_correct=False, memory_bytes=80e9)
    assert fit.ok and full.ok, (fit.error, full.error)
    assert fit.n_devices == 1 and fit.collective_per_device == {}
    assert fit.argument_bytes == full.argument_bytes == _argument_bytes(
        cfg, shape)
    assert full.per_device_flops > 0
    assert fit.per_device_flops == pytest.approx(full.per_device_flops,
                                                 rel=1e-2)
    assert fit.output_bytes == full.output_bytes
    assert fit.temp_bytes == full.temp_bytes
    for r in (fit, full):
        assert r.peak_bytes_per_device == (r.argument_bytes + r.output_bytes
                                           + r.temp_bytes)
        assert r.temp_bytes > 0 and r.fits is True
    if mode == "train":   # the state is updated in place: the loss and
        assert fit.output_bytes == 8      # the grad norm, 0-dim fp32
    else:                 # last-position logits (B, 1, V) fp32
        assert fit.output_bytes == 4 * BATCH * cfg.vocab_size


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_every_term_is_linear_in_the_depth(family):
    """What the vision-training phase reads off two dry runs: each term of
    a train cell at depth 6 is on the line through depths 2 and 3, the
    argument bytes (computed whole at each depth) too."""
    base = configs.get_config(FAMILIES[family]).reduced()
    shape = ShapeSpec("test_train", SEQ, BATCH, "train")
    r2, r3, r6 = (cellrun.run_cell(cellrun._depth_variant(base, k), shape,
                                   make_card_mesh(), "c", verbose=False)
                  for k in (2, 3, 6))
    assert cellrun.FIT_DEPTHS == (2, 3)
    for term in ("per_device_flops", "argument_bytes", "output_bytes",
                 "temp_bytes", "peak_bytes_per_device"):
        a, b = getattr(r2, term), getattr(r3, term)
        assert getattr(r6, term) == a + (b - a) * 4, term


#: dense configs without a logit softcap, their vocabulary widened so that
#: the unembedding (decode) and AdamW's update of the embedding (train)
#: hold the step's peak
HAND_COUNTED = ["h2o-danube-3-4b", "llava-next-mistral-7b", "nemotron-4-15b",
                "starcoder2-15b"]
WIDE_VOCAB = 32768


def _wide(arch: str, k: int):
    return cellrun._depth_variant(
        configs.get_config(arch).reduced().with_(vocab_size=WIDE_VOCAB), k)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("arch", HAND_COUNTED)
def test_train_temp_is_the_gradients_and_adamws_temporaries(arch, k, batch):
    """A train step's temp bytes worked out by hand.  With 32 tokens a row
    and a 32,768-token vocabulary the step's peak comes in AdamW's last
    line on the embedding (``Optimizer._update``: ``p.copy_(p.float() -
    lr * delta)``).  Held then: every parameter's gradient, in the
    parameter's dtype (``autograd.grad`` returns them all before the
    update starts); seven fp32 copies of the embedding (g, v-hat, m-hat,
    delta, p in fp32, lr * delta and their difference); and the clip
    scale, one fp32 scalar.  The loss and the grad norm are the outputs;
    the step count and the learning rate live on the host.  Every block's
    activations, recomputed under remat full, are freed by then, so depth
    5 (the depth fit) adds only its blocks' gradients."""
    cfg = _wide(arch, k)
    r = cellrun.run_cell(cfg, ShapeSpec("t", 32, batch, "train"),
                         make_card_mesh(), "c", verbose=False)
    params = [t for _, t in T.flatten(abstract_params(cfg))]
    embed = cfg.vocab_size * cfg.d_model
    assert max(t.numel() for t in params) == embed
    assert r.ok and r.output_bytes == 4 + 4
    assert r.temp_bytes == _bytes(params) + 7 * 4 * embed + 4


@pytest.mark.parametrize("seq", [32, 64])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("arch", HAND_COUNTED)
def test_decode_temp_is_the_unembeds_product(arch, k, seq):
    """A decode step's temp bytes worked out by hand.  The cache is
    written in place and each block's activations are freed before the
    next block runs, so the peak comes in the unembedding: the final
    normed residual (B, 1, D) and its product with the embedding in bf16
    (B, 1, V), live beside the fp32 logits (B, 1, V) that it is cast to,
    the step's output.  It does not grow with the depth or the cache."""
    cfg = _wide(arch, k)
    r = cellrun.run_cell(cfg, ShapeSpec("t", seq, BATCH, "decode"),
                         make_card_mesh(), "c", verbose=False)
    assert r.ok and r.output_bytes == BATCH * cfg.vocab_size * 4
    assert r.temp_bytes == BATCH * cfg.vocab_size * 2 + BATCH * cfg.d_model * 2


def test_run_cell_takes_passes_run_elsewhere():
    """The dry run's worker processes run a cell's passes; ``run_cell``
    puts them together as it does its own, and a pass that raised makes
    the cell a failure."""
    cfg = _cfg("moe")
    shape = ShapeSpec("test_prefill", SEQ, BATCH, "prefill")
    mesh = make_card_mesh()
    passes = {k: cellrun.depth_pass(cfg, shape, mesh, k)
              for k in cellrun.fit_depths(cfg)}
    given = cellrun.run_cell(cfg, shape, mesh, "c", verbose=False,
                             passes=passes).to_dict()
    own = cellrun.run_cell(cfg, shape, mesh, "c", verbose=False).to_dict()
    assert given.pop("seconds") > 0 and own.pop("seconds") > 0
    assert given == own and given["ok"]
    passes[3] = MemoryError("out of host memory")
    bad = cellrun.run_cell(cfg, shape, mesh, "c", verbose=False,
                           passes=passes)
    assert not bad.ok and bad.error == "MemoryError: out of host memory"
    assert cellrun.fit_depths(cfg) == (2, 3)
    assert cellrun.fit_depths(cfg, loop_correct=False) == (4,)
    assert cellrun.fit_depths(cellrun._depth_variant(cfg, 3)) == (3,)


def test_run_cell_counts_donated_outputs_when_asked():
    cfg = _cfg("dense")
    shape = ShapeSpec("test_decode", SEQ, BATCH, "decode")
    mesh = make_card_mesh()
    kept = cellrun.run_cell(cfg, shape, mesh, "c", verbose=False)
    new = cellrun.run_cell(cfg, shape, mesh, "c", verbose=False,
                           donate=False)
    cache = _bytes(t for _, t in T.flatten(abstract_cache(cfg, BATCH, SEQ)))
    assert new.output_bytes - kept.output_bytes == cache


def test_run_cell_fits_against_the_memory_given():
    cfg = _cfg("dense")
    shape = ShapeSpec("test_train", SEQ, BATCH, "train")
    r = cellrun.run_cell(cfg, shape, make_card_mesh(), "c", verbose=False,
                         memory_bytes=1e6)
    assert r.ok and r.fits is False and r.memory_bytes == 1e6
    assert cellrun.run_cell(cfg, shape, make_card_mesh(), "c",
                            verbose=False).fits is None


def test_run_cell_failure_is_data(capsys):
    cfg = _cfg("dense")
    bad = cfg.with_(pattern=(cfg.pattern[0].__class__(kind="conv"),))
    r = cellrun.run_cell(bad, ShapeSpec("t", SEQ, BATCH, "train"),
                         make_card_mesh(), "one_card")
    assert not r.ok and "conv" in r.error
    assert "FAIL" in capsys.readouterr().out


def test_run_cell_flops_count_products_only():
    """A dense 1-block forward (prefill, no backward): the FLOPs are those
    of the products: q/k/v/o and the gated MLP, the blocked attention's
    two einsums over every (query, key) pair, and the last position's
    unembed."""
    cfg = cellrun._depth_variant(configs.get_config(FAMILIES["dense"])
                                 .reduced(), 1)
    r = cellrun.run_cell(cfg, ShapeSpec("t", SEQ, BATCH, "prefill"),
                         make_card_mesh(), "c", verbose=False)
    d, h, kv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim_, cfg.d_ff)
    tokens = BATCH * SEQ
    proj = 2 * tokens * (d * (h + 2 * kv) * dh + h * dh * d + 3 * d * f)
    attn = 2 * 2 * BATCH * h * SEQ * SEQ * dh
    unembed = 2 * BATCH * d * cfg.vocab_size
    assert r.per_device_flops == proj + attn + unembed


def test_live_bytes_counts_a_storage_until_it_is_freed():
    x = torch.empty(1000, device="meta")
    with cellrun.LiveBytes([x]) as mem:
        y = x * 2                   # 4,000 new bytes
        view = y[:10]               # a view: nothing new
        del y
        assert mem.live == 4000     # the view holds the storage
        del view
        assert mem.live == 0
        z = x + 1
        w = z * 3
        assert mem.live == mem.peak == 8000
        del z, w
        x.add_(1)                   # in place on an argument: nothing new
    assert mem.live == 0 and mem.peak == 8000


@pytest.mark.parametrize("shape", [None, "decode_32k"])
def test_dryrun_writes_each_cell_and_the_summary(tmp_path, capsys, shape):
    """whisper-base's four cells (three run in worker processes, long_500k
    is a documented skip), or one of them (run in this process)."""
    argv = ["--arch", "whisper-base", "--device", "cpu", "--memory-gb", "80",
            "--out", str(tmp_path)]
    rc = dryrun.main(argv + (["--shape", shape] if shape else []))
    out = capsys.readouterr().out
    assert rc == 0
    assert out.strip().splitlines()[-1].startswith(
        "dry-run: 1 ok, 0 failed, 0 skipped" if shape else
        "dry-run: 3 ok, 0 failed, 1 skipped")
    shapes = [shape] if shape else ["train_4k", "prefill_32k", "decode_32k"]
    for name in shapes:
        d = json.loads((tmp_path / f"whisper-base__{name}__one_card.json")
                       .read_text())
        assert d["ok"] and not d["skipped"] and d["n_devices"] == 1
        assert d["memory_bytes"] == 80e9 and d["fits"] in (True, False)
        assert d["peak_bytes_per_device"] == (d["argument_bytes"]
                                              + d["output_bytes"]
                                              + d["temp_bytes"])
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(
        f"whisper-base__{n}__one_card.json"
        for n in (shapes + ([] if shape else ["long_500k"])))


def test_dryrun_writes_the_documented_skips(tmp_path, capsys):
    rc = dryrun.main(["--shape", "long_500k", "--arch", "llava-next-mistral-7b",
                      "--device", "cpu", "--memory-gb", "80", "--out",
                      str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "SKIP llava-next-mistral-7b__long_500k__one_card" in out
    assert "dry-run: 0 ok, 0 failed, 1 skipped" in out
    d = json.loads((tmp_path / "llava-next-mistral-7b__long_500k__one_card"
                               ".json").read_text())
    assert d["skipped"] and "long_500k" in d["reason"]


def test_dryrun_needs_the_card_or_a_memory(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="cuda"):
        dryrun.main(["--arch", "whisper-base", "--out", str(tmp_path)])
    with pytest.raises(ValueError, match="memory-gb"):
        dryrun.main(["--arch", "whisper-base", "--device", "cpu", "--out",
                     str(tmp_path)])


def test_build_cell_gives_the_step_its_meta_arguments():
    cfg = _cfg("vlm")
    shape = ShapeSpec("t", SEQ, BATCH, "train")
    fn, (state, batch), in_specs, out_specs, rules = cellrun.build_cell(
        cfg, shape, make_card_mesh(), optimizer=adamw())
    assert set(batch) == {"tokens", "image_embeds"}
    assert all(t.device.type == "meta" for _, t in T.flatten(state.params))
    assert in_specs[1] == {"tokens": ("data",),
                           "image_embeds": ("data",)}
    assert rules.mesh.devices.size == 1
