"""The port's parallel layer against the reference's, on the CPU, exactly
(nothing here is a float): the cell grid (``SHAPES``, ``skip_reason``,
``cells``), every logical-axis tree (parameters, cache, inputs, optimizer
state), the meta stand-ins against the reference's ``ShapeDtypeStruct``s,
the rules of every cell and the spec of every leaf on both production
meshes, the reference's sharding-logic cases, and ``_depth_variant``.

A reference spec is a ``PartitionSpec``; the port's is a tuple, so the
reference's is compared as ``tuple(spec)``.  The reference's rules are
built on a stand-in mesh that has only ``axis_names`` and
``devices.shape`` (``tests/test_sharding.py``'s idiom): that is all the
rules read."""
import dataclasses

import jax
import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jax_configs
from repro.launch import cellrun as jax_cellrun
from repro.models import model as jax_model
from repro.models import transformer as jax_T
from repro.parallel import sharding as jax_sharding
from repro.train import optimizer as jax_optimizer
from repro_torch import configs
from repro_torch.launch import cellrun
from repro_torch.models import model
from repro_torch.models import transformer as T
from repro_torch.parallel import (LogicalRules, make_local_mesh,
                                  make_production_mesh, make_rules)
from repro_torch.parallel import sharding
from repro_torch.train import optimizer

ARCHS = sorted(configs.REGISTRY)
CELLS = [(c.name, s.name) for c, s, _ in configs.cells(include_skipped=True)]
RUNNABLE = [(c.name, s.name) for c, s, _ in configs.cells()]
MESHES = {"single_pod_16x16": ((16, 16), ("data", "model")),
          "multi_pod_2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _fake_mesh(shape, axes):
    class FakeMesh:
        axis_names = axes
        devices = type("D", (), {"shape": shape})()
    return FakeMesh()


def _cfgs(arch: str):
    return jax_configs.get_config(arch), configs.get_config(arch)


def _shapes(name: str):
    return jax_configs.SHAPES[name], configs.SHAPES[name]


# --------------------------------------------------------------------------
# The cell grid
# --------------------------------------------------------------------------

def test_shapes_are_the_references():
    assert list(configs.SHAPES) == list(jax_configs.SHAPES)
    for name, s in configs.SHAPES.items():
        assert dataclasses.astuple(s) == dataclasses.astuple(
            jax_configs.SHAPES[name])


def test_cells_are_the_references_forty():
    want = [(c.name, s.name, r)
            for c, s, r in jax_configs.cells(include_skipped=True)]
    got = [(c.name, s.name, r)
           for c, s, r in configs.cells(include_skipped=True)]
    assert got == want
    assert len(got) == 40
    assert sum(r is not None for *_, r in got) == 6
    assert [(c.name, s.name) for c, s, _ in configs.cells()] == [
        (a, s) for a, s, r in want if r is None]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_skip_reason_is_the_references(arch, shape):
    (jc, pc), (js, ps) = _cfgs(arch), _shapes(shape)
    assert configs.skip_reason(pc, ps) == jax_configs.skip_reason(jc, js)


# --------------------------------------------------------------------------
# Logical-axis trees
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_param_logical_is_the_references(arch):
    jc, pc = _cfgs(arch)
    assert T.param_logical(pc) == jax_T.param_logical(jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_logical_is_the_references(arch):
    jc, pc = _cfgs(arch)
    assert T.cache_logical(pc) == jax_T.cache_logical(jc)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_batch_logical_is_the_references(arch, mode):
    jc, pc = _cfgs(arch)
    assert model.batch_logical(pc, mode) == jax_model.batch_logical(jc, mode)


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_state_logical_is_the_references(arch, factored):
    jc, pc = _cfgs(arch)
    got = optimizer.adamw(factored=factored).state_logical(
        T.param_logical(pc))
    want = jax_optimizer.adamw(factored=factored).state_logical(
        jax_T.param_logical(jc))
    assert tuple(got) == tuple(want)
    if factored:   # a 2-D+ leaf's v is the (rows, columns) pair
        assert got.v["embed"] == (("tp",), ("fsdp",))


# --------------------------------------------------------------------------
# Meta stand-ins against the reference's ShapeDtypeStructs
# --------------------------------------------------------------------------

def _leaves(tree) -> list:
    """(path, shape, dtype name) of every leaf, in sorted-path order."""
    return [(path, tuple(x.shape), str(x.dtype).removeprefix("torch."))
            for path, x in T.flatten(tree)]


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_the_reference(arch):
    jc, pc = _cfgs(arch)
    got = T.abstract_params(pc)
    assert all(x.device.type == "meta" for _, x in T.flatten(got))
    assert _leaves(got) == _leaves(jax_T.abstract_params(jc))


@pytest.mark.parametrize("arch,shape", RUNNABLE)
def test_input_specs_and_cache_match_the_reference(arch, shape):
    (jc, pc), (js, ps) = _cfgs(arch), _shapes(shape)
    got = model.input_specs(pc, ps.seq_len, ps.global_batch, ps.mode)
    want = jax_model.input_specs(jc, js.seq_len, js.global_batch, js.mode)
    assert all(x.device.type == "meta" for x in got.values())
    assert _leaves(got) == _leaves(want)
    if ps.mode == "decode":
        got = model.abstract_cache(pc, ps.global_batch, ps.seq_len)
        want = jax_model.abstract_cache(jc, js.global_batch, js.seq_len)
        assert all(x.device.type == "meta" for _, x in T.flatten(got))
        assert _leaves(got) == _leaves(want)


# --------------------------------------------------------------------------
# Rules and specs on the production meshes
# --------------------------------------------------------------------------

def _jax_specs(rules, logical_tree, abstract_tree) -> list:
    is_lg = jax_sharding._is_logical
    lgs = jax.tree.leaves(logical_tree, is_leaf=is_lg)
    abs_ = jax.tree.leaves(abstract_tree)
    assert len(lgs) == len(abs_)
    return [tuple(rules.spec_for_shape(lg, tuple(a.shape)))
            for lg, a in zip(lgs, abs_)]


def _port_specs(rules, logical_tree, abstract_tree) -> list:
    specs = sharding.named_shardings(rules, logical_tree, abstract_tree)
    if isinstance(specs, optimizer.TrainState):   # jax's leaf order
        return [specs.step] + [s for part in specs[1:]
                               for _, s in T.flatten(part)]
    return [s for _, s in T.flatten(specs)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_rules_and_leaf_specs_match_the_reference(arch, shape, mesh):
    (jc, pc), (js, ps) = _cfgs(arch), _shapes(shape)
    jrules = jax_cellrun.rules_for_cell(jc, js, _fake_mesh(*MESHES[mesh]))
    prules = cellrun.rules_for_cell(pc, ps, make_production_mesh(
        multi_pod=mesh.startswith("multi")))
    assert prules.rules == jrules.rules
    want = _jax_specs(jrules, jax_T.param_logical(jc),
                      jax_T.abstract_params(jc))
    got = _port_specs(prules, T.param_logical(pc), T.abstract_params(pc))
    assert got == want
    if ps.mode == "train":
        jopt, popt = jax_optimizer.adamw(), optimizer.adamw()
        want = _jax_specs(jrules, jopt.state_logical(jax_T.param_logical(jc)),
                          jax.eval_shape(jopt.init, jax_T.abstract_params(jc)))
        got = _port_specs(prules, popt.state_logical(T.param_logical(pc)),
                          popt.init(T.abstract_params(pc)))
        assert got == want
        want = _jax_specs(jrules, jax_model.batch_logical(jc, js.mode),
                          jax_model.input_specs(jc, js.seq_len,
                                                js.global_batch, js.mode))
        got = _port_specs(prules, model.batch_logical(pc, ps.mode),
                          model.input_specs(pc, ps.seq_len, ps.global_batch,
                                            ps.mode))
        assert got == want
    if ps.mode == "decode":
        want = _jax_specs(jrules, jax_T.cache_logical(jc),
                          jax_model.abstract_cache(jc, js.global_batch,
                                                   js.seq_len))
        got = _port_specs(prules, T.cache_logical(pc),
                          model.abstract_cache(pc, ps.global_batch,
                                               ps.seq_len))
        assert got == want


@pytest.mark.parametrize("kw", [
    {}, {"fsdp": False}, {"expert_parallel": False},
    {"sequence_parallel": True}, {"extra": {"act_seq": ("model",)}}],
    ids=["default", "no-fsdp", "no-ep", "sp", "extra"])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_make_rules_is_the_references(mesh, kw):
    got = make_rules(make_production_mesh(
        multi_pod=mesh.startswith("multi")), **kw)
    want = jax_sharding.make_rules(_fake_mesh(*MESHES[mesh]), **kw)
    assert got.rules == want.rules
    assert make_rules(None) == LogicalRules({}, None)


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_default_layout_is_the_references(arch, mode):
    jc, pc = _cfgs(arch)
    assert cellrun.default_layout(pc) == jax_cellrun.default_layout(jc)
    assert (cellrun.default_layout_for(pc, mode)
            == jax_cellrun.default_layout_for(jc, mode))


def test_production_meshes_describe_the_references():
    single, multi = (make_production_mesh(multi_pod=m) for m in (False, True))
    assert (single.axis_names, single.devices.shape, single.devices.size) \
        == (("data", "model"), (16, 16), 256)
    assert (multi.axis_names, multi.devices.shape, multi.devices.size) \
        == (("pod", "data", "model"), (2, 16, 16), 512)


# --------------------------------------------------------------------------
# tests/test_sharding.py's logic cases, on the port's LogicalRules
# --------------------------------------------------------------------------

def _mk(rules_dict, mesh_shape=(16, 16), axes=("data", "model")):
    mesh = _fake_mesh(mesh_shape, axes)
    return LogicalRules(rules_dict, mesh), jax_sharding.LogicalRules(
        rules_dict, mesh)


def _both(pair, logical, shape):
    got = pair[0].spec_for_shape(logical, shape)
    assert got == tuple(pair[1].spec_for_shape(logical, shape))
    return got


def test_divisibility_guard_drops_non_dividing_axes():
    r = _mk({"tp": ("model",), "fsdp": ("data",)})
    # whisper vocab 51865 % 16 != 0 -> tp dropped on that dim
    assert _both(r, ("tp", "fsdp"), (51865, 512)) == tuple(P(None, "data"))
    assert _both(r, ("tp", "fsdp"), (51200, 512)) == tuple(P("model", "data"))


def test_mixtral_expert_dim_does_not_consume_model_axis():
    """8 experts cannot use the 16-way axis; d_ff MUST still get it."""
    r = _mk({"expert": ("model",), "fsdp": ("data",), "tp": ("model",)})
    spec = _both(r, ("expert", "fsdp", "tp"), (8, 6144, 16384))
    assert spec == (None, "data", "model")


def test_multi_axis_logical_name():
    r = _mk({"batch": ("pod", "data", "model")}, (2, 16, 16),
            ("pod", "data", "model"))
    # 256 over 2*16*16=512: pod*data=32 divides, then model would need 512
    assert _both(r, ("batch",), (256,)) == (("pod", "data"),)
    assert _both(r, ("batch",), (512,)) == (("pod", "data", "model"),)
    # batch=1 (long_500k): everything dropped
    assert _both(r, ("batch",), (1,)) == ()


def test_axis_used_once_across_dims():
    r = _mk({"tp": ("model",), "act_seq": ("model",), "batch": ("data",)})
    # act_seq claims model on dim1 => vocab dim gets nothing
    spec = _both(r, ("batch", "act_seq", "tp"), (256, 4096, 32000))
    assert spec == ("data", "model")


@pytest.mark.parametrize("logical", [
    ("batch", None, "tp"), ("tp", "tp"), (None, None), ("expert", "fsdp"),
    ("layers", "fsdp", "tp", None), ()])
def test_spec_for_is_the_references(logical):
    rules = {"batch": ("pod", "data"), "tp": ("model",),
             "fsdp": ("pod", "data"), "expert": ("model",)}
    port, ref = _mk(rules, (2, 16, 16), ("pod", "data", "model"))
    assert port.spec_for(logical) == tuple(ref.spec_for(logical))
    assert sharding.logical_to_spec(port, {"x": logical}) == {
        "x": port.spec_for(logical)}


def test_one_card_shards_nothing():
    import torch

    x = torch.ones(4, 4)
    rules = make_rules(None)
    assert sharding.shard(x, rules, "batch", "tp") is x
    tree = {"a": x}
    assert sharding.shard_tree(tree, rules, {"a": ("batch", "tp")}) is tree
    assert sharding.named_shardings(rules, {"a": ("batch", "tp")},
                                    tree) is tree
    assert rules.spec_for_shape(("batch", "tp"), (4, 4)) == ()
    assert rules.sharding_for(("batch",)) is None
    # a local mesh is one the visible cards cover, and none without a card
    assert (make_local_mesh(1, 1) is None) == (torch.cuda.device_count() < 1)


#: every model entry point that takes the reference's ``rules``
ENTRY_POINTS = [(model, n) for n in (
    "lm_loss", "make_forward", "make_prefill", "make_serve_step",
    "make_hidden_forward", "make_loss_fn", "make_train_step")] + [
    (T, n) for n in (
        "forward_lm_hidden", "embed_inputs", "forward_lm", "encode",
        "forward_encdec_hidden", "decode_train", "forward_encdec",
        "decode_step_lm", "decode_step_encdec")]


@pytest.mark.parametrize("mod,name", ENTRY_POINTS,
                         ids=[n for _, n in ENTRY_POINTS])
def test_entry_point_takes_rules_where_the_reference_does(mod, name):
    """The reference's parameters in its order, and a value of another
    type where ``rules`` stands (an argument put one place too early)
    raises before the function runs."""
    import inspect

    fn = getattr(mod, name)
    ref = getattr(jax_model if mod is model else jax_T, name)
    params = list(inspect.signature(fn).parameters)
    assert params == list(inspect.signature(ref).parameters)
    at = params.index("rules")
    with pytest.raises(TypeError, match=f"{name}: rules must be"):
        fn(*([None] * at), 64)
    with pytest.raises(TypeError, match="not int"):
        fn(*([None] * at), rules=64)


# --------------------------------------------------------------------------
# The depth cut
# --------------------------------------------------------------------------

@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_depth_variant_is_the_references(arch, k):
    jc, pc = _cfgs(arch)
    got = cellrun._depth_variant(pc, k)
    want = jax_cellrun._depth_variant(jc, k)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.n_blocks == k
