"""Run one (arch x shape) cell's step on the ``meta`` device and reckon
what it costs one card.

The port of the reference's ``repro.launch.cellrun``, shared by the dry
run (``launch.dryrun``) and by ``chip_smoke.py``, which picks the depth
its vision-model training fits at.  Nothing model-sized is allocated: the
parameters, optimizer state, cache and inputs are ``meta`` tensors
(``abstract_params``, ``input_specs``, ``abstract_cache``), and the step
runs on them under two dispatch modes:

  * ``torch.utils.flop_counter.FlopCounterMode`` counts the FLOPs of the
    products (matmuls, einsums, convolutions) of the forward, the remat
    recompute and the backward.  Elementwise work counts 0, so the Mamba
    selective scan, which is all elementwise, adds nothing;
  * :class:`LiveBytes` counts each new storage's bytes from the op that
    creates it until it is freed, and keeps the peak: ``temp_bytes`` (what
    the step allocates beyond its arguments, less its outputs).

The step runs with the config as the registry holds it (``attn_impl=
"blocked"`` and the chunked scan, the reference's defaults), so no CUDA
kernel is asked to run on ``meta``.  ``argument_bytes`` (parameters,
optimizer state for train, cache for decode, inputs) and ``output_bytes``
are summed from the tensors exactly; ``peak_bytes_per_device`` is
argument + output + temp, and ``fits`` says whether that is within the
card's memory.  The port's train step updates the state in place and the
decode step the cache, as the reference's donate them: such outputs are
the arguments' storages and are not counted again (``donate=False``
counts them as a step that wrote new ones would hold them).

The plain chunked scan and the blocked attention are Python loops over
the sequence, so a meta pass at full depth is slow: FLOPs, output and
temp bytes come from two depth variants (``_depth_variant``) fitted to
``a + b·n_blocks``, as the reference fits XLA's count of a loop body;
argument bytes are exact at full depth.  The variants are 2 and 3 blocks
deep (``FIT_DEPTHS``), not the reference's 1 and 2: FLOPs are linear
from one block, but without a gradient the first block's input is held
by its callers through the whole stack, so from the second block on the
peak holds one residual more than at one block, and a fit through
depth 1 would overstate a prefill's temp by one residual for each block
past the second.  The passes of a cell are separate
(:func:`fit_depths`, :func:`depth_pass`), so the dry run can run them in
separate processes.  ``seconds`` is the host time of the meta passes,
in place of the reference's ``lower_s``/``compile_s``.  There is one
card, so ``n_devices`` is 1 and ``collective_per_device`` is ``{}``.  Left out as XLA and TPU-pod
machinery with no counterpart here: ``f32_shadow_bytes`` (CPU-backend
fp32 twins in HLO), ``collective_bytes_from_hlo``,
``peak_tpu_adjusted``, ``generated_code_bytes``, ``per_device_bytes``
(XLA's bytes accessed) and the 512-device mesh.
"""
from __future__ import annotations

import time
import weakref
from dataclasses import dataclass, field
from typing import Any, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ShapeSpec
from repro_torch.models import (abstract_cache, abstract_params, batch_logical,
                                cache_logical, input_specs, make_prefill,
                                make_serve_step, make_train_step,
                                param_logical)
from repro_torch.models.config import ModelConfig
from repro_torch.parallel.sharding import (LogicalRules, make_rules,
                                           named_shardings)
from repro_torch.train.optimizer import Optimizer, adamw


class LiveBytes(TorchDispatchMode):
    """The peak, over the ops run under it, of the bytes of the live
    storages those ops created on a device (a CPU storage, such as the
    optimizer's host step count, is not counted).  A storage counts from
    the op that creates it until it is freed; the storages of ``known``
    tensors (the step's arguments) and views of any storage seen before
    count nothing."""

    def __init__(self, known=()):
        super().__init__()
        self.live = 0
        self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for t in known:
            self._seen[t.untyped_storage()] = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor) and t.device.type != "cpu":
                self._track(t.untyped_storage())
        return out

    def _track(self, st) -> None:
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors) -> int:
    """Bytes of the distinct device storages under ``tensors``."""
    seen = {}
    for t in tensors:
        if t.device.type != "cpu":
            st = t.untyped_storage()
            seen[id(st)] = st.nbytes()
    return sum(seen.values())


@dataclass
class CellResult:
    arch: str
    shape: str
    mesh: str
    ok: bool = False
    error: str = ""
    n_devices: int = 0
    seconds: float = 0.0               # the meta passes, host clock
    per_device_flops: float = 0.0
    collective_per_device: dict[str, float] = field(default_factory=dict)
    peak_bytes_per_device: float = 0.0
    argument_bytes: float = 0.0
    output_bytes: float = 0.0
    temp_bytes: float = 0.0
    model_params: float = 0.0
    active_params: float = 0.0
    memory_bytes: float = 0.0          # the card's; 0 where not given
    fits: Optional[bool] = None

    def to_dict(self) -> dict[str, Any]:
        return {k: getattr(self, k) for k in self.__dataclass_fields__}


def default_layout(cfg: ModelConfig) -> str:
    """Baseline parallel layout per family (DESIGN.md §5):

    fsdp_tp_sp -- FSDP over (pod,data) + TP over model + sequence-parallel
        residual stream.  Right when per-layer TP shrinks the big matmuls
        (dense attention archs, qwen3's 128-expert EP).
    dp_zero3 -- batch over EVERY mesh axis + ZeRO-3 over every axis, no TP.
        Right when layers must see the full sequence anyway (mamba's scan)
        or when experts cannot divide the model axis (mixtral's 8 on 16).
    """
    if cfg.family in ("ssm", "hybrid"):
        return "dp_zero3"
    if cfg.n_experts and cfg.n_experts % 16 != 0:
        return "dp_zero3"          # mixtral: EP cannot divide the model axis
    return "fsdp_tp_sp"


def default_layout_for(cfg: ModelConfig, mode: str) -> str:
    """dp_zero3 exists to fit TRAIN optimizer state; inference shapes have
    no optimizer state and want sequence/TP sharding."""
    if mode in ("prefill", "decode"):
        return "fsdp_tp_sp"
    return default_layout(cfg)


def rules_for_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
                   *, layout: Optional[str] = None,
                   seq_shard_decode: bool = True) -> LogicalRules:
    """The reference's default (baseline) rules of a cell on ``mesh``."""
    layout = layout or default_layout_for(cfg, shape.mode)
    all_axes = tuple(mesh.axis_names)
    if shape.mode == "decode":
        dp = [a for a in ("pod", "data") if a in mesh.axis_names]
        dp_size = 1
        for a in dp:
            dp_size *= mesh.devices.shape[mesh.axis_names.index(a)]
        batch_ok = shape.global_batch % dp_size == 0
        extra = {}
        if seq_shard_decode:
            extra["kv_seq"] = ("model",) if batch_ok else all_axes
        if not batch_ok:
            extra["batch"] = ()
        rules = make_rules(mesh, fsdp=True, extra=extra)
        if layout == "dp_zero3":
            r = dict(rules.rules)
            r["fsdp"] = all_axes
            r["tp"] = ()
            r["tp_fsdp"] = all_axes
            rules = LogicalRules(r, mesh)
        return rules
    if layout == "dp_zero3":
        return make_rules(mesh, extra={
            "batch": all_axes, "fsdp": all_axes, "tp": (),
            "tp_fsdp": all_axes,
            "act_seq": (), "expert": ("model",) if "model" in all_axes else (),
        })
    # fsdp_tp_sp: sequence-parallel residual stream
    return make_rules(mesh, fsdp=True, extra={"act_seq": ("model",)})


def _depth_variant(cfg: ModelConfig, k: int) -> ModelConfig:
    """Same arch with k pattern-blocks (and k encoder layers for enc-dec);
    used to fit cost = a + b*n_blocks."""
    kw: dict = {"n_layers": cfg.period * k, "scan_unroll": max(k, 1)}
    if cfg.is_encdec:
        kw["enc_layers"] = k
    return cfg.with_(**kw)


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               rules: Optional[LogicalRules] = None,
               optimizer: Optional[Optimizer] = None):
    """Returns (fn, args, in_specs, out_specs, rules): the cell's step,
    its ``meta`` arguments, and the specs of the arguments and outputs on
    ``mesh`` (``named_shardings``).  The decode step's position is the
    last slot of the cache, as a host integer."""
    rules = rules or rules_for_cell(cfg, shape, mesh)
    params_ab = abstract_params(cfg)
    params_lg = param_logical(cfg)
    batch_ab = input_specs(cfg, shape.seq_len, shape.global_batch, shape.mode)
    batch_lg = batch_logical(cfg, shape.mode)
    batch_sh = named_shardings(rules, batch_lg, batch_ab)
    scalar = torch.empty((), device="meta")

    if shape.mode == "train":
        opt = optimizer or adamw(3e-4, 100, 10_000)
        state_ab = opt.init(params_ab)
        state_lg = opt.state_logical(params_lg)
        state_sh = named_shardings(rules, state_lg, state_ab)
        fn = make_train_step(cfg, opt, rules)
        metrics_sh = {k: named_shardings(rules, (), scalar)
                      for k in ("loss", "grad_norm", "step")}
        return fn, (state_ab, batch_ab), (state_sh, batch_sh), \
            (state_sh, metrics_sh), rules
    logits_ab = torch.empty((shape.global_batch, 1, cfg.vocab_size),
                            device="meta")
    logits_sh = named_shardings(rules, ("batch", None, "tp"), logits_ab)
    params_sh = named_shardings(rules, params_lg, params_ab)
    if shape.mode == "prefill":
        # prefill returns LAST-position logits (B, 1, V)
        return make_prefill(cfg, rules), (params_ab, batch_ab), \
            (params_sh, batch_sh), logits_sh, rules
    cache_ab = abstract_cache(cfg, shape.global_batch, shape.seq_len)
    cache_sh = named_shardings(rules, cache_logical(cfg), cache_ab)
    serve_step = make_serve_step(cfg, rules)

    def fn(params, cache, batch):
        return serve_step(params, cache, {**batch, "pos": shape.seq_len - 1})
    return fn, (params_ab, cache_ab, batch_ab), \
        (params_sh, cache_sh, batch_sh), (logits_sh, cache_sh), rules


#: the depths, in blocks, of the two meta passes of the depth fit
FIT_DEPTHS = (2, 3)


def fit_depths(cfg: ModelConfig, loop_correct: bool = True
               ) -> tuple[int, ...]:
    """The depths, in blocks, of the meta passes that reckon ``cfg``'s
    cell: ``FIT_DEPTHS``, or ``cfg``'s own depth where it is no deeper or
    ``loop_correct`` is off."""
    if loop_correct and cfg.n_blocks > FIT_DEPTHS[-1]:
        return FIT_DEPTHS
    return (cfg.n_blocks,)


def depth_pass(cfg: ModelConfig, shape: ShapeSpec, mesh, k: int,
               rules: Optional[LogicalRules] = None, donate: bool = True
               ) -> tuple[float, float, float, float, float]:
    """One step of ``cfg``'s cell, cut to ``k`` blocks, on ``meta``:
    (FLOPs, argument bytes, output bytes, temp bytes, seconds)."""
    t0 = time.perf_counter()
    if k != cfg.n_blocks:
        cfg = _depth_variant(cfg, k)
    fn, args, *_ = build_cell(cfg, shape, mesh, rules)
    arg_tensors = _tensors(args)
    arg_storages = {id(t.untyped_storage()) for t in arg_tensors}
    with FlopCounterMode(display=False) as flops, \
            LiveBytes(arg_tensors) as mem:
        out = fn(*args)
    outs = _tensors(out)
    aliased = [id(t.untyped_storage()) in arg_storages for t in outs]
    output = _storage_bytes([t for t, a in zip(outs, aliased) if not a])
    temp = mem.peak - output
    if not donate:
        output += _storage_bytes([t for t, a in zip(outs, aliased) if a])
    return (float(flops.get_total_flops()), float(_storage_bytes(arg_tensors)),
            float(output), float(temp), time.perf_counter() - t0)


def run_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, mesh_name: str,
             rules: Optional[LogicalRules] = None,
             donate: bool = True,
             verbose: bool = True,
             loop_correct: bool = True,
             *, memory_bytes: Optional[float] = None,
             passes: Optional[dict] = None) -> CellResult:
    """Reckon one cell (see the module docstring).  ``memory_bytes``, the
    card's memory, decides ``fits``; ``loop_correct=False`` runs one meta
    pass at full depth instead of the depth fit (exact, and slow at the
    full depth of a large config).  ``passes`` maps each of
    ``fit_depths(cfg, loop_correct)`` to its ``depth_pass``, or to the
    exception it raised, where they were run elsewhere; by default they
    run here."""
    res = CellResult(arch=cfg.name, shape=shape.name, mesh=mesh_name,
                     n_devices=mesh.devices.size,
                     model_params=float(cfg.param_count()),
                     active_params=float(cfg.param_count(active_only=True)),
                     memory_bytes=float(memory_bytes or 0.0))
    try:
        depths = fit_depths(cfg, loop_correct)
        if passes is None:
            passes = {k: depth_pass(cfg, shape, mesh, k, rules, donate)
                      for k in depths}
        for k in depths:
            if isinstance(passes[k], BaseException):
                raise passes[k]
        res.seconds = sum(passes[k][4] for k in depths)
        if len(depths) == 2:
            (d1, p1), (d2, p2) = ((k, passes[k]) for k in depths)
            nb = cfg.n_blocks
            (res.per_device_flops, _, res.output_bytes,
             res.temp_bytes) = (a + (b - a) * (nb - d1) / (d2 - d1)
                                for a, b in zip(p1[:4], p2[:4]))
            fn, args, *_ = build_cell(cfg, shape, mesh, rules)
            res.argument_bytes = float(_storage_bytes(_tensors(args)))
        else:
            (res.per_device_flops, res.argument_bytes, res.output_bytes,
             res.temp_bytes, _) = passes[depths[0]]
        res.peak_bytes_per_device = (res.argument_bytes + res.output_bytes
                                     + res.temp_bytes)
        if memory_bytes:
            res.fits = res.peak_bytes_per_device <= memory_bytes
        res.ok = True
    except Exception as e:  # noqa: BLE001 -- cell failures are data
        res.ok = False
        res.error = f"{type(e).__name__}: {e}"
    if verbose:
        print(cell_line(res), flush=True)
    return res


def cell_line(res: CellResult) -> str:
    """The dry run's line for one cell."""
    tag = f"{res.arch} x {res.shape} x {res.mesh}"
    if not res.ok:
        return f"  FAIL {tag}: {res.error[:300]}"
    fits = ("" if res.fits is None else
            f", fits {'yes' if res.fits else 'no'} "
            f"({res.memory_bytes / 1e9:.2f} GB)")
    return (f"  OK {tag}: {res.per_device_flops / 1e12:.2f} TFLOP a step, "
            f"argument {res.argument_bytes / 1e9:.2f} GB, temp "
            f"{res.temp_bytes / 1e9:.2f} GB, peak "
            f"{res.peak_bytes_per_device / 1e9:.2f} GB{fits} "
            f"(meta passes {res.seconds:.1f}s)")
