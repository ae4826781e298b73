"""Carry the reference's state into the port.

The data-diffusion runtime's state is the object catalog with its
payloads, and the experiment spec that generates the workload; the LM
substrate's is its parameter tree.

  store_from_numpy  ``(oid, size_bytes, ndarray)`` triples -- what the
                    reference's ``ObjectStore.items()`` holds -- into the
                    port's :class:`ObjectStore`
  spec_from_json    a spec file the reference's ``ExperimentSpec.save``
                    wrote, as the port's :class:`ExperimentSpec`
  params_from_jax   the reference's ``init_params`` tree, its leaves as
                    numpy arrays, as the port's parameter tree on a device
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Union

import numpy as np
import torch

from repro_torch.core.objects import DataObject
from repro_torch.core.runtime import ObjectStore
from repro_torch.device import resolve_device
from repro_torch.experiments.spec import ExperimentSpec
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import (flatten, param_defs, torch_dtype,
                                            unflatten)

def store_from_numpy(items: Iterable[tuple[str, int, np.ndarray]],
                     device: str | torch.device = "cpu") -> ObjectStore:
    """A port ObjectStore holding each array as a tensor on ``device``.

    The store stands in for the persistent store, so its natural place is
    host memory (the default); executors copy what they read to their own
    device.  Byte accounting uses ``size_bytes``, as in the reference."""
    dev = resolve_device(device)
    store = ObjectStore()
    for oid, size_bytes, arr in items:
        if not isinstance(arr, np.ndarray):
            raise TypeError(f"{oid}: expected a numpy array, "
                            f"got {type(arr).__name__}")
        store.put(DataObject(oid, int(size_bytes)),
                  torch.from_numpy(np.ascontiguousarray(arr)).to(dev))
    return store


def spec_from_json(path: Union[str, Path]) -> ExperimentSpec:
    """Load a reference spec JSON (``ExperimentSpec.save``), strictly: the
    port's spec has every field the reference's has, the fleet's
    included, so an unknown field or a bad value raises."""
    return ExperimentSpec.from_dict(json.loads(Path(path).read_text()))


def _tensor(arr: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor, bit for bit; bfloat16 arrays (numpy's
    ``ml_dtypes`` extension type, which ``torch.from_numpy`` refuses) go
    through their 16-bit pattern."""
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:   # torch shares the buffer: own a copy
        arr = arr.copy()
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def params_from_jax(cfg: ModelConfig, tree: dict,
                    device: str | torch.device = "cuda",
                    dtype: str | None = None) -> dict:
    """The reference's parameter tree for ``cfg`` (nested dicts of numpy
    arrays, e.g. ``jax.tree.map(np.asarray, init_params(cfg, key))``) as
    the port's, on ``device``.  Leaf names and shapes must match
    ``param_defs(cfg)`` exactly.  Leaves the definitions keep in fp32
    (norms) stay fp32; the others take ``dtype`` (default ``cfg.dtype``)."""
    dev = resolve_device(device)
    want = dict(flatten(param_defs(cfg)))
    got = dict(flatten(tree))
    if set(got) != set(want):
        raise ValueError(f"{cfg.name}: leaves differ from param_defs: "
                         f"missing {sorted(set(want) - set(got))}, "
                         f"unexpected {sorted(set(got) - set(want))}")
    param_dtype = torch_dtype(dtype or cfg.dtype)
    out = []
    for path, d in want.items():
        arr = got[path]
        if not isinstance(arr, np.ndarray):
            raise TypeError(f"{path}: expected a numpy array, "
                            f"got {type(arr).__name__}")
        if tuple(arr.shape) != d.shape:
            raise ValueError(f"{path}: shape {tuple(arr.shape)}, "
                             f"expected {d.shape}")
        dt = torch.float32 if d.dtype == "float32" else param_dtype
        out.append((path, _tensor(arr).to(device=dev, dtype=dt)))
    return unflatten(out)
