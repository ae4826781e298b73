"""Carry the reference's state into the port.

This system has no weights: its state is the object catalog with its
payloads, and the experiment spec that generates the workload.

  store_from_numpy  ``(oid, size_bytes, ndarray)`` triples -- what the
                    reference's ``ObjectStore.items()`` holds -- into the
                    port's :class:`ObjectStore`
  spec_from_json    a spec file the reference's ``ExperimentSpec.save``
                    wrote, as the port's :class:`ExperimentSpec`
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

#: reference spec fields this package does not keep, with the reference's
#: defaults: a saved spec may carry them only at these values.
_DROPPED_SPEC_FIELDS = {
    "provisioner": None,
    "write_outputs_to": "local",
    "index_update_interval_s": 0.0,
    "release_policy": "discard",
    "flow_solver": "incremental",
    "speculation_factor": 0.0,
    "hosts": 0,
    "threads_per_host": 1,
    "wire_batch": 64,
    "local_dispatch": False,
    "observe": {"events": False, "sink_path": None, "ring_capacity": 65536,
                "metrics": False, "metrics_interval_s": 0.25,
                "metrics_sink_path": None, "metrics_port": -1},
}
_DROPPED_WORKLOAD_FIELDS = {"trace_path": None, "sessions": None}


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


def _strip(d: dict, dropped: dict, path: str) -> dict:
    out = dict(d)
    for name, default in dropped.items():
        if name in out:
            if out[name] != default:
                raise ValueError(
                    f"{path}.{name}={out[name]!r}: this package does not run "
                    f"that reference feature (only its default {default!r} "
                    f"is accepted)")
            del out[name]
    return out


def spec_from_json(path: Union[str, Path]) -> ExperimentSpec:
    """Load a reference spec JSON (``ExperimentSpec.save``).  Fields this
    package keeps load strictly; the reference's other fields must hold
    their defaults, otherwise this raises rather than dropping intent."""
    d = _strip(json.loads(Path(path).read_text()), _DROPPED_SPEC_FIELDS,
               "spec")
    if isinstance(d.get("workload"), dict):
        d["workload"] = _strip(d["workload"], _DROPPED_WORKLOAD_FIELDS,
                               "spec.workload")
    return ExperimentSpec.from_dict(d)
