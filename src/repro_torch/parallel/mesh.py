"""Meshes described, not built.

The port of the reference's ``repro.parallel.mesh``.  The port runs on one
card, so nothing is sharded and no mesh of devices exists.  A
:class:`MeshSpec` describes one as the sharding rules read it (its
``axis_names`` and ``devices.shape``; ``devices.size`` counts the
devices), so :meth:`LogicalRules.spec_for_shape` can reckon what each
leaf's sharding would be on the reference's production meshes, 16x16 (one
pod, 256 chips) and 2x16x16 (two pods, 512 chips).  Making one allocates
nothing on any device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class DeviceGrid:
    """The shape of a mesh's device array, standing in for the array."""
    shape: tuple[int, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)


@dataclass(frozen=True)
class MeshSpec:
    """A mesh's axis names and device grid."""
    axis_names: tuple[str, ...]
    devices: DeviceGrid


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> MeshSpec:
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not name its axes {axes}")
    return MeshSpec(tuple(axes), DeviceGrid(tuple(shape)))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    """The reference's production mesh: 16x16 = 256 chips per pod; 2 pods
    = 512 chips."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_local_mesh(data: int = 1, model: int = 1) -> Optional[MeshSpec]:
    """A (data, model) mesh over the CUDA devices this process sees, or
    None when their count does not cover the request (no card: None)."""
    if data * model > torch.cuda.device_count():
        return None
    return make_mesh((data, model), ("data", "model"))
