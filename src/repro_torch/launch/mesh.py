"""The meshes the dry run reckons with (counterpart of
``repro.launch.mesh``): the reference's production meshes, described, and
the one card the port runs on.  None of them allocates anything."""
from __future__ import annotations

from repro_torch.parallel.mesh import MeshSpec, make_mesh, make_production_mesh

__all__ = ["make_card_mesh", "make_production_mesh"]


def make_card_mesh() -> MeshSpec:
    """One card as a 1x1 ("data", "model") mesh: the rules of a cell
    reckon on it as on the production meshes, and every spec is the
    whole leaf."""
    return make_mesh((1, 1), ("data", "model"))
