"""The plain reference against the port's CPU path, and what the benchmark
imports."""
from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ddbench import registry
from repro_torch.apps import astro
from repro_torch.kernels.stacking.ref import stack_rois_ref

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REF = registry.reference("sdss_stacking")
CFG = {"tiles_per_file": 150, "tile_h": 100, "tile_w": 100,
       "store_tiles": 600, "host_s_per_request": 0.0}


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in (HERE / "references").glob("*.py"):
        assert _top_level_imports(path) <= {"__future__", "time", "numpy",
                                           "torch"}


def test_the_reporting_process_loads_no_jax():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src'];"
            "import ddbench.run as r; r._setup_paths();"
            "import ddbench.harness, ddbench.sweep;"
            "from ddbench import registry;"
            "b = registry.benchmark();"
            "ms = b['end_to_end'] + b['per_layer'];"
            "[registry.reader(m['name']) for m in ms];"
            "print(r.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code, str(HERE.parent)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_coadd_agrees_with_the_ports_plain_version():
    g = torch.Generator().manual_seed(5)
    tiles = torch.randn((16, 100, 100), generator=g) * 100 + 500
    ids = [3, 9]
    sky, cal, dy, dx = astro.coadd_params(tiles, ids)
    want = stack_rois_ref(tiles, sky, cal, dy, dx) / tiles.shape[0]
    rdy, rdx = REF.shifts(ids, 16)
    assert np.array_equal(rdy, dy.numpy()) and np.array_equal(rdx, dx.numpy())
    got = REF.coadd(tiles[None].double(),
                    torch.from_numpy(rdy)[None].double(),
                    torch.from_numpy(rdx)[None].double())[0]
    err = float((got - want.double()).abs().max() / got.abs().max())
    assert err < 1e-6


def test_a_file_made_again_from_the_seed_equals_the_catalogs():
    seed = 2**40 + 3
    cat = REF.make_catalog(CFG, 300, seed, torch.device("cpu"))
    assert len(cat) == 300 and cat[0].shape == (150, 100, 100)
    assert not cat[0].is_pinned()
    # every file a view of one host block, at an offset of its own
    base = cat[0].untyped_storage().data_ptr()
    assert all(f.untyped_storage().data_ptr() == base for f in cat)
    at = REF.offsets(CFG, seed, 300)
    assert len(set(at.tolist())) == 300
    assert np.array_equal(REF.offsets(CFG, seed, 7), at[:7])
    store = REF.make_store(CFG, seed, torch.device("cpu"))
    for f in (0, 17, 255, 256, 299):
        assert torch.equal(store[at[f]:at[f] + 150], cat[f])
    other = REF.make_catalog(CFG, 2, seed + 1, torch.device("cpu"))
    assert not torch.equal(other[0], cat[0])
    assert 480 < float(store.mean()) < 520 and 90 < float(store.std()) < 110
    with pytest.raises(ValueError):
        REF.offsets(CFG, seed, 600 - 150 + 2)


def test_worst_error_judges_the_ports_cpu_outputs():
    seed = 77
    cat = REF.make_catalog(CFG, 4, seed, torch.device("cpu"))
    requests = []
    for f in range(4):
        out = astro.stack_object({f"img{f}": cat[f]})
        requests.append(((f"img{f}",), out))
    assert REF.worst_error(CFG, seed, requests, torch.device("cpu")) < 1e-6
    bad = requests[:3] + [(("img3",), requests[3][1] + 0.5)]
    assert REF.worst_error(CFG, seed, bad, torch.device("cpu")) > 1e-4
    wrong_shape = requests[:3] + [(("img3",), requests[3][1][:50])]
    assert REF.worst_error(CFG, seed, wrong_shape,
                           torch.device("cpu")) == float("inf")


def test_a_neighbouring_file_in_place_of_the_named_one_is_not_correct():
    # files overlap in the store: the one at the next offset shares all
    # but one tile with the named one, and still reads far over the limit
    seed = 79
    cat = REF.make_catalog(CFG, 300, seed, torch.device("cpu"))
    at = REF.offsets(CFG, seed, 300).tolist()
    f = next(i for i in range(300) if at[i] + 1 in at)
    g = at.index(at[f] + 1)
    good = astro.stack_object({f"img{f}": cat[f]})
    stale = astro.stack_object({f"img{f}": cat[g]})
    dev = torch.device("cpu")
    assert REF.worst_error(CFG, seed, [((f"img{f}",), good)], dev) < 1e-6
    assert REF.worst_error(CFG, seed, [((f"img{f}",), stale)], dev) > 1e-3


def test_the_bf16_control_misses_what_fp32_meets():
    seed = 78
    cat = REF.make_catalog(CFG, 4, seed, torch.device("cpu"))
    control = REF.control_task(CFG)
    requests = [((f"img{f}",), control({f"img{f}": cat[f]}))
                for f in range(4)]
    err = REF.worst_error(CFG, seed, requests, torch.device("cpu"))
    assert err > 1e-3
