"""The port stands alone: no module of ``repro_torch`` (nor chip_smoke.py)
imports JAX or anything of the JAX package ``repro``."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]

FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|$)"
    r"|from\s+repro(\.|\s)|import\s+repro\s*,)", re.M)


def _modules():
    return sorted(
        "repro_torch" + "".join(f".{p}" for p in
                                path.relative_to(PKG).with_suffix("").parts)
        .removesuffix(".__init__")
        for path in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_or_repro():
    code = (
        "import importlib, json, sys\n"
        f"mods = {_modules()!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["bad"] == []
    assert res["n"] == len(_modules()) >= 20


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_neither_jax_nor_repro(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert hits == []


def test_scan_catches_forbidden_imports():
    for line in ("import jax", "from jax import numpy", "import jax.numpy",
                 "from repro.core import Dispatcher", "import repro.core",
                 "import repro", "  from repro import core"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import x",
                 "import jaxlib_free_module", "from repro_torch import convert"):
        assert not FORBIDDEN.search(line), line


def test_dry_run_modules_load_no_jax():
    """The dry run's tools (the FLOP counter, the dispatch-mode storage
    tracker) pull nothing of JAX in: a fresh interpreter that imports the
    dry run and the cell runner holds no ``jax`` module."""
    code = ("import json, sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.cellrun\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "                        if m == 'jax' or m.startswith('jax.')\n"
            "                        or m == 'repro' or m.startswith('repro.'))))\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
