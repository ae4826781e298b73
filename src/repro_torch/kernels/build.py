"""Build the port's CUDA sources with ``nvcc`` at first use, and load them.

Each kernel is one ``csrc/*.cu`` file with a plain C entry point, compiled
for Hopper (``sm_90a``) into a shared library under ``build/kernels/`` at
the root of the checkout (git-ignored) and loaded with ``ctypes``.  A
library's file name carries a hash of its source and the compiler flags, so
an edited source is rebuilt and an unchanged one is reused.  ``build_all``
starts one ``nvcc`` per source at once, so several kernels build in the time
of the slowest.

Nothing here runs at import: this module is imported on machines without a
compiler or a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"

#: kernel name -> its CUDA source
SOURCES: dict[str, Path] = {
    "stack_rois": _KERNELS_DIR / "stacking" / "csrc" / "stack_rois.cu",
    "flash_attention": (_KERNELS_DIR / "flash_attention" / "csrc"
                        / "flash_attention.cu"),
    "mamba_scan": _KERNELS_DIR / "mamba_scan" / "csrc" / "mamba_scan.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.PyDLL] = {}
_lock = threading.Lock()


class LaunchCounter:
    """How many times a wrapper launched its kernel (thread-safe: executor
    threads launch concurrently)."""

    def __init__(self) -> None:
        self._n = 0
        self._lock = threading.Lock()

    def add(self) -> None:
        with self._lock:
            self._n += 1

    @property
    def value(self) -> int:
        return self._n

    def reset(self) -> None:
        with self._lock:
            self._n = 0


def refuse_grad(kernel: str, **tensors) -> None:
    """Raise where a forward-only kernel is handed a tensor that requires
    grad while grad mode is on: its output would carry no gradient, and
    training would go on with that gradient silently cut."""
    if not torch.is_grad_enabled():
        return
    wants = [name for name, t in tensors.items()
             if t is not None and t.requires_grad]
    if wants:
        raise RuntimeError(
            f"{kernel}: {', '.join(wants)} require grad, but the kernel has "
            f"no backward; run it under torch.no_grad() or call the op with "
            f"gradients")


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    the PATH, else the toolkit's usual place."""
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the port's CUDA kernels are built at first use")


def library_path(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, float]:
    """Compile every named kernel (default: all) whose library is missing,
    one ``nvcc`` per source, all started together.  Returns the seconds each
    build took (0.0 where the library already existed); raises with the
    compiler's output if any build fails.  ``nvcc``'s messages, including
    ``-Xptxas -v``'s register and shared-memory report, are kept beside
    each library as ``.log``."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    took = {name: 0.0 for name in names}
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.monotonic(), tmp, out)
    failed = []
    for name, (proc, t0, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.monotonic() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return took


def load(name: str) -> ctypes.PyDLL:
    """The loaded library of kernel ``name``, built first if needed.

    Loaded as a ``PyDLL``: a call keeps the interpreter lock.  Every entry
    point only enqueues a launch and returns within microseconds, and many
    executor threads launch at once; releasing the lock for such a call
    would hand it to another thread and queue this one behind it."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = _libs[name] = ctypes.PyDLL(str(library_path(name)))
        return lib
