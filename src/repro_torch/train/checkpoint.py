"""Checkpointing with atomic commit + restart-from-latest.

The port of the reference's ``repro.train.checkpoint``, file for file:

  * save is atomic: written to ``step_N.tmp/`` then renamed -- a crash
    mid-save never corrupts the latest checkpoint;
  * every leaf is saved as its own .npy plus a ``manifest.json`` (leaf
    names, dtypes, shapes, step);
  * ``restore_latest`` picks the newest *committed* step;
  * retention: keep the most recent ``keep`` checkpoints;
  * async mode: a synchronous host snapshot, then the write on a
    background thread (the train loop never blocks on IO).

Leaves go in the order ``jax.tree.flatten`` visits the same tree, under the
names the reference writes: a ``TrainState`` field is ``.step``,
``.params``, ``.m``, ``.v``; a dict key is the key (sorted); a tuple item
is its index (``/0``, ``/1`` of a factored v); parts are joined by ``/``.
bfloat16 leaves are written as their uint16 bits and tagged
``"bfloat16"``.  Restore is by position.  So each package reads the
other's checkpoints.
"""
from __future__ import annotations

import json
import pathlib
import re
import shutil
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch

PyTree = Any
_STEP_RE = re.compile(r"^step_(\d+)$")


def _named_leaves(tree: PyTree, path: tuple = ()) -> Iterator[tuple[str, Any]]:
    """(name, leaf) in ``jax.tree.flatten``'s order, named as the
    reference names them."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # NamedTuple
        for f in tree._fields:
            yield from _named_leaves(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, x in enumerate(tree):
            yield from _named_leaves(x, path + (str(i),))
    else:
        yield "/".join(path) or "leaf", tree


def _rebuild(like: PyTree, leaves: Iterator) -> PyTree:
    """``like``'s structure with its leaves taken in order from
    ``leaves``."""
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, dict):
        out = {k: _rebuild(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(x, leaves) for x in like)
    return next(leaves)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host numpy array to write, and its logical dtype name
    (bfloat16 goes as its uint16 bits: numpy has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        # a copy even of a host tensor: the caller updates it in place
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_file(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if "bfloat16" in dtype_name:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str | pathlib.Path, keep: int = 3,
                 async_save: bool = False) -> None:
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def save(self, step: int, tree: PyTree) -> pathlib.Path:
        # the host snapshot is synchronous (the caller may update the
        # tree's tensors in place as soon as this returns)
        host = [(name, *_to_host(leaf)) for name, leaf in _named_leaves(tree)]
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True)
            self._thread.start()
            return self.dir / f"step_{step}"
        return self._write(step, host)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: list) -> pathlib.Path:
        final = self.dir / f"step_{step}"
        tmp = self.dir / f"step_{step}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        manifest = {"step": step, "leaves": []}
        for i, (name, arr, dtype_name) in enumerate(host):
            fname = f"leaf_{i}.npy"
            np.save(tmp / fname, arr)
            manifest["leaves"].append(
                {"name": name, "file": fname, "dtype": dtype_name,
                 "shape": list(arr.shape)})
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)  # atomic commit
        with self._lock:
            self._gc()
        return final

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: max(len(steps) - self.keep, 0)]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ------------------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for child in self.dir.iterdir():
            m = _STEP_RE.match(child.name)
            if m and (child / "manifest.json").exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def restore(self, step: int, like: PyTree) -> PyTree:
        """The checkpoint of ``step`` in ``like``'s structure, each leaf
        with the dtype and device of ``like``'s leaf at its position."""
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        flat = [leaf for _, leaf in _named_leaves(like)]
        entries = manifest["leaves"]
        assert len(flat) == len(entries), \
            f"checkpoint has {len(entries)} leaves, model expects {len(flat)}"
        out = []
        for entry, want in zip(entries, flat):
            t = _from_file(np.load(path / entry["file"]), entry["dtype"])
            if isinstance(want, torch.Tensor):
                t = t.to(device=want.device, dtype=want.dtype)
            out.append(t)
        return _rebuild(like, iter(out))

    def restore_latest(self, like: PyTree) -> tuple[Optional[int], PyTree]:
        steps = self.steps()
        if not steps:
            return None, like
        s = steps[-1]
        return s, self.restore(s, like)
