"""Fault-tolerant checkpointing: npz files, async writer, atomic commit,
automatic latest-valid resume (counterpart of ``repro/ckpt/checkpoint.py``).

Layout:  ``<dir>/step_<k>/arrays.npz`` + ``MANIFEST.json`` (the commit
marker, written last: a crash mid-write leaves no manifest and the step is
ignored on resume).

A tree is any nesting of dicts (keys in sorted order), lists and tuples
whose leaves are tensors, numpy arrays or scalars; ``None`` is an empty
subtree.  Leaves are named by their "/"-joined path, so a file written by
either package reads in the other.  Tensors cross to numpy at the file
boundary (bf16 as its lossless f32 upcast; the dtype comes back from the
target structure) and return onto the caller's device.

The async mode snapshots the leaves to host memory synchronously (the
device-to-host copy) and writes on a background thread, overlapping the
I/O with the caller's next steps (DESIGN.md section 8).

Under a mesh of ranks a checkpoint holds the global tree, so one written
on one mesh resumes on another mesh or in one process: the save puts
each leaf back together (``gather``, a leaf at a time, every rank taking
part) and only the writer (rank 0) snapshots and writes it; a restore
reads the global arrays and cuts the rank's shard (``cut``).
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

Tree = Any

__all__ = [
    "save_checkpoint",
    "latest_step",
    "load_checkpoint",
    "load_named_tree",
    "restore_or_none",
    "CheckpointManager",
]


def _items(tree: Tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(path, leaf) pairs in flattening order (dict keys sorted)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [it for k in sorted(tree)
                for it in _items(tree[k], f"{prefix}{k}/")]
    if isinstance(tree, (list, tuple)):
        return [it for i, v in enumerate(tree)
                for it in _items(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def _rebuild(tree: Tree, fn: Callable[[str, Any], Any],
             prefix: str = "") -> Tree:
    """``tree``'s structure with every leaf replaced by fn(path, leaf)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _rebuild(v, fn, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, fn, f"{prefix}{i}/") for i, v in enumerate(tree)]
        return type(tree)(out) if not hasattr(tree, "_fields") \
            else type(tree)(*out)
    return fn(prefix[:-1], tree)


def _to_numpy(leaf) -> np.ndarray:
    """One leaf as a host array npz can hold (bf16 -> lossless f32)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str | Path, step: int, tree: Tree) -> Path:
    """Synchronous save with atomic commit: the arrays, then the
    manifest, then a rename of the whole step directory."""
    directory = Path(directory)
    tmp = directory / f".tmp_step_{step}"
    final = directory / f"step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    items = _items(tree)
    arrays = {n: _to_numpy(leaf) for n, leaf in items}
    np.savez(tmp / "arrays.npz", **arrays)
    (tmp / "MANIFEST.json").write_text(json.dumps({
        "step": step, "n_arrays": len(arrays), "time": time.time(),
        "names": [n for n, _ in items]}))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    """Largest step with a complete (manifest-bearing) checkpoint."""
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for d in directory.iterdir():
        if d.name.startswith("step_") and (d / "MANIFEST.json").exists():
            try:
                steps.append(int(d.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _resolve_step(directory: Path, step: Optional[int]) -> int:
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no valid checkpoint under {directory}")
    return step


def _restore_leaf(arr, like, device):
    """A stored array in the form of ``like``: a tensor of like's dtype
    on ``device`` (default like's device), else a numpy array of like's
    dtype."""
    if isinstance(like, torch.Tensor):
        dev = like.device if device is None else torch.device(device)
        return torch.from_numpy(np.array(arr)).to(device=dev,
                                                  dtype=like.dtype)
    dtype = getattr(like, "dtype", None)
    return arr.astype(dtype) if dtype is not None and arr.dtype != dtype \
        else arr


def load_checkpoint(directory: str | Path, tree_like: Tree,
                    step: Optional[int] = None, device=None,
                    cut: Optional[Callable[[str, Any], Any]] = None
                    ) -> tuple[Tree, int]:
    """Restore into the structure of ``tree_like`` (the latest complete
    step unless ``step`` is given).  Tensor leaves come back as tensors
    of the template's dtype on its device, or on ``device`` when given;
    other leaves as numpy arrays of the template's dtype.  ``cut(name,
    array)``, where given, takes each stored (global) array to the part
    this process holds first."""
    directory = Path(directory)
    step = _resolve_step(directory, step)
    data = np.load(directory / f"step_{step}" / "arrays.npz")

    def leaf(name, like):
        arr = data[name]
        return _restore_leaf(arr if cut is None else cut(name, arr), like,
                             device)
    return _rebuild(tree_like, leaf), step


def load_named_tree(directory: str | Path, step: Optional[int] = None,
                    device=None) -> tuple[Dict, int]:
    """A checkpoint as a nested dict keyed by the "/"-joined leaf names,
    without a template: the mid-sweep partial store (DESIGN.md section
    13) needs it, since which pairs have durable partials varies between
    checkpoints.  Leaves are host numpy arrays, or tensors on
    ``device`` when it is given."""
    directory = Path(directory)
    step = _resolve_step(directory, step)
    data = np.load(directory / f"step_{step}" / "arrays.npz")
    tree: Dict = {}
    for name in data.files:
        node = tree
        parts = name.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        arr = data[name]
        node[parts[-1]] = (arr if device is None
                           else torch.from_numpy(np.array(arr)).to(device))
    return tree, step


def restore_or_none(directory: str | Path,
                    device=None) -> Optional[tuple[Dict, int]]:
    """``load_named_tree`` of the latest complete step, or None when the
    directory holds no valid checkpoint yet: a fault-tolerant sweep
    probes for durable partials without special-casing the cold
    start (DESIGN.md section 13)."""
    if latest_step(directory) is None:
        return None
    return load_named_tree(directory, device=device)


class CheckpointManager:
    """Async checkpointing with bounded retention and resume."""

    def __init__(self, directory: str | Path, keep: int = 3):
        self.directory = Path(directory)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def wait(self):
        """Block until the in-flight async save finishes (re-raising any
        error it hit)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save_async(self, step: int, tree: Tree, *,
                   gather: Optional[Callable[[str, Any], Any]] = None,
                   write: bool = True):
        """Snapshot to host now; write on a background thread.  Under a
        mesh every rank calls it with ``gather(name, shard)``, which puts
        a leaf back together, and only the writer (``write``) keeps the
        snapshot and writes it."""
        self.wait()

        def snap(name, leaf):
            if gather is not None:
                leaf = gather(name, leaf)
            return _to_numpy(leaf).copy() if write else None
        host_tree = _rebuild(tree, snap)
        if not write:
            return

        def work():
            try:
                save_checkpoint(self.directory, step, host_tree)
                self._gc()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def restore_latest(self, tree_like: Tree, device=None, cut=None):
        """Load the newest complete checkpoint into tree_like's shape
        (``cut`` as in :func:`load_checkpoint`)."""
        return load_checkpoint(self.directory, tree_like, device=device,
                               cut=cut)

    def _gc(self):
        steps = sorted(
            int(d.name.split("_")[1]) for d in self.directory.iterdir()
            if d.name.startswith("step_") and (d / "MANIFEST.json").exists())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.directory / f"step_{s}", ignore_errors=True)
