"""Checkpoints with atomic commits and an asynchronous saver: the
counterpart of ``repro.train.checkpoint``, in the same on-disk format.

Layout:  <dir>/step_<N>/manifest.json + one .npy per leaf, named by the
leaf's key path in the JAX package's state tree (``params/blocks/attn/wq``
-> ``params__blocks__attn__wq.npy``).  Commit protocol: write into
``step_<N>.tmp``, then ``os.rename``, so a checkpoint directory is either
complete or absent.  bfloat16 leaves are written as their uint16 bits with
``"bfloat16"`` in the manifest, as the JAX package writes them, and read
back without ``ml_dtypes``; so a checkpoint of either framework restores
in the other.  The data-pipeline step travels in the manifest's metadata,
so restarts are bit-deterministic.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.train.tree import items, tree_map, unflatten


def _to_storable(leaf):
    """(array to np.save, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":          # an ml_dtypes array from JAX
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _from_storable(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(ckpt_dir: str, step: int, tree, metadata: Optional[dict] = None,
         keep_last: int = 3):
    """Synchronous atomic save of a nest of dicts of tensors (or arrays)."""
    tmp = os.path.join(ckpt_dir, f"step_{step}.tmp")
    final = os.path.join(ckpt_dir, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for key, leaf in items(tree):
        arr, dtype_name = _to_storable(leaf)
        fname = key.replace("/", "__") + ".npy"
        np.save(os.path.join(tmp, fname), arr)
        manifest["leaves"][key] = {"file": fname, "shape": list(arr.shape), "dtype": dtype_name}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep_last)
    return final


def _gc(ckpt_dir: str, keep_last: int):
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def all_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name.split("_", 1)[1]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int, target_tree):
    """Restore into the structure of ``target_tree`` (a nest of dicts of
    tensors): each leaf comes back on its target's device, cast to its
    target's dtype.  Returns (tree, manifest)."""
    path = os.path.join(ckpt_dir, f"step_{step}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    loaded = {}
    for key, tgt in items(target_tree):
        info = manifest["leaves"].get(key)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        t = _from_storable(np.load(os.path.join(path, info["file"])), info["dtype"])
        if tuple(t.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {tuple(t.shape)} "
                             f"vs target {tuple(tgt.shape)}")
        loaded[key] = t.to(device=tgt.device, dtype=tgt.dtype)
    return unflatten(loaded), manifest


class AsyncCheckpointer:
    """Background-thread checkpointer: ``save`` takes a host snapshot and
    returns; a worker thread writes it.  At most one save is pending, so
    the training loop blocks only if saves cannot keep up.  ``wait()``
    drains; an error of the worker is raised by the next ``save`` or
    ``wait``."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep_last = keep_last
        self._q: "queue.Queue" = queue.Queue(maxsize=1)
        self._err: Optional[Exception] = None
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, metadata = item
            try:
                save(self.ckpt_dir, step, host_tree, metadata, keep_last=self.keep_last)
            except Exception as e:   # surfaced on the next save/wait
                self._err = e
            finally:
                self._q.task_done()

    def save(self, step: int, tree, metadata: Optional[dict] = None):
        if self._err:
            raise self._err
        # a copy: the training loop goes on updating the tree in place
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        self._q.put((step, host_tree, metadata))

    def wait(self):
        self._q.join()
        if self._err:
            raise self._err

    def close(self):
        self.wait()
        self._q.put(None)
        self._thread.join()
