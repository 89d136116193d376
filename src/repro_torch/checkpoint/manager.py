"""Fault-tolerant checkpointing: atomic, async, device-independent
(counterpart of repro.checkpoint.manager, with its on-disk layout, so a
checkpoint restores across the two frameworks).

Layout (one directory per step)::

    <dir>/step_000000120/
        meta.json        # step, extra metadata, the sorted keys
        arrays.npz       # flattened tree, key = path string
    <dir>/LATEST         # atomically replaced pointer file

A key is the path of a leaf: its dict keys and tuple indices joined by
``/`` (``params/blocks/0/attn/q/w``), as the reference's ``_flatten``
builds it. bf16 leaves are stored as f32 (a lossless widening: numpy's
``.npy`` format has no bf16), and ``restore`` casts each leaf to the dtype
of the tree it is given.

  * **Atomicity**: writes go to ``<dir>/tmp_<step>`` and are
    ``os.replace``d into place; a crash mid-save never corrupts the latest
    checkpoint.
  * **Async**: ``save(..., blocking=False)`` copies the tree to host memory
    (arrays that own their memory: later in-place writes to the tensors do
    not reach the snapshot), then writes in a background thread; an error
    there is raised on the next ``wait`` or ``save``.
  * **Across meshes**: a DTensor leaf is gathered whole (``full_tensor``,
    a collective every rank of its mesh joins) and stored unsharded; in a
    process group of more than one rank only rank 0 writes, and the others
    wait for it at a barrier before ``save`` returns (``blocking``) or
    before the next ``wait``. ``restore(..., shardings=)`` distributes each
    leaf onto the mesh and placements it is given, which may be another
    mesh than the one it was saved from.
  * **Retention**: the ``keep`` most recent checkpoints are kept, older ones
    removed after a successful save.
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.models.convert import tensor_to_numpy

PyTree = Any


def _paths(tree: PyTree, prefix: tuple = ()):
    """(path, leaf) of every leaf; a path is a tuple of dict keys and tuple
    indices."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _key(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _host_copy(leaf: torch.Tensor) -> np.ndarray:
    """A leaf as a numpy array that owns its memory; a DTensor gathered
    whole first. ``tensor_to_numpy`` shares memory with a CPU tensor it
    does not widen, so that one is copied; a card tensor's ``.cpu()`` and
    bf16's widening copy already."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    arr = tensor_to_numpy(leaf)
    if leaf.device.type == "cpu" and leaf.dtype != torch.bfloat16:
        arr = arr.copy()
    return arr


def _flatten(tree: PyTree) -> dict[str, np.ndarray]:
    """Host copies of the leaves by key, bf16 widened to f32."""
    return {_key(path): _host_copy(leaf) for path, leaf in _paths(tree)}


def _is_dtensor(t) -> bool:
    # no DTensor exists before its module is imported (an import of 1 s)
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _rebuild(tree: PyTree, leaves: dict, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaves, prefix + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(v, leaves, prefix + (i,))
                          for i, v in enumerate(tree))
    return leaves[prefix]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._barrier = False     # the other ranks still wait for rank 0

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: PyTree, *, extra: Optional[dict] = None,
             blocking: bool = True) -> None:
        self.wait()
        flat = _flatten(tree)   # snapshot (host copy) before going async
        rank, world = _world()
        self._barrier = world > 1
        if rank != 0:           # rank 0 writes; the others meet it in wait()
            if blocking:
                self.wait()
            return
        meta = {"step": int(step), "extra": extra or {}, "keys": sorted(flat)}

        def _write():
            try:
                tmp = os.path.join(self.directory, f"tmp_{step:09d}")
                final = os.path.join(self.directory, f"step_{step:09d}")
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, "arrays.npz"), **flat)
                with open(os.path.join(tmp, "meta.json"), "w") as f:
                    json.dump(meta, f)
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.replace(tmp, final)
                latest_tmp = os.path.join(self.directory, ".LATEST.tmp")
                with open(latest_tmp, "w") as f:
                    f.write(f"step_{step:09d}")
                os.replace(latest_tmp, os.path.join(self.directory, "LATEST"))
                self._gc()
            except BaseException as e:   # raised on the next wait()/save()
                self._error = e

        if blocking:
            _write()
            self.wait()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        """Until the last save is on disk (on every rank of its group)."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._barrier:
            self._barrier = False
            dist.barrier()
        self._raise_if_failed()

    def _raise_if_failed(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint save failed") from err

    def _gc(self) -> None:
        steps = sorted(d for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for d in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.directory, d), ignore_errors=True)

    # -------------------------------------------------------------- restore
    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.directory, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return int(f.read().strip().split("_")[1])

    def restore(self, step: int, like: PyTree, *, device=None,
                shardings: Optional[PyTree] = None) -> tuple[PyTree, dict]:
        """Rebuild a tree shaped like ``like`` (tensors, meta tensors and
        DTensors included): each leaf cast to the dtype of ``like``'s leaf,
        on ``device`` (by default the leaf's own; a meta leaf's, the card).
        With ``shardings`` (a tree of ``distributed.sharding.NamedSharding``
        shaped like ``like``, as ``to_shardings`` gives it) each leaf is
        distributed onto its mesh and placements instead; every rank of the
        mesh calls this. Raises ``ValueError`` where a shape differs."""
        d = os.path.join(self.directory, f"step_{step:09d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        shard_of = dict(_paths(shardings)) if shardings is not None else None
        out = {}
        with np.load(os.path.join(d, "arrays.npz")) as z:
            for path, leaf in _paths(like):
                key = _key(path)
                arr = z[key]
                if tuple(arr.shape) != tuple(leaf.shape):
                    raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                                     f"model shape {tuple(leaf.shape)}")
                if shard_of is not None:
                    out[path] = shard_of[path].distribute(
                        torch.from_numpy(arr).to(dtype=leaf.dtype))
                    continue
                dev = (resolve_device(device) if device is not None or leaf.is_meta
                       else leaf.device)
                out[path] = torch.from_numpy(arr).to(dev, dtype=leaf.dtype)
        return _rebuild(like, out), meta["extra"]
