"""Async, crash-safe checkpointing.

Twin of ``repro/checkpoint/checkpointer.py``, with the same layout:
``<dir>/step_<N>/`` with one ``.npy`` per leaf and a ``manifest.json``
holding ``step``, ``leaves`` (each leaf's path), ``dtypes``, ``time`` and
``extra`` (the data-pipeline cursor). bf16 leaves are stored as a uint16
view (numpy has no bf16) and restored by the dtype in the manifest. Writes
go to a temp directory, then ``os.rename``: a crash mid-write never
corrupts the latest checkpoint; the oldest beyond ``keep`` are removed.

A state is a tree of dicts, tuples (an ``OptState`` too) and tensors: the
model's parameters plus the optimizer state. ``save`` copies every leaf to
the host in the caller's thread, so the caller may update its tensors in
place right after, even with ``blocking=False`` (only the disk writes run
in the background). ``restore`` loads into the structure of ``like``, each
leaf on the device and in the dtype of ``like``'s leaf; with ``shardings``
(a tree of ``(mesh, placements)`` pairs, or ``None`` leaves, parallel to
``like``) each leaf is re-placed with ``distribute_tensor``, so a checkpoint
saved on one mesh restores onto another (elastic). A DTensor leaf is saved
whole (``full_tensor``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ..distributed.sharding import distribute

PyTree = Any

_NUMPY_DTYPE = {torch.bfloat16: "bfloat16"}     # torch dtypes numpy cannot hold


def _flatten_with_paths(tree: PyTree) -> Tuple[List[Tuple[str, Any]], Any]:
    """(path, tensor) of every leaf; a None (an ``OptState`` without its
    error-feedback residual) is an empty subtree, as in JAX, and is skipped."""
    flat, spec = pytree.tree_flatten_with_path(tree)
    out = []
    for path, leaf in flat:
        if leaf is None:
            continue
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", getattr(p, "name", p))))
                       for p in path)
        out.append((key or "leaf", leaf))
    return out, spec


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """(numpy array to save, dtype name for the manifest); a copy, never a view."""
    t = t.detach()
    if hasattr(t, "full_tensor"):
        t = t.full_tensor()
    name = _NUMPY_DTYPE.get(t.dtype)
    if name == "bfloat16":
        return t.view(torch.uint16).to("cpu", copy=True).numpy(), name
    a = t.to("cpu", copy=True).numpy()
    return a, str(a.dtype)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3) -> None:
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # ---- save ------------------------------------------------------------
    def save(self, step: int, state: PyTree, extra: Optional[Dict] = None,
             blocking: bool = True) -> None:
        """Snapshot ``state`` (device→host copies happen in the caller's
        thread; the disk writes may run in the background)."""
        leaves, _ = _flatten_with_paths(state)
        host = [(k, *_to_host(v)) for k, v in leaves]

        def write():
            tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
            tmp.mkdir(parents=True, exist_ok=True)
            names, dtypes = [], []
            for i, (k, a, dtype) in enumerate(host):
                np.save(tmp / f"{i}.npy", a)
                names.append(k)
                dtypes.append(dtype)
            manifest = {"step": step, "leaves": names, "dtypes": dtypes,
                        "time": time.time(), "extra": extra or {}}
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)                      # atomic publish
            self._gc()

        if blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ---- restore ---------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def restore(self, step: int, like: PyTree,
                shardings: Optional[PyTree] = None) -> Tuple[PyTree, Dict]:
        """Load a checkpoint into the structure of ``like``: each leaf on the
        device and in the dtype of ``like``'s leaf; with ``shardings`` (a tree
        parallel to ``like`` of ``(mesh, placements)`` pairs, ``None`` where a
        leaf stays a plain tensor) each leaf distributed onto its mesh, as
        the reference's ``device_put`` to its shardings (the mesh may differ
        from save time)."""
        path = self.dir / f"step_{step}"
        manifest = json.loads((path / "manifest.json").read_text())
        flat_like, spec = pytree.tree_flatten(like)
        flat_shard = ([None] * len(flat_like) if shardings is None else
                      pytree.tree_flatten(shardings, is_leaf=lambda x: x is None or (
                          isinstance(x, tuple) and len(x) == 2 and hasattr(x[0], "mesh_dim_names")))[0])
        if len(flat_shard) != len(flat_like):
            raise ValueError(f"shardings has {len(flat_shard)} leaves, like {len(flat_like)}")
        n = len(manifest["leaves"])
        want = sum(leaf is not None for leaf in flat_like)
        if n != want:
            raise ValueError(f"checkpoint has {n} leaves, expected {want}")
        loaded, i = [], 0
        for ref, where in zip(flat_like, flat_shard):
            if ref is None:
                loaded.append(None)
                continue
            a = np.load(path / f"{i}.npy")
            t = torch.from_numpy(a)
            if manifest["dtypes"][i] == "bfloat16":
                t = t.view(torch.bfloat16)
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {manifest['leaves'][i]}: shape {tuple(t.shape)} "
                                 f"vs {tuple(ref.shape)}")
            t = t.to(device=ref.device, dtype=ref.dtype)
            if where is not None:
                t = distribute(t, *where)
            loaded.append(t)
            i += 1
        return pytree.tree_unflatten(loaded, spec), manifest["extra"]

    def restore_latest(self, like: PyTree, shardings: Optional[PyTree] = None
                       ) -> Optional[Tuple[int, PyTree, Dict]]:
        steps = self.steps()
        if not steps:
            return None
        step = steps[-1]
        state, extra = self.restore(step, like, shardings)
        return step, state, extra
