"""Fault-tolerant checkpoints: atomic, content-hashed, keep-N
(``repro.train.checkpoint``), the JAX package's on-disk layout.

Layout per step:
    <dir>/step_<n>.tmp-<pid>/   (written)  ->  <dir>/step_<n>/  (atomic rename)
        arrays.npz              the tree's leaves ('/' in a path as '|')
        manifest.json           step, user metadata, and per leaf its
                                shape, dtype and the sha256 of its bytes

A bf16 leaf is stored as its int16 view; the manifest records "bfloat16".
``restore`` checks every leaf's hash (a mismatch raises ``IOError``) and
puts the values, in their stored dtype, into the structure of a template
(on each template leaf's device), which may hold leaves of other dtypes.
A partly written checkpoint never has the final name; stale ``*.tmp-*``
directories are removed by the next save.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.train._tree import leaves_with_paths, unflatten


def _to_numpy(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str,
                device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.array(arr))
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(device)


def _digest(arr: np.ndarray) -> str:
    """sha256 of the array's bytes in C order (``arr.tobytes()``)."""
    return hashlib.sha256(
        np.ascontiguousarray(arr).reshape(-1).view(np.uint8)).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def save(self, step: int, tree: Any,
             metadata: Optional[Dict[str, Any]] = None) -> str:
        self._gc_tmp()
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp-{os.getpid()}")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        arrays = {}
        manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
        for key, leaf in leaves_with_paths(tree):
            arr, dtype = _to_numpy(torch.as_tensor(leaf))
            arrays[key.replace("/", "|")] = arr
            manifest["leaves"][key] = {"shape": list(arr.shape),
                                       "dtype": dtype,
                                       "sha256": _digest(arr)}
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc_old()
        return final

    def restore(self, template: Any,
                step: Optional[int] = None) -> Tuple[Any, int]:
        """Load the newest (or the given) step into ``template``'s
        structure; returns (tree, step)."""
        steps = self.available_steps()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step = steps[-1] if step is None else step
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = []
        with np.load(os.path.join(path, "arrays.npz")) as data:
            for key, leaf in leaves_with_paths(template):
                meta = manifest["leaves"].get(key)
                if meta is None:
                    raise KeyError(f"checkpoint missing leaf {key!r}")
                arr = data[key.replace("/", "|")]
                if _digest(arr) != meta["sha256"]:
                    raise IOError(f"corrupt checkpoint leaf {key!r}")
                device = leaf.device if isinstance(leaf, torch.Tensor) \
                    else torch.device("cpu")
                out.append(_from_numpy(arr, meta["dtype"], device))
        return unflatten(template, out), step

    def available_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and ".tmp-" not in name:
                try:
                    steps.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        s = self.available_steps()
        return s[-1] if s else None

    def _gc_old(self):
        for s in self.available_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def _gc_tmp(self):
        for name in os.listdir(self.dir):
            if ".tmp-" in name:
                shutil.rmtree(os.path.join(self.dir, name),
                              ignore_errors=True)
