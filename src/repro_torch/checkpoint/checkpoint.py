"""Atomic, optionally asynchronous checkpoints of tensor trees.

Port of ``repro.checkpoint.checkpoint`` for one device. Layout (one
directory per step)::

    <root>/step_000123.tmp-<nonce>/   # written first
        manifest.json                 # leaf names, shapes, dtypes, meta
        <leaf-name>.npy               # one file per leaf
    <root>/step_000123/               # atomic rename when complete

* atomicity: a checkpoint is visible iff its rename committed; a crash
  mid-write leaves only a ``.tmp-`` directory, which ``latest_step`` and
  ``restore`` ignore and the garbage collector removes after an hour;
* async: ``save`` copies every tensor to the host synchronously (so the
  step that follows may update the state in place), then writes in a
  thread. The thread is not a daemon: a pending write completes before the
  interpreter exits;
* bfloat16, which numpy lacks, is stored by its raw 16-bit pattern with
  ``"bfloat16"`` in the manifest and restored bit for bit.

Restore places each leaf on the device of the matching leaf of
``tree_like``. Resharding onto another mesh waits for the distributed port
(ROADMAP Queue A 8). The data-pipeline position and trainer bookkeeping
ride in ``manifest["meta"]``.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.core import tree as tree_lib

_BF16 = "bfloat16"


def _to_host(t: torch.Tensor):
    """(numpy array, dtype name) of a detached host copy of ``t``."""
    t = torch.as_tensor(t).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), _BF16
    return t.numpy(), str(t.dtype).replace("torch.", "")


def _from_host(arr: np.ndarray, dtype: str, like: torch.Tensor) -> torch.Tensor:
    t = torch.from_numpy(arr)       # np.load gives a C-contiguous array
    if dtype == _BF16:
        t = t.view(torch.bfloat16)
    return t.to(like.device)


def save(root: str, step: int, tree, *, meta: Optional[dict] = None,
         async_write: bool = False, keep_last: int = 3) -> str:
    """Write a checkpoint of ``tree``; returns the final directory path."""
    os.makedirs(root, exist_ok=True)
    final = os.path.join(root, f"step_{step:08d}")
    flat = {tree_lib.key_of(path): _to_host(leaf)
            for path, leaf in tree_lib.leaves_with_paths(tree)}

    def write():
        tmp = tempfile.mkdtemp(prefix=f"step_{step:08d}.tmp-", dir=root)
        manifest = {"step": step, "meta": meta or {}, "leaves": {}, "time": time.time()}
        try:
            for key, (arr, dtype) in flat.items():
                fname = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fname), arr)
                manifest["leaves"][key] = {"file": fname, "dtype": dtype,
                                           "shape": list(arr.shape)}
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            _gc(root, keep_last)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise

    if async_write:
        threading.Thread(target=write, name=f"ckpt-{step}").start()
        return final
    write()
    return final


def _gc(root: str, keep_last: int):
    steps = sorted(d for d in os.listdir(root) if d.startswith("step_") and ".tmp" not in d)
    for d in steps[:-keep_last] if keep_last > 0 else []:
        shutil.rmtree(os.path.join(root, d), ignore_errors=True)
    for d in os.listdir(root):
        if ".tmp-" in d:
            # stale partial writes from crashed processes
            age = time.time() - os.path.getmtime(os.path.join(root, d))
            if age > 3600:
                shutil.rmtree(os.path.join(root, d), ignore_errors=True)


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(root)
        if d.startswith("step_") and ".tmp" not in d
        and os.path.exists(os.path.join(root, d, "manifest.json"))
    ]
    return max(steps) if steps else None


def restore(root: str, tree_like, *, step: Optional[int] = None) -> Any:
    """Restore into the structure of ``tree_like``: returns ``(tree, meta,
    step)``, each leaf on the device of its counterpart in ``tree_like``."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {root}")
    d = os.path.join(root, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves: Dict[str, dict] = manifest["leaves"]

    def load(path, like):
        key = tree_lib.key_of(path)
        entry = leaves[key]
        if tuple(entry["shape"]) != tuple(like.shape):
            raise ValueError(f"{key}: checkpoint shape {entry['shape']} != "
                             f"{list(like.shape)}")
        return _from_host(np.load(os.path.join(d, entry["file"])), entry["dtype"], like)

    return tree_lib.map_with_paths(load, tree_like), manifest["meta"], step
