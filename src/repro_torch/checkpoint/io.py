"""Tree checkpointing: npz payload + JSON manifest (port of
``repro/checkpoint/io.py``, in its file format).

Files are ``{name}_{step:08d}.npz`` plus ``{name}_{step:08d}.json``; keys
are the slash-joined tree paths the reference writes (a dict key or a
sequence index as itself, a ``NamedTuple`` field as ``.field``), values
host numpy arrays, bf16 saved as fp32 (npz has no bf16). So either
package reads the other's checkpoints. ``restore`` rebuilds against a
template tree and gives each leaf the template leaf's type: a torch
tensor keeps its dtype and device, a numpy array its dtype, a Python
scalar its type.

Crash safety: payload and manifest are written to a temp file and moved
into place with ``os.replace`` (atomic on POSIX), so a writer killed
mid-save leaves the previous checkpoint or a stray ``*.tmp*`` file, never
a half-written payload under the final name. ``latest_step`` validates
each candidate payload (zip central directory + per-member CRC) and skips
truncated or missing ones; ``restore`` refuses non-finite payloads.
"""
from __future__ import annotations

import json
import os
import re
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from ..utils import tree

PyTree = Any


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:          # npz has no bf16: lossless up
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree_: PyTree) -> dict:
    leaves, _ = tree.tree_flatten_with_path(tree_)
    return {tree.path_str(path): _host(leaf) for path, leaf in leaves}


def _payload_valid(path: str) -> bool:
    """Whether an npz payload is present and structurally complete (zip
    central directory readable, every member's CRC checks out)."""
    if not os.path.isfile(path):
        return False
    try:
        with zipfile.ZipFile(path) as zf:
            return zf.testzip() is None
    except (zipfile.BadZipFile, OSError, EOFError):
        return False


def save(directory: str, step: int, tree_: PyTree, name: str = "ckpt",
         keep_last: Optional[int] = None) -> str:
    os.makedirs(directory, exist_ok=True)
    flat = _flatten(tree_)
    path = os.path.join(directory, f"{name}_{step:08d}.npz")
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)
    manifest = {"step": step, "keys": sorted(flat),
                "shapes": {k: list(v.shape) for k, v in flat.items()}}
    mpath = os.path.join(directory, f"{name}_{step:08d}.json")
    mtmp = mpath + ".tmp"
    with open(mtmp, "w") as f:
        json.dump(manifest, f)
    os.replace(mtmp, mpath)
    if keep_last is not None:
        gc_steps(directory, name=name, keep_last=keep_last)
    return path


def gc_steps(directory: str, name: str = "ckpt", keep_last: int = 1) -> None:
    """Keep only the newest ``keep_last`` steps with a valid payload;
    delete every other step (payload, manifest, meta), dead newer steps
    included, so the newest restorable step is never collected."""
    if keep_last < 1:
        raise ValueError(f"keep_last must be >= 1, got {keep_last}")
    if not os.path.isdir(directory):
        return
    steps = set()
    for f in os.listdir(directory):
        m = re.fullmatch(rf"{name}_(\d+)\.(npz|json)", f)
        if m:
            steps.add(int(m.group(1)))
    valid = [s for s in steps
             if _payload_valid(os.path.join(directory,
                                            f"{name}_{s:08d}.npz"))]
    keep = set(sorted(valid)[-keep_last:])
    for s in steps - keep:
        for ext in ("npz", "json", "meta.json"):
            p = os.path.join(directory, f"{name}_{s:08d}.{ext}")
            if os.path.isfile(p):
                os.remove(p)


def _like(raw: np.ndarray, leaf):
    """``raw`` as the template leaf's type, dtype and device."""
    if torch.is_tensor(leaf):
        return torch.from_numpy(np.array(raw)).to(device=leaf.device,
                                                  dtype=leaf.dtype)
    if isinstance(leaf, (np.ndarray, np.generic)):
        return np.array(raw, dtype=leaf.dtype)
    return type(leaf)(raw.item())


def restore(directory: str, step: int, template: PyTree,
            name: str = "ckpt", reject_nonfinite: bool = True) -> PyTree:
    path = os.path.join(directory, f"{name}_{step:08d}.npz")
    if not _payload_valid(path):
        raise FileNotFoundError(
            f"checkpoint payload missing or truncated: {path} "
            f"(use latest_step() to locate the last complete step)")
    out = []
    leaves, treedef = tree.tree_flatten_with_path(template)
    with np.load(path) as data:
        for path_t, leaf in leaves:
            key = tree.path_str(path_t)
            raw = data[key]
            if (reject_nonfinite and np.issubdtype(raw.dtype, np.floating)
                    and not np.isfinite(raw).all()):
                # A payload that passed the CRC can still carry NaN/inf
                # (state spilled mid-blowup): restoring it would feed
                # poison back into the store or the federation.
                raise ValueError(
                    f"checkpoint payload contains non-finite values: {path} "
                    f"(key {key!r}); refusing to restore corrupted state")
            out.append(_like(raw, leaf))
    return treedef.unflatten(out)


def latest_step(directory: str, name: str = "ckpt") -> Optional[int]:
    """Largest step with a complete payload; missing or truncated ones are
    skipped."""
    if not os.path.isdir(directory):
        return None
    steps = []
    for f in os.listdir(directory):
        m = re.fullmatch(rf"{name}_(\d+)\.npz", f)
        if m and _payload_valid(os.path.join(directory, f)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None
