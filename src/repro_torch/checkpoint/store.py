"""Atomic checkpointing with keep-last-k and auto-resume (port of
``repro.checkpoint.store``; leaves are written and read with numpy).

The on-disk format is the JAX package's, so either package reads what the
other wrote:

* **Atomicity** — a checkpoint is written to ``step_XXXXXXXX.tmp/`` and
  renamed into place only after every leaf + the manifest are on disk; a
  kill at any point leaves either a complete checkpoint or an ignorable
  ``.tmp`` directory.
* **Named leaves** — ``leaves.npz`` holds the leaves as ``a0, a1, ...`` and
  ``manifest.json`` their names, the JAX package's key paths
  (:func:`repro_torch.interop.flatten_names`); restore reads by name into a
  template, so it never depends on Python object identity.
* **keep_last_k** — old steps are pruned after a successful save; the
  newest *complete* checkpoint wins at resume (a torn directory is skipped).

Leaves may be numpy arrays or tensors on any device: they are copied to
host numpy to be written, and restored onto each template leaf's device
and dtype.
"""
from __future__ import annotations

import json
import math
import os
import shutil
import struct
import zipfile
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.interop import flatten_names, map_leaves

MANIFEST = "manifest.json"


def _host(leaf) -> np.ndarray:
    if torch.is_tensor(leaf):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree: Any, *, keep_last: int = 3) -> str:
    """Atomically write ``tree`` as checkpoint ``step``; prune old ones."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = flatten_names(tree)
    names = [n for n, _ in flat]
    np.savez(os.path.join(tmp, "leaves.npz"),
             **{f"a{i}": _host(leaf) for i, (_, leaf) in enumerate(flat)})
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump({"step": step, "names": names}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                       # the atomic commit point
    _prune(directory, keep_last)
    return final


def _prune(directory: str, keep_last: int) -> None:
    steps = sorted(all_steps(directory))
    for s in steps[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)
    # sweep stale tmp dirs from interrupted saves
    for d in os.listdir(directory):
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def all_steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp") \
                and os.path.exists(os.path.join(directory, d, MANIFEST)):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _read_npz(path: str) -> dict[str, np.ndarray]:
    """The arrays of an ``.npz`` by key, as ``np.load`` gives them. Where
    every member is stored uncompressed (as :func:`save` writes them), each
    is read with one ``np.fromfile`` at its offset in the file: ``np.load``
    copies a member through the zip reader a 256 KiB piece at a time."""
    with zipfile.ZipFile(path) as z:
        infos = z.infolist()
    if any(i.compress_type != zipfile.ZIP_STORED for i in infos):
        with np.load(path) as data:
            return {k: data[k] for k in data.files}
    out = {}
    with open(path, "rb") as f:
        for info in infos:
            f.seek(info.header_offset)
            local = f.read(30)
            if local[:4] != b"PK\x03\x04":
                raise ValueError(f"{path}: {info.filename} has no local "
                                 f"header")
            name_len, extra_len = struct.unpack("<HH", local[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read_header = (np.lib.format.read_array_header_1_0
                           if version == (1, 0) else
                           np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read_header(f)
            count = math.prod(shape)
            arr = np.fromfile(f, dtype=dtype, count=count)
            if arr.size != count:
                raise ValueError(f"{path}: {info.filename} holds "
                                 f"{arr.size} of {count} values")
            out[info.filename.removesuffix(".npy")] = (
                arr.reshape(shape[::-1]).T if fortran else arr.reshape(shape))
    return out


def load_leaves(directory: str, step: int) -> dict[str, np.ndarray]:
    """Every leaf of checkpoint ``step`` by name, as saved."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, MANIFEST)) as f:
        names = json.load(f)["names"]
    data = _read_npz(os.path.join(path, "leaves.npz"))
    return {n: data[f"a{i}"] for i, n in enumerate(names)}


def restore(directory: str, step: int, template: Any) -> Any:
    """Load checkpoint ``step`` into the structure of ``template``: each
    leaf is read by its name, checked against the template leaf's shape and
    cast to its dtype (onto its device, for a tensor)."""
    by_name = load_leaves(directory, step)
    path = os.path.join(directory, f"step_{step:08d}")

    def leaf(name, like):
        if name not in by_name:
            raise KeyError(f"checkpoint {path} missing leaf {name!r}")
        arr = by_name[name]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                             f"template {tuple(like.shape)}")
        if torch.is_tensor(like):
            return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                      dtype=like.dtype)
        return arr.astype(like.dtype)

    return map_leaves(template, leaf)


def restore_latest(directory: str, template: Any):
    """(step, tree) of the newest complete checkpoint, or (None, None)."""
    step = latest_step(directory)
    if step is None:
        return None, None
    return step, restore(directory, step, template)
