"""Atomic, resumable checkpoints of parameter and optimizer trees.

Ported from ``src/repro/checkpoint/checkpoint.py`` with its on-disk layout:

    <dir>/step_<N:08d>/
      manifest.json   -- step, leaf count, key paths, shapes, dtypes, meta
      shard_0.npz     -- leaf_<i>: the i-th leaf as a NumPy array

Leaves are taken in the tree's fixed key-path order
(:func:`repro_torch.tree.named_leaves`).  npz has no bfloat16, so a bf16
tensor is stored as its uint16 bits and the manifest records
``bfloat16``; ints and floats (the optimizer's count) are stored as 0-d
arrays.  One process writes one shard, ``shard_0``, of whole leaves.

A leaf that is this rank's shard of a mesh layout (a tensor with a
:class:`~repro_torch.distributed.mesh.Placement`: a sharded model's
parameters and their AdamW state) is saved whole, gathered leaf by leaf
to host memory, as JAX's ``np.asarray`` of a sharded array
(``src/repro/checkpoint/checkpoint.py:51``): every rank of the mesh takes
part in :func:`save` (``write=False`` on all but the writer), and
:func:`restore` cuts the rank's shard of each such leaf of ``like``, so a
checkpoint moves between meshes and to one rank.

Fault-tolerance properties, as in the JAX package:
  * atomic publish: written to ``step_<N>.tmp`` then ``os.replace``'d, so a
    crash mid-write never corrupts the latest checkpoint;
  * async: :func:`save_async` copies the leaves to host memory now and
    writes them in a background thread while training goes on; a second
    ``save_async`` into the same directory first waits for the pending one;
  * retention: the newest ``keep`` (3) steps stay;
  * :func:`restore` puts the leaves on the caller's device (each leaf of
    ``like``'s, or ``device``).
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

from repro_torch.distributed import mesh as M
from repro_torch.distributed.collectives import gather_leaf
from repro_torch.sharding.partition import shard_of
from repro_torch.tree import named_leaves, unflatten

# (key path, host array, dtype name) of each leaf.
Snapshot = List[Tuple[str, np.ndarray, str]]


def _snapshot(tree: Any) -> Snapshot:
    """Host copies of the tree's leaves, bf16 as uint16 bits; a shard
    gathered whole first (a collective over its mesh), one leaf at a
    time."""
    snap = []
    for path, leaf in named_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            if M.placement(leaf) is not None:
                with torch.no_grad():
                    leaf = gather_leaf(leaf)
            t = leaf.detach().to("cpu", copy=True)
            if t.dtype == torch.bfloat16:
                snap.append((path, t.view(torch.int16).numpy().view(
                    np.uint16), "bfloat16"))
            else:
                snap.append((path, t.numpy(), str(t.numpy().dtype)))
        else:
            a = np.asarray(leaf)
            snap.append((path, a, str(a.dtype)))
    return snap


def _write(ckpt_dir: str, step: int, snap: Snapshot,
           meta: Optional[Dict], keep: int) -> str:
    root = Path(ckpt_dir)
    root.mkdir(parents=True, exist_ok=True)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    np.savez(tmp / "shard_0.npz",
             **{f"leaf_{i}": a for i, (_, a, _) in enumerate(snap)})
    manifest = {
        "step": step,
        "n_leaves": len(snap),
        "paths": [p for p, _, _ in snap],
        "shapes": [list(a.shape) for _, a, _ in snap],
        "dtypes": [d for _, _, d in snap],
        "meta": meta or {},
        "time": time.time(),
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():  # a re-save of the same step replaces it
        shutil.rmtree(final)
    os.replace(tmp, final)

    steps = sorted(p for p in root.glob("step_*") if p.is_dir()
                   and not p.name.endswith(".tmp"))
    for old in steps[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return str(final)


def save(ckpt_dir: str, step: int, tree: Any, meta: Optional[Dict] = None,
         keep: int = 3, write: bool = True) -> Optional[str]:
    """Synchronous atomic save.  Returns the final directory path (None
    for a rank that only took part in the gathers, ``write=False``)."""
    snap = _snapshot(tree)
    return _write(ckpt_dir, step, snap, meta, keep) if write else None


_PENDING: Dict[str, threading.Thread] = {}


def save_async(ckpt_dir: str, step: int, tree: Any,
               meta: Optional[Dict] = None, keep: int = 3,
               write: bool = True) -> Optional[threading.Thread]:
    """Snapshot to host memory now, write in the background (``write``
    as :func:`save` takes it)."""
    if not write:
        _snapshot(tree)
        return None
    wait_pending(ckpt_dir)
    t = threading.Thread(target=_write, args=(ckpt_dir, step,
                                              _snapshot(tree), meta, keep),
                         daemon=True)
    t.start()
    _PENDING[ckpt_dir] = t
    return t


def wait_pending(ckpt_dir: str):
    t = _PENDING.pop(ckpt_dir, None)
    if t is not None:
        t.join()


def latest_step(ckpt_dir: str) -> Optional[int]:
    p = Path(ckpt_dir)
    if not p.exists():
        return None
    steps = sorted(
        int(d.name.split("_")[1]) for d in p.glob("step_*")
        if d.is_dir() and not d.name.endswith(".tmp"))
    return steps[-1] if steps else None


def _leaf(a: np.ndarray, dtype: str, like: Any, device) -> Any:
    if not isinstance(like, torch.Tensor):
        return type(like)(a.item())
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    pl = M.placement(like)
    if pl is not None:
        t = shard_of(t, pl.spec, pl.mesh)
    return t.to(like.device if device is None else device)


def restore(ckpt_dir: str, like: Any, step: Optional[int] = None,
            device=None) -> Tuple[Any, int]:
    """``(tree, step)``: the checkpoint of ``step`` (the latest by default)
    in ``like``'s structure (a module becomes the dict of its parameters),
    each tensor on ``device`` or, by default, on the device of ``like``'s
    leaf; this rank's shard where ``like``'s leaf is one.  Raises
    ``FileNotFoundError`` when there is no such checkpoint."""
    if step is None:
        step = latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    d = Path(ckpt_dir) / f"step_{step:08d}"
    if not d.is_dir():
        raise FileNotFoundError(f"no checkpoint of step {step} under "
                                f"{ckpt_dir}")
    manifest = json.loads((d / "manifest.json").read_text())
    like_leaves = named_leaves(like)
    paths = [p for p, _ in like_leaves]
    if manifest["paths"] != paths:
        raise ValueError(f"checkpoint {d} holds leaves {manifest['paths'][:4]}"
                         f"... ({manifest['n_leaves']}), the tree has "
                         f"{paths[:4]}... ({len(paths)})")
    with np.load(d / "shard_0.npz") as data:
        new = [_leaf(data[f"leaf_{i}"], manifest["dtypes"][i], leaf, device)
               for i, (_, leaf) in enumerate(like_leaves)]
    return unflatten(like, iter(new)), step
