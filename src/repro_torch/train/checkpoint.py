"""Fault-tolerant checkpointing: atomic, step-tagged, auto-resume (from
``repro.train.checkpoint``, the same on-disk layout).

Layout (one directory per step, written atomically via tmp+rename):

    <root>/step_00000200.tmp/...    (in flight)
    <root>/step_00000200/
        manifest.json               (leaf count, shapes, dtypes, step, ...)
        shard_00000.npz             (this host's leaves: leaf_0, leaf_1, ...)

* **cross-package**: leaves are written in ``jax.tree.flatten``'s order
  (``models.common.tree_flatten``: dict keys sorted, NamedTuple fields in
  order) and bf16 leaves as their raw uint16 bits with the logical dtype
  in the manifest, as the reference writes them, so either package
  restores the other's checkpoint.  Restore checks the leaf count and
  every shape, as the reference does (not the tree's text).
* **atomic**: readers never observe a partial checkpoint — the rename is
  the commit point; stale ``.tmp`` dirs from crashed writers are garbage-
  collected on the next save.
* **async flush**: ``save(..., blocking=False)`` hands the host copies of
  the leaves to a writer thread so the train loop resumes at once (the
  device->host copy is the only synchronous part).
* **retention**: keep the last N checkpoints (plus every multiple of
  ``keep_every``).
"""

from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.common import tree_flatten, tree_unflatten

_NAMES = {torch.bfloat16: "bfloat16", torch.float32: "float32",
          torch.float16: "float16", torch.int32: "int32",
          torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool",
          torch.int8: "int8"}


def _host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` as numpy; bf16 as its raw uint16 bits."""
    x = x.detach()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).cpu().numpy().view(np.uint16)
    return x.cpu().numpy()


def _tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    a = a if a.flags.c_contiguous else a.copy()     # keeps 0-d leaves 0-d
    if dtype_name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


class CheckpointManager:
    def __init__(self, root: str, keep_last: int = 3,
                 keep_every: Optional[int] = None, process_index: int = 0):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.process_index = process_index
        self._writer: Optional[threading.Thread] = None
        self._gc_tmp()

    # ---- write --------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = True,
             extra: Optional[Dict] = None):
        """Checkpoint a tree of tensors at ``step``."""
        self.wait()                       # one in-flight save at a time
        leaves, _ = tree_flatten(tree)
        store_leaves = [_host(x) for x in leaves]     # device -> host copy
        manifest = {
            "step": int(step),
            "n_leaves": len(leaves),
            "shapes": [list(x.shape) for x in leaves],
            "dtypes": [_NAMES[x.dtype] for x in leaves],
            "treedef": f"repro_torch tree of {len(leaves)} leaves",
            "time": time.time(),
            "extra": extra or {},
        }

        def _write():
            final = self.root / f"step_{step:08d}"
            tmp = self.root / f"step_{step:08d}.tmp"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            np.savez(tmp / f"shard_{self.process_index:05d}.npz",
                     **{f"leaf_{i}": x for i, x in enumerate(store_leaves)})
            (tmp / "manifest.json").write_text(json.dumps(manifest))
            if final.exists():
                shutil.rmtree(final)
            tmp.rename(final)             # commit point
            self._retain()

        if blocking:
            _write()
        else:
            self._writer = threading.Thread(target=_write, daemon=True)
            self._writer.start()

    def wait(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    # ---- read ---------------------------------------------------------------

    def steps(self) -> List[int]:
        out = []
        for p in self.root.iterdir():
            if p.is_dir() and p.name.startswith("step_") \
                    and not p.name.endswith(".tmp"):
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, template: Any, step: Optional[int] = None,
                device=None, placements: Any = None,
                rank: int = 0) -> Tuple[Any, int]:
        """Restore into the structure of ``template`` (leaf count and
        shapes checked); each leaf takes the template leaf's dtype and
        device, or ``device`` when given (a template of ``meta`` tensors
        then describes the state without holding it).  With
        ``placements`` (``template``'s structure, one
        ``parallel.sharding.Placement`` per leaf) each leaf is rank
        ``rank``'s block of it.  Leaves are read one at a time, so the
        host holds one global leaf beside what is restored."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        t_leaves, treedef = tree_flatten(template)
        if len(t_leaves) != manifest["n_leaves"]:
            raise ValueError(
                f"checkpoint has {manifest['n_leaves']} leaves, template "
                f"{len(t_leaves)} — architecture/RunConfig mismatch")
        pls = tree_flatten(placements)[0] if placements is not None \
            else [None] * len(t_leaves)
        restored = []
        with np.load(d / f"shard_{self.process_index:05d}.npz") as z:
            for i, (a, pl) in enumerate(zip(t_leaves, pls)):
                b = _tensor(z[f"leaf_{i}"], manifest["dtypes"][i])
                if tuple(a.shape) != tuple(b.shape):
                    raise ValueError(f"leaf {i}: shape {tuple(b.shape)} != "
                                     f"{tuple(a.shape)}")
                if pl is not None:     # a copy: the global leaf is freed
                    b = b[pl.index(tuple(b.shape), rank)].clone(
                        memory_format=torch.contiguous_format)
                restored.append(b.to(
                    device=a.device if device is None else device,
                    dtype=a.dtype))
        return tree_unflatten(treedef, restored), step

    # ---- housekeeping ---------------------------------------------------------

    def _retain(self):
        steps = self.steps()
        if len(steps) <= self.keep_last:
            return
        drop = steps[:-self.keep_last]
        for s in drop:
            if self.keep_every and s % self.keep_every == 0:
                continue
            shutil.rmtree(self.root / f"step_{s:08d}", ignore_errors=True)

    def _gc_tmp(self):
        for p in self.root.glob("step_*.tmp"):
            shutil.rmtree(p, ignore_errors=True)
