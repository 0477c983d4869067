"""Checkpointing: atomic, async, restorable onto any device (port of the
reference ``checkpoint/checkpoint.py``).

Layout (one directory per step), the reference's own::

    ckpt_dir/
      step_000123/
        manifest.json        # leaf keys, shapes, dtypes
        shard_00000.npz      # every leaf, whole, under its key
        COMMITTED            # written LAST -> atomic commit marker

* **Atomic**: readers only consider directories containing ``COMMITTED``;
  a crash mid-save leaves a garbage dir that restore ignores and a later
  save overwrites.
* **Async**: ``save_async`` copies every leaf to host memory before it
  returns, then writes on a background thread.  The copy must be whole
  at return: ``adamw_update`` writes the params and the moments in place
  (``train/optimizer.py``), so the next step overwrites the very tensors
  that were saved.  Only the file write runs behind.
* **Keys**: a leaf's key is the string ``jax.tree_util.keystr`` gives its
  path (``['params']['embed']``, ``['opt']['m'][0]``; dict keys in
  sorted order), so a checkpoint written by either package restores in
  the other.
* **Sharded leaves**: a ``ShardedTensor`` (``distributed/sharding.py``)
  is saved whole, gathered to the host, as the reference's
  ``np.asarray`` of a global array writes it.
* **Restore**: each leaf goes onto the skeleton leaf's device with its
  dtype and shape; a ``ShardedTensor`` skeleton leaf back onto its own
  layout.  ``shardings=`` (a tree of ``NamedSharding`` matching the
  skeleton) lays each leaf out afresh — the elastic restore onto a new
  mesh.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.distributed.sharding import ShardedTensor, is_sharded


def _keyed(tree, prefix: str = ""):
    """(key, leaf) pairs in the reference's flatten order (a
    ``ShardedTensor`` is one leaf)."""
    if is_sharded(tree):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _keyed(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _keyed(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _rebuild(fn, tree, other=None, prefix: str = ""):
    """``tree``'s layout with each leaf replaced by ``fn(key, leaf,
    other's leaf)``; ``other`` is a tree of the same layout, or None."""
    if is_sharded(tree):
        return fn(prefix, tree, other)
    if isinstance(tree, dict):
        return {k: _rebuild(fn, v, None if other is None else other[k],
                            f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(fn, v, None if other is None
                                   else other[i], f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return fn(prefix, tree, other)


def _host(x) -> np.ndarray:
    """A numpy copy of ``x`` that shares no memory with it (a bfloat16
    tensor raises: numpy has no such type)."""
    if isinstance(x, ShardedTensor):
        return x.gather("cpu").detach().numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.array(x, copy=True)


class CheckpointManager:
    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        os.makedirs(ckpt_dir, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    # -- save ---------------------------------------------------------------
    def _write(self, step: int, flat: dict):
        path = os.path.join(self.dir, f"step_{step:09d}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "shard_00000.npz"), **flat)
        manifest = {"step": step,
                    "leaves": {k: {"shape": list(v.shape),
                                   "dtype": str(v.dtype)}
                               for k, v in flat.items()}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        with open(os.path.join(tmp, "COMMITTED"), "w") as f:
            f.write("ok")
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
        self._gc()

    def _write_caught(self, step: int, flat: dict):
        try:
            self._write(step, flat)
        except Exception as e:  # re-raised by wait()
            self._error = e

    def _gc(self):
        steps = self.list_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)

    @staticmethod
    def snapshot(tree) -> dict:
        """{key: numpy copy} of every leaf, taken now."""
        return {k: _host(x) for k, x in _keyed(tree)}

    def save(self, step: int, tree) -> None:
        self.wait()  # serialize against any in-flight async save
        if step in self.list_steps():
            return
        self._write(step, self.snapshot(tree))

    def save_async(self, step: int, tree) -> None:
        self.wait()  # one in-flight save at a time
        flat = self.snapshot(tree)  # whole before return
        self._thread = threading.Thread(target=self._write_caught,
                                        args=(step, flat), daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the in-flight save; raise what its write raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # -- restore --------------------------------------------------------------
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and os.path.exists(
                    os.path.join(self.dir, name, "COMMITTED")):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, skeleton, shardings=None):
        """Restore into the skeleton's tree structure: each leaf a tensor
        on the skeleton leaf's device with its dtype (a leaf that is no
        tensor gives a CPU tensor of the saved dtype), a ``ShardedTensor``
        skeleton leaf on its layout; ``shardings`` (a tree of
        ``NamedSharding`` of the skeleton's layout) lays every leaf out
        on its new mesh instead."""
        path = os.path.join(self.dir, f"step_{step:09d}")
        with np.load(os.path.join(path, "shard_00000.npz")) as data:
            def leaf(key, like, sh):
                x = torch.from_numpy(data[key])
                want = tuple(like.shape if hasattr(like, "shape")
                             else np.shape(like))
                if tuple(x.shape) != want:
                    raise ValueError(
                        f"checkpoint leaf {key} has shape {tuple(x.shape)}, "
                        f"the skeleton {want}")
                if hasattr(like, "dtype") and isinstance(like.dtype,
                                                         torch.dtype):
                    x = x.to(like.dtype)
                if sh is None and is_sharded(like):
                    sh = like.sharding
                if sh is not None:
                    return sh.place(x)
                if isinstance(like, torch.Tensor):
                    return x.to(device=like.device)
                return x
            return _rebuild(leaf, skeleton, shardings)
