"""Checkpoints in the reference's on-disk format, with async save.

The layout and the manifest are the reference's
(``src/repro/checkpoint/checkpointer.py``), so either package restores
the other's checkpoint:

  * ``step_XXXXXXXX/proc_00000/arrays.npz`` holds every leaf under its
    key (path parts joined by ``/``: dict keys, list indices, ``.field``
    for a NamedTuple field, as ``jax.tree_util`` names them), bf16 / f16
    stored as f32; ``manifest.json`` records step, shapes, dtypes and the
    caller's ``extra``; ``COMMITTED`` is written last, and a step
    directory without it is ignored;
  * each step is written under a tmp name and renamed; the last ``keep``
    steps are kept.

The port keeps a model's groups as a list of per-group dicts where the
reference stacks them on a leading axis: a ``groups`` list is stored
stacked (one array a key, ``n_groups`` first) and split again on restore.

``restore(..., shardings=)`` is the elastic path: a leaf named in the
twin tree of ``launch/mesh.py::NamedSharding`` comes back as a DTensor
holding only this rank's slice of the saved array, so a checkpoint saved
on one mesh (or by one process) restores onto another.

Async save: torch tensors are mutable and the optimizer updates them in
place, so ``save`` copies every tensor to host memory before it returns
(the reference relies on immutable arrays instead); only the file writes
run on the worker thread.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.util import atomic_write, atomic_write_text, fsync_dir

_SEP = "/"
_WIDEN = (torch.bfloat16, torch.float16)     # numpy has no bf16


def _walk(node, fn, path=(), group=None):
    """Rebuild ``node`` with ``fn(key, group, tensor)`` at every tensor;
    ``group`` is the index in a ``groups`` list (stored stacked), else
    None."""
    if isinstance(node, torch.Tensor):
        return fn(_SEP.join(path), group, node)
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            if k == "groups" and isinstance(v, list):
                out[k] = [_walk(s, fn, path + (k,), i)
                          for i, s in enumerate(v)]
            else:
                out[k] = _walk(v, fn, path + (str(k),), group)
        return out
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_walk(getattr(node, f), fn, path + ("." + f,),
                                  group) for f in node._fields))
    if isinstance(node, (list, tuple)):
        return type(node)(_walk(v, fn, path + (str(i),), group)
                          for i, v in enumerate(node))
    raise TypeError(f"unexpected leaf {type(node)} at {_SEP.join(path)}")


def _flatten(tree) -> dict:
    """-> {key: (tensors, stacked)} in the reference's key format."""
    flat: dict = {}

    def rec(key, group, x):
        tensors, _ = flat.setdefault(key, ([], group is not None))
        tensors.append(x)
    _walk(tree, rec)
    return flat


def _sharding_map(node, path=(), group=None, out=None) -> dict:
    """{(key, group): NamedSharding} of a shardings twin tree, keyed as
    :func:`_walk` keys the leaves; None or a missing branch names none."""
    out = {} if out is None else out
    if node is None:
        return out
    if hasattr(node, "placements") and hasattr(node, "local_slices"):
        out[(_SEP.join(path), group)] = node
    elif isinstance(node, dict):
        for k, v in node.items():
            if k == "groups" and isinstance(v, list):
                for i, sub in enumerate(v):
                    _sharding_map(sub, path + (k,), i, out)
            else:
                _sharding_map(v, path + (str(k),), group, out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for f in node._fields:
            _sharding_map(getattr(node, f), path + ("." + f,), group, out)
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            _sharding_map(v, path + (str(i),), group, out)
    else:
        raise TypeError(f"unexpected sharding {type(node)} at "
                        f"{_SEP.join(path)}")
    return out


def _to_host(x: torch.Tensor) -> np.ndarray:
    """A host copy of ``x`` (bf16 / f16 widened to f32, losslessly) that
    later in-place updates of ``x`` do not reach."""
    dtype = torch.float32 if x.dtype in _WIDEN else x.dtype
    return x.detach().to("cpu", dtype, copy=True).numpy()


class Checkpointer:
    def __init__(self, directory: str | pathlib.Path, keep: int = 2,
                 process_index: int = 0):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.process_index = process_index
        self._worker: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None,
             blocking: bool = True):
        """Write ``tree`` as step ``step``.  Every tensor is on the host
        when this returns; with ``blocking=False`` the files are written
        by a worker thread (``wait`` joins it)."""
        self.wait()                                 # previous save must land
        snapshot = {}
        for key, (tensors, stacked) in _flatten(tree).items():
            arrays = [_to_host(x) for x in tensors]
            snapshot[key] = np.stack(arrays) if stacked else arrays[0]

        def work():
            self._write(step, snapshot, extra or {})

        if blocking:
            work()
        else:
            self._worker = threading.Thread(target=work, daemon=True)
            self._worker.start()

    def wait(self):
        if self._worker is not None:
            self._worker.join()
            self._worker = None

    def _write(self, step: int, flat: dict, extra: dict):
        tmp = self.dir / f".tmp_step_{step:08d}_{self.process_index}"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        shard_dir = tmp / f"proc_{self.process_index:05d}"
        shard_dir.mkdir()
        flat = dict(sorted(flat.items()))
        with atomic_write(shard_dir / "arrays.npz", "wb") as f:
            np.savez(f, **flat)
        manifest = {
            "step": step,
            "time": time.time(),
            "process_count": 1,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in flat.items()},
            "extra": extra,
        }
        atomic_write_text(tmp / "manifest.json",
                          json.dumps(manifest, indent=1))
        # commit marker last: a crash before this line leaves an
        # uncommitted (ignored) tmp dir, never a half-restorable step
        atomic_write_text(tmp / "COMMITTED", "ok")
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)
        fsync_dir(self.dir)
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore -------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "COMMITTED").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like: Any, shardings=None,
                device=None) -> tuple[Any, dict]:
        """Restore into the structure of ``like`` (a tree of tensors, meta
        tensors included) -> (tree, extra).  Each leaf takes its ``like``
        leaf's dtype, and goes to ``device`` (default: the ``like`` leaf's
        own device).  A leaf named in ``shardings`` (a twin tree of
        ``NamedSharding``, None where a leaf is not sharded) becomes a
        DTensor of this rank's slice only, on ``device`` (default: the
        mesh's device type, this rank's card)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        data = {}
        for proc_dir in sorted(d.glob("proc_*")):
            with np.load(proc_dir / "arrays.npz") as z:
                for k in z.files:
                    data[k] = z[k]
        counts = {k: len(t) for k, (t, _) in _flatten(like).items()}
        smap = _sharding_map(shardings)

        def load(key, group, leaf):
            if key not in data:
                raise KeyError(f"checkpoint missing leaf {key}")
            arr = data[key]
            want = tuple(leaf.shape)
            if group is not None:
                want = (counts[key],) + want
            if tuple(arr.shape) != want:
                raise ValueError(f"{key}: {arr.shape} != {want}")
            if group is not None:
                arr = arr[group]
            sh = smap.get((key, group))
            if sh is not None:
                return _shard_of(arr, sh, leaf.dtype, device)
            dev = leaf.device if device is None else torch.device(device)
            return torch.from_numpy(arr).to(dev, leaf.dtype, copy=True)

        return _walk(like, load), manifest["extra"]


def _shard_of(arr: np.ndarray, sharding, dtype, device) -> torch.Tensor:
    """This rank's slice of the saved ``arr`` as a DTensor of its shape."""
    from repro_torch.launch.mesh import to_dtensor
    mesh = sharding.mesh
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if mesh.device_type == "cuda"
                  else torch.device(mesh.device_type))
    part = np.ascontiguousarray(arr[sharding.local_slices(arr.shape)])
    local = torch.from_numpy(part).to(torch.device(device), dtype,
                                      copy=True)
    return to_dtensor(local, sharding, arr.shape)
