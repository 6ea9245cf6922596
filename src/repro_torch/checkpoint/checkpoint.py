"""Atomic, asynchronous checkpoints of the port's training state.

Counterpart of ``repro.checkpoint.checkpoint``, in the same on-disk
layout:

    <dir>/step_<N:09d>/
        arrays.npz     -- every leaf, named by its path (``params/blocks/
                          attn/wq``), as host numpy arrays
        meta.msgpack   -- {"step", "extra" (e.g. the data cursor),
                          "leaves": {name: [shape, dtype]}}

  * ATOMIC: a save writes ``step_<N>.tmp`` and renames it (``os.rename``
    is atomic on POSIX), so ``latest_step`` only ever sees whole
    directories.
  * ASYNC: ``CheckpointManager.save_async`` copies the state to host
    memory synchronously and writes it on a daemon thread; ``wait`` joins
    that thread (before the next save, and on every exit from the train
    loop).
  * GC: the ``keep`` most recent steps are retained.

Under a train mesh (``launch.mesh.TrainMesh``, with the state's specs
``dims``, ``sharding.partition.state_pspecs``) a save gathers every leaf
whole into rank 0's host memory, one leaf at a time, and rank 0 writes
the same files; a restore reads the whole leaves on every rank and keeps
the rank's blocks, under any mesh (the JAX ``restore(..., shardings)``,
the elastic path): a checkpoint written at 2 x 2 restores at 1 x 2 or
unsharded, and the other way round.

numpy has no bfloat16, so a bf16 leaf is stored as its uint16 bit
pattern and its meta dtype says ``bfloat16``.  The JAX package names the
LM head's leaves ``head/q/0`` (mu) and ``head/q/1`` (rho) where the port
says ``head/mu`` and ``head/rho``; ``reference_name`` maps one to the
other, so a checkpoint the JAX package wrote restores into the port's
training state.
"""

from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, Optional

import msgpack
import numpy as np
import torch

from repro_torch.core import tree as T
from repro_torch.sharding import partition as P

_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int32: "int32",
                torch.int64: "int64", torch.bool: "bool"}


def reference_name(path: str) -> str:
    """The JAX package's name for the port's leaf ``path``: the LM head's
    ``.../head/mu`` and ``.../head/rho`` are ``.../head/q/0`` and
    ``.../head/q/1`` there (a ``GaussianVariational`` node's children are
    numbered); every other name is the same."""
    for leaf, idx in (("mu", "0"), ("rho", "1")):
        suffix = f"head/{leaf}"
        if path == suffix or path.endswith("/" + suffix):
            return path[:-len(leaf)] + "q/" + idx
    return path


def _host(t: torch.Tensor) -> np.ndarray:
    # a copy even on the CPU: the train step updates its tensors in place
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def snapshot(tree: Any, mesh=None, dims: Any = None) -> tuple[dict, dict]:
    """(arrays, meta leaves) of ``tree`` copied to host memory.  Under a
    ``mesh`` every rank takes part in gathering each leaf whole (``dims``
    its specs) and rank 0 alone keeps them: the other ranks get empty
    dicts."""
    specs = dict(T.items(dims)) if mesh is not None else None
    arrays, leaves = {}, {}
    for path, t in T.items(tree):
        if mesh is not None:
            spec = specs[path]
            t = P.gather_leaf(t, spec, mesh, host=True)
            if mesh.rank != 0:
                continue
        arrays[path] = _host(t)
        leaves[path] = [list(t.shape), _DTYPE_NAMES[t.dtype]]
    return arrays, leaves


def _write(path: str, step: int, arrays: dict, leaves: dict,
           extra: Optional[dict]) -> str:
    final = os.path.join(path, f"step_{step:09d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "extra": extra or {}, "leaves": leaves}
    with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
        f.write(msgpack.packb(meta))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(path: str, step: int, tree: Any, extra: Optional[dict] = None,
         mesh=None, dims: Any = None):
    """Synchronous atomic save of ``tree`` (+ msgpack-able ``extra``);
    under a ``mesh`` every rank calls it and rank 0 writes (the others
    return None)."""
    arrays, leaves = snapshot(tree, mesh, dims)
    if mesh is not None and mesh.rank != 0:
        return None
    return _write(path, step, arrays, leaves, extra)


def list_steps(path: str) -> list[int]:
    if not os.path.isdir(path):
        return []
    out = []
    for d in os.listdir(path):
        m = re.fullmatch(r"step_(\d+)", d)
        if m and os.path.exists(os.path.join(path, d, "meta.msgpack")):
            out.append(int(m.group(1)))
    return sorted(out)


def latest_step(path: str) -> Optional[int]:
    steps = list_steps(path)
    return steps[-1] if steps else None


def _to_torch(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    a = a if a.flags.c_contiguous else a.copy()
    if dtype_name == "bfloat16":
        # the port's uint16 bits, or the JAX package's 2-byte records
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


@torch.no_grad()
def restore(path: str, step: int, template: Any, mesh=None,
            dims: Any = None) -> tuple[Any, dict]:
    """Load ``step`` INTO ``template``: every leaf is copied into the
    template's tensor of the same name (in place, on its device, cast to
    its dtype), which is returned with the checkpoint's ``extra``.  A
    name missing from the checkpoint raises ``KeyError``, a shape that
    differs ``ValueError``.  Under a ``mesh`` the template holds the
    rank's blocks (``dims`` their specs): each whole leaf is read and the
    rank's block of it copied in, whatever mesh wrote it."""
    specs = dict(T.items(dims)) if mesh is not None else None
    d = os.path.join(path, f"step_{step:09d}")
    with open(os.path.join(d, "meta.msgpack"), "rb") as f:
        meta = msgpack.unpackb(f.read())
    with np.load(os.path.join(d, "arrays.npz")) as npz:
        names = set(npz.files)
        for name, leaf in T.items(template):
            key = name if name in names else reference_name(name)
            if key not in names:
                raise KeyError(f"checkpoint missing leaf {name}")
            a = npz[key]
            want = tuple(leaf.shape) if mesh is None else \
                P.full_shape(leaf, specs[name], mesh)
            if tuple(a.shape) != want:
                raise ValueError(f"shape mismatch at {name}: ckpt "
                                 f"{a.shape} vs {want}")
            t = _to_torch(a, meta["leaves"][key][1])
            if mesh is not None:
                t = P.shard_leaf(t, specs[name], mesh)
            leaf.copy_(t.to(leaf.dtype))
    return template, meta["extra"]


class CheckpointManager:
    """Async save + GC + resume discovery for the train loop."""

    def __init__(self, path: str, keep: int = 3):
        self.path = path
        self.keep = keep
        os.makedirs(path, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Any,
                   extra: Optional[dict] = None, mesh=None,
                   dims: Any = None):
        """Snapshot ``tree`` now and write it on a thread; under a
        ``mesh`` every rank gathers and rank 0 writes."""
        self.wait()
        # snapshot to host synchronously: the next step updates the
        # device tensors in place
        arrays, leaves = snapshot(tree, mesh, dims)
        if mesh is not None and mesh.rank != 0:
            return

        def work():
            _write(self.path, step, arrays, leaves, extra)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def _gc(self):
        steps = list_steps(self.path)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:09d}"),
                          ignore_errors=True)

    def restore_latest(self, template: Any, mesh=None, dims: Any = None):
        """(step, tree, extra) of the newest checkpoint restored into
        ``template`` (on its device; a rank's blocks under ``mesh``), or
        (None, None, None)."""
        step = latest_step(self.path)
        if step is None:
            return None, None, None
        tree, extra = restore(self.path, step, template, mesh, dims)
        return step, tree, extra
