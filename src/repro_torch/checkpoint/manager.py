"""Sharded, atomic, async checkpointing on npz + manifest (port of
``repro.checkpoint.manager``, same on-disk format).

Layout on disk:
    <dir>/step_000123/
        manifest.json            step, keys, shapes, dtypes, extra metadata
        proc_00000.npz           this process's shard
    <dir>/step_000123.COMMITTED  empty marker written *after* all data lands

Guarantees, as in the JAX manager:
  * atomicity: a checkpoint without the COMMITTED marker is ignored and
    garbage-collected;
  * ranks: on a ``torch.distributed`` process group (``group=``) every rank
    writes its own ``proc_{rank}`` file, its shard of the state; rank 0
    writes the manifest and the marker after a barrier.  One process writes
    one file;
  * async: ``save(..., blocking=False)`` copies every tensor to host memory
    before it returns, and a writer thread does the file I/O.  The port
    updates parameters, moments and KV pools in place, so the copy must be
    complete before the caller's next step may touch them;
  * retention: the ``keep`` newest committed checkpoints survive GC.

Leaves are tensors in nested dicts and lists, keyed by the ``/``-joined
path of the JAX ``_flatten`` (dict keys, list indices).  A list of per-layer
trees under a key named ``layers`` (the port's model layout) is stored
stacked on a leading dim, as the JAX tree holds its layers, so the files of
both packages hold the same keys and shapes.  numpy has no bfloat16: bf16
leaves are stored as 2-byte raw data (numpy ``V2``), which the JAX
manager's void-dtype reinterpret reads back bit for bit, and a ``V2`` leaf
written by the JAX manager reads back here as ``uint16`` bits viewed as
bfloat16.

:meth:`CheckpointManager.restore` fills the template's tensors **in place**
and returns the template: at qwen3-1.7b a second copy of the training state
would cost another 20.6 GB of device memory.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time

import numpy as np
import torch

__all__ = ["CheckpointManager"]

_STEP_DIR_RE = re.compile(r"step_(\d+)")
_MARKER_RE = re.compile(r"step_(\d+)\.COMMITTED")
_LAYER_RE = re.compile(r"(.*/)?layers/(\d+)(/.*)?")

_NP_DTYPES = {torch.float64: np.float64, torch.float32: np.float32, torch.float16: np.float16,
              torch.int64: np.int64, torch.int32: np.int32, torch.int16: np.int16,
              torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_}


def _paths(tree, prefix=""):
    """``(key, leaf)`` of every tensor in ``tree``, dict keys in sorted order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _paths(sub, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _flatten(tree) -> dict:
    """``{key: tensor or [tensor per layer]}``: the JAX ``_flatten`` keys,
    with every ``layers`` list whose entries share keys, shapes and dtypes
    folded into one stacked leaf."""
    out: dict = {}
    stacks: dict = {}
    for key, leaf in _paths(tree):
        m = _LAYER_RE.fullmatch(key)
        if m is None:
            out[key] = leaf
        else:
            stacked = (m.group(1) or "") + "layers" + (m.group(3) or "")
            stacks.setdefault(stacked, {})[int(m.group(2))] = (key, leaf)
    for key, by_layer in stacks.items():
        n = len(by_layer)
        leaves = [by_layer[i][1] for i in range(n)] if set(by_layer) == set(range(n)) else []
        if leaves and all(t.shape == leaves[0].shape and t.dtype == leaves[0].dtype
                          for t in leaves):
            out[key] = leaves
        else:  # ragged layers: one key per layer, as the JAX flatten of a list
            out.update(dict(by_layer.values()))
    return out


def _to_host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (a tensor, or a list of per-layer tensors
    stacked on a leading dim), complete when this returns; bf16 as ``V2``."""
    layers = leaf if isinstance(leaf, list) else [leaf]
    t0 = layers[0].detach()
    bf16 = t0.dtype == torch.bfloat16
    dt = np.int16 if bf16 else _NP_DTYPES[t0.dtype]
    host = np.empty((len(layers),) + tuple(t0.shape), dt)
    for i, t in enumerate(layers):
        t = t.detach()
        torch.from_numpy(host[i, ...]).copy_(t.view(torch.int16) if bf16 else t)
    if not isinstance(leaf, list):
        host = host[0]
    return host.view("V2") if bf16 else host


def _dtype_name(leaf) -> str:
    t = leaf[0] if isinstance(leaf, list) else leaf
    return "bfloat16" if t.dtype == torch.bfloat16 else str(np.dtype(_NP_DTYPES[t.dtype]))


def _fill(dst: torch.Tensor, arr: np.ndarray) -> None:
    """Copy ``arr`` into ``dst``, reinterpreting 2-byte raw data as bf16
    bits and casting any other dtype mismatch."""
    if dst.dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Vui":
            raise ValueError(f"cannot read a {arr.dtype} leaf into bfloat16")
        src = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    else:
        want = np.dtype(_NP_DTYPES[dst.dtype])
        src = torch.from_numpy(np.ascontiguousarray(arr if arr.dtype == want
                                                    else arr.astype(want)))
    with torch.no_grad():
        dst.copy_(src.reshape(dst.shape))


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, group=None):
        """``group``: a ``torch.distributed`` process group whose ranks each
        save their own shard (``None``: one process)."""
        self.dir = directory
        self.keep = keep
        self.group = group
        if group is not None:
            import torch.distributed as dist

            self.rank, self.procs = dist.get_rank(group), dist.get_world_size(group)
        else:
            self.rank, self.procs = 0, 1
        if self.rank == 0:
            os.makedirs(directory, exist_ok=True)
        self._barrier()
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _barrier(self):
        if self.group is not None:
            import torch.distributed as dist

            dist.barrier(group=self.group)

    # ------------------------------------------------------------- save

    def save(self, step: int, tree, *, extra: dict | None = None, blocking: bool = True):
        """Snapshot ``tree`` (nested dicts and lists of tensors) at ``step``.

        The host copy is made before this returns, blocking or not; only the
        file I/O runs on the writer thread.  On a process group saves are
        collective and blocking (the commit waits on every rank's file)."""
        if self.group is not None and not blocking:
            raise ValueError("saves on a process group are collective: pass blocking=True")
        self.wait()  # one in-flight async save at a time
        flat = _flatten(tree)
        host = {k: _to_host(v) for k, v in flat.items()}
        manifest = {
            "step": step,
            "keys": sorted(host),
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "dtypes": {k: _dtype_name(flat[k]) for k in host},
            "extra": extra or {},
            "process_count": self.procs,
            "time": time.time(),
        }
        proc_file = f"proc_{self.rank:05d}.npz"

        if self.group is not None:
            path = self._step_dir(step)
            tmp = path + ".tmp"
            if self.rank == 0:
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp, exist_ok=True)
            self._barrier()
            np.savez(os.path.join(tmp, proc_file), **host)
            self._barrier()
            if self.rank == 0:
                self._commit(tmp, path, manifest)
            self._barrier()
            return

        def write():
            try:
                path = self._step_dir(step)
                tmp = path + ".tmp"
                shutil.rmtree(tmp, ignore_errors=True)
                os.makedirs(tmp, exist_ok=True)
                np.savez(os.path.join(tmp, proc_file), **host)
                self._commit(tmp, path, manifest)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if blocking:
            write()
            self.check()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def _commit(self, tmp: str, path: str, manifest: dict):
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        shutil.rmtree(path, ignore_errors=True)
        os.rename(tmp, path)
        open(path + ".COMMITTED", "w").close()
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        self.check()

    def check(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    def abandon(self):
        """Discard an in-flight or crashed async save without surfacing it:
        the writer thread is dropped, not joined; its tmp-dir output is swept
        by the next save's GC, and a half-landed write has no marker."""
        self._thread = None
        self._error = None

    # ---------------------------------------------------------- restore

    def latest_step(self) -> int | None:
        steps = []
        for name in os.listdir(self.dir):
            m = _MARKER_RE.fullmatch(name)
            if m is None:
                continue  # stray file: not ours to interpret
            step = int(m.group(1))
            if not os.path.isdir(self._step_dir(step)):
                continue  # orphaned marker
            steps.append(step)
        return max(steps) if steps else None

    def restore(self, step: int, template):
        """Fill ``template`` (the tree :meth:`save` took, or one of the same
        keys and shapes) in place from the checkpoint at ``step`` and return
        it.  A process of a group reads its own shard when the checkpoint
        was saved by as many ranks; otherwise every file is read.  A stacked
        ``layers`` leaf fills the template's per-layer tensors, so a
        checkpoint of the JAX tree restores into the port's layout."""
        path = self._step_dir(step)
        if not os.path.exists(path + ".COMMITTED"):
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        procs = self.manifest(step).get("process_count", 1)
        names = ([f"proc_{self.rank:05d}.npz"] if self.procs > 1 and procs == self.procs
                 else sorted(n for n in os.listdir(path) if n.endswith(".npz")))
        files = [np.load(os.path.join(path, n)) for n in names]
        try:
            where = {k: z for z in files for k in z.files}
            flat = _flatten(template)
            missing = sorted(k for k in flat if k not in where)
            if missing:
                raise ValueError(f"checkpoint missing keys: {missing[:5]} ...")
            for key, leaf in flat.items():
                arr = where[key][key]
                if isinstance(leaf, list):
                    for i, t in enumerate(leaf):
                        _fill(t, arr[i])
                else:
                    _fill(leaf, arr)
        finally:
            for z in files:
                z.close()
        return template

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self._step_dir(step), "manifest.json")) as f:
            return json.load(f)

    # --------------------------------------------------------------- gc

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:09d}")

    def _gc(self):
        committed = []
        for name in os.listdir(self.dir):
            full = os.path.join(self.dir, name)
            if name.endswith(".tmp"):
                shutil.rmtree(full, ignore_errors=True)
                continue
            m = _STEP_DIR_RE.fullmatch(name)
            if m is not None and os.path.isdir(full):
                if not os.path.exists(full + ".COMMITTED"):
                    shutil.rmtree(full, ignore_errors=True)  # uncommitted (crashed mid-save)
                else:
                    committed.append(int(m.group(1)))
                continue
            m = _MARKER_RE.fullmatch(name)
            if m is not None and not os.path.isdir(self._step_dir(int(m.group(1)))):
                try:
                    os.remove(full)  # orphaned marker
                except OSError:
                    pass
            # anything else in the directory is not ours: leave it alone
        for step in sorted(committed)[: -self.keep] if self.keep else []:
            # Marker first: a crash between the two deletes leaves an
            # uncommitted dir (swept next GC), never a marker pointing at
            # nothing.
            try:
                os.remove(self._step_dir(step) + ".COMMITTED")
            except OSError:
                pass
            shutil.rmtree(self._step_dir(step), ignore_errors=True)
