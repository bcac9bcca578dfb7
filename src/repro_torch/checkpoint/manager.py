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

**FSDP state** (``repro_torch.sharding``; ``layout=``, the counterpart of
the reference's ``restore(..., shardings=)``): a one-process save of the
virtual mesh writes full arrays, as above; a group's save writes each
rank's blocks under the same keys, and the manifest records the saving
``mesh`` and each key's ``specs``.  :meth:`CheckpointManager.restore` with
the target's layout (its mesh and rank) fills each leaf's blocks from
whatever saved them: full arrays are cut, a group's blocks are assembled
from every rank's file and then cut for the target mesh.
"""

from __future__ import annotations

import json
import math
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


def _as_tensor(arr: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    """``arr`` as a CPU tensor of ``dtype``, reinterpreting 2-byte raw data
    as bf16 bits and casting any other dtype mismatch."""
    if dtype == torch.bfloat16:
        if arr.dtype.itemsize != 2 or arr.dtype.kind not in "Vui":
            raise ValueError(f"cannot read a {arr.dtype} leaf into bfloat16")
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    want = np.dtype(_NP_DTYPES[dtype])
    return torch.from_numpy(np.ascontiguousarray(arr if arr.dtype == want else arr.astype(want)))


def _fill(dst: torch.Tensor, arr: np.ndarray) -> None:
    """Copy ``arr`` into ``dst`` (:func:`_as_tensor`)."""
    with torch.no_grad():
        dst.copy_(_as_tensor(arr, dst.dtype).reshape(dst.shape))


def _spec_paths(specs, prefix=""):
    """``(key, spec)`` of every leaf of a spec tree (a spec is a tuple or
    ``None``), keyed as :func:`_paths` keys the tree it describes."""
    if isinstance(specs, dict):
        for k in sorted(specs):
            yield from _spec_paths(specs[k], f"{prefix}{k}/")
    elif isinstance(specs, list):
        for i, sub in enumerate(specs):
            yield from _spec_paths(sub, f"{prefix}{i}/")
    else:
        yield prefix[:-1], specs


def _flat_specs(flat: dict, specs) -> dict:
    """The spec of every key of ``_flatten(tree)``: a stacked ``layers`` key
    takes its layer 0's (the layers share shapes, so the rules give them
    one spec)."""
    per = dict(_spec_paths(specs))
    out = {}
    for key in flat:
        if key in per:
            out[key] = per[key]
        else:
            m = re.fullmatch(r"(.*/)?layers(/.*)?", key)
            out[key] = per[(m.group(1) or "") + "layers/0" + (m.group(2) or "")]
    return out


def _named(spec, mesh):
    from repro_torch.sharding import spec_axes

    return spec_axes(spec, mesh)


def _spec_json(spec):
    return None if spec is None else [list(e) if isinstance(e, tuple) else e for e in spec]


def _spec_from_json(spec):
    return None if spec is None else tuple(tuple(e) if isinstance(e, list) else e for e in spec)


def _full_on_host(tree, layout):
    """The full arrays of a virtual mesh's blocks, as CPU tensors (each
    assembled on its own device, one leaf at a time)."""
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.sharding import assemble_blocks, spec_leaves

    out = iter([x.detach().cpu().clone() if spec is None
                else assemble_blocks(x.detach(), spec, layout.mesh).cpu()
                for x, spec in zip(tree_leaves(tree), spec_leaves(layout.specs))])
    return tree_map(lambda _: next(out), tree)


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

    def save(self, step: int, tree, *, extra: dict | None = None, blocking: bool = True,
             layout=None):
        """Snapshot ``tree`` (nested dicts and lists of tensors) at ``step``.

        The host copy is made before this returns, blocking or not; only the
        file I/O runs on the writer thread.  On a process group saves are
        collective and blocking (the commit waits on every rank's file).
        ``layout``: the tree's FSDP layout (module docstring)."""
        if self.group is not None and not blocking:
            raise ValueError("saves on a process group are collective: pass blocking=True")
        self.wait()  # one in-flight async save at a time
        sharded = layout is not None and layout.rank is not None
        if layout is not None and not sharded:
            tree = _full_on_host(tree, layout)
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
        if sharded:
            manifest["mesh"] = {"axis_names": list(layout.mesh.axis_names),
                                "axis_sizes": list(layout.mesh.axis_sizes)}
            manifest["specs"] = {k: _spec_json(v) for k, v in _flat_specs(flat, layout.specs)
                                 .items()}
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

    def restore(self, step: int, template, *, layout=None):
        """Fill ``template`` (the tree :meth:`save` took, or one of the same
        keys and shapes) in place from the checkpoint at ``step`` and return
        it.  A process of a group reads its own shard when the checkpoint
        was saved by as many ranks; otherwise every file is read.  A stacked
        ``layers`` leaf fills the template's per-layer tensors, so a
        checkpoint of the JAX tree restores into the port's layout.
        ``layout``: the template's FSDP layout on the target mesh (module
        docstring); a checkpoint a group saved with its mesh restores onto
        any target."""
        path = self._step_dir(step)
        if not os.path.exists(path + ".COMMITTED"):
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        manifest = self.manifest(step)
        if "mesh" in manifest or layout is not None:
            return self._restore_sharded(path, manifest, template, layout)
        procs = manifest.get("process_count", 1)
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

    def _restore_sharded(self, path, manifest, template, layout):
        """:meth:`restore` across meshes: each key's full array (as saved, or
        assembled from every rank's blocks), cut to the target's blocks."""
        from repro_torch.launch.mesh import Mesh
        from repro_torch.sharding import assemble_blocks, block_index, cut_blocks

        saved = manifest.get("mesh")
        if saved is not None:
            mesh_s = Mesh(tuple(saved["axis_names"]), tuple(saved["axis_sizes"]))
            specs_s = {k: _spec_from_json(v) for k, v in manifest["specs"].items()}
        names = sorted(n for n in os.listdir(path) if n.endswith(".npz"))
        files = [np.load(os.path.join(path, n)) for n in names]
        try:
            flat = _flatten(template)
            missing = sorted(k for k in flat if k not in files[0].files)
            if missing:
                raise ValueError(f"checkpoint missing keys: {missing[:5]} ...")
            specs_t = _flat_specs(flat, layout.specs) if layout is not None else {}

            def full(key, layer):
                if saved is None:
                    arr = files[0][key]
                    return arr if layer is None else arr[layer]
                spec = specs_s[key]
                if spec is None:
                    arr = files[0][key]
                    return arr if layer is None else arr[layer]
                G = math.prod(mesh_s.shape[a] for a in _named(spec, mesh_s))
                owner = {}
                for r in range(mesh_s.size):
                    owner.setdefault(block_index(spec, mesh_s, r), r)
                parts = []
                for j in range(G):
                    arr = files[owner[j]][key]
                    parts.append((arr if layer is None else arr[layer])[0])
                return assemble_blocks(np.stack(parts), spec, mesh_s)

            def fill(dst, key, arr):
                """The target's blocks of ``arr``, cut on ``dst``'s device."""
                spec = specs_t.get(key)
                if spec is None:
                    return _fill(dst, arr)
                src = _as_tensor(arr, dst.dtype).to(dst.device)
                blocks = cut_blocks(src, spec, layout.mesh)
                if layout.rank is not None:
                    i = block_index(spec, layout.mesh, layout.rank)
                    blocks = blocks[i:i + 1]
                with torch.no_grad():
                    dst.copy_(blocks)

            for key, leaf in flat.items():
                if isinstance(leaf, list):
                    for i, t in enumerate(leaf):
                        fill(t, key, full(key, i))
                else:
                    fill(leaf, key, full(key, None))
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
