"""Checkpointing: one file per process, elastic restore (port of
``repro.checkpoint.store``).

The JAX module's layout:

    <dir>/step_000100/
        manifest.json         tree structure, shapes / dtypes, writer info
        host_00000.npz        the leaves, keyed "<leaf_idx>|<offset,...>"
        _COMMITTED            written last; a checkpoint without it is
                              ignored (atomic-commit marker)

Writes go to ``step_N.tmp``, which is renamed once ``_COMMITTED`` has
landed, so a failure mid-save never corrupts the latest checkpoint. Leaves
are indexed in ``jax.tree_util``'s order (:mod:`repro_torch.core.tree`)
and bf16 is stored as a ``u2`` view (numpy has no bf16; the manifest keeps
the true dtype), so for the same tree the keys and manifest fields are the
JAX writer's. A plain tensor is written whole by rank 0 (offsets all 0).
A DTensor is written shard per process: each rank writes the blocks it
holds (``host_<rank>.npz``) at their global offsets, one copy of a block
replicated over a mesh dim (the rank at coordinate 0 there writes it).

The commit goes by files, not collectives, so an async save's thread never
races the training step's collectives: each rank renames its finished
file into place, rank 0 waits for all of them, then writes the manifest
and ``_COMMITTED`` and renames the directory; the other ranks wait for
the commit before a synchronous save returns.

A restore pastes whatever blocks the files hold at their offsets into the
target's layout (elastic: another mesh, another placement, or whole
tensors on one process), so any saved topology restores onto any target
and a checkpoint of the JAX package's multi-host writer loads too.
``CheckpointManager.save_async`` copies the local blocks to host memory
at once and writes the files on a background thread; ``keep`` bounds how
many checkpoints stay on disk.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import dtensor as shard
from repro_torch.core import tree as tu

COMMIT_TIMEOUT_S = 600.0     # how long a rank waits for the others' files

# torch dtypes by the numpy name the manifest records, and back
_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
          torch.float16: "float16", torch.float64: "float64",
          torch.int32: "int32", torch.int64: "int64", torch.int16: "int16",
          torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}
_DTYPES = {name: dt for dt, name in _NAMES.items()}


def _host(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as a host numpy array safe for ``.npz`` (bf16 as its ``u2``
    view, as ``_numpy_safe`` stores ml_dtypes) and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        name = _NAMES[t.dtype]
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), name
        return t.numpy(), name
    a = np.asarray(leaf)
    if a.dtype.kind not in "biufc":
        return a.view(np.dtype(f"u{a.dtype.itemsize}")), str(a.dtype)
    return a, str(a.dtype)


class _Blocks:
    """One leaf as this rank writes it: its global shape and dtype name,
    and the (offsets, host array) blocks it owns (none for a replica)."""

    def __init__(self, shape, dtype: str, blocks):
        self.shape, self.dtype, self.blocks = tuple(shape), dtype, blocks


def _world() -> Tuple[int, int]:
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _leaf_blocks(leaf, rank: int, copy: bool) -> _Blocks:
    """``leaf``'s blocks this rank writes, in host memory (a copy of a
    host tensor's with ``copy``)."""
    if shard.is_dtensor(leaf):
        from repro_torch.launch import sharding as shd
        mesh = leaf.device_mesh
        spec = shd.from_placements(leaf.placements, mesh, leaf.ndim)
        coord = mesh.get_coordinate()
        names = tuple(mesh.mesh_dim_names)
        used = {a for e in spec for a in shd._names(e)}
        owner = all(c == 0 for c, n in zip(coord, names) if n not in used)
        arr, name = _host(leaf.to_local())
        arr = np.array(arr, copy=True) if copy else arr
        blocks = []
        if owner:
            sl = shd.local_slices(leaf.shape, spec, mesh, coord)
            blocks = [(tuple(x.start for x in sl), arr)]
        return _Blocks(leaf.shape, name, blocks)
    arr, name = _host(leaf)
    arr = np.array(arr, copy=True) if copy else arr
    return _Blocks(arr.shape, name, [((0,) * arr.ndim, arr)]
                   if rank == 0 else [])


def _snapshot(tree, copy: bool = False) -> Any:
    """Every leaf's own blocks in host memory (copied now with ``copy``:
    the async save's)."""
    rank, _ = _world()
    return tu.tree_map(lambda x: x if isinstance(x, _Blocks)
                       else _leaf_blocks(x, rank, copy), tree)


def _wait_for(what: str, ready) -> None:
    t0 = time.time()
    while not ready():
        if time.time() - t0 > COMMIT_TIMEOUT_S:
            raise TimeoutError(f"checkpoint commit: {what} did not appear "
                               f"in {COMMIT_TIMEOUT_S:.0f} s")
        time.sleep(0.05)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra_meta: Optional[Dict] = None) -> str:
    """Synchronous save, every rank of the default process group calling
    it (module docstring). Returns the committed directory path.

    An installed fault injector's ``ckpt_io`` spec (site ``checkpoint``)
    raises OSError before anything touches disk, as in the JAX module."""
    from repro_torch.runtime import faults as _faults
    _inj = _faults.active()
    if _inj is not None and _inj.ckpt_fails():
        raise OSError(f"injected checkpoint-write failure at step {step}")
    rank, world = _world()
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    shards_out: Dict[str, np.ndarray] = {}
    manifest_leaves = []
    for li, (path, leaf) in enumerate(tu.flatten_with_paths(
            _snapshot(tree))):
        manifest_leaves.append(dict(path=path, shape=list(leaf.shape),
                                    dtype=leaf.dtype))
        for off, arr in leaf.blocks:
            shards_out[f"{li}|{','.join(map(str, off))}"] = arr
    host = os.path.join(tmp, f"host_{rank:05d}.npz")
    with open(host + ".part", "wb") as f:
        np.savez(f, **shards_out)
    os.rename(host + ".part", host)
    if rank != 0:
        _wait_for(f"{final}/_COMMITTED", lambda: os.path.exists(
            os.path.join(final, "_COMMITTED")))
        return final
    _wait_for(f"{world} host files under {tmp}", lambda: all(
        os.path.exists(os.path.join(tmp, f"host_{r:05d}.npz"))
        for r in range(world)))
    manifest = dict(step=step, leaves=manifest_leaves,
                    treedef=tu.treedef_str(tree), n_processes=world,
                    extra=extra_meta or {})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    open(os.path.join(tmp, "_COMMITTED"), "w").close()
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def read_manifest(ckpt_dir: str, step: int) -> Dict:
    with open(os.path.join(ckpt_dir, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    best = None
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(ckpt_dir, name, "_COMMITTED")):
            best = max(best or -1, int(m.group(1)))
    return best


def _to_tensor(block: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(block, order="C").view(np.int16)
                                ).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(block, order="C")).to(dtype)


def restore_checkpoint(ckpt_dir: str, step: int, target: Any) -> Any:
    """Restore into ``target``'s structure: each leaf a tensor of the
    target leaf's shape and dtype, on its device; a DTensor leaf in its
    layout on its mesh (the elastic path), each rank reading only the
    blocks that meet its own."""
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    if not os.path.exists(os.path.join(d, "_COMMITTED")):
        raise FileNotFoundError(f"no committed checkpoint at {d}")
    hosts = sorted(f for f in os.listdir(d) if f.startswith("host_"))
    files = [np.load(os.path.join(d, h)) for h in hosts]
    index: Dict[int, List[Tuple[Tuple[int, ...], Any, str]]] = {}
    for f in files:
        for key in f.files:
            li_s, off_s = key.split("|")
            off = tuple(int(x) for x in off_s.split(",")) if off_s else ()
            index.setdefault(int(li_s), []).append((off, f, key))

    out_leaves = []
    for li, (path, leaf) in enumerate(tu.flatten_with_paths(target)):
        shape, dtype = tuple(leaf.shape), leaf.dtype
        if li not in index:
            raise KeyError(f"leaf {li} ({path}) missing from checkpoint")
        if shard.is_dtensor(leaf):
            out_leaves.append(_restore_dtensor(leaf, index[li]))
            continue
        blocks = [(off, _to_tensor(f[key], dtype))     # each read once
                  for off, f, key in index[li]]
        if len(blocks) == 1 and tuple(blocks[0][1].shape) == shape:
            host = blocks[0][1]
        else:                      # paste the shards at their offsets
            host = torch.zeros(shape, dtype=dtype)
            for off, block in blocks:
                host[tuple(slice(o, o + n) for o, n in
                           zip(off, block.shape))] = block
        out_leaves.append(host.to(leaf.device))
    return tu.unflatten(target, out_leaves)


def _restore_dtensor(leaf, saved) -> Any:
    """The target DTensor ``leaf``'s own block, pasted from the saved
    blocks that intersect it (``repro.checkpoint.store``'s ``make``)."""
    from repro_torch.launch import sharding as shd
    mesh = leaf.device_mesh
    spec = shd.from_placements(leaf.placements, mesh, leaf.ndim)
    sl = shd.local_slices(leaf.shape, spec, mesh, mesh.get_coordinate())
    starts = tuple(x.start for x in sl)
    stops = tuple(x.stop for x in sl)
    out = torch.zeros(tuple(b - a for a, b in zip(starts, stops)),
                      dtype=leaf.dtype)
    for off, f, key in saved:
        block = _to_tensor(f[key], leaf.dtype)
        lo = tuple(max(o, a) for o, a in zip(off, starts))
        hi = tuple(min(o + n, b) for o, n, b in
                   zip(off, block.shape, stops))
        if any(a >= b for a, b in zip(lo, hi)):
            continue
        src = tuple(slice(a - o, b - o) for a, o, b in zip(lo, off, hi))
        dst = tuple(slice(a - s0, b - s0) for a, s0, b in zip(lo, starts, hi))
        out[dst] = block[src]
    return shd.from_blocks(out.to(leaf.to_local().device), leaf.shape, spec,
                           mesh)


class CheckpointManager:
    """Async save + keep-last-k GC around the plain save/restore calls."""

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(ckpt_dir, exist_ok=True)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def save_async(self, step: int, tree: Any,
                   extra_meta: Optional[Dict] = None):
        """Snapshot to host memory now; write files on a background thread."""
        self.wait()
        snapshot = _snapshot(tree, copy=True)

        def work():
            save_checkpoint(self.dir, step, snapshot, extra_meta)
            self._gc()

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def save(self, step: int, tree: Any, extra_meta: Optional[Dict] = None):
        self.wait()
        save_checkpoint(self.dir, step, tree, extra_meta)
        self._gc()

    def restore_latest(self, target: Any,
                       expect_meta: Optional[Dict] = None
                       ) -> Tuple[Optional[int], Any]:
        """Restore the newest committed checkpoint. If ``expect_meta`` is
        given, any key present in both it and the saved manifest's extra
        metadata must match -- refusing to load a checkpoint from a
        different arch/run into this one."""
        self.wait()
        step = latest_step(self.dir)
        if step is None:
            return None, None
        if expect_meta:
            saved = read_manifest(self.dir, step).get("extra", {})
            for k, v in expect_meta.items():
                if k in saved and saved[k] != v:
                    raise ValueError(
                        f"checkpoint at step {step} has {k}={saved[k]!r}, "
                        f"this run expects {v!r} -- refusing to restore")
        return step, restore_checkpoint(self.dir, step, target)

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for m in
            (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(self.dir))
            if m)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)
