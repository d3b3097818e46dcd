"""Checkpointing, one process and one host file (port of
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
JAX writer's. One process writes every leaf whole (offsets all 0); a
restore pastes whatever shards the files hold at their offsets, so a
checkpoint of the JAX package's multi-host writer loads too.
``CheckpointManager.save_async`` copies the tensors to host memory at once
and writes the files on a background thread; ``keep`` bounds how many
checkpoints stay on disk.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import tree as tu

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


def _snapshot(tree) -> Any:
    """Every tensor leaf copied to host memory now (the async save's)."""
    return tu.tree_map(lambda x: x.detach().to("cpu", copy=True)
                       if isinstance(x, torch.Tensor) else np.asarray(x),
                       tree)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    extra_meta: Optional[Dict] = None) -> str:
    """Synchronous save. Returns the committed directory path.

    An installed fault injector's ``ckpt_io`` spec (site ``checkpoint``)
    raises OSError before anything touches disk, as in the JAX module."""
    from repro_torch.runtime import faults as _faults
    _inj = _faults.active()
    if _inj is not None and _inj.ckpt_fails():
        raise OSError(f"injected checkpoint-write failure at step {step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    shards_out: Dict[str, np.ndarray] = {}
    manifest_leaves = []
    for li, (path, leaf) in enumerate(tu.flatten_with_paths(tree)):
        arr, dtype = _host(leaf)
        manifest_leaves.append(dict(path=path, shape=list(arr.shape),
                                    dtype=dtype))
        shards_out[f"{li}|{','.join('0' * arr.ndim)}"] = arr
    np.savez(os.path.join(tmp, "host_00000.npz"), **shards_out)
    manifest = dict(step=step, leaves=manifest_leaves,
                    treedef=tu.treedef_str(tree), n_processes=1,
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
    target leaf's shape and dtype, on its device."""
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
        snapshot = _snapshot(tree)

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
