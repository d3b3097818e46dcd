"""The port's checkpoint store against the JAX package's, on the CPU.

Every restore is bit for bit; for the same numpy tree the port writes the
JAX writer's ``.npz`` keys and arrays and its manifest fields, and each
restores the other's checkpoint.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.launch.steps import TrainState as JTrainState

from repro_torch import configs as tconfigs
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core import tree as tu
from repro_torch.launch import steps as tsteps
from repro_torch.runtime import faults as tfaults


def _np_tree(rng):
    return {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b16": rng.standard_normal((4, 4)).astype(np.float32),
            "i": rng.integers(0, 100, (5,)).astype(np.int32),
            "nested": {"scale": np.asarray(1.5, np.float32),
                       "list": [rng.standard_normal((3,)).astype(
                           np.float32)]}}


def _torch(tree):
    def conv(path, leaf):
        t = torch.from_numpy(np.array(leaf))
        return t.to(torch.bfloat16) if path == "b16" else t
    return tu.unflatten(tree, [conv(p, x)
                               for p, x in tu.flatten_with_paths(tree)])


def _jax(tree):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.asarray(
            x, jnp.bfloat16 if path[0].key == "b16" else x.dtype), tree)


def _equal(a, b):
    la, lb = tu.leaves(a), tu.leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_roundtrip_bit_exact(tmp_path):
    tree = _torch(_np_tree(np.random.default_rng(0)))
    path = save_checkpoint(str(tmp_path), 7, tree, extra_meta={"arch": "x"})
    assert path == os.path.join(str(tmp_path), "step_00000007")
    assert latest_step(str(tmp_path)) == 7
    target = tu.tree_map(torch.zeros_like, tree)
    _equal(restore_checkpoint(str(tmp_path), 7, target), tree)


def test_uncommitted_checkpoints_are_ignored(tmp_path):
    """The atomic commit: a torn save (a ``.tmp`` directory, or a step
    directory without ``_COMMITTED``) is never the latest, and restoring
    it raises."""
    tree = _torch(_np_tree(np.random.default_rng(1)))
    save_checkpoint(str(tmp_path), 3, tree)
    os.makedirs(tmp_path / "step_00000009.tmp")
    (tmp_path / "step_00000009.tmp" / "host_00000.npz").write_bytes(b"x")
    os.makedirs(tmp_path / "step_00000011")
    assert latest_step(str(tmp_path)) == 3
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path), 11, tree)
    step, got = CheckpointManager(str(tmp_path)).restore_latest(tree)
    assert step == 3
    _equal(got, tree)


def test_manager_async_save_keep_and_restore(tmp_path):
    """Four async saves and a sync one with ``keep=2``: the last two stay;
    the async snapshot is taken at the call (later in-place edits of the
    tensors do not reach the file), and the restore is bit for bit."""
    tree = _torch(_np_tree(np.random.default_rng(2)))
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save_async(s, tree, extra_meta={"arch": "a"})
    snap = tu.tree_map(torch.clone, tree)
    tree["w"].add_(1.0)                       # after the last async save
    mgr.wait()
    steps = sorted(int(n.split("_")[1]) for n in os.listdir(tmp_path))
    assert steps == [3, 4]
    step, got = mgr.restore_latest(tu.tree_map(torch.zeros_like, tree),
                                   expect_meta={"arch": "a"})
    assert step == 4
    _equal(got, snap)
    with pytest.raises(ValueError, match="refusing to restore"):
        mgr.restore_latest(tree, expect_meta={"arch": "b"})
    mgr.save(5, tree)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


def test_files_and_manifest_equal_the_jax_writer(tmp_path):
    """The same numpy tree (a bf16 leaf among fp32 / int32 ones, a 0-d
    leaf, a list) through both writers: the ``.npz`` keys and arrays and
    every manifest field are equal, and each side restores the other's."""
    nt = _np_tree(np.random.default_rng(3))
    tree_t, tree_j = _torch(nt), _jax(nt)
    save_checkpoint(str(tmp_path / "t"), 5, tree_t, extra_meta={"arch": "m"})
    jsave(str(tmp_path / "j"), 5, tree_j, extra_meta={"arch": "m"})
    ft = np.load(tmp_path / "t" / "step_00000005" / "host_00000.npz")
    fj = np.load(tmp_path / "j" / "step_00000005" / "host_00000.npz")
    assert sorted(ft.files) == sorted(fj.files)
    for key in fj.files:
        assert ft[key].dtype == fj[key].dtype, key
        np.testing.assert_array_equal(ft[key], fj[key])
    mt, mj = (json.loads((tmp_path / w / "step_00000005" /
                          "manifest.json").read_text()) for w in "tj")
    assert mt == mj
    assert sorted(os.listdir(tmp_path / "t" / "step_00000005")) == \
        sorted(os.listdir(tmp_path / "j" / "step_00000005"))

    # the port restores the JAX writer's checkpoint, and the other way
    got = restore_checkpoint(str(tmp_path / "j"), 5,
                             tu.tree_map(torch.zeros_like, tree_t))
    _equal(got, tree_t)
    dev = jax.devices()[0]
    shard = jax.sharding.SingleDeviceSharding(dev)
    back = jrestore(str(tmp_path / "t"), 5, jax.tree.map(
        lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), tree_j),
        jax.tree.map(lambda _: shard, tree_j))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree_j)):
        assert a.dtype == b.dtype and bool(jnp.all(a == b))


def test_train_state_layout_equals_jax(tmp_path):
    """A ``TrainState`` (a NamedTuple of params, AdamW state and step):
    the leaf order, paths and tree structure the JAX writer records."""
    cfg = tconfigs.get_smoke("gemma3-1b")
    state = tsteps.init_train_state(cfg, seed=0, device="cpu")
    save_checkpoint(str(tmp_path), 1, state)
    man = json.loads((tmp_path / "step_00000001" /
                      "manifest.json").read_text())
    jstate = JTrainState(*(tu.tree_map(
        lambda t: np.zeros(t.shape, np.float32), part)
        for part in state))
    flat = jax.tree_util.tree_flatten_with_path(jstate)[0]
    want = ["/".join(str(getattr(k, "key", getattr(k, "name", k)))
                     for k in path) for path, _ in flat]
    assert [leaf["path"] for leaf in man["leaves"]] == want
    assert man["treedef"] == str(jax.tree_util.tree_structure(jstate))
    assert man["leaves"][0]["dtype"] == "bfloat16"       # params/blocks/...
    got = restore_checkpoint(str(tmp_path), 1, tu.tree_map(
        torch.zeros_like, state))
    _equal(got, state)


def test_injected_write_failure_touches_nothing(tmp_path):
    """An installed injector's ``ckpt_io`` spec raises OSError before any
    file is written, as in the JAX store."""
    tfaults.install("ckpt_io@checkpoint:max=1")
    try:
        with pytest.raises(OSError, match="injected"):
            save_checkpoint(str(tmp_path), 2, {"w": torch.ones(2)})
    finally:
        tfaults.deactivate()
    assert os.listdir(tmp_path) == []
