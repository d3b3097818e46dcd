"""The sharded port on the CPU: gloo groups of 2 processes (mesh (2, 1))
and 4 (mesh (2, 2)), each rank one process running
``tests/_torch_mesh_worker.py``.

What they hold, sharded against one process on the same inputs (smoke
gemma3-1b in fp32, the fp32 engine):

- two sharded train steps (and, at world 2, of smoke mamba2-1.3b and
  granite-moe-3b-a800m): the loss and every gradient leaf within 1e-6
  relative L2 (the data-parallel sums add in another order), the updated
  parameters within 5e-2 of the update's bound 2 lr (1 + wd |w|) as
  ``chip_smoke.py`` phase 13 holds them (AdamW turns rounding noise in a
  near-zero gradient into a step of about lr); AdamW's m in its ZeRO-1
  layout (sharded over ``data``);
- every op of the sharded context against the unsharded call: the int8
  GEMM and conv bit for bit, the float ops within 1e-6 of the largest
  magnitude; a batch the data axis does not divide runs whole, and dense
  decode and paged prefill (never split) run on whole operands;
- ``make_global_batch`` against ``make_batch``, each rank holding its
  rows;
- the ops repaired for torch 2.11 (ROADMAP C9) on DTensors split along
  their dim, bit for bit the plain ops;
- the elastic restore (world 4): saved on (4, 1) and restored onto
  (1, 4), saved on (2, 2) and restored onto (2, 2) in another layout, and
  both onto whole tensors, bit for bit.

Since the grouped MoE dispatch and micro-batches under a mesh:

- ``moe_apply`` on DTensors at world 4 on (2, 2) with JAX's shapes (4 x 16
  x 16, 4 experts, top-2, capacity factor 64; fp32): grouped against
  ungrouped within 1e-4 (``tests/test_perf_flags.py``'s bound), their
  gradients within 1e-5 relative L2, and the grouped output within 1e-5
  of the JAX module's grouped dispatch on a (2, 2) mesh of four XLA
  devices; two grouped train steps of smoke granite-moe-3b-a800m against
  the one-process steps grouped alike, within the bounds above;
- a world-2 sharded ``grad_accum=2`` step against the one-process
  ``grad_accum=2`` step (the bounds above) and against the JAX step
  (``repro.launch.steps.make_train_step(grad_accum=2)``): loss within
  2e-6 relative, gradient norm 1e-5, parameters 5e-2 of the update's
  bound. The JAX step splits the global rows, each rank here its own:
  the mean over micro-batches of as many rows is the same function.

Hangs: the rendezvous is a ``FileStore`` under ``tmp_path``, collectives
time out after 60 s, and every child is joined with a deadline after
which the test kills the group and fails (``tests/_torch_gloo.py``).
"""

import dataclasses
import json

import numpy as np
import pytest

import _torch_mesh_worker as worker
from _torch_gloo import run_group, start_groups


def _run_group(world: int, tmp_path_factory):
    start_groups([(2, "mesh"), (4, "mesh")], tmp_path_factory)
    return run_group(world, tmp_path_factory)


def _hold_train(tr):
    s, r = tr["loss0"]
    assert abs(s - r) <= 1e-6 * abs(r)
    worst = max(tr["grad_rel"], key=tr["grad_rel"].get)
    assert tr["grad_rel"][worst] <= 1e-6, (worst, tr["grad_rel"][worst])
    for sl, rl, sg, rg in tr["steps"]:
        assert abs(sl - rl) <= 1e-6 * abs(rl)
        assert abs(sg - rg) <= 1e-6 * abs(rg)
    gap = max(tr["param_gap"], key=tr["param_gap"].get)
    assert tr["param_gap"][gap] <= 5e-2, (gap, tr["param_gap"][gap])
    # ZeRO-1: every m leaf is sharded over the data axis somewhere
    # (smoke widths all divide)
    assert all(pl[0].startswith("S(")
               for pl in tr["m_layouts"].values()), tr["m_layouts"]


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_train_step_matches_one_process(world, tmp_path_factory):
    ranks, _ = _run_group(world, tmp_path_factory)
    for res in ranks:
        _hold_train(res["train"])
    assert len({json.dumps(r["train"]["steps"]) for r in ranks}) == 1


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "granite-moe-3b-a800m"])
def test_sharded_train_step_recurrent_and_moe(arch, tmp_path_factory):
    """The same holds for the Mamba-2 and MoE blocks (world 2)."""
    ranks, _ = _run_group(2, tmp_path_factory)
    for res in ranks:
        _hold_train(res["train_families"][arch])


@pytest.mark.parametrize("world", [2, 4])
def test_sharded_ctx_ops_match_unsharded_call(world, tmp_path_factory):
    ranks, _ = _run_group(world, tmp_path_factory)
    for res in ranks:
        ops = res["ops"]
        assert len(ops) == 10, sorted(ops)
        for name, err in ops.items():
            limit = 0.0 if "int8" in name else 1e-6
            assert err <= limit, (name, err)


@pytest.mark.parametrize("world", [2, 4])
def test_global_batch_matches_make_batch(world, tmp_path_factory):
    ranks, _ = _run_group(world, tmp_path_factory)
    for res in ranks:
        b = res["batch"]
        assert b["tokens"] and b["labels"] and b["extra_embeds"], b
        assert b["tokens_local_rows"] == 8 // 2


@pytest.mark.parametrize("case", ["4x1_to_1x4", "2x2_to_2x2"])
def test_elastic_restore_onto_another_mesh(case, tmp_path_factory):
    ranks, _ = _run_group(4, tmp_path_factory)
    for res in ranks:
        el = res["elastic"][case]
        assert el["equal"] and el["layout_kept"] and el["plain_equal"], el
        assert el["files"] == ["_COMMITTED", "host_00000.npz",
                               "host_00001.npz", "host_00002.npz",
                               "host_00003.npz", "manifest.json"]


@pytest.mark.parametrize("world", [2, 4])
def test_repaired_ops_on_dtensors(world, tmp_path_factory):
    """ROADMAP C9: the pad, the cumulative sum and the MoE's scatter and
    gather through ``core.dtensor.local_along`` / ``replicated_call`` on
    DTensors split along the op's dim, bit for bit the plain ops (the
    ops torch 2.11's DTensor cannot propagate)."""
    ranks, _ = _run_group(world, tmp_path_factory)
    for res in ranks:
        assert res["repaired"] == {"pad": True, "cumsum": True,
                                   "scatter": True, "gather": True}


def _jax_grouped_moe(run_subprocess, tmp_path):
    """The JAX module's grouped dispatch on a (2, 2) mesh of four XLA
    devices, on ``worker.moe_inputs()`` (fp32 engine)."""
    p, x = worker.moe_inputs()
    src, dst = tmp_path / "moe_in.npz", tmp_path / "moe_jax.npy"
    np.savez(src, x=x, **p)
    run_subprocess(f"""
import numpy as np, jax, jax.numpy as jnp
from repro.core import flags
from repro.core.config import GemminiConfig
from repro.core.generator import elaborate
from repro.launch.mesh import activate_mesh, make_mesh
from repro.models import moe
engine = elaborate(GemminiConfig(input_dtype="fp32", acc_dtype="fp32",
                                 output_dtype="fp32"), "xla")
d = np.load({str(src)!r})
p = {{k: jnp.asarray(d[k]) for k in ("router", "wi", "wg", "wo")}}
mesh = make_mesh((2, 2), ("data", "model"))
with activate_mesh(mesh):
    flags.set_flag("moe_grouped_dispatch", 1)
    y = jax.jit(lambda p, x: moe.moe_apply(
        engine, p, x, **{worker.MOE_KW!r}))(p, jnp.asarray(d["x"]))
np.save({str(dst)!r}, np.asarray(y))
""", n_devices=4)
    return np.load(dst)


def test_grouped_dispatch_matches_ungrouped(tmp_path_factory):
    ranks, _ = _run_group(4, tmp_path_factory)
    for res in ranks:
        mg = res["moe_grouped"]
        assert mg["y_max_abs"] < 1e-4, mg
        assert max(mg["grad_rel"].values()) <= 1e-5, mg


def test_grouped_dispatch_matches_jax(tmp_path_factory, run_subprocess,
                                      tmp_path):
    _, out = _run_group(4, tmp_path_factory)
    got = np.load(out / "moe_grouped.npz")["y"]
    want = _jax_grouped_moe(run_subprocess, tmp_path)
    assert float(np.max(np.abs(got - want))) < 1e-5


def test_grouped_granite_train_step_matches_one_process(tmp_path_factory):
    ranks, _ = _run_group(4, tmp_path_factory)
    for res in ranks:
        _hold_train(res["train_grouped"])


def _jax_tree(flat, prefix):
    """Nested dict of jnp arrays from ``prefix + "a/b/c"`` npz keys."""
    import jax.numpy as jnp
    tree = {}
    for key in flat.files:
        if not key.startswith(prefix):
            continue
        *path, leaf = key[len(prefix):].split("/")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(flat[key])
    return tree


def test_sharded_grad_accum_step_matches_one_process(tmp_path_factory):
    ranks, _ = _run_group(2, tmp_path_factory)
    for res in ranks:
        _hold_train(res["train_accum"])


def test_sharded_grad_accum_step_matches_jax(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from repro import configs as jconfigs
    from repro.core.config import GemminiConfig as JConfig
    from repro.core.generator import elaborate
    from repro.launch import steps as jsteps
    from repro.launch.mesh import make_mesh as jmesh
    from repro.optim import adamw as jadamw
    _, out = _run_group(2, tmp_path_factory)
    d = np.load(out / "accum.npz")
    jc = dataclasses.replace(jconfigs.get_smoke("gemma3-1b"),
                             dtype=jnp.float32)
    engine = elaborate(JConfig(input_dtype="fp32", acc_dtype="fp32",
                               output_dtype="fp32"), "xla")
    params = _jax_tree(d, "init/")
    opt = jadamw.AdamWConfig(lr=worker.LR)
    toks = jnp.asarray(d["tokens"])
    step = jax.jit(jsteps.make_train_step(
        engine, jc, opt, jmesh((1, 1), ("data", "model")), *toks.shape,
        grad_accum=2))
    state, metrics = step(jsteps.TrainState(params, jadamw.adamw_init(params),
                                            jnp.zeros((), jnp.int32)),
                          {"tokens": toks, "labels": toks})
    assert abs(float(d["loss"]) - float(metrics["loss"])) <= \
        2e-6 * abs(float(metrics["loss"]))
    assert abs(float(d["grad_norm"]) - float(metrics["grad_norm"])) <= \
        1e-5 * abs(float(metrics["grad_norm"]))
    old = jax.tree_util.tree_leaves_with_path(params)
    new = dict(jax.tree_util.tree_leaves_with_path(state.params))
    for path, w in old:
        key = "step/" + "/".join(k.key for k in path)
        bound = 2 * worker.LR * (1 + opt.weight_decay * np.abs(w))
        gap = np.max(np.abs(d[key] - np.asarray(new[path])) / bound)
        assert gap <= 5e-2, (key, gap)

