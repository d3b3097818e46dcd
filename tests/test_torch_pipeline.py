"""The port's GPipe stage loop (``repro_torch.launch.pipeline``) on the
CPU: gloo groups of 2 and 4 processes on a ``("stage",)`` mesh, each rank
one process running ``tests/_torch_mesh_worker.py ... pipeline``.

What they hold:

- JAX's own case (``tests/test_sharding_dryrun.py``: L = 8 tanh layers of
  D = 32, 6 micro-batches of 4, fp32) through ``pipeline_apply`` at S = 2
  and S = 4, and at world 4 on a (stage 2, data 2) mesh with the
  micro-batch rows split over ``data``: the output within 1e-5 and the
  gradient of sum(y^2) by the stacked weights within 1e-4 of the layers
  applied in turn in one process, and of the JAX ``pipeline_apply`` at S =
  4 (a 4-device subprocess), as JAX's test bounds its own;
- smoke gemma3-1b at 6 layers through ``pipeline_loss_fn`` over 2 stages
  (``transformer_stage_fns``: each stage's layers keep their global
  windows): loss within 1e-6 relative, every gradient leaf within 1e-5
  relative L2 of ``transformer.loss_fn`` on the whole batch;
- in one process: ``split_stages`` refuses an indivisible layer count,
  and at S = 1 the loop is the sequential loop bit for bit.
"""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_mesh_worker as worker
from _torch_gloo import REPO, run_group, start_groups
from repro_torch.launch import pipeline as pp


JAX_CODE = """
import sys
import numpy as np, jax, jax.numpy as jnp
from repro.launch.pipeline import pipeline_apply, split_stages
from repro.launch.mesh import activate_mesh, make_mesh
mesh = make_mesh((4,), ("stage",))
inp = np.load(sys.argv[1])
w, x = jnp.asarray(inp["w"]), jnp.asarray(inp["x"])

def stage_fn(wp, h):
    h, _ = jax.lax.scan(lambda h, wl: (jnp.tanh(h @ wl), None), h, wp)
    return h

def ploss(w_st, x):
    return jnp.sum(pipeline_apply(stage_fn, w_st, x, mesh=mesh) ** 2)

stages = split_stages(w, 4)
with activate_mesh(mesh):
    y = pipeline_apply(stage_fn, stages, x, mesh=mesh)
    g = jax.grad(ploss)(stages, x).reshape(w.shape)
np.savez(sys.argv[2], y=np.asarray(y), g=np.asarray(g))
"""
_JAX = {}


def _start_jax(tmp_path_factory):
    """Start (once) the JAX reference, ``pipeline_apply`` on 4 XLA
    devices on JAX's test case, where JAX is installed (the card machine
    has none: its runs deselect the ``jax`` tests)."""
    if "proc" in _JAX or importlib.util.find_spec("jax") is None:
        return
    d = tmp_path_factory.mktemp("pp_jax")
    w, x = worker.pp_inputs()
    np.savez(d / "in.npz", w=w, x=x)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               + os.environ.get("XLA_FLAGS", ""))
    _JAX["out"] = d / "out.npz"
    _JAX["proc"] = subprocess.Popen(
        [sys.executable, "-c", JAX_CODE, str(d / "in.npz"),
         str(d / "out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture
def groups(tmp_path_factory):
    """Both gloo groups (started side by side with the JAX reference)."""
    start_groups([(2, "pipeline"), (4, "pipeline")], tmp_path_factory)
    _start_jax(tmp_path_factory)
    return {w: run_group(w, tmp_path_factory, "pipeline") for w in (2, 4)}


@pytest.fixture
def jax_reference(tmp_path_factory):
    """(y, dL/dw) of the JAX ``pipeline_apply`` on 4 stages."""
    if "ref" not in _JAX:
        _start_jax(tmp_path_factory)
        if "proc" not in _JAX:
            pytest.fail("the JAX reference needs the jax package")
        log = _JAX["proc"].communicate(timeout=480)[0]
        assert _JAX["proc"].returncode == 0, log[-4000:]
        out = np.load(_JAX["out"])
        _JAX["ref"] = out["y"], out["g"]
    return _JAX["ref"]


def _hold(reading):
    assert reading["y_max_abs"] < 1e-5, reading
    assert reading["g_max_abs"] < 1e-4, reading


@pytest.mark.parametrize("world", [2, 4])
def test_stage_loop_matches_sequential(world, groups):
    ranks, _ = groups[world]
    for res in ranks:
        _hold(res["pipeline"]["stage"])


def test_stage_loop_on_a_stage_and_data_mesh(groups):
    ranks, _ = groups[4]
    for res in ranks:
        assert res["pipeline"]["mesh_3d"] == {
            "axes": ["stage", "data", "model"], "dp": 2, "tp": 1,
            "stage": 2}
        assert res["pipeline"]["stage_data"]["shape"] == [2, 2]
        _hold(res["pipeline"]["stage_data"])


@pytest.mark.parametrize("world,name", [(2, "pipeline"), (4, "pipeline"),
                                        (4, "pipeline_stage_data")])
def test_stage_loop_matches_jax(world, name, groups, jax_reference):
    _, out = groups[world]
    got = np.load(out / f"{name}.npz")
    y, g = jax_reference
    assert float(np.max(np.abs(got["y"] - y))) < 1e-5
    assert float(np.max(np.abs(got["g"] - g))) < 1e-4


def test_model_stages_keep_their_layers_windows(groups):
    ranks, _ = groups[2]
    for res in ranks:
        m = res["pipeline"]["model"]
        got, want = m["loss"]
        assert abs(got - want) <= 1e-6 * abs(want), m["loss"]
        worst = max(m["grad_rel"], key=m["grad_rel"].get)
        assert m["grad_rel"][worst] <= 1e-5, (worst, m["grad_rel"][worst])


def test_split_stages_refuses_an_indivisible_stack():
    tree = {"w": torch.zeros((6, 3)), "b": {"v": torch.zeros((6,))}}
    assert pp.split_stages(tree, 3)["b"]["v"].shape == (3, 2)
    with pytest.raises(ValueError, match="not divisible"):
        pp.split_stages(tree, 4)


class _OneStage:
    """A shape-only ``("stage",)`` mesh of one device."""
    axis_names = ("stage",)
    shape = {"stage": 1}


def test_one_stage_is_the_sequential_loop_bit_for_bit():
    w_np, x_np = worker.pp_inputs()
    w = torch.from_numpy(w_np).requires_grad_(True)
    st = pp.split_stages(w, 1)
    y = pp.pipeline_apply(worker.tanh_stage, st, torch.from_numpy(x_np),
                          mesh=_OneStage())
    (y ** 2).sum().backward()
    g = w.grad.clone()
    w.grad = None
    ref = torch.stack([worker.tanh_stage(w, xi)
                       for xi in torch.from_numpy(x_np)])
    (ref ** 2).sum().backward()
    assert torch.equal(y, ref)
    assert torch.equal(g, w.grad)


class _Mesh:
    """A shape-only mesh stand-in."""

    def __init__(self, **shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("shape,dp,tp", [
    (dict(stage=4), 1, 1),
    (dict(stage=2, data=4, model=2), 4, 2),
    (dict(data=2, model=8), 2, 8),
    (dict(pod=2, data=2, model=4), 4, 4)])
def test_axis_helpers_on_stage_meshes(shape, dp, tp):
    """The mesh helpers on pipeline meshes: ``stage`` is outside the data
    domain, and a mesh without ``data`` / ``model`` has one device along
    each."""
    from repro_torch.launch import mesh as mesh_lib
    mesh = _Mesh(**shape)
    assert mesh_lib.dp_size(mesh) == dp
    assert mesh_lib.tp_size(mesh) == tp
    assert "stage" not in mesh_lib.data_axes(mesh)
