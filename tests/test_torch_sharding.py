"""The port's sharding rules and the sharded context's dispatch, with no
process group.

- ``param_specs``, ``opt_state_specs`` and ``decode_state_specs`` of
  ``repro_torch.launch.sharding`` equal the JAX package's
  ``PartitionSpec``s entry for entry, for every arch of the registry, on
  the (16, 16) and (2, 16, 16) production meshes. Both sides read a
  shape-only mesh stand-in (``tests/test_sharding_dryrun.py``'s
  ``_FakeMesh``).
- ``to_placements`` and ``from_placements`` round-trip on those specs.
- the sharded context splits the batch only where the data axes divide
  it, and otherwise hands the kernel whole operands (the unsharded call).
"""

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import sharding as jshd
from repro.launch import steps as jsteps

from repro_torch import configs as tconfigs
from repro_torch.core import tree as tu
from repro_torch.core.config import GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import sharding as tshd
from repro_torch.launch import steps as tsteps


class _FakeMesh:
    """Shape-only mesh stand-in for pure spec tests (no devices needed)."""

    def __init__(self, **axes):
        self.shape = dict(axes)
        self.axis_names = tuple(axes)


MESHES = {"16x16": dict(data=16, model=16),
          "2x16x16": dict(pod=2, data=16, model=16)}


def _jax_flat(tree):
    """[(path, spec entries)] of a JAX spec tree, paths as the port's."""
    out = []
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)
    )[0]:
        parts = []
        for p in path:
            if isinstance(p, jax.tree_util.DictKey):
                parts.append(str(p.key))
            elif isinstance(p, jax.tree_util.SequenceKey):
                parts.append(str(p.idx))
            else:
                parts.append(str(getattr(p, "name", p)))
        out.append(("/".join(parts), tuple(spec)))
    return out


def _port_flat(tree):
    return [(path, tuple(spec)) for path, spec in tu.flatten_with_paths(tree)]


_SHAPES = {}


def _shapes(arch):
    """(JAX param shapes, port param shapes on the meta device), once per
    arch."""
    if arch not in _SHAPES:
        _SHAPES[arch] = (jsteps.param_shapes(jconfigs.get(arch)),
                         tsteps.param_shapes(tconfigs.get(arch)))
    return _SHAPES[arch]


def test_registries_match():
    assert tconfigs.names() == jconfigs.names()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.names())
def test_param_and_opt_specs_equal_jax(arch, mesh_name):
    mesh = _FakeMesh(**MESHES[mesh_name])
    jshapes, tshapes = _shapes(arch)
    jp = _jax_flat(jshd.param_specs(jshapes, mesh))
    tp = _port_flat(tshd.param_specs(tshapes, mesh))
    assert tp == jp
    jo = jshd.opt_state_specs(jshapes, mesh)
    to = tshd.opt_state_specs(tshapes, mesh)
    for key in ("m", "v"):
        assert _port_flat(to[key]) == _jax_flat(jo[key])
    assert tuple(to["count"]) == tuple(jo["count"])


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", jconfigs.names())
def test_decode_state_specs_equal_jax(arch, mesh_name):
    mesh = _FakeMesh(**MESHES[mesh_name])
    jc, tc = jconfigs.get(arch), tconfigs.get(arch)
    for shape in jconfigs.shapes_for(arch):
        info = jsteps.SHAPES[shape]
        if info["kind"] != "decode":
            continue
        assert tsteps.SHAPES[shape] == info
        js = jshd.decode_state_specs(jc, mesh, info["batch"], info["seq"])
        ts = tshd.decode_state_specs(tc, mesh, info["batch"], info["seq"])
        for field in ("kv_k", "kv_v", "conv", "ssm", "pos"):
            j, t = getattr(js, field), getattr(ts, field)
            assert (t is None) == (j is None), (shape, field)
            if j is not None:
                assert tuple(t) == tuple(j), (shape, field)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_activation_specs_equal_jax(mesh_name):
    mesh = _FakeMesh(**MESHES[mesh_name])
    for arch in jconfigs.names():
        jc, tc = jconfigs.get(arch), tconfigs.get(arch)
        for batch, seq in ((256, 4096), (1, 524288), (48, 100)):
            assert tuple(tshd.residual_spec(tc, mesh, batch, seq)) == \
                tuple(jshd.residual_spec(jc, mesh, batch, seq))
            assert tuple(tshd.logits_spec(tc, mesh, batch)) == \
                tuple(jshd.logits_spec(jc, mesh, batch))
            for nd in (2, 3):
                assert tuple(tshd.tokens_spec(mesh, batch, nd)) == \
                    tuple(jshd.tokens_spec(mesh, batch, nd))
    assert tuple(tshd.batch_spec(mesh)) == tuple(jshd.batch_spec(mesh))
    assert tshd.data_axis(mesh) == jshd.data_axis(mesh)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ["gemma3-1b", "llava-next-34b",
                                  "granite-moe-3b-a800m", "hymba-1.5b",
                                  "musicgen-medium"])
def test_placements_round_trip(arch, mesh_name):
    """spec -> placements -> spec is the identity (trailing replicated
    dims spelled out), and a dim over ("pod", "data") is Shard on both
    mesh dims, major to minor."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _FakeMesh(**MESHES[mesh_name])
    _, tshapes = _shapes(arch)
    trees = [tshd.param_specs(tshapes, mesh)] + \
        list(tshd.opt_state_specs(tshapes, mesh).values())[:2]
    leaves = dict(tu.flatten_with_paths(tshapes))
    n = 0
    for tree in trees:
        for path, spec in tu.flatten_with_paths(tree):
            ndim = leaves[path].dim()
            pl = tshd.to_placements(spec, mesh)
            assert len(pl) == len(mesh.axis_names)
            back = tshd.from_placements(pl, mesh, ndim)
            want = tuple(spec) + (None,) * (ndim - len(spec))
            assert tuple(back) == want, (path, spec, pl)
            n += 1
    assert n
    if "pod" in mesh.axis_names:
        pl = tshd.to_placements(tshd.P(("pod", "data"), None), mesh)
        assert pl == (Shard(0), Shard(0), Replicate())
        with pytest.raises(ValueError):
            tshd.to_placements(tshd.P(("data", "pod")), mesh)


def test_local_slices_cover_and_refuse_uneven():
    mesh = _FakeMesh(pod=2, data=2, model=3)
    spec = tshd.P(("pod", "data"), "model")
    seen = torch.zeros((8, 6), dtype=torch.int32)
    for p in range(2):
        for d in range(2):
            for m in range(3):
                sl = tshd.local_slices((8, 6), spec, mesh, (p, d, m))
                seen[sl] += 1
                assert sl[0] == slice((p * 2 + d) * 2, (p * 2 + d) * 2 + 2)
    assert bool((seen == 1).all())
    with pytest.raises(ValueError):
        tshd.local_slices((6, 6), spec, mesh, (0, 0, 0))


@pytest.mark.parametrize("rows,split", [(8, True), (4, True), (6, False),
                                        (2, False)])
def test_sharded_ctx_splits_only_where_the_batch_divides(rows, split):
    """The layout the sharded context hands a kernel: dim 0 of the
    batched operands over ``data`` (4 devices) where 4 divides it, else
    every operand whole (the unsharded call); whole operands' gradients
    leave as partial sums over ``data`` only when the rows split."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = _FakeMesh(data=4, model=2)
    ctx = ExecutionContext(cfg=GemminiConfig()).with_mesh(mesh, "data")
    assert ctx.sharded and ctx.n_shards == 4
    assert ctx.unsharded().mesh is None and not ctx.unsharded().sharded
    a = torch.empty((rows, 8), device="meta")
    w = torch.empty((8, 16), device="meta")
    _, layouts, out_rows, partial = ctx._layout((a, w, None),
                                                (True, False, True))
    whole = (Replicate(), Replicate())
    if split:
        assert layouts[0] == (Shard(0), Replicate()) == out_rows
        assert partial == (Partial(), Replicate())
    else:
        assert layouts[0] == whole == out_rows and partial == whole
    assert layouts[1] == whole


def test_ctx_axis_must_be_a_mesh_axis():
    with pytest.raises(ValueError):
        ExecutionContext(mesh=_FakeMesh(data=2, model=2), axis="pod")
    ctx = ExecutionContext(mesh=_FakeMesh(pod=2, data=2, model=2),
                           axis=("pod", "data"))
    assert ctx.n_shards == 4


def test_plain_tensors_pass_through_a_sharded_ctx():
    """With no DTensor operand a sharded context runs the op as is: the
    tensors are the rank's own."""
    ctx = ExecutionContext(cfg=GemminiConfig(input_dtype="fp32",
                                             acc_dtype="fp32",
                                             output_dtype="fp32"))
    g = torch.Generator().manual_seed(0)
    a = torch.randn((6, 8), generator=g)
    b = torch.randn((8, 5), generator=g)
    d = torch.randn((1, 5), generator=g)
    want = ctx.gemm(a, b, d)
    got = ctx.with_mesh(_FakeMesh(data=4, model=1)).gemm(a, b, d)
    assert torch.equal(got, want)


def test_mesh_helpers_read_a_shape_only_mesh():
    mesh = _FakeMesh(pod=2, data=16, model=16)
    assert tmesh.data_axes(mesh) == ("pod", "data")
    assert tmesh.dp_size(mesh) == 32 and tmesh.tp_size(mesh) == 16
    assert tmesh.production_shape(multi_pod=True) == \
        ((2, 16, 16), ("pod", "data", "model"))
    with tmesh.activate_mesh(mesh):
        assert tmesh.current_mesh() is mesh
        assert tmesh.data_axes() == ("pod", "data") and tmesh.tp_size() == 16
    assert tmesh.current_mesh() is None
    with pytest.raises(ValueError):
        tmesh.data_axes()
