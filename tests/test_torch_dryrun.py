"""The port's cost count (``repro_torch.analysis.cost``) and dry run
(``repro_torch.launch.dryrun``) on the CPU, on a ``fake`` process group.

- the count against hand-counted graphs, as ``tests/test_hlo_analysis.py``
  holds the HLO count: a matmul, a batched ``einsum``, an all-reduce's
  bytes counted twice, zero-sized operands;
- a DTensor matmul on a fake (16, 16) mesh counts one device's FLOPs, not
  the 256 devices' (``FlopCounterMode``, above DTensor, counts the
  latter: kept as ``logical_flops``);
- a miniature dry run of the smoke gemma3-1b on a (2, 4) mesh and on
  (1, 1), a train cell and a decode cell: no device counts more FLOPs
  than the (1, 1) cell, the devices together at least as many (sharding
  splits or repeats work, never loses it), the row's replication factor
  is (per-device x devices) / logical, and collectives move bytes on
  (2, 4) and none on (1, 1); the same bounds for a Mamba-2 and a MoE
  train cell and a hybrid decode cell.
"""

import json

import pytest
import torch
import torch.distributed as dist
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import cost
from repro_torch.launch import dryrun


@pytest.fixture(scope="module", autouse=True)
def _no_group_left_behind():
    """The dry run starts fake process groups; none outlives the module
    (a checkpoint save would read its world size)."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_matmul_flops_and_bytes():
    a = torch.randn(512, 256)
    b = torch.randn(256, 128)
    with cost.count() as c:
        a @ b
    assert c.report.flops == 2 * 512 * 256 * 128
    io = (512 * 256 + 256 * 128 + 512 * 128) * 4
    assert io <= c.report.bytes <= 2 * io
    assert c.report.coll_bytes == 0


def test_batched_einsum_flops():
    a = torch.randn(4, 64, 32)
    b = torch.randn(4, 32, 16)
    with cost.count() as c:
        torch.einsum("bij,bjk->bik", a, b)
    assert c.report.flops == 2 * 4 * 64 * 32 * 16


def test_zero_sized_operands():
    a = torch.zeros((0, 128))
    b = torch.randn(128, 64)
    with cost.count() as c:
        torch.tanh(a @ b)
    assert c.report.flops == 0.0
    assert c.report.bytes == 128 * 64 * 4      # b read by the product


def test_all_reduce_counted_twice():
    import torch.distributed._functional_collectives as funcol
    mesh = dryrun.fake_mesh((2, 4), ("data", "model"))
    x = torch.randn(1000)
    with cost.count(mesh) as c:
        y = funcol.all_reduce(x, "sum", (mesh, 1))
        funcol.wait_tensor(funcol.all_gather_tensor(y, 0, (mesh, 0)))
    rep = c.report
    assert rep.coll_breakdown["all-reduce"] == 2 * 4000
    assert rep.coll_breakdown["all-gather"] == 2 * 4000
    assert rep.coll_by_axis == {"model": 8000, "data": 8000}
    assert rep.coll_counts == {"all-reduce": 1, "all-gather": 1}


def test_collectives_named_by_ranks_not_group_name():
    """A collective on the group of another mesh of the same layout (as
    DTensor issues when it reuses a plan cached for an earlier mesh) is
    kept under the axis its ranks span, not the group's name."""
    import torch.distributed._functional_collectives as funcol
    first = dryrun.fake_mesh((2, 4), ("data", "model"))
    mesh = dryrun.fake_mesh((2, 4), ("data", "model"))
    assert first.get_group(1).group_name != mesh.get_group(1).group_name
    x = torch.randn(1000)
    with cost.count(mesh) as c:
        funcol.wait_tensor(funcol.all_gather_tensor(x, 0, (first, 1)))
        funcol.wait_tensor(funcol.all_gather_tensor(x, 0, (first, 0)))
    assert c.report.coll_by_axis == {"model": 4 * 4000, "data": 2 * 4000}


def test_dtensor_matmul_counts_one_device():
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = dryrun.fake_mesh((16, 16), ("data", "model"))
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(4096, 2048), mesh,
                              [Shard(0), Replicate()])
        w = distribute_tensor(torch.empty(2048, 8192), mesh,
                              [Replicate(), Shard(1)])
        with FlopCounterMode(display=False) as above:
            x @ w
        with cost.count(mesh) as c:
            x @ w
    logical = 2 * 4096 * 2048 * 8192
    assert above.get_total_flops() == logical
    assert c.report.logical_flops == logical
    assert c.report.flops == logical / 256


@pytest.fixture(scope="module")
def mini_rows():
    rows = {}
    for shape in ("train_4k", "decode_32k"):
        for ms in ((2, 4), (1, 1)):
            rows[shape, ms] = dryrun.run_cell(
                "gemma3-1b", shape, mesh_shape=ms, smoke=True, batch=8,
                seq=64, verbose=False)
    return rows


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_mini_dry_run_splits_or_repeats_never_loses(shape, mini_rows):
    one = mini_rows[shape, (1, 1)]
    row = mini_rows[shape, (2, 4)]
    assert row["kind"] == one["kind"]
    assert row["flops"] > 0 and row["bytes"] > 0
    assert row["flops"] <= one["flops"]
    assert row["flops"] * 8 >= one["flops"]
    assert one["replication"] == pytest.approx(1.0)
    assert row["replication"] == pytest.approx(
        row["flops"] * 8 / row["logical_flops"])
    assert 1.0 <= row["replication"] <= 8.0
    assert row["coll_bytes"] > 0 and one["coll_bytes"] == 0
    assert row["argument_bytes"] < one["argument_bytes"]
    for key in ("t_compute", "t_memory", "t_collective", "bottleneck"):
        assert key in row


def test_train_cell_shards_the_data_and_zero1(mini_rows):
    """The train step splits the batch over ``data`` (its products do
    half the (1, 1) FLOPs on each device, every model rank the same), and
    its ZeRO-1 update reduce-scatters the gradients."""
    one = mini_rows["train_4k", (1, 1)]
    row = mini_rows["train_4k", (2, 4)]
    assert row["logical_flops"] == pytest.approx(one["flops"], rel=1e-9)
    assert row["flops"] == pytest.approx(one["flops"] / 2, rel=1e-9)
    assert row["coll_breakdown"]["reduce-scatter"] > 0
    assert row["coll_breakdown"]["all-gather"] > 0


def test_save_row(mini_rows, tmp_path):
    row = mini_rows["decode_32k", (2, 4)]
    dryrun.save_row(row, str(tmp_path))
    path = tmp_path / "baseline_gemma3-1b_decode_32k_2x4.json"
    assert json.loads(path.read_text())["flops"] == row["flops"]
    assert row["opts"] == {}          # no flag set away from its default


@pytest.mark.parametrize("arch,shape", [("mamba2-1.3b", "train_4k"),
                                        ("granite-moe-3b-a800m", "train_4k"),
                                        ("hymba-1.5b", "decode_32k")])
def test_mini_dry_run_recurrent_and_moe(arch, shape):
    """The SSM, MoE and hybrid blocks on fake DTensors: their reshapes
    make strided shards, whose sizes the dry run computes outside the
    fake mode; the same never-loses bounds against (1, 1)."""
    rows = {ms: dryrun.run_cell(arch, shape, mesh_shape=ms, smoke=True,
                                batch=8, seq=64, verbose=False)
            for ms in ((2, 4), (1, 1))}
    row, one = rows[2, 4], rows[1, 1]
    assert 0 < row["flops"] <= one["flops"] <= row["flops"] * 8
    assert row["coll_bytes"] > 0 and one["coll_bytes"] == 0
    assert row["logical_flops"] == pytest.approx(one["flops"], rel=1e-9)


def _moe_layer_collectives(grouped: bool):
    """The collectives of smoke granite-moe-3b-a800m's MoE layer (8 x 64
    tokens, the residual layout; bf16) on fake DTensors on a fake (2, 4)
    mesh, forward and backward apart."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch import configs
    from repro_torch.core import flags
    from repro_torch.core import tree as tu
    from repro_torch.core.config import GemminiConfig
    from repro_torch.core.context import ExecutionContext
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    from repro_torch.models import moe
    cfg = configs.get_smoke("granite-moe-3b-a800m")
    mesh = dryrun.fake_mesh((2, 4), ("data", "model"))
    ctx = ExecutionContext(cfg=GemminiConfig(
        input_dtype="bf16", acc_dtype="fp32", output_dtype="bf16"))
    flags.set_flag("moe_grouped_dispatch", int(grouped))
    try:
        with FakeTensorMode():
            p = {"moe": moe.moe_init(torch.Generator(), cfg.d_model,
                                     cfg.moe_d_ff, cfg.n_experts,
                                     ep=cfg.expert_padding, dtype=cfg.dtype)}
            p = shd.distribute_tree(p, shd.param_specs(p, mesh), mesh)
            for leaf in tu.leaves(p):
                leaf.requires_grad_(True)
            x = shd.distribute(torch.empty((8, 64, cfg.d_model),
                                           dtype=cfg.dtype),
                               shd.P("data", "model", None), mesh)
            x.requires_grad_(True)
            with implicit_replication(), mesh_lib.activate_mesh(mesh), \
                    dryrun._strided_shards_on_fake_tensors():
                with cost.count(mesh) as fwd:
                    y = moe.moe_apply(
                        ctx, p["moe"], x, n_experts=cfg.n_experts,
                        top_k=cfg.top_k, capacity_factor=cfg.capacity_factor)
                with cost.count(mesh) as bwd:
                    y.to(torch.float32).sum().backward()
    finally:
        flags.reset()
    return cfg, fwd.report, bwd.report


def test_grouped_dispatch_moves_only_the_regroup():
    """With ``moe_grouped_dispatch`` on, the dispatch's cumsum, scatter and
    combine run on each rank's group with no collective: the forward
    gathers the fp32 router (d x E x 4 bytes, over ``model``) and makes
    the regroup's two all-to-alls over ``model``; the backward makes the
    two all-to-alls and nothing else. Ungrouped, DTensor gathers the
    dispatch's tensors, more than four times the bytes."""
    cfg, fwd, bwd = _moe_layer_collectives(True)
    router = cfg.d_model * cfg.n_experts * 4
    assert dict(fwd.coll_counts) == {"all-gather": 1, "all-to-all": 2}
    assert fwd.coll_breakdown["all-gather"] == router
    assert dict(bwd.coll_counts) == {"all-to-all": 2}
    assert set(fwd.coll_by_axis) == set(bwd.coll_by_axis) == {"model"}
    _, ufwd, ubwd = _moe_layer_collectives(False)
    assert set(ufwd.coll_by_axis) == set(ubwd.coll_by_axis) == \
        {"data", "model"}
    assert ufwd.coll_bytes + ubwd.coll_bytes > \
        4 * (fwd.coll_bytes + bwd.coll_bytes)



@pytest.mark.parametrize("propagated", [True, False])
def test_replicated_call_route(monkeypatch, propagated):
    """``core.dtensor.replicated_call`` runs ``fn`` on the DTensors where
    DTensor propagates every op it ``needs``, else on whole plain operands
    (always without ``needs``); the result is a DTensor either way."""
    from repro_torch.core import dtensor as shard
    from repro_torch.launch import sharding as shd
    assert shard.propagates(torch.ops.aten.mm.default)
    mesh = dryrun.fake_mesh((2, 4), ("data", "model"))
    x = shd.distribute(torch.randn(8, 4), shd.P("data", None), mesh)
    monkeypatch.setattr(shard, "propagates", lambda op: propagated)
    seen = []

    def fn(t):
        seen.append(shard.is_dtensor(t))
        return t * 2
    assert shard.is_dtensor(shard.replicated_call(
        fn, x, needs=(torch.ops.aten.mul.Tensor,)))
    assert shard.is_dtensor(shard.replicated_call(fn, x))
    assert seen == [propagated, False]
