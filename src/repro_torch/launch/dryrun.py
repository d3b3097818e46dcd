"""Dry run: one step of each (arch x shape x mesh) cell, priced per
device with no device at all (port of ``repro.launch.dryrun``).

For each cell the dry run starts a ``fake`` process group of the mesh's
world size (256 for (16, 16), 512 for (2, 16, 16); rank 0 speaks for
all), builds the CPU device mesh, the cell's inputs as DTensors of fake
tensors (``steps.input_specs`` under ``FakeTensorMode``: no memory is
allocated), and runs the step (train / prefill / serve) once through an
unsharded context, so the plain versions run on DTensors and DTensor's
own sharding propagation partitions them, as the JAX dry run lowers its
step on the ``xla`` engine and lets GSPMD partition it. Nothing is
launched and no card is touched. ``analysis.cost`` counts the ops beneath
DTensor: per-device FLOPs, bytes and collective bytes by kind and by axis;
``analysis.roofline`` turns them into the card's three terms. The row also
carries the step's argument and output bytes on one device (its local
shards), the logical FLOPs above DTensor, and the replication factor
(per-device FLOPs x devices / logical FLOPs).

Usage (CPU):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-1b \\
      --shape train_4k                       # one cell on (16, 16)
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod

Rows go to ``--outdir`` (default ``build/dryrun``, git-ignored), one JSON
file per cell, named by ``--variant``; a row records the flags ``--opt``
set (``opts``). The steps run with their mesh active, so a flag that
reads it takes effect, e.g. the MoE's grouped dispatch:

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch \
      granite-moe-3b-a800m --shape train_4k --variant grouped \
      --opt moe_grouped_dispatch=1
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import configs
from repro_torch.analysis import cost, roofline
from repro_torch.core import flags
from repro_torch.core import tree as tu
from repro_torch.core.config import GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.optim import adamw

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..", "build",
                       "dryrun")


def _engine() -> ExecutionContext:
    return ExecutionContext(cfg=GemminiConfig(
        input_dtype="bf16", acc_dtype="fp32", output_dtype="bf16"))


def _fake_world(shape: Sequence[int]) -> None:
    """A ``fake`` default process group of ``prod(shape)`` ranks (this
    process is rank 0); an existing one of another kind or size is
    destroyed first."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = 1
    for s in shape:
        n *= int(s)
    if dist.is_initialized() and (dist.get_backend() != "fake" or
                                  dist.get_world_size() != n):
        dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)


def fake_mesh(shape: Sequence[int], axes: Sequence[str]):
    """A CPU device mesh of ``shape`` over a fake process group."""
    _fake_world(shape)
    return mesh_lib.make_mesh(shape, axes, "cpu")


@contextlib.contextmanager
def _strided_shards_on_fake_tensors():
    """DTensor computes a strided shard's local size by running
    ``torch.arange`` and ``tolist()``, which ``FakeTensorMode`` refuses
    (data-dependent); the reshapes of the SSM and MoE blocks make such
    shards. For the dry run that one computation runs outside the fake
    mode (its result is a size, not data). A torch without
    ``_StridedShard.local_shard_size_and_offset`` is left as it is."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt
    cls = getattr(pt, "_StridedShard", None)
    orig = getattr(cls, "local_shard_size_and_offset", None)
    if orig is None:
        yield
        return

    def real_sizes(self, *a, **kw):
        with unset_fake_temporarily():
            return orig(self, *a, **kw)

    cls.local_shard_size_and_offset = real_sizes
    try:
        yield
    finally:
        cls.local_shard_size_and_offset = orig


def _local_bytes(tree) -> float:
    total = 0.0
    for leaf in tu.leaves(tree):
        if isinstance(leaf, torch.Tensor):
            t = leaf.to_local() if hasattr(leaf, "to_local") else leaf
            total += t.numel() * t.element_size()
    return total


def _step(cfg, spec: Dict[str, Any], mesh, ctx):
    kind = spec["kind"]
    if kind == "train":
        return steps_lib.make_train_step(ctx, cfg, adamw.AdamWConfig(), mesh)
    if kind == "prefill":
        return steps_lib.make_prefill_step(ctx, cfg, mesh)
    return steps_lib.make_serve_step(ctx, cfg, mesh)


def run_cell(arch: str, shape: str, multi_pod: bool = False, *,
             verbose: bool = True, variant: str = "baseline",
             mesh_shape: Optional[Sequence[int]] = None, smoke: bool = False,
             batch: Optional[int] = None, seq: Optional[int] = None
             ) -> Dict[str, Any]:
    """Price one cell; returns its row. ``mesh_shape`` replaces the
    production mesh (axes ``("data", "model")``, or with ``pod`` first
    for three dims); ``smoke`` takes the reduced config; ``batch`` /
    ``seq`` replace the shape's (the tests' miniature cells)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = configs.get_smoke(arch) if smoke else configs.get(arch)
    if mesh_shape is None:
        mesh_shape, _ = mesh_lib.production_shape(multi_pod=multi_pod)
        _fake_world(mesh_shape)
        mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                             device_type="cpu")
    else:
        mesh = fake_mesh(mesh_shape,
                         ("pod", "data", "model")[-len(mesh_shape):])
    mesh_name = "x".join(str(s) for s in mesh_shape)
    n_chips = mesh.size()
    saved = dict(steps_lib.SHAPES[shape])
    if batch is not None or seq is not None:
        steps_lib.SHAPES[shape] = dict(saved, **{k: v for k, v in
                                                 (("batch", batch),
                                                  ("seq", seq))
                                                 if v is not None})
    try:
        with FakeTensorMode(), _strided_shards_on_fake_tensors():
            spec = steps_lib.input_specs(cfg, shape, mesh)
            fn = _step(cfg, spec, mesh, _engine())
            arg_bytes = _local_bytes(spec["args"])
            t0 = time.time()
            with cost.count(mesh) as counter:
                out = fn(*spec["args"])
            t_run = time.time() - t0
            out_bytes = _local_bytes(out)
    finally:
        steps_lib.SHAPES[shape] = saved
    kind = spec["kind"]
    rl = roofline.analyze(
        counter.report, arch=arch, shape=shape, mesh=mesh,
        mesh_name=mesh_name, n_chips=n_chips,
        model_flops=roofline.model_flops_for(cfg, kind, spec["batch"],
                                             spec["seq"]),
        arg_bytes=arg_bytes, out_bytes=out_bytes)
    rl.min_bytes = roofline.model_min_bytes_for(cfg, kind, spec["batch"],
                                                spec["seq"])
    row = rl.row()
    row.update(kind=kind, variant=variant, run_s=t_run, smoke=smoke,
               opts=flags.changed(), batch=spec["batch"], seq=spec["seq"],
               coll_counts=dict(counter.report.coll_counts),
               argument_bytes=arg_bytes, output_bytes=out_bytes)
    if verbose:
        print(f"[{arch} x {shape} x {mesh_name}] kind={kind} "
              f"batch={spec['batch']} seq={spec['seq']} "
              f"({t_run:.1f}s on fake tensors)")
        print(f"  per device: flops={rl.flops:.4e} bytes={rl.hbm_bytes:.4e}"
              f" args={arg_bytes:.4e} out={out_bytes:.4e}")
        print(f"  collectives: {rl.coll_bytes:.4e} B "
              f"{ {k: v for k, v in rl.coll_breakdown.items() if v} } "
              f"by axis {dict(rl.coll_by_axis)}")
        print(f"  logical flops={rl.logical_flops:.4e} "
              f"replication={rl.replication:.3f} "
              f"model flops={rl.model_flops:.4e}")
        print(f"  roofline ({roofline.CARD}): "
              f"compute={rl.t_compute * 1e3:.3f}ms "
              f"memory={rl.t_memory * 1e3:.3f}ms "
              f"collective={rl.t_collective * 1e3:.3f}ms "
              f"-> {rl.bottleneck}-bound")
    return row


def save_row(row, outdir: str):
    os.makedirs(outdir, exist_ok=True)
    name = f"{row['variant']}_{row['arch']}_{row['shape']}_{row['mesh']}.json"
    with open(os.path.join(outdir, name), "w") as f:
        json.dump(row, f, indent=1, default=str)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--opt", action="append", default=[],
                    help="optimization flag name[=value] (repeatable); "
                         "see repro_torch.core.flags")
    ap.add_argument("--outdir", default=os.path.abspath(RESULTS))
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("--arch or --all")

    for spec in args.opt:
        flags.parse_opt(spec)

    if args.all:
        cells = [(arch, shape) for arch in configs.names()
                 for shape in configs.shapes_for(arch)]
    else:
        shapes = [args.shape] if args.shape else \
            configs.shapes_for(args.arch)
        cells = [(args.arch, s) for s in shapes]

    failures = []
    for arch, shape in cells:
        try:
            row = run_cell(arch, shape, args.multi_pod,
                           variant=args.variant)
            save_row(row, args.outdir)
        except Exception as e:  # noqa: BLE001 - a cell's failure is reported
            failures.append((arch, shape, repr(e)))
            print(f"[FAIL {arch} x {shape}]")
            traceback.print_exc()
    print(f"\n{len(cells) - len(failures)}/{len(cells)} cells OK")
    for f in failures:
        print("FAILED:", f)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
