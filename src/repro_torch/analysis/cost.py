"""Per-device cost count of an eager step: FLOPs, bytes and collective
bytes (the counterpart of ``repro.analysis.hlo``, which reads them from
XLA's partitioned HLO text).

The port has no compiled module to read, so :class:`CostCount` counts the
ops as they dispatch. It is a ``TorchDispatchMode`` that runs *beneath*
DTensor: an op on DTensors is handed on to DTensor, and the ops DTensor
then runs on each rank's local tensors are the ones counted, so the
totals are one device's, as the HLO module's shapes are. (Above DTensor,
as ``torch.utils.flop_counter.FlopCounterMode`` sits, an op on DTensors
counts the global, logical work; that count is kept too, as
``logical_flops``.) Under ``FakeTensorMode`` nothing runs and no memory
is touched: the dry run's setting (``launch.dryrun``).

  * FLOPs: ``torch.utils.flop_counter``'s formula registry (matrix
    products, convolutions and attention; elementwise ops count nothing,
    where the HLO count gave them one per element).
  * bytes: each op's tensor inputs plus outputs (``hlo._op_bytes``), views
    and allocations excepted. An eager step fuses nothing, so this is the
    unfused traffic, above what a fusing compiler's step would move.
  * collective bytes: the output bytes of each c10d functional
    collective, all-reduce counted twice (its ring is a reduce-scatter
    plus an all-gather, ``repro.analysis.roofline``'s convention), by
    kind and by mesh axis.

DTensor's sharding propagation runs each new op once on fake tensors of
the global shapes to learn the output's metadata; those runs are not the
step's work and are skipped (:func:`count` marks them).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
from typing import Any, Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# c10d functional op name -> the HLO collective kind it corresponds to
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")
_NO_BYTES = frozenset({"empty", "empty_strided", "empty_like", "new_empty",
                       "new_empty_strided", "detach", "alias", "lift_fresh",
                       "wait_tensor", "device", "sym_size", "sym_stride",
                       "sym_numel", "sym_storage_offset", "is_same_size",
                       "_local_scalar_dense", "set_", "resize_"})


def _tensors(tree) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            yield from _tensors(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _tensors(t)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def flops_of(func, args, kwargs, out) -> float:
    """FLOPs of one op from ``torch.utils.flop_counter``'s registry (0 for
    an op it has no formula for)."""
    fn = flop_registry.get(func._overloadpacket)
    if fn is None:
        return 0.0
    return float(fn(*args, **kwargs, out_val=out))


@dataclasses.dataclass
class CostReport:
    flops: float = 0.0                   # per device
    bytes: float = 0.0                   # per device, unfused
    coll_bytes: float = 0.0              # per device, all-reduce x2
    coll_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    coll_counts: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    coll_by_axis: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))
    logical_flops: float = 0.0           # above DTensor: the global work
    flops_by_op: Dict[str, float] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(float))

    def row(self) -> Dict[str, Any]:
        return dict(flops=self.flops, bytes=self.bytes,
                    coll_bytes=self.coll_bytes,
                    coll_breakdown=dict(self.coll_breakdown),
                    coll_counts=dict(self.coll_counts),
                    coll_by_axis=dict(self.coll_by_axis),
                    logical_flops=self.logical_flops)


class CostCount(TorchDispatchMode):
    """Counts the local ops beneath DTensor into :attr:`report`.

    ``axis_of_ranks``: a process group's ranks -> mesh axis name, so
    collective bytes are kept per axis (:func:`group_axes` builds it from a
    mesh). A group is looked up by its ranks, not its name: DTensor may
    issue a collective on the group of another mesh of the same layout
    (one it cached an earlier plan for), which has another name; a group
    of no axis is kept under its name."""

    def __init__(self, axis_of_ranks: Optional[Dict[tuple, str]] = None):
        super().__init__()
        self.report = CostReport()
        self.axis_of_ranks = dict(axis_of_ranks or {})
        self._above = False         # inside an op on DTensors
        self.skip = 0               # inside DTensor's metadata propagation

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            if self._above or self.skip:
                return NotImplemented      # DTensor runs it on the locals
            self._above = True
            try:
                with self:
                    out = func(*args, **kwargs)
            finally:
                self._above = False
            self.report.logical_flops += flops_of(func, args, kwargs, out)
            return out
        out = func(*args, **kwargs)
        if not self.skip:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        rep = self.report
        ns, name = func.namespace, func._opname
        if ns in _COLLECTIVE_NS and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            b = float(sum(_nbytes(t) for t in _tensors(out)))
            if kind == "all-reduce":
                b *= 2.0
            rep.coll_bytes += b
            rep.coll_breakdown[kind] += b
            rep.coll_counts[kind] += 1
            group = args[-1] if args and isinstance(args[-1], str) \
                else kwargs.get("group_name")
            rep.coll_by_axis[self._axis(group)] += b
            return
        f = flops_of(func, args, kwargs, out)
        if f:
            rep.flops += f
            rep.flops_by_op[str(func._overloadpacket)] += f
        if func.is_view or name in _NO_BYTES or ns == "prim":
            return
        rep.bytes += float(sum(_nbytes(t) for t in _tensors(args)) +
                           sum(_nbytes(t) for t in _tensors(kwargs)) +
                           sum(_nbytes(t) for t in _tensors(out)))


    def _axis(self, group) -> str:
        import torch.distributed as dist
        from torch.distributed.distributed_c10d import _resolve_process_group
        try:
            ranks = tuple(dist.get_process_group_ranks(
                _resolve_process_group(group)))
        except (LookupError, RuntimeError, ValueError):
            return str(group)
        return self.axis_of_ranks.get(ranks, str(group))


def group_axes(mesh) -> Dict[tuple, str]:
    """This rank's process group's ranks -> axis name for each dim of
    ``mesh``."""
    import torch.distributed as dist
    names = tuple(mesh.mesh_dim_names)
    return {tuple(dist.get_process_group_ranks(mesh.get_group(i))): names[i]
            for i in range(len(names))}


@contextlib.contextmanager
def count(mesh=None) -> Iterator[CostCount]:
    """``with count(mesh) as c: ...`` then ``c.report``. DTensor's metadata
    propagation (``ShardingPropagator._propagate_tensor_meta_non_cached``,
    global fake shapes) is marked and not counted; a torch without that
    method raises here rather than count it."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = "_propagate_tensor_meta_non_cached"
    orig = getattr(ShardingPropagator, name, None)
    if orig is None:
        raise RuntimeError(f"ShardingPropagator.{name} is missing: this "
                           f"torch's DTensor cannot be counted beneath")
    mode = CostCount(group_axes(mesh) if mesh is not None else None)

    def marked(self, *a, **kw):
        mode.skip += 1
        try:
            return orig(self, *a, **kw)
        finally:
            mode.skip -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        with mode:
            yield mode
    finally:
        setattr(ShardingPropagator, name, orig)
