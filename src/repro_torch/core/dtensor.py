"""DTensor helpers shared by the context, the models and the launchers.

A ``DTensor`` is a wrapper subclass: its ``data_ptr()`` is not its
shard's, so no kernel may see one (``kernels`` entries call
:func:`require_local`). Model code outside the kernels runs on DTensors
through DTensor's own sharding propagation, as the JAX package's model
code runs under GSPMD.
"""

from __future__ import annotations

import functools
import sys

import torch


def is_dtensor(x) -> bool:
    """True for a DTensor. No DTensor exists before
    ``torch.distributed.tensor`` is imported, so a process that never
    shards pays no import for the check."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def any_dtensor(tensors) -> bool:
    """True when one of ``tensors`` is a DTensor (one module lookup when
    none can exist)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and any(isinstance(t, mod.DTensor)
                                   for t in tensors)


def require_local(name: str, *tensors) -> None:
    """Raise ``TypeError`` if any operand is a DTensor: a kernel takes the
    plain local shard (``ctx`` runs it on ``to_local()`` views)."""
    for t in tensors:
        if is_dtensor(t):
            raise TypeError(
                f"{name}: got a DTensor operand; a kernel takes plain local "
                f"tensors (run it through a sharded ExecutionContext, which "
                f"hands each kernel its local shard)")


def _split_last(x) -> bool:
    """True for a DTensor whose last dim is split over more than one
    device."""
    from torch.distributed.tensor import Shard
    n = 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim % x.ndim == x.ndim - 1:
            n *= x.device_mesh.size(i)
    return n > 1


def logsumexp_last(x: torch.Tensor) -> torch.Tensor:
    """``torch.logsumexp(x, -1)``; for a DTensor whose last dim is split
    over devices (the vocab-sharded logits), ``max + log(sum(exp(x -
    max)))`` instead, whose reductions DTensor runs as (...,)-sized
    partial reductions where its own logsumexp gathers ``x`` whole."""
    if not is_dtensor(x) or not _split_last(x):
        return torch.logsumexp(x, dim=-1)
    m = x.amax(dim=-1, keepdim=True).detach()
    return (torch.log(torch.exp(x - m).sum(dim=-1, keepdim=True)) + m)[..., 0]


def take_last(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` per position: ``torch.gather`` on the last dim for
    a plain tensor. A DTensor, whose last dim may be sharded (the
    vocab-sharded logits), sums ``x`` where the last dim's index equals
    ``idx`` and zero elsewhere instead, which is exact (one term is not
    zero) and reduces a (..., ) partial sum rather than gathering ``x``:
    DTensor's own gather over a sharded dim does not reduce a 3-D index."""
    if not is_dtensor(x):
        return torch.gather(x, -1, idx[..., None])[..., 0]
    vocab = torch.arange(x.shape[-1], device=x.device)
    hit = idx[..., None] == vocab
    return torch.where(hit, x, torch.zeros((), dtype=x.dtype,
                                           device=x.device)).sum(-1)


def local_along(fn, x: torch.Tensor, dim) -> torch.Tensor:
    """``fn(x)`` for an op along ``dim`` alone (a pad at its end, a
    cumulative sum over it). A DTensor runs ``fn`` on this rank's shard
    with ``dim`` made whole first (a split of it gathered; None: the
    shard as it is, for an op of each element or each rank) and the
    other placements kept; the output has those placements and ``dim``
    as long as ``fn`` made it. The same local op as DTensor's own
    propagation runs, so the values are the same, but some torch releases
    (2.11) cannot propagate ``pad`` on a sharded DTensor or ``flip`` (the
    backward of ``cumsum``), and this runs neither through DTensor."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor, Replicate
    nd, mesh = x.ndim, x.device_mesh
    dim = None if dim is None else dim % nd
    pl = tuple(Replicate() if dim is not None and getattr(p, "dim", None)
               is not None and p.dim % nd == dim else p
               for p in x.placements)
    out = fn(x.redistribute(mesh, pl).to_local(grad_placements=pl))
    shape = list(x.shape)
    if dim is not None:
        shape[dim] = out.shape[dim]
    return DTensor.from_local(out, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta")
                              .stride())


@functools.lru_cache(maxsize=None)
def propagates(op) -> bool:
    """True when this torch's DTensor has a sharding strategy of its own
    for the aten overload ``op`` (torch 2.11 has none for ``index_put``;
    neither 2.11 nor 2.13 has one for the fp32-output ``bmm``)."""
    from torch.distributed.tensor import DTensor
    prop = DTensor._op_dispatcher.sharding_propagator
    return any(op in getattr(prop, reg, {}) for reg in (
        "op_strategy_funcs", "op_single_dim_strategy_funcs", "op_to_rules"))


def replicated_call(fn, *tensors, needs=None):
    """``fn(*tensors)`` for a data movement DTensor cannot propagate in
    some torch releases. ``needs``: the aten ops ``fn`` and its backward
    run; where DTensor :func:`propagates` all of them, DTensors run ``fn``
    through DTensor's own propagation. Else (and always without
    ``needs``) every DTensor operand is gathered whole and ``fn`` runs on
    the plain tensors on each rank (:func:`local_call` with no operand
    split), the result a replicated DTensor: each rank then computes the
    whole gradient, and the operands' gradients leave replicated. Plain
    operands run ``fn`` as they are."""
    dts = [t for t in tensors if is_dtensor(t)]
    if not dts or (needs and all(propagates(op) for op in needs)):
        return fn(*tensors)
    n = len(tensors)
    return local_call(fn, tensors, (False,) * n, False,
                      dts[0].device_mesh, ())


def rows_only(x: torch.Tensor) -> torch.Tensor:
    """A DTensor with every split of a dim other than 0 gathered (the
    splits of dim 0 kept, unless it holds one row, which DTensor will not
    flatten while split), so (B, T, ...) flattens to rows as DTensor
    allows in every release; a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if getattr(p, "dim", None) is not None
               and (p.dim % x.ndim != 0 or x.shape[0] == 1) else p
               for p in x.placements)
    return constrain(x, (x.device_mesh, pl))


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """x (n, ...) on each of ``group``'s n ranks: block i goes to rank i,
    and block i of the result came from rank i. A functional collective
    (the cost count sees it), differentiable: its backward is the same
    exchange of the gradient blocks. The MoE's expert regroup: a group's
    (E, cap, d) buffer cut into n expert blocks becomes this rank's
    expert block of the n groups, and the same exchange brings the
    expert outputs back."""
    import torch.distributed._functional_collectives as funcol
    y = funcol.all_to_all_single_autograd(x.contiguous(), None, None, group)
    return funcol.wait_tensor(y)


def split_rows(x: torch.Tensor, n: int):
    """``x`` (B, ...) as ``n`` micro-batches of B / n rows, indexable by
    micro-batch: ``x.reshape(n, -1, ...)`` for a plain tensor. A DTensor
    splits each rank's own rows (no data moves): micro-batch i is the
    i-th block of every rank's local rows, in ``x``'s placements. Raises
    where a rank's rows do not divide by ``n``."""
    if not is_dtensor(x):
        return x.reshape(n, -1, *x.shape[1:])
    from torch.distributed.tensor import DTensor
    local = x.to_local()
    if local.shape[0] % n:
        raise ValueError(f"{local.shape[0]} local rows (of {x.shape[0]}) "
                         f"do not split into {n} micro-batches")
    shape = (x.shape[0] // n,) + tuple(x.shape[1:])
    stride = torch.empty(shape, device="meta").stride()
    return [DTensor.from_local(part, x.device_mesh, x.placements,
                               run_check=False, shape=torch.Size(shape),
                               stride=stride)
            for part in local.reshape(n, -1, *local.shape[1:])]


def constrain(x: torch.Tensor, layout) -> torch.Tensor:
    """``jax.lax.with_sharding_constraint``'s counterpart: a DTensor
    redistributed to ``layout`` (a ``(mesh, placements)`` pair); a plain
    tensor, or ``layout`` None, passes through."""
    if layout is None or not is_dtensor(x):
        return x
    mesh, placements = layout
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def place_rows(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """A DTensor with dim 0 split over ``axes`` (major to minor) and whole
    over the other mesh dims, where the axes divide dim 0; else ``x``.
    One row (a micro-batch of one sequence) is whole everywhere: DTensor
    will not flatten a split dim of one row."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in axes:
        n *= mesh.size(names.index(a))
    if x.shape[0] % n or x.shape[0] < n:
        return x
    pl = tuple(Shard(0) if name in axes and x.shape[0] > 1 else Replicate()
               for name in names)
    return constrain(x, (mesh, pl))


class _GradLayout(torch.autograd.Function):
    """Identity forward; the gradient redistributed to ``placements``."""

    @staticmethod
    def forward(ctx, x, placements):
        ctx.mesh, ctx.placements = x.device_mesh, placements
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != tuple(ctx.placements):
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g, None


def grad_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` unchanged, its gradient laid out as ``x`` is: a view whose
    backward sees a gradient of another layout (a sequence-sharded one)
    would flatten two sharded dims into one."""
    if not is_dtensor(x) or not x.requires_grad:
        return x
    return _GradLayout.apply(x, tuple(x.placements))


# ---------------------------------------------------------------------------
# local calls: a function of plain tensors run on each rank's shards
# ---------------------------------------------------------------------------
def layout(mesh, axes, arrays, batched):
    """(per-operand placements, placement of a batched output, gradient
    placements of a whole operand): dim 0 of the batched operands split
    over ``axes`` when they divide it (all of them), every operand whole
    otherwise; a whole operand's gradient is a partial sum over the split
    axes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.launch import mesh as mesh_lib
    names = mesh_lib.axis_names(mesh)
    n = mesh_lib.axis_size(mesh, tuple(axes))
    rows_of = [a for a, b in zip(arrays, batched) if b and a is not None]
    split = bool(rows_of) and all(a.shape[0] % n == 0 and a.shape[0] >= n
                                  for a in rows_of)
    rows = tuple(Shard(0) if split and name in axes else Replicate()
                 for name in names)
    whole_pl = (Replicate(),) * len(names)
    partial = tuple(Partial() if split and name in axes else Replicate()
                    for name in names)
    return [rows if b else whole_pl for b in batched], rows, partial


class _Whole(torch.autograd.Function):
    """A DTensor operand gathered whole, or into another layout of
    ``placements`` (the local tensor, or the DTensor where
    ``grad_placements`` is None); its gradient, each rank's
    partial sum, leaves as a DTensor of ``grad_placements`` (``Partial``
    over the split axes), so no reduction runs here: whoever needs it
    reduces it into the layout it needs (the ZeRO shard's
    reduce-scatter). With None the gradient leaves in the layout DTensor's
    propagation gave it."""

    @staticmethod
    def forward(ctx, x, placements, grad_placements):
        ctx.mesh, ctx.grad_placements = x.device_mesh, grad_placements
        y = x.redistribute(x.device_mesh, placements)
        return y if grad_placements is None else y.to_local()

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import DTensor
        if ctx.grad_placements is not None:
            g = DTensor.from_local(g, ctx.mesh, ctx.grad_placements,
                                   run_check=False)
        return g, None, None


def whole(x, placements, grad_placements):
    return _Whole.apply(x, placements, grad_placements)


def local_call(fn, arrays, batched, out_batched, mesh, axes):
    """``fn(*locals)`` on this rank's local tensors of ``arrays`` laid out
    by :func:`layout`, the outputs DTensors (dim 0 split where
    ``out_batched`` says: a bool, or one per output of a tuple). A plain
    tensor among them counts as whole on every rank (DTensor's implicit
    replication): a batched one gives this rank its rows. None passes
    through."""
    from torch.distributed.tensor import DTensor, Replicate
    layouts, rows, partial = layout(mesh, axes, arrays, batched)
    locs = []
    for a, b, pl in zip(arrays, batched, layouts):
        if is_dtensor(a) and b:
            a = a.redistribute(mesh, pl).to_local(grad_placements=pl)
        elif is_dtensor(a):
            a = whole(a, pl, partial)
        elif a is not None and b:
            a = DTensor.from_local(a, mesh, (Replicate(),) * mesh.ndim,
                                   run_check=False
                                   ).redistribute(mesh, pl).to_local()
        locs.append(a)
    out = fn(*locs)
    whole_pl = (Replicate(),) * mesh.ndim

    def wrap(o, b):
        return DTensor.from_local(o, mesh, rows if b else whole_pl,
                                  run_check=False)
    if isinstance(out, tuple):
        flags = out_batched if isinstance(out_batched, tuple) \
            else (out_batched,) * len(out)
        return tuple(None if o is None else wrap(o, b)
                     for o, b in zip(out, flags))
    return wrap(out, out_batched)


def rows_call(fn, rows: torch.Tensor, *others):
    """``fn(rows, *others)`` with ``rows`` split on dim 0 over its mesh's
    data axes and ``others`` whole (:func:`local_call`), for a model op
    DTensor's own propagation should not see (the embedding lookup, whose
    backward index_put some torch releases cannot shard); plain tensors
    run ``fn`` as is."""
    ts = (rows,) + others
    dts = [t for t in ts if is_dtensor(t)]
    if not dts:
        return fn(*ts)
    from repro_torch.launch import mesh as mesh_lib
    mesh = dts[0].device_mesh
    return local_call(fn, ts, (True,) + (False,) * len(others), True, mesh,
                      mesh_lib.data_axes(mesh))
