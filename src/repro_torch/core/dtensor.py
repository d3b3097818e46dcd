"""DTensor helpers shared by the context, the models and the launchers.

A ``DTensor`` is a wrapper subclass: its ``data_ptr()`` is not its
shard's, so no kernel may see one (``kernels`` entries call
:func:`require_local`). Model code outside the kernels runs on DTensors
through DTensor's own sharding propagation, as the JAX package's model
code runs under GSPMD.
"""

from __future__ import annotations

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
    over the other mesh dims, where the axes divide dim 0; else ``x``."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(mesh.mesh_dim_names)
    n = 1
    for a in axes:
        n *= mesh.size(names.index(a))
    if x.shape[0] % n or x.shape[0] < n:
        return x
    pl = tuple(Shard(0) if name in axes else Replicate() for name in names)
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
    """A DTensor operand gathered whole (the local tensor, or a whole
    DTensor where ``grad_placements`` is None); its gradient, each rank's
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
