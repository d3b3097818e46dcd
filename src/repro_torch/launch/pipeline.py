"""Pipeline parallelism (port of ``repro.launch.pipeline``): the GPipe
stage loop over a ``stage`` mesh axis.

The layer stack is split into S stages whose parameters are sharded over
the ``stage`` axis (each rank holds only its stage's layers). Micro-batches
march through the GPipe schedule: at tick ``t`` stage ``s`` runs
micro-batch ``t - s``; the activations hop stage -> stage + 1 by
point-to-point sends on the ``stage`` axis's process group, both ops of a
tick posted together (``batch_isend_irecv``), around the ring as the JAX
``ppermute``. Autograd differentiates straight through the loop: the hop
is an ``autograd.Function`` whose backward is the reverse ring, giving
the backward pipeline, with the GPipe bubble (S-1)/(T+S-1).

Every rank runs the same program, as the JAX ``shard_map`` body does:
each tick computes ``stage_fn`` on ``where(stage == 0, input, received)``
(a tensor select, so the received buffer stays in stage 0's graph and the
backward of every hop runs on every rank: a hop whose backward ran on one
rank and not on its neighbour would hang the group), and every tick but
the last hops its output. The last stage's outputs come back replicated
on every stage by a sum over the axis whose backward is the identity
(each rank already holds the whole cotangent of the replicated output);
the input's cotangent, which only stage 0's graph reaches, is summed over
the axis, as the transpose of the JAX ``shard_map`` sums a replicated
input's. At S = 1 the hop, the replication and that sum are the
identity.

``pipeline_apply`` operates on the residual stream; the embedding and the
unembedding stay outside (:func:`pipeline_loss_fn`).
:func:`transformer_stage_fns` gives the three functions for the model's
blocks (each stage's layers keep the windows and rope bases of their
global index). The other mesh axes are the caller's: stage parameters
that are DTensors over a (stage, data, model) mesh come to ``stage_fn`` as
DTensors on the (data, model) sub-mesh, and an activation that is a
DTensor there hops as its local shard.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import dtensor as shard
from repro_torch.core import tree as tu
from repro_torch.launch import mesh as mesh_lib


def split_stages(stacked_params: Any, n_stages: int) -> Any:
    """Reshape (L, ...) stacked layer params to (S, L/S, ...)."""
    def one(p):
        n = p.shape[0]
        if n % n_stages:
            raise ValueError(f"{n} layers not divisible into {n_stages} "
                             f"stages")
        return p.reshape(n_stages, n // n_stages, *p.shape[1:])
    return tu.tree_map(one, stacked_params)


def _ring(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """``x`` sent to the rank ``step`` ahead on ``group``'s ring, and the
    tensor of the rank ``step`` behind received, both ops posted
    together."""
    import torch.distributed as dist
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x,
                      dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _Hop(torch.autograd.Function):
    """Stage s's tensor to stage s + 1 (the last to stage 0); the backward
    sends each gradient back the other way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _ring(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _ring(g, ctx.group, -1), None


class _Replicate(torch.autograd.Function):
    """The sum over the axis of every stage's (masked) outputs; the
    backward is the identity."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Enter(torch.autograd.Function):
    """The identity; the backward sums the cotangent over the axis."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _stage_block(p, axis: str, s: int):
    """This stage's slice of a (S, ...) leaf: a DTensor split over ``axis``
    gives its local block (on the sub-mesh of the other axes, if any), a
    plain tensor its row ``s``."""
    if not shard.is_dtensor(p):
        return p[s]
    from torch.distributed.tensor import DTensor
    names = mesh_lib.axis_names(p.device_mesh)
    i = names.index(axis)
    if getattr(p.placements[i], "dim", None) != 0:
        raise ValueError(f"stage params must be split on dim 0 over "
                         f"{axis!r}, got {p.placements}")
    others = tuple(a for a in names if a != axis)
    local = p.to_local(grad_placements=p.placements)[0]
    if not others:
        return local
    sub = p.device_mesh[others]
    pl = tuple(q for j, q in enumerate(p.placements) if j != i)
    if any(getattr(q, "dim", None) == 0 for q in pl):
        raise ValueError("the stage dim is split over another axis too")
    pl = tuple(type(q)(q.dim - 1) if getattr(q, "dim", None) is not None
               else q for q in pl)
    return DTensor.from_local(local, sub, pl, run_check=False)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, x_microbatches: torch.Tensor, *,
                   mesh, axis: str = "stage") -> torch.Tensor:
    """Run micro-batches through the S-stage pipeline.

    stage_fn(params_for_one_stage, h) -> h   (applies that stage's layers)
    stage_params: tree with leading dim S (split over ``axis``: DTensors
        sharded on dim 0 over it, or plain tensors whole on every rank)
    x_microbatches: (n_micro, mb, ...) residual-stream inputs, the same on
        every stage (a plain tensor, or a DTensor on the other axes)
    Returns (n_micro, mb, ...) outputs (the last stage's, replicated).
    """
    n_stages = mesh_lib.axis_size(mesh, axis)
    s = mesh.get_local_rank(axis) if n_stages > 1 else 0
    group = mesh.get_group(axis) if n_stages > 1 else None
    nm = x_microbatches.shape[0]
    params1 = tu.tree_map(lambda p: _stage_block(p, axis, s),
                          stage_params)
    x = x_microbatches
    if n_stages > 1:
        x = shard.local_along(lambda v: _Enter.apply(v, group), x, None)
    first = torch.tensor(s == 0, device=x.device)
    buf = torch.zeros_like(x[0])
    total = nm + n_stages - 1
    outs = []
    for t in range(total):
        h_in = torch.where(first, x[min(t, nm - 1)], buf)
        h_out = stage_fn(params1, h_in)
        if t >= n_stages - 1:
            outs.append(h_out)
        if t < total - 1:
            buf = h_out if n_stages == 1 else shard.local_along(
                lambda v: _Hop.apply(v, group), h_out, None)
    y = torch.stack(outs)
    if n_stages == 1:
        return y
    last = torch.tensor(s == n_stages - 1, device=y.device)
    y = torch.where(last, y, torch.zeros((), dtype=y.dtype, device=y.device))
    return shard.local_along(lambda v: _Replicate.apply(v, group), y, None)


def pipeline_loss_fn(stage_fn, embed_fn, unembed_loss_fn):
    """Compose embed -> pipeline -> unembed+loss for training."""

    def loss(params, tokens, labels, *, mesh, n_micro: int,
             axis: str = "stage"):
        h = embed_fn(params, tokens)                     # (B, T, D)
        b = h.shape[0]
        hm = h.reshape(n_micro, b // n_micro, *h.shape[1:])
        ym = pipeline_apply(
            lambda sp, hh: stage_fn(params, sp, hh),
            params["stages"], hm, mesh=mesh, axis=axis)
        y = ym.reshape(b, *ym.shape[2:])
        return unembed_loss_fn(params, y, labels)

    return loss


def transformer_stage_fns(ctx, cfg, mesh=None, axis: str = "stage"):
    """(stage_fn, embed_fn, unembed_loss_fn) of a registry model for
    :func:`pipeline_loss_fn`, whose ``params`` are the model's with
    ``params["stages"] = split_stages(params["blocks"], S)``. The stage
    index comes from ``mesh`` (0 without one or at S = 1), so each stage
    runs its layers with the windows and rope bases of their global
    index (``transformer.apply_blocks``)."""
    from repro_torch.models import transformer as tf
    n_stages = 1 if mesh is None else mesh_lib.axis_size(mesh, axis)
    if cfg.n_layers % n_stages:
        raise ValueError(f"{cfg.n_layers} layers not divisible into "
                         f"{n_stages} stages")
    s = mesh.get_local_rank(axis) if n_stages > 1 else 0
    first = s * (cfg.n_layers // n_stages)

    def stage_fn(params, sp, h):
        return tf.apply_blocks(ctx, cfg, sp, h, tf.positions_of(h),
                               first=first)

    def embed_fn(params, tokens):
        return tf.embed_inputs(cfg, params, tokens)

    def unembed_loss_fn(params, y, labels):
        return tf.loss_from_logits(cfg, tf.unembed(ctx, cfg, params, y),
                                   labels)

    return stage_fn, embed_fn, unembed_loss_fn
