"""Mixture-of-Experts FFN (port of ``repro.models.moe``): top-k routing and
position-in-expert dispatch, for granite-moe (40 experts padded to 48
slots, top-8, softmax weights on the expert output) and llama4-scout (16
experts, top-1, sigmoid weight on the expert input, a shared expert).

The same function as the JAX module, step for step and in its rounding
order, so bf16 results can be held against it:

* **Routing** runs the router on the engine GEMM (``layers.project`` on
  fp32 input: fp32 x fp32 with fp32 accumulation, written at the engine's
  output dtype) and masks the padded slots to -inf. The top k keep
  ``jax.lax.top_k``'s order, ties to the lower index (a stable descending
  sort; ``torch.topk`` breaks ties otherwise, and bf16 logits tie often).
* **Dispatch** gives each (token, choice) its position in the expert by a
  cumulative sum over the token-major one-hot; positions at or past the
  capacity are dropped to a spare row. Each kept slot is written once, so
  nothing is summed in an order the device picks: the card gives the
  CPU's result, and a step run twice (the NaN guard's re-run) repeats it
  bit for bit. There are no atomics (``index_add_``) on either side.
* **Experts** are batched products over (slots, capacity, d), as the JAX
  module's ``einsum``: fp32 products and sums of the model-dtype operands
  (:func:`_bmm_f32`), the gate in fp32, rounded to the model dtype before
  the down projection.
* **Combine** gathers each choice's row, zeroes the dropped, weights it in
  the model dtype and adds a token's k rows in choice order, rounding
  after each add (the order of the JAX ``acc.at[tid].add``).

**Grouped dispatch** (the ``moe_grouped_dispatch`` flag, JAX's perf
flag B): :func:`_dispatch_grid` reads the current device mesh
(``launch.mesh.activate_mesh``; the steps activate theirs) and, where it
has a ``model`` axis and the shapes divide, splits the tokens into one
group per (pod x data, model) shard of the residual (B over the data
axes, T over ``model``). Capacity, the position-in-expert cumsum, the
scatter and the combine then run per group. Under a mesh each rank holds
its group and runs them on plain local tensors, forward and backward
(JAX's ``pin_g``); the one movement is the expert regroup, (G, E, cap,
d) from the group axis to the expert axis (E over ``model``), an
all-to-all over ``model`` each way (``core.dtensor.all_to_all``).
One body serves both: without a grid (``(1, None)``) it runs with G = 1,
one global group, as the JAX module does. The training forward calls
:func:`moe_apply` with the capacity bound (``dropless=False``) and
differentiates it: the gate weights, the dispatch's row writes and the
expert products all carry gradients, as the JAX module's do.
:func:`aux_load_balance_loss` is the Switch-style auxiliary loss.

Cost: serving is dropless (capacity = tokens), so the expert products run
every slot over every token row, padded slots included: for granite 48
rows of work for each 8 active, as in the JAX module. A grouped product
over the routed rows alone is later work (ROADMAP B').
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import dtensor as shard
from repro_torch.models import layers

Params = Dict[str, Any]


def pad_experts(n_experts: int, ep: int) -> int:
    """Number of expert slots after padding to the EP degree."""
    return ((n_experts + ep - 1) // ep) * ep


def _dispatch_grid(b: int, t: int):
    """(groups, (gb, gt) or None) for the grouped-dispatch perf flag (the
    JAX function over the port's mesh helpers).

    gb x gt mirrors the mesh's (data-parallel x model) shard grid so every
    group is device-local. Returns (1, None) when the flag is off, no mesh
    is active, the mesh has no ``model`` axis, or shapes do not divide.
    """
    from repro_torch.core import flags
    from repro_torch.launch import mesh as mesh_lib
    if not flags.get("moe_grouped_dispatch"):
        return 1, None
    mesh = mesh_lib.current_mesh()
    if mesh is None or "model" not in mesh_lib.axis_names(mesh):
        return 1, None
    gb = 1
    for ax in ("pod", "data"):
        if ax in mesh_lib.axis_names(mesh):
            gb *= mesh_lib.axis_size(mesh, ax)
    gt = mesh_lib.axis_size(mesh, "model")
    if gb < 1 or gt < 1 or b % gb or t % gt:
        return 1, None
    return gb * gt, (gb, gt)


def moe_init(gen: torch.Generator, d: int, d_ff: int, n_experts: int, *,
             ep: int = 1, n_shared: int = 0, d_ff_shared: Optional[int] = None,
             n_layers: Optional[int] = None, dtype=torch.bfloat16,
             device="cpu") -> Params:
    """The JAX module's tree: ``router`` (d, e_pad) in fp32, the stacked
    gated experts ``wi`` / ``wg`` (e_pad, d, d_ff) and ``wo`` (e_pad, d_ff,
    d) in ``dtype``, and a ``shared`` gated MLP of width ``(d_ff_shared or
    d_ff) * n_shared`` where ``n_shared`` > 0. ``n_layers``: a leading
    stacked L axis on every leaf. Numbers from ``gen``."""
    e_pad = pad_experts(n_experts, ep)
    lead = () if n_layers is None else (n_layers,)

    def normal(*shape, scale):
        return torch.randn(lead + shape, generator=gen, device=device,
                           dtype=torch.float32) * scale

    p: Params = {
        "router": normal(d, e_pad, scale=1.0 / math.sqrt(d)),
        "wi": normal(e_pad, d, d_ff, scale=1.0 / math.sqrt(d)).to(dtype),
        "wg": normal(e_pad, d, d_ff, scale=1.0 / math.sqrt(d)).to(dtype),
        "wo": normal(e_pad, d_ff, d, scale=1.0 / math.sqrt(d_ff)).to(dtype),
    }
    if n_shared:
        ff = (d_ff_shared or d_ff) * n_shared
        p["shared"] = {
            "wi": normal(d, ff, scale=1.0 / math.sqrt(d)).to(dtype),
            "wo": normal(ff, d, scale=1.0 / math.sqrt(ff)).to(dtype),
            "wg": normal(d, ff, scale=1.0 / math.sqrt(d)).to(dtype)}
    return p


def route(ctx, p: Params, x: torch.Tensor, *, n_experts: int,
          top_k: int):
    """Tokens x (N, d) -> (weights (N, k) in x's dtype, expert slots (N, k)
    int64), each token's choices best first. The logits come from the
    engine GEMM at its output dtype; a sigmoid weight for top-1
    (llama4), else a softmax over the k chosen logits."""
    e_pad = p["router"].shape[-1]
    logits = layers.project(ctx, x.to(torch.float32), p["router"])
    if e_pad != n_experts:
        pad = torch.arange(e_pad, device=x.device) >= n_experts
        logits = logits.masked_fill(pad, float("-inf"))
    gate_w, gate_idx = torch.sort(logits, dim=-1, descending=True,
                                  stable=True)
    gate_w, gate_idx = gate_w[:, :top_k], gate_idx[:, :top_k]
    if top_k == 1:
        weights = layers.sigmoid(gate_w)
    else:
        # jax.nn.softmax's ops, each rounded at the logits' dtype
        u = torch.exp(gate_w - gate_w.amax(dim=-1, keepdim=True))
        weights = u / u.sum(dim=-1, keepdim=True)
    return weights.to(x.dtype), gate_idx


class _BmmF32(torch.autograd.Function):
    """16-bit a @ b on the card by ``bmm``'s fp32-output overload, which
    has no derivative (torch 2.11); the backward is the one autograd
    gives the CPU's widened operands: each gradient the fp32 product of
    the fp32 cotangent and the other operand widened, rounded to its
    operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.bmm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        f32 = torch.float32
        ga = torch.bmm(g, b.to(f32).transpose(1, 2)).to(a.dtype) \
            if ctx.needs_input_grad[0] else None
        gb = torch.bmm(a.to(f32).transpose(1, 2), g).to(b.dtype) \
            if ctx.needs_input_grad[1] else None
        return ga, gb


# the aten ops of the dispatch's scatter and of its gather's backward
_INDEX_PUT = (torch.ops.aten.index_put_.default,
              torch.ops.aten.index_put.default)


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (E, M, K) @ b (E, K, N) as fp32 products summed in fp32, written
    fp32: the JAX ``einsum(..., preferred_element_type=float32)``. On the
    card 16-bit operands go to one ``bmm`` with an fp32 output
    (:class:`_BmmF32`); the CPU's ``bmm`` has no such overload, so there
    they are widened first, which computes the same function. DTensors run
    that overload on whole operands where DTensor has no strategy for it
    (``core.dtensor.replicated_call``: none has one in torch 2.11 or
    2.13)."""
    if a.is_cuda and a.dtype != torch.float32:
        return shard.replicated_call(_BmmF32.apply, a, b,
                                     needs=(torch.ops.aten.bmm.dtype,))
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def moe_apply(ctx, p: Params, x: torch.Tensor, *, n_experts: int,
              top_k: int, capacity_factor: float = 1.25,
              activation: str = "silu", router_weights_before: bool = False,
              dropless: bool = False) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D) in x's dtype.

    ``router_weights_before``: llama4 scales the expert *input* by the
    (sigmoid) weight; granite scales the expert *output* by the softmax
    weight. ``dropless``: capacity = tokens of a group, no token dropped
    (every serving entry); otherwise ``max(1, int(capacity_factor *
    tokens * top_k / n_experts))`` with the GShard drops. One body for
    G groups of ``ntl`` tokens; without a grid G = 1, the ops of one
    global group."""
    b, t, d = x.shape
    groups, grid = _dispatch_grid(b, t)
    ntl = b * t // groups
    kw = dict(n_experts=n_experts, top_k=top_k, activation=activation,
              router_weights_before=router_weights_before,
              capacity=ntl if dropless else
              max(1, int(capacity_factor * ntl * top_k / n_experts)))
    if grid is None:
        # a DTensor's T made whole first: flattening (B, T) with T split
        # needs a redistribution DTensor refuses in some releases (2.11)
        xf = shard.rows_only(x).reshape(b * t, d)
        y = _routed(ctx, p, xf, 1, **kw)
        # the gradient laid out as y (rows only) before the reshape's
        # backward
        y = shard.grad_layout(y.reshape(b, t, d))
    elif shard.is_dtensor(x):
        y = _grouped_sharded(ctx, p, x, grid, **kw)
    else:
        # relabel into groups (JAX's order: data-major, model-minor)
        gb, gt = grid
        xf = x.reshape(gb, b // gb, gt, t // gt, d).transpose(1, 2) \
            .reshape(b * t, d)
        y = _routed(ctx, p, xf, groups, **kw)
        y = y.reshape(gb, gt, b // gb, t // gt, d).transpose(1, 2) \
            .reshape(b, t, d)
    if "shared" in p:
        y = y + layers.mlp_apply(ctx, p["shared"], x, activation=activation)
    return y


def _routed(ctx, p: Params, xf, groups, *, capacity, **kw):
    """The routed experts of xf (G * ntl, d), each group's ntl rows
    consecutive, on the weights ``p`` -> (G * ntl, d)."""
    weights, slot, keep, expert_in = _dispatch(
        ctx, p["router"], xf, groups, capacity, **kw)
    out = _experts(expert_in, p["wi"], p["wg"], p["wo"], kw["activation"],
                   xf.dtype)
    return _combine(_group_major(out, groups), slot, keep, weights, groups,
                    **kw)


def _grouped_sharded(ctx, p: Params, x, grid, *, capacity, **kw):
    """:func:`moe_apply` over the (gb, gt) grid for a DTensor ``x`` laid
    out as the residual (B over the pod and data axes, T over ``model``):
    this rank's block *is* its group (JAX's ``pin_g``), dispatched and
    combined on plain local tensors, forward and backward. The router and
    expert weights come in as local blocks whose gradients leave as
    partial sums over the groups (``core.dtensor.whole``); a plain weight
    is whole on every rank (DTensor's implicit replication). The expert
    products run on this rank's E / gt experts for the gt groups of its
    data row, after the one movement: the expert regroup, an all-to-all
    over ``model`` each way. Where ``model`` does not divide the expert
    slots, each rank runs every expert on its own group, with no
    regroup."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from repro_torch.launch import mesh as mesh_lib
    gb, gt = grid
    b, t, d = x.shape
    e_pad = p["wi"].shape[0]
    ep = gt if e_pad % gt == 0 else 1
    mesh = x.device_mesh
    names = mesh_lib.axis_names(mesh)
    data = ("pod", "data")
    grid_pl = tuple(Shard(1) if a == "model" else
                    Shard(0) if a in data else Replicate() for a in names)
    whole_pl = (Replicate(),) * len(names)
    # each group's gradient is a partial sum over the groups
    partial = tuple(Partial() if a in data + ("model",) else Replicate()
                    for a in names)
    # this rank's E / ep experts; their gradients sum over the data axes'
    # groups and stay split over model
    e_pl = tuple(Shard(0) if a == "model" and ep > 1 else Replicate()
                 for a in names)
    e_grad = tuple(Shard(0) if a == "model" and ep > 1 else
                   Partial() if a in data + ("model",) else Replicate()
                   for a in names)
    w = {k: shard.whole(v if shard.is_dtensor(v) else DTensor.from_local(
             v, mesh, whole_pl, run_check=False),
             *((whole_pl, partial) if k == "router" else (e_pl, e_grad)))
         for k, v in p.items() if k in ("router", "wi", "wg", "wo")}
    xl = x.redistribute(mesh, grid_pl).to_local(grad_placements=grid_pl)
    weights, slot, keep, expert_in = _dispatch(
        ctx, w["router"], xl.reshape(-1, d), 1, capacity, **kw)
    if ep > 1:
        group = mesh.get_group("model")
        got = shard.all_to_all(
            expert_in.reshape(ep, e_pad // ep, capacity, d), group)
        out = _experts(_expert_major(got.reshape(-1, d), ep, capacity),
                       w["wi"], w["wg"], w["wo"], kw["activation"], x.dtype)
        out = shard.all_to_all(
            _group_major(out, ep).reshape(ep, -1, d), group).reshape(-1, d)
    else:
        out = _group_major(_experts(expert_in, w["wi"], w["wg"], w["wo"],
                                    kw["activation"], x.dtype), 1)
    y = _combine(out, slot, keep, weights, 1, **kw)
    return DTensor.from_local(y.reshape(b // gb, t // gt, d), mesh, grid_pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _offsets(groups, per_group, size, device):
    """Each of ``groups`` groups' first row, repeated for its
    ``per_group`` entries (a (G * per_group,) index), in rows of ``size``."""
    return torch.arange(groups, device=device).repeat_interleave(
        per_group) * size


def _dispatch(ctx, router, xf, groups, capacity, *, n_experts, top_k,
              router_weights_before, **_):
    """Routing, position-in-expert and the scatter, each group apart:
    xf (G * ntl, d) -> (weights (G * ntl * k,), slots (G * ntl * k,)
    within a group's E * capacity + 1 rows, kept, expert_in (E, G *
    capacity, d)). Each kept choice is written to its own row; the
    dropped ones all land on the group's spare last row, which no expert
    reads."""
    n, d = xf.shape
    e_pad = router.shape[-1]
    weights, gate_idx = route(ctx, {"router": router}, xf,
                              n_experts=n_experts, top_k=top_k)
    # capacity and position-in-expert, token-major over each group's
    # ntl * k choices
    flat = gate_idx.reshape(n * top_k)
    onehot = F.one_hot(flat, e_pad)
    cum = onehot.cumsum(0) if groups == 1 else \
        onehot.reshape(groups, -1, e_pad).cumsum(1).reshape(n * top_k, -1)
    pos = ((cum - 1) * onehot).sum(-1)
    keep = pos < capacity
    slot = torch.where(keep, flat * capacity + pos, e_pad * capacity)
    weights = weights.reshape(-1, 1)
    xin = xf.repeat_interleave(top_k, dim=0)
    if router_weights_before:
        xin = xin * weights
    rows = e_pad * capacity + 1

    def scatter(slot, xin):
        buf = xin.new_zeros((groups * rows, d))
        if groups > 1:
            slot = slot + _offsets(groups, n // groups * top_k, rows,
                                   slot.device)
        buf[slot] = xin
        return buf
    # DTensors: on whole operands where DTensor cannot propagate the
    # scatter (``core.dtensor.replicated_call``: torch 2.11)
    buf = shard.replicated_call(scatter, slot, xin, needs=_INDEX_PUT)
    if groups == 1:
        buf = buf[:-1]
    else:
        buf = buf.reshape(groups, rows, d)[:, :-1].reshape(-1, d)
    return weights, slot, keep, _expert_major(buf, groups, capacity)


def _expert_major(rows, groups, capacity):
    """(G * E * cap, d) rows, group-major -> (E, G * cap, d)."""
    d = rows.shape[-1]
    e = rows.shape[0] // (groups * capacity)
    if groups == 1:
        return rows.reshape(e, capacity, d)
    return rows.reshape(groups, e, capacity, d).transpose(0, 1) \
        .reshape(e, groups * capacity, d)


def _group_major(out, groups):
    """(E, G * cap, d) -> (G * E * cap, d) rows, group-major."""
    e, m, d = out.shape
    if groups == 1:
        return out.reshape(e * m, d)
    return out.reshape(e, groups, m // groups, d).transpose(0, 1) \
        .reshape(e * m, d)


def _experts(expert_in, wi, wg, wo, activation, dtype):
    """The gated expert FFNs, each expert over its rows: (E, M, d) against
    (E, d, ff) / (E, ff, d) -> (E, M, d) in ``dtype``. fp32 sums, the gated
    product rounded to ``dtype``."""
    act = layers._ACTS[activation]
    h = _bmm_f32(expert_in, wi)
    g = _bmm_f32(expert_in, wg)
    h = (act(g) * h).to(dtype)
    return _bmm_f32(h, wo).to(dtype)


def _combine(out, slot, keep, weights, groups, *, top_k,
             router_weights_before, **_):
    """out (G * E * cap, d) rows, group-major -> (G * ntl, d): gather each
    choice's row, zero the dropped, weight it in the model dtype and add
    a token's k rows in choice order, rounding after each add (the order
    of the JAX ``acc.at[tid].add``)."""
    d = out.shape[-1]
    per = out.shape[0] // groups
    idx = slot.clamp(max=per - 1)
    if groups > 1:
        idx = idx + _offsets(groups, idx.shape[0] // groups, per, idx.device)
    # DTensors: the gather's backward is a scatter (``_INDEX_PUT``)
    got = shard.replicated_call(lambda o, s: o[s], out, idx,
                                needs=_INDEX_PUT)
    got = torch.where(keep[:, None], got, 0.0)
    if not router_weights_before:
        got = got * weights
    got = got.reshape(-1, top_k, d)
    y = torch.zeros((got.shape[0], d), dtype=out.dtype, device=out.device)
    for j in range(top_k):
        y = y + got[:, j]
    return y


def aux_load_balance_loss(logits: torch.Tensor, gate_idx: torch.Tensor,
                          n_experts: int, top_k: int) -> torch.Tensor:
    """Switch-style auxiliary loss: E * sum(f_e * p_e), f_e the share of
    the choices ``gate_idx`` sends to expert e, p_e its mean router
    probability over the tokens (logits (N, e_pad), padded slots -inf)."""
    probs = torch.softmax(logits, dim=-1)[..., :n_experts]
    counts = torch.bincount(gate_idx.reshape(-1),
                            minlength=n_experts)[:n_experts].to(torch.float32)
    f = counts / counts.sum()
    pm = probs.mean(dim=0)
    return n_experts * torch.sum(f * pm)
