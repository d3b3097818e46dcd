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

Groups = 1 only: the JAX module's grouped dispatch (``_dispatch_grid``,
the ``moe_grouped_dispatch`` flag) reads the current device mesh
(``launch.mesh.activate_mesh``) and is the next multi-device slice
(ROADMAP A15b). The training forward calls
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

from repro_torch.models import layers

Params = Dict[str, Any]


def pad_experts(n_experts: int, ep: int) -> int:
    """Number of expert slots after padding to the EP degree."""
    return ((n_experts + ep - 1) // ep) * ep


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
    e_pad = p["wi"].shape[0]
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


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a (E, M, K) @ b (E, K, N) as fp32 products summed in fp32, written
    fp32: the JAX ``einsum(..., preferred_element_type=float32)``. On the
    card 16-bit operands go to one ``bmm`` with an fp32 output; the CPU's
    ``bmm`` has no such overload, so there they are widened first, which
    computes the same function."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def moe_apply(ctx, p: Params, x: torch.Tensor, *, n_experts: int,
              top_k: int, capacity_factor: float = 1.25,
              activation: str = "silu", router_weights_before: bool = False,
              dropless: bool = False) -> torch.Tensor:
    """x: (B, T, D) -> (B, T, D) in x's dtype.

    ``router_weights_before``: llama4 scales the expert *input* by the
    (sigmoid) weight; granite scales the expert *output* by the softmax
    weight. ``dropless``: capacity = tokens, no token dropped (every
    serving entry); otherwise ``max(1, int(capacity_factor * tokens *
    top_k / n_experts))`` with the GShard drops."""
    b, t, d = x.shape
    e_pad = p["wi"].shape[0]
    n = b * t
    xf = x.reshape(n, d)
    weights, gate_idx = route(ctx, p, xf, n_experts=n_experts, top_k=top_k)

    # capacity and position-in-expert, token-major over the n * k choices
    capacity = n if dropless else \
        max(1, int(capacity_factor * n * top_k / n_experts))
    flat = gate_idx.reshape(n * top_k)
    onehot = F.one_hot(flat, e_pad)
    pos = ((onehot.cumsum(0) - 1) * onehot).sum(-1)
    keep = pos < capacity
    slot = torch.where(keep, flat * capacity + pos, e_pad * capacity)

    # dispatch: each kept choice written to its own row; the dropped ones
    # all land on the spare last row, which no expert reads
    xin = xf.repeat_interleave(top_k, dim=0)
    if router_weights_before:
        xin = xin * weights.reshape(-1, 1)
    buf = x.new_zeros((e_pad * capacity + 1, d))
    buf[slot] = xin
    expert_in = buf[:-1].reshape(e_pad, capacity, d)

    # expert FFNs: fp32 sums, the gated product rounded to x's dtype
    act = layers._ACTS[activation]
    h = _bmm_f32(expert_in, p["wi"])
    g = _bmm_f32(expert_in, p["wg"])
    h = (act(g) * h).to(x.dtype)
    out = _bmm_f32(h, p["wo"]).to(x.dtype).reshape(e_pad * capacity, d)

    # combine: gather, zero the dropped, weight, add in choice order
    got = out[slot.clamp(max=e_pad * capacity - 1)]
    got = torch.where(keep[:, None], got, 0.0)
    if not router_weights_before:
        got = got * weights.reshape(-1, 1)
    got = got.reshape(n, top_k, d)
    y = torch.zeros((n, d), dtype=x.dtype, device=x.device)
    for j in range(top_k):
        y = y + got[:, j]
    y = y.reshape(b, t, d)

    if "shared" in p:
        y = y + layers.mlp_apply(ctx, p["shared"], x, activation=activation)
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
