"""The Mamba-2 mixer (port of ``repro.models.ssm``).

in_proj -> causal depthwise conv -> chunked SSD -> gate -> out_proj, with
heads H of dim P, state size N and G B/C groups (grouped like GQA). The
chunked SSD runs through ``ctx.ssd``: the CUDA kernel on a card, its plain
version on the CPU. A one-token step (decode) is the recurrence itself in
plain torch ops on either device, as in the JAX package, where it has no
kernel either. The train route (no cache) takes :func:`ssd_chunked`, the
port of the JAX model function ``ssd_chunked_xla``.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import dtensor as shard
from repro_torch.models import layers

Params = Dict[str, Any]


class SSMCache(NamedTuple):
    conv: torch.Tensor               # (B, K-1, conv_dim)
    # (B, H, N, P) carried recurrent state, or None for a FRESH prefill
    # (semantically zeros).
    state: Optional[torch.Tensor]


def mamba2_init(gen: torch.Generator, n_layers: int, d_model: int, *,
                d_inner: int, n_heads: int, d_state: int, n_groups: int = 1,
                d_conv: int = 4, dtype=torch.bfloat16, device="cpu") -> Params:
    """Layer-stacked (L, ...) Mamba-2 parameters: the JAX package's tree
    (``mamba2_init`` per layer, stacked), numbers from ``gen``."""
    conv_dim = d_inner + 2 * n_groups * d_state
    in_dim = 2 * d_inner + 2 * n_groups * d_state + n_heads   # z,x,B,C,dt
    L = n_layers

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32)

    a_log = torch.log(torch.linspace(1.0, 16.0, n_heads, device=device))
    return {
        "in_proj": (normal(L, d_model, in_dim) / math.sqrt(d_model)).to(dtype),
        "conv_w": (normal(L, d_conv, conv_dim) / math.sqrt(d_conv)).to(dtype),
        "a_log": a_log[None].repeat(L, 1),
        "d_skip": torch.ones((L, n_heads), dtype=torch.float32,
                             device=device),
        "dt_bias": torch.zeros((L, n_heads), dtype=torch.float32,
                               device=device),
        "norm": torch.zeros((L, d_inner), dtype=torch.float32, device=device),
        "out_proj": (normal(L, d_inner, d_model) / math.sqrt(d_inner)
                     ).to(dtype),
    }


def _split_in_proj(zxbcdt, d_inner, n_groups, d_state, n_heads):
    splits = [d_inner, 2 * d_inner, 2 * d_inner + n_groups * d_state,
              2 * d_inner + 2 * n_groups * d_state]
    z = zxbcdt[..., :splits[0]]
    x = zxbcdt[..., splits[0]:splits[1]]
    b = zxbcdt[..., splits[1]:splits[2]]
    c = zxbcdt[..., splits[2]:splits[3]]
    dt = zxbcdt[..., splits[3]:]
    return z, x, b, c, dt


def ssd_chunked(x, dt, a_log, b, c, *, d_skip=None, chunk: int = 256,
                initial_state=None) -> torch.Tensor:
    """The port of ``repro.models.ssm.ssd_chunked_xla``, op for op: x (B,
    T, H, P), dt (B, T, H), a_log (H,), b / c (B, T, G, N) -> y (B, T, H,
    P) in x's dtype. ``initial_state`` (B, H, N, P) fp32 resumes a previous
    segment; None starts from zeros.

    Autograd differentiates it (the decay matrix is masked before its
    exponential, so the backward never meets inf * 0), so it is the
    training forward's SSD: the JAX package trains on this route on every
    backend, because its Pallas SSD kernel has no VJP
    (``repro/models/ssm.py:211-217``). It is also the plain version the SSD
    kernels are held against (``repro_torch.kernels.mamba2.ssd_plain``)."""
    bsz, t, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    hpg = h // g
    q = min(chunk, t)
    pad = (-t) % q
    f32 = torch.float32
    xf, dtf = x.to(f32), dt.to(f32)
    bf, cf = b.to(f32), c.to(f32)
    if pad:
        def pad_time(v):
            return F.pad(v, (0, 0) * (v.ndim - 2) + (0, pad))
        xf, dtf, bf, cf = (shard.local_along(pad_time, v, 1)
                           for v in (xf, dtf, bf, cf))
    tt = t + pad
    nc = tt // q

    a = -torch.exp(a_log.to(f32))
    xf = xf.reshape(bsz, nc, q, h, p)
    dtf = dtf.reshape(bsz, nc, q, h)
    bf = bf.reshape(bsz, nc, q, g, n).repeat_interleave(hpg, dim=3)
    cf = cf.reshape(bsz, nc, q, g, n).repeat_interleave(hpg, dim=3)

    seg = shard.local_along(lambda v: torch.cumsum(v, dim=2), dtf * a,
                            2)                                 # inclusive
    # L[i, j] = exp(seg_i - seg_j) for i >= j: masked BEFORE exp, so the
    # i < j branch (a positive exponent) never overflows.
    li = seg[:, :, :, None, :] - seg[:, :, None, :, :]         # (B,nc,Qi,Qj,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool,
                                device=x.device))[None, None, :, :, None]
    zero = torch.zeros((), dtype=f32, device=x.device)
    ldec = torch.where(tri, torch.exp(torch.where(tri, li, zero)), zero)

    scores = torch.einsum("bcihn,bcjhn->bcijh", cf, bf)
    y_diag = torch.einsum("bcijh,bcjh,bcjhp->bcihp", scores * ldec, dtf, xf)

    decay_to_end = torch.exp(seg[:, :, -1:, :] - seg)          # (B,nc,Q,H)
    s_chunk = torch.einsum("bcjh,bcjh,bcjhn,bcjhp->bchnp",
                           decay_to_end, dtf, bf, xf)          # (B,nc,H,N,P)
    chunk_decay = torch.exp(seg[:, :, -1, :])                  # (B,nc,H)

    state = torch.zeros((bsz, h, n, p), dtype=f32, device=x.device) \
        if initial_state is None else initial_state.to(f32)
    y_off = []
    for ci in range(nc):
        y_off.append(torch.einsum("bihn,bhnp,bih->bihp", cf[:, ci], state,
                                  torch.exp(seg[:, ci])))
        state = state * chunk_decay[:, ci, :, None, None] + s_chunk[:, ci]
    y = y_diag + torch.stack(y_off, dim=1)                     # (B,nc,Q,H,P)
    y = y.reshape(bsz, tt, h, p)[:, :t]
    if d_skip is not None:
        y = y + d_skip[None, None, :, None] * x.to(f32)
    return y.to(x.dtype)


def ssd_decode_step(state, x_t, dt_t, a_log, b_t, c_t, *, d_skip=None):
    """One-token recurrence. state (B, H, N, P) fp32, x_t (B, H, P), dt_t
    (B, H), b_t/c_t (B, G, N). Returns (y_t in x_t's dtype, new state)."""
    h = state.shape[1]
    hpg = h // b_t.shape[1]
    f32 = torch.float32
    a = -torch.exp(a_log.to(f32))
    bh = b_t.to(f32).repeat_interleave(hpg, dim=1)             # (B, H, N)
    ch = c_t.to(f32).repeat_interleave(hpg, dim=1)
    da = torch.exp(dt_t.to(f32) * a[None, :])                  # (B, H)
    state = state * da[..., None, None] + torch.einsum(
        "bh,bhn,bhp->bhnp", dt_t.to(f32), bh, x_t.to(f32))
    y = torch.einsum("bhnp,bhn->bhp", state, ch)
    if d_skip is not None:
        y = y + d_skip[None, :, None] * x_t.to(f32)
    return y.to(x_t.dtype), state


def mamba2_apply(ctx, p: Params, u: torch.Tensor, *, d_inner: int,
                 n_heads: int, d_state: int, n_groups: int = 1,
                 chunk: int = 256, cache: Optional[SSMCache] = None
                 ) -> Tuple[torch.Tensor, Optional[SSMCache]]:
    """u: (B, T, d_model) -> (y, new cache). T == 1 with a cache decodes
    one token; a longer T with a cache is an inference prefill (fresh when
    ``cache.state`` is None, resumed otherwise) through ``ctx.ssd``."""
    bsz, t, _ = u.shape
    p_dim = d_inner // n_heads
    zxbcdt = layers.project(ctx, u, p["in_proj"])
    z, xin, b, c, dt = _split_in_proj(zxbcdt, d_inner, n_groups, d_state,
                                      n_heads)
    dt = F.softplus(dt.to(torch.float32) + p["dt_bias"][None, None, :])

    # x, B and C sit side by side in the projection: one view, no concat.
    xbc = zxbcdt[..., d_inner:2 * d_inner + 2 * n_groups * d_state]
    conv_state = cache.conv if cache is not None else None
    xbc, new_conv = layers.causal_conv1d(xbc, p["conv_w"], conv_state)
    xbc = F.silu(xbc)
    gn = n_groups * d_state
    xh = xbc[..., :d_inner].reshape(bsz, t, n_heads, p_dim)
    bh = xbc[..., d_inner:d_inner + gn].reshape(bsz, t, n_groups, d_state)
    ch = xbc[..., d_inner + gn:].reshape(bsz, t, n_groups, d_state)

    if cache is not None and t == 1:
        st0 = cache.state
        if st0 is None:                      # one-token fresh prefill
            st0 = torch.zeros((bsz, n_heads, d_state, p_dim),
                              dtype=torch.float32, device=u.device)
        y, new_state = ssd_decode_step(st0, xh[:, 0], dt[:, 0], p["a_log"],
                                       bh[:, 0], ch[:, 0], d_skip=p["d_skip"])
        y = y[:, None]
        new_cache = SSMCache(new_conv, new_state)
    elif cache is not None:
        y, final_state = ctx.ssd(xh, dt, p["a_log"], bh, ch,
                                 d_skip=p["d_skip"], chunk=chunk,
                                 initial_state=cache.state,
                                 return_final_state=True)
        new_cache = SSMCache(new_conv, final_state)
    else:
        # Train / forward route: the chunked model function, as the JAX
        # package's on every backend (its SSD kernel has no VJP).
        y = ssd_chunked(xh, dt, p["a_log"], bh, ch, d_skip=p["d_skip"],
                        chunk=chunk)
        new_cache = None

    y = y.reshape(bsz, t, d_inner)
    y = layers.rmsnorm(y * F.silu(z.to(torch.float32)).to(y.dtype), p["norm"])
    return layers.project(ctx, y, p["out_proj"]), new_cache
