"""Decoder stack (port of ``repro.models.transformer``): the paged entries
of the continuous-batching engine, the static reference path (one dense KV
cache) and the training forward and loss (:func:`forward`,
:func:`loss_fn`).

The families are dense (incl. musicgen's summed codebook embeddings and
per-codebook heads), moe (attention, then a routed expert FFN:
:mod:`repro_torch.models.moe`, dropless on every serving entry, capacity
bound in training), ssm (Mamba-2 blocks, no attention) and hybrid
(hymba: attention and Mamba-2 side by side in every block, meta tokens in
front of the prompt). Another family raises ``NotImplementedError``.

The parameter tree is the JAX package's: per-layer weights stacked along a
leading ``L`` axis, the same names, the same (d_in, d_out) layout, so
``repro_torch.convert`` moves JAX parameters across as they are. Layers run
in a Python loop, so each layer's sliding window is a static int and the
attention kernels run on gemma's local and global layers alike (the JAX
package scans windows as traced data and demotes such models to XLA).
Caches and recurrent state are written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint

from repro_torch.core import dtensor as shard
from repro_torch.core import flags
from repro_torch.core import tree as tu
from repro_torch.kernels import gemm as gemm_kernel
from repro_torch.models import attention as attn
from repro_torch.models import layers, moe, ssm

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Copy of ``repro.models.transformer.ModelConfig``; ``dtype`` is a
    torch dtype."""

    name: str
    family: str                       # dense | moe | ssm | hybrid
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    activation: str = "silu"
    qkv_bias: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    local_window: Optional[int] = None
    global_period: int = 0
    rope_base: float = 10000.0
    rope_base_local: Optional[float] = None
    post_norms: bool = False
    qk_norm: bool = False
    embed_scale: bool = False
    tie_embeddings: bool = True
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared_experts: int = 0
    router_weights_before: bool = False
    capacity_factor: float = 1.25
    expert_padding: int = 16
    d_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    d_conv: int = 4
    ssm_chunk: int = 256
    modality: str = "none"
    n_codebooks: int = 1
    n_meta_tokens: int = 0
    dtype: Any = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def has_attn(self) -> bool:
        return self.family in ("dense", "moe", "hybrid")

    @property
    def has_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.ssm_groups * self.d_state

    def param_count(self) -> int:
        """Analytic parameter count (for MODEL_FLOPS roofline terms)."""
        d, l = self.d_model, self.n_layers
        n = self.vocab * d * self.n_codebooks          # embed
        if not self.tie_embeddings or self.n_codebooks > 1:
            n += self.vocab * d * self.n_codebooks     # unembed heads
        per_layer = 0
        if self.has_attn:
            per_layer += d * (self.n_heads + 2 * self.n_kv_heads) * \
                self.head_dim + self.n_heads * self.head_dim * d
        if self.has_ssm:
            in_dim = 2 * self.d_inner + 2 * self.ssm_groups * self.d_state \
                + self.n_ssm_heads
            per_layer += d * in_dim + self.d_inner * d
        if self.family == "moe":
            e = self.n_experts
            per_layer += d * e                                   # router
            per_layer += 3 * d * self.moe_d_ff * e               # experts
            if self.n_shared_experts:
                per_layer += 3 * d * self.moe_d_ff * self.n_shared_experts
        elif self.family in ("dense", "hybrid") and self.d_ff:
            per_layer += 3 * d * self.d_ff
        return n + l * per_layer

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts)."""
        if self.family != "moe":
            return self.param_count()
        d, l, e = self.d_model, self.n_layers, self.n_experts
        full = self.param_count()
        inactive = l * 3 * d * self.moe_d_ff * (e - self.top_k)
        return full - inactive


def _require_ported(cfg: ModelConfig) -> None:
    if cfg.family not in ("dense", "moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not one the port serves "
            f"(dense, moe, ssm, hybrid)")


def layer_windows(cfg: ModelConfig) -> np.ndarray:
    """Per-layer sliding-window sizes; 0 encodes 'global'."""
    win = np.zeros((cfg.n_layers,), np.int32)
    if cfg.local_window:
        for i in range(cfg.n_layers):
            is_global = (cfg.global_period > 0 and
                         (i + 1) % cfg.global_period == 0)
            win[i] = 0 if is_global else cfg.local_window
    return win


def layer_rope_bases(cfg: ModelConfig) -> np.ndarray:
    base = np.full((cfg.n_layers,), cfg.rope_base, np.float32)
    if cfg.rope_base_local is not None and cfg.local_window:
        for i in range(cfg.n_layers):
            is_global = (cfg.global_period > 0 and
                         (i + 1) % cfg.global_period == 0)
            if not is_global:
                base[i] = cfg.rope_base_local
    return base


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------
def init_params(gen: torch.Generator, cfg: ModelConfig, *,
                device=None) -> Params:
    """Random parameters from a seeded generator, on ``device`` (default:
    the generator's). Same tree, names and stacked (L, ...) layout as the
    JAX package; the numbers differ (torch and jax draw differently), so
    tests convert JAX parameters through :mod:`repro_torch.convert`."""
    _require_ported(cfg)
    device = torch.device(device) if device is not None else gen.device
    L, d, dt = cfg.n_layers, cfg.d_model, cfg.dtype

    def dense(d_in, d_out):
        return (torch.randn((L, d_in, d_out), generator=gen, device=device)
                / d_in ** 0.5).to(dt)

    def norm(n):
        return torch.zeros((L, n), dtype=torch.float32, device=device)

    blocks: Params = {"ln1": norm(d)}
    if cfg.has_attn:
        hq, hk = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
        att = {"wq": dense(d, hq), "wk": dense(d, hk), "wv": dense(d, hk),
               "wo": dense(hq, d)}
        if cfg.qkv_bias:
            for name, n in (("bq", hq), ("bk", hk), ("bv", hk)):
                att[name] = torch.zeros((L, n), dtype=dt, device=device)
        blocks["attn"] = att
        if cfg.qk_norm:
            blocks["qnorm"] = norm(cfg.head_dim)
            blocks["knorm"] = norm(cfg.head_dim)
    if cfg.has_ssm:
        blocks["mamba"] = ssm.mamba2_init(
            gen, L, d, d_inner=cfg.d_inner, n_heads=cfg.n_ssm_heads,
            d_state=cfg.d_state, n_groups=cfg.ssm_groups, d_conv=cfg.d_conv,
            dtype=dt, device=device)
    if cfg.family == "moe":
        blocks["ln2"] = norm(d)
        blocks["moe"] = moe.moe_init(
            gen, d, cfg.moe_d_ff, cfg.n_experts, ep=cfg.expert_padding,
            n_shared=cfg.n_shared_experts, n_layers=L, dtype=dt,
            device=device)
    elif cfg.d_ff and cfg.family != "ssm":
        blocks["ln2"] = norm(d)
        blocks["mlp"] = {"wi": dense(d, cfg.d_ff), "wo": dense(cfg.d_ff, d),
                         "wg": dense(d, cfg.d_ff)}
    if cfg.post_norms:
        blocks["post_ln1"] = norm(d)
        if "ln2" in blocks:
            blocks["post_ln2"] = norm(d)
    if cfg.family == "hybrid":
        blocks["attn_out_norm"] = norm(d)
        blocks["ssm_out_norm"] = norm(d)

    def embed():
        return layers.embed_init(gen, cfg.vocab, d, dtype=dt, device=device)

    def head():
        return layers.dense_init(gen, d, cfg.vocab, dtype=dt, device=device)

    cb = cfg.n_codebooks
    p: Params = {"embed": torch.stack([embed() for _ in range(cb)])
                 if cb > 1 else embed(),
                 "blocks": blocks,
                 "final_norm": layers.rmsnorm_init(d, device=device)}
    if cb > 1:
        p["heads"] = torch.stack([head() for _ in range(cb)])
    elif not cfg.tie_embeddings:
        p["unembed"] = head()
    if cfg.n_meta_tokens:
        p["meta_tokens"] = (torch.randn((cfg.n_meta_tokens, d), generator=gen,
                                        device=device) * 0.02).to(dt)
    return p


# Param names that are engine-backed (d_in, d_out) projection weights
# (``repro.models.transformer._PROJ_KEYS``). MoE expert stacks are
# excluded: their GEMMs run as one ``bmm`` in models/moe.py, not through
# ctx.gemm, so they never resolve a schedule.
_PROJ_KEYS = frozenset({"wq", "wk", "wv", "wo", "wi", "wg", "router",
                        "in_proj", "out_proj", "unembed", "heads"})


def model_gemm_calls(cfg: ModelConfig, batch: int, seq: int, *,
                     include_decode: bool = True) -> list:
    """Every engine GEMM the model's projections run, as (M, N, K,
    has_bias, fp32 input, B transposed): the (batch*seq) prefill / train
    GEMM and the (batch) decode GEMM of each projection weight's trailing
    (d_in, d_out), walked from the parameter tree on the meta device (no
    allocation). The last two fields are what the card plan also reads:
    the MoE router multiplies fp32 activations, and the tied unembedding
    reads the embedding table transposed in place."""
    params = init_params(torch.Generator(), cfg, device="meta")
    ms = [batch * seq] + ([batch] if include_decode else [])

    def walk(node, names):
        if isinstance(node, dict):
            for key in sorted(node):    # jax.tree_util's leaf order
                yield from walk(node[key], names + (key,))
        else:
            yield names, node

    leaves = list(walk(params, ()))
    siblings: dict = {}
    for names, _ in leaves:
        siblings.setdefault(names[:-1], set()).add(names[-1])
    out, seen = [], set()
    for names, leaf in leaves:
        if leaf.dim() < 2:
            continue
        name = names[-1]
        b_trans = False
        if "moe" in names and name in ("wi", "wg", "wo"):
            continue
        if name in _PROJ_KEYS:
            k_in, n_out = leaf.shape[-2], leaf.shape[-1]
        elif name == "embed" and cfg.tie_embeddings and cfg.n_codebooks == 1:
            k_in, n_out = leaf.shape[-1], leaf.shape[-2]   # unembed: table.T
            b_trans = True
        else:
            continue
        has_bias = (name.startswith("w")
                    and "b" + name[1:] in siblings.get(names[:-1], ()))
        for m in ms:
            t = (int(m), int(n_out), int(k_in), bool(has_bias),
                 name == "router", b_trans)
            if t not in seen:
                seen.add(t)
                out.append(t)
    return out


def model_gemm_shapes(cfg: ModelConfig, batch: int, seq: int, *,
                      include_decode: bool = True) -> list:
    """Every (M, N, K, has_bias) GEMM shape the model's projections run
    (``repro.models.transformer.model_gemm_shapes``, the same list in the
    same order): :func:`model_gemm_calls` without the card plan's fields."""
    out, seen = [], set()
    for call in model_gemm_calls(cfg, batch, seq,
                                 include_decode=include_decode):
        if call[:4] not in seen:
            seen.add(call[:4])
            out.append(call[:4])
    return out


def model_attention_shapes(cfg: ModelConfig, batch: int, seq: int) -> list:
    """Every (B, Tq, Tk, H, KVH, D, causal, window) flash-attention shape
    the model runs at this (batch, seq): one per distinct per-layer window
    (``repro.models.transformer.model_attention_shapes``)."""
    if not cfg.has_attn:
        return []
    out = []
    for w in sorted({int(w) for w in layer_windows(cfg)}):
        out.append((batch, seq, seq, cfg.n_heads, cfg.n_kv_heads,
                    cfg.head_dim, True, None if w == 0 else w))
    return out


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s slice of the stacked block tree (views, no copies)."""
    def take(node):
        if isinstance(node, dict):
            return {k: take(v) for k, v in node.items()}
        return node[i]
    return take(params["blocks"])




# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------
def _attn_branch(ctx, cfg: ModelConfig, bp: Params, h: torch.Tensor,
                 positions: torch.Tensor, window: int, rope_base: float,
                 cache, cache_pos: Optional[int] = None,
                 prefill_start: Optional[int] = None,
                 kv_pages: Optional[int] = None):
    """window: static int, 0 = global. ``cache``: None (the training
    forward), a paged :class:`attn.PagedKVCache` (the engine) or a dense
    :class:`attn.KVCache` written at ``cache_pos`` (the static path).
    ``prefill_start``: cache position of a continuation chunk's first
    token (None = fresh prefill or decode). Returns (out, cache)."""
    b, t, _ = h.shape
    p = bp["attn"]
    q = layers.project(ctx, h, p["wq"], p.get("bq")).reshape(
        b, t, cfg.n_heads, cfg.head_dim)
    k = layers.project(ctx, h, p["wk"], p.get("bk")).reshape(
        b, t, cfg.n_kv_heads, cfg.head_dim)
    v = layers.project(ctx, h, p["wv"], p.get("bv")).reshape(
        b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = layers.rmsnorm(q, bp["qnorm"])
        k = layers.rmsnorm(k, bp["knorm"])
    q = layers.rope(q, positions, base=rope_base)
    k = layers.rope(k, positions, base=rope_base)

    if cache is None:
        # the training forward: the differentiable model function, not the
        # flash kernel (``attn.blockwise_attention``)
        o = attn.blockwise_attention(q, k, v, causal=True,
                                     window=window or None,
                                     softcap=cfg.attn_softcap)
    elif isinstance(cache, attn.KVCache):
        cache = attn.update_cache(cache, k, v, cache_pos)
        if t == 1:
            o = attn.decode_attention(ctx, q, cache, cache_pos, window=window,
                                      softcap=cfg.attn_softcap)
        else:
            # prefill from position 0: attend the t positions just written
            o = attn.attn_op(ctx, q, cache.k[:, :t], cache.v[:, :t],
                             causal=True, window=window,
                             softcap=cfg.attn_softcap)
    # The continuation test precedes the t == 1 decode test: a final chunk
    # may be one token long.
    elif prefill_start is not None:
        cache = attn.paged_update_prefill(cache, k, v, cache.tables[0],
                                          start=prefill_start)
        o = attn.paged_prefill_attn_op(ctx, q, cache, prefill_start,
                                       window=window, softcap=cfg.attn_softcap,
                                       kv_pages=kv_pages)
    elif t == 1:
        cache = attn.paged_update_decode(cache, k, v, cache.active,
                                         cache.trash)
        o = attn.paged_attn_op(ctx, q, cache, window=window,
                               softcap=cfg.attn_softcap)
    else:
        # fresh prefill: the prompt attends only itself; the pool is
        # write-only here.
        cache = attn.paged_update_prefill(cache, k, v, cache.tables[0])
        o = attn.attn_op(ctx, q, k, v, causal=True, window=window,
                         softcap=cfg.attn_softcap)
    o = o.reshape(b, t, cfg.n_heads * cfg.head_dim)
    return layers.project(ctx, o, p["wo"]), cache


def _block_apply(ctx, cfg: ModelConfig, bp: Params, h: torch.Tensor,
                 positions, window: int, rope_base: float, kv_cache=None,
                 ssm_cache: Optional[ssm.SSMCache] = None,
                 cache_pos: Optional[int] = None, prefill_start=None,
                 kv_pages=None):
    """One decoder block. Returns (h, kv_cache, ssm_cache)."""
    x = layers.rmsnorm(h, bp["ln1"])
    outs = []
    if cfg.has_attn:
        a_out, kv_cache = _attn_branch(ctx, cfg, bp, x, positions, window,
                                       rope_base, kv_cache, cache_pos,
                                       prefill_start=prefill_start,
                                       kv_pages=kv_pages)
        outs.append(a_out)
    if cfg.has_ssm:
        s_out, ssm_cache = ssm.mamba2_apply(
            ctx, bp["mamba"], x, d_inner=cfg.d_inner,
            n_heads=cfg.n_ssm_heads, d_state=cfg.d_state,
            n_groups=cfg.ssm_groups, chunk=cfg.ssm_chunk, cache=ssm_cache)
        outs.append(s_out)
    if cfg.family == "hybrid":
        # per-branch output norms, then the average in fp32 (hymba)
        a = layers.rmsnorm(outs[0], bp["attn_out_norm"])
        s = layers.rmsnorm(outs[1], bp["ssm_out_norm"])
        mixed = (0.5 * (a.to(torch.float32) + s.to(torch.float32))
                 ).to(h.dtype)
    else:
        mixed = outs[0]
    if cfg.post_norms:
        mixed = layers.rmsnorm(mixed, bp["post_ln1"])
    h = h + mixed
    if "moe" in bp or "mlp" in bp:
        x2 = layers.rmsnorm(h, bp["ln2"])
        if "moe" in bp:
            # The JAX package's ``serving`` test: an entry with a cache
            # serves and drops no token; the training forward (no cache)
            # keeps the capacity bound.
            serving = kv_cache is not None or ssm_cache is not None
            f = moe.moe_apply(ctx, bp["moe"], x2, n_experts=cfg.n_experts,
                              top_k=cfg.top_k,
                              capacity_factor=cfg.capacity_factor,
                              activation=cfg.activation,
                              router_weights_before=cfg.router_weights_before,
                              dropless=serving)
        else:
            f = layers.mlp_apply(ctx, bp["mlp"], x2,
                                 activation=cfg.activation)
        if cfg.post_norms:
            f = layers.rmsnorm(f, bp["post_ln2"])
        h = h + f
    return h, kv_cache, ssm_cache


def _embed_tokens(cfg: ModelConfig, params: Params,
                  tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) or, with codebooks, (B, T, n_q): musicgen sums the
    per-codebook embeddings."""
    if cfg.n_codebooks > 1:
        return sum(layers.embed_apply(params["embed"][i], tokens[..., i])
                   for i in range(cfg.n_codebooks))
    return layers.embed_apply(params["embed"], tokens,
                              scale_by_sqrt_dim=cfg.embed_scale)


def embed_inputs(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
                 extra_embeds: Optional[torch.Tensor] = None, *,
                 with_meta: bool = True) -> torch.Tensor:
    """Token embeddings, the ``extra_embeds`` (B, Ti, D) prefix (precomputed
    VLM patch or audio-frame embeddings, the frontend stub) in front of
    them, then hymba's meta tokens in front of all, in the JAX package's
    order; ``with_meta=False`` leaves the meta tokens out (a continuation
    chunk: they live at cache positions [0, n_meta))."""
    _require_ported(cfg)
    h = _embed_tokens(cfg, params, tokens)
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h], dim=1)
    if cfg.n_meta_tokens and with_meta:
        meta = params["meta_tokens"][None].expand(
            h.shape[0], cfg.n_meta_tokens, cfg.d_model)
        h = torch.cat([meta.to(h.dtype), h], dim=1)
    return h


def unembed(ctx, cfg: ModelConfig, params: Params,
            h: torch.Tensor) -> torch.Tensor:
    """fp32 logits (B, T, V), or (B, T, n_q, V) with codebooks."""
    h = layers.rmsnorm(h, params["final_norm"])
    if cfg.n_codebooks > 1:
        return torch.stack([layers.project(ctx, h, params["heads"][i])
                            for i in range(cfg.n_codebooks)],
                           dim=-2).to(torch.float32)
    if cfg.tie_embeddings:
        return layers.unembed_apply(ctx, params["embed"], h,
                                    softcap=cfg.final_softcap)
    logits = layers.project(ctx, h, params["unembed"]).to(torch.float32)
    if cfg.final_softcap:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    return logits


# ---------------------------------------------------------------------------
# full forward (train / prefill) and the loss
# ---------------------------------------------------------------------------
def _unbound_blocks(blocks: Params, n_layers: int):
    """Per-layer block trees from one ``unbind`` of each stacked leaf of
    ``blocks``. Autograd then stacks the layers' gradients once per leaf
    (``UnbindBackward``), where a ``select`` per layer would write each
    layer's gradient into a zeroed copy of the whole stack."""
    def split(node):
        if isinstance(node, dict):
            return {k: split(v) for k, v in node.items()}
        return node.unbind(0)

    def take(node, i):
        if isinstance(node, dict):
            return {k: take(v, i) for k, v in node.items()}
        return node[i]
    parts = split(blocks)
    return [take(parts, i) for i in range(n_layers)]


def apply_blocks(ctx, cfg: ModelConfig, blocks: Params, h: torch.Tensor,
                 positions: torch.Tensor, *, first: int = 0,
                 remat: bool = False, residual_sharding=None
                 ) -> torch.Tensor:
    """The residual ``h`` through the stacked ``blocks`` (a leading axis of
    n layers), which are the model's layers ``first`` .. ``first + n - 1``:
    each layer's static window and rope base are those of its index in
    the whole model (gemma3's local / global pattern), so a pipeline stage
    holding layers 13-25 runs them as :func:`forward` does. ``remat`` and
    ``residual_sharding`` as in :func:`forward`."""
    n = tu.leaves(blocks)[0].shape[0]
    win, bases = layer_windows(cfg), layer_rope_bases(cfg)
    policy = flags.get("remat_policy") if remat else "none"
    ckpt_kw = dict(use_reentrant=False)
    if policy == "dots":
        ckpt_kw["context_fn"] = gemm_kernel.gemm_tape
    for i, bp in enumerate(_unbound_blocks(blocks, n), start=first):
        def body(h, bp=bp, window=int(win[i]), base=float(bases[i])):
            return shard.constrain(
                _block_apply(ctx, cfg, bp, h, positions, window, base)[0],
                residual_sharding)
        if policy == "none":
            h = body(h)
        else:
            h = torch.utils.checkpoint.checkpoint(body, h, **ckpt_kw)
    return h


def forward(ctx, params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            extra_embeds: Optional[torch.Tensor] = None, *,
            remat: bool = False, residual_sharding=None,
            logits_sharding=None) -> torch.Tensor:
    """The training (and whole-sequence) forward: tokens (B, T) [or (B, T,
    n_q)], ``extra_embeds`` (B, Ti, D) or None -> fp32 logits over every
    position (prefix and meta tokens included), as the JAX ``forward``.

    Layers run in a Python loop with static windows and rope bases.
    Attention is :func:`attn.blockwise_attention` and the SSD
    :func:`ssm.ssd_chunked`, the model functions autograd differentiates
    (the JAX package keeps training off its Pallas kernels for want of a
    VJP, ``repro/models/transformer.py:518-524``); every projection runs
    the engine GEMM, whose backward products run on the same kernels
    (``kernels.gemm._GemmGrad``). A MoE block keeps its capacity bound.

    ``remat``: each block under ``torch.utils.checkpoint`` (non-reentrant),
    by ``flags.get("remat_policy")``: ``full`` saves nothing and recomputes
    the block in the backward, ``dots`` saves the engine GEMMs' outputs
    (``gemm_kernel.gemm_tape``) and recomputes the rest, ``none`` saves
    everything (no checkpoint).

    ``residual_sharding`` / ``logits_sharding``: ``(mesh, placements)``
    the (B, T, D) residual between blocks and the logits are redistributed
    to when they are DTensors (``core.dtensor.constrain``, the JAX
    forward's sharding constraints); None leaves them as they come."""
    _require_ported(cfg)
    h = embed_inputs(cfg, params, tokens, extra_embeds)
    h = shard.constrain(h, residual_sharding)
    h = apply_blocks(ctx, cfg, params["blocks"], h, positions_of(h),
                     remat=remat, residual_sharding=residual_sharding)
    return shard.constrain(unembed(ctx, cfg, params, h), logits_sharding)


def positions_of(h: torch.Tensor) -> torch.Tensor:
    """(B, T) positions 0 .. T-1 of a (B, T, D) residual."""
    b, t = h.shape[0], h.shape[1]
    return torch.arange(t, device=h.device)[None].expand(b, t)


def loss_fn(ctx, params: Params, cfg: ModelConfig, tokens: torch.Tensor,
            labels: torch.Tensor, extra_embeds: Optional[torch.Tensor] = None,
            **fwd_kw) -> torch.Tensor:
    """Next-token cross-entropy (fp32 scalar); labels == -100 are masked.
    The prefix and meta positions carry no loss; with codebooks the loss
    averages over every codebook's targets."""
    logits = forward(ctx, params, cfg, tokens, extra_embeds, **fwd_kw)
    return loss_from_logits(cfg, logits, labels, 0 if extra_embeds is None
                            else extra_embeds.shape[1])


def loss_from_logits(cfg: ModelConfig, logits: torch.Tensor,
                     labels: torch.Tensor, n_prefix: int = 0) -> torch.Tensor:
    """:func:`loss_fn`'s cross-entropy from the forward's fp32 logits,
    ``n_prefix`` prefix positions (the VLM's patch embeddings) first."""
    if n_prefix:                       # prefix positions carry no loss
        logits = logits[:, n_prefix:]
    if cfg.n_meta_tokens:
        logits = logits[:, cfg.n_meta_tokens:]
    logits = logits[:, :-1]            # (B, T-1, V) or (B, T-1, n_q, V)
    tgt = labels[:, 1:].long()
    mask = (tgt >= 0).to(torch.float32)
    lse = shard.logsumexp_last(logits)
    ll = shard.take_last(logits, tgt.clamp_min(0))
    nll = (lse - ll) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def _layers(cfg: ModelConfig, params: Params):
    """(layer params, static window, rope base) per layer, in order."""
    win, bases = layer_windows(cfg), layer_rope_bases(cfg)
    for i in range(cfg.n_layers):
        yield i, layer_params(params, i), int(win[i]), float(bases[i])


def _conv_shape(cfg: ModelConfig, batch: int):
    return (cfg.n_layers, batch, cfg.d_conv - 1, cfg.conv_dim)


def _ssm_shape(cfg: ModelConfig, batch: int):
    return (cfg.n_layers, batch, cfg.n_ssm_heads, cfg.d_state,
            cfg.ssm_head_dim)


# ---------------------------------------------------------------------------
# the static reference path: one dense KV cache, one shared position
# ---------------------------------------------------------------------------
class DecodeState(NamedTuple):
    kv_k: Optional[torch.Tensor]      # (L, B, S, KVH, D) or None
    kv_v: Optional[torch.Tensor]
    conv: Optional[torch.Tensor]      # (L, B, K-1, conv_dim) or None
    ssm: Optional[torch.Tensor]       # (L, B, H, N, P) fp32 or None
    pos: int                          # next write position (host int)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      dtype=torch.bfloat16, *, device="cpu") -> DecodeState:
    _require_ported(cfg)
    kv_k = kv_v = conv = st = None
    if cfg.has_attn:
        shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        kv_k = torch.zeros(shape, dtype=dtype, device=device)
        kv_v = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.has_ssm:
        conv = torch.zeros(_conv_shape(cfg, batch), dtype=dtype, device=device)
        st = torch.zeros(_ssm_shape(cfg, batch), dtype=torch.float32,
                         device=device)
    return DecodeState(kv_k, kv_v, conv, st, max_seq - 1)


def _static_caches(state: DecodeState, i: int, fresh: bool):
    kvc = attn.KVCache(state.kv_k[i], state.kv_v[i]) \
        if state.kv_k is not None else None
    ssc = None
    if state.conv is not None:
        # A fresh whole-prompt prefill spells its zero state None, as the
        # JAX package does (the SSD starts from zeros).
        ssc = ssm.SSMCache(state.conv[i], None if fresh else state.ssm[i])
    return kvc, ssc


def _store_ssm(state, i: int, ssc, rows=slice(None)) -> None:
    """Write layer ``i``'s new conv / SSM state into ``rows`` in place."""
    if ssc is not None:
        state.conv[i, rows] = ssc.conv.to(state.conv.dtype)
        state.ssm[i, rows] = ssc.state.to(state.ssm.dtype)


def prefill_into_cache(ctx, params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, state: DecodeState
                       ) -> Tuple[torch.Tensor, DecodeState]:
    """Forward over the prompt (tokens (B, P) [or (B, P, n_q)]) writing the
    caches at positions [0, P'), P' = P + meta tokens. Returns (logits
    (B, P', V), state with ``pos`` = P')."""
    h = embed_inputs(cfg, params, tokens)
    b, t, _ = h.shape
    positions = torch.arange(t, device=h.device)[None].expand(b, t)
    for i, bp, win, base in _layers(cfg, params):
        kvc, ssc = _static_caches(state, i, fresh=True)
        h, _, ssc = _block_apply(ctx, cfg, bp, h, positions, win, base,
                                 kv_cache=kvc, ssm_cache=ssc, cache_pos=0)
        _store_ssm(state, i, ssc)
    logits = unembed(ctx, cfg, params, h)
    return logits, state._replace(pos=t)


def decode_step(ctx, params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                state: DecodeState) -> Tuple[torch.Tensor, DecodeState]:
    """One step of the static path: tokens (B, 1) [or (B, 1, n_q)] at the
    shared position ``state.pos``; returns the new token's logits and the
    state one position on."""
    h = _embed_tokens(cfg, params, tokens)
    pos = int(state.pos)
    positions = torch.full((h.shape[0], 1), pos, dtype=torch.int64,
                           device=h.device)
    for i, bp, win, base in _layers(cfg, params):
        kvc, ssc = _static_caches(state, i, fresh=False)
        h, _, ssc = _block_apply(ctx, cfg, bp, h, positions, win, base,
                                 kv_cache=kvc, ssm_cache=ssc, cache_pos=pos)
        _store_ssm(state, i, ssc)
    logits = unembed(ctx, cfg, params, h)
    return logits, state._replace(pos=pos + 1)


# ---------------------------------------------------------------------------
# paged serving steps
# ---------------------------------------------------------------------------
class PagedDecodeState(NamedTuple):
    """Decode-slot state over paged KV pools. The last pool page (id NP)
    is the reserved trash page retired slots spill to. ``kv_*`` are None
    for the ssm family, ``conv`` / ``ssm`` for the attention-only ones."""

    kv_k: Optional[torch.Tensor]      # (L, KVH, NP + 1, page, D)
    kv_v: Optional[torch.Tensor]
    conv: Optional[torch.Tensor]      # (L, slots, K-1, conv_dim)
    ssm: Optional[torch.Tensor]       # (L, slots, H, N, P) fp32
    tables: torch.Tensor              # (slots, MP) int32 page ids
    lengths: torch.Tensor             # (slots,) int32 cached tokens per slot


def init_paged_state(cfg: ModelConfig, slots: int, n_pages: int,
                     page_size: int, max_pages: int, dtype=torch.bfloat16,
                     *, device="cpu") -> PagedDecodeState:
    _require_ported(cfg)
    kv_k = kv_v = conv = st = None
    if cfg.has_attn:
        shape = (cfg.n_layers, cfg.n_kv_heads, n_pages + 1, page_size,
                 cfg.head_dim)
        kv_k = torch.zeros(shape, dtype=dtype, device=device)
        kv_v = torch.zeros(shape, dtype=dtype, device=device)
    if cfg.has_ssm:
        conv = torch.zeros(_conv_shape(cfg, slots), dtype=dtype, device=device)
        st = torch.zeros(_ssm_shape(cfg, slots), dtype=torch.float32,
                         device=device)
    return PagedDecodeState(
        kv_k, kv_v, conv, st,
        torch.zeros((slots, max_pages), dtype=torch.int32, device=device),
        torch.zeros((slots,), dtype=torch.int32, device=device))


def _prefill_kv(state: PagedDecodeState, i: int, pages, page_size: int):
    if state.kv_k is None:
        return None
    zero_len = torch.zeros((1,), dtype=torch.int32, device=pages.device)
    return attn.PagedKVCache(state.kv_k[i], state.kv_v[i], pages[None],
                             zero_len, page_size)


def paged_prefill(ctx, params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  state: PagedDecodeState, slot: int, pages: torch.Tensor, *,
                  page_size: int, with_logits: bool = True
                  ) -> Tuple[Optional[torch.Tensor], PagedDecodeState]:
    """Prefill ONE fresh request (tokens (1, P) [or (1, P, n_q)],
    bucket-padded for attention-only families) into its pages (``pages``:
    (MP,) int32) and into slot ``slot``'s recurrent state, which starts
    from zeros (a retired tenant's state must not leak in). Returns
    (logits (1, P', V) or None, state); the caller owns the table/length
    update."""
    h = embed_inputs(cfg, params, tokens)
    t = h.shape[1]
    positions = torch.arange(t, device=h.device)[None]
    for i, bp, win, base in _layers(cfg, params):
        ssc = None
        if state.conv is not None:
            ssc = ssm.SSMCache(torch.zeros_like(state.conv[i, slot:slot + 1]),
                               None)
        h, _, ssc = _block_apply(ctx, cfg, bp, h, positions, win, base,
                                 kv_cache=_prefill_kv(state, i, pages,
                                                      page_size),
                                 ssm_cache=ssc)
        _store_ssm(state, i, ssc, slice(slot, slot + 1))
    logits = unembed(ctx, cfg, params, h) if with_logits else None
    return logits, state


def paged_prefill_chunk(ctx, params: Params, cfg: ModelConfig,
                        tokens: torch.Tensor, state: PagedDecodeState,
                        slot: int, pages: torch.Tensor, start: int, *,
                        page_size: int, with_logits: bool = True,
                        kv_pages: Optional[int] = None
                        ) -> Tuple[Optional[torch.Tensor], PagedDecodeState]:
    """Prefill a CONTINUATION chunk (tokens (1, Tc) [or (1, Tc, n_q)]) at
    cache positions [start, start + Tc); ``start`` is a host int.
    Attention reads cache pages + the chunk through the block table, cut
    to ``kv_pages``; the slot's conv and SSM state are resumed."""
    h = embed_inputs(cfg, params, tokens, with_meta=False)
    t = h.shape[1]
    positions = (int(start) + torch.arange(t, device=h.device))[None]
    rows = slice(slot, slot + 1)
    for i, bp, win, base in _layers(cfg, params):
        ssc = None
        if state.conv is not None:
            ssc = ssm.SSMCache(state.conv[i, rows], state.ssm[i, rows])
        h, _, ssc = _block_apply(ctx, cfg, bp, h, positions, win, base,
                                 kv_cache=_prefill_kv(state, i, pages,
                                                      page_size),
                                 ssm_cache=ssc, prefill_start=int(start),
                                 kv_pages=kv_pages)
        _store_ssm(state, i, ssc, rows)
    logits = unembed(ctx, cfg, params, h) if with_logits else None
    return logits, state


def paged_decode_step(ctx, params: Params, cfg: ModelConfig,
                      tokens: torch.Tensor, state: PagedDecodeState,
                      active: torch.Tensor, *, page_size: int
                      ) -> Tuple[torch.Tensor, PagedDecodeState]:
    """One continuous-batching decode step: every slot advances one token
    (tokens (slots, 1) [or (slots, 1, n_q)]); inactive slots write the
    trash page, keep frozen lengths and keep their conv / SSM state (a slot
    mid-way through a chunked prefill rides the batch as padding). Each
    slot ropes and attends at its own position."""
    h = _embed_tokens(cfg, params, tokens)
    positions = state.lengths[:, None]
    trash = state.kv_k.shape[2] - 1 if state.kv_k is not None else 0
    for i, bp, win, base in _layers(cfg, params):
        kvc = None
        if state.kv_k is not None:
            kvc = attn.PagedKVCache(state.kv_k[i], state.kv_v[i],
                                    state.tables, state.lengths, page_size,
                                    active, trash)
        ssc = None
        if state.conv is not None:
            ssc = ssm.SSMCache(state.conv[i], state.ssm[i])
        h, _, new = _block_apply(ctx, cfg, bp, h, positions, win, base,
                                 kv_cache=kvc, ssm_cache=ssc)
        if new is not None:
            new = ssm.SSMCache(
                torch.where(active[:, None, None],
                            new.conv.to(state.conv.dtype), state.conv[i]),
                torch.where(active[:, None, None, None], new.state,
                            state.ssm[i]))
            _store_ssm(state, i, new)
    logits = unembed(ctx, cfg, params, h)
    lengths = torch.where(active, state.lengths + 1, state.lengths)
    return logits, state._replace(lengths=lengths)
