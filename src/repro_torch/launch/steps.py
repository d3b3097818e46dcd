"""Train, prefill and serve steps (port of ``repro.launch.steps``).

One train step is forward + backward + AdamW: the loss through
``transformer.loss_fn`` with every block rematerialized (``remat=True``, as
the JAX step runs it), the gradients by autograd (the engine GEMM's
backward products on its kernels, attention and the SSD through their
model functions), then :func:`repro_torch.optim.adamw.adamw_update`. With
``grad_accum`` > 1 the batch splits into that many micro-batches whose
losses and gradients sum in fp32 and are averaged, as the JAX step's scan
does.

Under a device mesh (``mesh``, ``launch.mesh``) the steps run on DTensors,
as the JAX steps run under GSPMD: parameters laid out by
``sharding.param_specs`` (``model`` shards storage), the batch by
``tokens_spec``, the residual between blocks and the logits redistributed
to ``residual_spec`` / ``logits_spec``, and the engine's kernels run on
local tensors through the sharded context (``ctx.with_mesh``;
``core.context``). A whole weight's gradient leaves each kernel as a
data-parallel partial sum; the train step reduce-scatters it into the
ZeRO-1 layout of AdamW's m and v (``opt_state_specs``), updates that
shard, and all-gathers the new parameters into their own layout.
With ``grad_accum`` > 1 under a mesh each rank splits its own
rows (``core.dtensor.split_rows``): micro-batch i holds the i-th block
of every data shard's rows, so no data moves. The JAX step splits the
global rows instead; the mean loss and the mean gradient over the
micro-batches are the same function of the batch either way (each
micro-batch's loss is a mean over as many rows), and on one data shard
the two splits are the same.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import dtensor as shard
from repro_torch.core import tree as tu
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

N_VLM_TOKENS = 576   # anyres base-tile patch embeddings (stub frontend)


class TrainState(NamedTuple):
    params: Any
    opt: Dict[str, Any]
    step: torch.Tensor               # int32 scalar


def init_train_state(cfg: tf.ModelConfig, *, seed: int = 0,
                     device="cuda", mesh=None) -> TrainState:
    """Parameters drawn from ``seed`` on ``device`` (the card unless the
    caller passes ``"cpu"``), zeroed AdamW state, step 0. With ``mesh``
    every rank draws the same parameters and keeps its blocks of the
    ``param_specs`` layout; m and v are zeros in the ``opt_state_specs``
    layout (ZeRO-1); the step and AdamW's count stay plain tensors."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tf.init_params(gen, cfg, device=device)
    step = torch.zeros((), dtype=torch.int32, device=device)
    if mesh is None:
        return TrainState(params, adamw.adamw_init(params), step)
    ospecs = shd.opt_state_specs(params, mesh)
    f32 = tu.tree_map(lambda p: torch.empty(p.shape, dtype=torch.float32,
                                            device="meta"), params)
    opt = {"m": shd.empty_tree(f32, ospecs["m"], mesh, fill=0.0),
           "v": shd.empty_tree(f32, ospecs["v"], mesh, fill=0.0),
           "count": torch.zeros((), dtype=torch.int32, device=device)}
    params = shd.distribute_tree(params, shd.param_specs(params, mesh), mesh)
    return TrainState(params, opt, step)


def layouts(cfg: tf.ModelConfig, mesh, batch: int, seq: int
            ) -> Dict[str, Any]:
    """The forward's ``residual_sharding`` / ``logits_sharding``
    ``(mesh, placements)`` pairs for a (batch, seq) step (seq: the
    residual's length), or Nones without a mesh."""
    if mesh is None:
        return {"residual_sharding": None, "logits_sharding": None}
    return {"residual_sharding": (mesh, shd.to_placements(
                shd.residual_spec(cfg, mesh, batch, seq), mesh)),
            "logits_sharding": (mesh, shd.to_placements(
                shd.logits_spec(cfg, mesh, batch), mesh))}


def _residual_len(cfg: tf.ModelConfig, batch: Dict[str, Any]) -> int:
    extra = batch.get("extra_embeds")
    return batch["tokens"].shape[1] + cfg.n_meta_tokens + \
        (0 if extra is None else extra.shape[1])


def _mesh_scope(mesh):
    """Plain tensors the model makes (positions, masks) count as
    replicated next to DTensors, and ``mesh`` is the current one
    (``launch.mesh.current_mesh``, which the MoE's grouped dispatch
    reads)."""
    stack = contextlib.ExitStack()
    if mesh is not None:
        from torch.distributed.tensor.experimental import \
            implicit_replication
        stack.enter_context(implicit_replication())
        stack.enter_context(mesh_lib.activate_mesh(mesh))
    return stack


def loss_and_grads(ctx, cfg: tf.ModelConfig, params, batch: Dict[str, Any],
                   *, grad_accum: int = 1, remat: bool = True, **fwd_kw
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, gradient tree) of ``transformer.loss_fn`` over ``batch``
    (``tokens``, ``labels`` and, for a VLM, ``extra_embeds``). One batch:
    gradients in each parameter's dtype; micro-batches: fp32 sums divided
    by ``grad_accum``, as the JAX step's accumulation (DTensors: each
    rank's own rows split, module docstring; the sums kept in each
    gradient's layout). ``fwd_kw``: the forward's sharding constraints
    (:func:`layouts`, at one micro-batch's rows)."""
    leaves = [p.detach().requires_grad_(True) for p in tu.leaves(params)]
    p = tu.unflatten(params, leaves)
    tokens, labels = batch["tokens"], batch["labels"]
    extra = batch.get("extra_embeds")

    def one(t, l, e):
        loss = tf.loss_fn(ctx, p, cfg, t, l, e, remat=remat, **fwd_kw)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    if grad_accum == 1:
        loss, grads = one(tokens, labels, extra)
        return loss, tu.unflatten(params, list(grads))

    mbs = [None if x is None else shard.split_rows(x, grad_accum)
           for x in (tokens, labels, extra)]
    tot = acc = None
    for i in range(grad_accum):
        lv, gi = one(*(None if m is None else m[i] for m in mbs))
        if acc is None:             # zeros in each sum's own layout
            tot = torch.zeros_like(lv, dtype=torch.float32)
            acc = [torch.zeros_like(g, dtype=torch.float32) for g in gi]
        tot = tot + lv
        acc = [a + g for a, g in zip(acc, gi)]
    return tot / grad_accum, tu.unflatten(params,
                                          [a / grad_accum for a in acc])


def make_train_step(ctx, cfg: tf.ModelConfig, opt_cfg: adamw.AdamWConfig,
                    mesh=None, *, grad_accum: int = 1,
                    lr_schedule: Optional[Callable[[torch.Tensor], Any]]
                    = None):
    """Returns train_step(state, batch) -> (state, metrics): ``loss``,
    ``grad_norm`` and ``lr`` (fp32 scalars on the state's device, plain
    tensors under a mesh too). ``lr_schedule(step)`` scales the learning
    rate (``optim.schedule``); None keeps it constant, as the JAX step
    does. ``mesh``: the state and batch are DTensors on it (module
    docstring; ``ctx`` is the caller's, sharded by ``with_mesh`` or, for
    the dry run, not)."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        with _mesh_scope(mesh):
            fwd_kw = layouts(cfg, mesh,
                             batch["tokens"].shape[0] // grad_accum,
                             _residual_len(cfg, batch))
            loss, grads = loss_and_grads(ctx, cfg, state.params, batch,
                                         grad_accum=grad_accum, **fwd_kw)
            scale = 1.0 if lr_schedule is None else lr_schedule(state.step)
            if mesh is None:
                new_params, new_opt, om = adamw.adamw_update(
                    opt_cfg, state.params, grads, state.opt, lr_scale=scale)
                return TrainState(new_params, new_opt, state.step + 1), \
                    {"loss": loss, **om}
            new_params, new_opt, om = _zero1_update(
                opt_cfg, mesh, state.params, grads, state.opt, scale)
            metrics = {"loss": _plain(loss), **{k: _plain(v)
                                                for k, v in om.items()}}
        return TrainState(new_params, new_opt, state.step + 1), metrics

    return train_step


def _plain(x):
    return x.full_tensor() if shard.is_dtensor(x) else x


def _zero1_update(opt_cfg, mesh, params, grads, opt, scale):
    """AdamW on the ZeRO-1 shards: each gradient reduce-scattered (or
    chunked, where it is whole) into m's layout, each parameter cut to it
    (no transfer: it is replicated over the data axes), the update there,
    and the new parameters all-gathered into their own layout."""
    ms = tu.leaves(opt["m"])
    zp = [p.redistribute(mesh, m.placements)
          for p, m in zip(tu.leaves(params), ms)]
    zg = [g.redistribute(mesh, m.placements)
          for g, m in zip(tu.leaves(grads), ms)]
    new_zp, new_opt, om = adamw.adamw_update(
        opt_cfg, tu.unflatten(params, zp), tu.unflatten(params, zg), opt,
        lr_scale=scale)
    new_p = [z.redistribute(mesh, p.placements)
             for z, p in zip(tu.leaves(new_zp), tu.leaves(params))]
    return tu.unflatten(params, new_p), new_opt, om


def make_prefill_step(ctx, cfg: tf.ModelConfig, mesh=None):
    """Inference prefill: forward over the prompt, the last position's
    logits. ``mesh``: DTensor params and batch, the residual and logits
    laid out as in training."""

    @torch.no_grad()
    def prefill_step(params, batch):
        with _mesh_scope(mesh):
            fwd_kw = layouts(cfg, mesh, batch["tokens"].shape[0],
                             _residual_len(cfg, batch))
            logits = tf.forward(ctx, params, cfg, batch["tokens"],
                                batch.get("extra_embeds"), **fwd_kw)
            return logits[:, -1]

    return prefill_step


def make_serve_step(ctx, cfg: tf.ModelConfig, mesh=None):
    """One-token decode against the static path's dense KV / SSM cache
    (``mesh``: DTensor params, tokens and cache, ``decode_state_specs``)."""

    @torch.no_grad()
    def serve_step(params, tokens, state: tf.DecodeState):
        with _mesh_scope(mesh):
            return tf.decode_step(ctx, params, cfg, tokens, state)

    return serve_step


# ---------------------------------------------------------------------------
# input specs (DTensors of uninitialized blocks; under FakeTensorMode no
# memory at all: the dry run's inputs)
# ---------------------------------------------------------------------------
SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1),
}


def param_shapes(cfg: tf.ModelConfig):
    """The params tree on the meta device (shapes and dtypes, no
    allocation)."""
    return tf.init_params(torch.Generator(), cfg, device="meta")


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: tf.ModelConfig, shape_name: str, mesh) -> Dict[str, Any]:
    """All inputs of the step this (arch x shape) cell runs, as DTensors
    laid out on ``mesh`` (uninitialized; fake under ``FakeTensorMode``).

    Returns dict with 'kind', 'args' (the step's arguments in order),
    'batch' and 'seq'."""
    info = SHAPES[shape_name]
    batch, seq, kind = info["batch"], info["seq"], info["kind"]
    tok_nd = 3 if cfg.n_codebooks > 1 else 2
    tspec = shd.tokens_spec(mesh, batch, tok_nd)

    pshapes = param_shapes(cfg)
    params = shd.empty_tree(pshapes, shd.param_specs(pshapes, mesh), mesh)

    def toks(shape):
        return shd.empty_tree({"t": _meta(shape, torch.int32)},
                              {"t": tspec}, mesh, fill=0)["t"]

    if kind in ("train", "prefill"):
        text_seq = seq
        batch_dict: Dict[str, Any] = {}
        if cfg.modality == "vlm":
            text_seq = seq - N_VLM_TOKENS
            batch_dict["extra_embeds"] = shd.empty_tree(
                {"e": _meta((batch, N_VLM_TOKENS, cfg.d_model), cfg.dtype)},
                {"e": shd.tokens_spec(mesh, batch, 3)}, mesh)["e"]
        tshape = (batch, text_seq, cfg.n_codebooks) if tok_nd == 3 \
            else (batch, text_seq)
        batch_dict["tokens"] = toks(tshape)
        if kind == "train":
            batch_dict["labels"] = toks(tshape)
            ospecs = shd.opt_state_specs(pshapes, mesh)
            f32 = tu.tree_map(lambda p: _meta(p.shape, torch.float32),
                              pshapes)
            dev = mesh.device_type
            opt = {"m": shd.empty_tree(f32, ospecs["m"], mesh, fill=0.0),
                   "v": shd.empty_tree(f32, ospecs["v"], mesh, fill=0.0),
                   "count": torch.zeros((), dtype=torch.int32, device=dev)}
            state = TrainState(params, opt,
                               torch.zeros((), dtype=torch.int32, device=dev))
            return dict(kind=kind, args=(state, batch_dict), batch=batch,
                        seq=seq)
        return dict(kind=kind, args=(params, batch_dict), batch=batch,
                    seq=seq)

    # decode: one new token with a cache of `seq`
    dshape = (batch, 1, cfg.n_codebooks) if tok_nd == 3 else (batch, 1)
    sspecs = shd.decode_state_specs(cfg, mesh, batch, seq)
    sshapes = tf.init_decode_state(cfg, batch, seq, device="meta")
    cache = shd.empty_tree(sshapes._replace(pos=None),
                           sspecs._replace(pos=None), mesh, fill=0)
    state = cache._replace(pos=sshapes.pos)
    return dict(kind=kind, args=(params, toks(dshape), state), batch=batch,
                seq=seq)
