"""Train, prefill and serve steps (port of ``repro.launch.steps``).

One train step is forward + backward + AdamW: the loss through
``transformer.loss_fn`` with every block rematerialized (``remat=True``, as
the JAX step runs it), the gradients by autograd (the engine GEMM's
backward products on its kernels, attention and the SSD through their
model functions), then :func:`repro_torch.optim.adamw.adamw_update`. With
``grad_accum`` > 1 the batch splits into that many micro-batches whose
losses and gradients sum in fp32 and are averaged, as the JAX step's scan
does. Steps run eagerly on one device: the JAX steps' sharding annotations
come with the multi-device port (ROADMAP A15).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import tree as tu
from repro_torch.models import transformer as tf
from repro_torch.optim import adamw

N_VLM_TOKENS = 576   # anyres base-tile patch embeddings (stub frontend)


class TrainState(NamedTuple):
    params: Any
    opt: Dict[str, Any]
    step: torch.Tensor               # int32 scalar


def init_train_state(cfg: tf.ModelConfig, *, seed: int = 0,
                     device="cuda") -> TrainState:
    """Parameters drawn from ``seed`` on ``device`` (the card unless the
    caller passes ``"cpu"``), zeroed AdamW state, step 0."""
    gen = torch.Generator(device=device).manual_seed(seed)
    params = tf.init_params(gen, cfg, device=device)
    return TrainState(params, adamw.adamw_init(params),
                      torch.zeros((), dtype=torch.int32, device=device))


def loss_and_grads(ctx, cfg: tf.ModelConfig, params, batch: Dict[str, Any],
                   *, grad_accum: int = 1, remat: bool = True
                   ) -> Tuple[torch.Tensor, Any]:
    """(loss, gradient tree) of ``transformer.loss_fn`` over ``batch``
    (``tokens``, ``labels`` and, for a VLM, ``extra_embeds``). One batch:
    gradients in each parameter's dtype; micro-batches: fp32 sums divided
    by ``grad_accum``, as the JAX step's accumulation."""
    leaves = [p.detach().requires_grad_(True) for p in tu.leaves(params)]
    p = tu.unflatten(params, leaves)
    tokens, labels = batch["tokens"], batch["labels"]
    extra = batch.get("extra_embeds")

    def one(t, l, e):
        loss = tf.loss_fn(ctx, p, cfg, t, l, e, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    if grad_accum == 1:
        loss, grads = one(tokens, labels, extra)
        return loss, tu.unflatten(params, list(grads))

    def split(x):
        return None if x is None else x.reshape(grad_accum, -1, *x.shape[1:])
    tot = torch.zeros((), dtype=torch.float32, device=tokens.device)
    acc = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
           for x in leaves]
    mbs = [split(x) for x in (tokens, labels, extra)]
    for i in range(grad_accum):
        lv, gi = one(*(None if m is None else m[i] for m in mbs))
        tot = tot + lv
        acc = [a + g for a, g in zip(acc, gi)]
    return tot / grad_accum, tu.unflatten(params,
                                          [a / grad_accum for a in acc])


def make_train_step(ctx, cfg: tf.ModelConfig, opt_cfg: adamw.AdamWConfig,
                    *, grad_accum: int = 1,
                    lr_schedule: Optional[Callable[[torch.Tensor], Any]]
                    = None):
    """Returns train_step(state, batch) -> (state, metrics): ``loss``,
    ``grad_norm`` and ``lr`` (fp32 scalars on the state's device).
    ``lr_schedule(step)`` scales the learning rate (``optim.schedule``);
    None keeps it constant, as the JAX step does."""

    def train_step(state: TrainState, batch) -> Tuple[TrainState, Dict]:
        loss, grads = loss_and_grads(ctx, cfg, state.params, batch,
                                     grad_accum=grad_accum)
        scale = 1.0 if lr_schedule is None else lr_schedule(state.step)
        new_params, new_opt, om = adamw.adamw_update(
            opt_cfg, state.params, grads, state.opt, lr_scale=scale)
        return TrainState(new_params, new_opt, state.step + 1), \
            {"loss": loss, **om}

    return train_step


def make_prefill_step(ctx, cfg: tf.ModelConfig):
    """Inference prefill: forward over the prompt, the last position's
    logits."""

    @torch.no_grad()
    def prefill_step(params, batch):
        logits = tf.forward(ctx, params, cfg, batch["tokens"],
                            batch.get("extra_embeds"))
        return logits[:, -1]

    return prefill_step


def make_serve_step(ctx, cfg: tf.ModelConfig):
    """One-token decode against the static path's dense KV / SSM cache."""

    @torch.no_grad()
    def serve_step(params, tokens, state: tf.DecodeState):
        return tf.decode_step(ctx, params, cfg, tokens, state)

    return serve_step
