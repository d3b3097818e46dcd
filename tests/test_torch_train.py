"""The port's training path against the JAX package, on the CPU.

The JAX side differentiates ``repro.models.transformer.loss_fn`` with
``jax.value_and_grad`` on an ``xla`` engine (what JAX's own training tests
run: its Pallas kernels have no VJP); the port runs
``repro_torch.models.transformer.loss_fn`` and autograd on its plain
versions (CPU tensors), through the engine GEMM's ``autograd.Function``.
Both take the same numpy parameters and batches, and both are fp32 end to
end (model dtype and engine config).

Tolerances, each with its reason:
- loss: 2e-6 relative. Both sides sum in fp32 in other orders (MKL
  against XLA's dot), about 1e-7 per op over two layers and a softmax.
- gradients: each leaf within 2e-5 relative L2 of JAX's. The target is
  1e-5; the worst leaf, hymba-1.5b's ``a_log``, reads 1.3e-5: its
  gradient sums the SSD's decay terms over every position, so the
  per-op differences add up before the norm is taken.
- the 5-step AdamW + cosine curve: each step's loss 1e-5 relative, the
  final parameters 1e-3 relative L2 per leaf (AdamW's first steps move a
  weight by about the learning rate whatever its gradient's size, so a
  gradient that is nearly zero on both sides can move it either way).
- the bf16 dense MLP (ROADMAP C6): bit for bit.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.core.context import ExecutionContext as JContext
from repro.core.generator import elaborate
from repro.models import layers as jlayers
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.optim import adamw as jadamw
from repro.optim import schedule as jschedule

from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core import flags as tflags
from repro_torch.core import tree as tu
from repro_torch.core.config import Activation, GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.kernels import gemm as tgemm
from repro_torch.launch import steps as tsteps
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedule as tschedule

F32 = dict(input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32")
JENGINE = elaborate(JGemminiConfig(**F32), "xla")
TCTX = ExecutionContext(cfg=GemminiConfig(**F32))
# The dense archs here; the recurrent, hybrid, audio and MoE archs in
# tests/test_torch_train_mixers.py (the JAX references take most of the
# time, so the two files split them).
MIXER_ARCHS = ("granite-moe-3b-a800m", "hymba-1.5b", "llama4-scout-17b-a16e",
               "mamba2-1.3b", "musicgen-medium")
ARCHS = sorted(set(jconfigs.names()) - set(MIXER_ARCHS))
# remat off, then on under each policy of core/flags.py
VARIANTS = {"plain": (False, "full"), "full": (True, "full"),
            "dots": (True, "dots"), "none": (True, "none")}
BATCH, SEQ, EXTRA = 2, 16, 3


def _configs(arch):
    return (dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32),
            dataclasses.replace(tconfigs.get_smoke(arch),
                                dtype=torch.float32))


def _batch(jc, seed):
    """Tokens, labels (a few masked with -100) and, for a VLM, a prefix of
    ``EXTRA`` patch embeddings, from a seed."""
    rng = np.random.default_rng(seed)
    shape = (BATCH, SEQ, jc.n_codebooks) if jc.n_codebooks > 1 \
        else (BATCH, SEQ)
    toks = rng.integers(0, jc.vocab, shape).astype(np.int32)
    labels = toks.copy()
    labels[0, 5] = -100
    labels[1, -3:] = -100
    extra = rng.standard_normal((BATCH, EXTRA, jc.d_model)).astype(
        np.float32) if jc.modality == "vlm" else None
    return toks, labels, extra


@functools.lru_cache(maxsize=None)
def _jax_reference(arch):
    """(numpy params, batch, JAX loss, JAX grads as numpy) for ``arch``."""
    jc, _ = _configs(arch)
    npt = jax.tree.map(np.asarray,
                       jtf.init_params(jax.random.PRNGKey(len(arch)), jc))
    toks, labels, extra = _batch(jc, len(arch))
    fn = jax.jit(jax.value_and_grad(
        lambda p, t, l, e: jtf.loss_fn(JENGINE, p, jc, t, l, e)))
    loss, grads = fn(jax.tree.map(jnp.asarray, npt), jnp.asarray(toks),
                     jnp.asarray(labels),
                     None if extra is None else jnp.asarray(extra))
    return npt, (toks, labels, extra), float(loss), \
        jax.tree.map(np.asarray, grads)


def _t(a):
    return None if a is None else torch.from_numpy(np.asarray(a))


def _rel(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch, variant):
    """Each dense registry arch at smoke size (llava with an
    ``extra_embeds`` prefix): the port's loss and every gradient leaf
    against ``jax.value_and_grad(tf.loss_fn)``, with ``remat`` off and on
    under each ``remat_policy``."""
    check_loss_and_grads(arch, variant)


def check_loss_and_grads(arch, variant):
    npt, (toks, labels, extra), jloss, jgrads = _jax_reference(arch)
    _, tc = _configs(arch)
    remat, policy = VARIANTS[variant]
    tflags.set_flag("remat_policy", policy)
    try:
        loss, grads = tsteps.loss_and_grads(
            TCTX, tc, params_from_numpy(npt),
            {"tokens": _t(toks), "labels": _t(labels),
             "extra_embeds": _t(extra)}, remat=remat)
    finally:
        tflags.reset()
    np.testing.assert_allclose(loss.item(), jloss, rtol=2e-6)
    got = dict(tu.flatten_with_paths(grads))
    want = dict(tu.flatten_with_paths(jgrads))
    assert sorted(got) == sorted(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape and np.isfinite(g).all(), path
        assert _rel(g, w) <= 2e-5, (path, _rel(g, w))


def test_remat_policies_agree_bit_for_bit_and_count_gemms():
    """Loss and gradients are the same bits under every policy (as JAX's
    ``tests/test_perf_flags.py`` holds its loss), and the engine GEMM runs
    as the chip phase counts it: 7 projections a layer plus the
    unembedding forward, the layers' 7 again when ``full`` recomputes them
    (``dots`` replays the saved outputs), and two backward products per
    forward GEMM."""
    _, tc = _configs("gemma3-1b")
    tc = dataclasses.replace(tc, n_layers=3)
    params = ttf.init_params(torch.Generator().manual_seed(0), tc)
    toks = torch.randint(0, tc.vocab, (BATCH, SEQ),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks}
    calls = {"fwd": 0, "bwd": 0}
    real = tgemm._gemm

    def counting(*args, **kw):
        calls["bwd" if kw.get("bwd") else "fwd"] += 1
        return real(*args, **kw)

    ref = None
    n_fwd = 7 * tc.n_layers + 1
    try:
        tgemm._gemm = counting
        for name in sorted(VARIANTS):
            remat, policy = VARIANTS[name]
            tflags.set_flag("remat_policy", policy)
            calls.update(fwd=0, bwd=0)
            loss, grads = tsteps.loss_and_grads(TCTX, tc, params, batch,
                                                remat=remat)
            recompute = 7 * tc.n_layers if name == "full" else 0
            assert calls == {"fwd": n_fwd + recompute, "bwd": 2 * n_fwd}, \
                (name, calls)
            flat = [loss] + tu.leaves(grads)
            if ref is None:
                ref = flat
            assert all(torch.equal(a, b) for a, b in zip(flat, ref)), name
    finally:
        tgemm._gemm = real
        tflags.reset()


def _jax_step(jc, opt_cfg, total):
    def step(params, opt, t, l, i):
        loss, grads = jax.value_and_grad(
            lambda p: jtf.loss_fn(JENGINE, p, jc, t, l))(params)
        scale = jschedule.cosine_schedule(i, total, warmup_steps=1)
        params, opt, _ = jadamw.adamw_update(opt_cfg, params, grads, opt,
                                             lr_scale=scale)
        return params, opt, loss
    return jax.jit(step)


def test_adamw_cosine_loss_curve_matches_jax():
    """Five AdamW steps under a cosine schedule (warmup 1) on smoke
    gemma3-1b, each on its own batch: the port's ``make_train_step``
    against ``jax.value_and_grad`` + ``adamw_update``."""
    jc, tc = _configs("gemma3-1b")
    total = 5
    opt_j = jadamw.AdamWConfig(lr=3e-3)
    opt_t = tadamw.AdamWConfig(lr=3e-3)
    npt = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(3), jc))
    jp = jax.tree.map(jnp.asarray, npt)
    jopt = jadamw.adamw_init(jp)
    params = params_from_numpy(npt)
    state = tsteps.TrainState(params, tadamw.adamw_init(params),
                              torch.zeros((), dtype=torch.int32))
    step_t = tsteps.make_train_step(
        TCTX, tc, opt_t, lr_schedule=lambda s: tschedule.cosine_schedule(
            s, total, warmup_steps=1))
    step_j = _jax_step(jc, opt_j, total)
    losses = []
    for i in range(total):
        toks = _batch(jc, 10 + i)[0]
        jp, jopt, jloss = step_j(jp, jopt, jnp.asarray(toks),
                                 jnp.asarray(toks), i)
        state, metrics = step_t(state, {"tokens": _t(toks),
                                        "labels": _t(toks)})
        np.testing.assert_allclose(metrics["loss"].item(), float(jloss),
                                   rtol=1e-5)
        losses.append(float(jloss))
    assert losses[-1] < losses[0]
    assert int(state.step) == total == int(jopt["count"])
    got = dict(tu.flatten_with_paths(state.params))
    for path, w in tu.flatten_with_paths(jax.tree.map(np.asarray, jp)):
        assert _rel(got[path].numpy(), w) <= 1e-3, path


def test_grad_accum_matches_one_batch():
    """Two micro-batches sum their fp32 gradients and halve them: the
    same loss and gradients as the whole batch, within fp32 sums."""
    _, tc = _configs("qwen1.5-4b")
    params = ttf.init_params(torch.Generator().manual_seed(4), tc)
    toks = torch.randint(0, tc.vocab, (4, SEQ),
                         generator=torch.Generator().manual_seed(5))
    batch = {"tokens": toks, "labels": toks}
    l1, g1 = tsteps.loss_and_grads(TCTX, tc, params, batch)
    l2, g2 = tsteps.loss_and_grads(TCTX, tc, params, batch, grad_accum=2)
    # the mean over two halves of equal token counts is the whole mean
    torch.testing.assert_close(l2, l1, rtol=1e-6, atol=0)
    for a, b in zip(tu.leaves(g2), tu.leaves(g1)):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_prefill_and_serve_steps_match_jax():
    """``make_prefill_step`` (the whole-sequence forward's last logits)
    and ``make_serve_step`` (one static-path decode step) against the JAX
    model functions the JAX steps wrap, on smoke qwen1.5-4b in fp32."""
    jc, tc = _configs("qwen1.5-4b")
    npt = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(5), jc))
    jp, tp = jax.tree.map(jnp.asarray, npt), params_from_numpy(npt)
    toks = _batch(jc, 6)[0]
    want = jtf.forward(JENGINE, jp, jc, jnp.asarray(toks))[:, -1]
    got = tsteps.make_prefill_step(TCTX, tc)(tp, {"tokens": _t(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=2e-5)
    js = jtf.init_decode_state(jc, BATCH, SEQ + 1, dtype=jnp.float32)
    js = js._replace(pos=jnp.zeros((), jnp.int32))
    ts = ttf.init_decode_state(tc, BATCH, SEQ + 1,
                               dtype=torch.float32)._replace(pos=0)
    _, js = jtf.prefill_into_cache(JENGINE, jp, jc, jnp.asarray(toks), js)
    _, ts = ttf.prefill_into_cache(TCTX, tp, tc, _t(toks), ts)
    nxt = toks[:, -1:]
    jl, _ = jtf.decode_step(JENGINE, jp, jc, jnp.asarray(nxt), js)
    tl, ts = tsteps.make_serve_step(TCTX, tc)(tp, _t(nxt), ts)
    assert ts.pos == SEQ + 1
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=2e-5)


# ---------------------------------------------------------------------------
# the engine GEMM's gradient
# ---------------------------------------------------------------------------
def _ints(rng, shape, dtype):
    """Small integers: every product and sum is exact in fp32, in any
    order, so the kernels' Function and autograd agree bit for bit."""
    return torch.from_numpy(rng.integers(-4, 5, shape).astype(
        np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bias", [None, "row", "full"])
@pytest.mark.parametrize("b_layout", ["rows", "transposed"])
@pytest.mark.parametrize("mkn", [(6, 5, 9), (7, 11, 3)])
def test_gemm_backward_matches_autograd(dtype, bias, b_layout, mkn):
    """``kernels.gemm.gemm`` under grad against autograd through the
    plain product: dA, dB (both orientations: K <= N copies A, K > N
    copies dC) and the bias's gradient, B row-major or read as the
    transpose of a row-major (N, K) buffer (the tied unembedding)."""
    m, k, n = mkn
    rng = np.random.default_rng(m * k * n)
    a = _ints(rng, (m, k), dtype).requires_grad_(True)
    if b_layout == "rows":
        b = _ints(rng, (k, n), dtype).requires_grad_(True)
        b_use = b
    else:
        b = _ints(rng, (n, k), dtype).requires_grad_(True)
        b_use = b.T
    d = None
    if bias == "row":
        d = _ints(rng, (n,), dtype).requires_grad_(True)
    elif bias == "full":
        d = _ints(rng, (m, n), dtype).requires_grad_(True)
    dc = _ints(rng, (m, n), dtype)
    c = tgemm.gemm(a, b_use, d, acc_dtype=torch.float32, out_dtype=dtype)
    assert c.grad_fn is not None and c.dtype == dtype
    c.backward(dc)
    got = [a.grad, b.grad] + ([] if d is None else [d.grad])

    leaves = [x.detach().float().requires_grad_(True)
              for x in [a, b] + ([] if d is None else [d])]
    bb = leaves[1] if b_layout == "rows" else leaves[1].T
    ref = leaves[0] @ bb + (0 if d is None else leaves[2])
    ref.backward(dc.float())
    for g, x, orig in zip(got, leaves, [a, b] + ([] if d is None else [d])):
        assert g.dtype == orig.dtype and g.shape == orig.shape
        assert torch.equal(g.float(), x.grad)


def test_gemm_backward_widens_a_narrower_output():
    """The MoE router: fp32 operands, a bf16 output. The output gradient
    is widened to fp32 (exact), so the operands' gradients are fp32."""
    rng = np.random.default_rng(9)
    a = _ints(rng, (5, 8), torch.float32).requires_grad_(True)
    b = _ints(rng, (8, 6), torch.float32).requires_grad_(True)
    c = tgemm.gemm(a, b, acc_dtype=torch.float32, out_dtype=torch.bfloat16)
    dc = _ints(rng, (5, 6), torch.bfloat16)
    c.backward(dc)
    torch.testing.assert_close(a.grad, dc.float() @ b.detach().T,
                               rtol=0, atol=0)
    torch.testing.assert_close(b.grad, a.detach().T @ dc.float(),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kw,dtypes", [
    (dict(shift=2), (torch.float32, torch.float32)),
    (dict(activation=Activation.RELU), (torch.float32, torch.float32)),
    (dict(), (torch.int8, torch.int32)),
])
def test_gemm_grad_refuses_what_has_no_derivative(kw, dtypes):
    """A shift, an activation or an integer datapath has no gradient: the
    call raises under grad, on any device (before any kernel)."""
    in_dt, acc_dt = dtypes
    a = torch.ones((2, 3), dtype=in_dt)
    b = torch.ones((3, 4), dtype=in_dt)
    d = torch.zeros((4,), requires_grad=True)
    if in_dt.is_floating_point:
        a.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no gradient"):
        tgemm.gemm(a, b, d, acc_dtype=acc_dt,
                   out_dtype=acc_dt if not acc_dt.is_floating_point
                   else torch.float32, **kw)
    # without grad the same calls run the plain version
    with torch.no_grad():
        tgemm.gemm(a, b, d, acc_dtype=acc_dt,
                   out_dtype=acc_dt if not acc_dt.is_floating_point
                   else torch.float32, **kw)


# ---------------------------------------------------------------------------
# C6: the bf16 dense MLP equals JAX's bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("activation", ["silu", "gelu"])
def test_dense_mlp_bf16_equals_jax_bit_for_bit(activation):
    """``layers.mlp_apply`` in bf16 on the serving engine config (bf16 ->
    fp32 -> bf16) against the JAX engine datapath. Operands are chosen so
    that every GEMM sum is exact in fp32 (the two sides sum in other
    orders): x, wi and wg are multiples of 1/16 and 1/64, and wo picks one
    hidden unit per output column. What is left to differ is the
    activation's rounding, which XLA applies after each of its ops; a
    single rounding (``F.silu``, ``F.gelu``) differs in 3-5% of these
    values."""
    d, ff = 64, 128
    rng = np.random.default_rng(11)
    x = (rng.integers(-24, 25, (2, 8, d)) / 16).astype(np.float32)
    wi = (rng.integers(-16, 17, (d, ff)) / 64).astype(np.float32)
    wg = (rng.integers(-16, 17, (d, ff)) / 64).astype(np.float32)
    wo = np.zeros((ff, d), np.float32)
    wo[rng.permutation(ff)[:d], np.arange(d)] = 1.0
    bf = dict(input_dtype="bf16", acc_dtype="fp32", output_dtype="bf16")
    jctx = JContext(cfg=JGemminiConfig(**bf), backend="xla_twin")
    tctx = ExecutionContext(cfg=GemminiConfig(**bf))
    jp = {k: jnp.asarray(v, jnp.bfloat16)
          for k, v in (("wi", wi), ("wg", wg), ("wo", wo))}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16)
          for k, v in (("wi", wi), ("wg", wg), ("wo", wo))}
    want = jlayers.mlp_apply(jctx, jp, jnp.asarray(x, jnp.bfloat16),
                             activation=activation)
    got = tlayers.mlp_apply(tctx, tp, torch.from_numpy(x).to(torch.bfloat16),
                            activation=activation)
    want = np.asarray(want.astype(jnp.float32))
    assert np.array_equal(got.float().numpy(), want)


# ---------------------------------------------------------------------------
# the model pieces the training path adds
# ---------------------------------------------------------------------------
def test_embed_inputs_orders_prefix_then_meta_as_jax():
    """hymba-1.5b smoke with an ``extra_embeds`` prefix: meta tokens, then
    the prefix, then the tokens, as JAX orders them."""
    jc, tc = _configs("hymba-1.5b")
    npt = jax.tree.map(np.asarray, jtf.init_params(jax.random.PRNGKey(0), jc))
    toks, _, _ = _batch(jc, 1)
    extra = np.random.default_rng(2).standard_normal(
        (BATCH, EXTRA, jc.d_model)).astype(np.float32)
    want = jtf.embed_inputs(jc, jax.tree.map(jnp.asarray, npt),
                            jnp.asarray(toks), jnp.asarray(extra))
    got = ttf.embed_inputs(tc, params_from_numpy(npt), _t(toks), _t(extra))
    assert got.shape == (BATCH, jc.n_meta_tokens + EXTRA + SEQ, jc.d_model)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_aux_load_balance_loss_matches_jax():
    rng = np.random.default_rng(6)
    logits = rng.standard_normal((40, 8)).astype(np.float32)
    logits[:, 6:] = -np.inf                     # two padded slots
    idx = np.argsort(-logits, axis=-1, kind="stable")[:, :2]
    want = jmoe.aux_load_balance_loss(jnp.asarray(logits), jnp.asarray(idx),
                                      6, 2)
    got = tmoe.aux_load_balance_loss(_t(logits), _t(idx), 6, 2)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------
def _cli(tmp_path, *extra):
    return ["--arch", "gemma3-1b", "--smoke", "--device", "cpu",
            "--steps", "8", "--batch", "2", "--seq", "16", "--log-every",
            "100", "--ckpt-dir", str(tmp_path), "--ckpt-every", "3", *extra]


def test_train_cli_restarts_from_the_checkpoint(tmp_path, capsys):
    """``--fail-at 5`` on the CPU: the first attempt fails at step 5, the
    restart resumes from the step-3 checkpoint, and its losses from there
    equal an uninterrupted run's bit for bit."""
    clean = ttrain.main(_cli(tmp_path / "clean"))
    res = ttrain.main(_cli(tmp_path / "faulted", "--fail-at", "5"))
    out = capsys.readouterr().out
    assert "injected failure at step 5" in out
    assert "restored checkpoint step=3" in out
    assert res.start_step == 3 and res.steps_done == 8 == clean.steps_done
    assert res.losses == clean.losses[3:]
    assert sorted(os.listdir(tmp_path / "faulted")) == [
        "step_00000003", "step_00000006", "step_00000008"]


def test_train_cli_defaults_to_cuda_and_raises_without_it(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    argv = [a for a in _cli(tmp_path) if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain.main(argv + ["--max-restarts", "0"])
