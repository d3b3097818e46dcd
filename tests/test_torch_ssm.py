"""The port's recurrent, hybrid and audio families and its static reference
path against the JAX package, on the CPU.

Kernel level: the plain chunked SSD (``ssd_plain``) against the JAX XLA
route (``ssd_chunked_xla`` + ``_final_state``), the naive recurrence
(``ssd_ref``, both packages) and the Pallas kernel in interpret mode; the
dense ``decode_attention`` plain version against the Pallas decode kernel
(interpret) and the JAX model-level ``decode_attention``; the card checks'
fp64 recurrence (``_ssd_exact``) against the JAX route. Model level: the
Mamba-2 mixer (prefill, resumed chunk, decode) and the static path's
``prefill_into_cache`` / ``decode_step`` logits against the JAX functions
on ``xla_twin``. Engine level: greedy token streams against the JAX
``ServingEngine(backend="xla_twin")`` under the fp32 engine config, with
chunking, forced preemption, defrag and host offload. Finally the port's
``serve_decode`` gate in bf16 on the CPU.

Tolerances: fp32 on both sides; the chunked SSD computes the same einsums
in another summation order (1e-5 of the output's largest magnitude); the
naive recurrence and the Pallas kernel sum along another route again
(the JAX package's own SSD tests hold them to 1e-4; here 1e-5 where the
numbers allow it). Logits: 2e-5 absolute / 1e-4 relative, as in
``test_torch_model``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.core.context import ExecutionContext as JContext
from repro.kernels import attention as jak
from repro.kernels import mamba2 as jm2
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro.models import transformer as jtf
from repro.serving import ServingEngine as JServingEngine

from repro_torch import configs as tconfigs
from repro_torch.convert import (decode_state_from_numpy,
                                 paged_state_from_numpy, params_from_numpy)
from repro_torch.core.config import GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.examples import serve_decode
from repro_torch.kernels import attention as tak
from repro_torch.kernels import mamba2 as tm2
from repro_torch.kernels import ref as tref
from repro_torch.models import layers as tlayers
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf
from repro_torch.serving import ServingEngine

from _ssd_exact import fp32_tolerance, ssd_fp64

F32 = dict(input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32")
SSD_TOL = 1e-5
ATOL, RTOL = 2e-5, 1e-4
_PERTURB = ("ln1", "ln2", "post_ln1", "post_ln2", "qnorm", "knorm",
            "final_norm", "attn_out_norm", "ssm_out_norm", "norm", "dt_bias",
            "d_skip")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().float().numpy()


_jit_chunked = jax.jit(jssm.ssd_chunked_xla, static_argnames=("chunk",))
_jit_final = jax.jit(jssm._final_state)
_jit_ref = jax.jit(jref.ssd_ref)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)) /
                 np.max(np.abs(want)))


# ---------------------------------------------------------------------------
# causal conv1d
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv1d_bit_exact(with_state):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    st = rng.standard_normal((2, 3, 24)).astype(np.float32) \
        if with_state else None
    jy, jst = jlayers.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                    None if st is None else jnp.asarray(st))
    ty, tst = tlayers.causal_conv1d(_t(x), _t(w),
                                    None if st is None else _t(st))
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())
    np.testing.assert_array_equal(np.asarray(jst), tst.numpy())


# ---------------------------------------------------------------------------
# the chunked SSD
# ---------------------------------------------------------------------------
def _ssd_inputs(seed, bsz, t, h, p, g, n):
    rng = np.random.default_rng(seed)
    f = np.float32
    return dict(
        x=rng.standard_normal((bsz, t, h, p)).astype(f),
        dt=(np.abs(rng.standard_normal((bsz, t, h)) * 0.5) + 0.01).astype(f),
        a_log=(rng.standard_normal((h,)) * 0.3).astype(f),
        b=(rng.standard_normal((bsz, t, g, n)) * 0.3).astype(f),
        c=(rng.standard_normal((bsz, t, g, n)) * 0.3).astype(f),
        d_skip=(rng.standard_normal((h,)) * 0.5).astype(f))


SSD_CASES = [
    # bsz, t, h, p, g, n, chunk
    (2, 64, 4, 16, 2, 32, 16),
    (1, 100, 2, 8, 1, 16, 32),      # ragged T
    (1, 7, 4, 8, 1, 8, 256),        # T < chunk: q = min(chunk, T)
    (2, 33, 8, 8, 2, 8, 16),        # grouped heads, ragged
]


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("resume", [False, True])
def test_ssd_plain_matches_jax_chunked(case, resume):
    bsz, t, h, p, g, n, chunk = case
    d = _ssd_inputs(1, bsz, t, h, p, g, n)
    init = (np.random.default_rng(2).standard_normal((bsz, h, n, p)) * 0.5
            ).astype(np.float32) if resume else None
    jy = _jit_chunked(
        *(jnp.asarray(d[k]) for k in ("x", "dt", "a_log", "b", "c")),
        d_skip=jnp.asarray(d["d_skip"]), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init))
    _, jfs = _jit_final(
        *(jnp.asarray(d[k]) for k in ("x", "dt", "a_log", "b", "c")),
        initial_state=None if init is None else jnp.asarray(init))
    ty, tfs = tm2.ssd_plain(*(_t(d[k]) for k in ("x", "dt", "a_log", "b",
                                                   "c")),
                            d_skip=_t(d["d_skip"]), chunk=chunk,
                            initial_state=None if init is None else _t(init),
                            return_final_state=True)
    assert _rel(ty.numpy(), jy) <= SSD_TOL
    assert _rel(tfs.numpy(), jfs) <= SSD_TOL


@pytest.mark.parametrize("resume", [False, True])
def test_ssd_plain_matches_jax_at_mamba2_geometry(resume):
    """The fp32 plain version the card's fp32 SSD kernel is held against,
    at mamba2-1.3b's head geometry (P = 64, N = 128, G = 1; 4 of its 64
    heads) on one 256-token chunk, fresh and resumed, against the JAX
    chunked SSD (the XLA route and ``_final_state``): SSD_TOL of the
    largest magnitude, y and the final state."""
    bsz, t, h, p, g, n, chunk = 1, 256, 4, 64, 1, 128, 256
    d = _ssd_inputs(7, bsz, t, h, p, g, n)
    init = (np.random.default_rng(8).standard_normal((bsz, h, n, p)) * 0.5
            ).astype(np.float32) if resume else None
    jin = [jnp.asarray(d[k]) for k in ("x", "dt", "a_log", "b", "c")]
    jinit = None if init is None else jnp.asarray(init)
    jy = _jit_chunked(*jin, d_skip=jnp.asarray(d["d_skip"]), chunk=chunk,
                      initial_state=jinit)
    _, jfs = _jit_final(*jin, initial_state=jinit)
    ty, tfs = tm2.ssd_plain(*(_t(d[k]) for k in ("x", "dt", "a_log", "b",
                                                   "c")),
                            d_skip=_t(d["d_skip"]), chunk=chunk,
                            initial_state=None if init is None else _t(init),
                            return_final_state=True)
    assert _rel(ty.numpy(), jy) <= SSD_TOL
    assert _rel(tfs.numpy(), jfs) <= SSD_TOL


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_plain_matches_recurrence_and_pallas(case):
    """Zero initial state: the naive recurrence (the port's and the JAX
    package's) and the Pallas kernel in interpret mode, final state
    included."""
    bsz, t, h, p, g, n, chunk = case
    d = _ssd_inputs(3, bsz, t, h, p, g, n)
    args = ("x", "dt", "a_log", "b", "c")
    ty, tfs = tm2.ssd_plain(*(_t(d[k]) for k in args),
                            d_skip=_t(d["d_skip"]), chunk=chunk,
                            return_final_state=True)
    jin = [jnp.asarray(d[k]) for k in args]
    want_ref = _jit_ref(*jin, d_skip=jnp.asarray(d["d_skip"]))
    port_ref = tref.ssd_ref(*(_t(d[k]) for k in args), d_skip=_t(d["d_skip"]))
    jy, jfs = jm2.ssd(*jin, d_skip=jnp.asarray(d["d_skip"]), chunk=chunk,
                      interpret=True, return_final_state=True)
    assert _rel(port_ref.numpy(), want_ref) <= SSD_TOL
    assert _rel(ty.numpy(), want_ref) <= SSD_TOL
    assert _rel(ty.numpy(), jy) <= SSD_TOL
    assert _rel(tfs.numpy(), jfs) <= SSD_TOL


@pytest.mark.parametrize("case", SSD_CASES)
@pytest.mark.parametrize("resume", [False, True])
def test_ssd_fp64_yardstick_matches_jax_and_plain(case, resume):
    """The card checks' fp64 recurrence (``_ssd_exact``) gives the JAX
    chunked route's y and final state, and the plain version's fp32
    results lie within ``fp32_tolerance`` of it."""
    bsz, t, h, p, g, n, chunk = case
    d = _ssd_inputs(5, bsz, t, h, p, g, n)
    init = (np.random.default_rng(6).standard_normal((bsz, h, n, p)) * 0.5
            ).astype(np.float32) if resume else None
    args = ("x", "dt", "a_log", "b", "c")
    jin = [jnp.asarray(d[k]) for k in args]
    jinit = None if init is None else jnp.asarray(init)
    jy = _jit_chunked(*jin, d_skip=jnp.asarray(d["d_skip"]), chunk=chunk,
                      initial_state=jinit)
    _, jfs = _jit_final(*jin, initial_state=jinit)
    tin = [_t(d[k]) for k in args]
    tinit = None if init is None else _t(init)
    ey, efs = ssd_fp64(*tin, d_skip=_t(d["d_skip"]), initial_state=tinit)
    assert ey.dtype == efs.dtype == torch.float64
    assert _rel(ey.numpy(), jy) <= SSD_TOL
    assert _rel(efs.numpy(), jfs) <= SSD_TOL
    ty, tfs = tm2.ssd_plain(*tin, d_skip=_t(d["d_skip"]), chunk=chunk,
                            initial_state=tinit, return_final_state=True)
    tol = fp32_tolerance(tin[1], tin[2], chunk)
    assert _rel(ty.numpy(), ey.numpy()) <= tol
    assert _rel(tfs.numpy(), efs.numpy()) <= tol


def test_ssd_split_equals_single_pass():
    """Two segments, the second resumed from the first's final state, give
    the single pass (what a chunked prefill relies on)."""
    d = _ssd_inputs(4, 1, 40, 4, 8, 1, 16)
    args = [_t(d[k]) for k in ("x", "dt", "a_log", "b", "c")]
    y, fs = tm2.ssd_plain(*args, d_skip=_t(d["d_skip"]), chunk=16,
                          return_final_state=True)
    first = [a[:, :24] if a.dim() > 1 else a for a in args]
    second = [a[:, 24:] if a.dim() > 1 else a for a in args]
    y1, s1 = tm2.ssd_plain(*first, d_skip=_t(d["d_skip"]), chunk=16,
                           return_final_state=True)
    y2, s2 = tm2.ssd_plain(*second, d_skip=_t(d["d_skip"]), chunk=16,
                           initial_state=s1, return_final_state=True)
    assert _rel(torch.cat([y1, y2], 1).numpy(), y.numpy()) <= SSD_TOL
    assert _rel(s2.numpy(), fs.numpy()) <= SSD_TOL


# ---------------------------------------------------------------------------
# dense decode attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("h,kvh,pos,window,softcap",
                         [(4, 1, 37, None, None), (8, 2, 63, 16, 50.0),
                          (4, 4, 0, None, None), (5, 5, 20, 8, None),
                          (4, 1, 0, 8, None)])
def test_decode_attention_plain_matches_jax(h, kvh, pos, window, softcap):
    rng = np.random.default_rng(5)
    b, s, d = 2, 64, 16
    q = rng.standard_normal((b, 1, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kvh, d)).astype(np.float32)
    got = tak.decode_attention_plain(_t(q), _t(k), _t(v), pos, window=window,
                                     softcap=softcap)
    want_kernel = jak.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos),
        window=window, softcap=softcap, block_k=16, interpret=True)
    want_model = jattn.decode_attention(
        jnp.asarray(q), jattn.KVCache(jnp.asarray(k), jnp.asarray(v)),
        jnp.int32(pos), window=window, softcap=softcap)
    for want in (want_kernel, want_model):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-6)
    # the wrapper takes the plain version for a CPU tensor
    via = tak.decode_attention(_t(q), _t(k), _t(v), pos, window=window,
                               softcap=softcap)
    assert torch.equal(via, got)


# ---------------------------------------------------------------------------
# models: configs, params, the Mamba-2 mixer, the static path
# ---------------------------------------------------------------------------
ARCHS = ("gemma2-2b", "mamba2-1.3b", "hymba-1.5b", "musicgen-medium")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_tree_match_jax(arch):
    jc, tc = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    for f in dataclasses.fields(jc):
        if f.name != "dtype":
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    for full in (jconfigs.get(arch), tconfigs.get(arch)):
        assert full.n_layers == jconfigs.get(arch).n_layers
    ref = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)),
                       jtf.init_params(jax.random.PRNGKey(0), jc))
    got = ttf.init_params(torch.Generator().manual_seed(0), tc)

    def shapes(node):
        if isinstance(node, dict):
            return {k: shapes(v) for k, v in node.items()}
        return (tuple(node.shape), str(node.dtype).replace("torch.", ""))
    assert shapes(got) == ref


def _model(arch, seed=0, **kw):
    """fp32 JAX / port configs and a numpy tree with the norm scales and
    the SSM's dt_bias / d_skip perturbed off their initial constants."""
    jc = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float32,
                             **kw)
    tc = dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float32,
                             **kw)
    rng = np.random.default_rng(seed + 11)
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(seed), jc))

    def perturb(path, a):
        if path[-1].key in _PERTURB:
            return (a + 0.3 * rng.standard_normal(a.shape)).astype(a.dtype)
        return a
    return jc, tc, jax.tree_util.tree_map_with_path(perturb, tree)


def _ctxs():
    return (JContext(cfg=JGemminiConfig(**F32), backend="xla_twin"),
            ExecutionContext(cfg=GemminiConfig(**F32)))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), _np(b), atol=ATOL, rtol=RTOL)


def test_mamba2_apply_prefill_resume_decode_match_jax():
    """One Mamba-2 layer: a fresh 11-token prefill, a resumed 6-token
    chunk, then one decode token, carrying conv and SSM state."""
    jc, tc, tree = _model("mamba2-1.3b")
    jctx, tctx = _ctxs()
    lp = jax.tree.map(lambda a: a[0], tree["blocks"]["mamba"])
    jp, tp = jax.tree.map(jnp.asarray, lp), params_from_numpy(lp)
    kw = dict(d_inner=jc.d_inner, n_heads=jc.n_ssm_heads,
              d_state=jc.d_state, n_groups=jc.ssm_groups, chunk=8)
    rng = np.random.default_rng(6)
    u = rng.standard_normal((2, 18, jc.d_model)).astype(np.float32)
    conv0 = np.zeros((2, jc.d_conv - 1, tc.conv_dim), np.float32)
    jcache = jssm.SSMCache(jnp.asarray(conv0), None)
    tcache = tssm.SSMCache(_t(conv0), None)
    japply = jax.jit(lambda u, c: jssm.mamba2_apply(jctx, jp, u, cache=c,
                                                    **kw))
    for lo, hi in ((0, 11), (11, 17), (17, 18)):
        jy, jcache = japply(jnp.asarray(u[:, lo:hi]), jcache)
        ty, tcache = tssm.mamba2_apply(tctx, tp, _t(u[:, lo:hi]),
                                       cache=tcache, **kw)
        _close(jy, ty)
        _close(jcache.conv, tcache.conv)
        _close(jcache.state, tcache.state)


@pytest.mark.parametrize("arch", ARCHS)
def test_static_path_logits_match_jax(arch):
    """``prefill_into_cache`` over a 9-token prompt, then three
    ``decode_step`` tokens: logits and every cache against JAX."""
    jc, tc, tree = _model(arch, seed=1)
    jctx, tctx = _ctxs()
    jp, tp = jax.tree.map(jnp.asarray, tree), params_from_numpy(tree)
    rng = np.random.default_rng(7)
    shape = (1, 9, tc.n_codebooks) if tc.n_codebooks > 1 else (1, 9)
    toks = rng.integers(0, tc.vocab, shape).astype(np.int32)
    max_seq = 9 + tc.n_meta_tokens + 4
    js = jtf.init_decode_state(jc, 1, max_seq, dtype=jnp.float32)
    js = js._replace(pos=jnp.zeros((), jnp.int32))
    ts = ttf.init_decode_state(tc, 1, max_seq, dtype=torch.float32)
    ts = ts._replace(pos=0)
    jl, js = jtf.prefill_into_cache(jctx, jp, jc, jnp.asarray(toks), js)
    tl, ts = ttf.prefill_into_cache(tctx, tp, tc, _t(toks), ts)
    _close(jl, tl)
    assert ts.pos == int(js.pos) == 9 + tc.n_meta_tokens
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1:], axis=-1), np.int32)
        jl, js = jtf.decode_step(jctx, jp, jc, jnp.asarray(nxt), js)
        tl, ts = ttf.decode_step(tctx, tp, tc, _t(nxt), ts)
        _close(jl, tl)
    back = decode_state_from_numpy(jax.tree.map(np.asarray, js._asdict()))
    assert back.pos == ts.pos
    for name in ("kv_k", "kv_v", "conv", "ssm"):
        a, b = getattr(back, name), getattr(ts, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_allclose(_np(a), _np(b), atol=ATOL, rtol=RTOL)


def test_paged_state_with_recurrent_state_converts():
    jc = jconfigs.get_smoke("hymba-1.5b")
    js = jtf.init_paged_state(jc, 3, 10, 8, 4)
    rng = np.random.default_rng(8)
    js = js._replace(ssm=jnp.asarray(rng.standard_normal(js.ssm.shape),
                                     jnp.float32))
    ts = paged_state_from_numpy(jax.tree.map(np.asarray, js._asdict()))
    ref = ttf.init_paged_state(tconfigs.get_smoke("hymba-1.5b"), 3, 10, 8, 4)
    for name in ("kv_k", "conv", "ssm"):
        assert getattr(ts, name).shape == getattr(ref, name).shape, name
        assert getattr(ts, name).dtype == getattr(ref, name).dtype, name
    np.testing.assert_array_equal(ts.ssm.numpy(), np.asarray(js.ssm))


# ---------------------------------------------------------------------------
# the serving engine against the JAX engine
# ---------------------------------------------------------------------------
def _drive(eng, prompts, gen, defrag_after=None):
    for p in prompts:
        eng.submit(p, gen)
    if defrag_after is not None:
        for _ in range(defrag_after):
            eng.step()
        eng.defrag()
    rep = eng.run()
    return [np.asarray(r["tokens"]).ravel().tolist()
            for r in rep["requests"]], rep["summary"]


def _pair(arch, prompts, gen, defrag_after=None, **kw):
    jc, tc, tree = _model(arch, seed=2)
    jeng = JServingEngine(jc, backend="xla_twin",
                          engine_cfg=JGemminiConfig(**F32),
                          params=jax.tree.map(jnp.asarray, tree),
                          temperature=0.0, seed=0, **kw)
    teng = ServingEngine(tc, engine_cfg=GemminiConfig(**F32),
                         params=params_from_numpy(tree), device="cpu", **kw)
    return (_drive(jeng, prompts, gen, defrag_after),
            _drive(teng, prompts, gen, defrag_after))


def _prompts(seed, lengths, codebooks=1, vocab=128):
    rng = np.random.default_rng(seed)
    shape = (lambda n: (n, codebooks)) if codebooks > 1 else (lambda n: (n,))
    return [rng.integers(0, vocab, shape(n)).astype(np.int32)
            for n in lengths]


ENGINE_ARCHS = ("mamba2-1.3b", "hymba-1.5b", "musicgen-medium")


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
def test_chunked_engine_tokens_match_jax(arch):
    """Three requests over two slots, 8-token chunks: first chunks,
    resumed chunks, decode with slots recycled."""
    cb = tconfigs.get_smoke(arch).n_codebooks
    (jt, js), (tt, ts) = _pair(arch, _prompts(0, (19, 9, 26), cb), 5,
                               max_slots=2, max_context=48, page_size=8,
                               prefill_chunk=8)
    assert js["prefill_chunks"] > 3
    assert tt == jt
    assert ts["prefill_chunks"] == js["prefill_chunks"]


@pytest.mark.parametrize("arch", ENGINE_ARCHS)
@pytest.mark.parametrize("kv_offload", [False, True])
def test_preemption_defrag_offload_tokens_match_jax(arch, kv_offload):
    """Two slots over four pages force an eviction, the arena is
    defragmented mid-run; with ``kv_offload`` the victim's pages and its
    conv / SSM state are spilled to the host and restored."""
    cb = tconfigs.get_smoke(arch).n_codebooks
    (jt, js), (tt, ts) = _pair(arch, _prompts(1, (19, 19), cb), 8,
                               defrag_after=3, max_slots=2, max_context=32,
                               page_size=8, n_pages=4, prefill_chunk=8,
                               kv_offload=kv_offload)
    assert js["preemptions"] >= 1
    if kv_offload:
        assert ts["offload_restores"] >= 1 and ts["restarts_recomputed"] == 0
    assert tt == jt
    for key in ("preemptions", "prefill_tokens", "offload_restores"):
        assert ts[key] == js[key], key


@pytest.mark.parametrize("arch", ("mamba2-1.3b", "hymba-1.5b"))
def test_prefix_cache_refused_for_recurrent_families(arch):
    with pytest.raises(ValueError, match="attention-only"):
        ServingEngine(tconfigs.get_smoke(arch), device="cpu", max_context=32,
                      prefix_cache=True)


def test_recurrent_families_prefill_at_exact_length():
    eng = ServingEngine(tconfigs.get_smoke("mamba2-1.3b"), device="cpu",
                        max_context=32, page_size=8)
    assert eng.prefill_pad == 1
    assert eng.state.kv_k is None and eng.state.conv is not None


def test_serve_decode_gate_passes_on_cpu_in_bf16(capsys):
    """The port's four-family gate: engine tokens equal the static path's
    exactly, as the JAX gate requires."""
    assert serve_decode.main(["--device", "cpu"]) == 0
    assert "serve_decode OK" in capsys.readouterr().out
