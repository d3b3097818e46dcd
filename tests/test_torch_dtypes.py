"""Every dtype combination of the engine's datapaths, the port against the
JAX package, on the CPU.

The port's plain GEMM (``kernels.ref.gemm_ref``), conv (``conv2d_ref``)
and epilogue (``kernels.epilogue.apply``) against JAX's on all 186
(input, accumulator, output) combinations ``gemm_ref`` accepts, the mixed
input pairs, and the combinations where JAX raises; a few combinations
against the JAX ``gemm_os`` / ``gemm_ws`` kernels in interpret mode at a
single K tile; the fp16 attention and SSD plain versions against the JAX
kernels in interpret mode; and the smoke gemma3-1b and hymba-1.5b at fp16
on the fp16 engine config against the JAX engine. These plain versions are
what the CUDA kernels are held against on the card.

Operands (one seed-0 generator per case): integers uniform in the input
type's range, at most +-100000; floats N(0, 9); an fp32 bias N(0, 10^4)
(converted to the accumulator by XLA's rules, so an integer accumulator
sees saturating truncation); shift 1.

The rule: where the product sums in an integer dtype, the result is equal
bit for bit, and so is every epilogue (``apply``) alone but fp32 SiLU,
whose exp is each library's own (within 1e-6 relative, an integer output
within one count). Where the product sums in a float dtype, the two sides
add the same fp32 products in other orders: within the existing fp rule of
the coarsest float type the value passes through (fp32 1e-5 relative plus
1e-6 of the largest magnitude; bf16 / fp16 one ulp, 2^-7 / 2^-10
relative, plus 2^-14 of the largest magnitude), an integer output within
one count more (a truncation may fall either side), infinities in the same
places, and so are NaNs (GELU or SiLU of an overflowed fp16 value).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core.config import Activation as JActivation
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.core.context import ExecutionContext as JContext
from repro.core import tiling as jtiling
from repro.kernels import attention as jak
from repro.kernels import epilogue as jepi
from repro.kernels import gemm as jgemm
from repro.kernels import mamba2 as jm2
from repro.kernels import ref as jref
from repro.models import transformer as jtf

from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.config import Activation, GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.kernels import attention as tak
from repro_torch.kernels import epilogue as tepi
from repro_torch.kernels import mamba2 as tm2
from repro_torch.kernels import ref as tref
from repro_torch.models import transformer as ttf

NAMES = ("int8", "int16", "int32", "bfloat16", "float16", "float32")
TORCH = {"int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
         "bfloat16": torch.bfloat16, "float16": torch.float16,
         "float32": torch.float32}
_BITS = {"int8": 8, "int16": 16, "int32": 32, "bfloat16": 16,
         "float16": 16, "float32": 32}
_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10, "float32": 1e-5}


def _raises(a: str, b: str, acc: str) -> bool:
    """Where JAX's dot_general refuses the accumulator: both inputs integer
    and the accumulator narrower than either."""
    ints = a.startswith("int") and b.startswith("int")
    return ints and _BITS[acc] < max(_BITS[a], _BITS[b])


# the 186 combinations: 31 (input, accumulator) pairs x 6 outputs
COMBOS = [(i, a, o) for i in NAMES for a in NAMES for o in NAMES
          if not _raises(i, i, a)]
MIXED = [(a, b) for a in NAMES for b in NAMES if a != b]
assert len(COMBOS) == 186


def _act(i: int, acc: str) -> str:
    """A combination's activation, every unit in turn (SiLU only on a
    float accumulator: JAX refuses it on an integer one)."""
    acts = ["RELU", "GELU", "RELU6", "NONE", "SILU"]
    act = acts[i % len(acts)]
    return "RELU" if act == "SILU" and acc.startswith("int") else act


def _draw(rng, name: str, shape) -> np.ndarray:
    if name.startswith("int"):
        lim = min(int(np.iinfo(name).max), 100000)
        return rng.integers(-lim, lim + 1, shape).astype(name)
    return (rng.standard_normal(shape) * 3).astype(np.float32)


def _j(x: np.ndarray, name: str):
    return jnp.asarray(x).astype(name)


def _t(x: np.ndarray, name: str) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype == jnp.bfloat16:
        x = x.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(x)).to(TORCH[name])


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.double().numpy() if x.is_floating_point() else \
            x.numpy().astype(np.float64)
    return np.asarray(x).astype(np.float64)


def _hold(got: torch.Tensor, want, exact: bool, floats=()) -> None:
    """``got`` (the port) against ``want`` (JAX) by the module's rule;
    ``floats``: the float dtypes the value passed through."""
    assert str(got.dtype).split(".")[-1] == str(want.dtype), \
        (got.dtype, want.dtype)
    assert tuple(got.shape) == tuple(want.shape)
    g, w = _f64(got), _f64(want)
    if exact:
        np.testing.assert_array_equal(g, w)
        return
    nan = np.isnan(w)                  # GELU / SiLU of an fp16 overflow
    np.testing.assert_array_equal(np.isnan(g), nan)
    inf = np.isinf(w)
    np.testing.assert_array_equal(np.isinf(g), inf)
    np.testing.assert_array_equal(g[inf], w[inf])
    g, w = g[~(inf | nan)], w[~(inf | nan)]
    scale = np.abs(w).max() if w.size else 0.0
    rtol = max(_ULP[f] for f in floats)
    atol = (1e-6 if rtol == 1e-5 else 2.0 ** -14) * scale
    if not got.is_floating_point():
        atol += 1.0
    np.testing.assert_array_less(np.abs(g - w), rtol * np.abs(w) + atol
                                 + 1e-300)


def _float_route(a: str, b: str, acc: str, out: str):
    """The float dtypes the product and the epilogue pass through (empty:
    the product sums in an integer dtype, the result exact)."""
    dot = str(tref.product_dtypes(TORCH[a], TORCH[b], TORCH[acc])) \
        .split(".")[-1]
    if dot.startswith("int"):
        return ()
    return tuple(d for d in (dot, acc, out) if not d.startswith("int"))


# ---------------------------------------------------------------------------
# the GEMM and the conv on every combination
# ---------------------------------------------------------------------------
def _gemm_case(a_name, b_name, acc, out, act, seed):
    rng = np.random.default_rng(seed)
    a = _draw(rng, a_name, (8, 64))
    b = _draw(rng, b_name, (64, 8))
    d = (rng.standard_normal((1, 8)) * 1e4).astype(np.float32)
    kw = dict(shift=1)
    want = jref.gemm_ref(_j(a, a_name), _j(b, b_name), jnp.asarray(d),
                         acc_dtype=acc, out_dtype=out,
                         activation=JActivation[act], **kw)
    got = tref.gemm_ref(_t(a, a_name), _t(b, b_name), torch.from_numpy(d),
                        acc_dtype=TORCH[acc], out_dtype=TORCH[out],
                        activation=Activation[act], **kw)
    floats = _float_route(a_name, b_name, acc, out)
    _hold(got, want, not floats, floats)


@pytest.mark.parametrize("combo", COMBOS, ids="-".join)
def test_gemm_ref_matches_jax(combo):
    i, acc, out = combo
    _gemm_case(i, i, acc, out, _act(COMBOS.index(combo), acc), 0)


@pytest.mark.parametrize("pair", MIXED, ids="@".join)
def test_gemm_ref_mixed_inputs_match_jax(pair):
    """Mixed input dtypes (JAX converts both to the accumulator first) on
    every accumulator JAX accepts, the output cycling through the table."""
    a, b = pair
    for j, acc in enumerate(NAMES):
        if _raises(a, b, acc):
            continue
        out = NAMES[(j + MIXED.index(pair)) % len(NAMES)]
        _gemm_case(a, b, acc, out, _act(j, acc), j)


@pytest.mark.parametrize("pair", [(a, b) for a in NAMES for b in NAMES],
                         ids="@".join)
def test_gemm_ref_raises_where_jax_raises(pair):
    """``TypeError`` on exactly JAX's combinations, for each accumulator."""
    a, b = pair
    x, y = np.ones((1, 2)), np.ones((2, 1))
    for acc in NAMES:
        jax_raises = port_raises = False
        try:
            jref.gemm_ref(_j(x, a), _j(y, b), None, acc_dtype=acc,
                          out_dtype=acc)
        except TypeError:
            jax_raises = True
        try:
            tref.gemm_ref(_t(x.astype(np.float32), "float32").to(TORCH[a]),
                          _t(y.astype(np.float32), "float32").to(TORCH[b]),
                          None, acc_dtype=TORCH[acc], out_dtype=TORCH[acc])
        except TypeError:
            port_raises = True
        assert jax_raises == port_raises == _raises(a, b, acc), (a, b, acc)


@pytest.mark.parametrize("combo", COMBOS, ids="-".join)
def test_conv2d_ref_matches_jax(combo):
    """A 2 x 2 conv whose im2col is the GEMM tests' (8, 64) x (64, 8)."""
    i, acc, out = combo
    rng = np.random.default_rng(1)
    x = _draw(rng, i, (2, 3, 3, 16))
    w = _draw(rng, i, (2, 2, 16, 8))
    bias = (rng.standard_normal((8,)) * 1e4).astype(np.float32)
    act = _act(COMBOS.index(combo) + 1, acc)
    want = jref.conv2d_ref(_j(x, i), _j(w, i), jnp.asarray(bias),
                           acc_dtype=acc, out_dtype=out, shift=1,
                           activation=JActivation[act])
    got = tref.conv2d_ref(_t(x, i), _t(w, i), torch.from_numpy(bias),
                          acc_dtype=TORCH[acc], out_dtype=TORCH[out],
                          shift=1, activation=Activation[act])
    floats = _float_route(i, i, acc, out)
    _hold(got, want, not floats, floats)


# ---------------------------------------------------------------------------
# the epilogue alone: bit for bit on every (accumulator, output) pair
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pair", [(a, o) for a in NAMES for o in NAMES],
                         ids="-".join)
def test_epilogue_apply_matches_jax(pair):
    acc, out = pair
    rng = np.random.default_rng(2)
    x = _draw(rng, acc, (8, 8))
    if not acc.startswith("int"):
        x = x * 30                       # past int8's range, some past fp16's
    for act in ("NONE", "RELU", "RELU6", "GELU", "SILU"):
        for shift in (0, 3):
            kw = dict(shift=shift)
            if act == "SILU" and acc.startswith("int"):
                with pytest.raises(TypeError):
                    jepi.apply(_j(x, acc), activation=JActivation[act],
                               out_dtype=out, **kw)
                with pytest.raises(TypeError):
                    tepi.apply(_t(x, acc), activation=Activation[act],
                               out_dtype=TORCH[out], **kw)
                continue
            want = jepi.apply(_j(x, acc), activation=JActivation[act],
                              out_dtype=out, **kw)
            got = tepi.apply(_t(x, acc), activation=Activation[act],
                             out_dtype=TORCH[out], **kw)
            if act == "SILU" and acc == "float32":
                _hold(got, want, False, ("float32",))
            else:
                _hold(got, want, True)


def test_casts_follow_xla_convert():
    """Float -> integer truncates toward zero, saturates and maps NaN to 0
    (``Tensor.to`` would wrap 300.0 to 44 in int8); int32 -> fp16 rounds to
    nearest even and overflows to inf."""
    f = np.array([300., -300., 1e10, -1e10, np.nan, 2.7, -2.7, np.inf],
                 np.float32)
    for name in ("int8", "int16", "int32"):
        want = jnp.asarray(f).astype(name)
        got = tepi.convert(torch.from_numpy(f), TORCH[name])
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    i = np.array([70000, 65520, 65519, -70000], np.int32)
    want = jnp.asarray(i).astype(jnp.float16)
    got = tepi.convert(torch.from_numpy(i), torch.float16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the JAX kernels in interpret mode at a single K tile (no per-tile rounding)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dataflow", ["OS", "WS"])
@pytest.mark.parametrize("combo", [
    ("int8", "int16", "int8"), ("int8", "int32", "float16"),
    ("bfloat16", "bfloat16", "bfloat16"), ("float16", "bfloat16", "int8"),
    ("int16", "float32", "bfloat16"), ("float32", "float16", "float32")],
    ids="-".join)
def test_interpret_kernels_at_one_k_tile(combo, dataflow):
    i, acc, out = combo
    short = {"bfloat16": "bf16", "float16": "fp16", "float32": "fp32"}
    cfg = JGemminiConfig(input_dtype=short.get(i, i),
                         acc_dtype=short.get(acc, acc),
                         output_dtype=short.get(out, out))
    rng = np.random.default_rng(3)
    m, n, k = 16, 128, 128
    a, b = _draw(rng, i, (m, k)), _draw(rng, i, (k, n))
    d = (rng.standard_normal((1, n)) * 1e4).astype(np.float32)
    plan = next(p for p in jtiling.enumerate_plans(cfg, m, n, k,
                                                   max_candidates=64)
                if p.tile_k >= p.k)
    pad = ((0, plan.m - m), (0, plan.k - k)), ((0, plan.k - k),
                                               (0, plan.n - n))
    fn = jgemm.gemm_os if dataflow == "OS" else jgemm.gemm_ws
    want = fn(_j(np.pad(a, pad[0]), i), _j(np.pad(b, pad[1]), i),
              jnp.asarray(np.broadcast_to(np.pad(d, ((0, 0), (0, plan.n - n))),
                                          (plan.m, plan.n))).astype(acc),
              plan, cfg, shift=1, activation=JActivation.RELU,
              interpret=True)
    got = tref.gemm_ref(_t(a, i), _t(b, i), torch.from_numpy(d),
                        acc_dtype=TORCH[acc], out_dtype=TORCH[out], shift=1,
                        activation=Activation.RELU)
    floats = _float_route(i, i, acc, out)
    _hold(got, want[:m, :n], not floats, floats)


# ---------------------------------------------------------------------------
# fp16 through the attention and SSD kernels' plain versions
# ---------------------------------------------------------------------------
F16_TOL = 2.0 ** -10        # one fp16 ulp (both sides compute in fp32)


def _f16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(torch.float16)


def _hold_f16(got, want):
    assert got.dtype == torch.float16
    g, w = got.float().numpy(), np.asarray(want, np.float32)
    assert np.isfinite(g).all()
    np.testing.assert_allclose(g, w, rtol=F16_TOL,
                               atol=F16_TOL * np.abs(w).max())


def test_fp16_flash_attention_matches_jax_kernel():
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((1, 40, 4, 16)).astype(np.float16)
               for _ in range(3))
    k, v = k[:, :, :2], v[:, :, :2]
    kw = dict(causal=True, window=16, softcap=None)
    want = jak.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                               block_q=16, block_k=16, interpret=True, **kw)
    assert want.dtype == jnp.float16
    _hold_f16(tak.flash_attention(_f16(q), _f16(k), _f16(v), **kw), want)


def test_fp16_decode_attention_matches_jax_kernel():
    rng = np.random.default_rng(5)
    q = rng.standard_normal((2, 1, 4, 16)).astype(np.float16)
    k, v = (rng.standard_normal((2, 48, 2, 16)).astype(np.float16)
            for _ in range(2))
    want = jak.decode_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                jnp.asarray(40), window=24, block_k=16,
                                interpret=True)
    got = tak.decode_attention(_f16(q), _f16(k), _f16(v), 40, window=24)
    _hold_f16(got, want)


def _pools(rng, kvh, n_pool, page, d, lens, mp):
    pk = rng.standard_normal((kvh, n_pool, page, d)).astype(np.float16)
    pv = rng.standard_normal((kvh, n_pool, page, d)).astype(np.float16)
    tables = rng.permutation(n_pool)[:len(lens) * mp].reshape(
        len(lens), mp).astype(np.int32)
    return pk, pv, tables


def test_fp16_paged_decode_attention_matches_jax_kernel():
    rng = np.random.default_rng(6)
    lens = np.array([37, 1, 60], np.int32)
    pk, pv, tables = _pools(rng, 2, 16, 16, 16, lens, 4)
    q = rng.standard_normal((3, 1, 4, 16)).astype(np.float16)
    want = jak.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
        jnp.asarray(lens), interpret=True)
    got = tak.paged_decode_attention(
        _f16(q), _f16(pk), _f16(pv), torch.from_numpy(tables),
        torch.from_numpy(lens))
    _hold_f16(got, want)


def test_fp16_paged_prefill_attention_matches_jax_kernel():
    rng = np.random.default_rng(7)
    pk, pv, tables = _pools(rng, 2, 12, 16, 16, [1], 6)
    q = rng.standard_normal((1, 24, 4, 16)).astype(np.float16)
    want = jak.paged_prefill_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(tables[0]), jnp.asarray(40), block_q=8, interpret=True)
    got = tak.paged_prefill_attention(_f16(q), _f16(pk), _f16(pv),
                                      torch.from_numpy(tables[0]), 40)
    _hold_f16(got, want)


def test_fp16_ssd_matches_jax_kernel():
    rng = np.random.default_rng(8)
    bsz, t, h, p, g, n = 1, 48, 4, 8, 2, 16
    x = rng.standard_normal((bsz, t, h, p)).astype(np.float16)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, t, h)))).astype(
        np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    b, c = ((rng.standard_normal((bsz, t, g, n)) * 0.3).astype(np.float16)
            for _ in range(2))
    d_skip = np.ones((h,), np.float32)
    want = jm2.ssd(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a_log),
                   jnp.asarray(b), jnp.asarray(c),
                   d_skip=jnp.asarray(d_skip), chunk=16, interpret=True)
    assert want.dtype == jnp.float16
    got = tm2.ssd(_f16(x), torch.from_numpy(dt), torch.from_numpy(a_log),
                  _f16(b), _f16(c), d_skip=torch.from_numpy(d_skip),
                  chunk=16)
    _hold_f16(got, want)


# ---------------------------------------------------------------------------
# an fp16 model on the fp16 engine config, the port against the JAX engine
# ---------------------------------------------------------------------------
# The fp16 logits' tolerance: relative L2 at most 1e-2 of the JAX logits
# (both sides round every projection and norm output to fp16, 2^-11
# relative, and sum in fp32 in other orders; a few layers drift by a few
# of those).
F16_LOGITS_TOL = 1e-2
F16_ENGINE = dict(input_dtype="fp16", acc_dtype="fp32", output_dtype="fp16")


@pytest.mark.parametrize("arch", ["gemma3-1b", "hymba-1.5b"])
def test_fp16_model_logits_match_jax_engine(arch):
    jc = dataclasses.replace(jconfigs.get_smoke(arch), dtype=jnp.float16)
    tc = dataclasses.replace(tconfigs.get_smoke(arch), dtype=torch.float16)
    tree = jax.tree.map(np.asarray,
                        jtf.init_params(jax.random.PRNGKey(0), jc))
    jp = jax.tree.map(jnp.asarray, tree)
    tp = params_from_numpy(tree)
    jctx = JContext(cfg=JGemminiConfig(**F16_ENGINE), backend="xla")
    tctx = ExecutionContext(cfg=GemminiConfig(**F16_ENGINE))
    page, mp = 8, 6
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jc.vocab, (1, 24)).astype(np.int32)
    pages = np.arange(mp, dtype=np.int32)
    js = jtf.init_paged_state(jc, 1, mp, page, mp, dtype=jnp.float16)
    ts = ttf.init_paged_state(tc, 1, mp, page, mp, dtype=torch.float16)
    want, _ = jtf.paged_prefill(jctx, jp, jc, jnp.asarray(toks), js, 0,
                                jnp.asarray(pages), page_size=page)
    got, _ = ttf.paged_prefill(tctx, tp, tc, torch.from_numpy(toks), ts, 0,
                               torch.from_numpy(pages), page_size=page)
    w = np.asarray(want, np.float64)
    g = got.double().numpy()
    assert got.dtype == torch.float16 or got.dtype == torch.float32
    assert np.isfinite(w).all() and np.isfinite(g).all()
    rel = np.linalg.norm(g - w) / np.linalg.norm(w)
    assert rel <= F16_LOGITS_TOL, rel
