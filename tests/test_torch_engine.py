"""The port's Gemmini engine path against the JAX package, on the CPU.

Covers ``repro_torch.core`` (config, tiling, isa, dse, quantize,
generator), the int8 datapath of the engine GEMM on both dataflows, the
mvout ``accumulator_epilogue``, conv2d by host im2col and by the fused
route, and the port's quickstart. Inputs come from
``np.random.default_rng`` and go to both sides; the JAX side runs its
Pallas kernels in interpret mode, as the JAX package's own tests do.
Every integer result is bit-exact, and every plan, header and DSE number
equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import config as jconfig
from repro.core import dse as jdse
from repro.core import quantize as jq
from repro.core import tiling as jtiling
from repro.core.config import Activation as JActivation
from repro.core.config import Dataflow as JDataflow
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.core.context import ExecutionContext as JContext
from repro.core.generator import elaborate as jelaborate
from repro.kernels import conv as jconv
from repro.kernels import gemm as jgemm
from repro.kernels import ref as jref

from repro_torch.core import config as tconfig
from repro_torch.core import dse as tdse
from repro_torch.core import quantize as tq
from repro_torch.core import tiling as ttiling
from repro_torch.core.config import Activation, Dataflow, GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.core.generator import elaborate
from repro_torch.examples import quickstart
from repro_torch.kernels import epilogue as tepi
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import ref as tref


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got: torch.Tensor, want) -> None:
    w = np.asarray(want)
    assert got.numpy().dtype == w.dtype, (got.dtype, w.dtype)
    np.testing.assert_array_equal(got.numpy(), w)


def _i8(rng, shape, lo=-128, hi=128) -> np.ndarray:
    return rng.integers(lo, hi, shape).astype(np.int8)


# ---------------------------------------------------------------------------
# int8 GEMM on both dataflows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("act", ["NONE", "RELU", "RELU6"])
@pytest.mark.parametrize("shift", [0, 7])
@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("df", ["OS", "WS"])
@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (200, 136, 260)])
def test_int8_gemm_matches_jax_kernels(m, n, k, df, bias, shift, act):
    """ctx.gemm on an int8 BOTH instance, each dataflow, against the JAX
    gemm_os / gemm_ws kernels in interpret mode (through the op layer's
    padding to the tile plan and the [:m, :n] cut)."""
    rng = np.random.default_rng(m + n + k)
    a, b = _i8(rng, (m, k)), _i8(rng, (k, n))
    d = rng.integers(-20000, 20000, (1, n)).astype(np.int32) if bias else None
    jctx = JContext(cfg=JGemminiConfig(dataflow=JDataflow.BOTH),
                    backend="interpret")
    want = jctx.gemm(jnp.asarray(a), jnp.asarray(b),
                     None if d is None else jnp.asarray(d),
                     dataflow=JDataflow[df], shift=shift,
                     activation=JActivation[act])
    ctx = ExecutionContext(cfg=GemminiConfig(dataflow=Dataflow.BOTH))
    got = ctx.gemm(_t(a), _t(b), None if d is None else _t(d),
                   dataflow=Dataflow[df], shift=shift,
                   activation=Activation[act])
    _eq(got, want)


@pytest.mark.parametrize("out", ["int8", "int32"])
@pytest.mark.parametrize("df", ["OS", "WS"])
@pytest.mark.parametrize("m,n,k,lo", [(40, 24, 384, 120), (17, 136, 200, 96)])
def test_int8_gemm_wraps_like_jax(m, n, k, lo, df, out):
    """The int32 sum wraps modulo 2^32, in the JAX kernels and in the port:
    all-positive operands and a bias within 2^20 of 2^31 - 1 carry every
    output past it (the bits the card's split-K merge must keep)."""
    rng = np.random.default_rng(m * k + n)
    a, b = _i8(rng, (m, k), lo, 128), _i8(rng, (k, n), lo, 128)
    d = rng.integers(2 ** 31 - 2 ** 20, 2 ** 31 - 1, (1, n)).astype(np.int32)
    assert (d.astype(np.int64) + lo * lo * k > 2 ** 31 - 1).all()
    jcfg = JGemminiConfig(dataflow=JDataflow.BOTH, output_dtype=out)
    want = JContext(cfg=jcfg, backend="interpret").gemm(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(d),
        dataflow=JDataflow[df], shift=3, activation=JActivation.NONE)
    ctx = ExecutionContext(cfg=GemminiConfig(dataflow=Dataflow.BOTH,
                                             output_dtype=out))
    got = ctx.gemm(_t(a), _t(b), _t(d), dataflow=Dataflow[df], shift=3,
                   activation=Activation.NONE)
    _eq(got, want)
    if out == "int32":
        exact = (a.astype(np.int64) @ b.astype(np.int64) + d) >> 3
        assert (np.asarray(want) < 0).all() and (exact > 2 ** 28).all()


@pytest.mark.parametrize("out", ["int8", "int32"])
@pytest.mark.parametrize("act,shift", [("RELU", 5), ("NONE", 0),
                                       ("RELU6", 31)])
def test_accumulator_epilogue_matches_jax(out, act, shift):
    """The mvout pass over a raw int32 accumulator (the full int32 range,
    so the shift rounds and the int8 output saturates), and over fp32."""
    rng = np.random.default_rng(shift)
    acc = rng.integers(-2 ** 31, 2 ** 31 - 1, (256, 256)).astype(np.int32)
    jcfg = JGemminiConfig(output_dtype=out)
    plan = jtiling.make_plan(jcfg, 256, 256, 128, 128, 128, 128)
    want = jgemm.accumulator_epilogue(jnp.asarray(acc), plan, jcfg,
                                      shift=shift,
                                      activation=JActivation[act],
                                      interpret=True)
    got = tgemm.accumulator_epilogue(_t(acc), out_dtype=tconfig.dtype_of(out),
                                     shift=shift, activation=Activation[act])
    _eq(got, want)


def test_accumulator_epilogue_fp32_matches_jax():
    rng = np.random.default_rng(9)
    acc = (8 * rng.standard_normal((128, 256))).astype(np.float32)
    jcfg = JGemminiConfig(input_dtype="fp32", acc_dtype="fp32",
                          output_dtype="fp32")
    plan = jtiling.make_plan(jcfg, 128, 256, 128, 128, 128, 128)
    want = jgemm.accumulator_epilogue(jnp.asarray(acc), plan, jcfg, shift=3,
                                      activation=JActivation.GELU,
                                      interpret=True)
    got = tgemm.accumulator_epilogue(_t(acc), out_dtype=torch.float32,
                                     shift=3, activation=Activation.GELU)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("act", ["GELU", "SILU"])
def test_float_units_refused_on_int_accumulator(act):
    """GELU and SiLU on an int32 accumulator, as the JAX package's
    epilogue computes them: SiLU is refused with ``TypeError`` (JAX's
    sigmoid takes no integer), in the plain version and in the GEMM
    wrapper before any launch; GELU runs in fp32 on the shifted value and
    the float result is clipped and truncated to the integer output, equal
    to JAX's bit for bit."""
    acc = np.array([[-300, -5, 0, 3, 5, 700]], np.int32)
    from repro.kernels import epilogue as jepi
    if act == "SILU":
        with pytest.raises(TypeError):
            tepi.apply(_t(acc), shift=1, activation=Activation[act],
                       out_dtype=torch.int8)
        with pytest.raises(TypeError):
            tgemm.gemm(_t(acc.astype(np.int8)), _t(acc.astype(np.int8).T),
                       acc_dtype=torch.int32, out_dtype=torch.int8,
                       activation=Activation[act])
        with pytest.raises(TypeError):
            jepi.apply(jnp.asarray(acc), shift=1, activation=JActivation.SILU,
                       out_dtype=jnp.int8)
    else:
        want = jepi.apply(jnp.asarray(acc), shift=1,
                          activation=JActivation.GELU, out_dtype=jnp.int8)
        # rshift -> [-150, -2, 0, 2, 2, 350]; gelu in fp32; truncation
        np.testing.assert_array_equal(np.asarray(want),
                                      [[0, 0, 0, 1, 1, 127]])
        got = tepi.apply(_t(acc), shift=1, activation=Activation[act],
                         out_dtype=torch.int8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the int plain path: float64 products, wrapped to int32
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("m,k,n,lo,hi", [
    (33, 71, 29, -128, 128),
    (2, 160_000, 3, 120, 128),      # |sum| > 2^31: wraps
    (2, 160_000, 3, -128, -120),
])
def test_int_plain_matmul_equals_int64_form(m, k, n, lo, hi):
    rng = np.random.default_rng(k)
    a, b = _t(_i8(rng, (m, k), lo, hi)), _t(_i8(rng, (k, n), lo, hi))
    want = (a.to(torch.int64) @ b.to(torch.int64)).to(torch.int32)
    got = tref._int_matmul(a, b)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    if k > 2 ** 17:
        exact = a.to(torch.int64) @ b.to(torch.int64)
        assert (exact.abs() > 2 ** 31).all() and not torch.equal(
            exact, got.to(torch.int64))


# ---------------------------------------------------------------------------
# conv2d: host im2col and fused, against the JAX implicit-im2col kernel
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,pad,bias", [
    (2, 12, 12, 8, 16, 3, 3, 1, 1, True),
    (1, 16, 16, 4, 20, 1, 1, 1, 0, False),    # pointwise
    (1, 15, 15, 8, 8, 3, 3, 2, 1, True),      # strided
    (1, 11, 11, 8, 8, 3, 3, 2, 0, False),     # strided, no padding
    (1, 8, 8, 3, 32, 7, 7, 2, 3, True),       # stem-like, CI = 3
])
def test_conv2d_matches_jax_kernel(fused, n, h, w, ci, co, kh, kw, stride,
                                   pad, bias):
    rng = np.random.default_rng(h * co + kh)
    x = _i8(rng, (n, h, w, ci), -64, 64)
    wt = _i8(rng, (kh, kw, ci, co), -32, 32)
    b = rng.integers(-500, 500, (co,)).astype(np.int32) if bias else None
    want = jconv.conv2d_implicit(
        jnp.asarray(x), jnp.asarray(wt), None if b is None else jnp.asarray(b),
        cfg=JGemminiConfig(), stride=stride, padding=pad, shift=7,
        activation=JActivation.RELU, co_tile=8, interpret=True)
    got = ExecutionContext(cfg=GemminiConfig()).conv2d(
        _t(x), _t(wt), None if b is None else _t(b), stride=stride,
        padding=pad, shift=7, activation=Activation.RELU, fused=fused)
    _eq(got, want)


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("df", ["OS", "WS"])
def test_deep_narrow_conv_matches_jax_kernel(fused, df):
    """3x3 over 5x5x64 -> 16 (K = 576, the depth the card splits over its
    taps), padding on every border, through both conv routes and, on the
    host route, both dataflows."""
    rng = np.random.default_rng(576)
    x = _i8(rng, (1, 5, 5, 64))
    wt = _i8(rng, (3, 3, 64, 16))
    b = rng.integers(-2 ** 20, 2 ** 20, (16,)).astype(np.int32)
    want = jconv.conv2d_implicit(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b),
        cfg=JGemminiConfig(), stride=1, padding=1, shift=9,
        activation=JActivation.RELU, co_tile=8, interpret=True)
    got = ExecutionContext(cfg=GemminiConfig(dataflow=Dataflow.BOTH)).conv2d(
        _t(x), _t(wt), _t(b), stride=1, padding=1, shift=9,
        activation=Activation.RELU, fused=fused, dataflow=Dataflow[df])
    _eq(got, want)
    assert np.asarray(want).any()


@pytest.mark.parametrize("kh,stride,pad", [(3, 1, 1), (3, 2, 0), (7, 2, 3)])
def test_im2col_matches_jax(kh, stride, pad):
    rng = np.random.default_rng(kh)
    x = _i8(rng, (2, 13, 11, 5))
    _eq(tref.im2col(_t(x), kh, kh, stride, pad),
        jref.im2col(jnp.asarray(x), kh, kh, stride, pad))


# ---------------------------------------------------------------------------
# configs, plans, header, DSE
# ---------------------------------------------------------------------------
def _jcfg(cfg: GemminiConfig) -> JGemminiConfig:
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    kw["dataflow"] = JDataflow[cfg.dataflow.name]
    return JGemminiConfig(**kw)


def _plan_dict(plan) -> dict:
    d = dataclasses.asdict(plan)
    d["dataflow"] = plan.dataflow.value
    return d


def test_design_points_equal_jax():
    for name in ("DESIGN_POINTS", "PAPER_DESIGN_POINTS"):
        t, j = getattr(tconfig, name), getattr(jconfig, name)
        assert t.keys() == j.keys()
        for p in t:
            assert _jcfg(t[p]) == j[p], (name, p)
            assert t[p].describe() == j[p].describe()
            assert t[p].is_quantized == j[p].is_quantized
    assert tconfig.SYSTEM_LEVEL_POINTS == jconfig.SYSTEM_LEVEL_POINTS
    assert quickstart.QUICKSTART_CFG.input_torch == torch.int8


@pytest.mark.parametrize("df", [None, "OS", "WS"])
def test_header_and_plans_equal_jax(df):
    """The quickstart's header and the greedy / enumerated plans of its
    shape, on the quickstart config (BOTH: no dataflow resolves to WS)."""
    cfg = quickstart.QUICKSTART_CFG
    jcfg = _jcfg(cfg)
    tdf = None if df is None else Dataflow[df]
    jdf = None if df is None else JDataflow[df]
    assert elaborate(cfg).header(1000, 512, 2048, dataflow=tdf) == \
        jelaborate(jcfg).header(1000, 512, 2048, dataflow=jdf)
    for has_bias in (False, True):
        assert _plan_dict(ttiling.plan_gemm(cfg, 1000, 512, 2048, dataflow=tdf,
                                            has_bias=has_bias)) == \
            _plan_dict(jtiling.plan_gemm(jcfg, 1000, 512, 2048, dataflow=jdf,
                                         has_bias=has_bias))
    got = [_plan_dict(p) for p in ttiling.enumerate_plans(
        cfg, 200, 136, 260, dataflow=tdf)]
    want = [_plan_dict(p) for p in jtiling.enumerate_plans(
        jcfg, 200, 136, 260, dataflow=jdf)]
    assert got == want
    assert ttiling.padded_shape(cfg, 200, 136, 260) == \
        jtiling.padded_shape(jcfg, 200, 136, 260)


@pytest.mark.parametrize("wl", ["resnet50", "mobilenet", "mlp3"])
def test_dse_design_points_equal_jax(wl):
    """Table-1 points 1-10 at the paper's scale on a paper workload: the
    port's copied DSE gives the JAX package's numbers exactly."""
    tw = {**tdse.PAPER_DNNS, **tdse.PAPER_MLPS}[wl]
    jw = {**jdse.PAPER_DNNS, **jdse.PAPER_MLPS}[wl]
    got = [dataclasses.asdict(r) for r in tdse.run_design_points(tw)]
    want = [dataclasses.asdict(r) for r in jdse.run_design_points(jw)]
    assert got == want


def test_dse_evaluate_equals_jax_on_resnet50():
    cfg = quickstart.QUICKSTART_CFG
    got = tdse.evaluate(cfg, tdse.resnet(50), tdse.isa.ROCKET,
                        dataflow=Dataflow.OS)
    want = jdse.evaluate(_jcfg(cfg), jdse.resnet(50), jdse.isa.ROCKET,
                         dataflow=JDataflow.OS)
    assert got == want
    assert len(tdse.resnet(50).gemms) == 50


# ---------------------------------------------------------------------------
# quantization numerics
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shift", [0, 1, 4, 7, 31])
def test_rounding_shift_and_saturate_equal_jax(shift):
    rng = np.random.default_rng(shift)
    x = np.concatenate([
        rng.integers(-2 ** 31, 2 ** 31 - 1, 500),
        np.arange(-40, 40), [2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    _eq(tq.rounding_shift(_t(x), shift), jq.rounding_shift(jnp.asarray(x),
                                                           shift))
    _eq(tq.scale_and_saturate(_t(x), shift, torch.int8),
        jq.scale_and_saturate(jnp.asarray(x), shift, jnp.int8))


@pytest.mark.parametrize("scale", [0.0003, 0.37, 1.0, 5.5])
def test_fixed_point_rescale_equals_jax(scale):
    rng = np.random.default_rng(1)
    acc = rng.integers(-2 ** 24, 2 ** 24, 1000).astype(np.int32)
    mult, shift = tq.quantize_multiplier(scale)
    assert (mult, shift) == jq.quantize_multiplier(scale)
    np.testing.assert_array_equal(
        tq.fixed_point_rescale(_t(acc), mult, shift),
        jq.fixed_point_rescale(acc, mult, shift))


def test_quantize_calibrate_dequantize_equal_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((300, 70)).astype(np.float32)
    s_t = tq.calibrate_symmetric(_t(x))
    s_j = jq.calibrate_symmetric(jnp.asarray(x))
    assert s_t == s_j
    q_t = tq.quantize(_t(x), s_t)
    _eq(q_t, jq.quantize(jnp.asarray(x), s_j))
    _eq(tq.dequantize(q_t, s_t), jq.dequantize(jnp.asarray(q_t.numpy()), s_j))


def test_fake_quant_has_straight_through_gradient():
    rng = np.random.default_rng(3)
    x = _t(rng.standard_normal((5, 7)).astype(np.float32)).requires_grad_()
    y = tq.fake_quant(x, 0.05)
    want = jq.fake_quant(jnp.asarray(x.detach().numpy()), 0.05)
    _eq(y.detach(), want)
    g = _t(rng.standard_normal((5, 7)).astype(np.float32))
    y.backward(g)
    assert torch.equal(x.grad, g)
    jg = jax.grad(lambda v: jnp.sum(jq.fake_quant(v, 0.05) *
                                    jnp.asarray(g.numpy())))(
        jnp.asarray(x.detach().numpy()))
    _eq(x.grad, jg)


# ---------------------------------------------------------------------------
# dispatch and entry point
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("elab,asked", [("OS", "WS"), ("WS", "OS")])
def test_dataflow_mismatch_raises_like_jax(elab, asked):
    rng = np.random.default_rng(4)
    a, b = _i8(rng, (16, 32)), _i8(rng, (32, 8))
    with pytest.raises(ValueError, match="elaborated with"):
        JContext(cfg=JGemminiConfig(dataflow=JDataflow[elab]),
                 backend="interpret").gemm(jnp.asarray(a), jnp.asarray(b),
                                           dataflow=JDataflow[asked])
    inst = elaborate(GemminiConfig(dataflow=Dataflow[elab]))
    with pytest.raises(ValueError, match="elaborated with"):
        inst.gemm(_t(a), _t(b), dataflow=Dataflow[asked])
    x, w = _i8(rng, (1, 6, 6, 4)), _i8(rng, (3, 3, 4, 8))
    with pytest.raises(ValueError, match="elaborated with"):
        inst.conv2d(_t(x), _t(w), padding=1, dataflow=Dataflow[asked])
    inst.gemm(_t(a), _t(b), dataflow=Dataflow[elab])


def test_elaborate_checks_the_accumulator():
    with pytest.raises(ValueError, match="accumulator"):
        elaborate(GemminiConfig(accumulator_bytes=1024))
    with pytest.raises(ValueError, match="accumulator"):
        jelaborate(JGemminiConfig(accumulator_bytes=1024))
    assert elaborate(quickstart.QUICKSTART_CFG) is \
        elaborate(quickstart.QUICKSTART_CFG)


def test_quickstart_runs_on_cpu(capsys):
    assert quickstart.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "quickstart OK" in out
    assert "'TILE_M': 1024, 'TILE_N': 512, 'TILE_K': 2048" in out
