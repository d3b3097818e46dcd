"""The port's engine on every datapath of the dtype table beyond int8 ->
int32 -> int8, against the JAX package, on the CPU.

Datapaths (input -> accumulator -> output): fp32 -> fp32 -> fp32 (Table
1's design point 4), bf16 -> fp32 -> bf16, fp16 -> fp32 -> fp16, int16 ->
int32 -> int16, int16 -> int32 -> int32 and int8 -> int32 -> int16. The
same numpy-seeded inputs go to the JAX kernels in interpret mode (the
GEMM on both dataflows through ``ExecutionContext(backend="interpret")``,
``conv2d_implicit`` and ``accumulator_epilogue`` with ``interpret=True``)
and to the port's ``ctx.gemm`` (OS and WS) and ``ctx.conv2d`` (host
im2col and fused routes), which on the CPU run the plain versions the
CUDA kernels are held against on the card.

Tolerances: integers bit-exact. fp32: 1e-5 relative plus 1e-6 of the
largest magnitude (the two sides sum in other orders). bf16 / fp16: one
ulp of the output type (2^-7 / 2^-10 relative) plus 2^-14 of the largest
magnitude, since a sum near a rounding boundary may round either way;
infinities (an fp16 overflow) must sit in the same places with the same
sign.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import Activation as JActivation
from repro.core.config import Dataflow as JDataflow
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.core import tiling as jtiling
from repro.core.context import ExecutionContext as JContext
from repro.kernels import conv as jconv
from repro.kernels import gemm as jgemm

from repro_torch.core.config import Activation, Dataflow, GemminiConfig
from repro_torch.core.config import dtype_of
from repro_torch.core.context import ExecutionContext
from repro_torch.kernels import gemm as tgemm

# (input, accumulator, output)
DATAPATHS = [("fp32", "fp32", "fp32"), ("bf16", "fp32", "bf16"),
             ("fp16", "fp32", "fp16"), ("int16", "int32", "int16"),
             ("int16", "int32", "int32"), ("int8", "int32", "int16")]
_ULP = {"fp32": None, "bf16": 2.0 ** -7, "fp16": 2.0 ** -10}
_NP = {"fp32": np.float32, "bf16": jnp.bfloat16, "fp16": np.float16,
       "int8": np.int8, "int16": np.int16, "int32": np.int32}


def _t(a) -> torch.Tensor:
    """A numpy array (bf16 through fp32, exactly) as a torch tensor."""
    a = np.asarray(a)
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x: torch.Tensor) -> np.ndarray:
    return x.float().numpy() if x.is_floating_point() else x.numpy()


def _cfgs(dp, dataflow="BOTH"):
    i, a, o = dp
    return (JGemminiConfig(dataflow=JDataflow[dataflow], input_dtype=i,
                           acc_dtype=a, output_dtype=o),
            GemminiConfig(dataflow=Dataflow[dataflow], input_dtype=i,
                          acc_dtype=a, output_dtype=o))


def _check(got: torch.Tensor, want, out: str) -> None:
    """``got`` (the port) against ``want`` (JAX) at ``out``'s rule."""
    w = np.asarray(want)
    assert got.dtype == dtype_of(out), (got.dtype, out)
    assert got.shape == w.shape, (got.shape, w.shape)
    if out.startswith("int"):
        assert w.dtype == _NP[out]
        np.testing.assert_array_equal(got.numpy(), w)
        return
    g, w = _np(got), w.astype(np.float32)
    inf = np.isinf(w)
    np.testing.assert_array_equal(np.isinf(g), inf)
    np.testing.assert_array_equal(g[inf], w[inf])
    assert np.isfinite(g[~inf]).all()
    scale = np.abs(w[~inf]).max() if (~inf).any() else 0.0
    rtol, atol = (1e-5, 1e-6 * scale) if _ULP[out] is None \
        else (_ULP[out], 2.0 ** -14 * scale)
    np.testing.assert_allclose(g[~inf], w[~inf], rtol=rtol, atol=atol)


def _operands(rng, dp, shape_a, shape_b, n):
    """A, B and a bias for datapath dp: floats x ~ N(0, 1), w ~ N(0, 1) /
    sqrt(K), a N(0, 1) bias; int16 x in [-2^14, 2^14), w in [-2^8, 2^8)
    and an int32 bias (shift 10 keeps outputs inside int16, most of them);
    int8 x, w in [-128, 128) and a bias within 2^20."""
    i = dp[0]
    k = int(np.prod(shape_b[:-1]))
    if i.startswith("int"):
        lo_a, lo_b, lo_d = {"int16": (2 ** 14, 2 ** 8, 2 ** 24),
                            "int8": (128, 128, 2 ** 20)}[i]
        a = rng.integers(-lo_a, lo_a, shape_a).astype(_NP[i])
        b = rng.integers(-lo_b, lo_b, shape_b).astype(_NP[i])
        d = rng.integers(-lo_d, lo_d, (n,)).astype(np.int32)
        return a, b, d, 10 if i == "int16" else 7
    a = rng.standard_normal(shape_a).astype(np.float32).astype(_NP[i])
    b = (rng.standard_normal(shape_b) / np.sqrt(k)).astype(np.float32) \
        .astype(_NP[i])
    d = rng.standard_normal((n,)).astype(np.float32)
    return a, b, d, 1


# ---------------------------------------------------------------------------
# GEMM on both dataflows
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("df", ["OS", "WS"])
@pytest.mark.parametrize("m,n,k", [(128, 128, 128), (200, 136, 260)])
@pytest.mark.parametrize("dp", DATAPATHS, ids="-".join)
def test_gemm_datapaths_match_jax_kernels(dp, m, n, k, df):
    """ctx.gemm on a BOTH instance of the datapath, each dataflow, bias,
    shift and ReLU, against the JAX gemm_os / gemm_ws kernels in
    interpret mode (through the op layer's padding to the tile plan)."""
    rng = np.random.default_rng(m + n + k + len(df))
    a, b, d, shift = _operands(rng, dp, (m, k), (k, n), n)
    jcfg, cfg = _cfgs(dp)
    want = JContext(cfg=jcfg, backend="interpret").gemm(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(d)[None, :],
        dataflow=JDataflow[df], shift=shift, activation=JActivation.RELU)
    got = ExecutionContext(cfg=cfg).gemm(
        _t(a), _t(b), _t(d)[None, :], dataflow=Dataflow[df], shift=shift,
        activation=Activation.RELU)
    _check(got, want, dp[2])
    assert np.asarray(want).astype(np.float64).any()


@pytest.mark.parametrize("df", ["OS", "WS"])
def test_fp16_gemm_plain_matches_jax_at_quickstart(df):
    """The plain version the card's fp16 wide GEMM is held against (the
    port's ctx.gemm on the CPU), at the quickstart GEMM (1000 x 512 x 2048;
    a bias row, shift 1, ReLU), against the JAX GEMM on its XLA twin, each
    dataflow: the fp16 rule."""
    rng = np.random.default_rng(1000)
    dp = ("fp16", "fp32", "fp16")
    a, b, d, shift = _operands(rng, dp, (1000, 2048), (2048, 512), 512)
    jcfg, cfg = _cfgs(dp)
    want = JContext(cfg=jcfg, backend="xla_twin").gemm(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(d)[None, :],
        dataflow=JDataflow[df], shift=shift, activation=JActivation.RELU)
    got = ExecutionContext(cfg=cfg).gemm(
        _t(a), _t(b), _t(d)[None, :], dataflow=Dataflow[df], shift=shift,
        activation=Activation.RELU)
    _check(got, want, "fp16")
    assert shift == 1 and np.asarray(want).astype(np.float32).any()


@pytest.mark.parametrize("df", ["OS", "WS"])
def test_int16_gemm_wraps_and_saturates_like_jax(df):
    """int16 operands near 2^15 over K = 64: every true sum passes 2^31, so
    the int32 accumulator wraps, in the JAX kernels and in the port; after
    shift 4 the int16 output saturates at both ends, and some outputs are
    negative where the true sum is positive (the wrap shows)."""
    rng = np.random.default_rng(64)
    m, n, k = 24, 40, 64
    a = rng.integers(2 ** 14, 2 ** 15, (m, k)).astype(np.int16)
    b = rng.integers(2 ** 14, 2 ** 15, (k, n)).astype(np.int16)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert (exact > 2 ** 31).all()
    jcfg, cfg = _cfgs(("int16", "int32", "int16"))
    want = JContext(cfg=jcfg, backend="interpret").gemm(
        jnp.asarray(a), jnp.asarray(b), None, dataflow=JDataflow[df],
        shift=4, activation=JActivation.NONE)
    got = ExecutionContext(cfg=cfg).gemm(_t(a), _t(b), dataflow=Dataflow[df],
                                         shift=4, activation=Activation.NONE)
    _check(got, want, "int16")
    w = np.asarray(want)
    assert (w == 32767).any() and (w == -32768).any()
    assert (w < 0).any()                   # true sums are all positive


def _byte_plane_gemm(a: torch.Tensor, b: torch.Tensor, d: torch.Tensor,
                     **kw) -> torch.Tensor:
    """The card's int16 GEMM as ``csrc/igemm.cuh`` computes it: each
    operand split into a signed high byte (a >> 8) and an unsigned low byte
    (a & 0xff); the four int8 products A_h B_h, A_h B_l, A_l B_h and A_l
    B_l, each over k in the kernel's order (in every 32-k MMA step, lane
    quad t holds k {2t, 2t + 1, 2t + 8, 2t + 9} of each 16-k half where the
    MMA takes k 4t..4t + 3: one permutation for both operands), summed
    into three int32 accumulators (the bias in A_l B_l's) and combined as
    2^16 hh + 2^8 mid + ll, every add wrapping modulo 2^32; then the
    epilogue."""
    from repro_torch.kernels import epilogue as tepi

    k = a.shape[1]
    step = torch.tensor([16 * h + 2 * t + e for h in (0, 1) for t in range(4)
                         for e in (0, 1, 8, 9)])
    steps = -(-k // 32)
    order = (torch.arange(steps)[:, None] * 32 + step[None, :]).flatten()
    order = order[order < k]
    assert sorted(order.tolist()) == list(range(k))
    a, b = a.long()[:, order], b.long()[order]
    ah, al, bh, bl = a >> 8, a & 0xFF, b >> 8, b & 0xFF
    assert ah.min() >= -128 and ah.max() <= 127 and al.max() <= 255

    def wrap(x):                        # an int32 register, modulo 2^32
        return ((x + 2 ** 31) % 2 ** 32) - 2 ** 31

    hh = wrap(ah @ bh)
    mid = wrap(wrap(ah @ bl) + wrap(al @ bh))
    ll = wrap(wrap(al @ bl) + d.long()[None, :])
    acc = wrap(wrap(ll + wrap(mid * 2 ** 8)) + wrap(hh * 2 ** 16))
    return tepi.apply(acc.to(torch.int32), **kw)


@pytest.mark.parametrize("out,shift,act", [("int16", 9, "RELU"),
                                           ("int32", 0, "NONE")])
@pytest.mark.parametrize("k", [64, 4608])
def test_int16_byte_planes_match_jax_kernel(k, out, shift, act):
    """The identity the card's int16 GEMM rests on: four int8 products of
    byte planes (high bytes signed, low bytes unsigned) combined with
    shifts in wrapping int32, k permuted within each MMA step as the
    kernel's fragments take it, equal bit for bit to the JAX gemm_os int16
    kernel in interpret mode, on full-range operands with a row of all
    -32768 and one of all 32767 on each side, at K = 64 and 4608 (the true
    sums pass 2^31)."""
    rng = np.random.default_rng(k + shift)
    m, n = 8, 24
    a = rng.integers(-2 ** 15, 2 ** 15, (m, k)).astype(np.int16)
    b = rng.integers(-2 ** 15, 2 ** 15, (k, n)).astype(np.int16)
    a[0], a[1], b[:, 0], b[:, 1] = -2 ** 15, 2 ** 15 - 1, -2 ** 15, 2 ** 15 - 1
    d = rng.integers(-2 ** 31, 2 ** 31, (n,)).astype(np.int32)
    exact = a.astype(np.int64) @ b.astype(np.int64)
    assert (np.abs(exact[:2, :2]) > 2 ** 31).all()
    jcfg, _ = _cfgs(("int16", "int32", out))
    want = JContext(cfg=jcfg, backend="interpret").gemm(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(d)[None, :],
        dataflow=JDataflow.OS, shift=shift, activation=JActivation[act])
    got = _byte_plane_gemm(_t(a), _t(b), _t(d), shift=shift,
                           activation=Activation[act], out_dtype=dtype_of(out))
    _check(got, want, out)
    assert np.asarray(want).astype(np.int64).any()


@pytest.mark.parametrize("df", ["OS", "WS"])
def test_fp16_gemm_overflows_to_inf_like_jax(df):
    """fp16 outputs past 65504 are +-inf on both sides (JAX's astype does
    not saturate), the rest within the fp16 rule."""
    rng = np.random.default_rng(16)
    m, n, k = 32, 48, 64
    a = (rng.standard_normal((m, k)) * 100).astype(np.float16)
    b = (rng.standard_normal((k, n)) * 100).astype(np.float16)
    jcfg, cfg = _cfgs(("fp16", "fp32", "fp16"))
    want = JContext(cfg=jcfg, backend="interpret").gemm(
        jnp.asarray(a), jnp.asarray(b), None, dataflow=JDataflow[df],
        shift=0, activation=JActivation.NONE)
    got = ExecutionContext(cfg=cfg).gemm(_t(a), _t(b), dataflow=Dataflow[df])
    _check(got, want, "fp16")
    w = np.asarray(want).astype(np.float32)
    assert (w == np.inf).any() and (w == -np.inf).any()
    assert np.isfinite(w).any()


# ---------------------------------------------------------------------------
# the mvout epilogue
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("acc,out,act,shift", [
    ("int32", "int16", "RELU", 9), ("int32", "int16", "NONE", 0),
    ("fp32", "fp16", "RELU", 2), ("fp32", "fp16", "NONE", 0)])
def test_accumulator_epilogue_new_outputs_match_jax(acc, out, act, shift):
    """The mvout pass to int16 (full int32 range: the shift rounds and the
    output saturates) and to fp16 (magnitudes up to 2^17: values past
    65504 round to +-inf)."""
    rng = np.random.default_rng(shift + len(out))
    if acc == "int32":
        a = rng.integers(-2 ** 31, 2 ** 31 - 1, (256, 256)).astype(np.int32)
    else:
        a = (rng.standard_normal((128, 256)) * 2.0 **
             rng.integers(0, 18, (128, 256))).astype(np.float32)
    jcfg = JGemminiConfig(input_dtype="int8" if acc == "int32" else "fp16",
                          acc_dtype=acc, output_dtype=out)
    plan = jtiling.make_plan(jcfg, a.shape[0], 256, 128, 128, 128, 128)
    want = jgemm.accumulator_epilogue(jnp.asarray(a), plan, jcfg, shift=shift,
                                      activation=JActivation[act],
                                      interpret=True)
    got = tgemm.accumulator_epilogue(_t(a), out_dtype=dtype_of(out),
                                     shift=shift, activation=Activation[act])
    _check(got, want, out)
    w = np.asarray(want).astype(np.float64)
    assert (np.isinf(w).any() if out == "fp16" and shift == 0
            else np.abs(w).max() >= (32767 if out == "int16" else 1))


# ---------------------------------------------------------------------------
# conv2d: host im2col and fused
# ---------------------------------------------------------------------------
CONV_SHAPES = [
    (2, 12, 12, 8, 16, 3, 3, 1, 1, True),
    (1, 16, 16, 4, 20, 1, 1, 1, 0, False),    # pointwise
    (1, 15, 15, 8, 8, 3, 3, 2, 1, True),      # strided
    (1, 11, 11, 8, 8, 3, 3, 2, 0, False),     # strided, no padding
    (1, 8, 8, 3, 32, 7, 7, 2, 3, True),       # stem-like, CI = 3
]
_JAX_CONV = {}


def _conv_case(dp, shape):
    """The operands of one (datapath, shape) case and the JAX kernel's
    output (computed once for both routes)."""
    key = (dp, shape)
    if key not in _JAX_CONV:
        n, h, w, ci, co, kh, kw, stride, pad, bias = shape
        rng = np.random.default_rng(h * co + kh + len(dp[0]))
        x, wt, b, shift = _operands(rng, dp, (n, h, w, ci), (kh, kw, ci, co),
                                    co)
        b = b if bias else None
        jcfg, _ = _cfgs(dp)
        want = jconv.conv2d_implicit(
            jnp.asarray(x), jnp.asarray(wt),
            None if b is None else jnp.asarray(b), cfg=jcfg, stride=stride,
            padding=pad, shift=shift, activation=JActivation.RELU, co_tile=8,
            interpret=True)
        _JAX_CONV[key] = (x, wt, b, shift, np.asarray(want))
    return _JAX_CONV[key]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shape", CONV_SHAPES,
                         ids=["3x3", "pointwise", "strided", "strided-nopad",
                              "stem"])
@pytest.mark.parametrize("dp", DATAPATHS, ids="-".join)
def test_conv2d_datapaths_match_jax_kernel(dp, shape, fused):
    """ctx.conv2d on each datapath, host im2col and fused routes, against
    the JAX implicit-im2col kernel in interpret mode."""
    n, h, w, ci, co, kh, kw, stride, pad, bias = shape
    x, wt, b, shift, want = _conv_case(dp, shape)
    _, cfg = _cfgs(dp)
    got = ExecutionContext(cfg=cfg).conv2d(
        _t(x), _t(wt), None if b is None else _t(b), stride=stride,
        padding=pad, shift=shift, activation=Activation.RELU, fused=fused)
    _check(got, want, dp[2])


@pytest.mark.parametrize("fused", [False, True])
def test_int16_conv_wraps_and_saturates_like_jax(fused):
    """A 3x3 int16 conv whose every true sum passes 2^31 (144 taps x
    channels of products near 2^29): the int32 accumulator wraps and the
    int16 output saturates, identically on both sides."""
    rng = np.random.default_rng(3)
    x = rng.integers(2 ** 14, 2 ** 15, (1, 6, 6, 16)).astype(np.int16)
    wt = rng.integers(2 ** 14, 2 ** 15, (3, 3, 16, 8)).astype(np.int16)
    patches = np.lib.stride_tricks.sliding_window_view(
        x[0].astype(np.int64), (3, 3), axis=(0, 1))      # (4, 4, 16, 3, 3)
    exact = np.einsum("hwcij,ijco->hwo", patches, wt.astype(np.int64))
    assert (exact > 2 ** 31).all()
    jcfg, cfg = _cfgs(("int16", "int32", "int16"))
    want = jconv.conv2d_implicit(jnp.asarray(x), jnp.asarray(wt), None,
                                 cfg=jcfg, shift=6, co_tile=8, interpret=True)
    got = ExecutionContext(cfg=cfg).conv2d(_t(x), _t(wt), shift=6,
                                           fused=fused)
    _check(got, want, "int16")
    w = np.asarray(want)
    assert (w == 32767).any() and (w == -32768).any() and (w < 0).any()


@pytest.mark.parametrize("fused", [False, True])
def test_fp16_conv_overflows_to_inf_like_jax(fused):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((1, 7, 7, 16)) * 80).astype(np.float16)
    wt = (rng.standard_normal((3, 3, 16, 8)) * 80).astype(np.float16)
    jcfg, cfg = _cfgs(("fp16", "fp32", "fp16"))
    want = jconv.conv2d_implicit(jnp.asarray(x), jnp.asarray(wt), None,
                                 cfg=jcfg, padding=1, co_tile=8,
                                 interpret=True)
    got = ExecutionContext(cfg=cfg).conv2d(_t(x), _t(wt), padding=1,
                                           fused=fused)
    _check(got, want, "fp16")
    w = np.asarray(want).astype(np.float32)
    assert (w == np.inf).any() and (w == -np.inf).any()


@pytest.mark.parametrize("n,h", [(2, 13), (1, 21)], ids=["b2-13", "b1-21"])
@pytest.mark.parametrize("dp", [("fp32", "fp32", "fp32"),
                                ("fp16", "fp32", "fp16")], ids="-".join)
def test_conv2d_ref_matches_jax_at_stem_geometry(dp, n, h):
    """The plain version the card's stem loader is held against
    (``conv2d_ref``: CI = 3, 7x7, stride 2, padding 3, so every output
    row starts in the padding), against the JAX kernel in interpret mode,
    at images whose output rows are not a multiple of any tile."""
    from repro_torch.kernels.ref import conv2d_ref

    rng = np.random.default_rng(h + n)
    x, wt, b, shift = _operands(rng, dp, (n, h, h, 3), (7, 7, 3, 24), 24)
    jcfg, _ = _cfgs(dp)
    want = jconv.conv2d_implicit(
        jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b), cfg=jcfg, stride=2,
        padding=3, shift=shift, activation=JActivation.RELU, co_tile=8,
        interpret=True)
    got = conv2d_ref(_t(x), _t(wt), _t(b), stride=2, padding=3,
                     acc_dtype=torch.float32, out_dtype=dtype_of(dp[2]),
                     shift=shift, activation=Activation.RELU)
    _check(got, want, dp[2])
