"""The port's kernel modules against the JAX package, on the CPU.

Each kernel wrapper of ``repro_torch.kernels`` takes its plain PyTorch
version for a CPU tensor; these tests hold that version against the JAX
package's Pallas kernel in interpret mode (the kernel body run on the CPU,
as the JAX package's own tests run it) and against its XLA twin. Inputs
come from ``np.random.default_rng`` and go to both sides.

Tolerances:
* fp32 GEMM: 1e-6 relative (plus 1e-6 of the output's largest magnitude
  for elements near zero): both sides sum the same products in another
  order.
* bf16 outputs: one bf16 ulp. Both sides round the same fp32 value, which
  can straddle a rounding boundary.
* fp32 attention: 1e-5. The interpret-mode kernels run the online softmax
  over other block sizes than the plain versions, so every row is
  rescaled by exp(m_old - m_new) a different number of times.
* int8 GEMM: bit-exact.

``test_torch_cuda`` holds the CUDA kernels against these plain versions on
a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.config import Activation as JActivation
from repro.core.config import Dataflow as JDataflow
from repro.core.config import GemminiConfig as JGemminiConfig
from repro.core.context import ExecutionContext as JContext
from repro.kernels import attention as jak
from repro.kernels import ref as jref
from repro.models import attention as jattn

from repro_torch.convert import tensor_from_numpy
from repro_torch.core.config import Activation, GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.kernels import attention as tak
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels import mamba2 as tm2

ATTN_TOL = 1e-5


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a, dtype=None):
    return tensor_from_numpy(np.asarray(a), "cpu", dtype)


def _assert_bf16_within_one_ulp(got, want):
    """|got - want| <= one bf16 ulp of want (2^(e - 7), e = exponent)."""
    g, w = _np(got), _np(want)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert np.all(np.abs(g - w) <= ulp), np.max(np.abs(g - w) / ulp)


def _assert_fp32_close(got, want, rtol=1e-6):
    w = _np(want)
    np.testing.assert_allclose(_np(got), w, rtol=rtol,
                               atol=rtol * np.abs(w).max())


# ---------------------------------------------------------------------------
# GEMM: gemm_ref and gemm_os (interpret)
# ---------------------------------------------------------------------------
_JDT = {"bf16": jnp.bfloat16, "fp32": jnp.float32}
_TDT = {"bf16": torch.bfloat16, "fp32": torch.float32}


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("in_dt,out_dt", [("bf16", "fp32"), ("bf16", "bf16"),
                                          ("fp32", "fp32")])
def test_gemm_matches_jax(in_dt, out_dt, bias):
    """Ragged (M, N, K) = (37, 70, 96): the port's gemm on a CPU tensor
    against the JAX gemm_ref and gemm_os (interpret, through the op layer's
    padding to the tile plan)."""
    rng = np.random.default_rng(0)
    m, n, k = 37, 70, 96
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = rng.standard_normal((k, n)).astype(np.float32)
    d = rng.standard_normal((1, n)).astype(np.float32) if bias else None
    jcfg = JGemminiConfig(dataflow=JDataflow.OS, input_dtype=in_dt,
                          acc_dtype="fp32", output_dtype=out_dt)
    ja, jb = jnp.asarray(a, _JDT[in_dt]), jnp.asarray(b, _JDT[in_dt])
    jd = None if d is None else jnp.asarray(d)
    want_ref = jref.gemm_ref(ja, jb, jd, acc_dtype=jnp.float32,
                             out_dtype=_JDT[out_dt])
    want_os = JContext(cfg=jcfg, backend="interpret").gemm(ja, jb, jd)
    ctx = ExecutionContext(cfg=GemminiConfig(input_dtype=in_dt,
                                             acc_dtype="fp32",
                                             output_dtype=out_dt))
    got = ctx.gemm(_t(a, _TDT[in_dt]), _t(b, _TDT[in_dt]),
                   None if d is None else _t(d))
    assert got.dtype == _TDT[out_dt] and tuple(got.shape) == (m, n)
    for want in (want_ref, want_os):
        if out_dt == "bf16":
            _assert_bf16_within_one_ulp(got, want)
        else:
            _assert_fp32_close(got, want)


def test_gemm_reads_transposed_b_view():
    """The tied unembedding hands the GEMM ``table.T``, a strided view;
    the result equals the product with a contiguous copy."""
    rng = np.random.default_rng(1)
    table = _t(rng.standard_normal((50, 24)).astype(np.float32))
    x = _t(rng.standard_normal((3, 24)).astype(np.float32))
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.float32)
    got = tgemm.gemm(x, table.T, **kw)
    want = tgemm.gemm(x, table.T.contiguous(), **kw)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("activation,shift", [
    ("NONE", 2), ("RELU", 0), ("RELU6", 0), ("GELU", 0), ("SILU", 1)])
def test_gemm_epilogue_matches_jax(activation, shift):
    """fp32 datapath with each activation unit and the power-of-two output
    shift (GELU is the tanh approximation, as jax.nn.gelu's default)."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((9, 40)).astype(np.float32)
    b = rng.standard_normal((40, 33)).astype(np.float32)
    d = rng.standard_normal((9, 33)).astype(np.float32)
    want = jref.gemm_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(d),
                         acc_dtype=jnp.float32, out_dtype=jnp.float32,
                         shift=shift, activation=JActivation[activation])
    got = tgemm.gemm(_t(a), _t(b), _t(d), acc_dtype=torch.float32,
                     out_dtype=torch.float32, shift=shift,
                     activation=Activation[activation])
    _assert_fp32_close(got, want)


def test_gemm_int8_datapath_bit_exact():
    """The plain version's integer datapath (int8 -> int32, rounding
    shift, ReLU, saturation to int8) equals the JAX oracle bit for bit."""
    rng = np.random.default_rng(3)
    a = rng.integers(-128, 128, (33, 71)).astype(np.int8)
    b = rng.integers(-128, 128, (71, 29)).astype(np.int8)
    d = rng.integers(-1000, 1000, (1, 29)).astype(np.int32)
    want = jref.gemm_ref(jnp.asarray(a), jnp.asarray(b), jnp.asarray(d),
                         acc_dtype=jnp.int32, out_dtype=jnp.int8, shift=8,
                         activation=JActivation.RELU)
    got = tgemm.gemm(_t(a), _t(b), _t(d), acc_dtype=torch.int32,
                     out_dtype=torch.int8, shift=8,
                     activation=Activation.RELU)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tq,tk,h,kvh,window,softcap", [
    (40, 40, 4, 4, None, None),      # causal, MHA
    (40, 40, 4, 1, 16, None),        # MQA, sliding window
    (40, 40, 4, 2, None, 30.0),      # GQA, softcap
    (24, 56, 4, 2, 8, 20.0),         # Tq < Tk right-aligned, all options
    (17, 70, 4, 2, 24, None),        # ragged tiles, a window inside a tile
])
def test_flash_attention_matches_jax(tq, tk, h, kvh, window, softcap):
    rng = np.random.default_rng(4)
    d = 16
    q = rng.standard_normal((2, tq, h, d)).astype(np.float32)
    k = rng.standard_normal((2, tk, kvh, d)).astype(np.float32)
    v = rng.standard_normal((2, tk, kvh, d)).astype(np.float32)
    kw = dict(causal=True, window=window, softcap=softcap)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want_kernel = jak.flash_attention(jq, jk, jv, block_q=16, block_k=16,
                                      interpret=True, **kw)
    want_xla = jattn.blockwise_attention_xla(jq, jk, jv, **kw)
    got = ExecutionContext().flash_attention(_t(q), _t(k), _t(v), **kw)
    for want in (want_kernel, want_xla):
        np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


def test_flash_attention_bf16_matches_xla_twin():
    """bf16 inputs and output: the plain version rounds where the XLA twin
    does (fp32 math, one cast at the end)."""
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 33, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 33, 1, 16)).astype(np.float32)
    v = rng.standard_normal((1, 33, 1, 16)).astype(np.float32)
    want = jattn.blockwise_attention_xla(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)), window=8)
    got = tak.flash_attention(*(_t(x, torch.bfloat16) for x in (q, k, v)),
                              window=8)
    assert got.dtype == torch.bfloat16
    _assert_bf16_within_one_ulp(got, want)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------
def _paged_case(rng, b, h, kvh, d, page, mp, n_pool, lens):
    """Pools with each slot's live tokens scattered over random pages;
    every page no slot owns is poisoned with NaN. Returns pools, tables."""
    pool_k = np.full((kvh, n_pool, page, d), np.nan, np.float32)
    pool_v = np.full((kvh, n_pool, page, d), np.nan, np.float32)
    tables = np.zeros((b, mp), np.int32)
    free = list(rng.permutation(n_pool))
    for bb in range(b):
        for j in range(-(-int(lens[bb]) // page)):
            pid = free.pop()
            tables[bb, j] = pid
            pool_k[:, pid] = rng.standard_normal((kvh, page, d))
            pool_v[:, pid] = rng.standard_normal((kvh, page, d))
    return pool_k, pool_v, tables


@pytest.mark.parametrize("h,kvh,window,softcap", [
    (4, 2, None, None), (4, 1, 24, None), (8, 8, None, 30.0)])
def test_paged_decode_matches_jax(h, kvh, window, softcap):
    """Slots with a partial page, a single token, a full table and an
    empty slot (len 0: a zero row, as the TPU kernel gives), over pools
    whose unowned pages hold NaN (never read)."""
    rng = np.random.default_rng(6)
    d, page, mp = 16, 16, 5
    lens = np.array([37, 1, 80, 0], np.int32)
    pk, pv, tables = _paged_case(rng, 4, h, kvh, d, page, mp, 24, lens)
    q = rng.standard_normal((4, 1, h, d)).astype(np.float32)
    kw = dict(window=window, softcap=softcap)
    want = jak.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv), jnp.asarray(tables),
        jnp.asarray(lens), interpret=True, **kw)
    got = ExecutionContext().paged_attention(_t(q), _t(pk), _t(pv),
                                             _t(tables), _t(lens), **kw)
    assert np.isfinite(_np(got)).all()
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)
    np.testing.assert_array_equal(_np(got)[3], 0.0)


def test_paged_decode_matches_xla_twin_on_live_slots():
    """On finite pools the plain version equals the JAX explicit-gather
    twin for every live slot."""
    rng = np.random.default_rng(7)
    h, kvh, d, page, mp = 4, 2, 16, 8, 4
    lens = np.array([19, 27, 8], np.int32)
    pk, pv, tables = _paged_case(rng, 3, h, kvh, d, page, mp, 16, lens)
    pk, pv = np.nan_to_num(pk), np.nan_to_num(pv)
    q = rng.standard_normal((3, 1, h, d)).astype(np.float32)
    cache = jattn.PagedKVCache(jnp.asarray(pk), jnp.asarray(pv),
                               jnp.asarray(tables), jnp.asarray(lens), page)
    want = jattn.paged_decode_attention_xla(jnp.asarray(q), cache, window=8)
    got = tak.paged_decode_attention(_t(q), _t(pk), _t(pv), _t(tables),
                                     _t(lens), window=8)
    np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL,
                               atol=ATTN_TOL)


# ---------------------------------------------------------------------------
# paged prefill attention
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("window,softcap", [(None, None), (8, 30.0)])
@pytest.mark.parametrize("start", [0, 8, 13])
def test_paged_prefill_matches_jax(start, window, softcap):
    """A 12-token chunk at [start, start + 12) of one request, its table
    cut to kv_pages = 5 by the op layer; pages outside the table hold
    NaN."""
    rng = np.random.default_rng(8 + start)
    h, kvh, d, page, t, kv_pages = 4, 2, 16, 8, 12, 5
    pk, pv, tables = _paged_case(rng, 1, h, kvh, d, page, 7, 20,
                                 np.array([start + t], np.int32))
    # the table's tail past the frontier points at owned, finite pages
    tables[0, -(-(start + t) // page):] = tables[0, 0]
    table = tables[0]
    q = rng.standard_normal((1, t, h, d)).astype(np.float32)
    kw = dict(window=window, softcap=softcap, kv_pages=kv_pages)
    jargs = (jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
             jnp.asarray(table), jnp.int32(start))
    want_kernel = JContext(backend="interpret").paged_prefill_attention(
        *jargs, **kw)
    want_xla = JContext(backend="xla").paged_prefill_attention(*jargs, **kw)
    got = ExecutionContext().paged_prefill_attention(
        _t(q), _t(pk), _t(pv), _t(table), start, **kw)
    for want in (want_kernel, want_xla):
        np.testing.assert_allclose(_np(got), _np(want), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)


# ---------------------------------------------------------------------------
# dispatch by device
# ---------------------------------------------------------------------------
def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor never reaches a kernel: the launch counts stay 0."""
    reset_launch_counts()
    x = torch.ones((2, 8))
    ExecutionContext(cfg=GemminiConfig(input_dtype="fp32", acc_dtype="fp32",
                                       output_dtype="fp32")).matmul(
        x, torch.ones((8, 4)))
    q = torch.ones((1, 4, 2, 16))
    tak.flash_attention(q, q, q)
    tak.decode_attention(q[:, :1], q, q, 2)
    x = torch.ones((1, 5, 2, 8))
    b = torch.ones((1, 5, 1, 8))
    tm2.ssd(x, torch.ones((1, 5, 2)), torch.zeros((2,)), b, b,
            initial_state=torch.zeros((1, 2, 8, 8)), return_final_state=True)
    counts = launch_counts()
    assert {"gemm", "flash_attention", "paged_prefill_attention",
            "paged_decode_attention", "ssd", "decode_attention"} <= \
        set(counts)
    assert set(counts.values()) == {0}


def test_unknown_device_raises_instead_of_falling_back():
    """A tensor on neither the CPU nor a CUDA card has no path."""
    x = torch.ones((2, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tgemm.gemm(x, x.T, acc_dtype=torch.float32, out_dtype=torch.float32)
    q = torch.ones((1, 4, 2, 16), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tak.flash_attention(q, q, q)
