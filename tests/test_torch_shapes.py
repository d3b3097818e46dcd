"""The port's attention and SSD wrappers at the shapes the JAX kernels take
beyond the compiled ones, on the CPU, against the JAX Pallas kernels in
interpret mode.

The CUDA kernels run these shapes on the card through the next compiled
instance (head dims), column slices and sub-chunks (the SSD) and the fp32
kernels on widened operands (mixed dtypes); ``test_torch_cuda`` holds them
against the plain versions there. Here the plain versions, which a CPU
tensor takes, are held to the JAX kernels:

* each attention launcher (flash, dense decode, paged decode, paged
  prefill) at head dims 8, 20, 48, 96, 200 and 320, in fp32 and bf16, and
  in both mixed orders (q bf16 with k / v fp32, q fp32 with k / v fp16),
  with a window and a softcap;
* the SSD at head dims 24 and 128, state sizes 200 and 256, a 512-token
  chunk over T = 600 (one whole chunk and a ragged one), in fp32 and bf16,
  and x fp32 with B / C bf16, x bf16 with B / C fp32; y and the final
  state.

Tolerances: an fp32 output within 1e-5 absolute for attention (the
interpret kernels run the online softmax over other blocks than the plain
versions) and within 1e-4 absolute for the SSD (y and the state of
O(1) inputs: the chunk's sums of 512 terms in another order); a 16-bit
output within one ulp of its dtype at the value, beyond that fp32
tolerance: both sides round fp32 values that differ by up to the fp32
tolerance, and a value near a rounding boundary (or near zero, where the
fp32 difference is many ulps of the value) rounds either way. Inputs come
from ``np.random.default_rng``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as jak
from repro.kernels import mamba2 as jm2

from repro_torch.kernels import attention as tak
from repro_torch.kernels import mamba2 as tm2

ATTN_TOL = 1e-5
SSD_TOL = 1e-4
HEAD_DIMS = (8, 20, 48, 96, 200, 320)
# (q dtype, k / v dtype)
ATTN_DTYPES = {"fp32": ("float32", "float32"),
               "bf16": ("bfloat16", "bfloat16"),
               "q_bf16_kv_fp32": ("bfloat16", "float32"),
               "q_fp32_kv_fp16": ("float32", "float16")}
KW = dict(window=16, softcap=30.0)


def _j(a, dtype):
    """Rounded from the fp32 array, as ``_t`` rounds (no double rounding
    on one side only)."""
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                 dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, dtype, tol):
    """fp32: within ``tol`` absolute; bf16 / fp16: within one ulp of the
    output dtype (2^(e - 7) or 2^(e - 10), e the exponent of the larger
    of the two values) plus ``tol``."""
    assert str(got.dtype).replace("torch.", "") == dtype
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        return
    bits = {"bfloat16": 7, "float16": 10}[dtype]
    big = np.maximum(np.maximum(np.abs(w), np.abs(g)), 1e-30)
    ulp = np.exp2(np.floor(np.log2(big)) - bits)
    assert np.all(np.abs(g - w) <= ulp + tol), \
        np.max(np.abs(g - w) - ulp)


def _pools(rng, kvh, n_pool, page, d, lens, mp):
    """Pools holding each slot's tokens on distinct random pages (every
    page finite); tables padded with the slot's first page."""
    pk = rng.standard_normal((kvh, n_pool, page, d)).astype(np.float32)
    pv = rng.standard_normal((kvh, n_pool, page, d)).astype(np.float32)
    tables = np.zeros((len(lens), mp), np.int32)
    free = list(rng.permutation(n_pool))
    for b, n in enumerate(lens):
        owned = [free.pop() for _ in range(max(1, -(-n // page)))]
        tables[b] = owned + [owned[0]] * (mp - len(owned))
    return pk, pv, tables


@pytest.mark.parametrize("mix", list(ATTN_DTYPES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_flash_attention_any_head_dim(d, mix):
    qd, kd = ATTN_DTYPES[mix]
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 24, 4, d))
    k = rng.standard_normal((1, 24, 2, d))
    v = rng.standard_normal((1, 24, 2, d))
    want = jak.flash_attention(_j(q, qd), _j(k, kd), _j(v, kd), causal=True,
                               block_q=16, block_k=16, interpret=True, **KW)
    got = tak.flash_attention(_t(q, qd), _t(k, kd), _t(v, kd), causal=True,
                              **KW)
    _assert_close(got, want, qd, ATTN_TOL)


@pytest.mark.parametrize("mix", list(ATTN_DTYPES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_decode_attention_any_head_dim(d, mix):
    qd, kd = ATTN_DTYPES[mix]
    rng = np.random.default_rng(100 + d)
    q = rng.standard_normal((2, 1, 4, d))
    k = rng.standard_normal((2, 40, 2, d))
    v = rng.standard_normal((2, 40, 2, d))
    want = jak.decode_attention(_j(q, qd), _j(k, kd), _j(v, kd),
                                jnp.int32(37), block_k=16, interpret=True,
                                **KW)
    got = tak.decode_attention(_t(q, qd), _t(k, kd), _t(v, kd), 37, **KW)
    _assert_close(got, want, qd, ATTN_TOL)


@pytest.mark.parametrize("mix", list(ATTN_DTYPES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_decode_attention_any_head_dim(d, mix):
    qd, kd = ATTN_DTYPES[mix]
    rng = np.random.default_rng(200 + d)
    lens = [37, 1, 20]
    pk, pv, tables = _pools(rng, 2, 16, 8, d, lens, 5)
    q = rng.standard_normal((3, 1, 4, d))
    ln = np.asarray(lens, np.int32)
    want = jak.paged_decode_attention(
        _j(q, qd), _j(pk, kd), _j(pv, kd), jnp.asarray(tables),
        jnp.asarray(ln), interpret=True, **KW)
    got = tak.paged_decode_attention(
        _t(q, qd), _t(pk, kd), _t(pv, kd), torch.from_numpy(tables),
        torch.from_numpy(ln), **KW)
    _assert_close(got, want, qd, ATTN_TOL)


@pytest.mark.parametrize("mix", list(ATTN_DTYPES))
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_paged_prefill_attention_any_head_dim(d, mix):
    qd, kd = ATTN_DTYPES[mix]
    rng = np.random.default_rng(300 + d)
    start, t = 13, 12
    pk, pv, tables = _pools(rng, 2, 12, 8, d, [start + t], 4)
    q = rng.standard_normal((1, t, 4, d))
    want = jak.paged_prefill_attention(
        _j(q, qd), _j(pk, kd), _j(pv, kd), jnp.asarray(tables[0]),
        jnp.int32(start), block_q=16, interpret=True, **KW)
    got = tak.paged_prefill_attention(
        _t(q, qd), _t(pk, kd), _t(pv, kd), torch.from_numpy(tables[0]),
        start, **KW)
    _assert_close(got, want, qd, ATTN_TOL)


# (x dtype, B / C dtype)
SSD_DTYPES = {"fp32": ("float32", "float32"),
              "bf16": ("bfloat16", "bfloat16"),
              "x_fp32_bc_bf16": ("float32", "bfloat16"),
              "x_bf16_bc_fp32": ("bfloat16", "float32")}


@pytest.mark.parametrize("mix", list(SSD_DTYPES))
@pytest.mark.parametrize("p,n", [(24, 200), (24, 256), (128, 200),
                                 (128, 256)])
def test_ssd_any_head_dim_state_and_chunk(p, n, mix):
    """Mixed orders at every (P, N) too: a 512-token chunk over T = 600,
    two heads of one B / C group."""
    xd, bd = SSD_DTYPES[mix]
    rng = np.random.default_rng(p + n)
    t, h, g = 600, 2, 1
    x = rng.standard_normal((1, t, h, p))
    b = 0.1 * rng.standard_normal((1, t, g, n))
    c = 0.1 * rng.standard_normal((1, t, g, n))
    dt = np.log1p(np.exp(rng.standard_normal((1, t, h)) - 2.0))
    a_log = np.log(np.linspace(1.0, 4.0, h))
    d_skip = np.ones((h,))
    want_y, want_s = jm2.ssd(
        _j(x, xd), _j(dt, "float32"), _j(a_log, "float32"), _j(b, bd),
        _j(c, bd), d_skip=_j(d_skip, "float32"), chunk=512, interpret=True,
        return_final_state=True)
    got_y, got_s = tm2.ssd(
        _t(x, xd), _t(dt, "float32"), _t(a_log, "float32"), _t(b, bd),
        _t(c, bd), d_skip=_t(d_skip, "float32"), chunk=512,
        return_final_state=True)
    _assert_close(got_y, want_y, xd, SSD_TOL)
    _assert_close(got_s, want_s, "float32", SSD_TOL)
