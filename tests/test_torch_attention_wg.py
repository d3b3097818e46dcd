"""The generic flash and paged prefill kernels' shapes on the CPU: head
dims past 512, the column-slice mechanism, and the geometry the contracts
mirror.

On the card a 16-bit head dim that is not compiled, or above 256, runs
``csrc/attention_wg.cuh`` (column slices of V and O above 256) and an
fp32 one above 128 runs column slices of the 128 instance;
``test_torch_cuda`` holds both against the plain versions there. Here:

* the plain versions a CPU tensor takes, held to the JAX Pallas kernels
  in interpret mode at head dims 640 and 1024, fp32 and bf16, with a
  window and a softcap (tolerances as ``test_torch_shapes``: fp32 within
  1e-5 absolute, bf16 one ulp of the value plus that);
* ``column_slice_attention_plain`` (scores over the whole head dim, P V a
  slice at a time) held to ``blockwise_attention`` at head dims 320 and
  640 (fp32 within 1e-5 absolute);
* the contracts' mirror of the kernels' plans: slices cover the head dim
  exactly once, the padded width is at most 1.25 d from d = 64, every
  plan fits 227 KB of shared memory and the SM's share, and the lint
  admits the plans it mirrors; the wrappers' routing by head dim, dtype
  and alignment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as jak

from repro_torch.analysis.lint import checks
from repro_torch.kernels import attention as tak
from repro_torch.kernels import contracts as kc
from repro_torch.models.attention import blockwise_attention

ATTN_TOL = 1e-5
KW = dict(window=16, softcap=30.0)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32), getattr(jnp, dtype))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(getattr(torch,
                                                                 dtype))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _assert_close(got, want, dtype, tol):
    """fp32: within ``tol`` absolute; bf16: within one bf16 ulp of the
    larger of the two values plus ``tol``."""
    assert str(got.dtype).replace("torch.", "") == dtype
    g, w = _np(got), _np(want)
    assert g.shape == w.shape and np.isfinite(g).all()
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=0, atol=tol)
        return
    big = np.maximum(np.maximum(np.abs(w), np.abs(g)), 1e-30)
    ulp = np.exp2(np.floor(np.log2(big)) - 7)
    assert np.all(np.abs(g - w) <= ulp + tol), np.max(np.abs(g - w) - ulp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [640, 1024])
def test_flash_attention_past_512(d, dtype):
    rng = np.random.default_rng(d)
    q = rng.standard_normal((1, 24, 4, d))
    k = rng.standard_normal((1, 24, 2, d))
    v = rng.standard_normal((1, 24, 2, d))
    want = jak.flash_attention(_j(q, dtype), _j(k, dtype), _j(v, dtype),
                               causal=True, block_q=16, block_k=16,
                               interpret=True, **KW)
    got = tak.flash_attention(_t(q, dtype), _t(k, dtype), _t(v, dtype),
                              causal=True, **KW)
    _assert_close(got, want, dtype, ATTN_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [640, 1024])
def test_paged_prefill_attention_past_512(d, dtype):
    rng = np.random.default_rng(300 + d)
    start, t, page = 13, 12, 8
    pk = rng.standard_normal((2, 12, page, d))
    pv = rng.standard_normal((2, 12, page, d))
    table = rng.permutation(12)[:4].astype(np.int32)
    q = rng.standard_normal((1, t, 4, d))
    want = jak.paged_prefill_attention(
        _j(q, dtype), _j(pk, dtype), _j(pv, dtype), jnp.asarray(table),
        jnp.int32(start), block_q=16, interpret=True, **KW)
    got = tak.paged_prefill_attention(
        _t(q, dtype), _t(pk, dtype), _t(pv, dtype), torch.from_numpy(table),
        start, **KW)
    _assert_close(got, want, dtype, ATTN_TOL)


@pytest.mark.parametrize("kw", [dict(window=None, softcap=None), KW])
@pytest.mark.parametrize("d", [320, 640])
def test_column_slices_match_blockwise(d, kw):
    rng = np.random.default_rng(d + 1)
    q, k, v = (_t(rng.standard_normal(s), "float32")
               for s in ((2, 20, 6, d), (2, 30, 2, d), (2, 30, 2, d)))
    want = blockwise_attention(q, k, v, causal=True, **kw)
    width = kc.wg_width(d)[0]
    assert width < d
    got = tak.column_slice_attention_plain(q, k, v, causal=True, **kw)
    _assert_close(got, want, "float32", ATTN_TOL)
    # the fp32 kernels' slices (128 columns) are the same function
    got = tak.column_slice_attention_plain(q, k, v, causal=True,
                                           width=kc.F32_SLICE, **kw)
    _assert_close(got, want, "float32", ATTN_TOL)


def test_wg_slices_cover_the_head_dim_once():
    """Every head dim the 16-bit kernel takes: its slices hold d (the last
    one live), the padded width is at most 1.25 d from d = 64, and each
    slice is at most 256 columns of an instance width."""
    for d in range(1, kc.WG_HEAD_DIM_MAX + 1):
        dv, slices = kc.wg_width(d)
        assert dv in kc.WG_WIDTHS and dv <= kc.WG_SLICE
        assert (slices - 1) * dv < d <= slices * dv, d
        if d >= 64:
            assert slices * dv <= 1.25 * d, (d, dv, slices)


def test_f32_slices_cover_the_head_dim_once():
    for d in range(1, kc.F32_HEAD_DIM_MAX + 1):
        dc, slices = kc.f32_flash_dim(d)
        assert dc in kc.HEAD_DIMS
        assert (slices - 1) * dc < d <= slices * dc, d
        assert (slices > 1) == (d > kc.F32_SLICE_FROM)


@pytest.mark.parametrize("align", [16, 8, 4, 2])
def test_wg_plans_fit_shared_memory(align):
    """The mirror of attention_wg.cuh's plan at every head dim (by 8) and
    page size: shared memory within 227 KB, the blocks an SM within 228
    KB; the partial (m, l, O) fits over Q and the rings; one past the
    widest head dim refused."""
    for d in list(range(8, kc.WG_HEAD_DIM_MAX + 1, 8)) + [1, 20, 200]:
        for page in (0, 8, 16, 24, 64, 128):
            p = kc.wg_plan(1, 256, 256 + 768 * bool(page), 32, 8, d,
                           768 * bool(page), 1, 0, page, align, kc.SMS)
            assert "refused" not in p, (d, page)
            assert p["smem"] <= kc.WG_SMEM_ONE
            per_sm = p["blocks_sm"] * (p["smem"] + kc.SMEM_RESERVED + 512)
            assert per_sm <= kc.SMEM_PER_SM, (d, page)
            part = (2 * kc.WG_ROWS + kc.WG_ROWS * (p["width"] + 8)) * 4
            assert part <= p["smem"] - 1024
            assert 1 <= p["kring"] <= kc.WG_KS_MAX
            load = p["load"]
            if align < 16:
                assert load == (kc.LOAD_CP4 if align >= 4 else kc.LOAD_ELEM)
            elif page in (0, 8, 16, 64, 128):
                assert load == kc.LOAD_TMA
            else:
                assert load == kc.LOAD_CP16
    p = kc.wg_plan(1, 256, 256, 32, 8, kc.WG_HEAD_DIM_MAX + 1, 0, 1, 0, 0,
                   16, kc.SMS)
    assert p == {"refused": "shared memory"}


@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("d", [20, 48, 80, 96, 200, 320, 640, 1024])
def test_lint_admits_the_generic_plans(d, dtype):
    """The contracts of the generic calls at the shapes the card runs
    them: a 256-token causal chunk with 32 / 8 heads, flash (every
    schedule of the tuner's space) and paged prefill at 768, aligned and
    not; every one admitted, its blocks the grid's."""
    from repro_torch.tune import schedules
    for align in (16, 2):
        for sched in schedules.enumerate_attn_schedules(getattr(torch,
                                                                dtype), d):
            c = kc.flash_contract(1, 256, 256, 32, 8, d, dtype=dtype,
                                  align=align, **sched)
            assert checks.admits(c), (d, align, sched,
                                      checks.check_contract(c))
            p = c.plan_dict()
            assert c.blocks == p["grid_x"] * p["grid_y"] * p["grid_z"]
        c = kc.paged_prefill_contract(256, 768, 32, 8, d, dtype=dtype,
                                      align=align, page=64)
        assert checks.admits(c), (d, checks.check_contract(c))


def test_routing_by_head_dim_dtype_and_alignment():
    def t(dtype, d, off=0):
        buf = torch.zeros(4 * d + off, dtype=dtype)
        return buf[off:].view(1, 4, 1, d)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    assert tak.kernel_lib(128, t(bf16, 128), t(bf16, 128)) == "attention"
    assert tak.kernel_lib(80, t(bf16, 80)) == "attention_wg"
    assert tak.kernel_lib(80, t(f16, 80)) == "attention_wg16"
    assert tak.kernel_lib(80, t(f32, 80)) == "attention_any"
    assert tak.kernel_lib(128, t(bf16, 128, 2)) == "attention_wg"
    assert tak.kernel_lib(640, t(bf16, 640)) == "attention_wg"
    assert tak.kernel_lib(80, t(bf16, 80), decode=True) == \
        "attention_decode_any"
    x = t(bf16, 640)
    assert tak.kernel_dtype(x, x, x, 640) == bf16
    assert tak.kernel_dtype(x, x, x, 640, decode=True) == f32
    assert tak.kernel_dtype(x, t(f32, 640), x, 640) == f32
