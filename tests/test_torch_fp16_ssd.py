"""The fp16 SSD's exact split, its dispatch, and its plain version against
the JAX package on the model's views, on the CPU.

On the card an all-fp16 ``ssd`` call runs the tensor-core kernel
(``csrc/ssd16.cu`` / ``ssd16_any.cu``) on the fp16 operands as they are:
each fp16 operand fragment of a bf16 MMA is split into two bf16 terms,
``kernels.mamba2.split_f16`` in plain torch. These tests hold that split
to exactness on every finite fp16 value, the dispatch to its kernel and
library, and ``ssd`` on fp16 views into a fused projection (what the model
hands the kernel) to the JAX package's SSD run as its own tests run it on
the CPU (``ops.ssd_impl`` at the ``interpret`` backend: the Pallas kernel
in interpret mode for a fresh call, the XLA route where a state is carried
in).

Tolerances: y (fp16) one fp16 ulp, 2^-10 relative, plus 2^-10 of the
largest magnitude (both sides sum in fp32 in other orders, then round
once); the final state (fp32) 1e-5 of the largest magnitude (the same
sums, other orders).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import mamba2 as tm2

F16_TOL = 2.0 ** -10
STATE_TOL = 1e-5


def _finite_f16() -> torch.Tensor:
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(
        torch.int16)
    v = bits.view(torch.float16)
    return v[torch.isfinite(v)]


def test_every_finite_fp16_splits_exactly_into_two_bf16_terms():
    """All 63488 finite fp16 bit patterns (subnormals, both zeros and
    65504 included): hi + lo is the value exactly in fp32, lo is the exact
    remainder (no rounding in its bf16), hi is the value's nearest bf16
    and stays finite (65504 rounds to 65536), and lo is at most four of
    the value's fp16 ulps."""
    v = _finite_f16()
    assert v.numel() == 63488
    hi, lo = tm2.split_f16(v)
    assert hi.dtype == lo.dtype == torch.bfloat16
    f = v.float()
    assert torch.equal(hi.float() + lo.float(), f)
    assert torch.equal(lo.float(), f - hi.float())
    assert torch.equal(hi, f.to(torch.bfloat16))
    assert torch.isfinite(hi).all() and torch.isfinite(lo).all()
    # fp16's ulp at each value: 2^(exponent - 10), 2^-24 below 2^-14
    ulp = torch.exp2(torch.floor(torch.log2(f.abs().clamp(min=2.0 ** -14)))
                     - 10)
    assert (lo.float().abs() <= 4 * ulp).all()
    assert hi[v == 65504].float().item() == 65536.0
    assert lo[v == 65504].float().item() == -32.0


def test_kernel_dtype_and_library_of_an_fp16_call():
    """An all-fp16 call runs the fp16 kernel (its own libraries); a mixed
    one the fp32 kernel on widened operands."""
    f16, bf16, f32 = torch.float16, torch.bfloat16, torch.float32

    def t(dtype):
        return torch.zeros((1, 4, 2, 8), dtype=dtype)
    assert tm2.kernel_dtype(t(f16), t(f16), t(f16)) == f16
    assert tm2.kernel_dtype(t(f16), t(bf16), t(bf16)) == f32
    assert tm2.kernel_dtype(t(bf16), t(f16), t(f16)) == f32
    assert tm2.kernel_dtype(t(bf16), t(bf16), t(bf16)) == bf16
    assert tm2.kernel_dtype(t(f32), t(f32), t(f32)) == f32
    assert tm2.kernel_lib(64, 128, f16) == "ssd16"
    assert tm2.kernel_lib(96, 128, f16) == "ssd16_any"
    assert tm2.kernel_lib(64, 256, f16) == "ssd16_any"
    assert tm2.kernel_lib(64, 128, bf16) == "ssd"
    assert tm2.kernel_lib(64, 128) == "ssd"
    assert tm2.kernel_lib(10, 64, f32) == "ssd_any"


def _projection(seed, bsz, t, h, p, g, n):
    """A fused fp16 projection laid out as the model's (z | x | B | C |
    dt) and the x, B and C views into it; B and C drawn at 0.3."""
    rng = np.random.default_rng(seed)
    hp, gn = h * p, g * n
    scale = np.concatenate([np.ones(2 * hp), np.full(2 * gn, 0.3),
                            np.ones(h)])
    proj = (rng.standard_normal((bsz, t, 2 * hp + 2 * gn + h)) * scale
            ).astype(np.float16)
    tp = torch.from_numpy(proj)
    x = tp[..., hp:2 * hp].view(bsz, t, h, p)
    b = tp[..., 2 * hp:2 * hp + gn].view(bsz, t, g, n)
    c = tp[..., 2 * hp + gn:2 * hp + 2 * gn].view(bsz, t, g, n)
    dt = np.log1p(np.exp(rng.standard_normal((bsz, t, h)))).astype(
        np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    init = (rng.standard_normal((bsz, h, n, p)) * 0.5).astype(np.float32)
    return x, b, c, dt, a_log, init


@pytest.mark.parametrize("resume", [False, True], ids=["fresh", "resumed"])
def test_fp16_ssd_on_projection_views_matches_jax(resume):
    """``ssd`` on fp16 x, B and C that are strided views into one fused
    projection (smoke widths: 4 heads of P 16, N 16, G 1, 48 tokens in
    chunks of 16), fresh and resumed from a carried fp32 state, against
    the JAX SSD on the same values: y in fp16 and the final fp32 state."""
    bsz, t, h, p, g, n, chunk = 1, 48, 4, 16, 1, 16, 16
    x, b, c, dt, a_log, init = _projection(21, bsz, t, h, p, g, n)
    assert not (x.is_contiguous() or b.is_contiguous() or c.is_contiguous())
    d_skip = np.ones((h,), np.float32)
    init = init if resume else None
    jy, jfs = jops.ssd_impl(
        jnp.asarray(x.numpy()), jnp.asarray(dt), jnp.asarray(a_log),
        jnp.asarray(b.numpy()), jnp.asarray(c.numpy()),
        d_skip=jnp.asarray(d_skip), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init),
        return_final_state=True, backend="interpret")
    assert jy.dtype == jnp.float16
    ty, tfs = tm2.ssd(x, torch.from_numpy(dt), torch.from_numpy(a_log), b, c,
                      d_skip=torch.from_numpy(d_skip), chunk=chunk,
                      initial_state=None if init is None
                      else torch.from_numpy(init), return_final_state=True)
    assert ty.dtype == torch.float16 and tfs.dtype == torch.float32
    g_, w = ty.float().numpy(), np.asarray(jy, np.float32)
    assert np.isfinite(g_).all()
    np.testing.assert_allclose(g_, w, rtol=F16_TOL,
                               atol=F16_TOL * np.abs(w).max())
    ws = np.asarray(jfs, np.float32)
    assert np.abs(tfs.numpy() - ws).max() <= STATE_TOL * np.abs(ws).max()
