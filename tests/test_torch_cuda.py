"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips on a host without a card; the
module imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -o filterwarnings= -m cuda \\
        tests/test_torch_cuda.py

The first test to launch a kernel builds the kernels with ``nvcc``.
Tolerances: fp32 1e-5 relative (plus 1e-5 of the largest magnitude), since
the kernels sum in another order than the plain versions; bf16 one bf16
ulp of the value (2^-7 relative) plus 2^-14 of the largest magnitude.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels import attention as tak
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels.ref import gemm_ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels build with nvcc for "
                    "sm_90a at first use)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    scale = w.abs().max().item()
    rtol, atol = ((2.0 ** -7, 2.0 ** -14 * scale) if dtype == torch.bfloat16
                  else (1e-5, 1e-5 * scale))
    torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


def _pools(rng, kvh, n_pool, page, d, lens, mp):
    """Pools holding each slot's tokens on random pages; unowned pages NaN
    (the kernels must never read them)."""
    pk = np.full((kvh, n_pool, page, d), np.nan, np.float32)
    pv = np.full((kvh, n_pool, page, d), np.nan, np.float32)
    tables = np.zeros((len(lens), mp), np.int32)
    free = list(rng.permutation(n_pool))
    for b, n in enumerate(lens):
        for j in range(-(-n // page)):
            pid = free.pop()
            tables[b, j] = pid
            pk[:, pid] = rng.standard_normal((kvh, page, d))
            pv[:, pid] = rng.standard_normal((kvh, page, d))
    return pk, pv, tables


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [3, 40])
def test_gemm_matches_plain(card, dtype, m):
    """Ragged M/N/K, B read as the transpose of a row-major (N, K) buffer
    (the tied unembedding's layout), bias on the D input."""
    g = torch.Generator(device=card).manual_seed(m)
    a = torch.randn((m, 300), generator=g, device=card).to(dtype)
    b = torch.randn((77, 300), generator=g, device=card).to(dtype).T
    bias = torch.randn((77,), generator=g, device=card)
    kw = dict(acc_dtype=torch.float32, out_dtype=dtype)
    n0 = tgemm.gemm.launches
    got = tgemm.gemm(a, b, bias, **kw)
    assert tgemm.gemm.launches == n0 + 1
    _close(got, gemm_ref(a, b, bias, **kw), dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_attention_kernels_match_plain(card, dtype, d):
    """GQA, window and softcap on all three attention kernels; a decode
    slot of length 0 gives a zero row; NaN pages are never read."""
    rng = np.random.default_rng(d)
    h, kvh, page, mp = 8, 2, 16, 6
    lens = [70, 0, 33]
    pk, pv, tables = _pools(rng, kvh, 24, page, d, lens, mp)
    pk_c, pv_c = (torch.from_numpy(x).to(card, dtype) for x in (pk, pv))
    tables_c = torch.from_numpy(tables).to(card)
    lens_c = torch.tensor(lens, dtype=torch.int32, device=card)
    kw = dict(window=24, softcap=30.0)
    counts = kernels.launch_counts()

    q = torch.from_numpy(rng.standard_normal((3, 1, h, d))).to(card, dtype)
    got = tak.paged_decode_attention(q, pk_c, pv_c, tables_c, lens_c, **kw)
    _close(got, tak.paged_decode_attention_plain(q, pk_c, pv_c, tables_c,
                                                 lens_c, **kw), dtype)
    assert (got[1] == 0).all()

    qp = torch.from_numpy(rng.standard_normal((1, 20, h, d))).to(card, dtype)
    got = tak.paged_prefill_attention(qp, pk_c, pv_c, tables_c[0], 50, **kw)
    _close(got, tak.paged_prefill_attention_plain(qp, pk_c, pv_c,
                                                  tables_c[0], 50, **kw),
           dtype)

    k = torch.from_numpy(rng.standard_normal((2, 70, kvh, d))).to(card, dtype)
    v = torch.from_numpy(rng.standard_normal((2, 70, kvh, d))).to(card, dtype)
    qf = torch.from_numpy(rng.standard_normal((2, 45, h, d))).to(card, dtype)
    got = tak.flash_attention(qf, k, v, **kw)
    _close(got, tak.blockwise_attention(qf, k, v, **kw), dtype)

    after = kernels.launch_counts()
    for name in ("paged_decode_attention", "paged_prefill_attention",
                 "flash_attention"):
        assert after[name] == counts[name] + 1, name
