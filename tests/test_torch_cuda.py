"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips on a host without a card; the
module imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -o filterwarnings= -m cuda \\
        tests/test_torch_cuda.py

The first test to launch a kernel builds the kernels with ``nvcc``.
Tolerances: fp32 1e-5 relative (plus 1e-5 of the largest magnitude), since
the kernels sum in another order than the plain versions; bf16 one bf16
ulp of the value (2^-7 relative) plus 2^-14 of the largest magnitude.
The int8 datapath (GEMM on both dataflows, conv, the mvout epilogue) is
bit-exact. The SSD's fp32 results are held against the naive recurrence
in fp64 within ``_ssd_exact.fp32_tolerance`` (the cumulative decay's
rounding, which the exponentials turn into a relative error).
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core.config import Activation
from repro_torch.kernels import attention as tak
from repro_torch.kernels import conv as tconv
from repro_torch.kernels import epilogue as tepi
from repro_torch.kernels import gemm as tgemm
from repro_torch.kernels import mamba2 as tm2
from repro_torch.kernels import ref as tref
from repro_torch.kernels.ref import gemm_ref

from _ssd_exact import fp32_tolerance, ssd_fp64

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


def _i8(g, shape, lo=-128, hi=128):
    return torch.randint(lo, hi, shape, generator=g, device=g.device,
                         dtype=torch.int8)


def test_int_plain_matmul_on_card(card):
    """The plain int path runs on CUDA (float64 products, exact) and equals
    the int64 form on the CPU, through a sum that wraps past 2^31."""
    g = torch.Generator(device=card).manual_seed(0)
    a, b = _i8(g, (9, 300)), _i8(g, (300, 7))
    want = (a.cpu().long() @ b.cpu().long()).to(torch.int32)
    assert torch.equal(tref._int_matmul(a, b).cpu(), want)
    big = torch.full((1, 140_000), 127, dtype=torch.int8, device=card)
    got = tref._int_matmul(big, big.T.contiguous()).cpu()
    want = (big.cpu().long() @ big.cpu().T.long()).to(torch.int32)
    assert torch.equal(got, want) and int(want) < 0   # wrapped


@pytest.mark.parametrize("dataflow", ["OS", "WS"])
@pytest.mark.parametrize("m,n,k,bias,trans_b,out,shift,act", [
    (1000, 512, 2048, "row", False, torch.int8, 7, "RELU"),   # quickstart
    (1, 1000, 2048, "row", False, torch.int8, 7, "NONE"),     # classifier
    (37, 77, 147, "full", False, torch.int32, 0, "RELU6"),    # ragged, stem K
    (200, 136, 260, None, True, torch.int8, 5, "RELU"),       # B transposed
    (130, 24, 4608, "row", False, torch.int8, 12, "NONE"),    # K beyond a strip
])
def test_int8_gemm_matches_plain(card, dataflow, m, n, k, bias, trans_b, out,
                                 shift, act):
    g = torch.Generator(device=card).manual_seed(m + n + k)
    a = _i8(g, (m, k))
    b = _i8(g, (n, k)).T if trans_b else _i8(g, (k, n))
    d = {None: None,
         "row": torch.randint(-5000, 5000, (n,), generator=g, device=card,
                              dtype=torch.int32),
         "full": torch.randint(-5000, 5000, (m, n), generator=g, device=card,
                               dtype=torch.int32)}[bias]
    kw = dict(acc_dtype=torch.int32, out_dtype=out, shift=shift,
              activation=Activation[act])
    fn = tgemm.gemm_ws if dataflow == "WS" else tgemm.gemm_os
    n0 = fn.launches
    got = fn(a, b, d, **kw)
    assert fn.launches == n0 + 1
    assert got.dtype == out and torch.equal(got, gemm_ref(a, b, d, **kw))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_float_gemm_ws_matches_plain(card, dtype):
    """The WS order on the float datapath: the same tiles, weight-major."""
    g = torch.Generator(device=card).manual_seed(7)
    a = torch.randn((300, 200), generator=g, device=card).to(dtype)
    b = torch.randn((200, 130), generator=g, device=card).to(dtype)
    kw = dict(acc_dtype=torch.float32, out_dtype=dtype)
    got = tgemm.gemm_ws(a, b, **kw)
    _close(got, gemm_ref(a, b, None, **kw), dtype)
    assert torch.equal(got, tgemm.gemm_os(a, b, **kw))


@pytest.mark.parametrize("acc_dtype,out_dtype,shape,shift,act", [
    (torch.int32, torch.int8, (1000, 512), 7, "RELU"),
    (torch.int32, torch.int32, (3, 5, 7), 31, "NONE"),
    (torch.float32, torch.float32, (3136, 256), 2, "GELU"),
    (torch.float32, torch.bfloat16, (33, 65), 0, "SILU"),
])
def test_accumulator_epilogue_matches_plain(card, acc_dtype, out_dtype, shape,
                                            shift, act):
    g = torch.Generator(device=card).manual_seed(1)
    if acc_dtype == torch.int32:
        acc = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                            device=card, dtype=torch.int32)
    else:
        acc = torch.randn(shape, generator=g, device=card) * 8
    kw = dict(out_dtype=out_dtype, shift=shift, activation=Activation[act])
    n0 = tgemm.accumulator_epilogue.launches
    got = tgemm.accumulator_epilogue(acc, **kw)
    assert tgemm.accumulator_epilogue.launches == n0 + 1
    want = tepi.apply(acc, **kw)
    if acc_dtype == torch.int32:
        assert torch.equal(got, want)
    else:
        _close(got, want, out_dtype)


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,pad,bias", [
    (1, 224, 224, 3, 64, 7, 7, 2, 3, True),    # ResNet-50 conv1 (stem)
    (1, 56, 56, 64, 64, 3, 3, 1, 1, True),     # stage-1 3x3
    (1, 28, 28, 128, 512, 1, 1, 1, 0, False),  # 1x1
    (2, 15, 13, 8, 20, 3, 3, 2, 1, True),      # strided, CI % 16 != 0
    (2, 14, 10, 16, 12, 5, 3, 1, 2, False),    # rectangular filter
])
def test_conv2d_implicit_matches_plain(card, n, h, w, ci, co, kh, kw, stride,
                                       pad, bias):
    g = torch.Generator(device=card).manual_seed(h * w + co)
    x = _i8(g, (n, h, w, ci), -64, 64)
    wt = _i8(g, (kh, kw, ci, co), -32, 32)
    b = torch.randint(-500, 500, (co,), generator=g, device=card,
                      dtype=torch.int32) if bias else None
    kw_ = dict(stride=stride, padding=pad, acc_dtype=torch.int32,
               out_dtype=torch.int8, shift=7, activation=Activation.RELU)
    n0 = tconv.conv2d_implicit.launches
    got = tconv.conv2d_implicit(x, wt, b, **kw_)
    assert tconv.conv2d_implicit.launches == n0 + 1
    assert torch.equal(got, tref.conv2d_ref(x, wt, b, **kw_))


@pytest.mark.parametrize("act", ["GELU", "SILU"])
def test_int_kernels_refuse_float_units(card, act):
    """GELU / SiLU on an int32 accumulator raise before any launch, as
    the plain version does."""
    x = torch.ones((4, 32), dtype=torch.int8, device=card)
    kw = dict(acc_dtype=torch.int32, out_dtype=torch.int8,
              activation=Activation[act])
    for fn in (tgemm.gemm_os, tgemm.gemm_ws):
        with pytest.raises(ValueError, match="float unit"):
            fn(x, x.T, **kw)
    with pytest.raises(ValueError, match="float unit"):
        tgemm.accumulator_epilogue(x.int(), out_dtype=torch.int8,
                                   activation=Activation[act])
    with pytest.raises(ValueError, match="float unit"):
        tconv.conv2d_implicit(x.reshape(1, 2, 2, 32), x.reshape(1, 1, 32, 4),
                              **kw)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,h,p,g,n,chunk", [(1000, 8, 64, 1, 128, 256),
                                             (300, 10, 64, 1, 16, 256),
                                             (7, 4, 8, 1, 8, 256),
                                             (70, 8, 16, 2, 32, 32)])
@pytest.mark.parametrize("resume", [False, True])
def test_ssd_matches_plain(card, dtype, t, h, p, g, n, chunk, resume):
    """The chunked SSD kernel: ragged chunks, grouped B/C, x/B/C read as
    strided views of one fused buffer (as the model hands them over), and
    a resumed segment's initial state taken into the kernel."""
    rng = np.random.default_rng(t + h + n)
    bsz = 2
    d_in = h * p
    fused = torch.tensor(rng.standard_normal((bsz, t, d_in + 2 * g * n)),
                         dtype=torch.float32).to(card, dtype)
    x = fused[..., :d_in].reshape(bsz, t, h, p)
    b = fused[..., d_in:d_in + g * n].reshape(bsz, t, g, n) * 0.3
    c = fused[..., d_in + g * n:].reshape(bsz, t, g, n) * 0.3
    dt = torch.tensor(np.abs(rng.standard_normal((bsz, t, h))) * 0.5 + 0.01,
                      dtype=torch.float32, device=card)
    a_log = torch.tensor(np.log(np.linspace(1.0, 16.0, h)),
                         dtype=torch.float32, device=card)
    d_skip = torch.tensor(rng.standard_normal(h), dtype=torch.float32,
                          device=card)
    init = torch.tensor(rng.standard_normal((bsz, h, n, p)) * 0.5,
                        dtype=torch.float32, device=card) if resume else None
    kw = dict(d_skip=d_skip, chunk=chunk, return_final_state=True)
    kernels.reset_launch_counts()
    y, fs = tm2.ssd(x, dt, a_log, b, c, initial_state=init, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd"] == 1
    # fp32 results against the naive recurrence in fp64 on the same inputs,
    # within the rounding the decay exponentials amplify (fp32_tolerance);
    # bf16 outputs against the plain version in bf16.
    tol = fp32_tolerance(dt, a_log, chunk)
    exact_y, exact_fs = ssd_fp64(x, dt, a_log, b, c, d_skip=d_skip,
                                 initial_state=init)
    if dtype == torch.bfloat16:
        _close(y, tm2.ssd_plain(x, dt, a_log, b, c, initial_state=init,
                                **kw)[0], dtype)
    else:
        torch.testing.assert_close(y.double(), exact_y, rtol=0,
                                   atol=tol * exact_y.abs().max().item())
    torch.testing.assert_close(fs.double(), exact_fs, rtol=0,
                               atol=tol * exact_fs.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,kvh,d,pos,window,softcap",
                         [(4, 2048, 4, 1, 256, 1999, None, None),
                          (4, 2048, 4, 1, 256, 1999, 512, None),
                          (1, 784, 4, 1, 256, 783, 512, None),
                          (2, 700, 25, 5, 64, 650, 1024, None),
                          (3, 100, 8, 2, 128, 99, 24, 50.0),
                          (2, 64, 4, 4, 16, 0, None, None)])
def test_decode_attention_matches_plain(card, dtype, b, s, h, kvh, d, pos,
                                        window, softcap):
    """Dense decode against a cache whose rows past ``pos`` hold NaN (the
    kernel must never read them; the plain version gets zeros there)."""
    rng = np.random.default_rng(s + h)
    q = torch.tensor(rng.standard_normal((b, 1, h, d)),
                     dtype=torch.float32).to(card, dtype)
    k = torch.tensor(rng.standard_normal((b, s, kvh, d)),
                     dtype=torch.float32).to(card, dtype)
    v = torch.tensor(rng.standard_normal((b, s, kvh, d)),
                     dtype=torch.float32).to(card, dtype)
    kw = dict(window=window, softcap=softcap)
    want = tak.decode_attention_plain(q, k, v, pos, **kw)
    k[:, pos + 1:] = float("nan")
    v[:, pos + 1:] = float("nan")
    kernels.reset_launch_counts()
    got = tak.decode_attention(q, k, v, pos, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == 1
    _close(got, want, dtype)


def _bf16(rng, shape, card):
    return torch.tensor(rng.standard_normal(shape),
                        dtype=torch.float32).to(card, torch.bfloat16)


def _flash_inputs(card, b, tq, tk, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return (_bf16(rng, (b, tq, h, d), card), _bf16(rng, (b, tk, kvh, d), card),
            _bf16(rng, (b, tk, kvh, d), card))


@pytest.mark.parametrize("tq,tk", [(tq, tk) for tq in (1, 15, 17, 45, 256)
                                   for tk in sorted({tq, 70, 200})
                                   if tk >= tq])
def test_flash_bf16_ragged_shapes(card, tq, tk):
    """The tensor-core flash kernel on ragged query and key counts (row and
    key predicates, no padded copies), MQA 4/1 at head dim 256, causal."""
    q, k, v = _flash_inputs(card, 1, tq, tk, 4, 1, 256, tq * 1000 + tk)
    n0 = tak.flash_attention.launches
    got = tak.flash_attention(q, k, v)
    assert tak.flash_attention.launches == n0 + 1
    _close(got, tak.blockwise_attention(q, k, v), torch.bfloat16)


@pytest.mark.parametrize("b,tq,tk,h,kvh,d,window,softcap", [
    (1, 45, 200, 4, 1, 256, 24, None),      # window edge inside a key tile
    (2, 100, 130, 8, 2, 64, 40, None),      # ... at a 64-key tile
    (1, 64, 64, 4, 1, 256, None, 50.0),     # softcap
    (1, 384, 384, 25, 5, 64, 1024, None),   # hymba's GQA 25 / 5
    (1, 256, 256, 4, 1, 256, None, None),   # gemma3's MQA 4 / 1
    (2, 33, 90, 4, 2, 16, 20, 30.0),        # head dim 16
    (1, 50, 77, 6, 3, 32, None, None),      # head dim 32
    (1, 70, 70, 2, 2, 128, 16, None),       # head dim 128, MHA
])
def test_flash_bf16_matches_plain(card, b, tq, tk, h, kvh, d, window,
                                  softcap):
    q, k, v = _flash_inputs(card, b, tq, tk, h, kvh, d, tq + tk + d)
    kw = dict(window=window, softcap=softcap)
    got = tak.flash_attention(q, k, v, **kw)
    _close(got, tak.blockwise_attention(q, k, v, **kw), torch.bfloat16)


def test_flash_bf16_rerun_is_bit_identical(card):
    """The partials merge in a fixed order, so two runs at gemma3-1b's
    first-chunk shape agree bit for bit."""
    q, k, v = _flash_inputs(card, 1, 256, 256, 4, 1, 256, 11)
    first = tak.flash_attention(q, k, v)
    assert torch.equal(first, tak.flash_attention(q, k, v))


def _decode_inputs(card, dtype, b, s, h, kvh, d, seed):
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape),
                              dtype=torch.float32).to(card, dtype)
                 for shape in ((b, 1, h, d), (b, s, kvh, d), (b, s, kvh, d)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,s,h,kvh,d,pos,window", [
    (1, 300, 4, 1, 256, "split-1", None),    # the last key closes a split
    (1, 300, 4, 1, 256, "split", None),      # ... and one past it
    (2, 300, 8, 2, 128, "2split", 100),
    (1, 100, 4, 1, 256, 0, None),            # one live key
    (2, 300, 4, 1, 256, 250, 24),            # window inside one split
    (4, 2048, 4, 1, 256, 1999, 700),         # four sequences, ragged splits
    (1, 500, 25, 5, 64, 420, None),          # hymba's GQA 25 / 5
    (2, 90, 6, 2, 16, 80, 50),               # head dim 16
])
def test_decode_split_edges(card, dtype, b, s, h, kvh, d, pos, window):
    """The split-KV decode kernel where splits begin and end, with NaN in
    every row past ``pos`` (never read): one launch per call, two calls
    bit-identical."""
    split = tak.decode_plan(b, s, h, kvh, d, s - 1)[3]
    pos = {"split-1": split - 1, "split": split,
           "2split": 2 * split}.get(pos, pos)
    q, k, v = _decode_inputs(card, dtype, b, s, h, kvh, d, s + h + d)
    want = tak.decode_attention_plain(q, k, v, pos, window=window)
    k[:, pos + 1:] = float("nan")
    v[:, pos + 1:] = float("nan")
    kernels.reset_launch_counts()
    got = tak.decode_attention(q, k, v, pos, window=window)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["decode_attention"] == 1
    _close(got, want, dtype)
    assert torch.equal(got, tak.decode_attention(q, k, v, pos, window=window))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_split_on_concurrent_streams(card, dtype):
    """Calls on two streams at once, each of many splits: every call zeroes
    the tickets of its own workspace, so the two never merge each other's
    partials."""
    b, s, h, kvh, d = 4, 2048, 4, 1, 256
    assert tak.decode_plan(b, s, h, kvh, d, s - 1)[0] > 1
    inputs = [_decode_inputs(card, dtype, b, s, h, kvh, d, seed)
              for seed in (5, 6)]
    wants = [tak.decode_attention_plain(q, k, v, s - 1) for q, k, v in inputs]
    streams = [torch.cuda.Stream(card) for _ in inputs]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(8):
        for i, (st, (q, k, v)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(st):
                gots[i].append(tak.decode_attention(q, k, v, s - 1))
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        for g in got:
            _close(g, want, dtype)
