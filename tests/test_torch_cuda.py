"""The port's CUDA kernels against their plain versions, on a card.

Every test here is marked ``cuda`` and skips on a host without a card; the
module imports no JAX, so it runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -o filterwarnings= -m cuda \\
        tests/test_torch_cuda.py

The first test to launch a kernel builds the kernels with ``nvcc``.
Tolerances: fp32 1e-5 relative (plus 1e-5 of the largest magnitude), since
the kernels sum in another order than the plain versions (the bf16 GEMM's
fp32 outputs: the bound on a float sum's order, ``_close_bf16_gemm``);
bf16 one bf16 ulp of the value (2^-7 relative) plus 2^-14 of the largest
magnitude.
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
    count = _os_count(dtype)
    n0 = count.launches
    got = tgemm.gemm(a, b, bias, **kw)
    assert count.launches == n0 + 1
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


def _paged_decode_inputs(card, dtype, lens, page, mp, h, kvh, d, window,
                         seed):
    """q, pools, tables and lengths for paged decode. Every key row a slot
    must not read holds NaN: the rows of its pages past its length and
    before its window, and every page no slot owns; the table entries past
    a slot's pages point at an all-NaN page."""
    rng = np.random.default_rng(seed)
    owned = sum(-(-n // page) for n in lens)
    n_pool = owned + 3
    pk = np.full((kvh, n_pool, page, d), np.nan, np.float32)
    pv = np.full((kvh, n_pool, page, d), np.nan, np.float32)
    free = list(rng.permutation(n_pool - 1))
    tables = np.full((len(lens), mp), n_pool - 1, np.int32)
    for b, n in enumerate(lens):
        lo = max(0, n - window) if window else 0
        for j in range(-(-n // page)):
            pid = free.pop()
            tables[b, j] = pid
            for r in range(page):
                if lo <= j * page + r < n:
                    pk[:, pid, r] = rng.standard_normal((kvh, d))
                    pv[:, pid, r] = rng.standard_normal((kvh, d))
    q = torch.from_numpy(rng.standard_normal((len(lens), 1, h, d))
                         ).to(card, dtype)
    return (q, torch.from_numpy(pk).to(card, dtype),
            torch.from_numpy(pv).to(card, dtype),
            torch.from_numpy(tables).to(card),
            torch.tensor(lens, dtype=torch.int32, device=card))


_PAGED_EDGES = [
    # lengths, page, pages per slot, H, KVH, D, window
    ([0, 1, 63, 64, 65, 2048], 64, 32, 4, 1, 256, None),
    ([0, 1, 63, 64, 65, 2048], 16, 128, 4, 1, 256, None),
    ([0, 1, 63, 64, 65, 208], 16, 13, 4, 1, 256, None),   # reach 208
    ([300, 320, 64, 0, 208], 16, 20, 4, 1, 256, 100),     # window mid-split
    ([320, 384, 128, 1], 64, 8, 4, 1, 256, 128),          # ... on a boundary
    ([1010, 530, 310, 80], 64, 32, 4, 1, 256, 512),       # gemma3's local
    ([700, 1, 0], 64, 16, 25, 5, 64, 1024),               # hymba's GQA
    ([700, 130, 5], 64, 16, 25, 5, 64, None),
    ([90, 33], 16, 8, 8, 2, 128, 24),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", range(len(_PAGED_EDGES)))
def test_paged_decode_split_edges(card, dtype, case):
    """Paged decode where splits begin and end: lengths 0, 1, 63, 64, 65
    and the table's whole reach, pages of 16 and 64, a reach that is not a
    multiple of 64 keys, a window edge inside a split and on a split
    boundary, GQA 25 / 5 at head dim 64. NaN in every row the kernel must
    not read; one launch per call; a zero row for an empty slot; a rerun
    bit-identical."""
    lens, page, mp, h, kvh, d, window = _PAGED_EDGES[case]
    q, pk, pv, tables, lengths = _paged_decode_inputs(
        card, dtype, lens, page, mp, h, kvh, d, window, case)
    kw = dict(window=window, softcap=30.0 if case == 8 else None)
    want = tak.paged_decode_attention_plain(q, pk, pv, tables, lengths, **kw)
    kernels.reset_launch_counts()
    got = tak.paged_decode_attention(q, pk, pv, tables, lengths, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["paged_decode_attention"] == 1
    _close(got, want, dtype)
    for b, n in enumerate(lens):
        if n == 0:
            assert (got[b] == 0).all()
    again = tak.paged_decode_attention(q, pk, pv, tables, lengths, **kw)
    assert torch.equal(got, again)


def test_paged_decode_plan_from_shapes(card):
    """The grid comes from the shapes alone: the table's reach in 64-key
    splits, or the window's (one more where it starts mid-split)."""
    assert tak.paged_decode_plan(4, 32, 64, 4, 1, 256)[:2] == (32, 4)
    assert tak.paged_decode_plan(4, 32, 64, 4, 1, 256, 512)[:2] == (9, 4)
    assert tak.paged_decode_plan(2, 13, 16, 4, 1, 256)[0] == 4
    assert tak.paged_decode_plan(1, 1, 16, 4, 1, 256) == (1, 1, 4, 64, 0)
    assert tak.paged_decode_plan(3, 16, 64, 25, 5, 64, 1024)[:3] == (16, 15, 8)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_paged_decode_on_concurrent_streams(card, dtype):
    """Calls on two streams at once at gemma3-1b's serving shape: each
    stream has its own tickets and partials, so every result equals the
    single-stream one."""
    inputs = [_paged_decode_inputs(card, dtype, [1010, 530, 310, 80], 64, 32,
                                   4, 1, 256, None, seed)
              for seed in (5, 6)]
    wants = [tak.paged_decode_attention(*args) for args in inputs]
    streams = [torch.cuda.Stream(card) for _ in inputs]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(8):
        for i, (st, args) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(st):
                gots[i].append(tak.paged_decode_attention(*args))
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        for g in got:
            assert torch.equal(g, want)


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


# ---------------------------------------------------------------------------
# the int8 main loop (igemm.cuh): every plan regime at ResNet-50's shapes,
# split-K wrapping, both B layouts, misaligned operands, streams
# ---------------------------------------------------------------------------
_S8_REGIMES = [  # (M, N, K, regime): dse.resnet(50)'s shapes, the quickstart
    (1, 1000, 2048, "skinny"), (16, 1000, 2048, "skinny"),
    (17, 512, 4608, "square"), (49, 512, 4608, "square"),
    (49, 2048, 512, "square"), (196, 256, 2304, "square"),
    (196, 1024, 256, "square"), (784, 128, 1152, "square"),
    (784, 512, 128, "square"), (1000, 512, 2048, "square"),
    (3136, 64, 576, "square"), (3136, 256, 64, "square"),
    (12544, 64, 147, "square"),
]


def _s8_case(g, m, n, k, trans_b, card, lo=-128, hi=128):
    a = _i8(g, (m, k), lo, hi)
    b = _i8(g, (n, k), lo, hi).T if trans_b else _i8(g, (k, n), lo, hi)
    d = torch.randint(-2 ** 20, 2 ** 20, (n,), generator=g, device=card,
                      dtype=torch.int32)
    return a, b, d


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("m,n,k,regime", _S8_REGIMES)
def test_int8_gemm_plan_regimes(card, m, n, k, regime, trans_b):
    """Every regime of the plan at ResNet-50's N and K: bit-exact against
    the plain version in both dataflows, OS equal to WS, int8 and int32
    outputs, and each call one launch."""
    assert tgemm.gemm_s8_plan(m, n, k, trans_b)["regime"] == regime
    g = torch.Generator(device=card).manual_seed(m * 7 + n + k)
    a, b, d = _s8_case(g, m, n, k, trans_b, card)
    for out, shift, act in ((torch.int8, 9, "RELU"), (torch.int32, 0, "NONE")):
        kw = dict(acc_dtype=torch.int32, out_dtype=out, shift=shift,
                  activation=Activation[act])
        want = gemm_ref(a, b, d, **kw)
        n0, w0 = tgemm.gemm_os.launches, tgemm.gemm_ws.launches
        got = tgemm.gemm_os(a, b, d, **kw)
        assert tgemm.gemm_os.launches == n0 + 1
        assert got.dtype == out and torch.equal(got, want)
        assert torch.equal(tgemm.gemm_ws(a, b, d, **kw), got)
        assert tgemm.gemm_ws.launches == w0 + 1


@pytest.mark.parametrize("dataflow", ["OS", "WS"])
def test_int8_gemm_split_k_wraps(card, dataflow):
    """A K split 16 ways whose partials and bias carry the int32 sum past
    2^31: the merge wraps as the plain version does, bit for bit, and
    every ticket is back at 0 afterwards."""
    m, n, k = 17, 64, 150_000
    assert tgemm.gemm_s8_plan(m, n, k)["splits"] == 16
    a = torch.full((m, k), 127, dtype=torch.int8, device=card)
    b = torch.full((k, n), 127, dtype=torch.int8, device=card)
    a[:, ::3] = 100
    d = torch.full((n,), 2 ** 31 - 7, dtype=torch.int32, device=card)
    kw = dict(acc_dtype=torch.int32, out_dtype=torch.int32)
    fn = tgemm.gemm_ws if dataflow == "WS" else tgemm.gemm_os
    got = fn(a, b, d, **kw)
    torch.cuda.synchronize()
    exact = (a[:1].cpu().long() @ b[:, :1].cpu().long()).item() + 2 ** 31 - 7
    assert exact > 2 ** 32 and int(got[0, 0]) == (exact + 2 ** 31) % 2 ** 32 \
        - 2 ** 31
    assert torch.equal(got, gemm_ref(a, b, d, **kw))
    ws = tgemm._WORKSPACE[(card.index or 0,
                           torch.cuda.current_stream(card).cuda_stream)]
    assert int(ws[:1024].abs().sum()) == 0


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("which", ["a", "b", "both"])
@pytest.mark.parametrize("m,n,k", [(200, 136, 260), (5, 96, 1024),
                                   (784, 128, 1152)])
def test_int8_gemm_misaligned_operands(card, m, n, k, which, trans_b):
    """Operands one byte past an aligned address (rows of 1- to 16-byte
    granules: the byte path and 4- to 16-byte copies), both B layouts,
    bit-exact and OS equal to WS."""
    g = torch.Generator(device=card).manual_seed(m + k)

    def shifted(shape):
        flat = _i8(g, (shape[0] * shape[1] + 1,))
        return flat[1:].view(shape)

    a = shifted((m, k)) if which in ("a", "both") else _i8(g, (m, k))
    if which in ("b", "both"):
        b = shifted((n, k)).T if trans_b else shifted((k, n))
    else:
        b = _i8(g, (n, k)).T if trans_b else _i8(g, (k, n))
    kw = dict(acc_dtype=torch.int32, out_dtype=torch.int8, shift=8,
              activation=Activation.RELU)
    got = tgemm.gemm_os(a, b, **kw)
    assert torch.equal(got, gemm_ref(a, b, None, **kw))
    assert torch.equal(tgemm.gemm_ws(a, b, **kw), got)


def test_int8_gemm_on_concurrent_streams(card):
    """Split-K calls on two streams back to back: each stream has its own
    workspace and tickets, every result equals the single-stream one bit
    for bit, and both streams' tickets are at 0 afterwards."""
    m, n, k = 49, 512, 4608
    assert tgemm.gemm_s8_plan(m, n, k)["splits"] > 1
    g = torch.Generator(device=card).manual_seed(k)
    kw = dict(acc_dtype=torch.int32, out_dtype=torch.int8, shift=10)
    inputs = [_s8_case(g, m, n, k, False, card) for _ in range(2)]
    wants = [tgemm.gemm_os(a, b, d, **kw) for a, b, d in inputs]
    streams = [torch.cuda.Stream(card) for _ in inputs]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(8):
        for i, (st, (a, b, d)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(st):
                gots[i].append(tgemm.gemm_os(a, b, d, **kw))
                gots[i].append(tgemm.gemm_ws(a, b, d, **kw))
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        for x in got:
            assert torch.equal(x, want)
    for st in streams:
        ws = tgemm._WORKSPACE[(card.index or 0, st.cuda_stream)]
        assert int(ws[:1024].abs().sum()) == 0


def test_int8_gemm_plan(card):
    """The plan fills the card: K splits > 1 wherever the tiles alone are
    fewer than the SMs and K has the steps; one split for one k step; 16-row
    tiles of 4 warps for M <= 16, else 64 x 64 tiles of 8 warps; one tile a
    block (both dataflows take this plan)."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    for m, n, k, _ in _S8_REGIMES:
        for trans_b in (False, True):
            p = tgemm.gemm_s8_plan(m, n, k, trans_b)
            bm, bn, bk = p["tile"]
            tiles = -(-m // bm) * -(-n // bn)
            if tiles < sms and -(-k // bk) >= 4:
                assert p["splits"] > 1, (m, n, k, p)
            assert p["grid"] == tiles * p["splits"]
            assert (p["workspace_bytes"] > 0) == (p["splits"] > 1)
    assert tgemm.gemm_s8_plan(3136, 256, 64)["splits"] == 1
    p = tgemm.gemm_s8_plan(1000, 512, 2048)
    assert p["tile"] == (64, 64, 64) and p["threads"] == 256
    p = tgemm.gemm_s8_plan(1, 1000, 2048)
    assert p["tile"] == (16, 64, 64) and p["threads"] == 128


def _resnet50_conv_shapes():
    """The distinct (H, CI, CO, KH, stride, pad) of dse.resnet(50)'s layers
    as chip_smoke.py's phase 6 runs them, classifier and stem included
    (``chip_smoke.resnet50_shapes``)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return [conv for _, _, conv, _ in cs.resnet50_shapes()]


@pytest.mark.parametrize("case", range(18))
def test_conv2d_implicit_resnet50_shapes(card, case):
    """Every distinct conv of dse.resnet(50)'s stream (1x1 by the matrix
    loader, 3x3 per stage and the stem by the tap gather): bit-exact
    against the plain version and the host route (im2col, then the GEMM
    on OS and on WS), int8 and int32 out."""
    shapes = _resnet50_conv_shapes()
    assert len(shapes) == 18
    h, ci, co, kh, stride, pad = shapes[case]
    g = torch.Generator(device=card).manual_seed(case)
    x = _i8(g, (1, h, h, ci), -64, 64)
    wt = _i8(g, (kh, kh, ci, co), -32, 32)
    b = torch.randint(-500, 500, (co,), generator=g, device=card,
                      dtype=torch.int32)
    for out, act in ((torch.int8, Activation.RELU), (torch.int32,
                                                     Activation.NONE)):
        kw_ = dict(stride=stride, padding=pad, acc_dtype=torch.int32,
                   out_dtype=out, shift=8, activation=act)
        n0 = tconv.conv2d_implicit.launches
        got = tconv.conv2d_implicit(x, wt, b, **kw_)
        assert tconv.conv2d_implicit.launches == n0 + 1
        assert torch.equal(got, tref.conv2d_ref(x, wt, b, **kw_))
        a = tref.im2col(x, kh, kh, stride, pad)
        for fn in (tgemm.gemm_os, tgemm.gemm_ws):
            host = fn(a, wt.reshape(-1, co), b[None, :], acc_dtype=torch.int32,
                      out_dtype=out, shift=8, activation=act)
            assert torch.equal(host.reshape(got.shape), got)


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,pad", [
    (2, 7, 9, 64, 24, 5, 3, 1, 2),     # padding on every border, g = 16
    (1, 6, 5, 8, 40, 3, 3, 1, 1),      # CI = 8: the strip loader
    (2, 9, 9, 12, 16, 3, 3, 2, 1),     # CI = 12: the strip loader
    (1, 6, 5, 24, 40, 3, 3, 1, 1),     # CI = 24: 8-byte copies
    (2, 9, 9, 20, 16, 3, 3, 2, 1),     # CI = 20: 4-byte copies
    (1, 7, 7, 17, 16, 3, 3, 1, 1),     # CI = 17: element loads
    (1, 10, 10, 3, 16, 7, 7, 2, 3),    # CI = 3: the strip loader
    (1, 5, 5, 64, 16, 3, 3, 1, 1),     # deep narrow, K = 576 split
    (3, 4, 4, 20, 8, 1, 1, 1, 0),      # 1x1, CI = 20: matrix loader
    (1, 9, 9, 32, 16, 1, 1, 2, 0),     # 1x1 strided: the tap gather
])
def test_conv2d_implicit_edges(card, n, h, w, ci, co, kh, kw, stride, pad):
    g = torch.Generator(device=card).manual_seed(h * w + ci)
    x = _i8(g, (n, h, w, ci), -64, 64)
    wt = _i8(g, (kh, kw, ci, co), -32, 32)
    b = torch.randint(-500, 500, (co,), generator=g, device=card,
                      dtype=torch.int32)
    kw_ = dict(stride=stride, padding=pad, acc_dtype=torch.int32,
               out_dtype=torch.int8, shift=6, activation=Activation.RELU6)
    assert torch.equal(tconv.conv2d_implicit(x, wt, b, **kw_),
                       tref.conv2d_ref(x, wt, b, **kw_))


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


# ---------------------------------------------------------------------------
# the bf16 GEMM's two regimes (skinny split-K mma.sync, M <= 16; wide
# wgmma) at ragged shapes, every option, every split count
# ---------------------------------------------------------------------------
def _bf16_operands(g, m, n, k, trans_b):
    a = torch.randn((m, k), generator=g, device=g.device).to(torch.bfloat16)
    bt = (torch.randn((n, k), generator=g, device=g.device) * k ** -0.5
          ).to(torch.bfloat16)
    return a, (bt.T if trans_b else bt.T.contiguous())


def _close_bf16_gemm(got, want, a, b, out_dtype):
    """bf16 outputs: ``_close`` (one bf16 ulp, since the fp32 sums may
    round either way). fp32 outputs: the bf16 products are exact in fp32,
    so kernel and plain version differ only in the order of their fp32
    sums; each lies within K * 2^-24 * sum_k |a_ik b_kj| of the exact sum
    (the standard bound on a float sum in any order), hence twice that,
    plus 1e-5 relative for the activation's own rounding."""
    if out_dtype == torch.bfloat16:
        _close(got, want, out_dtype)
        return
    k = a.shape[1]
    mag = (a.float().abs() @ b.float().abs()).cpu()
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    bound = 2 * k * 2.0 ** -24 * mag + 1e-5 * w.abs() + 1e-30
    assert ((g - w).abs() <= bound).all(), float(((g - w).abs() - bound).max())


@pytest.mark.parametrize("k", [300, 1152, 6912])
@pytest.mark.parametrize("n", [77, 256, 1000])
@pytest.mark.parametrize("m", [1, 3, 4, 5, 16, 17, 63, 64, 65, 256, 1000])
def test_bf16_gemm_ragged_shapes(card, m, n, k):
    """Both regimes at ragged M, N and K, B row-major and as the transpose
    of a row-major (N, K) buffer (the tied unembedding's layout): one
    launch per call."""
    g = torch.Generator(device=card).manual_seed(m * 7 + n * 3 + k)
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.bfloat16)
    for trans_b in (False, True):
        a, b = _bf16_operands(g, m, n, k, trans_b)
        n0 = tgemm.gemm.launches
        got = tgemm.gemm(a, b, **kw)
        assert tgemm.gemm.launches == n0 + 1
        _close(got, gemm_ref(a, b, None, **kw), torch.bfloat16)


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias", [None, "row", "full"])
@pytest.mark.parametrize("act,shift", [("NONE", 0), ("RELU", 0),
                                       ("RELU6", 2), ("GELU", 0),
                                       ("SILU", 1)])
def test_bf16_gemm_epilogue_options(card, act, shift, bias, out):
    """Bias as one row or a full (M, N) matrix, every activation, a shift,
    bf16 and fp32 outputs, both B layouts, in both regimes (with K
    splits)."""
    g = torch.Generator(device=card).manual_seed(len(act) + shift)
    for m, n, k in ((4, 200, 1152), (100, 300, 700)):
        d = {None: None,
             "row": torch.randn((n,), generator=g, device=card),
             "full": torch.randn((m, n), generator=g, device=card)}[bias]
        kw = dict(acc_dtype=torch.float32, out_dtype=out, shift=shift,
                  activation=Activation[act])
        for trans_b in (False, True):
            a, b = _bf16_operands(g, m, n, k, trans_b)
            got = tgemm.gemm(a, b, d, **kw)
            assert got.dtype == out
            _close_bf16_gemm(got, gemm_ref(a, b, d, **kw), a, b, out)


@pytest.mark.parametrize("m,n,k", [(4, 130, 1150), (100, 130, 1150),
                                   (129, 16700, 70)])   # 128 x 256 tiles
@pytest.mark.parametrize("which", ["a", "b", "both"])
def test_bf16_gemm_misaligned_operands(card, m, n, k, which):
    """Rows that are not 16-byte aligned (a 4-byte offset, a row stride
    that is no multiple of 8): no tensor map, loaded element by element,
    same result."""
    g = torch.Generator(device=card).manual_seed(m)
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.bfloat16)
    a, b = _bf16_operands(g, m, n, k, False)
    if which in ("a", "both"):
        flat = torch.empty(m * k + 2, dtype=torch.bfloat16, device=card)
        flat[2:] = a.reshape(-1)
        a = flat[2:].view(m, k)
        assert a.data_ptr() % 16 == 4 and a.stride(0) % 8 != 0
    if which in ("b", "both"):
        flat = torch.empty(n * k + 2, dtype=torch.bfloat16, device=card)
        flat[2:] = b.T.reshape(-1)
        b = flat[2:].view(n, k).T                   # B = table.T, ldb = 1150
        assert b.data_ptr() % 16 == 4
    _close(tgemm.gemm(a, b, **kw), gemm_ref(a, b, None, **kw),
           torch.bfloat16)


def _split_shape(regime, splits):
    """A shape whose K the plan splits ``splits`` ways on any card: skinny
    (one tile, row-major B, one 64-deep round of loads per split, ragged
    K), or wide (M = 64, two 128 x 64 tiles, four k steps per split: one
    cluster of ``splits`` blocks per tile)."""
    if regime == "skinny":
        return 3, 200, 64 * splits - 5
    return 64, 128, 256 * splits


@pytest.mark.parametrize("regime,splits",
                         [("skinny", s) for s in range(1, 33)] +
                         [("wide", s) for s in range(1, 9)])
def test_bf16_gemm_every_split_count(card, regime, splits):
    """Every split count the plan can choose covers K exactly once: with
    small integers the fp32 sum is exact, so the kernel must equal the
    plain version bit for bit. A skinny split leaves every ticket back at
    0; a wide one merges within its cluster and takes no workspace."""
    m, n, k = _split_shape(regime, splits)
    plan = tgemm.gemm_plan(m, n, k)
    assert plan["regime"] == regime and plan["splits"] == splits
    g = torch.Generator(device=card).manual_seed(splits)
    a = torch.randint(-3, 4, (m, k), generator=g, device=card).to(
        torch.bfloat16)
    b = torch.randint(-3, 4, (k, n), generator=g, device=card).to(
        torch.bfloat16)
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.float32)
    got = tgemm.gemm(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, gemm_ref(a, b, None, **kw))
    if regime == "wide":
        assert plan["workspace_bytes"] == 0
    elif splits > 1:
        ws = tgemm._WORKSPACE[(card.index or 0,
                               torch.cuda.current_stream(card).cuda_stream)]
        assert int(ws[:1024].abs().sum()) == 0


@pytest.mark.parametrize("m,n,k,trans_b", [
    (4, 1024, 1152, False),      # skinny, K split 17 ways
    (16, 6912, 1152, True),      # skinny, two MMAs per 16 k
    (64, 256, 6912, False),      # wide, 128 x 64 tiles, a cluster per tile
    (256, 1152, 1024, True),     # wide, K split over clusters, table.T
    (1000, 1000, 300, False),    # wide, 128 x 128 tiles, cp.async ring
    (1000, 8000, 304, False),    # wide, 128 x 256 tiles by TMA
    (200, 17000, 136, True),     # the same, B = table.T
])
def test_bf16_gemm_ws_equals_os_and_reruns(card, m, n, k, trans_b):
    """The plan depends on the shape alone and every partial is merged in
    split order: WS equals OS and a rerun equals the first run, bit for
    bit."""
    g = torch.Generator(device=card).manual_seed(m + n)
    a, b = _bf16_operands(g, m, n, k, trans_b)
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.bfloat16)
    got = tgemm.gemm_os(a, b, **kw)
    _close(got, gemm_ref(a, b, None, **kw), torch.bfloat16)
    assert torch.equal(got, tgemm.gemm_ws(a, b, **kw))
    assert torch.equal(got, tgemm.gemm_os(a, b, **kw))


# One shape per wide tile (the narrowest whose tiles fit one wave of
# blocks on a 132-SM card; 64 x 256 for M <= 64 past that), K split.
_WIDE_TILES = [((300, 200, 640), (128, 64)), ((256, 6912, 256), (128, 128)),
               ((256, 9000, 128), (128, 256)), ((64, 20000, 128), (64, 256))]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("case", range(len(_WIDE_TILES)))
def test_wide_gemm_tile_shapes(card, case, trans_b, dtype):
    """Each wide tile shape (two consumer warpgroups on 128 rows, or on the
    columns of 64 x 256) with B either way round: small integers make the
    fp32 sum exact, so OS, WS and a rerun equal the plain version bit for
    bit, and the fp16 / bf16 epilogue (bias, ReLU, shift 1) rounds the same
    sums the same way."""
    if torch.cuda.get_device_properties(card).multi_processor_count != 132:
        pytest.skip("the tile choices are a 132-SM H100's")
    (m, n, k), tile = _WIDE_TILES[case]
    plan = tgemm.gemm_plan(m, n, k, trans_b, dtype=dtype)
    assert plan["regime"] == "wide" and plan["tile"][:2] == tile
    assert plan["threads"] == 288 and plan["workspace_bytes"] == 0
    g = torch.Generator(device=card).manual_seed(m + n + k)
    a = torch.randint(-3, 4, (m, k), generator=g, device=card).to(dtype)
    b = torch.randint(-3, 4, (n, k) if trans_b else (k, n), generator=g,
                      device=card).to(dtype)
    b = b.T if trans_b else b
    d = torch.randint(-8, 8, (n,), generator=g, device=card).float()
    for out, kw in ((torch.float32, {}),
                    (dtype, dict(shift=1, activation=Activation.RELU))):
        args = dict(acc_dtype=torch.float32, out_dtype=out, **kw)
        got = tgemm.gemm_os(a, b, d, **args)
        torch.cuda.synchronize()
        assert torch.equal(got, gemm_ref(a, b, d, **args))
        assert torch.equal(got, tgemm.gemm_ws(a, b, d, **args))
        assert torch.equal(got, tgemm.gemm_os(a, b, d, **args))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_wide_gemm_clusters_on_concurrent_streams(card, dtype):
    """The fp16 quickstart GEMM (K split over clusters) and gemma3-1b's wq
    at M = 256, on two streams at once: the splits merge in distributed
    shared memory, so the streams share nothing and every result equals
    the single-stream one bit for bit."""
    g = torch.Generator(device=card).manual_seed(21)
    kw = dict(acc_dtype=torch.float32, out_dtype=dtype)
    inputs = []
    for m, n, k in ((1000, 512, 2048), (256, 1024, 1152)):
        assert tgemm.gemm_plan(m, n, k, dtype=dtype)["splits"] > 1
        a = torch.randn((m, k), generator=g, device=card).to(dtype)
        b = (torch.randn((k, n), generator=g, device=card) / k ** 0.5
             ).to(dtype)
        inputs.append((a, b))
    wants = [tgemm.gemm(a, b, **kw) for a, b in inputs]
    streams = [torch.cuda.Stream(card) for _ in inputs]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(8):
        for i, (st, (a, b)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(st):
                gots[i].append(tgemm.gemm(a, b, **kw))
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        for x in got:
            assert torch.equal(x, want)


@pytest.mark.parametrize("m,n,k", [(4, 1152, 6912), (256, 256, 1152)])
def test_bf16_gemm_split_on_concurrent_streams(card, m, n, k):
    """Calls that split K, on two streams at once: each stream has its own
    workspace and tickets, so every result equals the single-stream one
    bit for bit."""
    assert tgemm.gemm_plan(m, n, k)["splits"] > 1
    g = torch.Generator(device=card).manual_seed(k)
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.bfloat16)
    inputs = [_bf16_operands(g, m, n, k, False) for _ in range(2)]
    wants = [tgemm.gemm(a, b, **kw) for a, b in inputs]
    streams = [torch.cuda.Stream(card) for _ in inputs]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(8):
        for i, (st, (a, b)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(st):
                gots[i].append(tgemm.gemm(a, b, **kw))
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        for x in got:
            assert torch.equal(x, want)


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


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("count", [1, 3, 4, 5, 1021, 4099])
@pytest.mark.parametrize("acc_dtype,out_dtype", [
    (torch.int32, torch.int8), (torch.int32, torch.int16),
    (torch.int32, torch.int32), (torch.float32, torch.float32),
    (torch.float32, torch.bfloat16), (torch.float32, torch.float16)])
def test_accumulator_epilogue_misaligned_odd_lengths(card, acc_dtype,
                                                     out_dtype, count,
                                                     offset):
    """A slice that starts 0-3 elements past a 16-byte boundary, at counts
    that leave a head, a tail or no whole run of four: the scalar head and
    tail and the runs between them write every element once."""
    g = torch.Generator(device=card).manual_seed(count + offset)
    if acc_dtype == torch.int32:
        base = torch.randint(-2 ** 31, 2 ** 31 - 1, (count + 4,), generator=g,
                             device=card, dtype=torch.int32)
        kw = dict(out_dtype=out_dtype, shift=5, activation=Activation.RELU6)
    else:
        base = torch.randn((count + 4,), generator=g, device=card) * 2.0 ** 13
        kw = dict(out_dtype=out_dtype, shift=1, activation=Activation.NONE)
    acc = base[offset:offset + count]
    assert acc.data_ptr() % 16 == 4 * offset
    n0 = tgemm.accumulator_epilogue.launches
    got = tgemm.accumulator_epilogue(acc, **kw)
    assert tgemm.accumulator_epilogue.launches == n0 + 1
    # One value in, one out, no sum: every datapath is bit-exact (fp16's
    # overflows to inf included).
    assert torch.equal(got, tepi.apply(acc, **kw))


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
    """SiLU on an int32 accumulator raises ``TypeError`` before any launch,
    as the plain version and JAX do; GELU runs as JAX computes it (fp32
    on the shifted int32, clipped and truncated) and equals the plain
    version bit for bit on the GEMMs, the mvout epilogue and the conv."""
    x = torch.arange(-64, 64, dtype=torch.int8, device=card).reshape(4, 32)
    kw = dict(acc_dtype=torch.int32, out_dtype=torch.int8, shift=4,
              activation=Activation[act])
    acc = x.int() * 37
    xi, wi = x.reshape(1, 2, 2, 32), x.reshape(1, 1, 32, 4)
    calls = [(lambda fn=fn: fn(x, x.T, **kw),
              lambda: gemm_ref(x, x.T, None, **kw))
             for fn in (tgemm.gemm_os, tgemm.gemm_ws)]
    calls.append((lambda: tgemm.accumulator_epilogue(
        acc, out_dtype=torch.int8, shift=4, activation=Activation[act]),
        lambda: tepi.apply(acc, out_dtype=torch.int8, shift=4,
                           activation=Activation[act])))
    calls.append((lambda: tconv.conv2d_implicit(xi, wi, **kw),
                  lambda: tref.conv2d_ref(xi, wi, None, **kw)))
    for run, plain in calls:
        if act == "SILU":
            before = kernels.launch_counts()
            with pytest.raises(TypeError, match="float unit"):
                run()
            assert kernels.launch_counts() == before
        else:
            assert torch.equal(run(), plain())


def _ssd_inputs(card, dtype, bsz, t, h, p, g, n, seed, pad=0, resume=True):
    """x, B and C as strided views of one fused projection (``pad`` extra
    columns make its rows miss 16-byte words), dt, a_log, d_skip and the
    initial state (or None)."""
    rng = np.random.default_rng(seed)
    d_in = h * p
    fused = torch.tensor(rng.standard_normal((bsz, t, d_in + 2 * g * n + pad)),
                         dtype=torch.float32)
    fused[..., d_in:] *= 0.3
    fused = fused.to(card, dtype)
    x = fused[..., :d_in].reshape(bsz, t, h, p)
    b = fused[..., d_in:d_in + g * n].reshape(bsz, t, g, n)
    c = fused[..., d_in + g * n:d_in + 2 * g * n].reshape(bsz, t, g, n)
    dt = torch.tensor(np.abs(rng.standard_normal((bsz, t, h))) * 0.5 + 0.01,
                      dtype=torch.float32, device=card)
    a_log = torch.tensor(np.log(np.linspace(1.0, 16.0, h)),
                         dtype=torch.float32, device=card)
    d_skip = torch.tensor(rng.standard_normal(h), dtype=torch.float32,
                          device=card)
    init = torch.tensor(rng.standard_normal((bsz, h, n, p)) * 0.5,
                        dtype=torch.float32, device=card) if resume else None
    return x, dt, a_log, b, c, d_skip, init


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,h,p,g,n,chunk,pad", [
    (1000, 8, 64, 1, 128, 256, 0),    # four chunks, the last ragged
    (300, 10, 64, 1, 16, 256, 0),
    (7, 4, 8, 1, 8, 256, 1),          # rows off 16-byte words
    (70, 8, 16, 2, 32, 32, 0),        # short chunks, two groups
    (1, 4, 16, 1, 16, 256, 0),        # one token
    (64, 6, 32, 2, 128, 256, 0),      # one row tile
    (255, 8, 64, 1, 128, 256, 0),     # a ragged last row tile
    (256, 64, 64, 1, 128, 256, 0),    # mamba2-1.3b's serving call
    (1000, 64, 64, 1, 128, 256, 0),   # its widths over four chunks
    (256, 50, 64, 1, 16, 256, 0),     # hymba-1.5b's
    (257, 5, 8, 1, 16, 256, 3),       # one token into a second chunk
    (1000, 6, 32, 2, 16, 256, 0),
])
@pytest.mark.parametrize("resume", [False, True])
def test_ssd_matches_plain(card, dtype, t, h, p, g, n, chunk, pad, resume):
    """The chunked SSD kernels: ragged chunks and row tiles, grouped B/C
    (an odd number of heads per group), x/B/C read as strided views of one
    fused buffer (as the model hands them over, aligned or not), and a
    resumed segment's initial state taken into the kernel."""
    x, dt, a_log, b, c, d_skip, init = _ssd_inputs(
        card, dtype, 2, t, h, p, g, n, t + h + n, pad, resume)
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
@pytest.mark.parametrize("t", [7, 256, 600])
def test_ssd_without_skip_or_state(card, dtype, t):
    """No ``d_skip``, no initial state, no final state asked for: y alone,
    against the plain version."""
    x, dt, a_log, b, c, _, _ = _ssd_inputs(card, dtype, 1, t, 6, 16, 2, 16,
                                           t, resume=False)
    y = tm2.ssd(x, dt, a_log, b, c, chunk=256)
    want = tm2.ssd_plain(x, dt, a_log, b, c, chunk=256)
    if dtype == torch.bfloat16:
        _close(y, want, dtype)
    else:
        exact_y, _ = ssd_fp64(x, dt, a_log, b, c)
        tol = fp32_tolerance(dt, a_log, 256)
        torch.testing.assert_close(y.double(), exact_y, rtol=0,
                                   atol=tol * exact_y.abs().max().item())


def test_ssd_rerun_and_streams_are_bit_identical(card):
    """mamba2-1.3b's serving call (bf16, 256 tokens resumed) and a 1000-token
    one: a rerun, and calls on two streams at once, give the first result
    bit for bit (the kernel has no atomics; its sums run in a fixed
    order)."""
    for t in (256, 1000):
        args = _ssd_inputs(card, torch.bfloat16, 1, t, 64, 64, 1, 128, t)
        x, dt, a_log, b, c, d_skip, init = args
        kw = dict(d_skip=d_skip, initial_state=init, return_final_state=True)
        y0, s0 = tm2.ssd(x, dt, a_log, b, c, **kw)
        streams = [torch.cuda.Stream(card) for _ in range(2)]
        torch.cuda.synchronize()
        outs = []
        for _ in range(4):
            for st in streams:
                with torch.cuda.stream(st):
                    outs.append(tm2.ssd(x, dt, a_log, b, c, **kw))
        torch.cuda.synchronize()
        for y, s_ in outs:
            assert torch.equal(y, y0) and torch.equal(s_, s0)


def test_ssd_fp32_rerun_and_streams_are_bit_identical(card):
    """The fp32 kernel at mamba2-1.3b's widths (256 tokens resumed, and
    1000 fresh: four launches): a rerun, and calls on two streams at once,
    give the first result bit for bit (no atomics; every sum runs in a
    fixed order)."""
    for t, resume in ((256, True), (1000, False)):
        x, dt, a_log, b, c, d_skip, init = _ssd_inputs(
            card, torch.float32, 1, t, 64, 64, 1, 128, t, resume=resume)
        kw = dict(d_skip=d_skip, initial_state=init, return_final_state=True)
        y0, s0 = tm2.ssd(x, dt, a_log, b, c, **kw)
        streams = [torch.cuda.Stream(card) for _ in range(2)]
        torch.cuda.synchronize()
        outs = []
        for _ in range(4):
            for st in streams:
                with torch.cuda.stream(st):
                    outs.append(tm2.ssd(x, dt, a_log, b, c, **kw))
        torch.cuda.synchronize()
        for y, s_ in outs:
            assert torch.equal(y, y0) and torch.equal(s_, s0)


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
    """Calls on two streams at once, each of many splits: each stream has
    its own tickets and partials, so the two never merge each other's
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


# ---------------------------------------------------------------------------
# bf16 paged prefill: the tensor-core flash kernel through the block table
# ---------------------------------------------------------------------------
def _paged_prefill_inputs(card, page, start, t, h, kvh, d, seed):
    """q, pools and the request's table for a chunk at [start, start + t).
    The live rows (positions below start + t) sit on random pages; every
    other pool row holds NaN -- the rows of the last page past the chunk,
    every page the request does not own -- and the table's last entry,
    past the frontier, points at an all-NaN page."""
    rng = np.random.default_rng(seed)
    live = start + t
    n_live = -(-live // page)
    n_pool = n_live + 3
    pk = np.full((kvh, n_pool, page, d), np.nan, np.float32)
    pv = np.full((kvh, n_pool, page, d), np.nan, np.float32)
    order = rng.permutation(n_pool)
    table = np.empty(n_live + 1, np.int32)
    table[:n_live] = order[:n_live]
    table[n_live] = order[n_live]
    for j in range(n_live):
        rows = min(page, live - j * page)
        pk[:, table[j], :rows] = rng.standard_normal((kvh, rows, d))
        pv[:, table[j], :rows] = rng.standard_normal((kvh, rows, d))
    return (_bf16(rng, (1, t, h, d), card),
            torch.from_numpy(pk).to(card, torch.bfloat16),
            torch.from_numpy(pv).to(card, torch.bfloat16),
            torch.from_numpy(table).to(card))


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("start,t", [(0, 1), (0, 50), (0, 256), (40, 1),
                                     (40, 50), (40, 256), (768, 1),
                                     (768, 50), (768, 256)])
def test_paged_prefill_bf16_matches_plain(card, page, start, t):
    """gemma3-1b's MQA 4 / 1 at head dim 256: start 0, mid-page (40) and
    768, T of 1, 50 and 256, pages smaller and larger than a key tile; no
    NaN of a dead pool row reaches the output; one launch per call."""
    q, kp, vp, table = _paged_prefill_inputs(card, page, start, t, 4, 1, 256,
                                             start * 7 + t + page)
    n0 = tak.paged_prefill_attention.launches
    got = tak.paged_prefill_attention(q, kp, vp, table, start)
    assert tak.paged_prefill_attention.launches == n0 + 1
    _close(got, tak.paged_prefill_attention_plain(q, kp, vp, table, start),
           torch.bfloat16)


@pytest.mark.parametrize("page,start,t,h,kvh,d,window,softcap", [
    (16, 40, 50, 4, 1, 256, 24, None),       # window starts mid-page
    (64, 768, 256, 4, 1, 256, 512, None),    # gemma3-1b's local layers
    (16, 768, 256, 4, 1, 256, 100, 50.0),    # window and softcap
    (64, 768, 256, 25, 5, 64, 1024, None),   # hymba-1.5b's GQA 25 / 5
    (16, 37, 60, 25, 5, 64, 20, 30.0),       # the same, page 16
    (16, 40, 50, 4, 2, 16, 24, 30.0),        # head dim 16
    (64, 100, 77, 6, 3, 32, None, None),     # head dim 32
    (16, 13, 45, 8, 2, 64, None, 50.0),      # head dim 64, softcap
    (64, 200, 70, 2, 2, 128, 16, None),      # head dim 128, MHA
])
def test_paged_prefill_bf16_options(card, page, start, t, h, kvh, d, window,
                                    softcap):
    q, kp, vp, table = _paged_prefill_inputs(card, page, start, t, h, kvh, d,
                                             start + t + d)
    kw = dict(window=window, softcap=softcap)
    got = tak.paged_prefill_attention(q, kp, vp, table, start, **kw)
    _close(got, tak.paged_prefill_attention_plain(q, kp, vp, table, start,
                                                  **kw), torch.bfloat16)


def test_paged_prefill_bf16_rerun_is_bit_identical(card):
    """A gemma3-1b continuation chunk (T=256 at 768, page 64): the merge
    order is fixed, so two runs agree bit for bit, and equal the dense
    flash kernel on the same keys gathered beforehand."""
    q, kp, vp, table = _paged_prefill_inputs(card, 64, 768, 256, 4, 1, 256,
                                             3)
    first = tak.paged_prefill_attention(q, kp, vp, table, 768)
    assert torch.equal(first, tak.paged_prefill_attention(q, kp, vp, table,
                                                          768))
    k, v = (tak._gather(x, table[None])[:, :1024].contiguous()
            for x in (kp, vp))
    assert torch.equal(first, tak.flash_attention(q, k, v))


# ---------------------------------------------------------------------------
# the fp32 GEMM (CUDA-core FMAs): ragged shapes, both B layouts, every
# option, every split count
# ---------------------------------------------------------------------------
def _f32_operands(g, m, n, k, trans_b):
    a = torch.randn((m, k), generator=g, device=g.device)
    bt = torch.randn((n, k), generator=g, device=g.device) * k ** -0.5
    return a, (bt.T if trans_b else bt.T.contiguous())


@pytest.mark.parametrize("k", [1, 300, 1151])
@pytest.mark.parametrize("n", [77, 128, 1000])
@pytest.mark.parametrize("m", [1, 4, 17, 64, 65, 129, 256, 1000])
def test_fp32_gemm_ragged_shapes(card, m, n, k):
    """Ragged M, N and K (K = 1151: rows not 16-byte aligned, 4-byte
    copies), B row-major and as the transpose of a row-major (N, K) buffer:
    one launch per call, IEEE fp32 within the sum-order tolerance."""
    g = torch.Generator(device=card).manual_seed(m * 7 + n * 3 + k)
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.float32)
    for trans_b in (False, True):
        a, b = _f32_operands(g, m, n, k, trans_b)
        n0 = tgemm.OS_COUNTS[torch.float32].launches
        got = tgemm.gemm(a, b, **kw)
        assert tgemm.OS_COUNTS[torch.float32].launches == n0 + 1
        _close(got, gemm_ref(a, b, None, **kw), torch.float32)


@pytest.mark.parametrize("which", ["a", "b", "both"])
def test_fp32_gemm_misaligned_operands(card, which):
    """Operands 4 bytes past a 16-byte boundary: 4-byte copies, same
    result."""
    m, n, k = 70, 130, 300
    g = torch.Generator(device=card).manual_seed(len(which))
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.float32)
    a, b = _f32_operands(g, m, n, k, False)
    if which in ("a", "both"):
        flat = torch.empty(m * k + 1, device=card)
        flat[1:] = a.reshape(-1)
        a = flat[1:].view(m, k)
        assert a.data_ptr() % 16 == 4
    if which in ("b", "both"):
        flat = torch.empty(n * k + 1, device=card)
        flat[1:] = b.T.reshape(-1)
        b = flat[1:].view(n, k).T
        assert b.data_ptr() % 16 == 4
    _close(tgemm.gemm(a, b, **kw), gemm_ref(a, b, None, **kw), torch.float32)


@pytest.mark.parametrize("out", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bias", [None, "row", "full"])
@pytest.mark.parametrize("act,shift", [("NONE", 0), ("RELU", 0),
                                       ("RELU6", 2), ("GELU", 0),
                                       ("SILU", 1)])
def test_fp32_gemm_epilogue_options(card, act, shift, bias, out):
    """Bias as one row or a full (M, N) matrix, every activation, a shift,
    bf16 and fp32 outputs, both B layouts, with and without K splits."""
    g = torch.Generator(device=card).manual_seed(len(act) + shift)
    for m, n, k in ((4, 200, 1152), (100, 300, 700)):
        d = {None: None,
             "row": torch.randn((n,), generator=g, device=card),
             "full": torch.randn((m, n), generator=g, device=card)}[bias]
        kw = dict(acc_dtype=torch.float32, out_dtype=out, shift=shift,
                  activation=Activation[act])
        for trans_b in (False, True):
            a, b = _f32_operands(g, m, n, k, trans_b)
            got = tgemm.gemm(a, b, d, **kw)
            assert got.dtype == out
            _close(got, gemm_ref(a, b, d, **kw), out)


@pytest.mark.parametrize("splits", range(1, 17))
def test_fp32_gemm_every_split_count(card, splits):
    """Every split count the plan can choose (one 64 x 128 tile, ragged K)
    covers K exactly once: with small integers the fp32 sum is exact, so
    the kernel equals the plain version bit for bit; every ticket is back
    at 0 afterwards."""
    m, n, k = 64, 128, 64 * splits - 3
    plan = tgemm.gemm_plan(m, n, k, dtype=torch.float32)
    assert plan["regime"] == "fp32" and plan["splits"] == splits
    g = torch.Generator(device=card).manual_seed(splits)
    a = torch.randint(-3, 4, (m, k), generator=g, device=card).float()
    b = torch.randint(-3, 4, (k, n), generator=g, device=card).float()
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.float32)
    got = tgemm.gemm(a, b, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, gemm_ref(a, b, None, **kw))
    if splits > 1:
        ws = tgemm._WORKSPACE[(card.index or 0,
                               torch.cuda.current_stream(card).cuda_stream)]
        assert int(ws[:1024].abs().sum()) == 0


@pytest.mark.parametrize("m,n,k,trans_b", [
    (4, 1024, 1152, False),      # decode rows, K split 16 ways
    (64, 1024, 1152, False),     # wq at a 64-token prompt, K split
    (256, 8512, 2048, False),    # mamba2-1.3b's in_proj, one split
    (256, 2048, 4096, True),     # K split, B = table.T
    (256, 33000, 40, True),      # 128 x 128 tiles, B = table.T
])
def test_fp32_gemm_ws_equals_os_and_reruns(card, m, n, k, trans_b):
    """The plan depends on the shape alone and the partials merge in split
    order: WS equals OS and a rerun equals the first run, bit for bit."""
    g = torch.Generator(device=card).manual_seed(m + n)
    a, b = _f32_operands(g, m, n, k, trans_b)
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.float32)
    got = tgemm.gemm_os(a, b, **kw)
    _close(got, gemm_ref(a, b, None, **kw), torch.float32)
    assert torch.equal(got, tgemm.gemm_ws(a, b, **kw))
    assert torch.equal(got, tgemm.gemm_os(a, b, **kw))


def test_fp32_gemm_plan_tiles(card):
    """128-row tiles unless 64-row ones pad M less; K splits where the
    tiles alone leave SMs idle or end in a thin last wave, never more
    blocks than two waves' worth where tiles are few."""
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    p = tgemm.gemm_plan(64, 1024, 1152, dtype=torch.float32)
    assert p["regime"] == "fp32" and p["tile"] == (64, 128, 16)
    assert p["threads"] == 128 and 1 < p["splits"] <= 16
    assert p["grid"] == 8 * p["splits"] <= 2 * sms
    assert p["workspace_bytes"] > 0
    p = tgemm.gemm_plan(130, 1024, 1152, dtype=torch.float32)
    assert p["tile"][0] == 64                  # 192 rows, not 256
    p = tgemm.gemm_plan(256, 6912, 1152, dtype=torch.float32)
    assert p["tile"][0] == 128 and p["threads"] == 256
    p = tgemm.gemm_plan(256, 33000, 40, True, dtype=torch.float32)
    assert p["tile"][0] == 128 and p["splits"] == 1
    assert p["workspace_bytes"] == 0


@pytest.mark.parametrize("m,n,k", [(4, 1152, 6912), (64, 1024, 1152)])
def test_fp32_gemm_split_on_concurrent_streams(card, m, n, k):
    """Calls that split K, on two streams at once: each stream has its own
    workspace and tickets, so every result equals the single-stream one
    bit for bit."""
    assert tgemm.gemm_plan(m, n, k, dtype=torch.float32)["splits"] > 1
    g = torch.Generator(device=card).manual_seed(k)
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.float32)
    inputs = [_f32_operands(g, m, n, k, False) for _ in range(2)]
    wants = [tgemm.gemm(a, b, **kw) for a, b in inputs]
    streams = [torch.cuda.Stream(card) for _ in inputs]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(8):
        for i, (st, (a, b)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(st):
                gots[i].append(tgemm.gemm(a, b, **kw))
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        for x in got:
            assert torch.equal(x, want)


# ---------------------------------------------------------------------------
# the float and 16-bit datapaths: the fp16 and int16 GEMMs, int16 / fp16
# outputs, the conv on fp32, bf16, fp16 and int16 inputs
# ---------------------------------------------------------------------------
_F32, _BF16, _F16 = torch.float32, torch.bfloat16, torch.float16
_I8, _I16, _I32 = torch.int8, torch.int16, torch.int32
_DATAPATHS = {  # (input, accumulator, output)
    "fp32": (_F32, _F32, _F32), "bf16": (_BF16, _F32, _BF16),
    "fp16": (_F16, _F32, _F16), "int16": (_I16, _I32, _I16),
    "int16-int32": (_I16, _I32, _I32), "int8-int16": (_I8, _I32, _I16)}


def _dp_operands(g, dp, shape_a, shape_b, n):
    """Floats: x ~ N(0, 1), w ~ N(0, 1) / sqrt(K), a N(0, 1) bias, shift 1;
    int16: x in [-2^14, 2^14), w in [-2^8, 2^8), an int32 bias, shift 10
    (some outputs saturate); int8: full range, a bias within 2^20, shift
    7."""
    dt = _DATAPATHS[dp][0]
    k = int(np.prod(shape_b[:-1]))
    dev = g.device
    if dt.is_floating_point:
        a = torch.randn(shape_a, generator=g, device=dev).to(dt)
        b = (torch.randn(shape_b, generator=g, device=dev) * k ** -0.5).to(dt)
        return a, b, torch.randn((n,), generator=g, device=dev), 1
    lo_a, lo_b, lo_d, shift = ((2 ** 14, 2 ** 8, 2 ** 24, 10) if dt == _I16
                               else (128, 128, 2 ** 20, 7))
    a = torch.randint(-lo_a, lo_a, shape_a, generator=g, device=dev, dtype=dt)
    b = torch.randint(-lo_b, lo_b, shape_b, generator=g, device=dev, dtype=dt)
    d = torch.randint(-lo_d, lo_d, (n,), generator=g, device=dev,
                      dtype=_I32)
    return a, b, d, shift


def _close_dp(got, want, out_dtype):
    """Integers bit-exact. Floats: bf16 / fp16 one ulp of the output type
    plus 2^-14 of the largest finite magnitude, fp32 1e-5 relative plus
    1e-6 of it (the sums' order differs); infinities (an fp16 overflow) in
    the same places with the same sign."""
    assert got.dtype == want.dtype == out_dtype
    assert got.shape == want.shape
    if not out_dtype.is_floating_point:
        assert torch.equal(got, want)
        return
    g, w = got.float().cpu(), want.float().cpu()
    inf = torch.isinf(w)
    assert torch.equal(torch.isinf(g), inf) and torch.equal(g[inf], w[inf])
    g, w = g[~inf], w[~inf]
    assert torch.isfinite(g).all()
    scale = w.abs().max().item() if w.numel() else 0.0
    rtol, atol = {_BF16: (2.0 ** -7, 2.0 ** -14 * scale),
                  _F16: (2.0 ** -10, 2.0 ** -14 * scale),
                  _F32: (1e-5, 1e-6 * scale)}[out_dtype]
    torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


def _os_count(dtype):
    """The launch count an OS GEMM of ``dtype`` inputs adds to."""
    return {_I8: tgemm.gemm_os, _F32: tgemm.OS_COUNTS[_F32],
            _F16: tgemm.OS_COUNTS[_F16],
            _I16: tgemm.OS_COUNTS[_I16]}.get(dtype, tgemm.gemm)


@pytest.mark.parametrize("m,n,k,trans_b", [
    (1, 1000, 2048, False),      # the classifier (skinny / one M tile)
    (3, 77, 300, True),          # ragged, B = table.T
    (37, 77, 147, False),        # ragged, the stem's K
    (200, 136, 260, True),       # ragged, B transposed
    (1000, 512, 2048, False),    # the quickstart
    (49, 512, 4608, False),      # stage 4's 3x3 as a GEMM: K split
])
@pytest.mark.parametrize("dp", list(_DATAPATHS))
def test_datapath_gemm_matches_plain_os_equals_ws(card, dp, m, n, k,
                                                  trans_b):
    """Each datapath's GEMM at ragged M / N / K with bias, shift and ReLU:
    within its rule of the plain version, one launch per call on its
    count, WS equal to OS bit for bit, and a rerun equal to the first."""
    g = torch.Generator(device=card).manual_seed(m + n + k)
    dt, acc, out = _DATAPATHS[dp]
    a, bt, d, shift = _dp_operands(g, dp, (m, k), (n, k), n)
    b = bt.T if trans_b else bt.T.contiguous()
    kw = dict(acc_dtype=acc, out_dtype=out, shift=shift,
              activation=Activation.RELU)
    count = _os_count(dt)
    n0, w0 = count.launches, tgemm.gemm_ws.launches
    got = tgemm.gemm_os(a, b, d, **kw)
    assert count.launches == n0 + 1
    _close_dp(got, gemm_ref(a, b, d, **kw), out)
    assert torch.equal(tgemm.gemm_ws(a, b, d, **kw), got)
    assert tgemm.gemm_ws.launches == w0 + 1
    assert torch.equal(tgemm.gemm_os(a, b, d, **kw), got)


@pytest.mark.parametrize("dataflow", ["OS", "WS"])
def test_int16_gemm_split_k_wraps(card, dataflow):
    """int16 operands near 2^15 over K = 4608 (the plan splits K): every
    true sum passes 2^31, partials and the bias wrap modulo 2^32, and the
    int16 / int32 outputs equal the plain version's bit for bit; every
    ticket is back at 0."""
    m, n, k = 49, 512, 4608
    assert tgemm.gemm_plan(m, n, k, dtype=_I16)["splits"] > 1
    g = torch.Generator(device=card).manual_seed(16)
    a = torch.randint(2 ** 14, 2 ** 15, (m, k), generator=g, device=card,
                      dtype=_I16)
    b = torch.randint(2 ** 14, 2 ** 15, (k, n), generator=g, device=card,
                      dtype=_I16)
    d = torch.full((n,), 2 ** 31 - 1, dtype=_I32, device=card)
    fn = tgemm.gemm_ws if dataflow == "WS" else tgemm.gemm_os
    for out, shift in ((_I32, 0), (_I16, 3)):
        kw = dict(acc_dtype=_I32, out_dtype=out, shift=shift)
        got = fn(a, b, d, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, gemm_ref(a, b, d, **kw))
    exact = a.double() @ b.double()
    assert bool((exact > 2 ** 31).all())
    assert int((got == 32767).sum()) > 0 and int((got == -32768).sum()) > 0
    ws = tgemm._WORKSPACE[(card.index or 0,
                           torch.cuda.current_stream(card).cuda_stream)]
    assert int(ws[:1024].abs().sum()) == 0


def test_fp16_gemm_overflows_to_inf(card):
    """fp16 outputs past 65504 round to +-inf, as the plain version's
    cast does, on both dataflows."""
    g = torch.Generator(device=card).manual_seed(5)
    a = (torch.randn((64, 256), generator=g, device=card) * 60).to(_F16)
    b = (torch.randn((256, 96), generator=g, device=card) * 60).to(_F16)
    kw = dict(acc_dtype=_F32, out_dtype=_F16)
    want = gemm_ref(a, b, None, **kw)
    for fn in (tgemm.gemm_os, tgemm.gemm_ws):
        _close_dp(fn(a, b, **kw), want, _F16)
    assert bool((want == float("inf")).any() & (want == -float("inf")).any())


@pytest.mark.parametrize("which", ["a", "b"])
def test_fp16_gemm_misaligned_operands(card, which):
    """fp16 rows that are not 16-byte aligned: no tensor map, the cp.async
    ring's element loads, the same result."""
    g = torch.Generator(device=card).manual_seed(11)
    m, n, k = 100, 130, 1150
    a, b, _, _ = _dp_operands(g, "fp16", (m, k), (k, n), n)
    src = a if which == "a" else b
    flat = torch.empty(src.numel() + 2, dtype=_F16, device=card)
    flat[2:] = src.reshape(-1)
    moved = flat[2:].view(src.shape)
    assert moved.data_ptr() % 16 == 4
    a, b = (moved, b) if which == "a" else (a, moved)
    kw = dict(acc_dtype=_F32, out_dtype=_F16)
    _close_dp(tgemm.gemm(a, b, **kw), gemm_ref(a, b, None, **kw), _F16)


# gemma3-1b's serving GEMMs (7 projections x M = 4, 64, 256, and the tied
# unembedding read as table.T) and their plans on a 132-SM H100: (M, N, K,
# b_trans) -> (regime, tile, splits, grid, threads, stages, smem, workspace
# bytes). The skinny plans (M = 4) are the ones bf16 had before fp16
# shared its kernels. The wide plans are the redesign's (128 x 64 tiles
# where they fit one wave of blocks, else 128 x 128, else 128 x 256 / 64 x
# 256; two consumer warpgroups and a producer warp; no workspace): their
# K splits (None here) follow how many clusters the card holds at once,
# which its GPC layout sets, so the test holds them to the rule instead.
_GEMMA3_PLANS = {
    **{(4, n, k, False): p for n, k, p in (
        (1024, 1152, ("skinny", (8, 64, 64), 17, 272, 128, 1, 0, 561152)),
        (256, 1152, ("skinny", (8, 64, 64), 18, 72, 128, 1, 0, 151552)),
        (1152, 1024, ("skinny", (8, 64, 64), 15, 270, 128, 1, 0, 557056)),
        (6912, 1152, ("skinny", (8, 256, 64), 10, 270, 128, 1, 0, 2215936)),
        (1152, 6912, ("skinny", (8, 64, 256), 15, 270, 128, 1, 0, 557056)))},
    (4, 262144, 1152, True): ("skinny", (8, 64, 256), 1, 4096, 128, 1, 0, 0),
    **{(m, n, k, False): ("wide", tile, None, None, 288, st, 197632, 0)
       for m in (64, 256) for n, k, tile, st in (
           (1024, 1152, (128, 64, 64), 8), (256, 1152, (128, 64, 64), 8),
           (1152, 1024, (128, 64, 64), 8), (1152, 6912, (128, 64, 64), 8),
           (6912, 1152, (128, 64, 64) if m == 64 else (128, 128, 64),
            8 if m == 64 else 6))},
    (64, 262144, 1152, True): ("wide", (64, 256, 64), 1, 1024, 288, 5,
                               205824, 0),
    (256, 262144, 1152, True): ("wide", (128, 256, 64), 1, 2048, 288, 4,
                                197632, 0),
}


def test_bf16_plan_unchanged_and_fp16_takes_it(card):
    """Templating the 16-bit kernels on their element type left bf16's
    skinny plan as it was at gemma3-1b's shapes; the wide plan is the
    redesign's: the recorded tile, threads, stages and shared memory, no
    workspace, and K splits as many as fill the SMs (at most 8, each at
    least four k steps) that the card holds as clusters in one wave. fp16
    takes the same plan; int16 takes the int8 tensor-core loop's plan over
    its 2 K bytes (the byte planes): the int8 plan's regime, tile rows and
    columns, splits, grid, threads, stages and workspace, 32 k a stage,
    and shared memory of its own (no transposed B slab)."""
    if torch.cuda.get_device_properties(card).multi_processor_count != 132:
        pytest.skip("the recorded plans are a 132-SM H100's")
    keys = ("regime", "tile", "splits", "grid", "threads", "stages", "smem",
            "workspace_bytes")
    for (m, n, k, trans), want in _GEMMA3_PLANS.items():
        got = tgemm.gemm_plan(m, n, k, trans, dtype=_BF16)
        for key, w in zip(keys, want):
            assert w is None or got[key] == w, (m, n, k, trans, key)
        if want[2] is None:
            bm, bn, bk = got["tile"]
            tiles = -(-m // bm) * -(-n // bn)
            most = min(132 // tiles, -(-k // bk) // 4, 8)
            assert 1 <= got["splits"] <= max(most, 1)
            assert got["grid"] == tiles * got["splits"]
        assert tgemm.gemm_plan(m, n, k, trans, dtype=_F16) == got
    for m, n, k in ((1000, 512, 2048), (49, 512, 4608), (12544, 64, 147),
                    (1, 1000, 2048)):
        for trans in (False, True):
            p16 = tgemm.gemm_plan(m, n, k, trans, dtype=_I16)
            p8 = tgemm.gemm_s8_plan(m, n, 2 * k, trans)
            assert p16["regime"] == ("skinny" if m <= 16 else "square")
            assert p16["tile"] == (*p8["tile"][:2], 32)
            for key in ("regime", "splits", "grid", "threads", "stages",
                        "workspace_bytes"):
                assert p16[key] == p8[key], (m, n, k, trans, key)


@pytest.mark.parametrize("acc_dtype,out_dtype,shape,shift,act", [
    (_I32, _I16, (1000, 512), 9, "RELU"),
    (_I32, _I16, (3, 5, 7), 0, "RELU6"),
    (_F32, _F16, (3136, 256), 2, "GELU"),
    (_F32, _F16, (33, 65), 0, "NONE"),
])
def test_accumulator_epilogue_new_outputs(card, acc_dtype, out_dtype, shape,
                                          shift, act):
    """int32 -> int16 (saturating) and fp32 -> fp16 (magnitudes up to 2^18:
    overflow to +-inf) against the plain version."""
    g = torch.Generator(device=card).manual_seed(2)
    if acc_dtype == _I32:
        acc = torch.randint(-2 ** 31, 2 ** 31 - 1, shape, generator=g,
                            device=card, dtype=_I32)
    else:
        acc = torch.randn(shape, generator=g, device=card) * 2.0 ** \
            torch.randint(0, 19, shape, generator=g, device=card)
    kw = dict(out_dtype=out_dtype, shift=shift, activation=Activation[act])
    n0 = tgemm.accumulator_epilogue.launches
    got = tgemm.accumulator_epilogue(acc, **kw)
    assert tgemm.accumulator_epilogue.launches == n0 + 1
    _close_dp(got, tepi.apply(acc, **kw), out_dtype)


def _conv_counter(dtype):
    return tconv.conv2d_implicit if dtype == _I8 else tconv.COUNTS[dtype]


def _datapath_conv(card, dp, n, h, w, ci, co, kh, kw, stride, pad, seed,
                   act=Activation.RELU):
    """One conv of the datapath against the plain version and the host
    route (im2col, then the GEMM on OS and WS); a float conv reruns to the
    same bits."""
    g = torch.Generator(device=card).manual_seed(seed)
    dt, acc, out = _DATAPATHS[dp]
    x, wt, b, shift = _dp_operands(g, dp, (n, h, w, ci), (kh, kw, ci, co),
                                   co)
    kw_ = dict(stride=stride, padding=pad, acc_dtype=acc, out_dtype=out,
               shift=shift, activation=act)
    count = _conv_counter(dt)
    n0 = count.launches
    got = tconv.conv2d_implicit(x, wt, b, **kw_)
    assert count.launches == n0 + 1
    _close_dp(got, tref.conv2d_ref(x, wt, b, **kw_), out)
    if dt.is_floating_point:
        assert torch.equal(tconv.conv2d_implicit(x, wt, b, **kw_), got)
    a = tref.im2col(x, kh, kw, stride, pad)
    for fn in (tgemm.gemm_os, tgemm.gemm_ws):
        host = fn(a, wt.reshape(-1, co), b[None, :], acc_dtype=acc,
                  out_dtype=out, shift=shift, activation=act)
        _close_dp(host.reshape(got.shape), got, out)
    return got


@pytest.mark.parametrize("case", range(18))
@pytest.mark.parametrize("dp", ["fp32", "bf16", "fp16", "int16",
                                "int8-int16"])
def test_datapath_conv_resnet50_shapes(card, dp, case):
    """Every distinct conv of dse.resnet(50)'s stream (the stem's CI = 3,
    stage 4's 3x3 with K = 4608) on each new datapath."""
    h, ci, co, kh, stride, pad = _resnet50_conv_shapes()[case]
    _datapath_conv(card, dp, 1, h, h, ci, co, kh, kh, stride, pad, case)


@pytest.mark.parametrize("n,h,w,ci,co,kh,kw,stride,pad", [
    (2, 7, 9, 64, 24, 5, 3, 1, 2),     # padding on every border
    (1, 6, 5, 8, 40, 3, 3, 1, 1),      # CI = 8
    (2, 9, 9, 12, 16, 3, 3, 2, 1),     # CI = 12: no 16-byte granule
    (1, 10, 10, 3, 16, 7, 7, 2, 3),    # CI = 3: the strip loader
    (1, 8, 8, 5, 24, 3, 3, 1, 1),      # CI = 5, odd: 16-bit strips
    (1, 9, 7, 6, 16, 3, 3, 1, 1),      # CI = 6: 16-bit strips
    (1, 7, 7, 9, 24, 3, 3, 1, 1),      # CI = 9: 16-bit element loads
    (1, 5, 5, 64, 16, 3, 3, 1, 1),     # deep narrow, K = 576 split
    (3, 4, 4, 20, 8, 1, 1, 1, 0),      # 1x1, CI = 20: the matrix loader
    (1, 9, 9, 32, 16, 1, 1, 2, 0),     # 1x1 strided: the tap gather
])
@pytest.mark.parametrize("dp", ["fp32", "bf16", "fp16", "int16"])
def test_datapath_conv_edges(card, dp, n, h, w, ci, co, kh, kw, stride, pad):
    _datapath_conv(card, dp, n, h, w, ci, co, kh, kw, stride, pad, h * w + ci,
                   act=Activation.RELU6)


def test_int16_conv_wraps_and_saturates(card):
    """A 3x3 int16 conv whose every true sum passes 2^31: the int32
    accumulator wraps and the int16 output saturates, bit-exact."""
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randint(2 ** 14, 2 ** 15, (1, 14, 14, 64), generator=g,
                      device=card, dtype=_I16)
    wt = torch.randint(2 ** 14, 2 ** 15, (3, 3, 64, 32), generator=g,
                       device=card, dtype=_I16)
    kw_ = dict(acc_dtype=_I32, out_dtype=_I16, shift=6)
    got = tconv.conv2d_implicit(x, wt, **kw_)
    assert torch.equal(got, tref.conv2d_ref(x, wt, None, **kw_))
    assert int((got == 32767).sum()) > 0 and int((got == -32768).sum()) > 0


# ---------------------------------------------------------------------------
# the CUDA-core conv's own plan (fp32, int16) and the strip loader of the
# stem (CI = 3) on every datapath
# ---------------------------------------------------------------------------
def _resnet50_conv_gemms():
    """(label, (M, N, K)) of each distinct layer of dse.resnet(50)'s stream,
    as chip_smoke.py's phase 6 runs them."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return [(label, mnk) for label, mnk, _, _ in cs.resnet50_shapes()]


@pytest.mark.parametrize("case", range(18))
def test_cuda_core_conv_plan_resnet50_shapes(card, case):
    """The fp32 / int16 conv's plan at each distinct layer: 56 x 64 tiles
    (7 x 8 micro-tiles: 64 columns where CO = 64) of 256 threads, no split
    longer than 512 k (the fp32 chains), the SMs all but filled on
    stages 3 and 4 (M = 196, 49), the workspace its splits need, and
    int16's plan equal to fp32's but for the shared memory."""
    label, (m, n, k) = _resnet50_conv_gemms()[case]
    p = tconv.conv_plan(m, n, k, _F32)
    p16 = tconv.conv_plan(m, n, k, _I16)
    assert {**p, "smem": 0} == {**p16, "smem": 0}    # int16's ring is half
    bm, bn, bk = p["tile"]
    assert p["regime"] == "cuda cores" and (bm, bn, bk) == (56, 64, 16)
    assert p["threads"] == 256
    tiles = -(-m // bm) * -(-n // bn)
    assert p["grid"] == tiles * p["splits"]
    assert -(-k // (16 * p["splits"])) * 16 <= 512
    if m in (196, 49):
        # power-of-two splits of the stage's 8-64 tiles: 128 blocks on
        # the H100's 132 SMs, or 256 two an SM (an uneven split that
        # reached 132 measured slower: tools/conv_phases.py --splits)
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        assert p["grid"] >= 0.96 * sms, (label, p)
    want_ws = 4 * (1024 + p["grid"] * bm * bn) if p["splits"] > 1 else 0
    assert p["workspace_bytes"] == want_ws


@pytest.mark.parametrize("n,h,w,co,kh,stride", [
    (1, 224, 224, 64, 7, 2),    # ResNet-50's stem
    (2, 37, 37, 24, 7, 2),      # batch 2: tiles across images, ragged M
    (3, 19, 23, 16, 7, 1),      # stride 1, W != H
    (1, 30, 30, 130, 5, 2),     # CO ragged past two column tiles
])
@pytest.mark.parametrize("dp", ["fp32", "bf16", "fp16", "int16",
                                "int8-int16"])
def test_conv_strip_loader(card, dp, n, h, w, co, kh, stride):
    """CI = 3 with padding 3: every datapath's conv reads the image through
    the strip loader (strips staged in shared memory, zeros in the
    padding), within its rule of the plain version, equal to the host
    route on OS and on WS, and a rerun to the same bits."""
    _datapath_conv(card, dp, n, h, w, 3, co, kh, kh, stride, 3,
                   h * w + co + kh)


@pytest.mark.parametrize("dp", ["fp32", "fp16", "int16", "int8-int16"])
def test_conv_strip_loader_unaligned_image(card, dp):
    """The stem read from an image one element into its buffer (no row or
    strip 16-byte aligned): the strips' windows keep each address's
    residue, and the result equals the aligned image's."""
    g = torch.Generator(device=card).manual_seed(11)
    dt, acc, out = _DATAPATHS[dp]
    x, wt, b, shift = _dp_operands(g, dp, (1, 41, 41, 3), (7, 7, 3, 64), 64)
    buf = torch.zeros(x.numel() + 1, dtype=dt, device=card)
    buf[1:] = x.flatten()
    xo = buf[1:].view(x.shape)
    kw_ = dict(stride=2, padding=3, acc_dtype=acc, out_dtype=out,
               shift=shift, activation=Activation.RELU)
    got = tconv.conv2d_implicit(xo, wt, b, **kw_)
    _close_dp(got, tref.conv2d_ref(x, wt, b, **kw_), out)
    assert torch.equal(got, tconv.conv2d_implicit(x, wt, b, **kw_))


def _chip_smoke():
    """``chip_smoke.py`` as a module (its profiler helpers)."""
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_profile_call_retakes_a_short_window(card):
    """``chip_smoke.profile_call`` holds each profiler window to the launch
    counters' growth over its passes. A window in which the counters grew
    by one launch more than the profiler could see (a counted launch that
    never ran, standing in for one the profiler lost) is taken again; a
    call whose windows all stay short fails rather than report a device
    time."""
    cs = _chip_smoke()
    g = torch.Generator(device=card).manual_seed(5)
    a, b = _bf16_operands(g, 256, 1024, 1152, False)
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.bfloat16)
    calls = [0]

    def short_once():
        # profile_call runs fn once, then 5 timed walls, then per window a
        # warm-up pass and 3 profiled ones: call 9 is the first window's
        # second profiled pass
        calls[0] += 1
        tgemm.gemm(a, b, **kw)
        if calls[0] == 9:
            tgemm.gemm.launches += 1

    out = cs.profile_call(torch, "short once", short_once, quiet=True)
    assert calls[0] == 14 and out["windows"] == 2
    assert out["launches_by_kernel"]["gemm"] == 1

    def always_short():
        tgemm.gemm(a, b, **kw)
        tgemm.gemm.launches += 1

    with pytest.raises(SystemExit):
        cs.profile_call(torch, "always short", always_short, quiet=True)


# ---------------------------------------------------------------------------
# the int16 GEMM on the int8 tensor cores (byte planes): full range, ragged
# and misaligned operands, every output, shift and activation, streams
# ---------------------------------------------------------------------------
def _i16_full_range(g, shape, card):
    """int16 over its whole range, with the first row all -32768 and the
    second all 32767 (both byte planes at their ends)."""
    x = torch.randint(-2 ** 15, 2 ** 15, shape, generator=g, device=card,
                      dtype=_I16)
    x[0] = -2 ** 15
    if shape[0] > 1:
        x[1] = 2 ** 15 - 1
    return x


@pytest.mark.parametrize("out", [_I32, _I16, _I8])
@pytest.mark.parametrize("act", ["NONE", "RELU", "RELU6"])
@pytest.mark.parametrize("m,n,k,trans_b", [
    (5, 70, 37, False),          # skinny, K not a multiple of 32
    (3, 77, 100, True),          # skinny, B = table.T
    (130, 72, 4608, False),      # square, K split, every true sum wraps
    (67, 129, 1000, True),       # ragged past a tile, K not of 64
])
def test_int16_gemm_full_range(card, out, act, m, n, k, trans_b):
    """Full-range operands (rows of -32768 and of 32767 on both sides) and
    a full-range int32 bias, every output type, shifts 0 / 7 / 31 and each
    activation: bit-exact against the plain version, OS equal to WS, one
    launch per call on gemm[int16]."""
    g = torch.Generator(device=card).manual_seed(m * n + k)
    a = _i16_full_range(g, (m, k), card)
    bt = _i16_full_range(g, (n, k), card)
    b = bt.T if trans_b else bt.T.contiguous()
    d = torch.randint(-2 ** 31, 2 ** 31 - 1, (n,), generator=g, device=card,
                      dtype=_I32)
    if k == 4608:     # the planes' rows against the planes' columns
        assert (a[:2].double() @ b[:, :2].double()).abs().min() > 2 ** 31
    for shift in (0, 7, 31):
        kw = dict(acc_dtype=_I32, out_dtype=out, shift=shift,
                  activation=Activation[act])
        n0 = tgemm.OS_COUNTS[_I16].launches
        got = tgemm.gemm_os(a, b, d, **kw)
        assert tgemm.OS_COUNTS[_I16].launches == n0 + 1
        assert torch.equal(got, gemm_ref(a, b, d, **kw)), shift
        assert torch.equal(tgemm.gemm_ws(a, b, d, **kw), got)


@pytest.mark.parametrize("trans_b", [False, True])
@pytest.mark.parametrize("offset_a,offset_b", [(1, 0), (0, 1), (3, 5)])
def test_int16_gemm_misaligned_operands(card, trans_b, offset_a, offset_b):
    """A and B read from buffers an odd number of elements in (no 16-byte
    granule) and rows of odd stride: the 8-, 4- and byte copies of the
    ring, bit-exact against the plain version on both dataflows."""
    g = torch.Generator(device=card).manual_seed(offset_a * 10 + offset_b)
    m, n, k = 45, 66, 301
    abuf = _i16_full_range(g, (m * k + offset_a,), card)
    bbuf = _i16_full_range(g, (n * k + offset_b,), card)
    a = abuf[offset_a:].view(m, k)
    bt = bbuf[offset_b:].view(n, k)
    b = bt.T if trans_b else bbuf[offset_b:].view(k, n)
    kw = dict(acc_dtype=_I32, out_dtype=_I16, shift=9,
              activation=Activation.RELU)
    want = gemm_ref(a, b, None, **kw)
    assert torch.equal(tgemm.gemm_os(a, b, **kw), want)
    assert torch.equal(tgemm.gemm_ws(a, b, **kw), want)


def test_int16_gemm_reruns_and_streams_are_bit_identical(card):
    """The quickstart shape and a K-split shape, each on its own stream,
    eight times over at once: every result equals the plain version's
    (each stream has its own tickets and partials)."""
    shapes = ((1000, 512, 2048), (49, 512, 4608))
    assert tgemm.gemm_plan(49, 512, 4608, dtype=_I16)["splits"] > 1
    g = torch.Generator(device=card).manual_seed(21)
    inputs = [(_i16_full_range(g, (m, k), card),
               _i16_full_range(g, (k, n), card)) for m, n, k in shapes]
    kw = dict(acc_dtype=_I32, out_dtype=_I32)
    wants = [gemm_ref(a, b, None, **kw) for a, b in inputs]
    streams = [torch.cuda.Stream(card) for _ in inputs]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(8):
        for i, (st, (a, b)) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(st):
                gots[i].append(tgemm.gemm_os(a, b, **kw))
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        for x in got:
            assert torch.equal(x, want)


# ---------------------------------------------------------------------------
# fp32 flash and paged prefill: the CUDA-core flash kernel (row tiles of a
# kv head's query heads, key tiles over warps and clusters)
# ---------------------------------------------------------------------------
def _f32(rng, shape, card):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32,
                        device=card)


@pytest.mark.parametrize("rep", [1, 2, 5, 8])
@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("b,tq,tk,causal,window,softcap", [
    (1, 37, 37, True, None, None),      # ragged rows
    (2, 20, 75, True, 16, 30.0),        # right-aligned, window, softcap
    (1, 9, 300, False, None, None),     # few rows, many keys: clusters
    (1, 130, 130, False, 40, None),     # non-causal window
])
def test_flash_fp32_matches_plain(card, rep, d, b, tq, tk, causal, window,
                                  softcap):
    """GQA 1 / 2 / 5 / 8 at every head dim, causal or not, windows and
    softcap, ragged Tq / Tk: the fp32 rule of the plain version, one launch
    per call, a rerun equal bit for bit."""
    rng = np.random.default_rng(rep * 1000 + d + tq + tk)
    kvh = 2 if rep < 8 else 1
    q = _f32(rng, (b, tq, rep * kvh, d), card)
    k, v = (_f32(rng, (b, tk, kvh, d), card) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=softcap)
    n0 = tak.flash_attention.launches
    got = tak.flash_attention(q, k, v, **kw)
    assert tak.flash_attention.launches == n0 + 1
    _close(got, tak.blockwise_attention(q, k, v, **kw), torch.float32)
    assert torch.equal(got, tak.flash_attention(q, k, v, **kw))


def _paged_prefill_f32(card, page, start, t, h, kvh, d, seed):
    """_paged_prefill_inputs' layout (dead rows NaN) in fp32."""
    q, kp, vp, table = _paged_prefill_inputs(card, page, start, t, h, kvh, d,
                                             seed)
    rng = np.random.default_rng(seed + 1)
    live = ~torch.isnan(kp.float())
    kp, vp = (torch.where(live, torch.from_numpy(
        rng.standard_normal(kp.shape)).to(card, torch.float32),
        torch.full_like(kp, float("nan"), dtype=torch.float32))
        for _ in range(2))
    return _f32(rng, (1, t, h, d), card), kp, vp, table


@pytest.mark.parametrize("page", [16, 64])
@pytest.mark.parametrize("rep", [1, 2, 5, 8])
@pytest.mark.parametrize("start,t,d,window,softcap", [
    (0, 50, 64, None, None),            # a fresh chunk
    (12, 8, 16, 8, 50.0),               # the gate's last chunk
    (40, 1, 32, None, None),            # one row, mid-page
    (768, 256, 64, 1024, None),         # hymba-1.5b's continuation chunk
    (200, 70, 128, 16, None),           # head dim 128, a short window
    (100, 33, 256, None, 30.0),         # head dim 256, softcap
])
def test_paged_prefill_fp32_matches_plain(card, page, rep, start, t, d,
                                          window, softcap):
    """Start offsets, pages 16 / 64, GQA 1 / 2 / 5 / 8 and every head dim:
    no NaN of a dead pool row reaches the output, the fp32 rule of the
    plain version, one launch per call, a rerun equal bit for bit."""
    kvh = 2 if rep < 8 else 1
    q, kp, vp, table = _paged_prefill_f32(card, page, start, t, rep * kvh,
                                          kvh, d, start + t + d + rep)
    kw = dict(window=window, softcap=softcap)
    n0 = tak.paged_prefill_attention.launches
    got = tak.paged_prefill_attention(q, kp, vp, table, start, **kw)
    assert tak.paged_prefill_attention.launches == n0 + 1
    _close(got, tak.paged_prefill_attention_plain(q, kp, vp, table, start,
                                                  **kw), torch.float32)
    assert torch.equal(got, tak.paged_prefill_attention(q, kp, vp, table,
                                                        start, **kw))


def test_fp32_attention_on_concurrent_streams(card):
    """fp32 flash at hymba-1.5b's first chunk and fp32 paged prefill at its
    continuation chunk, each on its own stream, eight times over at once:
    every result equals the first run bit for bit."""
    rng = np.random.default_rng(25)
    q = _f32(rng, (1, 256, 25, 64), card)
    k, v = (_f32(rng, (1, 256, 5, 64), card) for _ in range(2))
    qp, kp, vp, table = _paged_prefill_f32(card, 64, 768, 256, 25, 5, 64, 9)
    calls = [lambda: tak.flash_attention(q, k, v, window=1024),
             lambda: tak.paged_prefill_attention(qp, kp, vp, table, 768,
                                                 window=1024)]
    wants = [fn() for fn in calls]
    streams = [torch.cuda.Stream(card) for _ in calls]
    torch.cuda.synchronize()
    gots = [[], []]
    for _ in range(8):
        for i, (st, fn) in enumerate(zip(streams, calls)):
            with torch.cuda.stream(st):
                gots[i].append(fn())
    torch.cuda.synchronize()
    for got, want in zip(gots, wants):
        for x in got:
            assert torch.equal(x, want)


@pytest.mark.parametrize("arch", ["gemma3-1b", "hymba-1.5b",
                                  "granite-moe-3b-a800m"])
def test_guard_rerun_launches_the_steps_kernels(card, arch):
    """The NaN guard's re-run of a poisoned step launches the kernels its
    primary call launched, as many times (hymba-1.5b: attention and the
    SSD; granite: the fp32 router GEMM too, and its dispatch writes each
    expert row once, so the re-run routes and sums as the primary call
    did), and gives the primary call's logits bit for bit from the
    restored state; every poisoned step falls back once and every request
    finishes with the unfaulted run's tokens."""
    from repro_torch import configs
    from repro_torch.serving import ServingEngine

    def serve(plan):
        eng = ServingEngine(configs.get_smoke(arch), device=card,
                            max_slots=2, max_context=96, page_size=8,
                            prefill_chunk=8, faults=plan)
        primary, fallback = eng._dispatch, eng._dispatch_fallback
        last = {}

        def watch_primary(which, args):
            before = kernels.launch_counts()
            logits, state = primary(which, args)
            last["grew"] = {k: v - before[k] for k, v in
                            kernels.launch_counts().items() if v > before[k]}
            last["logits"] = None if logits is None else logits.clone()
            return logits, state

        def watch_fallback(which, args):
            before = kernels.launch_counts()
            logits, state = fallback(which, args)
            grew = {k: v - before[k] for k, v in
                    kernels.launch_counts().items() if v > before[k]}
            assert grew == last["grew"] and grew, which
            assert torch.equal(logits, last["logits"]), which
            return logits, state

        eng._dispatch, eng._dispatch_fallback = watch_primary, watch_fallback
        rng = np.random.default_rng(3)
        for n in (30, 7):
            eng.submit(rng.integers(0, 128, (n,)).astype(np.int32), 5)
        return eng.run()

    rep, clean = serve("seed=1;inf@prefill:max=1;nan@chunk:max=1;"
                       "nan@decode:max=1"), serve(None)
    assert all(r["status"] == "finished" for r in rep["requests"])
    # A first chunk that samples no token has no logits to poison.
    assert rep["summary"]["fallbacks"] == sum(rep["faults"].values()) >= 2
    assert [np.asarray(r["tokens"]).tolist() for r in rep["requests"]] == \
        [np.asarray(r["tokens"]).tolist() for r in clean["requests"]]


@pytest.mark.parametrize("top_k,shared", [(8, False), (1, True)])
def test_moe_apply_on_card(card, top_k, shared):
    """The MoE layer at granite's widths (d 1536, 40 experts in 48 slots,
    expert d_ff 512) on 37 tokens in bf16 under the serving engine config:
    the router launches the fp32 GEMM once, no token goes to a padded
    slot, a second call equals the first bit for bit (no atomics), and the
    output is within the bf16 rule of the plain path on the CPU. The
    llama4 form (top-1 sigmoid on the input, a shared expert) the same."""
    from repro_torch.core.config import GemminiConfig
    from repro_torch.core.context import ExecutionContext
    from repro_torch.models import moe

    gen = torch.Generator(device=card).manual_seed(top_k)
    p = moe.moe_init(gen, 1536, 512, 40, ep=16, n_shared=int(shared),
                     dtype=torch.bfloat16, device=card)
    x = torch.randn((1, 37, 1536), generator=gen, device=card).to(
        torch.bfloat16)
    ctx = ExecutionContext(cfg=GemminiConfig(
        input_dtype="bf16", acc_dtype="fp32", output_dtype="bf16"))
    kw = dict(n_experts=40, top_k=top_k, router_weights_before=shared,
              dropless=True)
    count = tgemm.OS_COUNTS[torch.float32]
    n0 = count.launches
    got = moe.moe_apply(ctx, p, x, **kw)
    assert count.launches == n0 + 1
    assert torch.equal(moe.moe_apply(ctx, p, x, **kw), got)
    _, idx = moe.route(ctx, p, x[0], n_experts=40, top_k=top_k)
    assert int(idx.max()) < 40
    p_cpu = {k: ({kk: vv.cpu() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.cpu()) for k, v in p.items()}
    cpu = moe.moe_apply(ctx, p_cpu, x.cpu(), **kw)
    _, cpu_idx = moe.route(ctx, p_cpu, x[0].cpu(), n_experts=40,
                           top_k=top_k)
    # A bf16 router logit may round either way on the two sides (their
    # fp32 sums run in other orders), and a token whose choices differ is
    # held to nothing here. The others: relative L2 within one bf16 step,
    # the gap of operands rounded to bf16 at the same points from sums in
    # other orders.
    same = (cpu_idx == idx.cpu()).all(dim=-1)
    assert same.float().mean() > 0.9
    g, w = got[0].float().cpu()[same], cpu[0].float()[same]
    assert torch.isfinite(g).all()
    assert ((g - w).norm() / w.norm()).item() <= 2.0 ** -7


def test_moe_expert_products_backward_on_card(card):
    """The expert products' fp32-output ``bmm`` of bf16 operands
    (``moe._bmm_f32``), which has no derivative of its own: both
    gradients bit for bit the route autograd takes with the operands
    widened to fp32 (the CPU's), at granite's widths (48 slots, 37 rows,
    d 1536, d_ff 512). The forward sums the same exact bf16 products in
    fp32 in another order (tensor cores against CUDA cores): within 4
    sqrt(K) fp32 ulps relative L2, the size of two summation orders'
    gap over K = 1536 terms."""
    from repro_torch.models import moe

    gen = torch.Generator(device=card).manual_seed(29)
    a = torch.randn((48, 37, 1536), generator=gen, device=card).to(
        torch.bfloat16).requires_grad_(True)
    b = (torch.randn((48, 1536, 512), generator=gen, device=card) *
         1536 ** -0.5).to(torch.bfloat16).requires_grad_(True)
    g = torch.randn((48, 37, 512), generator=gen, device=card)
    got = moe._bmm_f32(a, b)
    ga, gb = torch.autograd.grad(got, (a, b), g)
    want = torch.bmm(a.to(torch.float32), b.to(torch.float32))
    wa, wb = torch.autograd.grad(want, (a, b), g)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    assert ((got - want).norm() / want.norm()).item() <= \
        4 * 1536 ** 0.5 * 2.0 ** -24
    assert torch.equal(ga, wa) and torch.equal(gb, wb)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,k,n,b_trans", [(37, 45, 29, False),
                                           (37, 45, 29, True),
                                           (4096, 1152, 6912, False)])
def test_gemm_backward_matches_plain(card, dtype, m, k, n, b_trans):
    """The engine GEMM under grad (a bias row on the D input): dA and dB
    launch the kernels (``gemm[bwd]`` counts two launches) and equal the
    plain versions of the same products on the card, by the dtype's rule;
    the bias's gradient is dC's fp32 row sum. A small ragged shape with B
    row-major and read transposed (the tied unembedding's layout), and
    gemma3-1b's wi at the training phase's 4 x 1024 token rows."""
    g = torch.Generator(device=card).manual_seed(m + n)
    a = torch.randn((m, k), generator=g, device=card).to(dtype)
    b = (torch.randn((n, k), generator=g, device=card) * k ** -0.5
         ).to(dtype)
    b = b.T if b_trans else b.T.contiguous()
    d = torch.randn((n,), generator=g, device=card).to(dtype)
    dc = (torch.randn((m, n), generator=g, device=card) * 1e-2).to(dtype)
    leaves = [x.clone().requires_grad_(True) for x in (a, b, d)]
    n0 = tgemm.BWD_COUNT.launches
    c = tgemm.gemm(*leaves, acc_dtype=torch.float32, out_dtype=dtype)
    c.backward(dc)
    torch.cuda.synchronize()
    assert tgemm.BWD_COUNT.launches == n0 + 2
    kw = dict(acc_dtype=torch.float32, out_dtype=dtype)
    _close(leaves[0].grad, gemm_ref(dc, b.t(), None, **kw), dtype)
    _close(leaves[1].grad, gemm_ref(a.t(), dc, None, **kw), dtype)
    _close(leaves[2].grad, dc.float().sum(0).to(dtype), dtype)
    assert [x.grad.dtype for x in leaves] == [dtype] * 3


def test_smoke_train_step_matches_cpu(card):
    """One fp32 training step of smoke gemma3-1b on the card and on the
    CPU from the same weights and batch: loss within 1e-5 relative, every
    gradient leaf within 1e-4 relative L2 (the kernels and the CPU sum in
    other orders), and the card launched the fp32 GEMM and its backward
    products (``remat`` recomputes each block: 7 more a layer)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.core import tree as tu
    from repro_torch.core.config import GemminiConfig
    from repro_torch.core.context import ExecutionContext
    from repro_torch.launch import steps

    cfg = dataclasses.replace(configs.get_smoke("gemma3-1b"),
                              dtype=torch.float32)
    ctx = ExecutionContext(cfg=GemminiConfig(
        input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32"))
    params = steps.init_train_state(cfg, seed=3, device="cpu").params
    toks = torch.randint(0, cfg.vocab, (2, 24),
                         generator=torch.Generator().manual_seed(3),
                         dtype=torch.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        p = tu.tree_map(lambda t: t.to(dev), params)
        kernels.reset_launch_counts()
        loss, grads = steps.loss_and_grads(
            ctx, cfg, p, {"tokens": toks.to(dev), "labels": toks.to(dev)})
        out[dev] = loss.cpu(), [x.cpu() for x in tu.leaves(grads)], \
            kernels.launch_counts()
    (lc, gc, counts), (lp, gp, _) = out["cuda"], out["cpu"]
    fwd = 7 * cfg.n_layers + 1
    assert counts["gemm[fp32]"] == fwd + 7 * cfg.n_layers
    assert counts["gemm[bwd]"] == 2 * fwd
    torch.testing.assert_close(lc, lp, rtol=1e-5, atol=0)
    for x, y in zip(gc, gp):
        assert ((x - y).norm() / y.norm().clamp_min(1e-30)).item() <= 1e-4


# ---------------------------------------------------------------------------
# plans named by the caller (the tuner's schedules)
# ---------------------------------------------------------------------------
def _gemm_case(card, dtype, m, n=200, k=600, b_trans=False, seed=0):
    """Operands and a runner of one GEMM datapath: (run(plan), plain, kind,
    plan function)."""
    g = torch.Generator(device=card).manual_seed(seed)
    if dtype in (torch.int8, torch.int16):
        a = torch.randint(-100, 100, (m, k), generator=g, device=card,
                          dtype=torch.int32).to(dtype)
        bb = torch.randint(-100, 100, (n, k) if b_trans else (k, n),
                           generator=g, device=card,
                           dtype=torch.int32).to(dtype)
        d = torch.randint(-1000, 1000, (n,), generator=g, device=card,
                          dtype=torch.int32)
        kw = dict(acc_dtype=torch.int32, out_dtype=torch.int32)
    else:
        a = torch.randn((m, k), generator=g, device=card).to(dtype)
        bb = torch.randn((n, k) if b_trans else (k, n), generator=g,
                         device=card).to(dtype)
        d = torch.randn((n,), generator=g, device=card)
        kw = dict(acc_dtype=torch.float32, out_dtype=torch.float32)
    b = bb.t() if b_trans else bb

    def run(plan=None):
        return tgemm.gemm_os(a, b, d, plan=plan, **kw)

    def plan_of(**o):
        if dtype == torch.int8:
            return tgemm.gemm_s8_plan(m, n, k, b_trans, card, **o)
        return tgemm.gemm_plan(m, n, k, b_trans, card, dtype, **o)
    plain = gemm_ref(a.cpu(), b.cpu(), d.cpu(), **kw)
    return run, plain, a, b, plan_of


def _check_gemm(got, plain, a, b, dtype):
    if dtype in (torch.int8, torch.int16):
        assert torch.equal(got.cpu(), plain)
    else:
        _close_bf16_gemm(got, plain, a.cpu(), b.cpu(), torch.float32)


_REGIMES = [(torch.bfloat16, 4), (torch.bfloat16, 256), (torch.float16, 100),
            (torch.float32, 4), (torch.float32, 256), (torch.int8, 4),
            (torch.int8, 256), (torch.int16, 100)]


@pytest.mark.parametrize("dtype,m", _REGIMES)
@pytest.mark.parametrize("b_trans", [False, True])
def test_gemm_plan_equal_to_default_is_bit_identical(card, dtype, m,
                                                     b_trans):
    """The shape's own plan named explicitly launches the same kernel on
    the same grid: bit for bit the output of a call that names none."""
    run, _, _, _, plan_of = _gemm_case(card, dtype, m, b_trans=b_trans)
    own = plan_of()
    named = {"tile": own["tile_code"], "splits": own["splits"]}
    assert plan_of(**named)["grid"] == own["grid"]
    assert torch.equal(run(named), run())
    assert torch.equal(run({"tile": 0, "splits": 0}), run())


# A plan other than the shape's own, per regime: (tile code, splits).
_OTHER = {(torch.bfloat16, 4): [(1, 1), (1, 3)],
          (torch.bfloat16, 256): [(2, 1), (3, 5), (4, 2), (2, 8)],
          (torch.float16, 100): [(5, 3), (3, 1)],
          (torch.float32, 4): [(1, 7), (2, 1)],
          (torch.float32, 256): [(2, 3), (1, 16)],
          (torch.int8, 4): [(2, 3), (1, 9)],
          (torch.int8, 256): [(1, 2), (2, 5)],
          (torch.int16, 100): [(1, 4), (2, 13)]}


@pytest.mark.parametrize("dtype,m", _REGIMES)
def test_gemm_other_plans_match_plain(card, dtype, m):
    """Each GEMM regime at plans it would not pick itself: the float sums
    in another order within the sum-order bound, int32 bit for bit."""
    for b_trans in (False, True):
        run, plain, a, b, plan_of = _gemm_case(card, dtype, m,
                                               b_trans=b_trans)
        for tile, splits in _OTHER[(dtype, m)]:
            p = plan_of(tile=tile, splits=splits)
            assert (p["tile_code"], p["splits"]) == (tile, splits)
            _check_gemm(run({"tile": tile, "splits": splits}), plain, a, b,
                        dtype)


@pytest.mark.parametrize("dtype,m,tile,splits", [
    (torch.bfloat16, 256, 2, 9),       # past WD_MAX_SPLITS
    (torch.bfloat16, 256, 1, 1),       # the skinny kernel above M = 16
    (torch.bfloat16, 4, 3, 1),         # a wide tile at M <= 16
    (torch.bfloat16, 256, 6, 1),       # no such tile
    (torch.bfloat16, 256, 2, 0),       # a tile without splits
    (torch.float32, 256, 3, 1),
    (torch.float32, 256, 1, 17),       # past sgemm's MAX_SPLITS
    (torch.int8, 256, 2, 17),          # past igemm's MAX_SPLITS
    (torch.int8, 4, 1, 20),            # more splits than k steps (10)
    (torch.int16, 100, 0, 2)])         # splits without a tile
def test_gemm_illegal_plan_raises(card, dtype, m, tile, splits):
    """A plan the kernel cannot run raises, from the plan function and
    from the launch; nothing is clamped or replaced."""
    run, _, _, _, plan_of = _gemm_case(card, dtype, m)
    with pytest.raises(RuntimeError):
        plan_of(tile=tile, splits=splits)
    with pytest.raises(RuntimeError):
        run({"tile": tile, "splits": splits})


def _conv_case(card, dtype, shape, seed=0):
    n, h, ci, co, kh, stride, pad = shape
    g = torch.Generator(device=card).manual_seed(seed)
    if dtype in (torch.int8, torch.int16):
        x = torch.randint(-100, 100, (n, h, h, ci), generator=g, device=card,
                          dtype=torch.int32).to(dtype)
        w = torch.randint(-100, 100, (kh, kh, ci, co), generator=g,
                          device=card, dtype=torch.int32).to(dtype)
        b = torch.randint(-1000, 1000, (co,), generator=g, device=card,
                          dtype=torch.int32)
        kw = dict(acc_dtype=torch.int32, out_dtype=torch.int32)
    else:
        x = torch.randn((n, h, h, ci), generator=g, device=card).to(dtype)
        w = torch.randn((kh, kh, ci, co), generator=g, device=card).to(dtype)
        b = torch.randn((co,), generator=g, device=card)
        kw = dict(acc_dtype=torch.float32, out_dtype=torch.float32)
    kw.update(stride=stride, padding=pad)
    plain = tref.conv2d_ref(x.cpu(), w.cpu(), b.cpu(), **kw)
    oh = (h + 2 * pad - kh) // stride + 1
    mnk = (n * oh * oh, co, kh * kh * ci)
    return (lambda plan=None: tconv.conv2d_implicit(x, w, b, plan=plan,
                                                    **kw)), plain, mnk


# the stem (a 3-channel tap: strips), a 3x3 layer and a 1x1 layer
_CONVS = [(1, 32, 3, 64, 7, 2, 3), (1, 14, 64, 64, 3, 1, 1),
          (2, 7, 128, 96, 1, 1, 0)]


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16,
                                   torch.float32, torch.int16])
@pytest.mark.parametrize("shape", _CONVS)
def test_conv_plans(card, dtype, shape):
    """The conv at its own plan named explicitly (bit for bit the call
    that names none), at other plans (against the plain version: int32
    exact, floats within 1e-4 relative of the largest magnitude), and an
    illegal plan raises."""
    run, plain, (m, n, k) = _conv_case(card, dtype, shape)
    own = tconv.conv_plan(m, n, k, dtype, card)
    named = {"tile": own["tile_code"], "splits": own["splits"]}
    assert torch.equal(run(named), run())
    cc = dtype in (torch.float32, torch.int16)
    others = [(1, 1), (1, 2), (1, 4)] if cc else [(1, 2), (2, 1), (2, 2)]
    for tile, splits in others:
        got = run({"tile": tile, "splits": splits}).cpu()
        if dtype in (torch.int8, torch.int16):
            assert torch.equal(got, plain)
        else:
            scale = plain.abs().max().item()
            tol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
            torch.testing.assert_close(got.float(), plain.float(), rtol=tol,
                                       atol=1e-4 * scale)
    with pytest.raises(RuntimeError):
        run({"tile": 2 if cc else 3, "splits": 1})
    with pytest.raises(RuntimeError):
        run({"tile": 1, "splits": 64})


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 256])
def test_flash_plans(card, dtype, d):
    """Flash attention at its own (cluster, stages) named explicitly (bit
    for bit), at every other plan of the space (against the plain version),
    and illegal plans raise."""
    from repro_torch.tune import schedules
    g = torch.Generator(device=card).manual_seed(d)
    b, tq, tk, h, kvh = 2, 200, 300, 4, 2
    q = torch.randn((b, tq, h, d), generator=g, device=card).to(dtype)
    k = torch.randn((b, tk, kvh, d), generator=g, device=card).to(dtype)
    v = torch.randn((b, tk, kvh, d), generator=g, device=card).to(dtype)
    kw = dict(causal=True, window=128)
    own = tak.flash_plan(b, tq, tk, h, kvh, d, dtype=dtype, device=card,
                         **kw)
    base = tak.flash_attention(q, k, v, **kw)
    assert torch.equal(tak.flash_attention(q, k, v, plan=own, **kw), base)
    want = tak.blockwise_attention(q.cpu(), k.cpu(), v.cpu(), **kw)
    for plan in schedules.enumerate_attn_schedules(dtype, d)[1:]:
        _close(tak.flash_attention(q, k, v, plan=plan, **kw), want, dtype)
    bad = [{"cluster": 3, "stages": 1}, {"cluster": 8, "stages": 1},
           {"cluster": 1, "stages": 3}]
    if dtype == torch.float32 and d == 256:
        bad.append({"cluster": 1, "stages": 2})
    for plan in bad:
        with pytest.raises(RuntimeError):
            tak.flash_attention(q, k, v, plan=plan, **kw)


def test_decode_split_plans(card):
    """The paged decode kernel at its own 64 keys per split named
    explicitly (bit for bit), at other splits (against the plain version),
    and an illegal split raises."""
    rng = np.random.default_rng(0)
    kvh, h, d, page, mp = 1, 4, 256, 16, 40
    lens = [600, 37, 1, 640]
    pk, pv, tables = _pools(rng, kvh, 200, page, d, lens, mp)
    dt = torch.bfloat16
    q = torch.tensor(rng.standard_normal((4, 1, h, d)), device=card).to(dt)
    pk, pv = (torch.tensor(x, device=card).to(dt) for x in (pk, pv))
    tables = torch.tensor(tables, device=card)
    lengths = torch.tensor(lens, dtype=torch.int32, device=card)
    for window in (None, 100):
        base = tak.paged_decode_attention(q, pk, pv, tables, lengths,
                                          window=window)
        same = tak.paged_decode_attention(q, pk, pv, tables, lengths,
                                          window=window,
                                          plan={"split_keys": 64})
        assert torch.equal(same, base)
        want = tak.paged_decode_attention_plain(
            q.cpu(), pk.cpu(), pv.cpu(), tables.cpu(), lengths.cpu(),
            window=window)
        for split in (16, 48, 128, 512):
            _close(tak.paged_decode_attention(
                q, pk, pv, tables, lengths, window=window,
                plan={"split_keys": split}), want, dt)
    for split in (8, 24, 8192):
        with pytest.raises(RuntimeError):
            tak.paged_decode_attention(q, pk, pv, tables, lengths,
                                       plan={"split_keys": split})


def test_tuner_full_mode_on_card(card, tmp_path):
    """Under ``full`` the first call of a shape measures its space on the
    card and persists the winner, the second only looks it up; the output
    holds against the plain version. A tuned winner, read back by a fresh
    cache, is the plan that won, and in a fresh measurement (interleaved
    with the shape's own plan) it is within TIE_BAND of that plan. ``off``
    never consults the tuner."""
    from repro_torch.core import flags
    from repro_torch.tune import cache as tcache
    from repro_torch.tune import measure, schedules, tuner
    prev = flags.get("tune_mode"), flags.get("tune_cache")
    flags.set_flag("tune_cache", str(tmp_path / "plans.json"))
    tcache.reset_cache()
    calls = {"n": 0}
    real = measure.time_callable

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)
    measure.time_callable = counting
    try:
        run, plain, a, b, _ = _gemm_case(card, torch.bfloat16, 256)
        flags.set_flag("tune_mode", "full")
        got = run()
        first = calls["n"]
        assert first > 1
        _check_gemm(got, plain, a, b, torch.bfloat16)
        run()
        assert calls["n"] == first
        dtypes = (torch.bfloat16, torch.float32, torch.float32)
        rep = tuner._tune_gemm(dtypes, False, 256, 200, 600, True, False,
                               card)
        tcache.reset_cache()
        assert tcache.get_cache().lookup_schedule(rep.cache_key, ()) == \
            rep.winner
        case = measure.gemm_case(dtypes, False, 256, 200, 600, True, False,
                                 card)
        t = ([], [])
        for r in range(4):
            for i in ((0, 1) if r % 2 == 0 else (1, 0)):
                t[i].append(real(case, (schedules.STATIC, rep.winner)[i],
                                 device=card)["min_us"])
        assert min(t[1]) <= min(t[0]) * (1 + tuner.TIE_BAND)
        flags.set_flag("tune_mode", "off")
        n0 = calls["n"]
        assert torch.equal(run(), run({"tile": 0, "splits": 0}))
        assert calls["n"] == n0
    finally:
        measure.time_callable = real
        flags.set_flag("tune_mode", prev[0])
        flags.set_flag("tune_cache", prev[1])
        tcache.reset_cache()


# ---------------------------------------------------------------------------
# the launch contracts held to the C plan functions (chip_smoke phase 17's
# checks (a) and (d) on one probe plan per kernel family)
# ---------------------------------------------------------------------------
def _family_probe(family):
    """The family's first plan the lint admits that splits its sum through
    tickets (or clusters), else its first admitted plan."""
    from repro_torch.analysis.lint import checks, driver
    first = None
    for pr in driver.probes(("gemm",) if family.startswith("gemm")
                            else (family,)):
        if pr.family != family:
            continue
        c = pr.contract()
        if not checks.admits(c) or c.needs_card:
            continue
        if any(r.via != "none" for r in c.reductions):
            return pr
        first = first or pr
    return first


@pytest.mark.parametrize("family", [
    "gemm", "gemm_s8", "conv2d_implicit", "flash_attention",
    "decode_attention", "paged_decode_attention", "paged_prefill_attention",
    "ssd", "accumulator_epilogue"])
def test_contract_agrees_with_c_plan_and_tickets_return(card, family):
    from repro_torch.analysis.lint import card as lcard
    pr = _family_probe(family)
    counts = dict(plans=0, admitted=0, refused=0, needs_card=0,
                  card_refused=0, c_disagree=0, launched=0)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    launcher = lcard.Launcher(torch, torch.device(
        "cuda", torch.cuda.current_device()),
        ssd_exact=(ssd_fp64, fp32_tolerance))
    c = lcard.check_plan(torch, pr, sms, counts, print, launcher, [])
    assert c is not None and counts["launched"] == 1
    assert counts["c_disagree"] == 0


# ---------------------------------------------------------------------------
# the generic datapath (csrc/datapath.cu) and fp16 through the attention and
# SSD kernels
# ---------------------------------------------------------------------------
def _bits_equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    if not got.is_floating_point():
        return torch.equal(got, want)
    ints = {2: torch.int16, 4: torch.int32}[got.element_size()]
    return torch.equal(got.view(ints), want.view(ints))


def _counted(name, fn):
    before = kernels.launch_counts()[name]
    out = fn()
    torch.cuda.synchronize()
    assert kernels.launch_counts()[name] > before, name
    return out


@pytest.mark.parametrize("combo", [
    # (a) the product on an existing loop, the sum rounded or wrapped
    (torch.bfloat16, torch.bfloat16, torch.bfloat16, torch.bfloat16),
    (torch.int8, torch.int8, torch.int16, torch.int8),
    (torch.float32, torch.float32, torch.float16, torch.int8),
    # (b) int32 inputs on the CUDA-core loop
    (torch.int32, torch.int32, torch.int32, torch.int16),
    (torch.int32, torch.int32, torch.float32, torch.float16),
    # (d) mixed input dtypes converted first
    (torch.int8, torch.float16, torch.float32, torch.float32),
    (torch.float16, torch.bfloat16, torch.int32, torch.int32)],
    ids=lambda c: str(c).split(".")[-1])
@pytest.mark.parametrize("dataflow", ["OS", "WS"])
def test_generic_gemm_mechanisms_match_plain(card, combo, dataflow):
    """Each mechanism of the generic datapath against the plain version:
    bit for bit where the product sums in an integer dtype, else within the
    coarsest float's rule; OS and WS alike."""
    from repro_torch.core.config import Dataflow

    ia, ib, acc, out = combo
    g = torch.Generator(device=card).manual_seed(30)
    m, n, k = 77, 200, 300

    def draw(dtype, shape):
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g, device=card).to(dtype)
        return torch.randint(-100, 100, shape, generator=g, device=card,
                             dtype=dtype)
    a, b = draw(ia, (m, k)), draw(ib, (k, n))
    d = torch.randn((n,), generator=g, device=card) * 50
    kw = dict(acc_dtype=acc, out_dtype=out, shift=1,
              activation=Activation.RELU)
    got = tgemm.gemm(a, b, d, dataflow=Dataflow[dataflow], **kw)
    want = gemm_ref(a, b, d, **kw)
    dot = tref.product_dtypes(ia, ib, acc)
    if not dot.is_floating_point:
        assert _bits_equal(got, want)
        return
    g_, w_ = got.double().cpu(), want.double().cpu()
    finite = torch.isfinite(w_)
    assert torch.equal(torch.isfinite(g_), finite)
    ulp = max({torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(t,
              1e-5) for t in (dot, acc, out) if t.is_floating_point)
    scale = w_[finite].abs().max().item()
    atol = (1e-6 if ulp == 1e-5 else 2.0 ** -14) * scale + \
        (0.0 if out.is_floating_point else 1.0)
    assert ((g_ - w_)[finite].abs() <=
            ulp * w_[finite].abs() + atol).all()


def test_generic_conv_int32_and_bf16_accumulator_match_plain(card):
    """(b) the int32 conv (one launch, bit for bit) and a bf16 accumulator
    on the bf16 conv's wide sum plus the generic epilogue."""
    g = torch.Generator(device=card).manual_seed(31)
    x = torch.randint(-500, 500, (1, 14, 14, 32), generator=g, device=card,
                      dtype=torch.int32)
    w = torch.randint(-500, 500, (3, 3, 32, 24), generator=g, device=card,
                      dtype=torch.int32)
    b = torch.randint(-1000, 1000, (24,), generator=g, device=card,
                      dtype=torch.int32)
    kw = dict(acc_dtype=torch.int32, out_dtype=torch.int32, stride=1,
              padding=1, shift=3, activation=Activation.RELU)
    got = _counted("conv2d_implicit[int32]",
                   lambda: tconv.conv2d_implicit(x, w, b, **kw))
    assert _bits_equal(got, tref.conv2d_ref(x, w, b, **kw))
    xb, wb = x.to(torch.bfloat16) / 64, w.to(torch.bfloat16) / 512
    kw.update(acc_dtype=torch.bfloat16, out_dtype=torch.bfloat16)
    got = _counted("epilogue[any]",
                   lambda: tconv.conv2d_implicit(xb, wb, b, **kw))
    _close(got, tref.conv2d_ref(xb, wb, b, **kw), torch.bfloat16)


@pytest.mark.parametrize("pair", [(torch.int8, torch.bfloat16),
                                  (torch.int16, torch.int8),
                                  (torch.float32, torch.int32),
                                  (torch.bfloat16, torch.float16),
                                  (torch.float16, torch.float32)],
                         ids=lambda p: str(p).split(".")[-1])
def test_generic_epilogue_and_convert_bit_for_bit(card, pair):
    """(c) accumulator_epilogue on other accumulators (GELU included) and
    (d) the conversion, each bit for bit against the plain version."""
    from repro_torch.kernels import datapath as tdp

    acc, out = pair
    g = torch.Generator(device=card).manual_seed(32)
    x = (torch.randn((999, 513), generator=g, device=card) * 60)
    x = x.to(acc) if acc.is_floating_point else x.round().to(acc)
    for act in (Activation.RELU, Activation.GELU):
        kw = dict(out_dtype=out, shift=2, activation=act)
        got = _counted("epilogue[any]",
                       lambda: tgemm.accumulator_epilogue(x, **kw))
        assert _bits_equal(got, tepi.apply(x, **kw)), act
    got = _counted("convert", lambda: tdp.convert(x, out))
    assert _bits_equal(got, tepi.convert(x, out))
    t = x[:, :500].t()                          # a strided view, read as is
    assert _bits_equal(tdp.convert(t, out), tepi.convert(t, out))


def _close_f16(got, want):
    assert got.dtype == torch.float16
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    scale = w.abs().max().item()
    torch.testing.assert_close(g, w, rtol=2.0 ** -10,
                               atol=2.0 ** -14 * scale)


def test_fp16_attention_kernels_match_plain(card):
    """fp16 through flash, paged prefill, paged decode and dense decode,
    each counted under its [fp16] counter, against the plain versions."""
    g = torch.Generator(device=card).manual_seed(33)

    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=card) * scale).to(
            torch.float16)
    q, k, v = r(1, 96, 8, 128), r(1, 96, 2, 128), r(1, 96, 2, 128)
    got = _counted("flash_attention[fp16]",
                   lambda: tak.flash_attention(q, k, v, window=40))
    _close_f16(got, tak.blockwise_attention(q, k, v, window=40))
    kp, vp = r(2, 20, 16, 128), r(2, 20, 16, 128)
    table = torch.randperm(20, generator=g, device=card)[:8].to(torch.int32)
    qp = r(1, 30, 8, 128)
    got = _counted("paged_prefill_attention[fp16]",
                   lambda: tak.paged_prefill_attention(qp, kp, vp, table, 50))
    _close_f16(got, tak.paged_prefill_attention_plain(qp, kp, vp, table, 50))
    tables = torch.randperm(20, generator=g, device=card)[:12].reshape(
        3, 4).to(torch.int32)
    lens = torch.tensor([40, 1, 64], dtype=torch.int32, device=card)
    qd = r(3, 1, 8, 128)
    got = _counted("paged_decode_attention[fp16]",
                   lambda: tak.paged_decode_attention(qd, kp, vp, tables,
                                                      lens))
    _close_f16(got, tak.paged_decode_attention_plain(qd, kp, vp, tables,
                                                     lens))
    got = _counted("decode_attention[fp16]",
                   lambda: tak.decode_attention(qd[:1], k, v, 90, window=64))
    _close_f16(got, tak.decode_attention_plain(qd[:1], k, v, 90, window=64))


def test_fp16_flash_stress_row_spanning_20_decades(card):
    """A causal 2048-key row whose softmax spans more than 20 decades: the
    fp16 kernel's P = P_hi + P_lo stays finite and within the fp16 rule."""
    g = torch.Generator(device=card).manual_seed(34)
    q, k = (torch.randn((1, 2048, n, 256), generator=g, device=card)
            .mul(4).to(torch.float16) for n in (4, 1))
    v = torch.randn((1, 2048, 1, 256), generator=g, device=card).to(
        torch.float16)
    s = (q[0, -1, 0].float() @ k[0, :, 0].float().T) / 16
    assert (s.max() - s.min()).item() / np.log(10.0) > 20
    got = tak.flash_attention(q, k, v)
    _close_f16(got, tak.blockwise_attention(q, k, v))


def test_fp16_ssd_and_its_stress_state_past_fp16_range(card):
    """fp16 x, B, C on the fp32 kernel (widened exactly): y within the fp16
    rule of the plain version, and a chunk whose state passes 65504 stays
    finite with its fp32 state within the fp64 recurrence's tolerance."""
    g = torch.Generator(device=card).manual_seed(35)
    t, h, p, gg, n = 128, 8, 64, 1, 64
    x = (1000 + 1000 * torch.rand((1, t, h, p), generator=g, device=card)
         ).to(torch.float16)
    b = torch.ones((1, t, gg, n), dtype=torch.float16, device=card)
    c = (torch.randn((1, t, gg, n), generator=g, device=card) * 1e-3).to(
        torch.float16)
    dt = torch.nn.functional.softplus(torch.randn((1, t, h), generator=g,
                                                  device=card))
    a_log = torch.log(torch.linspace(1e-3, 1e-2, h, device=card))
    d = torch.ones((h,), device=card)
    y, st = _counted("ssd[fp16]", lambda: tm2.ssd(
        x, dt, a_log, b, c, d_skip=d, chunk=t, return_final_state=True))
    wy = tm2.ssd_plain(x, dt, a_log, b, c, d_skip=d, chunk=t)
    _close_f16(y, wy)
    assert torch.isfinite(st).all() and st.abs().max().item() > 65504
    _, exact = ssd_fp64(x, dt, a_log, b, c, d_skip=d)
    tol = fp32_tolerance(dt, a_log, t)
    assert (st.double() - exact).abs().max().item() <= \
        tol * exact.abs().max().item()


# ---------------------------------------------------------------------------
# the last kernel shapes: any head dim, unaligned operands, mixed dtypes,
# the SSD's head dim, state and chunk
# ---------------------------------------------------------------------------
_F16 = torch.float16


def _close_out(got, want):
    """By the output dtype: bf16 one bf16 ulp (2^-7 relative), fp16 one
    fp16 ulp (2^-10), fp32 1e-5 relative; each plus 2^-14 (fp32: 1e-5) of
    the largest magnitude (the sum orders differ)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    g, w = got.float().cpu(), want.float().cpu()
    assert torch.isfinite(g).all()
    scale = w.abs().max().item()
    rtol, atol = {torch.bfloat16: (2.0 ** -7, 2.0 ** -14 * scale),
                  _F16: (2.0 ** -10, 2.0 ** -14 * scale)}.get(
                      got.dtype, (1e-5, 1e-5 * scale))
    torch.testing.assert_close(g, w, rtol=rtol, atol=atol)


def _offset(t, off):
    """``t``'s values in a buffer ``off`` elements past a 16-byte boundary
    (a contiguous view the kernels must read element by element)."""
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def _attn_inputs(card, rng, d, qd, kd, off=0):
    """The four launchers' operands at head dim d: flash (2 x 40 x 8 /
    2 heads), dense decode (2 x 1 against 70 keys), paged decode (3 slots)
    and paged prefill (20 tokens at 50) over pools with NaN pages."""
    h, kvh, page, mp = 8, 2, 16, 6
    lens = [70, 0, 33]
    pk, pv, tables = _pools(rng, kvh, 24, page, d, lens, mp)

    def dev(x, dt):
        return _offset(torch.from_numpy(np.asarray(x, np.float32)).to(
            card, dt), off)
    return dict(
        q=dev(rng.standard_normal((2, 40, h, d)), qd),
        k=dev(rng.standard_normal((2, 40, kvh, d)), kd),
        v=dev(rng.standard_normal((2, 40, kvh, d)), kd),
        qd=dev(rng.standard_normal((2, 1, h, d)), qd),
        kc=dev(rng.standard_normal((2, 70, kvh, d)), kd),
        vc=dev(rng.standard_normal((2, 70, kvh, d)), kd),
        qs=dev(rng.standard_normal((3, 1, h, d)), qd),
        qp=dev(rng.standard_normal((1, 20, h, d)), qd),
        pk=dev(pk, kd), pv=dev(pv, kd),
        tables=torch.from_numpy(tables).to(card),
        lens=torch.tensor(lens, dtype=torch.int32, device=card))


def _attn_calls(e, kw):
    """(name, kernel call, plain call) of each launcher."""
    return [
        ("flash_attention",
         lambda: tak.flash_attention(e["q"], e["k"], e["v"], **kw),
         lambda: tak.blockwise_attention(e["q"], e["k"], e["v"], **kw)),
        ("decode_attention",
         lambda: tak.decode_attention(e["qd"], e["kc"], e["vc"], 60, **kw),
         lambda: tak.decode_attention_plain(e["qd"], e["kc"], e["vc"], 60,
                                            **kw)),
        ("paged_decode_attention",
         lambda: tak.paged_decode_attention(e["qs"], e["pk"], e["pv"],
                                            e["tables"], e["lens"], **kw),
         lambda: tak.paged_decode_attention_plain(
             e["qs"], e["pk"], e["pv"], e["tables"], e["lens"], **kw)),
        ("paged_prefill_attention",
         lambda: tak.paged_prefill_attention(e["qp"], e["pk"], e["pv"],
                                             e["tables"][0], 50, **kw),
         lambda: tak.paged_prefill_attention_plain(
             e["qp"], e["pk"], e["pv"], e["tables"][0], 50, **kw))]


def _grew(name, before, mixed=False, dtype=None):
    key = f"{name}[mixed]" if mixed else \
        f"{name}[fp16]" if dtype == _F16 else name
    return kernels.launch_counts()[key] == before[key] + 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, _F16, torch.float32])
@pytest.mark.parametrize("d", [8, 20, 48, 80, 200, 320, 512])
def test_attention_any_head_dim(card, d, dtype):
    """Every launcher at head dims between and past the compiled ones
    (320 and 512: the fp32 instance at 512, 16-bit operands widened),
    with a window and a softcap: one launch each, counted by q's dtype."""
    e = _attn_inputs(card, np.random.default_rng(d), d, dtype, dtype)
    for name, run, plain in _attn_calls(e, dict(window=24, softcap=30.0)):
        before = kernels.launch_counts()
        got = run()
        assert _grew(name, before, dtype=dtype), name
        _close_out(got, plain())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 80])
def test_attention_unaligned_operands(card, d, dtype):
    """Operands 2 elements past a 16-byte boundary: the element-by-element
    loads, the same result as the aligned call."""
    rng = np.random.default_rng(7)
    aligned = _attn_inputs(card, rng, d, dtype, dtype)
    shifted = {k: (_offset(v, 2) if v.is_floating_point() else v)
               for k, v in aligned.items()}
    assert shifted["q"].data_ptr() % 16 != 0
    kw = dict(window=None, softcap=None)
    for (name, run, plain), (_, run_s, _) in zip(
            _attn_calls(aligned, kw), _attn_calls(shifted, kw)):
        got = run_s()
        _close_out(got, plain())
        _close_out(got, run())


@pytest.mark.parametrize("qd,kd", [(torch.bfloat16, torch.float32),
                                   (torch.float32, _F16),
                                   (_F16, torch.bfloat16)])
@pytest.mark.parametrize("d", [64, 96])
def test_attention_mixed_dtypes(card, d, qd, kd):
    """q in one dtype, k / v in another: the fp32 kernel on widened
    operands, the output in q's dtype, counted in ``[mixed]``."""
    e = _attn_inputs(card, np.random.default_rng(d), d, qd, kd)
    for name, run, plain in _attn_calls(e, dict(window=24, softcap=None)):
        before = kernels.launch_counts()
        got = run()
        assert _grew(name, before, mixed=True), name
        _close_out(got, plain())


def _shape_ssd_inputs(card, seed, t, h, g, n, p, xd, bd, resume, off=0):
    gen = torch.Generator(device=card).manual_seed(seed)

    def randn(*shape, dtype=torch.float32, scale=1.0):
        x = torch.randn(shape, generator=gen, device=card) * scale
        return _offset(x.to(dtype), off)
    x = randn(1, t, h, p, dtype=xd)
    b = randn(1, t, g, n, dtype=bd, scale=0.3)
    c = randn(1, t, g, n, dtype=bd, scale=0.3)
    dt = torch.nn.functional.softplus(torch.randn((1, t, h), generator=gen,
                                                  device=card))
    a_log = torch.log(torch.linspace(1.0, 16.0, h, device=card))
    d_skip = torch.ones((h,), device=card)
    init = torch.randn((1, h, n, p), generator=gen, device=card) * 0.5 \
        if resume else None
    return x, dt, a_log, b, c, d_skip, init


def _check_ssd(got, x, dt, a_log, b, c, d_skip, init, chunk):
    """y against the plain version at the chunk asked for (the output
    dtype's rule); y in fp32 and the final state against the fp64
    recurrence within ``fp32_tolerance``."""
    want = tm2.ssd_plain(x, dt, a_log, b, c, d_skip=d_skip, chunk=chunk,
                         initial_state=init)
    exact_y, exact_s = ssd_fp64(x, dt, a_log, b, c, d_skip=d_skip,
                                initial_state=init)
    tol = fp32_tolerance(dt, a_log, chunk)
    if got[0].dtype == torch.float32:
        pairs = ((got[0], exact_y), (got[1], exact_s))
    else:
        _close_out(got[0], want)
        pairs = ((got[1], exact_s),)
    for v, ex in pairs:
        err = (v.double() - ex).abs().max().item()
        assert torch.isfinite(v).all() and err <= tol * ex.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t,h,n,p,chunk,resume", [
    (600, 4, 256, 128, 512, True),    # two slices, two sub-chunks + ragged
    (256, 4, 128, 96, 256, False),    # a half-filled second slice
    (300, 4, 200, 24, 300, True),     # P 24 on the 32-wide instance
    (100, 4, 64, 10, 64, True),       # P 10: element rows and states
    (80, 2, 256, 8, 80, False)])
def test_ssd_any_head_dim_state_and_chunk(card, t, h, n, p, chunk, resume,
                                          dtype):
    args = _shape_ssd_inputs(card, p + n, t, h, 1, n, p, dtype, dtype, resume)
    before = kernels.launch_counts()["ssd"]
    got = tm2.ssd(*args[:5], d_skip=args[5], chunk=chunk,
                  initial_state=args[6], return_final_state=True)
    assert kernels.launch_counts()["ssd"] == before + 1
    _check_ssd(got, *args, chunk)


@pytest.mark.parametrize("xd,bd", [(torch.float32, torch.bfloat16),
                                   (torch.bfloat16, torch.float32)])
def test_ssd_mixed_dtypes(card, xd, bd):
    args = _shape_ssd_inputs(card, 3, 300, 4, 2, 128, 64, xd, bd, True)
    before = kernels.launch_counts()["ssd[mixed]"]
    got = tm2.ssd(*args[:5], d_skip=args[5], chunk=256,
                  initial_state=args[6], return_final_state=True)
    assert kernels.launch_counts()["ssd[mixed]"] == before + 1
    assert got[0].dtype == xd
    _check_ssd(got, *args, 256)


def test_wrappers_raise_nowhere_on_a_seeded_grid(card):
    """32 draws of (head dim 1..512, q / k / v dtypes, alignment) through
    the four attention launchers and 32 of (P 1..256, N 1..256, chunk
    1..600, x / B / C dtypes, alignment) through the SSD: every call
    launches and matches its plain version."""
    rng = np.random.default_rng(2026)
    floats = [torch.bfloat16, _F16, torch.float32]
    for _ in range(32):
        d = int(rng.integers(1, 513))
        qd, kd = (floats[i] for i in rng.integers(0, 3, 2))
        off = int(rng.integers(0, 2)) * 2
        e = _attn_inputs(card, rng, d, qd, kd, off)
        for name, run, plain in _attn_calls(e, dict(window=None,
                                                    softcap=None)):
            _close_out(run(), plain())
    for _ in range(32):
        p, n = (int(v) for v in rng.integers(1, 257, 2))
        t = int(rng.integers(1, 601))
        chunk = int(rng.integers(1, 601))
        xd, bd = (floats[i] for i in rng.integers(0, 3, 2))
        args = _shape_ssd_inputs(card, int(rng.integers(0, 1 << 30)), t, 2,
                                 1, n, p, xd, bd, bool(rng.integers(0, 2)),
                                 int(rng.integers(0, 2)))
        got = tm2.ssd(*args[:5], d_skip=args[5], chunk=chunk,
                      initial_state=args[6], return_final_state=True)
        _check_ssd(got, *args, chunk)
