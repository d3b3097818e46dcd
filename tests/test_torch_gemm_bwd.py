"""The engine GEMM's backward products against JAX, and the contract
mirror of the backward kernel's plan, on the CPU.

(a) ``kernels.gemm.gemm`` under grad (``_GemmGrad``: ``grad_a`` /
``grad_b``) at the operand layouts the card's backward kernel
(``csrc/hgemm_bwd.cuh``) takes, against ``jax.vjp`` of the JAX package's
``repro.kernels.ref.gemm_ref`` on the same numpy inputs from a seed. On the
CPU both products run the plain version; the layouts are those the card
reads in place: a row-major weight (read as its transpose for dA), the tied
unembedding's ``table.T`` (dA reads the table row-major; dB is written in
the table's own layout), a dC that is the transpose of a row-major buffer,
and dB with K <= N and with K > N. Tolerances: fp32 1e-5 of the largest
magnitude (MKL and XLA's dot sum in other orders); bf16 one bf16 ulp of
the value (2^-7 relative) plus 2^-14 of the largest magnitude (a sum in
another order may round to the neighbouring bf16 value).

(b) The plan's contract (``kernels.contracts.gemm_bwd_geometry`` /
``gemm_bwd_schedule``, the mirror of ``hgemm_bwd::plan`` and its walk) at
gemma3-1b's 16 training products and at ragged shapes, on the H100 SXM's
132 SMs, the H100 PCIe's 114 and half a card's 66: every (tile, k step) is
computed exactly once, each stream-K block's share is within one k step
of the mean (the data-parallel blocks' tile counts equal), a split tile's
partials are added in k order by the block holding its first k steps, and
the contract lints clean.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import gemm_ref as jgemm_ref

from repro_torch.analysis.lint import checks
from repro_torch.kernels import contracts as kc
from repro_torch.kernels import gemm as tgemm

_JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _draw(rng, shape, dtype):
    """Normal values rounded to ``dtype`` through fp32 on both sides."""
    x = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(dtype)
    return t, np.asarray(jnp.asarray(x).astype(_JDT[dtype]))


def _close(got, want, dtype):
    g = got.detach().float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    scale = float(np.abs(w).max())
    rtol, atol = ((2.0 ** -7, 2.0 ** -14 * scale) if dtype == torch.bfloat16
                  else (0.0, 1e-5 * scale))
    assert g.shape == w.shape
    np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)


# (m tokens, k in, n out, the weight's layout, dC's layout)
LAYOUTS = {
    "weight_rows": (48, 24, 40, "rows", "rows"),        # dB with K <= N
    "weight_rows_k_gt_n": (48, 40, 24, "rows", "rows"),  # mlp.wo: K > N
    "tied_table": (48, 24, 72, "table", "rows"),        # B = table.T
    "dc_transposed": (48, 24, 40, "rows", "transposed"),
    "tied_table_dc_transposed": (40, 32, 56, "table", "transposed"),
}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_backward_products_match_jax(case, dtype):
    m, k, n, w_layout, dc_layout = LAYOUTS[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    a_t, a_j = _draw(rng, (m, k), dtype)
    if w_layout == "rows":
        w_t, w_j = _draw(rng, (k, n), dtype)
    else:
        w_t, w_j = _draw(rng, (n, k), dtype)        # the table, (vocab, d)
    dc_t, dc_j = _draw(rng, (m, n) if dc_layout == "rows" else (n, m), dtype)
    if dc_layout == "transposed":
        dc_t, dc_j = dc_t.t(), dc_j.T
        assert dc_t.stride(0) == 1

    a = a_t.clone().requires_grad_(True)
    w = w_t.clone().requires_grad_(True)
    b = w if w_layout == "rows" else w.T
    c = tgemm.gemm(a, b, acc_dtype=torch.float32, out_dtype=dtype)
    c.backward(dc_t)

    def f(a_, w_):
        b_ = w_ if w_layout == "rows" else w_.T
        return jgemm_ref(a_, b_, None, acc_dtype=jnp.float32,
                         out_dtype=_JDT[dtype])
    out, vjp = jax.vjp(f, jnp.asarray(a_j), jnp.asarray(w_j))
    ga, gw = vjp(jnp.asarray(dc_j))
    _close(c, out, dtype)
    assert a.grad.dtype == dtype and w.grad.dtype == dtype
    assert a.grad.shape == a.shape and w.grad.shape == w.shape
    _close(a.grad, ga, dtype)
    _close(w.grad, gw, dtype)


def test_grad_b_writes_the_parameter_layout_on_the_cpu_as_before():
    """On the CPU ``grad_b`` keeps the plain version's orientation rule
    (A^T @ dC where K <= N, else (dC^T @ A)^T); ``trans`` only names the
    parameter's layout for the card's kernel and changes no value."""
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((32, 40)).astype(np.float32))
    dc = torch.from_numpy(rng.standard_normal((32, 24)).astype(np.float32))
    plain = tgemm.grad_b(a, dc, torch.float32)
    assert torch.equal(tgemm.grad_b(a, dc, torch.float32, trans=True), plain)
    assert torch.equal(plain, (dc.t() @ a).t())


@pytest.mark.parametrize("case,route", [
    ("rows", "persistent"), ("transposed", "persistent"),
    ("fp32", "forward"), ("rows16", "forward"), ("odd_rows", "forward"),
    ("mixed", "forward"), ("strided", "forward")])
def test_backward_route_by_shape_and_layout(case, route):
    """The card's route for a backward product, from dtype, shape and
    strides alone (``bwd_route``): the backward kernel wherever a tensor
    map describes both operands and M > 16; the forward kernels for fp32,
    M <= 16, rows that are not whole 16-byte words (granite's vocab of
    49155) and mixed dtypes."""
    bf16 = torch.bfloat16
    a = torch.zeros(64, 96, dtype=bf16)
    b = torch.zeros(96, 48, dtype=bf16)
    if case == "transposed":
        a, b = torch.zeros(96, 64, dtype=bf16).t(), \
            torch.zeros(48, 96, dtype=bf16).t()
    elif case == "fp32":
        a, b = a.float(), b.float()
    elif case == "rows16":
        a = a[:16]
    elif case == "odd_rows":
        b = torch.zeros(96, 49155, dtype=bf16)
    elif case == "mixed":
        b = b.half()
    elif case == "strided":
        a = torch.zeros(64, 192, dtype=bf16)[:, ::2]
    dtype = a.dtype
    assert tgemm.bwd_route(a, b, dtype) == route


# ---------------------------------------------------------------------------
# (b) the plan's contract
# ---------------------------------------------------------------------------
def gemma3_products():
    """gemma3-1b's 16 backward products at 4 x 1024 token rows, as the
    kernel's (M, N, K): dA = dC B^T (M tokens, N the layer's input width,
    K its output width) and dB = A^T dC (M the input width, N the output
    width, K tokens; the tied unembedding's as dB^T = dC^T A, written in
    the table's layout)."""
    t, d, q, kv, ff, v = 4096, 1152, 1024, 256, 6912, 262144
    proj = [("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
            ("wi", d, ff), ("wg", d, ff), ("mlp.wo", ff, d)]
    out = []
    for name, kin, nout in proj:
        out.append((f"dA {name}", t, kin, nout))
        out.append((f"dB {name}", kin, nout, t))
    out.append(("dA unembed", t, d, v))
    out.append(("dB unembed", v, d, t))
    return out


RAGGED = [("ragged", 1000, 1000, 1100), ("narrow", 100, 72, 90),
          ("one_tile", 17, 8, 8), ("long_k", 300, 136, 40000),
          ("tall", 20000, 24, 64)]
SHAPES = [(n, m, nn, k) for n, m, nn, k in gemma3_products() + RAGGED]


def _units_by_tile(p, sched):
    cover = {}
    for g, units in enumerate(sched):
        for tile, lo, hi, kind, contrib in units:
            assert 0 <= lo < hi <= p["ksteps"]
            cover.setdefault(tile, []).append((lo, hi, g, kind, contrib))
    return cover


@pytest.mark.parametrize("sms", [132, 114, 66])
@pytest.mark.parametrize("name,m,n,k", SHAPES, ids=[s[0] for s in SHAPES])
def test_bwd_plan_covers_balances_and_orders(name, m, n, k, sms):
    p = kc.gemm_bwd_geometry(m, n, k, sms)
    assert p is not None
    sched = kc.gemm_bwd_schedule(p)
    tiles = p["tiles_m"] * p["tiles_n"]
    ks = p["ksteps"]
    # every (tile, k step) exactly once
    cover = _units_by_tile(p, sched)
    assert sorted(cover) == list(range(tiles))
    for tile, segs in cover.items():
        segs.sort()
        assert segs[0][0] == 0 and segs[-1][1] == ks
        assert all(a[1] == b[0] for a, b in zip(segs, segs[1:]))
        if len(segs) == 1:
            assert segs[0][3] == "whole"
            continue
        # split: the first share's block adds the others' partials, in k
        # order, and each later share is a contributor of exactly it
        first = segs[0]
        assert first[3] == "first" and all(s[3] == "later"
                                           for s in segs[1:])
        assert first[4] == tuple(s[2] for s in segs[1:])
        assert list(first[4]) == sorted(first[4])
        assert tile >= p["dp_tiles"]
        # the first share is its block's last unit (it waits at the end)
        assert sched[first[2]][-1][0] == tile
    # one partial slot and one flag a stream-K block
    later = [g for g, units in enumerate(sched)
             for u in units if u[3] == "later"]
    assert len(later) == len(set(later))
    assert all(g < p["sk_blocks"] <= kc.MAX_TICKETS for g in later)
    # equal shares: stream-K within one k step of the mean, whole waves
    # one tile each
    sk_work = [sum(hi - lo for t, lo, hi, *_ in units if t >= p["dp_tiles"])
               for units in sched[:p["sk_blocks"]]]
    if sk_work:
        mean = p["sk_tiles"] * ks / p["sk_blocks"]
        assert max(sk_work) - mean <= 1 and mean - min(sk_work) <= 1
        assert min(sk_work) >= min(kc.BWD_MIN_SEG, ks)
        assert p["sk_blocks"] == p["sk_tiles"] * p["splits"] <= sms
    dp_counts = [sum(1 for u in units if u[0] < p["dp_tiles"])
                 for units in sched]
    assert max(dp_counts) - min(dp_counts) <= 1
    assert p["dp_tiles"] % p["grid"] == 0
    assert p["grid"] <= sms
    # the contract lints clean and its plan is the geometry
    c = kc.gemm_bwd_contract(m, n, k, sms=sms)
    assert not [f for f in checks.check_contract(c) if f.severity == "error"]
    assert c.plan_dict() == {key: p[key] for key in c.plan_dict()}


@pytest.mark.parametrize("m,n,k,bn,dp,sk,skb", [
    (4096, 1152, 262144, 192, 132, 60, 120),   # the unembedding's dA
    (262144, 1152, 4096, 192, 12276, 12, 48),  # its dB^T
    (1152, 256, 4096, 128, 0, 18, 72),         # wk dB: 4 shares a tile
    (4096, 1152, 1024, 192, 132, 60, 60),      # wq dA: too short to split
    (1152, 1024, 4096, 192, 0, 54, 108),       # wq dB: 192 columns
    (4096, 6912, 1152, 192, 1056, 96, 96),     # mlp.wo dA
])
def test_bwd_plan_at_gemma3_shapes(m, n, k, bn, dp, sk, skb):
    """The hybrid at the shapes PERF.md discusses: 192-column tiles at N =
    1152 (no half-empty column tile), whole waves data-parallel, each
    remaining tile in SMS // R shares of at least BWD_MIN_SEG k steps."""
    p = kc.gemm_bwd_geometry(m, n, k)
    assert (p["bn"], p["dp_tiles"], p["sk_tiles"], p["sk_blocks"]) == \
        (bn, dp, sk, skb)
    assert p["smem"] <= kc.SMEM_PER_BLOCK


def test_bwd_plan_refuses_what_the_kernel_cannot_run():
    assert kc.gemm_bwd_geometry(0, 8, 8) is None
    assert kc.gemm_bwd_geometry(1 << 30, 1 << 30, 8) is None  # tiles > 2^31
    c = kc.gemm_bwd_contract(0, 8, 8)
    assert {f.code for f in checks.check_contract(c)} == {"GL105"}
