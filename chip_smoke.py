#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout around this file
(it puts ``src`` on ``sys.path`` itself). Phases, each fatal on failure:

1. device: the card's name and power limit from ``nvidia-smi``;
2. build: every ``src/repro_torch/kernels/csrc/*.cu`` with ``nvcc`` for
   ``sm_90a``, all sources at once;
3. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at the shapes the serving path gives it plus one shape per
   attention kernel that turns every option on (head_dim 128, KVH > 1,
   softcap, sliding window), and at the engine path's shapes (the
   quickstart's int8 GEMM, ResNet-50's classifier and conv layers, the
   mvout epilogue), where the int8 kernels must be bit-exact. Times are
   CUDA-event medians with the L2 cache flushed before each launch;
   bounds use 3.35 TB/s and 989 TFLOP/s (bf16 tensor rate; 67 TFLOP/s for
   fp32 inputs, 1979 TOP/s for int8);
4. serve: gemma3-1b at full width (26 layers, random weights from a seed)
   through ``ServingEngine``: four requests, prompts of 1000, 512, 300 and
   64 tokens, 32 new tokens each, 256-token prefill chunks; launch counts
   are zeroed just before and read just after, and every kernel must have
   run; the first request's prefill logits at full width are held against
   the plain path on the CPU;
5. end to end against plain: the smoke gemma3-1b and qwen1.5-4b configs in
   fp32 (model dtype and engine config) on the card and on the CPU, with
   the same weights and prompts, must give equal greedy tokens;
6. engine: the Gemmini engine path on the quickstart's int8 BOTH instance:
   the port's quickstart (header, int8 GEMM on OS and WS, conv by host
   im2col and fused); the header against ``plan_gemm``; the mvout route
   (int32 GEMM, then ``accumulator_epilogue``); and ResNet-50's 50-layer
   stream from ``dse.resnet(50)`` at batch 1 (int8 convs from a seed, the
   classifier as a GEMM) three ways: host im2col + OS GEMM, host im2col +
   WS GEMM, and the fused conv kernel. Every output equals the plain
   version bit for bit and OS equals WS; launch counts are zeroed just
   before and read just after, and every engine kernel must have run;
7. recurrent serve: mamba2-1.3b at its published widths (48 layers,
   d_model 2048, d_state 128; bf16, weights from seed 0) on phase 4's
   traffic; the chunked SSD must launch once per layer for every prefill
   chunk, fresh and resumed, and no attention kernel may run; a 256-token
   prompt's prefill logits are held against the CPU plain path in fp32
   (``FP32_LOGITS_LIMIT``) and in bf16 (``hold_bf16``: the card's bf16
   gap from the fp32 logits at most twice the CPU's);
8. hybrid serve: hymba-1.5b at full width (128 meta tokens, window 1024),
   two requests of 700 and 200 tokens, 16 new tokens each; the SSD, flash,
   paged prefill, paged decode and GEMM kernels must all launch; prefill
   logits against the CPU as in phase 7;
9. gate: the port's ``serve_decode`` at smoke size, fp32 model and engine,
   for gemma2-2b, mamba2-1.3b, hymba-1.5b and musicgen-medium: on the card
   the engine's greedy tokens equal the static path's (dense decode
   kernel), and both equal the CPU plain path's;
10. static path: gemma3-1b at full width with phase 4's weights, bf16,
   through ``prefill_into_cache`` and 16 ``decode_step`` calls on a
   768-token prompt (the dense decode kernel's main path: it must launch
   once per step and layer); the logits, teacher-forced with the card's
   tokens on the CPU, are held by ``hold_bf16``.

Phase 3 also holds the chunked SSD (mamba2-1.3b's and hymba-1.5b's
widths, fresh and resumed, and a ragged 7-token prompt; final states
against the naive recurrence in fp64) and dense decode attention in bf16
at phase 10's shapes, at four sequences of 2048 and at hymba-1.5b's
shape, and in fp32 at phase 9's (each attention arch's longest request,
its windows and softcap), flash attention at hymba-1.5b's first chunk and
in fp32 at phase 9's prompts (the CUDA-core kernel that the fp32 gate
runs), and logs each redesigned kernel's grid and ``ptxas`` registers and
spills; dense decode's yardsticks are SDPA over the whole cache under a
boolean mask and (its ``library_ms``) SDPA without a mask over the live
key slice. Every main path's launch counts are zeroed
just before it and read just after; the kernels line takes each kernel's
count from its own path: the serve phase, the engine phase, the recurrent
serve (``ssd``) or the static path (``decode_attention``).

The line before the last is one JSON object ``{"kernels": [...]}``; the
last is ``{"ok": true, "device": {...}}``. Per-shape results and the
compiler's register / spill report go to ``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
OUT_DIR = os.path.join(ROOT, "chiprun_out")

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12, "int": 1979e12}
REPS = 25

# Full-width logits, card against the CPU plain path. fp32: each limit sits
# between the card's fp32 reading and the bf16 gap (mamba2-1.3b 7.5e-4 vs
# 2.9e-1, hymba-1.5b 2.2e-5 vs 4.6e-2, on an H100; PERF.md section 2).
# bf16: see ``hold_bf16``.
FP32_LOGITS_LIMIT = {"mamba2-1.3b": 5e-3, "hymba-1.5b": 1e-3}
BF16_FACTOR = 2.0

# Phase 10's static path: one gemma3-1b request, a prompt long enough that
# the 512-token window drops keys, then greedy decode steps.
STATIC_PROMPT = 768
STATIC_STEPS = 16


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


# ---------------------------------------------------------------------------
# measurement helpers
# ---------------------------------------------------------------------------
class Timer:
    """Median device time of one call (CUDA events), L2 flushed first.

    Before each timed call a sleep kernel holds the stream for longer than
    the host takes to enqueue the call, so the events bracket the device
    work alone and not the host's launch overhead; ``host_ms`` is the
    wall time of one synchronised call, launch overhead included."""

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(128 << 20, dtype=torch.uint8,
                                     device="cuda")
        start, end = self._events()
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        self.cycles_per_ms = 10_000_000 / start.elapsed_time(end)

    def _events(self):
        ev = self.torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def host_ms(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    def __call__(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        hold = int(self.cycles_per_ms * (2.0 * self.host_ms(fn) + 1.0))
        times = []
        for _ in range(reps):
            torch.cuda._sleep(hold)
            self.flush_buf.zero_()
            start, end = self._events()
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def bound_ms(nbytes: float, flops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(torch, name, got, want, kind):
    """bf16: one bf16 ulp of the value (2^-7 relative) plus 2^-14 of the
    output's largest magnitude, since kernel and plain version sum in other
    orders and a value near a rounding boundary may round either way.
    fp32: 1e-5 relative plus 1e-6 of the largest magnitude (sum order).
    int: bit-exact, same dtype (the int32 sum is exact in any order)."""
    if kind == "int":
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"{name}: {got.dtype} {tuple(got.shape)} != {want.dtype} "
                 f"{tuple(want.shape)}")
        err = (got.long() - want.long()).abs().max().item() \
            if got.numel() else 0
        if err != 0:
            fail(f"{name}: int kernel differs from the plain version, max "
                 f"abs err {err}")
        return float(err)
    g, w = got.float(), want.float()
    if g.shape != w.shape:
        fail(f"{name}: shape {tuple(g.shape)} != {tuple(w.shape)}")
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    err = (g - w).abs()
    scale = w.abs().max().item()
    rtol, atol = (2.0 ** -7, 2.0 ** -14 * scale) if kind == "bf16" \
        else (1e-5, 1e-6 * scale)
    bad = err > rtol * w.abs() + atol
    if bad.any():
        fail(f"{name}: {int(bad.sum())} of {bad.numel()} elements outside "
             f"tolerance; max abs err {err.max().item():.3e} (scale "
             f"{scale:.3e})")
    return err.max().item()


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
def flash_grid(t_q, t_k, h, dh, window):
    """(blocks per cluster, blocks) of the bf16 flash kernel, from its
    tiling (``flash_cluster`` in ``attention.cu``): 16-row query tiles x
    heads x a cluster of 4-warp blocks, enough of them (at most 4, a power
    of two) that the busiest tile's key tiles go one to a warp."""
    kt = 16 if dh >= 256 else 32 if dh >= 128 else 64
    most = 0
    for row0 in range(0, t_q, 16):
        q0 = t_k - t_q + row0
        lo = max(0, q0 - window + 1) if window else 0
        hi = min(t_k, q0 + 16)
        if hi > lo:
            most = max(most, -(-hi // kt) - lo // kt)
    cl = 1
    while cl < 4 and cl * 4 < most:
        cl *= 2
    return cl, cl * -(-t_q // 16) * h


def kernel_cases(torch, rng_seed=0):
    """(kernel, label, representative, kind, run_kernel, run_plain,
    run_library, nbytes, flops) for every checked shape."""
    from repro_torch import configs
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import gemm_ref

    cfg = configs.get("gemma3-1b")
    d, hd, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    gen = torch.Generator(device="cuda").manual_seed(rng_seed)
    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    cases = []

    # -- gemm: every projection and the tied unembedding at the serving
    # path's row counts (decode: 4 slots; chunks: 256; the short prompt: 64)
    proj = [("wq", d, nh * hd), ("wk", d, nkv * hd), ("wv", d, nkv * hd),
            ("wo", nh * hd, d), ("wi", d, cfg.d_ff), ("wg", d, cfg.d_ff),
            ("mlp.wo", cfg.d_ff, d)]
    table = randn(cfg.vocab, d, scale=d ** -0.5)
    for m in (4, 64, 256):
        for pname, k, n in proj + [("unembed", d, cfg.vocab)]:
            a = randn(m, k)
            b = table.T if pname == "unembed" else randn(k, n, scale=k ** -0.5)
            kw = dict(acc_dtype=f32, out_dtype=bf16)
            nbytes = 2 * (m * k + k * n + m * n)
            cases.append((
                "gemm", f"{pname} M={m} N={n} K={k}",
                pname == "unembed" and m == 4, "bf16",
                lambda a=a, b=b, kw=kw: kg.gemm(a, b, **kw),
                lambda a=a, b=b, kw=kw: gemm_ref(a, b, None, **kw),
                lambda a=a, b=b: torch.matmul(a, b),
                nbytes, 2.0 * m * n * k))
    # the D input (qwen's QKV bias) and the fp32 datapath (fp32 engine)
    a, b = randn(64, d), randn(d, nh * hd, scale=d ** -0.5)
    bias = randn(nh * hd)
    kw = dict(acc_dtype=f32, out_dtype=bf16)
    cases.append(("gemm", "wq+bias M=64", False, "bf16",
                  lambda: kg.gemm(a, b, bias, **kw),
                  lambda: gemm_ref(a, b, bias, **kw), None,
                  2 * (64 * d + d * nh * hd * 2), 2.0 * 64 * d * nh * hd))
    a32, b32, bias32 = a.float(), b.float(), bias.float()
    kw32 = dict(acc_dtype=f32, out_dtype=f32)
    cases.append(("gemm", "fp32 wq+bias M=64", False, "fp32",
                  lambda: kg.gemm(a32, b32, bias32, **kw32),
                  lambda: gemm_ref(a32, b32, bias32, **kw32), None,
                  4 * (64 * d + d * nh * hd * 2), 2.0 * 64 * d * nh * hd))

    # -- flash_attention: a fresh prompt or first chunk, local and global
    def flash_case(t_q, t_k, h, kvh, dh, window, softcap, rep, dtype=bf16):
        q = randn(1, t_q, h, dh, dtype=dtype)
        k = randn(1, t_k, kvh, dh, dtype=dtype)
        v = randn(1, t_k, kvh, dh, dtype=dtype)
        kw = dict(causal=True, window=window, softcap=softcap)
        pairs = sum(min(i + t_k - t_q + 1, window or 1 << 30)
                    for i in range(t_q))
        nbytes = q.element_size() * (2 * t_q * h * dh + 2 * t_k * kvh * dh)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
        # SDPA computes the same function where the window cuts no key.
        lib = library if ((window is None or window >= t_k) and
                          softcap is None and t_q == t_k) else None
        kind = "fp32" if dtype == f32 else "bf16"
        if dtype == bf16:
            cl, blocks = flash_grid(t_q, t_k, h, dh, window)
            grid = f"{blocks} blocks, clusters of {cl}"
        else:
            grid = f"{-(-t_q // 64) * h} blocks (CUDA cores)"
        cases.append(("flash_attention",
                      f"{kind} Tq={t_q} Tk={t_k} H={h} KVH={kvh} D={dh} "
                      f"window={window} softcap={softcap}", rep, kind,
                      lambda: ka.flash_attention(q, k, v, **kw),
                      lambda: ka.blockwise_attention(q, k, v, **kw), lib,
                      nbytes, 4.0 * dh * h * pairs, dict(grid=grid)))
    flash_case(256, 256, nh, nkv, hd, None, None, True)
    flash_case(256, 256, nh, nkv, hd, cfg.local_window, None, False)
    flash_case(64, 64, nh, nkv, hd, None, None, False)
    flash_case(64, 64, nh, nkv, hd, cfg.local_window, None, False)
    flash_case(100, 200, 8, 2, 128, 64, 50.0, False)
    # hymba-1.5b's first chunk as phase 8 launches it: 256 cache positions
    # (its 128 meta tokens lead the prompt), GQA 25 / 5, head dim 64
    hy = configs.get("hymba-1.5b")
    flash_case(256, 256, hy.n_heads, hy.n_kv_heads, hy.head_dim,
               hy.local_window, None, False)
    # phase 9's gate in fp32 (the CUDA-core kernel): each attention arch's
    # longest prompt as the static path prefills it, windows and softcap
    from repro_torch.examples import serve_decode as sd
    for arch in sd.ARCHS:
        sc = configs.get_smoke(arch)
        if not sc.has_attn:
            continue
        t = max(sd.PROMPT_LENS) + sc.n_meta_tokens
        for window in (None, sc.local_window) if sc.local_window \
                else (None,):
            flash_case(t, t, sc.n_heads, sc.n_kv_heads, sc.head_dim, window,
                       sc.attn_softcap, False, dtype=f32)

    # -- paged attention pools as the engine holds them: page 64, 2048-token
    # context (32 pages per slot), 128 pages + the trash page
    def pools(kvh, n_pages, page, dh):
        return (randn(kvh, n_pages + 1, page, dh),
                randn(kvh, n_pages + 1, page, dh))

    def prefill_case(t, start, h, kvh, dh, page, n_pages, kv_pages, window,
                     softcap, rep):
        kp, vp = pools(kvh, n_pages, page, dh)
        perm = torch.randperm(n_pages, generator=gen, device="cuda")
        table = perm[:kv_pages].to(torch.int32)
        q = randn(1, t, h, dh)
        kw = dict(window=window, softcap=softcap)
        pairs = sum(min(start + i + 1, window or 1 << 30) for i in range(t))
        live = start + t if window is None else min(start + t,
                                                    window - 1 + t)
        nbytes = 2 * (2 * t * h * dh + 2 * live * kvh * dh) + 4 * kv_pages
        cases.append(("paged_prefill_attention",
                      f"T={t} start={start} H={h} KVH={kvh} D={dh} "
                      f"kv_pages={kv_pages} window={window} softcap={softcap}",
                      rep, "bf16",
                      lambda: ka.paged_prefill_attention(q, kp, vp, table,
                                                         start, **kw),
                      lambda: ka.paged_prefill_attention_plain(
                          q, kp, vp, table, start, **kw), None,
                      nbytes, 4.0 * dh * h * pairs))
    for start in (256, 512, 768):
        prefill_case(256, start, nh, nkv, hd, 64, 128, 16, None, None,
                     start == 768)
        prefill_case(256, start, nh, nkv, hd, 64, 128, 16, cfg.local_window,
                     None, False)
    prefill_case(64, 256, nh, nkv, hd, 64, 128, 5, None, None, False)
    prefill_case(50, 37, 8, 2, 128, 16, 40, 6, 24, 50.0, False)

    def decode_case(lengths, h, kvh, dh, page, n_pages, mp, window, softcap,
                    rep):
        kp, vp = pools(kvh, n_pages, page, dh)
        s = len(lengths)
        perm = torch.randperm(n_pages, generator=gen, device="cuda")
        tables = perm[:s * mp].reshape(s, mp).to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = randn(s, 1, h, dh)
        kw = dict(window=window, softcap=softcap)
        live = sum(min(n, window or 1 << 30) for n in lengths)
        nbytes = 2 * (2 * s * h * dh + 2 * live * kvh * dh) + 4 * s * (mp + 1)
        cases.append(("paged_decode_attention",
                      f"S={s} lengths={lengths} H={h} KVH={kvh} D={dh} "
                      f"window={window} softcap={softcap}", rep, "bf16",
                      lambda: ka.paged_decode_attention(q, kp, vp, tables,
                                                        lens, **kw),
                      lambda: ka.paged_decode_attention_plain(
                          q, kp, vp, tables, lens, **kw), None,
                      nbytes, 4.0 * dh * h * live))
    serve_lengths = [1010, 530, 310, 80]
    decode_case(serve_lengths, nh, nkv, hd, 64, 128, 32, None, None, True)
    decode_case(serve_lengths, nh, nkv, hd, 64, 128, 32, cfg.local_window,
                None, False)
    decode_case([77, 0, 16, 33], 8, 2, 128, 16, 40, 8, 24, 50.0, False)
    engine_cases(torch, gen, cases)
    recurrent_cases(torch, gen, cases)
    return cases


def ssd_flops(t, h, p, g, n, chunk, carried):
    """Operations the chunked SSD needs per batch row: per chunk of q rows
    the causal C.B^T scores once per B/C group (2 q(q+1)/2 N), and per
    head the weighted product with x (2 q(q+1)/2 P), the state update
    (2 q N P) and, where a state is carried in, its term (2 q N P)."""
    q = min(chunk, t)
    total = 0.0
    for t0 in range(0, t, q):
        qq = min(q, t - t0)
        tri = qq * (qq + 1) / 2
        total += g * 2 * tri * n + h * (2 * tri * p + 2 * qq * n * p)
        if t0 > 0 or carried:
            total += h * 2 * qq * n * p
    return total


def recurrent_cases(torch, gen, cases):
    """The chunked SSD at mamba2-1.3b's and hymba-1.5b's widths (bf16 x,
    B, C; fp32 dt and states), fresh and resumed, and on a ragged 7-token
    prompt; dense decode attention at gemma3-1b's shape (global and the
    512 window) and hymba-1.5b's (GQA 25 / 5, head dim 64, window 1024).

    The SSD's y is held against the plain version in bf16; its final
    state against the naive recurrence in fp64 (``tests/_ssd_exact.py``)
    within ``fp32_tolerance`` (exp of the per-chunk cumulative decay turns
    that sum's fp32 rounding into a relative error). Its bound takes the
    fp32 CUDA-core peak (67 TFLOP/s): the kernel's math is fp32 on CUDA
    cores."""
    from _ssd_exact import fp32_tolerance, ssd_fp64

    from repro_torch import configs
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import mamba2 as km

    bf16, f32 = torch.bfloat16, torch.float32

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    def ssd_case(arch, t, resume, rep):
        cfg = configs.get(arch)
        h, p, g, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
            cfg.d_state
        chunk = cfg.ssm_chunk
        x = randn(1, t, h, p)
        b, c = randn(1, t, g, n, scale=0.3), randn(1, t, g, n, scale=0.3)
        dt = torch.nn.functional.softplus(randn(1, t, h, dtype=f32))
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
        d_skip = torch.ones((h,), dtype=f32, device="cuda")
        init = randn(1, h, n, p, dtype=f32, scale=0.5) if resume else None
        kw = dict(d_skip=d_skip, chunk=chunk, initial_state=init,
                  return_final_state=True)
        name = f"ssd [{arch} T={t}]"

        def check(got, want):
            err = check_close(torch, name, got[0], want[0], "bf16")
            _, exact = ssd_fp64(x, dt, a_log, b, c, d_skip=d_skip,
                                initial_state=init)
            tol = fp32_tolerance(dt, a_log, chunk)
            st_err = (got[1].double() - exact).abs().max().item()
            scale = exact.abs().max().item()
            if not torch.isfinite(got[1]).all() or st_err > tol * scale:
                fail(f"{name}: final state err {st_err:.3e} > {tol:.2e} x "
                     f"{scale:.3e}")
            log(f"{name}: final state err {st_err:.3e} (limit "
                f"{tol * scale:.3e}, fp64 recurrence)")
            return err

        nbytes = (2 * 2 * t * h * p + 2 * 2 * t * g * n + 4 * t * h + 8 * h
                  + 4 * h * n * p * (2 if resume else 1))
        cases.append(("ssd", f"{arch} B=1 T={t} H={h} P={p} G={g} N={n} "
                      f"chunk={chunk} {'resumed' if resume else 'fresh'}",
                      rep, "bf16",
                      lambda: km.ssd(x, dt, a_log, b, c, **kw),
                      lambda: km.ssd_plain(x, dt, a_log, b, c, **kw), None,
                      nbytes, ssd_flops(t, h, p, g, n, chunk, resume),
                      dict(check=check, peak="fp32")))
    ssd_case("mamba2-1.3b", 1000, False, True)
    ssd_case("mamba2-1.3b", 1000, True, False)
    ssd_case("hymba-1.5b", 1000, False, False)
    ssd_case("hymba-1.5b", 1000, True, False)
    ssd_case("mamba2-1.3b", 7, False, False)

    def decode_case(b, s, h, kvh, dh, pos, window, softcap, rep,
                    dtype=bf16):
        q = randn(b, 1, h, dh, dtype=dtype)
        k = randn(b, s, kvh, dh, dtype=dtype)
        v = randn(b, s, kvh, dh, dtype=dtype)
        kw = dict(window=window, softcap=softcap)
        kpos = torch.arange(s, device="cuda")
        lo = max(0, pos - window + 1) if window else 0
        live = min(pos + 1, s) - lo
        mask = (kpos <= pos) & (kpos >= lo)
        sdpa = torch.nn.functional.scaled_dot_product_attention

        # Two one-call yardsticks: the whole cache under a boolean mask,
        # and (the faster) no mask over the live key slice.
        def masked():
            return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), attn_mask=mask[None, None, None, :],
                        enable_gqa=True)

        def live_slice():
            return sdpa(q.transpose(1, 2), k[:, lo:pos + 1].transpose(1, 2),
                        v[:, lo:pos + 1].transpose(1, 2), enable_gqa=True)
        libs = {"masked": masked, "live_slice": live_slice} \
            if softcap is None else {}
        for name, fn in list(libs.items()):
            try:                      # the yardstick only, never the port
                fn()
            except RuntimeError as e:
                log(f"scaled_dot_product_attention ({name}) refused: {e}")
                del libs[name]
        kind = "fp32" if dtype == f32 else "bf16"
        nbytes = q.element_size() * (2 * b * h * dh + 2 * b * live * kvh * dh)
        splits, groups, _, split, _ = ka.decode_plan(b, s, h, kvh, dh, pos,
                                                     window)
        opts = dict(grid=f"{splits * groups} blocks ({splits} splits of "
                    f"{split} keys x {groups})")
        if "masked" in libs:
            opts["library_masked"] = libs["masked"]
        cases.append(("decode_attention",
                      f"{kind} B={b} S={s} pos={pos} H={h} KVH={kvh} D={dh} "
                      f"window={window} softcap={softcap}", rep, kind,
                      lambda: ka.decode_attention(q, k, v, pos, **kw),
                      lambda: ka.decode_attention_plain(q, k, v, pos, **kw),
                      libs.get("live_slice"), nbytes, 4.0 * dh * h * b * live,
                      opts))
    # phase 10's static path: gemma3-1b's last decode step, global and local
    g3 = configs.get("gemma3-1b")
    s_max = STATIC_PROMPT + STATIC_STEPS
    decode_case(1, s_max, g3.n_heads, g3.n_kv_heads, g3.head_dim, s_max - 1,
                None, None, True)
    decode_case(1, s_max, g3.n_heads, g3.n_kv_heads, g3.head_dim, s_max - 1,
                g3.local_window, None, False)
    # and a batch of four at the serve phase's longest context
    for window in (None, g3.local_window):
        decode_case(4, 2048, g3.n_heads, g3.n_kv_heads, g3.head_dim, 1999,
                    window, None, False)
    hy = configs.get("hymba-1.5b")
    decode_case(1, 2048, hy.n_heads, hy.n_kv_heads, hy.head_dim, 1500,
                hy.local_window, None, False)
    decode_case(2, 100, 8, 2, 128, 99, 24, 50.0, False)
    # phase 9's gate in fp32: each attention arch's longest request at its
    # last decode step, with its windows and softcap
    from repro_torch.examples import serve_decode as sd
    for arch in sd.ARCHS:
        cfg = configs.get_smoke(arch)
        if not cfg.has_attn:
            continue
        s_gate = max(p + cfg.n_meta_tokens + g
                     for p, g in zip(sd.PROMPT_LENS, sd.GEN_LENS))
        for window in (None, cfg.local_window) if cfg.local_window \
                else (None,):
            decode_case(1, s_gate, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                        s_gate - 1, window, cfg.attn_softcap, False,
                        dtype=f32)


def engine_cases(torch, gen, cases):
    """The engine path's int8 kernels at its shapes: the quickstart GEMM
    (bias, shift 7, ReLU), ResNet-50's classifier and a ragged GEMM on
    both dataflows; the mvout epilogue; ResNet-50's stage-1 3x3 conv and
    its stem conv."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels import epilogue as epi
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import conv2d_ref, gemm_ref

    i8, i32 = torch.int8, torch.int32

    def rint(lo, hi, *shape, dtype=i8):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=dtype)

    relu = Activation.RELU
    for label, m, n, k, rep in (("quickstart", 1000, 512, 2048, True),
                                ("classifier", 1, 1000, 2048, False),
                                ("ragged", 37, 77, 147, False)):
        a, b = rint(-128, 128, m, k), rint(-128, 128, k, n)
        bias = rint(-1000, 1000, 1, n, dtype=i32)
        kw = dict(acc_dtype=i32, out_dtype=i8, shift=7, activation=relu)
        # torch._int_mm: the int32 product alone, no bias or epilogue; it
        # takes M > 16 and K, N multiples of 8.
        lib = (lambda a=a, b=b: torch._int_mm(a, b)) \
            if m > 16 and k % 8 == 0 and n % 8 == 0 else None
        if lib is not None:
            try:                      # the yardstick only, never the port
                lib()
            except RuntimeError as e:
                log(f"torch._int_mm refused M={m} N={n} K={k}: {e}")
                lib = None
        for kernel, fn in (("gemm[int8]", kg.gemm_os), ("gemm_ws", kg.gemm_ws)):
            cases.append((
                kernel, f"{label} M={m} N={n} K={k} bias shift=7 relu", rep,
                "int", lambda a=a, b=b, bias=bias, fn=fn, kw=kw:
                fn(a, b, bias, **kw),
                lambda a=a, b=b, bias=bias, kw=kw: gemm_ref(a, b, bias, **kw),
                lib, m * k + k * n + 4 * n + m * n, 2.0 * m * n * k))

    acc = rint(-2 ** 31, 2 ** 31 - 1, 1000, 512, dtype=i32)
    kw = dict(out_dtype=i8, shift=7, activation=relu)
    cases.append(("accumulator_epilogue", "int32 (1000, 512) -> int8 shift=7 "
                  "relu", True, "int",
                  lambda acc=acc, kw=kw: kg.accumulator_epilogue(acc, **kw),
                  lambda acc=acc, kw=kw: epi.apply(acc, **kw), None,
                  5 * 1000 * 512, 0.0))
    accf = torch.randn((3136, 256), generator=gen, device="cuda") * 8
    kwf = dict(out_dtype=torch.float32, shift=2, activation=relu)
    cases.append(("accumulator_epilogue", "fp32 (3136, 256) -> fp32 shift=2 "
                  "relu", False, "fp32",
                  lambda: kg.accumulator_epilogue(accf, **kwf),
                  lambda: epi.apply(accf, **kwf), None, 8 * 3136 * 256,
                  0.0))

    for label, h, ci, co, kh, stride, pad, rep in (
            ("stage-1 3x3", 56, 64, 64, 3, 1, 1, True),
            ("conv1 7x7/2", 224, 3, 64, 7, 2, 3, False)):
        x = rint(-64, 64, 1, h, h, ci)
        w = rint(-32, 32, kh, kh, ci, co)
        bias = rint(-500, 500, co, dtype=i32)
        oh = (h + 2 * pad - kh) // stride + 1
        kw = dict(stride=stride, padding=pad, acc_dtype=i32, out_dtype=i8,
                  shift=8, activation=relu)
        cases.append((
            "conv2d_implicit", f"{label} 1x{h}x{h}x{ci} -> {oh}x{oh}x{co}",
            rep, "int",
            lambda x=x, w=w, bias=bias, kw=kw: kc.conv2d_implicit(x, w, bias,
                                                                  **kw),
            lambda x=x, w=w, bias=bias, kw=kw: conv2d_ref(x, w, bias, **kw),
            None, x.numel() + w.numel() + 4 * co + oh * oh * co,
            2.0 * oh * oh * co * kh * kh * ci))


def run_kernel_phase(torch, timer):
    """Each case: (kernel, label, representative, kind, run_kernel,
    run_plain, run_library, bytes, flops[, opts]); ``opts["check"]``
    replaces ``check_close`` for a kernel with several outputs,
    ``opts["peak"]`` names the rate its operations run at, where that is
    not the tolerance kind's, ``opts["grid"]`` describes the kernel's grid
    and ``opts["library_masked"]`` is a second one-call yardstick."""
    rows, summary = [], {}
    for (kernel, label, rep, kind, run_k, run_p, run_lib, nbytes, flops,
         *opts) in kernel_cases(torch):
        opts = opts[0] if opts else {}
        got = run_k()
        torch.cuda.synchronize()
        want = run_p()
        if "check" in opts:
            err = opts["check"](got, want)
        else:
            err = check_close(torch, f"{kernel} [{label}]", got, want, kind)
        del got, want
        ms = timer(run_k)
        host_ms = timer.host_ms(run_k)
        plain_ms = timer(run_p)
        lib_ms = timer(run_lib) if run_lib is not None else None
        b_ms, b_by = bound_ms(nbytes, flops, opts.get("peak", kind))
        row = {"name": kernel, "shape": label, "max_abs_err": err, "ms": ms,
               "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops}
        extra = ""
        if "library_masked" in opts:
            row["library_masked_ms"] = timer(opts["library_masked"])
            extra += f"  masked library {row['library_masked_ms']:.4f} ms"
        if "grid" in opts:
            row["grid"] = opts["grid"]
            extra += f"  grid {opts['grid']}"
        rows.append(row)
        log(f"{kernel:<24} {label:<62} err {err:.2e}  kernel {ms:8.4f} ms "
            f"(host {host_ms:7.4f})  plain {plain_ms:8.4f} ms  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms':>10}  bound "
            f"{b_ms:.4f} ms ({b_by}){extra}")
        if rep:
            summary[kernel] = row
    # Launch counts of the checks are not the main path's: reset below.
    return rows, summary


# ---------------------------------------------------------------------------
# phase 4: full-width serve
# ---------------------------------------------------------------------------
SERVE_PROMPTS = (1000, 512, 300, 64)
SERVE_NEW = 32


def run_serve_phase(torch, np):
    from repro_torch import configs, kernels
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    cfg = configs.get("gemma3-1b")
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, max_slots=4, max_context=2048, page_size=64,
                           prefill_chunk=256, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(engine.params))
    log(f"gemma3-1b full width: {n_params / 1e9:.3f} B parameters, "
        f"{len(engine.params['blocks']['ln1'])} layers, "
        f"{engine.alloc.n_pages} KV pages; init "
        f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in SERVE_PROMPTS]
    for p in prompts:
        engine.submit(p, SERVE_NEW)

    kernels.reset_launch_counts()
    report = engine.run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()

    for r in report["requests"]:
        if r["status"] != "finished" or r["new_tokens"] != SERVE_NEW:
            fail(f"request {r['rid']}: status {r['status']}, "
                 f"{r['new_tokens']} of {SERVE_NEW} tokens")
        toks = np.asarray(r["tokens"])
        if toks.shape != (SERVE_NEW,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab:
            fail(f"request {r['rid']}: bad tokens {toks}")
    counts = {name: counts[name] for name in kernels.SERVING_KERNELS}
    for name, n in counts.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    s = report["summary"]
    log(f"serve: {int(s['requests'])} requests, {int(s['new_tokens'])} new "
        f"tokens in {s['wall_s']:.3f} s = {s['tokens_per_s']:.2f} tok/s; "
        f"TTFT p50 {s['p50_ttft_s'] * 1e3:.1f} ms p99 "
        f"{s['p99_ttft_s'] * 1e3:.1f} ms; ITL p50 "
        f"{s['p50_itl_s'] * 1e3:.2f} ms p95 {s['p95_itl_s'] * 1e3:.2f} ms; "
        f"{int(s['prefill_chunks'])} prefill chunks, "
        f"{int(s['iterations'])} iterations; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"serve launch counts: {counts}")

    # Full-width numerics: the 64-token prompt's prefill logits on the card
    # (kernels) against the plain path on the CPU, same weights.
    n = SERVE_PROMPTS[-1]
    pages = torch.arange(engine.max_pages_per_seq, dtype=torch.int32)
    toks = torch.from_numpy(prompts[-1][None])
    cuda_state = tf.init_paged_state(cfg, 1, engine.max_pages_per_seq, 64,
                                     engine.max_pages_per_seq,
                                     dtype=cfg.dtype, device="cuda")
    got, _ = tf.paged_prefill(engine.engine, engine.params, cfg,
                              toks.cuda(), cuda_state, 0, pages.cuda(),
                              page_size=64)
    cpu_params = _tree_map(lambda t: t.cpu(), engine.params)
    cpu_state = tf.init_paged_state(cfg, 1, engine.max_pages_per_seq, 64,
                                    engine.max_pages_per_seq,
                                    dtype=cfg.dtype, device="cpu")
    want, _ = tf.paged_prefill(engine.engine, cpu_params, cfg, toks,
                               cpu_state, 0, pages, page_size=64)
    got = got.float().cpu()
    if got.shape != (1, n, cfg.vocab) or not torch.isfinite(got).all():
        fail(f"full-width logits: shape {tuple(got.shape)} or non-finite")
    rel = ((got - want).norm() / want.norm()).item()
    # bf16 rounds every projection and norm output (2^-8 relative); over
    # 26 layers the two sum orders drift apart by a few of those.
    log(f"full-width prefill logits vs the CPU plain path: relative L2 "
        f"error {rel:.3e} (limit 5e-2)")
    if not rel <= 5e-2:
        fail(f"full-width logits disagree with the plain path: {rel:.3e}")
    return counts, s, run_profile_phase(torch, engine), engine


# ---------------------------------------------------------------------------
# phase 4b: where a full-width decode step and prefill chunk spend time
# ---------------------------------------------------------------------------
_KERNEL_NAMES = (("ssd_kernel", "ssd"),
                 ("decode_split_kernel", "decode_attention"),
                 ("flash_tc_kernel", "flash_attention"),
                 ("ConvA", "conv2d_implicit"), ("MatrixA", "gemm[int8]"),
                 ("epilogue_kernel", "accumulator_epilogue"),
                 ("gemm_bf16_kernel", "gemm"), ("gemm_f32_kernel", "gemm"),
                 ("paged_decode_kernel", "paged_decode_attention"),
                 ("true>", "paged_prefill_attention"),
                 ("prefill_attn_kernel", "flash_attention"))


def _kernel_class(name: str) -> str:
    for key, cls in _KERNEL_NAMES:
        if key in name:
            return cls
    return "other"


def profile_call(torch, name, fn, n=3):
    """Wall time of one synchronised ``fn()`` (median of 5) against the
    device time of every kernel ``torch.profiler`` saw in it (mean of n),
    by kernel class; "gemm[int8]" covers the int8 GEMM in either order."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    by_class, launches = {}, {}
    for a in prof.key_averages():
        # Device activity only: an operator's entry repeats the time
        # of the kernels it launched.
        if not str(a.device_type).endswith("CUDA"):
            continue
        dev_us = a.self_device_time_total
        cls = _kernel_class(a.key)
        by_class[cls] = by_class.get(cls, 0.0) + dev_us / 1e3 / n
        launches[cls] = launches.get(cls, 0) + a.count // n
    wall = statistics.median(walls)
    device = sum(by_class.values())
    out = {"wall_ms": wall, "device_ms": device,
           "device_busy_share": device / wall,
           "device_ms_by_kernel": by_class, "launches_by_kernel": launches}
    if device == 0.0:
        log(f"profile {name}: wall {wall:.3f} ms; device time not "
            f"measured (the profiler saw no CUDA kernel)")
        return out
    parts = ", ".join(f"{k} {v:.3f} ms x{launches[k]}" for k, v in
                      sorted(by_class.items(), key=lambda kv: -kv[1]))
    log(f"profile {name}: wall {wall:.3f} ms, device busy "
        f"{device:.3f} ms ({device / wall:.1%}); {parts}")
    return out


def run_profile_phase(torch, engine):
    """``profile_call`` for one decode step of four slots at
    1000/512/300/64 cached tokens and for one 256-token continuation
    chunk at position 768 (the serve phase's shapes)."""
    from repro_torch.models import transformer as tf

    cfg, ctx, params = engine.model_cfg, engine.engine, engine.params
    mp, page = engine.max_pages_per_seq, engine.page_size
    state = tf.init_paged_state(cfg, 4, 4 * mp, page, mp, dtype=cfg.dtype,
                                device="cuda")
    state.tables.copy_(torch.arange(4 * mp, dtype=torch.int32,
                                    device="cuda").reshape(4, mp))
    decode_state = state._replace(lengths=torch.tensor(
        [1000, 512, 300, 64], dtype=torch.int32, device="cuda"))
    active = torch.ones((4,), dtype=torch.bool, device="cuda")
    toks = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    chunk = torch.zeros((1, 256), dtype=torch.int32, device="cuda")
    steps = {
        "decode_step": lambda: tf.paged_decode_step(
            ctx, params, cfg, toks, decode_state, active, page_size=page),
        "prefill_chunk": lambda: tf.paged_prefill_chunk(
            ctx, params, cfg, chunk, state, 0, state.tables[0], 768,
            page_size=page, kv_pages=16),
    }
    return {name: profile_call(torch, name, fn) for name, fn in steps.items()}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# phase 5: fp32 end to end, card against CPU
# ---------------------------------------------------------------------------
def run_e2e_phase(torch, np):
    from repro_torch import configs
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import GemminiConfig
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    f32 = GemminiConfig(input_dtype="fp32", acc_dtype="fp32",
                        output_dtype="fp32")
    # gemma3 with six layers, every third global, so both window kinds run
    for arch, kw in (("gemma3-1b", dict(n_layers=6, global_period=3)),
                     ("qwen1.5-4b", {})):
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  dtype=torch.float32, **kw)
        rng = np.random.default_rng(1)
        tree = _tree_map(lambda t: t.numpy(),
                         tf.init_params(torch.Generator().manual_seed(1), cfg))
        # norm scales and biases start at zero: perturb them so the
        # zero-centred norms and the GEMM's D input carry weight
        for node, key in [(tree, "final_norm")] + [
                (tree["blocks"], k) for k in ("ln1", "ln2", "post_ln1",
                                              "post_ln2", "qnorm", "knorm")
        ] + [(tree["blocks"]["attn"], k) for k in ("bq", "bk", "bv")]:
            if key in node:
                node[key] = node[key] + 0.3 * rng.standard_normal(
                    node[key].shape).astype(np.float32)
        prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
                   for n in (37, 16, 70, 5)]
        streams = {}
        for device in ("cuda", "cpu"):
            eng = ServingEngine(cfg, max_slots=4, max_context=128,
                                page_size=8, prefill_chunk=16,
                                engine_cfg=f32,
                                params=params_from_numpy(tree, device),
                                device=device)
            for p in prompts:
                eng.submit(p, 12)
            rep = eng.run()
            streams[device] = [np.asarray(r["tokens"]).tolist()
                               for r in rep["requests"]]
        if streams["cuda"] != streams["cpu"]:
            fail(f"{arch} fp32: greedy tokens differ between card and CPU:\n"
                 f"  cuda {streams['cuda']}\n  cpu  {streams['cpu']}")
        log(f"{arch} smoke fp32: card and CPU give equal greedy tokens for "
            f"{len(prompts)} requests x 12 tokens")


# ---------------------------------------------------------------------------
# phase 6: the Gemmini engine path (quickstart + ResNet-50 layer stream)
# ---------------------------------------------------------------------------
ENGINE_REPS = 3


def resnet50_layers(torch, seed=0):
    """``dse.resnet(50)``'s 50 GEMM-shaped layers at batch 1 as int8 convs
    with data from a seed: the 7x7/2 stem on a 224x224x3 image, each 1x1
    and 3x3 (pad 1) at its stage's width and resolution, and the classifier
    as a 1x1 conv over a 1x1x2048 image (host route: the (1, 2048) x
    (2048, 1000) GEMM). Returns (label, x, w, bias, stride, pad, act)."""
    import math

    from repro_torch.core import dse
    from repro_torch.core.config import Activation

    gen = torch.Generator(device="cuda").manual_seed(seed)
    layers = []
    for i, g in enumerate(dse.resnet(50).gemms):
        if g.m == 1:
            h, kh, stride, pad, ci = 1, 1, 1, 0, g.k
        elif g.k == 7 * 7 * 3:
            h, kh, stride, pad, ci = 224, 7, 2, 3, 3
        elif g.k % 9 == 0:
            h, kh, stride, pad, ci = math.isqrt(g.m), 3, 1, 1, g.k // 9
        else:
            h, kh, stride, pad, ci = math.isqrt(g.m), 1, 1, 0, g.k
        oh = (h + 2 * pad - kh) // stride + 1
        if oh * oh != g.m or kh * kh * ci != g.k:
            fail(f"resnet50 layer {i}: {g} is not a square conv")
        x = torch.randint(-64, 64, (1, h, h, ci), generator=gen,
                          device="cuda", dtype=torch.int8)
        w = torch.randint(-32, 32, (kh, kh, ci, g.n), generator=gen,
                          device="cuda", dtype=torch.int8)
        b = torch.randint(-500, 500, (g.n,), generator=gen, device="cuda",
                          dtype=torch.int32)
        act = Activation.NONE if g.m == 1 else Activation.RELU
        layers.append((f"{i}: {kh}x{kh}/{stride} {h}x{h}x{ci}->{g.n}", x, w,
                       b, stride, pad, act))
    return layers


def run_engine_phase(torch, smi):
    from repro_torch import kernels
    from repro_torch.core.config import Activation, Dataflow
    from repro_torch.core.generator import elaborate
    from repro_torch.core.tiling import plan_gemm
    from repro_torch.examples import quickstart
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import conv2d_ref, gemm_ref

    cfg = quickstart.QUICKSTART_CFG
    inst = elaborate(cfg)
    layers = resnet50_layers(torch)
    refs = [conv2d_ref(x, w, b, stride=st, padding=p, acc_dtype=torch.int32,
                       out_dtype=torch.int8, shift=8, activation=act)
            for _, x, w, b, st, p, act in layers]
    a, b, bias, _, _ = quickstart.quickstart_operands("cuda")
    want_q = gemm_ref(a, b, bias, acc_dtype=torch.int32, out_dtype=torch.int8,
                      shift=7, activation=Activation.RELU)
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    # the user's entry point: header, int8 GEMM on OS and WS, conv both ways
    if quickstart.main(["--device", "cuda"]) != 0:
        fail("the port's quickstart differs from its oracle on the card")
    hdr = inst.header(1000, 512, 2048)
    plan = plan_gemm(cfg, 1000, 512, 2048)
    want_hdr = {"DIM": cfg.dim, "TILE_M": plan.tile_m, "TILE_N": plan.tile_n,
                "TILE_K": plan.tile_k, "GRID": plan.grid,
                "SPAD_BYTES": cfg.scratchpad_bytes,
                "ACC_BYTES": cfg.accumulator_bytes,
                "DATAFLOW": plan.dataflow.value,
                "UTILIZATION": plan.utilization,
                "ARITH_INTENSITY": plan.arithmetic_intensity}
    if hdr != want_hdr:
        fail(f"header {hdr} != plan_gemm's {want_hdr}")
    # the mvout route: a raw int32 accumulator, then the epilogue pass
    acc = elaborate(cfg.replace(output_dtype="int32")).gemm(
        a, b, bias, dataflow=Dataflow.OS)
    y = kg.accumulator_epilogue(acc, out_dtype=torch.int8, shift=7,
                                activation=Activation.RELU)
    if not torch.equal(y, want_q):
        fail("mvout route (int32 GEMM + accumulator_epilogue) differs from "
             "the fused epilogue's oracle")

    routes = {
        "host im2col + OS GEMM": dict(fused=False, dataflow=Dataflow.OS),
        "host im2col + WS GEMM": dict(fused=False, dataflow=Dataflow.WS),
        "fused conv kernel": dict(fused=True),
    }

    def stream(route):
        return [inst.conv2d(x, w, b, stride=st, padding=p, shift=8,
                            activation=act, **routes[route])
                for _, x, w, b, st, p, act in layers]

    outs = {}
    for route in routes:
        outs[route] = stream(route)
        torch.cuda.synchronize()
        for (label, *_), got, want in zip(layers, outs[route], refs):
            if got.dtype != torch.int8 or not torch.equal(got, want):
                fail(f"resnet50 [{route}] layer {label}: differs from "
                     f"conv2d_ref")
    for got_os, got_ws in zip(*(outs[r] for r in list(routes)[:2])):
        if not torch.equal(got_os, got_ws):
            fail("resnet50: OS and WS outputs differ")
    counts = kernels.launch_counts()
    for name in kernels.ENGINE_KERNELS:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the engine path")
    log(f"engine launch counts: "
        f"{ {n: counts[n] for n in kernels.ENGINE_KERNELS} }")

    walls = {route: [] for route in routes}
    for rep in range(ENGINE_REPS):
        order = list(routes) if rep % 2 == 0 else list(routes)[::-1]
        for route in order:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stream(route)
            torch.cuda.synchronize()
            walls[route].append((time.perf_counter() - t0) * 1e3)
    ops = sum(2.0 * r.numel() * x.shape[-1] * w.shape[0] * w.shape[1]
              for (_, x, w, *_), r in zip(layers, refs))
    summary = {"layers": len(layers), "ops": ops, "routes": {}}
    for route, ws in walls.items():
        ms = statistics.median(ws)
        summary["routes"][route] = {"wall_ms": ms, "walls_ms": ws}
        log(f"resnet50 stream, {len(layers)} layers, batch 1, {route}: wall "
            f"{ms:.3f} ms (median of {ENGINE_REPS}; {ops / ms / 1e9:.2f} "
            f"TOP/s) on {smi}")
    for route in routes:
        summary["routes"][route]["profile"] = profile_call(
            torch, f"resnet50 [{route}]", lambda route=route: stream(route))
    log("engine: quickstart bit-exact on OS / WS / host conv / fused conv; "
        "header equals plan_gemm; mvout route bit-exact; resnet50 stream "
        "bit-exact on all three routes, OS == WS")
    return counts, summary


# ---------------------------------------------------------------------------
# phases 7-8: the recurrent and hybrid families served at full width
# ---------------------------------------------------------------------------
ATTN_KERNELS = ("flash_attention", "paged_prefill_attention",
                "paged_decode_attention", "decode_attention")


def serve_family(torch, np, arch, prompt_lens, new_tokens, chunk=256):
    """``arch`` at its published widths (bf16, weights from seed 0) through
    ``ServingEngine``: the requests are submitted at once, launch counts
    zeroed just before ``run`` and read just after. Returns (engine,
    prompts, counts, ssd launches on resumed chunks, summary)."""
    from repro_torch import configs, kernels
    from repro_torch.kernels import mamba2
    from repro_torch.serving import ServingEngine

    cfg = configs.get(arch)
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, max_slots=4, max_context=2048, page_size=64,
                           prefill_chunk=chunk, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(engine.params))
    log(f"{arch} full width: {n_params / 1e9:.3f} B parameters, "
        f"{cfg.n_layers} layers; init {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
               for n in prompt_lens]
    for p in prompts:
        engine.submit(p, new_tokens)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    report = engine.run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    resumed = mamba2.ssd.resumed_launches
    for r in report["requests"]:
        toks = np.asarray(r["tokens"])
        if r["status"] != "finished" or r["new_tokens"] != new_tokens or \
                toks.shape != (new_tokens,) or toks.min() < 0 or \
                toks.max() >= cfg.vocab:
            fail(f"{arch} request {r['rid']}: status {r['status']}, "
                 f"{r['new_tokens']} of {new_tokens} tokens")
    s = report["summary"]
    log(f"{arch} serve: {int(s['requests'])} requests, "
        f"{int(s['new_tokens'])} new tokens in {s['wall_s']:.3f} s = "
        f"{s['tokens_per_s']:.2f} tok/s; TTFT p50 "
        f"{s['p50_ttft_s'] * 1e3:.1f} ms p99 {s['p99_ttft_s'] * 1e3:.1f} ms; "
        f"ITL p50 {s['p50_itl_s'] * 1e3:.2f} ms p95 "
        f"{s['p95_itl_s'] * 1e3:.2f} ms; {int(s['prefill_chunks'])} "
        f"prefill chunks, {int(s['iterations'])} iterations, "
        f"{int(s['preemptions'])} preemptions; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"{arch} serve launch counts: {counts}; ssd on resumed chunks "
        f"{resumed}")
    return engine, prompts, counts, resumed, s


def as_fp32(torch, engine):
    """(model config, execution context, params) of ``engine`` in the fp32
    model dtype and engine config."""
    from repro_torch.core.config import GemminiConfig
    from repro_torch.core.context import ExecutionContext

    return (dataclasses.replace(engine.model_cfg, dtype=torch.float32),
            ExecutionContext(cfg=GemminiConfig(
                input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32")),
            _tree_map(lambda t: t.float(), engine.params))


def prefill_logits(torch, engine, prompt, fp32=False):
    """The prompt's fresh prefill logits on the card (kernels) and on the
    CPU (plain path), same weights; ``fp32`` runs both in the fp32 model
    dtype and engine config."""
    from repro_torch.models import transformer as tf

    cfg, ctx, params = as_fp32(torch, engine) if fp32 else \
        (engine.model_cfg, engine.engine, engine.params)
    mp = engine.max_pages_per_seq
    pages = torch.arange(mp, dtype=torch.int32)
    toks = torch.from_numpy(prompt[None])
    outs = {}
    for dev, p in (("cuda", params),
                   ("cpu", _tree_map(lambda t: t.cpu(), params))):
        state = tf.init_paged_state(cfg, 1, mp, engine.page_size, mp,
                                    dtype=cfg.dtype, device=dev)
        outs[dev], _ = tf.paged_prefill(ctx, p, cfg, toks.to(dev), state, 0,
                                        pages.to(dev),
                                        page_size=engine.page_size)
    return outs["cuda"].float().cpu(), outs["cpu"].float()


def rel_l2(got, want) -> float:
    return ((got - want).norm() / want.norm()).item()


def hold_bf16(name, card, cpu, exact):
    """bf16 logits on the card (kernels) against bf16 logits on the CPU
    (plain path), each measured from the CPU's fp32 logits on the same
    weights and tokens: the card's bf16 gap may be at most BF16_FACTOR
    times the CPU's. Both round at the same points (bf16 operands, fp32
    sums) in other orders, so their gaps should be alike; a kernel fault
    adds its own error on top. A fixed limit on the card-vs-CPU bf16 gap
    would not do: these random-weight stacks amplify rounding layer by
    layer (at mamba2-1.3b's 48 layers the CPU's own bf16 logits are
    further from its fp32 ones than the card's bf16 logits are from the
    CPU's), so that gap says more about depth than about the kernels."""
    g_card, g_cpu = rel_l2(card, exact), rel_l2(cpu, exact)
    log(f"{name}: bf16 relative L2 from the fp32 CPU logits: card "
        f"{g_card:.3e}, CPU {g_cpu:.3e} (ratio {g_card / g_cpu:.3f}, limit "
        f"{BF16_FACTOR}); card vs CPU in bf16 {rel_l2(card, cpu):.3e}")
    if not g_card <= BF16_FACTOR * g_cpu:
        fail(f"{name}: the card's bf16 logits are {g_card:.3e} from fp32, "
             f"over {BF16_FACTOR} x the CPU's {g_cpu:.3e}")
    return {"bf16_card_vs_fp32": g_card, "bf16_cpu_vs_fp32": g_cpu,
            "bf16_card_vs_cpu": rel_l2(card, cpu)}


def check_prefill_logits(torch, engine, prompt, name, fp32_limit):
    """The prompt's fresh prefill logits on the card (kernels) against the
    plain path on the CPU, same weights: in the fp32 model dtype and engine
    config within ``fp32_limit`` relative L2, and in bf16 by
    :func:`hold_bf16`."""
    cfg = engine.model_cfg
    out = {}
    for fp32 in (True, False):
        got, want = prefill_logits(torch, engine, prompt, fp32=fp32)
        if got.shape != (1, len(prompt) + cfg.n_meta_tokens, cfg.vocab) or \
                not torch.isfinite(got).all():
            fail(f"{name} logits: shape {tuple(got.shape)} or non-finite")
        out["fp32" if fp32 else "bf16"] = got, want
    rel = {"fp32": rel_l2(*out["fp32"]), "fp32_limit": fp32_limit}
    log(f"{name}: {len(prompt)}-token prefill logits vs the CPU plain path "
        f"in fp32: relative L2 error {rel['fp32']:.3e} (limit {fp32_limit})")
    if not rel["fp32"] <= fp32_limit:
        fail(f"{name} fp32 logits disagree with the plain path: "
             f"{rel['fp32']:.3e}")
    rel.update(hold_bf16(name, *out["bf16"], out["fp32"][1]))
    return rel


def profile_family(torch, engine):
    """``profile_call`` for one decode step of four slots at
    1000/512/300/64 cached tokens and one 256-token continuation chunk at
    position 768, with the recurrent state carried."""
    from repro_torch.models import transformer as tf

    cfg, ctx, params = engine.model_cfg, engine.engine, engine.params
    mp, page = engine.max_pages_per_seq, engine.page_size
    state = tf.init_paged_state(cfg, 4, 4 * mp, page, mp, dtype=cfg.dtype,
                                device="cuda")
    state.tables.copy_(torch.arange(4 * mp, dtype=torch.int32,
                                    device="cuda").reshape(4, mp))
    decode_state = state._replace(lengths=torch.tensor(
        [1000, 512, 300, 64], dtype=torch.int32, device="cuda"))
    active = torch.ones((4,), dtype=torch.bool, device="cuda")
    toks = torch.zeros((4, 1), dtype=torch.int32, device="cuda")
    chunk = torch.zeros((1, 256), dtype=torch.int32, device="cuda")
    steps = {
        "decode_step": lambda: tf.paged_decode_step(
            ctx, params, cfg, toks, decode_state, active, page_size=page),
        "prefill_chunk": lambda: tf.paged_prefill_chunk(
            ctx, params, cfg, chunk, state, 0, state.tables[0], 768,
            page_size=page, kv_pages=16),
    }
    return {name: profile_call(torch, f"{cfg.name} {name}", fn)
            for name, fn in steps.items()}


def run_ssm_phase(torch, np):
    """mamba2-1.3b, phase 4's traffic: the chunked SSD runs every prefill
    chunk (fresh and resumed), the GEMM every projection, and no attention
    kernel runs (the family has none)."""
    engine, prompts, counts, resumed, s = serve_family(
        torch, np, "mamba2-1.3b", SERVE_PROMPTS, SERVE_NEW)
    L = engine.model_cfg.n_layers
    chunks, reqs = int(s["prefill_chunks"]), int(s["requests"])
    want = {"ssd": chunks * L, "resumed": (chunks - reqs) * L}
    if counts["ssd"] != want["ssd"] or resumed != want["resumed"] or \
            resumed <= 0 or counts["gemm"] <= 0 or \
            any(counts[k] for k in ATTN_KERNELS) or s["preemptions"]:
        fail(f"mamba2-1.3b launch counts {counts} (ssd resumed {resumed}) "
             f"are not the path's: want ssd {want['ssd']} ({want['resumed']} "
             f"resumed) for {chunks} chunks x {L} layers, gemm > 0, no "
             f"attention kernel, no preemption")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, engine.model_cfg.vocab, (256,)).astype(np.int32)
    rel = check_prefill_logits(torch, engine, prompt, "mamba2-1.3b",
                               FP32_LOGITS_LIMIT["mamba2-1.3b"])
    profile = profile_family(torch, engine)
    return counts, resumed, {"summary": s, "logits_rel_l2": rel,
                             "profile": profile}


def run_hybrid_phase(torch, np):
    """hymba-1.5b (128 meta tokens, window 1024): every serving kernel
    runs -- flash on first chunks, paged prefill on continuations, paged
    decode, the SSD fresh and resumed, the GEMM."""
    engine, prompts, counts, resumed, s = serve_family(
        torch, np, "hymba-1.5b", (700, 200), 16)
    need = ("ssd", "flash_attention", "paged_prefill_attention",
            "paged_decode_attention", "gemm")
    if any(counts[k] <= 0 for k in need) or resumed <= 0:
        fail(f"hymba-1.5b: kernels of the path not launched: {counts} "
             f"(ssd resumed {resumed})")
    rel = check_prefill_logits(torch, engine, prompts[1][:128],
                               "hymba-1.5b", FP32_LOGITS_LIMIT["hymba-1.5b"])
    profile = profile_family(torch, engine)
    return counts, resumed, {"summary": s, "logits_rel_l2": rel,
                             "profile": profile}


# ---------------------------------------------------------------------------
# phase 9: the four-family gate, engine vs static path vs CPU, in fp32
# ---------------------------------------------------------------------------
def run_gate_phase(torch):
    """The port's ``serve_decode`` at smoke size with the fp32 model dtype
    and engine config: on the card the engine's greedy tokens must equal
    the static path's (dense decode kernel), and both the CPU plain
    path's."""
    from repro_torch import kernels
    from repro_torch.examples import serve_decode

    kernels.reset_launch_counts()
    card = {a: serve_decode.run_arch(a, device="cuda", fp32=True,
                                     verbose=False)
            for a in serve_decode.ARCHS}
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    for arch in serve_decode.ARCHS:
        cpu = serve_decode.run_arch(arch, device="cpu", fp32=True,
                                    verbose=False)
        got = card[arch]
        if not got["ok"] or got["engine"] != cpu["engine"] or \
                got["reference"] != cpu["reference"]:
            fail(f"gate {arch} fp32: engine {got['engine']} / static "
                 f"{got['reference']} on the card, engine {cpu['engine']} / "
                 f"static {cpu['reference']} on the CPU")
        log(f"gate {arch} fp32: engine == static path on the card == CPU "
            f"({sum(len(t) for t in got['engine'])} tokens)")
    if counts["decode_attention"] <= 0 or counts["ssd"] <= 0:
        fail(f"gate: the static path's kernels did not launch: {counts}")
    log(f"gate launch counts: {counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 10: the static reference path at full width
# ---------------------------------------------------------------------------
def static_path(torch, ctx, cfg, params, prompt, device, tokens=None):
    """``prefill_into_cache`` over ``prompt``, then STATIC_STEPS
    ``decode_step`` calls, one request with a dense KV cache. Greedy on the
    logits unless ``tokens`` gives the tokens to feed (teacher forcing).
    Returns the fed tokens and the (STATIC_STEPS + 1, vocab) fp32 logits
    of the prompt's last position and of every decode step."""
    from repro_torch.models import transformer as tf

    state = tf.init_decode_state(cfg, 1, len(prompt) + STATIC_STEPS,
                                 dtype=cfg.dtype, device=device)
    logits, state = tf.prefill_into_cache(
        ctx, params, cfg, torch.from_numpy(prompt[None]).to(device), state)
    rows, fed = [logits[0, -1].float().cpu()], []
    del logits
    for i in range(STATIC_STEPS):
        fed.append(int(tokens[i]) if tokens is not None else
                   int(torch.argmax(rows[-1])))
        logits, state = tf.decode_step(
            ctx, params, cfg, torch.tensor([[fed[-1]]], dtype=torch.int32,
                                           device=device), state)
        rows.append(logits[0, -1].float().cpu())
    return fed, torch.stack(rows)


def run_static_phase(torch, np, engine):
    """gemma3-1b at full width with phase 4's weights through the static
    path (``prefill_into_cache`` + ``decode_step``), bf16: the dense decode
    kernel runs every decode step of every layer, at the shapes phase 3
    holds it at. The card's logits are then held against the CPU plain
    path's, teacher-forced with the card's tokens, by :func:`hold_bf16`."""
    from repro_torch import kernels

    cfg = engine.model_cfg
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab, (STATIC_PROMPT,)).astype(np.int32)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    toks, card = static_path(torch, engine.engine, cfg, engine.params,
                             prompt, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    want = STATIC_STEPS * cfg.n_layers
    if counts["decode_attention"] != want or \
            any(counts[k] for k in ("paged_prefill_attention",
                                    "paged_decode_attention")):
        fail(f"static path launch counts {counts}: want decode_attention "
             f"{want} ({STATIC_STEPS} steps x {cfg.n_layers} layers) and no "
             f"paged kernel")
    if not torch.isfinite(card).all() or min(toks) < 0 or \
            max(toks) >= cfg.vocab:
        fail(f"static path: non-finite logits or bad tokens {toks}")
    log(f"static path gemma3-1b full width: {STATIC_PROMPT}-token prompt + "
        f"{STATIC_STEPS} decode steps in {wall:.3f} s; launch counts "
        f"{counts}")
    cpu_params = _tree_map(lambda t: t.cpu(), engine.params)
    _, cpu = static_path(torch, engine.engine, cfg, cpu_params, prompt,
                         "cpu", tokens=toks)
    del cpu_params
    cfg32, ctx32, params32 = as_fp32(torch, engine)
    _, exact = static_path(torch, ctx32, cfg32,
                           _tree_map(lambda t: t.cpu(), params32), prompt,
                           "cpu", tokens=toks)
    rel = hold_bf16("static path gemma3-1b", card, cpu, exact)
    return counts, {"wall_s": wall, "tokens": toks, "logits_rel_l2": rel}


# ---------------------------------------------------------------------------
def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, SRC)
    sys.path.insert(0, os.path.join(ROOT, "tests"))     # _ssd_exact
    import numpy as np

    from repro_torch import kernels
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.makedirs(OUT_DIR, exist_ok=True)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")

    # 2. build
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        f"({', '.join(f'{k} {v:.1f} s' for k, v in secs.items())}) into "
        f"{_build.build_dir()}")
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "entry function" in ln or "registers" in ln
                    or "spill" in ln]
             for name in secs}
    # the redesigned attention kernels: entry, spills, registers
    att = ptxas.get("attention", [])
    for i, ln in enumerate(att):
        if "flash_tc_kernel" in ln or "decode_split_kernel" in ln:
            log("ptxas " + " | ".join(att[i:i + 3]))

    # 3. kernels
    timer = Timer(torch)
    rows, rep_rows = run_kernel_phase(torch, timer)
    del timer
    torch.cuda.empty_cache()

    # 4. serve at full width (the main path: counts zeroed inside)
    counts, serve_summary, profile, engine = run_serve_phase(torch, np)
    torch.cuda.empty_cache()

    # 5. fp32 end to end, card against CPU
    run_e2e_phase(torch, np)
    torch.cuda.empty_cache()

    # 6. the Gemmini engine path (its own main path: counts zeroed inside)
    engine_counts, engine_summary = run_engine_phase(torch, smi)
    torch.cuda.empty_cache()

    # 7-8. the recurrent and hybrid families at full width (each its own
    # main path: counts zeroed inside)
    ssm_counts, ssm_resumed, ssm_summary = run_ssm_phase(torch, np)
    torch.cuda.empty_cache()
    hybrid_counts, hybrid_resumed, hybrid_summary = run_hybrid_phase(torch,
                                                                     np)
    torch.cuda.empty_cache()

    # 9. the four-family gate at smoke size
    gate_counts = run_gate_phase(torch)
    torch.cuda.empty_cache()

    # 10. the static path at full width (the dense decode kernel's main
    # path: counts zeroed inside)
    static_counts, static_summary = run_static_phase(torch, np, engine)
    del engine
    torch.cuda.empty_cache()

    # 11. the kernels line
    meta = {
        "gemm": ("csrc/gemm.cu", "src/repro/kernels/gemm.py:105"),
        "flash_attention": ("csrc/attention.cu",
                            "src/repro/kernels/attention.py:162"),
        "paged_prefill_attention": ("csrc/attention.cu",
                                    "src/repro/kernels/attention.py:558"),
        "paged_decode_attention": ("csrc/attention.cu",
                                   "src/repro/kernels/attention.py:418"),
        "gemm[int8]": ("csrc/gemm.cu", "src/repro/kernels/gemm.py:105"),
        "gemm_ws": ("csrc/gemm.cu", "src/repro/kernels/gemm.py:184"),
        "accumulator_epilogue": ("csrc/gemm.cu",
                                 "src/repro/kernels/gemm.py:217"),
        "conv2d_implicit": ("csrc/conv.cu", "src/repro/kernels/conv.py:140"),
        "ssd": ("csrc/ssd.cu", "src/repro/kernels/mamba2.py:151"),
        "decode_attention": ("csrc/attention.cu",
                             "src/repro/kernels/attention.py:276"),
    }
    line = []
    for name, (src, replaces) in meta.items():
        r = rep_rows[name]
        launches = (engine_counts if name in kernels.ENGINE_KERNELS else
                    ssm_counts if name in kernels.RECURRENT_KERNELS else
                    static_counts if name in kernels.STATIC_KERNELS else
                    counts)[name]
        if launches <= 0:
            fail(f"kernel {name}: no launch on its main path")
        line.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/" + src,
                     "replaces": replaces, "launches": launches,
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi, "build_s": secs,
                   "ptxas": ptxas, "kernels": rows, "serve": serve_summary,
                   "serve_launches": counts, "profile": profile,
                   "engine": engine_summary,
                   "engine_launches": engine_counts,
                   "ssm": ssm_summary, "ssm_launches": ssm_counts,
                   "ssm_resumed_ssd_launches": ssm_resumed,
                   "hybrid": hybrid_summary, "hybrid_launches": hybrid_counts,
                   "hybrid_resumed_ssd_launches": hybrid_resumed,
                   "gate_launches": gate_counts,
                   "static": static_summary,
                   "static_launches": static_counts}, f, indent=1)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
