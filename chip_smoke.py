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
   softcap, sliding window). Times are CUDA-event medians with the L2
   cache flushed before each launch; bounds use 3.35 TB/s and 989 TFLOP/s
   (bf16 tensor rate; 67 TFLOP/s for fp32 inputs);
4. serve: gemma3-1b at full width (26 layers, random weights from a seed)
   through ``ServingEngine``: four requests, prompts of 1000, 512, 300 and
   64 tokens, 32 new tokens each, 256-token prefill chunks; launch counts
   are zeroed just before and read just after, and every kernel must have
   run; the first request's prefill logits at full width are held against
   the plain path on the CPU;
5. end to end against plain: the smoke gemma3-1b and qwen1.5-4b configs in
   fp32 (model dtype and engine config) on the card and on the CPU, with
   the same weights and prompts, must give equal greedy tokens.

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
PEAK_FLOPS = {"bf16": 989e12, "fp32": 67e12}
REPS = 25


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
    fp32: 1e-5 relative plus 1e-6 of the largest magnitude (sum order)."""
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
    def flash_case(t_q, t_k, h, kvh, dh, window, softcap, rep):
        q = randn(1, t_q, h, dh)
        k, v = randn(1, t_k, kvh, dh), randn(1, t_k, kvh, dh)
        kw = dict(causal=True, window=window, softcap=softcap)
        pairs = sum(min(i + t_k - t_q + 1, window or 1 << 30)
                    for i in range(t_q))
        nbytes = 2 * (2 * t_q * h * dh + 2 * t_k * kvh * dh)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=True, enable_gqa=True)
        lib = library if (window is None and softcap is None and
                          t_q == t_k) else None
        cases.append(("flash_attention",
                      f"Tq={t_q} Tk={t_k} H={h} KVH={kvh} D={dh} "
                      f"window={window} softcap={softcap}", rep, "bf16",
                      lambda: ka.flash_attention(q, k, v, **kw),
                      lambda: ka.blockwise_attention(q, k, v, **kw), lib,
                      nbytes, 4.0 * dh * h * pairs))
    flash_case(256, 256, nh, nkv, hd, None, None, True)
    flash_case(256, 256, nh, nkv, hd, cfg.local_window, None, False)
    flash_case(64, 64, nh, nkv, hd, None, None, False)
    flash_case(64, 64, nh, nkv, hd, cfg.local_window, None, False)
    flash_case(100, 200, 8, 2, 128, 64, 50.0, False)

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
    return cases


def run_kernel_phase(torch, timer):
    rows, summary = [], {}
    for (kernel, label, rep, kind, run_k, run_p, run_lib, nbytes,
         flops) in kernel_cases(torch):
        got = run_k()
        torch.cuda.synchronize()
        want = run_p()
        err = check_close(torch, f"{kernel} [{label}]", got, want, kind)
        ms = timer(run_k)
        host_ms = timer.host_ms(run_k)
        plain_ms = timer(run_p)
        lib_ms = timer(run_lib) if run_lib is not None else None
        b_ms, b_by = bound_ms(nbytes, flops, kind)
        row = {"name": kernel, "shape": label, "max_abs_err": err, "ms": ms,
               "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops}
        rows.append(row)
        log(f"{kernel:<24} {label:<62} err {err:.2e}  kernel {ms:8.4f} ms "
            f"(host {host_ms:7.4f})  plain {plain_ms:8.4f} ms  library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f} ms':>10}  bound "
            f"{b_ms:.4f} ms ({b_by})")
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
    return counts, s, run_profile_phase(torch, engine)


# ---------------------------------------------------------------------------
# phase 4b: where a full-width decode step and prefill chunk spend time
# ---------------------------------------------------------------------------
_KERNEL_NAMES = (("gemm_bf16_kernel", "gemm"), ("gemm_f32_kernel", "gemm"),
                 ("paged_decode_kernel", "paged_decode_attention"),
                 ("true>", "paged_prefill_attention"),
                 ("prefill_attn_kernel", "flash_attention"))


def _kernel_class(name: str) -> str:
    for key, cls in _KERNEL_NAMES:
        if key in name:
            return cls
    return "other"


def run_profile_phase(torch, engine):
    """Wall time of one synchronised call against the device time of every
    kernel ``torch.profiler`` saw in it, for one decode step of four slots
    at 1000/512/300/64 cached tokens and for one 256-token continuation
    chunk at position 768 (the serve phase's shapes)."""
    from torch.profiler import ProfilerActivity, profile

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
    out = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        n = 3
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
        out[name] = {"wall_ms": wall, "device_ms": device,
                     "device_busy_share": device / wall,
                     "device_ms_by_kernel": by_class,
                     "launches_by_kernel": launches}
        if device == 0.0:
            log(f"profile {name}: wall {wall:.3f} ms; device time not "
                f"measured (the profiler saw no CUDA kernel)")
            continue
        parts = ", ".join(f"{k} {v:.3f} ms x{launches[k]}" for k, v in
                          sorted(by_class.items(), key=lambda kv: -kv[1]))
        log(f"profile {name}: wall {wall:.3f} ms, device busy "
            f"{device:.3f} ms ({device / wall:.1%}); {parts}")
    return out


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
def main() -> int:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a card")
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        fail(f"no src/repro_torch beside {__file__}: run it from a checkout")
    sys.path.insert(0, SRC)
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
                    if "registers" in ln or "spill" in ln]
             for name in secs}

    # 3. kernels
    timer = Timer(torch)
    rows, rep_rows = run_kernel_phase(torch, timer)
    del timer
    torch.cuda.empty_cache()

    # 4. serve at full width (the main path: counts zeroed inside)
    counts, serve_summary, profile = run_serve_phase(torch, np)
    torch.cuda.empty_cache()

    # 5. fp32 end to end, card against CPU
    run_e2e_phase(torch, np)

    # 6. the kernels line
    meta = {
        "gemm": ("csrc/gemm.cu", "src/repro/kernels/gemm.py:105"),
        "flash_attention": ("csrc/attention.cu",
                            "src/repro/kernels/attention.py:162"),
        "paged_prefill_attention": ("csrc/attention.cu",
                                    "src/repro/kernels/attention.py:558"),
        "paged_decode_attention": ("csrc/attention.cu",
                                   "src/repro/kernels/attention.py:418"),
    }
    line = []
    for name, (src, replaces) in meta.items():
        r = rep_rows[name]
        line.append({"name": name, "route": "cuda",
                     "source": "src/repro_torch/kernels/" + src,
                     "replaces": replaces, "launches": counts[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"], "shape": r["shape"]})
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump({"device": kind, "nvidia_smi": smi, "build_s": secs,
                   "ptxas": ptxas, "kernels": rows, "serve": serve_summary,
                   "serve_launches": counts, "profile": profile}, f,
                  indent=1)
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
