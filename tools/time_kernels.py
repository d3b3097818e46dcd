"""Device time of kernels for a same-card comparison of two checkouts: the
bf16 engine GEMM at gemma3-1b's 24 serving shapes (7 projections and the
tied unembedding at M = 4, 64 and 256, the rows of ``chip_smoke.py`` phase
3, with ``torch.matmul`` beside each), fp32 ``flash_attention`` at the fp32
gate's prompts, the paged attention kernels at gemma3-1b's serving shapes
(paged decode global and with the 512-key window), and the bf16 chunked
SSD at mamba2-1.3b's and hymba-1.5b's widths (the serving call, 256 tokens
resumed, and 1000 tokens fresh). It times the ``repro_torch`` package
found under ``--src``, so two checkouts compare on one card, run after
run:

  python3 tools/time_kernels.py --src OTHER_CHECKOUT/src --tag parent
  python3 tools/time_kernels.py --tag change
  python3 tools/time_kernels.py --only ssd    # one group: gemm, attention, ssd

Each output is held against its plain version (``chip_smoke.check_close``)
and timed with ``chip_smoke.Timer`` (CUDA events, L2 flushed, median of
25), beside the host's cost of one call launched back to back
(``enqueue_us``). Prints one JSON line ``{"tag", "device", "rows": [...], "gemm_step_sums"}``
(the GEMM's sum over one decode step, M = 4, and one prefill chunk, M =
256); needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def gemm_cases(torch, cs):
    """(kernel, label, kind, run_kernel, run_plain, run_library, (bytes,
    operations))."""
    from repro_torch.kernels import gemm as kg

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    return [("gemm", f"{name} M={m} N={n} K={k}", "bf16", run_k, run_p,
             run_lib, (2 * (m * k + k * n + m * n), 2.0 * m * n * k))
            for name, m, n, k, run_k, run_p, run_lib
            in cs.gemm_serving_cases(torch, randn, kg.gemm)]


def attention_cases(torch):
    """(kernel, label, kind, run_kernel, run_plain, None, (bytes,
    operations) or None)."""
    from repro_torch import configs
    from repro_torch.examples import serve_decode as sd
    from repro_torch.kernels import attention as ka

    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    out = []
    for arch in sd.ARCHS:
        sc = configs.get_smoke(arch)
        if not sc.has_attn:
            continue
        t = max(sd.PROMPT_LENS) + sc.n_meta_tokens
        for window in (None, sc.local_window) if sc.local_window else (None,):
            q = randn(1, t, sc.n_heads, sc.head_dim, dtype=torch.float32)
            k, v = (randn(1, t, sc.n_kv_heads, sc.head_dim,
                          dtype=torch.float32) for _ in range(2))
            kw = dict(window=window, softcap=sc.attn_softcap)
            out.append(("flash_attention",
                        f"fp32 {arch} T={t} H={sc.n_heads} "
                        f"KVH={sc.n_kv_heads} D={sc.head_dim} window={window} "
                        f"softcap={sc.attn_softcap}", "fp32",
                        lambda q=q, k=k, v=v, kw=kw:
                            ka.flash_attention(q, k, v, **kw),
                        lambda q=q, k=k, v=v, kw=kw:
                            ka.blockwise_attention(q, k, v, **kw), None, None))

    g3 = configs.get("gemma3-1b")
    h, kvh, d, page, n_pages = g3.n_heads, g3.n_kv_heads, g3.head_dim, 64, 128
    kp, vp = (randn(kvh, n_pages + 1, page, d) for _ in range(2))
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    table = perm[:16].to(torch.int32)
    qp = randn(1, 256, h, d)
    out.append(("paged_prefill_attention", "T=256 start=768 global", "bf16",
                lambda: ka.paged_prefill_attention(qp, kp, vp, table, 768),
                lambda: ka.paged_prefill_attention_plain(qp, kp, vp, table,
                                                         768), None, None))
    lengths = [1010, 530, 310, 80]
    tables = perm[:4 * 32].reshape(4, 32).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    qd = randn(4, 1, h, d)
    for window in (None, g3.local_window):
        live = sum(min(n, window or 1 << 30) for n in lengths)
        work = (2 * (2 * 4 * h * d + 2 * live * kvh * d) + 4 * 4 * 33,
                4.0 * d * h * live)
        out.append(("paged_decode_attention",
                    f"lengths={lengths} window={window}", "bf16",
                    lambda w=window: ka.paged_decode_attention(
                        qd, kp, vp, tables, lens, window=w),
                    lambda w=window: ka.paged_decode_attention_plain(
                        qd, kp, vp, tables, lens, window=w), None, work))
    return out


def ssd_cases(torch, cs):
    """The bf16 chunked SSD (y held against the plain version)."""
    from repro_torch import configs
    from repro_torch.kernels import mamba2 as km

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = []
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        cfg = configs.get(arch)
        h, p, g, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
            cfg.d_state
        for t, resume in ((256, True), (1000, False)):
            def randn(*shape, scale=1.0, dtype=torch.bfloat16):
                return (torch.randn(shape, generator=gen, device="cuda")
                        * scale).to(dtype)
            x = randn(1, t, h, p)
            b, c = randn(1, t, g, n, scale=0.3), randn(1, t, g, n, scale=0.3)
            dt = torch.nn.functional.softplus(randn(1, t, h,
                                                    dtype=torch.float32))
            a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
            kw = dict(d_skip=torch.ones((h,), device="cuda"),
                      chunk=cfg.ssm_chunk, return_final_state=True,
                      initial_state=randn(1, h, n, p, scale=0.5,
                                          dtype=torch.float32)
                      if resume else None)
            nbytes = (2 * 2 * t * h * p + 2 * 2 * t * g * n + 4 * t * h +
                      8 * h + 4 * h * n * p * (2 if resume else 1))
            out.append(("ssd", f"{arch} T={t} "
                        f"{'resumed' if resume else 'fresh'}", "bf16",
                        lambda x=x, b=b, c=c, dt=dt, a=a_log, kw=kw:
                            km.ssd(x, dt, a, b, c, **kw)[0],
                        lambda x=x, b=b, c=c, dt=dt, a=a_log, kw=kw:
                            km.ssd_plain(x, dt, a, b, c, **kw)[0], None,
                        (nbytes, cs.ssd_flops(t, h, p, g, n, cfg.ssm_chunk,
                                              resume))))
    return out


def enqueue_us(torch, fn, n=50):
    """Host microseconds per call of ``fn`` launched back to back (the
    wrapper's own cost: argument checks, plan and workspace lookups, the
    launch), with the card busy behind it."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=os.path.join(ROOT, "src"),
                    help="directory holding the repro_torch package to time")
    ap.add_argument("--tag", default="", help="names the run in the output")
    ap.add_argument("--only", choices=("gemm", "attention", "ssd"),
                    help="time one group of kernels")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_kernels: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch import configs
    from repro_torch.kernels import _build

    _build.build()
    timer = cs.Timer(torch)
    cases = []
    if args.only in (None, "gemm"):
        cases += gemm_cases(torch, cs)
    if args.only in (None, "attention"):
        cases += attention_cases(torch)
    if args.only in (None, "ssd"):
        cases += ssd_cases(torch, cs)
    rows = []
    for kernel, label, kind, run_k, run_p, run_lib, work in cases:
        err = cs.check_close(torch, f"{kernel} {label}", run_k(), run_p(),
                             kind)
        row = {"kernel": kernel, "shape": label, "max_abs_err": err,
               "ms": timer(run_k), "enqueue_us": enqueue_us(torch, run_k)}
        if run_lib is not None:
            row["library_ms"] = timer(run_lib)
        if work is not None:
            row["bound_ms"] = cs.bound_ms(*work, kind)[0]
        rows.append(row)
        lib = f"  library {row['library_ms']:.4f} ms" if "library_ms" in row \
            else ""
        print(f"[time_kernels] {args.tag} {kernel:<24} {label:<60} "
              f"{row['ms']:.4f} ms{lib}  enqueue {row['enqueue_us']:.1f} us  "
              f"err {err:.2e}", flush=True)
    sums = cs.gemm_step_sums([r for r in rows if r["kernel"] == "gemm"],
                             configs.get("gemma3-1b").n_layers)
    for m, sm in sorted(sums.items()):
        print(f"[time_kernels] {args.tag} gemm step sum M={m}: kernel "
              f"{sm['ms']:.4f} ms  torch.matmul {sm['library_ms']:.4f} ms",
              flush=True)
    print(json.dumps({"tag": args.tag, "device": torch.cuda.get_device_name(0),
                      "src": os.path.abspath(args.src), "rows": rows,
                      "gemm_step_sums": sums}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
