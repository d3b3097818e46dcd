"""Serving entry point over the port's continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --batch 4 --prompt-len 512 --gen 32

runs gemma3-1b at full width on the card with random weights drawn from
``--seed``; ``--smoke`` selects the reduced config and ``--device cpu`` the
plain path on the CPU. Every registered arch serves: the dense ones, the
recurrent mamba2-1.3b, the hybrid hymba-1.5b and the four-codebook
musicgen-medium (prompts and outputs then carry a trailing codebook axis).

The robustness and observability flags are the JAX CLI's: ``--faults``
(a ``GEMMINI_FAULTS``-grammar plan), ``--enforce-deadlines`` and
``--deadline S``, ``--trace`` / ``--trace-out PATH`` (a Chrome trace,
summarized by ``python -m repro_torch.obs PATH``) and ``--profile``
(every ExecutionContext op timed, on a card by CUDA events, and its
achieved share of the card's roofline printed per bucket). ``--tune
{off,cached,full}`` (or ``GEMMINI_TUNE``; the file from
``GEMMINI_TUNE_CACHE``) resolves the page size and the paged decode split
at startup and warms every schedule the prompt length will launch, then
prints the warm-up's hits and misses.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.core import flags
from repro_torch.obs import profile as oprofile
from repro_torch.obs import trace as otrace
from repro_torch.serving import ServingEngine


def serve(model_cfg, *, batch: int, prompt_len: int, gen_len: int,
          temperature: float = 1.0, seed: int = 0, eos_id: int = -1,
          policy: str = "continuous", max_slots: int = 0,
          page_size: int = 0, prefill_chunk: int = 0,
          admission_policy: str = "fifo", faults: str = "",
          enforce_deadlines: bool = False, deadline_s: float = 0.0,
          trace=None, kv_offload: bool = False,
          prefix_cache: bool = False, host_pool_pages: int = 0,
          device: str = "cuda"):
    """Serve ``batch`` random-prompt requests; returns tokens (B, gen[, n_q]),
    t_prefill, t_decode, tok_per_s, and the engine's telemetry under
    ``report`` (the JAX CLI's schema).

    ``faults``: a ``GEMMINI_FAULTS``-grammar plan (empty = env / off);
    ``enforce_deadlines`` sheds expired requests instead of serving them;
    ``deadline_s`` stamps every request with a relative SLO (0 =
    best-effort). ``trace`` follows ``ServingEngine(trace=)``; the
    engine's tracer is installed process-globally for the run, so fault
    firings and profiled op spans land on the same timeline."""
    rng = np.random.default_rng(seed)
    max_slots = max_slots or min(batch, 8)
    max_context = prompt_len + gen_len + 64
    engine = ServingEngine(
        model_cfg, max_slots=max_slots, max_context=max_context,
        page_size=page_size or None, seed=seed, temperature=temperature,
        policy=policy, warm_prompt_lens=[prompt_len],
        prefill_chunk=None if prefill_chunk < 0 else prefill_chunk,
        admission_policy=admission_policy, faults=faults or None,
        enforce_deadlines=enforce_deadlines, trace=trace,
        kv_offload=kv_offload, prefix_cache=prefix_cache,
        host_pool_pages=host_pool_pages or None, device=device)
    if engine.tracer is not None:
        otrace.install(engine.tracer)
    if engine.warm_stats is not None:
        from repro_torch import tune
        s = engine.warm_stats
        print(f"[serve] plan warmup ({flags.get('tune_mode')}): "
              f"{s['gemm_shapes']} gemm + {s['attn_shapes']} attn + "
              f"{s['paged_shapes']} paged shapes, {s['cache_hits']} cache "
              f"hits, {s['cache_misses']} misses "
              f"(cache: {tune.default_cache_path()})")
        print(f"[serve] paged cache: page={engine.page_size} tokens, "
              f"decode split={engine.engine.decode_split or 64} keys, "
              f"arena={engine.alloc.n_pages} pages")
    tok_shape = (prompt_len, model_cfg.n_codebooks) \
        if model_cfg.n_codebooks > 1 else (prompt_len,)
    # Deadlines are absolute timestamps on the engine's clock.
    deadline = (engine.now() + deadline_s) if deadline_s > 0 else None
    for _ in range(batch):
        prompt = rng.integers(0, model_cfg.vocab, tok_shape).astype(np.int32)
        engine.submit(prompt, gen_len, eos_id=eos_id, deadline=deadline)
    t0 = time.time()
    try:
        report = engine.run()
    finally:
        if engine.tracer is not None and otrace.active() is engine.tracer:
            otrace.deactivate()
    wall = time.time() - t0
    outs = []
    for r in report["requests"]:
        toks = np.asarray(r["tokens"], np.int32).reshape(
            (-1,) + tok_shape[1:])
        pad_shape = (gen_len - toks.shape[0],) + toks.shape[1:]
        outs.append(np.concatenate([toks, np.zeros(pad_shape, np.int32)]))
    summ = report["summary"]
    ttft = max(r["ttft_s"] or 0.0 for r in report["requests"])
    return dict(tokens=np.stack(outs), t_prefill=ttft, t_decode=wall - ttft,
                tok_per_s=summ["tokens_per_s"], report=report, engine=engine)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", choices=("continuous", "static"),
                    default="continuous")
    ap.add_argument("--slots", type=int, default=0,
                    help="decode slots (default: min(batch, 8))")
    ap.add_argument("--page-size", type=int, default=0,
                    help="KV page size (default: tuned or 64)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill granularity in tokens; 0 = one "
                         "page, negative = single-pass prefill")
    ap.add_argument("--admission", choices=("fifo", "priority", "deadline"),
                    default="fifo")
    ap.add_argument("--kv-offload", action="store_true")
    ap.add_argument("--host-pool-pages", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--faults", default="",
                    help="deterministic fault-injection spec "
                         "(GEMMINI_FAULTS grammar, e.g. "
                         "'seed=7;nan@decode:p=0.2,max=2'); empty = "
                         "$GEMMINI_FAULTS / off")
    ap.add_argument("--enforce-deadlines", action="store_true",
                    help="shed requests whose deadline passed "
                         "(terminal deadline_missed status) instead of "
                         "serving them to completion")
    ap.add_argument("--deadline", type=float, default=0.0, metavar="S",
                    help="per-request SLO: stamp every request with "
                         "submit-time + S seconds (0 = best-effort)")
    ap.add_argument("--trace", action="store_true",
                    help="record request/engine/allocator/fault spans and "
                         "export a Chrome-trace JSON (see --trace-out); "
                         "off by default, also togglable via $GEMMINI_TRACE")
    ap.add_argument("--trace-out", default="TRACE_serve.json", metavar="PATH",
                    help="Chrome-trace output path for --trace (default: "
                         "TRACE_serve.json; summarize with python -m "
                         "repro_torch.obs PATH)")
    ap.add_argument("--profile", action="store_true",
                    help="time every ExecutionContext op (CUDA events on "
                         "a card, synchronised per op) and print achieved-"
                         "vs-roofline utilization per kernel bucket")
    ap.add_argument("--tune", choices=flags.TUNE_MODES, default=None,
                    help="kernel-schedule tuning mode (default: "
                         "$GEMMINI_TUNE)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (plain path)")
    args = ap.parse_args(argv)
    # Always re-set: set_flag validates, so a mistyped $GEMMINI_TUNE fails
    # at startup instead of at the first schedule resolution.
    flags.set_flag("tune_mode", args.tune if args.tune is not None
                   else flags.get("tune_mode"))
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    profiler = None
    if args.profile:
        profiler = oprofile.install(oprofile.Profiler())
        print("[serve] profiling: per-op timing, one synchronisation per op")
    try:
        out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    gen_len=args.gen, temperature=args.temperature,
                    seed=args.seed, policy=args.policy, max_slots=args.slots,
                    page_size=args.page_size,
                    prefill_chunk=args.prefill_chunk,
                    admission_policy=args.admission, faults=args.faults,
                    enforce_deadlines=args.enforce_deadlines,
                    deadline_s=args.deadline,
                    trace=True if args.trace else None,
                    kv_offload=args.kv_offload,
                    prefix_cache=args.prefix_cache,
                    host_pool_pages=args.host_pool_pages, device=args.device)
    finally:
        if profiler is not None:
            oprofile.deactivate()
    s = out["report"]["summary"]

    def ms(v):
        return "n/a" if v is None else f"{v * 1e3:.1f}ms"

    print(f"[serve] {args.arch} on {args.device}: {int(s['requests'])} reqs, "
          f"{int(s['new_tokens'])} tokens in {s['wall_s'] * 1e3:.0f}ms "
          f"({out['tok_per_s']:.1f} tok/s), TTFT max {ms(out['t_prefill'])}, "
          f"ITL p50 {ms(s['p50_itl_s'])} / p95 {ms(s['p95_itl_s'])}, "
          f"{int(s['prefill_chunks'])} prefill chunks, "
          f"preemptions {int(s['preemptions'])}, out shape "
          f"{out['tokens'].shape}")
    if s["injected_faults"] or s["retries"] or s["fallbacks"] or s["shed"]:
        faults_seen = out["report"].get("faults", {})
        print(f"[serve] robustness: {int(s['injected_faults'])} injected "
              f"({faults_seen}), {int(s['retries'])} retries, "
              f"{int(s['fallbacks'])} re-run fallbacks, "
              f"{int(s['shed'])} shed, "
              f"{int(s['straggler_steps'])} straggler steps, "
              f"quarantined {out['report']['quarantined'] or 'none'}")
    tracer = out["engine"].tracer
    if tracer is not None and args.trace:
        tracer.export_chrome(args.trace_out)
        print(f"[serve] trace: {len(tracer.events)} events "
              f"({tracer.dropped} dropped) -> {args.trace_out} "
              f"(summarize: python -m repro_torch.obs {args.trace_out})")
    if profiler is not None:
        print(profiler.report())
    return out


if __name__ == "__main__":
    main()
