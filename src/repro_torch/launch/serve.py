"""Serving entry point over the port's continuous-batching engine.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
      --batch 4 --prompt-len 512 --gen 32

runs gemma3-1b at full width on the card with random weights drawn from
``--seed``; ``--smoke`` selects the reduced config and ``--device cpu`` the
plain path on the CPU. Every registered arch serves: the dense ones, the
recurrent mamba2-1.3b, the hybrid hymba-1.5b and the four-codebook
musicgen-medium (prompts and outputs then carry a trailing codebook axis).
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import configs
from repro_torch.serving import ServingEngine


def serve(model_cfg, *, batch: int, prompt_len: int, gen_len: int,
          temperature: float = 1.0, seed: int = 0, eos_id: int = -1,
          policy: str = "continuous", max_slots: int = 0,
          page_size: int = 0, prefill_chunk: int = 0,
          admission_policy: str = "fifo", kv_offload: bool = False,
          prefix_cache: bool = False, host_pool_pages: int = 0,
          device: str = "cuda"):
    """Serve ``batch`` random-prompt requests; returns tokens (B, gen[, n_q]),
    t_prefill, t_decode, tok_per_s, and the engine's telemetry under
    ``report`` (the JAX CLI's schema)."""
    rng = np.random.default_rng(seed)
    max_slots = max_slots or min(batch, 8)
    max_context = prompt_len + gen_len + 64
    engine = ServingEngine(
        model_cfg, max_slots=max_slots, max_context=max_context,
        page_size=page_size or None, seed=seed, temperature=temperature,
        policy=policy,
        prefill_chunk=None if prefill_chunk < 0 else prefill_chunk,
        admission_policy=admission_policy, kv_offload=kv_offload,
        prefix_cache=prefix_cache, host_pool_pages=host_pool_pages or None,
        device=device)
    tok_shape = (prompt_len, model_cfg.n_codebooks) \
        if model_cfg.n_codebooks > 1 else (prompt_len,)
    for _ in range(batch):
        prompt = rng.integers(0, model_cfg.vocab, tok_shape).astype(np.int32)
        engine.submit(prompt, gen_len, eos_id=eos_id)
    t0 = time.time()
    report = engine.run()
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
                    help="KV page size (default 64)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked-prefill granularity in tokens; 0 = one "
                         "page, negative = single-pass prefill")
    ap.add_argument("--admission", choices=("fifo", "priority", "deadline"),
                    default="fifo")
    ap.add_argument("--kv-offload", action="store_true")
    ap.add_argument("--host-pool-pages", type=int, default=0)
    ap.add_argument("--prefix-cache", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (plain path)")
    args = ap.parse_args(argv)
    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    out = serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                gen_len=args.gen, temperature=args.temperature,
                seed=args.seed, policy=args.policy, max_slots=args.slots,
                page_size=args.page_size, prefill_chunk=args.prefill_chunk,
                admission_policy=args.admission, kv_offload=args.kv_offload,
                prefix_cache=args.prefix_cache,
                host_pool_pages=args.host_pool_pages, device=args.device)
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
    return out


if __name__ == "__main__":
    main()
