"""Serving gate: the continuous-batching engine against the static
reference path, across model families (port of ``examples/serve_decode.py``).

  PYTHONPATH=src python -m repro_torch.examples.serve_decode [--device cpu] [--fp32]

Drives the port's ``ServingEngine`` (paged KV cache, continuous batching,
chunked prefill) for one arch of each family -- dense attention
(gemma2-2b), SSM (mamba2-1.3b, recurrent state), hybrid (hymba-1.5b, both,
with meta tokens) and multi-codebook audio (musicgen-medium) -- at smoke
size, and re-derives every request's greedy token stream through the
static reference path (``prefill_into_cache`` + ``decode_step``, one
request at a time, dense KV cache). The process exits 1 on any mismatch.
Chunked prefill is on (8 cache positions per chunk), so the comparison
also holds that splitting a prompt across chunk calls -- self-attention
for chunk 0, the block-table gather for continuations, resumed conv / SSM
state for the recurrent families -- reproduces the single-pass stream.

``--device cuda`` (the default) runs the engine on the paged, flash and
SSD kernels and the static path on the flash, dense decode and SSD kernels;
``--device cpu`` runs every plain version. ``--fp32`` makes the model dtype
and the engine config fp32 (the default is bf16, the JAX gate's). Weights
come from a seeded CPU generator, so both devices serve the same model.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Dict, List

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core.config import GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.models import transformer as tf
from repro_torch.serving import ServingEngine

ARCHS = ["gemma2-2b", "mamba2-1.3b", "hymba-1.5b", "musicgen-medium"]
PROMPT_LENS = [11, 16, 7]          # mixed lengths: distinct page counts
GEN_LENS = [6, 3, 5]               # mixed depths: slots recycle mid-run
PREFILL_CHUNK = 8                  # < the longer prompts: multi-chunk paths


def engine_config(fp32: bool) -> GemminiConfig:
    dt = "fp32" if fp32 else "bf16"
    return GemminiConfig(input_dtype=dt, acc_dtype="fp32", output_dtype=dt)


def model_config(arch: str, fp32: bool):
    cfg = configs.get_smoke(arch)
    return dataclasses.replace(cfg, dtype=torch.float32) if fp32 else cfg


def reference_tokens(ctx, model_cfg, params, prompt: np.ndarray,
                     gen_len: int, device) -> np.ndarray:
    """The static-batch oracle: one request, dense contiguous KV cache."""
    t_true = len(prompt) + model_cfg.n_meta_tokens
    state = tf.init_decode_state(model_cfg, 1, t_true + gen_len,
                                 dtype=model_cfg.dtype, device=device)
    state = state._replace(pos=0)
    tokens = torch.from_numpy(prompt[None]).to(device)
    logits, state = tf.prefill_into_cache(ctx, params, model_cfg, tokens,
                                          state)
    toks, last = [], logits[0, t_true - 1]
    for _ in range(gen_len):
        nxt = torch.argmax(last, dim=-1).to(torch.int32).cpu().numpy()
        toks.append(nxt)
        step = nxt.reshape(1, 1) if nxt.ndim == 0 else nxt.reshape(1, 1, -1)
        logits, state = tf.decode_step(ctx, params, model_cfg,
                                       torch.from_numpy(step).to(device),
                                       state)
        last = logits[0, -1]
    return np.stack(toks)


def run_arch(arch: str, *, device: str = "cuda", fp32: bool = False,
             verbose: bool = True) -> Dict:
    """Serve the three prompts on the engine and on the static path.
    Returns ``ok`` (equal streams), the engine's and the reference's
    token streams, and the engine summary."""
    model_cfg = model_config(arch, fp32)
    ecfg = engine_config(fp32)
    params = tf.init_params(torch.Generator().manual_seed(0), model_cfg)
    params = _tree_map(lambda t: t.to(device), params)
    rng = np.random.default_rng(0)
    engine = ServingEngine(model_cfg, max_slots=2, max_context=64,
                           page_size=16, n_pages=24, temperature=0.0,
                           seed=0, engine_cfg=ecfg, params=params,
                           prefill_chunk=PREFILL_CHUNK, device=device)
    prompts = []
    for plen, glen in zip(PROMPT_LENS, GEN_LENS):
        shape = (plen, model_cfg.n_codebooks) \
            if model_cfg.n_codebooks > 1 else (plen,)
        prompt = rng.integers(0, model_cfg.vocab, shape).astype(np.int32)
        prompts.append(prompt)
        engine.submit(prompt, glen)
    report = engine.run()
    s = report["summary"]
    if verbose:
        print(f"  engine: {int(s['requests'])} reqs, "
              f"{int(s['new_tokens'])} tokens, {s['tokens_per_s']:.1f} "
              f"tok/s, {int(s['prefill_chunks'])} prefill chunks "
              f"(chunk={engine.prefill_chunk})")

    ctx = ExecutionContext(cfg=ecfg)
    ok, got_all, want_all = True, [], []
    for r, prompt, glen in zip(report["requests"], prompts, GEN_LENS):
        got = np.asarray(r["tokens"], np.int32)
        want = reference_tokens(ctx, model_cfg, params, prompt, glen, device)
        got_all.append(got.tolist())
        want_all.append(want.tolist())
        if got.shape != want.shape or not np.array_equal(got, want):
            ok = False
            if verbose:
                print(f"  MISMATCH rid={r['rid']}: engine {got.ravel()} "
                      f"!= reference {want.ravel()}")
        elif verbose:
            print(f"  rid {r['rid']}: {got.shape[0]} tokens match the "
                  f"static reference exactly")
    return {"ok": ok, "engine": got_all, "reference": want_all,
            "summary": s}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def main(argv: List[str] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (plain path)")
    ap.add_argument("--fp32", action="store_true",
                    help="fp32 model dtype and engine config (default bf16)")
    args = ap.parse_args(argv)
    ok = True
    for arch in ARCHS:
        print(f"\n--- serving {arch} (reduced config, paged engine, "
              f"{args.device}, {'fp32' if args.fp32 else 'bf16'}) ---")
        ok &= run_arch(arch, device=args.device, fp32=args.fp32)["ok"]
    if not ok:
        print("\nserve_decode FAILED: engine diverged from the reference "
              "path", file=sys.stderr)
        return 1
    print("\nserve_decode OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
