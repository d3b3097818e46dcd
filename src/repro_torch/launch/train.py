"""Training entry point (port of ``repro.launch.train``).

Composes the training stack: config registry -> engine context -> train
step -> synthetic data pipeline -> checkpoint manager -> straggler
detection -> restart loop. Usage (the CPU's plain path, reduced config,
the whole fault-tolerant loop):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --smoke --device cpu --steps 20 --batch 4 --seq 64 \\
      --ckpt-dir /tmp/ckpt --ckpt-every 5 --fail-at 7

Without ``--device cpu`` it runs on the card (the kernels; it raises if
there is none). The engine is bf16 in, fp32 accumulate, bf16 out, as the
JAX launcher's. ``--fail-at N`` raises once at step N; the restart loop
(``runtime.ft.run_with_restarts``) then builds a fresh run, which resumes
from the newest committed checkpoint. ``--tune {off,cached,full}`` (or
``GEMMINI_TUNE``) warms the schedule of every GEMM and attention shape a
step runs before the first step (``repro_torch.tune.warm_model_plans``);
the backward products resolve theirs at their first call. The JAX
launcher's ``--tp`` and ``--xla-lhs`` shape a device mesh and have no
counterpart until the multi-device port (ROADMAP A15).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import flags
from repro_torch.core.config import GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.data import SyntheticLM, SyntheticLMConfig, make_batch
from repro_torch.launch import steps as steps_lib
from repro_torch.optim import adamw
from repro_torch.runtime import (RestartPolicy, StragglerDetector,
                                 run_with_restarts)


@dataclasses.dataclass
class RunResult:
    steps_done: int
    final_loss: float
    losses: List[float]
    straggler_steps: int
    start_step: int = 0              # the checkpoint step this run resumed


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host: pass "
                           "--device cpu for the plain path")
    return device


def train_once(args, model_cfg, pods: int, armed: dict) -> RunResult:
    """One attempt of the loop. ``armed['fail']`` holds the pending
    ``--fail-at`` failure, which fires once per ``main`` call."""
    device = _device(args.device)
    engine = ExecutionContext(cfg=GemminiConfig(input_dtype="bf16",
                                                acc_dtype="fp32",
                                                output_dtype="bf16"))
    opt_cfg = adamw.AdamWConfig(lr=args.lr)
    batch, seq = args.batch, args.seq
    gen = SyntheticLM(SyntheticLMConfig(
        vocab=model_cfg.vocab, seq=seq, global_batch=batch, seed=args.seed,
        n_codebooks=model_cfg.n_codebooks))
    extra = dict(extra_embed_dim=model_cfg.d_model,
                 extra_tokens=steps_lib.N_VLM_TOKENS) \
        if model_cfg.modality == "vlm" else {}

    state = steps_lib.init_train_state(model_cfg, seed=args.seed,
                                       device=device)
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir \
        else None
    start_step = 0
    if mgr is not None:
        step_found, restored = mgr.restore_latest(
            state, expect_meta={"arch": model_cfg.name})
        if step_found is not None:
            start_step, state = step_found, restored
            print(f"[train] restored checkpoint step={start_step} "
                  f"(device={device})")
    train_step = steps_lib.make_train_step(engine, model_cfg, opt_cfg,
                                           grad_accum=args.grad_accum)

    detector = StragglerDetector()
    losses, stragglers = [], 0
    step = start_step
    try:
        while step < args.steps:
            if armed.get("fail") == step:
                armed["fail"] = None
                raise RuntimeError(f"injected failure at step {step}")
            t0 = time.time()
            batch_dict = make_batch(gen, step, device, **extra)
            state, metrics = train_step(state, batch_dict)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if detector.observe(dt):
                stragglers += 1
                print(f"[train] step {step}: straggler ({dt*1e3:.0f}ms)")
            losses.append(loss)
            if step % args.log_every == 0:
                print(f"[train] step {step:5d} loss={loss:.4f} "
                      f"({dt*1e3:.0f}ms)")
            step += 1
            if mgr is not None and step % args.ckpt_every == 0:
                mgr.save_async(step, state,
                               extra_meta={"arch": model_cfg.name})
        if mgr is not None:
            mgr.save(step, state, extra_meta={"arch": model_cfg.name})
        return RunResult(step, losses[-1] if losses else float("nan"),
                         losses, stragglers, start_step)
    finally:
        # Flush any in-flight async checkpoint before this attempt
        # unwinds: a restart builds a fresh manager and restores at once.
        if mgr is not None:
            mgr.wait()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject one failure at this step (FT demo)")
    ap.add_argument("--max-restarts", type=int, default=2)
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

    model_cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    if flags.get("tune_mode") != "off":
        # Warm every GEMM shape a train step runs (one device: the whole
        # batch is its M). No attention: the step trains through the
        # model function, never the flash kernel.
        from repro_torch import tune
        stats = tune.warm_model_plans(
            GemminiConfig(input_dtype="bf16", acc_dtype="fp32",
                          output_dtype="bf16"), model_cfg, args.batch,
            args.seq, include_decode=False, include_attention=False,
            device=_device(args.device))
        print(f"[train] plan warmup ({flags.get('tune_mode')}): "
              f"{stats['gemm_shapes']} gemm shapes, "
              f"{stats['cache_hits']} cache hits, "
              f"{stats['cache_misses']} misses")
    armed = {"fail": args.fail_at}

    def make_runner(attempt, pods):
        if attempt:
            print(f"[train] restart #{attempt} on {pods} pod(s)")
        return lambda: train_once(args, model_cfg, pods, armed)

    result, attempts, pods = run_with_restarts(
        make_runner, RestartPolicy(max_failures=args.max_restarts),
        n_pods=1,
        on_failure=lambda a, e: print(f"[train] FAILURE (attempt {a}): {e}"))
    print(f"[train] done: {result.steps_done} steps, "
          f"final_loss={result.final_loss:.4f}, attempts={attempts}, "
          f"stragglers={result.straggler_steps}")
    return result


if __name__ == "__main__":
    main()
