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
the backward products resolve theirs at their first call.

Under ``torchrun`` (``WORLD_SIZE`` in the environment) the run is sharded:
the default process group comes up (NCCL on the card, gloo under
``--device cpu``; ``torchrun`` gives the address and rank), the
(data, model) mesh is the largest ``pick_mesh(--tp)`` finds on the world
size, the state is initialized (or restored, onto this mesh whatever mesh
saved it) in its ``param_specs`` / ZeRO-1 layout, each rank generates only
its batch rows (``make_global_batch``), and the engine context hands each
kernel its local shard; the tuner warms the per-device shapes.
``--grad-accum M`` splits each rank's rows into M micro-batches
(``launch.steps``). On the card, one process per card:

  torchrun --nproc-per-node 1 -m repro_torch.launch.train --arch \
      gemma3-1b --tp 1 --grad-accum 4 --steps 4 --batch 4 --seq 1024

The JAX launcher's ``--xla-lhs`` only sets XLA's scheduler flags and has
no counterpart.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List

import torch

from repro_torch import configs
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import flags
from repro_torch.core.config import GemminiConfig
from repro_torch.core.context import ExecutionContext
from repro_torch.data import (SyntheticLM, SyntheticLMConfig, make_batch,
                              make_global_batch)
from repro_torch.launch import sharding as shd
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.mesh import make_mesh
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


def _log(msg: str) -> None:
    """Print on rank 0 only (every rank of a sharded run logs the same)."""
    if int(os.environ.get("RANK", 0)) == 0:
        print(msg)


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available on this host: pass "
                           "--device cpu for the plain path")
    return device


def _engine_cfg() -> GemminiConfig:
    return GemminiConfig(input_dtype="bf16", acc_dtype="fp32",
                         output_dtype="bf16")


def distributed() -> bool:
    """True when ``torchrun`` (or another launcher) set this process up
    as one rank of several or of one: ``WORLD_SIZE`` is in the
    environment."""
    return "WORLD_SIZE" in os.environ


def init_distributed(device: torch.device) -> torch.device:
    """The default process group from the launcher's environment: NCCL on
    the card (each rank on card ``LOCAL_RANK``), gloo on the CPU. Returns
    this rank's device. A card run without NCCL raises."""
    import torch.distributed as dist
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a sharded run on the card needs NCCL")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    return device


def pick_mesh(tp_hint: int = 0, device_type: str = "cuda"):
    """Largest (data, model) mesh the world size supports: ``model`` is
    ``tp_hint`` (or up to 16), halved until it divides the world."""
    import torch.distributed as dist
    n = dist.get_world_size()
    tp = tp_hint or max(1, min(16, n))
    while n % tp:
        tp //= 2
    return make_mesh((n // tp, tp), ("data", "model"), device_type)


def train_once(args, model_cfg, pods: int, armed: dict) -> RunResult:
    """One attempt of the loop. ``armed['fail']`` holds the pending
    ``--fail-at`` failure, which fires once per ``main`` call."""
    device = _device(args.device)
    mesh = None
    engine = ExecutionContext(cfg=_engine_cfg())
    if distributed():
        device = init_distributed(device)
        mesh = pick_mesh(args.tp, device.type)
        engine = engine.with_mesh(mesh, axis=shd.data_axis(mesh))
    opt_cfg = adamw.AdamWConfig(lr=args.lr)
    batch, seq = args.batch, args.seq
    gen = SyntheticLM(SyntheticLMConfig(
        vocab=model_cfg.vocab, seq=seq, global_batch=batch, seed=args.seed,
        n_codebooks=model_cfg.n_codebooks))
    extra = dict(extra_embed_dim=model_cfg.d_model,
                 extra_tokens=steps_lib.N_VLM_TOKENS) \
        if model_cfg.modality == "vlm" else {}
    tok_spec = None if mesh is None else shd.tokens_spec(
        mesh, batch, 3 if model_cfg.n_codebooks > 1 else 2)

    if flags.get("tune_mode") != "off":
        # Warm every GEMM shape a train step runs at the per-device
        # micro-batch (the data axes split the batch, --grad-accum each
        # rank's rows). No attention: the step trains through the model
        # function, never the flash kernel.
        from repro_torch import tune
        stats = tune.warm_model_plans(
            _engine_cfg(), model_cfg, batch // args.grad_accum, seq,
            include_decode=False,
            include_attention=False, n_shards=engine.n_shards,
            device=device)
        _log(f"[train] plan warmup ({flags.get('tune_mode')}, "
             f"{engine.n_shards} data shard(s)): "
             f"{stats['gemm_shapes']} gemm shapes, "
             f"{stats['cache_hits']} cache hits, "
             f"{stats['cache_misses']} misses")

    state = steps_lib.init_train_state(model_cfg, seed=args.seed,
                                       device=device, mesh=mesh)
    mgr = CheckpointManager(args.ckpt_dir, keep=3) if args.ckpt_dir \
        else None
    start_step = 0
    if mgr is not None:
        step_found, restored = mgr.restore_latest(
            state, expect_meta={"arch": model_cfg.name})
        if step_found is not None:
            start_step, state = step_found, restored
            where = device if mesh is None else \
                f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))}"
            _log(f"[train] restored checkpoint step={start_step} "
                 f"({where})")
    train_step = steps_lib.make_train_step(engine, model_cfg, opt_cfg, mesh,
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
            batch_dict = make_batch(gen, step, device, **extra) \
                if mesh is None else \
                make_global_batch(gen, step, mesh, tok_spec, **extra)
            state, metrics = train_step(state, batch_dict)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if detector.observe(dt):
                stragglers += 1
                _log(f"[train] step {step}: straggler ({dt*1e3:.0f}ms)")
            losses.append(loss)
            if step % args.log_every == 0:
                _log(f"[train] step {step:5d} loss={loss:.4f} "
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
    ap.add_argument("--tp", type=int, default=0,
                    help="model-axis size of the mesh under torchrun "
                         "(0: up to 16, what divides the world)")
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

    if args.tp and not distributed():
        ap.error("--tp shapes the mesh of a sharded run: launch with "
                 "torchrun")

    model_cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get(args.arch)
    armed = {"fail": args.fail_at}

    def make_runner(attempt, pods):
        if attempt:
            _log(f"[train] restart #{attempt} on {pods} pod(s)")
        return lambda: train_once(args, model_cfg, pods, armed)

    result, attempts, pods = run_with_restarts(
        make_runner, RestartPolicy(max_failures=args.max_restarts),
        n_pods=1,
        on_failure=lambda a, e: _log(f"[train] FAILURE (attempt {a}): {e}"))
    _log(f"[train] done: {result.steps_done} steps, "
         f"final_loss={result.final_loss:.4f}, attempts={attempts}, "
         f"stragglers={result.straggler_steps}")
    if distributed():
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()
    return result


if __name__ == "__main__":
    main()
