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
   quickstart's int8 GEMM and every distinct layer of ResNet-50's stream
   as a GEMM on both dataflows, each with its ``gemm_s8_plan`` and
   ``torch._int_mm`` beside it where that call takes the shape; the conv
   kernel at every distinct conv of the stream; the mvout epilogue at its
   six datapaths, int32 -> int8 / int16 / int32 and fp32 -> fp32 / bf16 /
   fp16, at (1000, 512) and at (999, 513) read from 4 bytes past a
   16-byte boundary, fp32 -> fp32 / fp16 also at (3136, 256)), where the
   int8 kernels must be bit-exact, and at
   phase 6b's (the fp16 and int16 GEMMs at the quickstart shape on both
   dataflows, fp16 beside ``torch.matmul``; int16 and fp16 outputs of the
   int8 and bf16 kernels; the fp32, bf16, fp16 and int16 conv kernels
   at the stem, stage-1 3x3 and stage-4 3x3 beside
   ``torch.nn.functional.conv2d``; PyTorch's errors for int16 matmul and
   conv on the card are logged), int16 bit-exact. Times are
   CUDA-event medians with the L2 cache flushed before each launch;
   bounds use the peaks of ``repro_torch.analysis.roofline`` (3.35 TB/s;
   989 TFLOP/s bf16 / fp16, 67 TFLOP/s fp32, 1979 TOP/s int8, 1979 / 4
   TOP/s int16);
4. serve: gemma3-1b at full width (26 layers, random weights from a seed)
   through ``ServingEngine``: four requests, prompts of 1000, 512, 300 and
   64 tokens, 32 new tokens each, 256-token prefill chunks; launch counts
   are zeroed just before and read just after, and every kernel must have
   run; the first request's prefill logits at full width are held against
   the plain path on the CPU;
5. end to end against plain: the smoke gemma3-1b, gemma3-4b, qwen1.5-4b,
   llava-next-34b (text only), granite-moe-3b-a800m and
   llama4-scout-17b-a16e configs in fp32 (model dtype and engine config)
   on the card and on the CPU, with the same weights and prompts, must
   give equal greedy tokens;
6. engine: the Gemmini engine path on the quickstart's int8 BOTH instance:
   the port's quickstart (header, int8 GEMM on OS and WS, conv by host
   im2col and fused); the header against ``plan_gemm``; the mvout route
   (int32 GEMM, then ``accumulator_epilogue``); and ResNet-50's 50-layer
   stream from ``dse.resnet(50)`` at batch 1 (int8 convs from a seed, the
   classifier as a GEMM) three ways: host im2col + OS GEMM, host im2col +
   WS GEMM, and the fused conv kernel, with each route's device time
   whole and per stage. Every output equals the plain version bit for
   bit and OS equals WS; launch counts are zeroed just before and read
   just after, and every engine kernel must have run;
6b. datapaths: the same 50-layer stream on four BOTH instances, each
   layer drawn at the instance's input type from a seed: Table 1's design
   point 4 (fp32 -> fp32 -> fp32), bf16 -> fp32 -> bf16 (the serving
   engine's datapath), fp16 -> fp32 -> fp16 and int16 -> int32 -> int16,
   through all three routes; every output held against ``conv2d_ref`` at
   the same dtypes (int16 bit-exact, floats by ``check_close``'s rules),
   OS equal to WS bit for bit, int16 saturations counted; launch counts
   zeroed just before and read just after, and every kernel of
   ``DATAPATH_KERNELS`` must have run; each route's wall (median of 3) and
   device time, whole and per stage;
7. recurrent serve: mamba2-1.3b at its published widths (48 layers,
   d_model 2048, d_state 128; bf16, weights from seed 0) on phase 4's
   traffic; the chunked SSD must launch once per layer for every prefill
   chunk, fresh and resumed, and no attention kernel may run; a 256-token
   prompt's prefill logits are held against the CPU plain path in fp32
   (``hold_fp32``) and in bf16 (``hold_bf16``: the card's bf16
   gap from the fp32 logits at most twice the CPU's); one decode step of
   four active slots through the engine's envelope is timed with the NaN
   guard off and on, alternating (on: the active slots' conv / SSM rows
   copied before the step, the logits' finiteness read after it);
8. hybrid serve: hymba-1.5b at full width (128 meta tokens, window 1024),
   two requests of 700 and 200 tokens, 16 new tokens each; the SSD, flash,
   paged prefill, paged decode and GEMM kernels must all launch; prefill
   logits against the CPU and the guarded decode step's cost as in
   phase 7;
9. gate: the port's ``serve_decode`` at smoke size, fp32 model and engine,
   for gemma2-2b, mamba2-1.3b, hymba-1.5b and musicgen-medium: on the card
   the engine's greedy tokens equal the static path's (dense decode
   kernel), and both equal the CPU plain path's;
10. static path: gemma3-1b at full width with phase 4's weights, bf16,
   through ``prefill_into_cache`` and 16 ``decode_step`` calls on a
   768-token prompt (the dense decode kernel's main path: it must launch
   once per step and layer); the logits, teacher-forced with the card's
   tokens on the CPU, are held by ``hold_bf16``;
11. robustness and profiler: (a) phase 4's traffic on phase 4's weights
   under ``FAULT_PLAN`` (a NaN-poisoned decode step and an Inf-poisoned
   prefill step, each re-run from its pre-call state; three transient
   failures, each retried), the NaN guard on: every request finishes,
   retries and fallbacks equal the injector's firings, each re-run inside
   ``_dispatch_fallback`` launches its primary step's kernels as many
   times and gives phase 4's logits of that step bit for bit, and every
   request's tokens equal phase 4's; the same traffic runs unfaulted
   just before (guard off, then on) and after (off), for walls taken on
   the same host at the same time; (b) phase 5's smoke gemma3-1b in
   fp32 under the chaos suite's ``MIXED_PLAN``: tokens equal the
   unfaulted card's and the CPU's, counters and firings the CPU's; (c)
   the op profiler over phase 4b's decode step and continuation chunk
   (each op's events bracket its device work: a spin kernel holds the
   stream while the host enqueues it): per bucket calls, best time,
   achieved TFLOP/s and TB/s and roofline share (none above 1.0), each
   op's calls equal to its kernel's launches, logits equal to the
   unprofiled step's bit for bit. Every other phase's engines retry no
   step and fall back on none (``assert_clean``);
12. MoE: granite-moe-3b-a800m at its published widths (32 layers, 40
   experts padded to 48 slots, top-8, vocab 49155; bf16, weights from
   seed 0) on phase 4's traffic: the bf16 GEMM, the fp32 GEMM (the
   router: fp32 in, bf16 out), flash, paged prefill and paged decode must
   each launch, the router once a layer; a routing census of one decode
   step and one chunk (every layer's loads sum to tokens x 8, none on
   slots 40-47); a 256-token prompt's prefill logits held against the CPU
   plain path in fp32 (``hold_fp32``) and by ``hold_bf16``; the
   two phase-4b steps profiled, the expert ``bmm``'s device time apart
   and the largest other kernels named;
13. train, smoke: every registry arch at smoke size in fp32 (model and
   engine), one ``make_train_step`` on the card and on the CPU from the
   same weights and batch (llava-next-34b with an ``extra_embeds``
   prefix, musicgen-medium with four codebooks, the MoE archs capacity
   bound): the loss and every gradient leaf agree within
   ``TRAIN_SMOKE_GRAD_LIMIT``, the step's metrics too, and its updated
   parameters within ``TRAIN_SMOKE_PARAM_LIMIT`` of the update's own bound
   (qwen's key bias, rounding noise, within the bound); the fp32 GEMM and its
   backward products (``gemm[bwd]``) must launch;
14. train, full width: gemma3-1b at its published widths (26 layers,
   vocab 262144; bf16, the serving engine config), ``remat=True``, AdamW
   under a cosine schedule, ``TRAIN_STEPS`` steps of 4 x 1024 tokens of
   ``SyntheticLM`` from seed 0 (launch counts zeroed just before, read
   just after): every step launches the forward GEMM and ``gemm[bwd]``
   exactly as ``train_gemm_launches`` works them out from the model
   (forward, the remat recompute, two backward products per projection;
   attention and the SSD run their model functions, so no other kernel);
   losses finite, the last three's mean below the first three's; the
   state after step 4 saved, restored into a fresh state bit for bit
   (parameters and AdamW state) and step 5 from it giving the
   uninterrupted run's loss; one step profiled (wall, device time, idle
   share; free memory read before the phase); the first step's loss and
   gradient norm in fp32 at batch 1 x 128 against the CPU plain path
   (``TRAIN_CPU_LIMITS``); the launcher (``repro_torch.launch.train``)
   with ``--fail-at`` restarting from its checkpoint;
15. gemma3-4b at its published widths (34 layers, GQA 8 / 4, head dim 256,
   window 1024; bf16, weights from seed 0) on phase 4's traffic: every
   serving kernel must launch; a 256-token prompt's prefill logits held
   against the CPU plain path in fp32 (``hold_fp32``) and by
   ``hold_bf16``;
16. tune (the kernel-schedule tuner, ``repro_torch.tune``; every earlier
   phase runs with tuning off): under ``GEMMINI_TUNE=full``, with a cache
   under ``build/`` deleted afterwards, the distinct GEMMs of gemma3-1b's
   decode step (M = 4) and 256-token chunk, ResNet-50's distinct convs on
   the int8 and fp32
   instances, phase 3's flash shape and phase 4's page size (4 slots,
   2048 context) are tuned; each winner within ``TIE_BAND`` of the static
   plan on the same measurement and held against its plain version by
   phase 3's rules, with ``torch.matmul`` / cuDNN / SDPA logged beside
   it; then a fresh cache object in ``cached`` mode and an engine warmed
   for phase 4's prompts serve phase 4's traffic with no cache miss, the
   first request's first 256 tokens' prefill logits held by
   ``hold_bf16`` and the decode step's wall logged beside phase 4b's; a
   guard trip under ``FAULT_PLAN`` quarantines the paged key, whose next
   resolution is the static page;
17. contracts (``repro_torch.analysis.lint.card``): every probe plan of the
   lint driver, all ten kernel families over the tuner's schedule space
   widened past each limit: (a) the lint admits a plan exactly when its C
   plan function accepts it (a plan that needs the card's cluster
   co-residency is logged where the card refuses it), and an accepted
   plan's contract equals the C array field for field; (b) every kernel
   entry's ``ptxas`` registers, rounded to 8, times its threads and its
   ``__launch_bounds__`` blocks fit 65,536; (c) each accepted plan
   launched twice into an output between 4 KB guard bands filled with a
   sentinel (NaN payloads for floats, bit patterns for ints), another
   each time: every element written, the bands untouched, the output
   equal to its plain version by phase 3's rules; (d) the stream's
   ticket words 0 after each ticket plan; (e) the two launches bit-equal.
   The counts (plans, admitted, refused, needing the card, C
   disagreements) are logged; the phase has 90 s.

Phase 3 also holds the chunked SSD (mamba2-1.3b's and hymba-1.5b's
widths: the serving call, one 256-token chunk resumed, and 1000 tokens
fresh and resumed, and a ragged 7-token prompt; final states against the
naive recurrence in fp64; fp16 at the serving call on its tensor-core
kernel, and a chunk whose state passes 65504, which must launch no
conversion), the operand conversion on each of its paths (int16 (1000,
2048) -> bf16 packed, the same one value into its buffer, rows on
mamba2-1.3b's SSD x view fp16 -> fp32, general on a transposed view;
``Tensor.to`` beside each, bit for bit) and every dtype pair on each path
bit for bit, and dense decode attention in bf16
at phase 10's shapes, at four sequences of 2048 and at hymba-1.5b's
shape, and in fp32 at phase 9's (each attention arch's longest request,
its windows and softcap), paged decode in fp32 at phase 9's two slots,
flash attention at hymba-1.5b's first chunk (bf16, and fp32 as phase 8's
fp32 logits run it) and in fp32 at phase 9's prompts (the CUDA-core
kernel that the fp32 gate runs; SDPA beside each row without a softcap,
under the window's mask where it cuts keys), paged prefill at
hymba-1.5b's continuation chunk (T=256 at 768, GQA 25 / 5, window 1024;
bf16 and fp32) and in fp32 at the gate's last chunks, granite-moe-3b-a800m's
shapes in bf16 (flash at its first chunk, paged prefill at T=256 from 768
and paged decode at phase 4b's four slots, GQA 24 / 8, head dim 64; the
tied unembedding at M = 4, N = 49155, odd; the router GEMM, fp32 in and
bf16 out, at M = 4 and 256, N = 48, beside ``torch.matmul`` in fp32 with
TF32 off and a cast, held by the bf16 rule), the fp32 SSD at
mamba2-1.3b's and hymba-1.5b's widths (phases 7-8's fp32 prompt, 256
tokens fresh; a
resumed chunk; 1000 tokens fresh; y and final state against the fp64
recurrence), and logs each redesigned kernel's grid and
``ptxas`` registers and spills; each bf16 paged prefill row also times the
dense flash kernel on the same keys gathered beforehand (what the block
table costs); dense decode's yardsticks are SDPA over the whole cache
under a boolean mask and (its ``library_ms``) SDPA without a mask over the
live key slice. The bf16 GEMM rows (gemma3-1b's 7 projections and the
tied unembedding at M = 4, 64 and 256) log their plan (``gemm.gemm_plan``:
regime, tile, K splits, grid, workspace) and ``torch.matmul`` beside each;
the fp32 rows (wq with a bias at M = 64; mamba2-1.3b's in_proj at M = 256,
as phase 7's fp32 logits run it) log theirs, beside ``torch.addmm`` /
``torch.matmul`` in fp32 with TF32 off; the log and
the JSON carry the GEMM's sums over one decode step (M = 4) and one
prefill chunk (M = 256), 7 projections per layer and the unembedding.
The ``gemm[bwd]`` rows are the training step's backward products at its
4 x 1024 token rows: dA = dC B^T and dB = A^T dC of every projection and
of the tied unembedding (``kernels.gemm.grad_a`` / ``grad_b``, on the
backward kernel ``csrc/hgemm_bwd.cuh``), each with its plan (tile, the
data-parallel and stream-K tiles, units, the shares of a split tile,
grid), ``torch.matmul`` on the same operands, its launches per training
step, a second launch bit-equal to the first and the bytes the call
allocates beyond its output (0: its operands are read in place); two more
rows hold granite-moe-3b-a800m's tied unembedding (vocab 49155, rows no
tensor map describes) on the forward route, the forward kernels, at the
same token rows.
Every profiler window (phases 4b, 6, 6b, 7-8) is held to the launch
counters' growth over its passes (``profile_call``, a marker kernel
around each pass left out of the counts): a short window is taken again,
and one that stays short fails the run.
Phase 18 is the multi-device slice on one card: on a (1, 1) ``("data",
"model")`` mesh over a one-rank NCCL group, two sharded ``make_train_step``
steps of full-width gemma3-1b (phase 14's engine and batch) equal two
unsharded steps bit for bit (losses, gradient norms, parameters, AdamW's
m and v) and launch the same GEMMs; each wrapped op of the sharded
context (the biased GEMM, the fused conv, flash, paged decode, the resumed
SSD) given DTensors equals the unsharded call bit for bit, one launch
each; a DTensor at each kernel entry raises ``TypeError``; and one
full-size dry-run cell (gemma3-1b x train_4k on 16 x 16, ``fake``
process group) runs in a subprocess and prints its row.
Phase 19 is the rest of the multi-device slice on one card, each check's
launch counts zeroed just before it and read just after: on the (1, 1)
mesh, full-width granite-moe-3b-a800m's ``make_prefill_step`` over 2 x
512 tokens and one MoE layer's loss and gradients at 1 x 1024 with
``moe_grouped_dispatch`` off and on (the grid is (1, 1): the grouped path
runs with one group), bit for bit; two sharded ``grad_accum`` = 4 steps
of full-width gemma3-1b (micro-batches of 1 x 1024) bit for bit the
unsharded ``grad_accum`` steps; and gemma3-1b's 26 blocks through
``pipeline_loss_fn`` at S = 1 on a ``("stage",)`` mesh, 4 micro-batches
of 1 x 1024, bit for bit the blocks applied micro-batch by micro-batch;
the GEMM launches equal each way.
Phase 20 is the remaining datapaths, each run's launch counts zeroed just
before it and read just after: (a) gemma3-1b at fp16 (the model dtype and
the fp16 engine config, published widths, seed 0) on phase 4's traffic,
every request finished, tokens/s, TTFT and ITL beside the card's name
and power limit, phase 4b's two steps profiled, a fresh prefill's logits
held by ``hold_bf16`` at fp16; one static-path request as phase 10's
(``decode_attention[fp16]`` every step of every layer); hymba-1.5b at fp16 on
phase 8's 700 + 200 tokens at 16 of its 32 layers, held the same way and
launching no ``convert`` (an arch
whose CPU fp16 logits are not finite is logged as not servable in fp16 and
fails nothing); (b) every (input, accumulator, output) combination JAX accepts
on the quickstart GEMM (OS == WS), ``accumulator_epilogue`` on every pair at
(1000, 512) and (999, 513), ``conv2d_implicit`` at stage 1's 3x3, and
ResNet-50's stream on the int32 -> int32 -> int32 and bf16 -> bf16 -> bf16
instances on all three routes, each against the plain
version (``hold_any``); then a combination of each mechanism timed.
Phase 21 is the last kernel shapes (``run_shapes_phase``): (a) the four
attention launchers at head dims 48, 80, 96 and 200 in bf16, fp16 and
fp32, at 320 (fp32's instance at 512), on views 2 elements past a 16-byte
boundary and in both mixed orders, and the SSD at mamba2-1.3b's d_inner as
32 heads of P = 128, N = 256, a 512-token chunk resumed, and at P = 96, in
bf16, fp32 and fp16, and in both mixed orders; every call once with the
counts zeroed just before and
read just after (each wrapper, its fp16 and its mixed count must launch),
then each against its plain version, timed beside its bound and SDPA
where one call computes the same function; (b) the smoke gemma3-1b with
head dim 80 and 200 served in fp32, card == CPU; (c) the port's
``chaos_smoke`` example on the card; held to 60 s.
``python3 chip_smoke.py --phase 17`` runs phases 1, 2 and 17 alone (a
quicker check of the contracts on a card), ``--phase 18`` phases 1, 2 and
18, ``--phase 19`` phases 1, 2 and 19, ``--phase 20`` phases 1, 2 and 20,
``--phase 21`` phases 1, 2 and 21 (rows in
``chiprun_out/chip_smoke_shapes.json``); with no argument every phase
runs.

Every main path's launch counts are zeroed
just before it and read just after; the kernels line takes each kernel's
count from its own path: the serve phase, the engine phase, phase 6b (the
fp16 / int16 GEMMs and the fp32 / bf16 / fp16 / int16 convs), the
recurrent serve (``ssd``), the static path (``decode_attention``), the
MoE serve (``gemm[fp32]``, the fp32 GEMM's own count) or the full-width
training run (``gemm[bwd]``, the backward products on any float
datapath).

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

# The input dtype of each check kind, whose peak rate bounds it
# (``repro_torch.analysis.roofline``; "int" is the int8 datapath).
KIND_DTYPE = {"bf16": "bfloat16", "fp16": "float16", "fp32": "float32",
              "int": "int8", "int16": "int16", "int32": "int32"}
REPS = 25

# Full-width logits, card against the CPU plain path: fp32 by ``hold_fp32``
# (the card's gap at most FP32_FACTOR times the CPU's own gap when every
# fp32 weight moves by up to half an ulp, drawn from FP32_PERTURB_SEED;
# on an H100 the ratio read 1.80 for mamba2-1.3b, 1.38 hymba-1.5b, 1.21
# granite-moe-3b-a800m and 1.15 gemma3-4b, and another draw put
# mamba2-1.3b's at 2.9: PERF.md, PR 26), bf16 by ``hold_bf16``.
FP32_FACTOR = 4.0
FP32_PERTURB_SEED = 7
BF16_FACTOR = 2.0
# Phase 20: the fp16 model's engine config, and the prompt length of its
# full-width 16-bit logits hold (the CPU's fp16 plain path runs it too).
F16_ENGINE = dict(input_dtype="fp16", acc_dtype="fp32", output_dtype="fp16")
F16_HOLD_TOKENS = 32
F16_HYMBA_LAYERS = 16            # phase 20's fp16 hymba-1.5b: half depth

# Phase 10's static path: one gemma3-1b request, a prompt long enough that
# the 512-token window drops keys, then greedy decode steps.
STATIC_PROMPT = 768
STATIC_STEPS = 16


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def fail(msg: str) -> None:
    log(f"FAIL: {msg}")
    sys.exit(1)


def assert_clean(name: str, summary) -> None:
    """An unfaulted run retries no step and re-runs none (a NaN guard that
    trips here is a kernel fault)."""
    if summary["retries"] or summary["fallbacks"]:
        fail(f"{name}: {int(summary['retries'])} retries and "
             f"{int(summary['fallbacks'])} fallbacks in an unfaulted run")


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
    import torch
    from repro_torch.analysis.roofline import HBM_BW, peak_ops

    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / peak_ops(getattr(torch, KIND_DTYPE[kind])) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(torch, name, got, want, kind):
    """bf16: one bf16 ulp of the value (2^-7 relative) plus 2^-14 of the
    output's largest magnitude, since kernel and plain version sum in other
    orders and a value near a rounding boundary may round either way.
    fp16: the same with one fp16 ulp (2^-10 relative), and infinities (an
    fp16 overflow) in the same places with the same sign; the largest
    magnitude is the largest finite one. fp32: 1e-5 relative plus 1e-6 of
    the largest magnitude (sum order). int, int16: bit-exact, same dtype
    (the int32 sum is exact in any order)."""
    if kind in ("int", "int16", "int32"):
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
    if kind == "fp16":
        inf = torch.isinf(w)
        if not torch.equal(torch.isinf(g), inf) or \
                not torch.equal(g[inf], w[inf]):
            fail(f"{name}: infinities differ from the plain version's "
                 f"({int(torch.isinf(g).sum())} against {int(inf.sum())})")
        g, w = g[~inf], w[~inf]
    if not torch.isfinite(g).all():
        fail(f"{name}: non-finite kernel output")
    if g.numel() == 0:
        return 0.0
    err = (g - w).abs()
    scale = w.abs().max().item()
    rtol, atol = {"bf16": (2.0 ** -7, 2.0 ** -14 * scale),
                  "fp16": (2.0 ** -10, 2.0 ** -14 * scale)}.get(
                      kind, (1e-5, 1e-6 * scale))
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


def f32_grid(t_q, t_k, h, kvh, dh, causal, window, sms=132):
    """The fp32 flash kernel's grid (``f32_plan`` in ``attention.cu``):
    row tiles of 8 x RPL (position, query head) pairs of one kv head (RPL
    4, 2, 1 for D <= 64, 128, 256), position-major, x kv heads, in
    clusters of 1-4 blocks of 4 warps, doubled while the busiest tile's
    16-key tiles outnumber the cluster's warps and the grid is short of
    the SMs."""
    rb = 8 * (4 if dh <= 64 else 2 if dh == 128 else 1)
    g, off = h // kvh, t_k - t_q
    nrb = -(-t_q * g // rb)
    most = 0
    for rb0 in range(0, t_q * g, rb):
        p0, p1 = off + rb0 // g, off + (min(rb0 + rb, t_q * g) - 1) // g
        lo = max(0, p0 - window + 1) if window else 0
        hi = min(t_k, p1 + 1) if causal else t_k
        if hi > lo:
            most = max(most, -(-hi // 16) - lo // 16)
    cl = 1
    while cl < 4 and cl * 4 < most and nrb * kvh * cl < sms:
        cl *= 2
    return f"{cl * nrb * kvh} blocks of {rb} rows, clusters of {cl}"


GEMM_ROWS = (4, 64, 256)   # decode (4 slots), a short prompt, a chunk


def gemm_serving_cases(torch, randn, gemm):
    """gemma3-1b's bf16 GEMMs at the serving path's row counts: (name, M,
    N, K, run_kernel, run_plain, run_library) for every projection and
    the tied unembedding (B = ``table.T``), ``randn(*shape, scale=)``
    making the operands; the yardstick is ``torch.matmul``."""
    from repro_torch import configs
    from repro_torch.kernels.ref import gemm_ref

    cfg = configs.get("gemma3-1b")
    d, hd, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    proj = [("wq", d, nh * hd), ("wk", d, nkv * hd), ("wv", d, nkv * hd),
            ("wo", nh * hd, d), ("wi", d, cfg.d_ff), ("wg", d, cfg.d_ff),
            ("mlp.wo", cfg.d_ff, d)]
    table = randn(cfg.vocab, d, scale=d ** -0.5)
    kw = dict(acc_dtype=torch.float32, out_dtype=torch.bfloat16)
    out = []
    for m in GEMM_ROWS:
        for name, k, n in proj + [("unembed", d, cfg.vocab)]:
            a = randn(m, k)
            b = table.T if name == "unembed" else randn(k, n, scale=k ** -0.5)
            out.append((name, m, n, k,
                        lambda a=a, b=b: gemm(a, b, **kw),
                        lambda a=a, b=b: gemm_ref(a, b, None, **kw),
                        lambda a=a, b=b: torch.matmul(a, b)))
    return out


def gemm_step_sums(rows, n_layers):
    """Per row count M: one step's sum over its 7 x n_layers projections
    and the unembedding, for each of ``ms``, ``library_ms`` and
    ``bound_ms`` in ``rows`` (dicts with ``shape`` "name M=.. ...")."""
    sums = {}
    for r in rows:
        name, m = r["shape"].split()[0], int(r["shape"].split()[1][2:])
        times = 1 if name == "unembed" else n_layers
        acc = sums.setdefault(m, {"ms": 0.0, "library_ms": 0.0,
                                  "bound_ms": 0.0})
        for key in acc:
            if r.get(key) is not None:
                acc[key] += times * r[key]
    return sums


TRAIN_ROWS = 4 * 1024      # the training phase's batch x sequence


def gemm_backward_cases(torch, randn):
    """The engine GEMM's backward products at gemma3-1b's training shapes
    (M = 4 x 1024 token rows): (op, name, M, N, K, operands, run_kernel,
    run_plain, run_library, run_exact) for dA = dC B^T and dB = A^T dC of
    every projection and of the tied unembedding (B = ``table.T``), M x N
    x K the product's own (dA: M tokens, N = the layer's input width, K =
    its output width; dB: M = input width, N = output width, K tokens).
    ``kernels.gemm.grad_a`` / ``grad_b`` are the calls the autograd
    Function makes (the unembedding's dB written in the table's layout, as
    dB^T = dC^T A); the yardstick is ``torch.matmul`` on the same
    operands; ``operands`` are the backward kernel's (A, B) for its plan
    and route."""
    from repro_torch import configs
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import gemm_ref

    cfg = configs.get("gemma3-1b")
    d, hd, nh, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    proj = [("wq", d, nh * hd), ("wk", d, nkv * hd), ("wv", d, nkv * hd),
            ("wo", nh * hd, d), ("wi", d, cfg.d_ff), ("wg", d, cfg.d_ff),
            ("mlp.wo", cfg.d_ff, d)]
    m = TRAIN_ROWS
    bf16, kw = torch.bfloat16, dict(acc_dtype=torch.float32,
                                    out_dtype=torch.bfloat16)
    table = randn(cfg.vocab, d, scale=d ** -0.5)
    out = []
    for name, k, n in proj + [("unembed", d, cfg.vocab)]:
        a = randn(m, k)
        tied = name == "unembed"
        b = table.T if tied else randn(k, n, scale=k ** -0.5)
        dc = randn(m, n, scale=1e-3)
        # dA: dC (m x n) @ B^T (n x k); B^T is read in place
        out.append(("dA", name, m, k, n, (dc, b.t()),
                    lambda dc=dc, b=b: kg.grad_a(dc, b, bf16),
                    lambda dc=dc, b=b: gemm_ref(dc, b.t(), None, **kw),
                    lambda dc=dc, b=b: torch.matmul(dc, b.t()),
                    lambda dc=dc, b=b: dc.double() @ b.t().double()))
        # dB: A^T (k x m) @ dC (m x n), A^T read in place; the tied
        # table's as dC^T A into the table's (n, k) layout
        out.append(("dB", name, k, n, m, (dc.t(), a) if tied else
                    (a.t(), dc),
                    (lambda a=a, dc=dc: kg.grad_b(a, dc, bf16, trans=True))
                    if tied else (lambda a=a, dc=dc: kg.grad_b(a, dc, bf16)),
                    lambda a=a, dc=dc: gemm_ref(a.t(), dc, None, **kw),
                    lambda a=a, dc=dc: torch.matmul(a.t(), dc),
                    lambda a=a, dc=dc: a.t().double() @ dc.double()))
    return out


def bwd_plan_text(operands):
    """The backward route of a product's operands and, on the backward
    kernel, its plan as phase 3 logs it: tile, ring, the data-parallel
    tiles and the stream-K tiles over their blocks, units (a data-parallel
    tile or a stream-K share each), the shares of a split tile, grid,
    workspace."""
    from repro_torch.kernels import gemm as kg

    a, b = operands
    route = kg.bwd_route(a, b, a.dtype)
    if route != "persistent":
        return route, {}
    m, k = a.shape
    n = b.shape[1]
    p = kg.gemm_bwd_plan(m, n, k)
    units = p["dp_tiles"] + p["sk_blocks"]
    bm, bn, bk = p["tile"]
    text = (f"{bm}x{bn}x{bk}, {p['stages']} stages, {p['dp_tiles']} tiles "
            f"data-parallel + {p['sk_tiles']} stream-K over "
            f"{p['sk_blocks']} blocks, {units} units, a split tile in "
            f"{p['splits']} shares, grid {p['grid']} x {p['threads']}, "
            f"workspace {p['workspace_bytes']} B")
    return text, {"units": units, "splits": p["splits"], "grid": p["grid"],
                  "dp_tiles": p["dp_tiles"], "sk_tiles": p["sk_tiles"],
                  "sk_blocks": p["sk_blocks"], "tile": p["tile"]}


def copied_bytes(torch, run_k):
    """Device bytes a call asks the caching allocator for beyond its output
    (a copy of an operand, a scratch buffer), by the allocator's requested
    bytes (a block it hands out may be larger than asked): 0 for the
    backward kernel, whose operands are read in place (the stream's
    workspace is made by an earlier call)."""
    key = "requested_bytes.all."
    torch.cuda.synchronize()
    base = torch.cuda.memory_stats()[key + "current"]
    torch.cuda.reset_peak_memory_stats()
    out = run_k()
    torch.cuda.synchronize()
    extra = torch.cuda.memory_stats()[key + "peak"] - base - \
        out.numel() * out.element_size()
    del out
    return max(int(extra), 0)


def rerun_equal(torch, name, run_k, check):
    """``check`` (a phase 3 check on (got, want)) and then a second launch
    bit-equal to the first: the backward kernel's stream-K partials are
    added in a fixed order."""
    def hold(got, want):
        err = check(got, want)
        again = run_k()
        if not torch.equal(got.view(torch.int16), again.view(torch.int16)):
            fail(f"{name}: a second launch differs from the first")
        return err
    return hold


# A product over this many terms or more is held to the exact (fp64)
# product by ``hold_long_k`` rather than elementwise by ``check_close``.
LONG_K = 1 << 16


def hold_long_k(torch, name, exact_fn):
    """A check for a bf16 product with a long inner dimension (the tied
    unembedding's dA sums 262144 products): the tensor cores add each
    k-step's products into the fp32 accumulator rounding toward zero, so
    over thousands of steps the kernel's fp32 sums drift from the IEEE
    plain version's by about 1e-3 of their partial sums, and small outputs
    then round to another bf16 value than the plain version's, two steps
    apart at a few borderline elements. Both are held to the exact
    product instead, as ``hold_bf16`` holds logits: the kernel's relative
    L2 gap from the fp64 product at most ``BF16_FACTOR`` times the plain
    version's (whose gap is its bf16 output rounding)."""
    def check(got, want):
        exact = exact_fn()
        g_k, g_p = rel_l2(got, exact), rel_l2(want, exact)
        err = (got.double() - exact).abs().max().item()
        del exact
        log(f"{name}: relative L2 from the fp64 product: kernel {g_k:.3e}, "
            f"plain {g_p:.3e} (ratio {g_k / g_p:.3f}, limit {BF16_FACTOR});"
            f" kernel max abs err {err:.3e}")
        if not torch.isfinite(got).all() or not g_k <= BF16_FACTOR * g_p:
            fail(f"{name}: the kernel is {g_k:.3e} from the exact product, "
                 f"over {BF16_FACTOR} x the plain version's {g_p:.3e}")
        return err
    return check


def fp32_gemm_cases(torch, randn):
    """The fp32 engine GEMM (the fp32 engine config's datapath) at the
    shapes the fp32 paths give it: (name, M, N, K, run_kernel, run_plain,
    run_library, bytes). gemma3-1b's wq with a bias row at a
    64-token prompt (the D input: qwen's QKV bias) and mamba2-1.3b's
    widest projection, in_proj (2048 -> 8512), at the 256-token prompt of
    phase 7's fp32 logits. The yardstick is the one PyTorch call that
    computes the same function, in fp32 with TF32 off: ``torch.addmm``
    with a bias, ``torch.matmul`` without. Bytes: A, B, the bias and C,
    each once, 4 bytes an element."""
    from repro_torch import configs
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import gemm_ref

    g3, m2 = configs.get("gemma3-1b"), configs.get("mamba2-1.3b")
    d_inner = m2.ssm_expand * m2.d_model
    n_heads = d_inner // m2.ssm_head_dim
    in_dim = 2 * d_inner + 2 * m2.ssm_groups * m2.d_state + n_heads
    f32 = torch.float32
    kw = dict(acc_dtype=f32, out_dtype=f32)
    out = []
    for name, m, k, n, bias in (
            ("wq+bias", 64, g3.d_model, g3.n_heads * g3.head_dim, True),
            ("mamba2 in_proj", 256, m2.d_model, in_dim, False)):
        a = randn(m, k, dtype=f32)
        b = randn(k, n, dtype=f32, scale=k ** -0.5)
        d = randn(n, dtype=f32) if bias else None
        lib = (lambda a=a, b=b, d=d: torch.addmm(d, a, b)) if bias else \
            (lambda a=a, b=b: torch.matmul(a, b))
        out.append((name, m, n, k,
                    lambda a=a, b=b, d=d: kg.gemm(a, b, d, **kw),
                    lambda a=a, b=b, d=d: gemm_ref(a, b, d, **kw), lib,
                    4 * (m * k + k * n + m * n + (n if bias else 0))))
    return out


def moe_gemm_cases(torch, randn):
    """granite-moe-3b-a800m's GEMMs that no other path gives the card:
    (name, M, N, K, kind, run_kernel, run_plain, run_library, bytes,
    b_trans). The router is ``layers.project`` on fp32 input, so under the
    bf16 serving config the fp32 kernel writes bf16 (N = 48 slots, at a
    decode step's 4 rows and a chunk's 256); its yardstick is
    ``torch.matmul`` in fp32 with TF32 off, then the cast. The tied
    unembedding has an odd N (49155): the bf16 kernel's scalar store path,
    beside ``torch.matmul``. Bytes: A, B and C, each once."""
    from repro_torch import configs
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import gemm_ref
    from repro_torch.models.moe import pad_experts

    cfg = configs.get("granite-moe-3b-a800m")
    d, e_pad = cfg.d_model, pad_experts(cfg.n_experts, cfg.expert_padding)
    f32, bf16 = torch.float32, torch.bfloat16
    kw = dict(acc_dtype=f32, out_dtype=bf16)
    out = []
    router = randn(d, e_pad, dtype=f32, scale=d ** -0.5)
    for m in (4, 256):
        a = randn(m, d, dtype=f32)
        out.append(("router fp32->bf16", m, e_pad, d, "fp32",
                    lambda a=a: kg.gemm(a, router, **kw),
                    lambda a=a: gemm_ref(a, router, None, **kw),
                    lambda a=a: torch.matmul(a, router).to(bf16),
                    4 * (m * d + d * e_pad) + 2 * m * e_pad, False))
    table = randn(cfg.vocab, d, scale=d ** -0.5)
    a = randn(4, d)
    out.append(("granite unembed", 4, cfg.vocab, d, "bf16",
                lambda: kg.gemm(a, table.T, **kw),
                lambda: gemm_ref(a, table.T, None, **kw),
                lambda: torch.matmul(a, table.T),
                2 * (4 * d + d * cfg.vocab + 4 * cfg.vocab), True))
    return out


def gemm_plan_text(kg, m, n, k, b_trans=False, **kw):
    """The float GEMM's plan for a shape (bf16 inputs unless ``dtype=`` is
    given), as phase 3 logs it."""
    p = kg.gemm_plan(m, n, k, b_trans, **kw)
    bm, bn, bk = p["tile"]
    return (f"{p['regime']} {bm}x{bn}x{bk}, {p['splits']} K splits, "
            f"{p['grid']} blocks x {p['threads']}, {p['stages']} stages, "
            f"{p['smem']} B shared, workspace {p['workspace_bytes']} B")


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
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    KIND_OF = {bf16: "bf16", f32: "fp32", f16: "fp16"}
    F16_SUFFIX = {f16: "[fp16]"}

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    cases = []

    # -- gemm: every projection and the tied unembedding at the serving
    # path's row counts, each with its plan (regime, tile, K splits, grid)
    for pname, m, n, k, run_k, run_p, run_lib in gemm_serving_cases(
            torch, randn, kg.gemm):
        nbytes = 2 * (m * k + k * n + m * n)
        cases.append((
            "gemm", f"{pname} M={m} N={n} K={k}",
            pname == "unembed" and m == 4, "bf16", run_k, run_p, run_lib,
            nbytes, 2.0 * m * n * k,
            {"plan": gemm_plan_text(kg, m, n, k, pname == "unembed")}))
    # the D input (qwen's QKV bias) beside the one PyTorch call that
    # computes it, torch.addmm; bytes: A, B, the bias and C, each once
    n = nh * hd
    a, b = randn(64, d), randn(d, n, scale=d ** -0.5)
    bias = randn(n)
    kw = dict(acc_dtype=f32, out_dtype=bf16)
    cases.append(("gemm", f"wq+bias M=64 N={n} K={d}", False, "bf16",
                  lambda: kg.gemm(a, b, bias, **kw),
                  lambda: gemm_ref(a, b, bias, **kw),
                  lambda: torch.addmm(bias, a, b),
                  2 * (64 * d + d * n + 64 * n + n), 2.0 * 64 * d * n,
                  {"plan": gemm_plan_text(kg, 64, n, d)}))
    # -- gemm[bwd]: the training step's backward products (dA, dB) of every
    # projection and the tied unembedding on the backward kernel; each runs
    # once a layer a step (the unembedding's once a step)
    for op, pname, m, n, k, operands, run_k, run_p, run_lib, run_exact in \
            gemm_backward_cases(torch, randn):
        label = f"{op} {pname} M={m} N={n} K={k}"
        plan, geo = bwd_plan_text(operands)
        if not geo:
            fail(f"gemm[bwd] [{label}]: routed to the {plan} kernels, not "
                 f"the backward kernel")
        check = hold_long_k(torch, f"gemm[bwd] [{label}]", run_exact) \
            if k >= LONG_K else \
            (lambda got, want, label=label: check_close(
                torch, f"gemm[bwd] [{label}]", got, want, "bf16"))
        opts = {"plan": plan, "bwd_plan": geo,
                "launches_per_step": 1 if pname == "unembed" else
                cfg.n_layers,
                "copied_bytes": lambda run_k=run_k: copied_bytes(torch,
                                                                 run_k),
                "check": rerun_equal(torch, f"gemm[bwd] [{label}]", run_k,
                                     check)}
        cases.append((
            "gemm[bwd]", label, pname == "unembed" and op == "dB", "bf16",
            run_k, run_p, run_lib, 2 * (m * k + k * n + m * n),
            2.0 * m * n * k, opts))
    # granite-moe-3b-a800m's tied unembedding in bf16 training at the same
    # token rows: a vocab of 49155 leaves rows of no whole 16-byte words,
    # which no tensor map describes, so both products take the forward
    # route (the forward kernels; grad_b copies A^T), held to the plain
    # version
    gcfg = configs.get("granite-moe-3b-a800m")
    gd, gv, rows = gcfg.d_model, gcfg.vocab, TRAIN_ROWS
    gtable = randn(gv, gd, scale=gd ** -0.5)
    ga, gdc = randn(rows, gd), randn(rows, gv, scale=1e-3)
    kw16 = dict(acc_dtype=f32, out_dtype=bf16)
    for op, m, n, k, operands, run_k, run_p, run_lib in (
            ("dA", rows, gd, gv, (gdc, gtable),
             lambda: kg.grad_a(gdc, gtable.T, bf16),
             lambda: gemm_ref(gdc, gtable, None, **kw16),
             lambda: torch.matmul(gdc, gtable)),
            ("dB", gd, gv, rows, (gdc.t(), ga),
             lambda: kg.grad_b(ga, gdc, bf16, trans=True),
             lambda: gemm_ref(ga.t(), gdc, None, **kw16),
             lambda: torch.matmul(ga.t(), gdc))):
        label = f"{op} granite unembed M={m} N={n} K={k}"
        route, geo = bwd_plan_text(operands)
        if geo:
            fail(f"gemm[bwd] [{label}]: a vocab of {gv} routed to the "
                 f"backward kernel, which no tensor map lets read it")
        cases.append((
            "gemm[bwd]", label, False, "bf16", run_k, run_p, run_lib,
            2 * (m * k + k * n + m * n), 2.0 * m * n * k,
            {"plan": f"{route} route: " + gemm_plan_text(kg, m, n, k)}))
    # the fp32 datapath (fp32 engine config), TF32 off as main sets it
    for pname, m, n, k, run_k, run_p, run_lib, nbytes in fp32_gemm_cases(
            torch, randn):
        cases.append(("gemm[fp32]", f"fp32 {pname} M={m} N={n} K={k}", False,
                      "fp32", run_k, run_p, run_lib, nbytes, 2.0 * m * n * k,
                      {"plan": gemm_plan_text(kg, m, n, k, dtype=f32)}))
    # granite-moe-3b-a800m (phase 12): the router, fp32 in and bf16 out
    # (held by the bf16 rule: the two sum orders may round a value either
    # way; bounded at the fp32 rate), and the odd-N tied unembedding
    for pname, m, n, k, kind, run_k, run_p, run_lib, nbytes, trans in \
            moe_gemm_cases(torch, randn):
        router = kind == "fp32"
        label = f"{pname} M={m} N={n} K={k}"
        opts = {"plan": gemm_plan_text(kg, m, n, k, trans,
                                       dtype=f32 if router else bf16)}
        if router:
            opts["check"] = lambda got, want, label=label: check_close(
                torch, f"gemm[fp32] [{label}]", got, want, "bf16")
        cases.append(("gemm[fp32]" if router else "gemm", label,
                      router and m == 4, kind, run_k, run_p, run_lib, nbytes,
                      2.0 * m * n * k, opts))

    # -- flash_attention: a fresh prompt or first chunk, local and global
    def flash_case(t_q, t_k, h, kvh, dh, window, softcap, rep, dtype=bf16):
        q = randn(1, t_q, h, dh, dtype=dtype)
        k = randn(1, t_k, kvh, dh, dtype=dtype)
        v = randn(1, t_k, kvh, dh, dtype=dtype)
        kw = dict(causal=True, window=window, softcap=softcap)
        pairs = sum(min(i + t_k - t_q + 1, window or 1 << 30)
                    for i in range(t_q))
        nbytes = q.element_size() * (2 * t_q * h * dh + 2 * t_k * kvh * dh)

        # SDPA computes the same function without a softcap: causal, and
        # where the window cuts keys, under the window's boolean mask.
        band = None
        if window is not None and window < t_k:
            i = torch.arange(t_q, device="cuda")[:, None] + t_k - t_q
            j = torch.arange(t_k, device="cuda")[None, :]
            band = (j <= i) & (j > i - window)

        def library():
            return torch.nn.functional.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=band, is_causal=band is None, enable_gqa=True)
        lib = library if softcap is None and t_q == t_k else None
        kind = KIND_OF[dtype]
        if dtype != f32:
            cl, blocks = flash_grid(t_q, t_k, h, dh, window)
            grid = f"{blocks} blocks, clusters of {cl}"
        else:
            grid = f32_grid(t_q, t_k, h, kvh, dh, True, window)
        cases.append(("flash_attention" + F16_SUFFIX.get(dtype, ""),
                      f"{kind} Tq={t_q} Tk={t_k} H={h} KVH={kvh} D={dh} "
                      f"window={window} softcap={softcap}", rep, kind,
                      lambda: ka.flash_attention(q, k, v, **kw),
                      lambda: ka.blockwise_attention(q, k, v, **kw), lib,
                      nbytes, 4.0 * dh * h * pairs, dict(grid=grid)))
    flash_case(256, 256, nh, nkv, hd, None, None, True)
    flash_case(256, 256, nh, nkv, hd, cfg.local_window, None, False)
    # fp16 (phase 20's model) at the bf16 rows' shapes, SDPA fp16 beside
    flash_case(256, 256, nh, nkv, hd, None, None, True, dtype=f16)
    flash_case(256, 256, nh, nkv, hd, cfg.local_window, None, False,
               dtype=f16)
    flash_stress_case(torch, randn, cases, nh, nkv, hd)
    flash_case(64, 64, nh, nkv, hd, None, None, False)
    flash_case(64, 64, nh, nkv, hd, cfg.local_window, None, False)
    flash_case(100, 200, 8, 2, 128, 64, 50.0, False)
    # hymba-1.5b's first chunk as phase 8 launches it: 256 cache positions
    # (its 128 meta tokens lead the prompt), GQA 25 / 5, head dim 64
    hy = configs.get("hymba-1.5b")
    flash_case(256, 256, hy.n_heads, hy.n_kv_heads, hy.head_dim,
               hy.local_window, None, False)
    # and in fp32, as phase 8's fp32 logits run it (the CUDA-core kernel)
    flash_case(256, 256, hy.n_heads, hy.n_kv_heads, hy.head_dim,
               hy.local_window, None, False, dtype=f32)
    # granite-moe-3b-a800m's first chunk (phase 12): GQA 24 / 8, head dim 64
    gr = configs.get("granite-moe-3b-a800m")
    flash_case(256, 256, gr.n_heads, gr.n_kv_heads, gr.head_dim, None, None,
               False)
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
                     softcap, rep, dtype=bf16):
        kp, vp = (x.to(dtype) for x in pools(kvh, n_pages, page, dh))
        perm = torch.randperm(n_pages, generator=gen, device="cuda")
        table = perm[:kv_pages].to(torch.int32)
        q = randn(1, t, h, dh, dtype=dtype)
        kw = dict(window=window, softcap=softcap)
        pairs = sum(min(start + i + 1, window or 1 << 30) for i in range(t))
        live = start + t if window is None else min(start + t,
                                                    window - 1 + t)
        kind = KIND_OF[dtype]
        nbytes = q.element_size() * (2 * t * h * dh + 2 * live * kvh * dh) \
            + 4 * kv_pages
        # the dense flash kernel on the same keys gathered beforehand: what
        # reading them through the block table costs (not a library call)
        kg_, vg_ = (ka._gather(x, table[None])[:, :start + t].contiguous()
                    for x in (kp, vp))
        opts = dict(dense=lambda: ka.flash_attention(q, kg_, vg_, **kw))
        if dtype != f32:
            cl, blocks = flash_grid(t, start + t, h, dh, window)
            opts["grid"] = f"{blocks} blocks, clusters of {cl}"
        else:
            opts["grid"] = f32_grid(t, start + t, h, kvh, dh, True, window)
        cases.append(("paged_prefill_attention" + F16_SUFFIX.get(dtype, ""),
                      f"{'fp32 ' if dtype == f32 else ''}T={t} start={start} "
                      f"H={h} KVH={kvh} D={dh} kv_pages={kv_pages} "
                      f"window={window} softcap={softcap}", rep, kind,
                      lambda: ka.paged_prefill_attention(q, kp, vp, table,
                                                         start, **kw),
                      lambda: ka.paged_prefill_attention_plain(
                          q, kp, vp, table, start, **kw), None,
                      nbytes, 4.0 * dh * h * pairs, opts))
    for start in (256, 512, 768):
        prefill_case(256, start, nh, nkv, hd, 64, 128, 16, None, None,
                     start == 768)
        prefill_case(256, start, nh, nkv, hd, 64, 128, 16, cfg.local_window,
                     None, False)
    prefill_case(256, 768, nh, nkv, hd, 64, 128, 16, None, None, True,
                 dtype=f16)
    prefill_case(64, 256, nh, nkv, hd, 64, 128, 5, None, None, False)
    prefill_case(50, 37, 8, 2, 128, 16, 40, 6, 24, 50.0, False)
    # hymba-1.5b's continuation chunk as phase 8's profile runs it: T=256 at
    # 768, GQA 25 / 5, head dim 64, its 1024-token window
    prefill_case(256, 768, hy.n_heads, hy.n_kv_heads, hy.head_dim, 64, 128,
                 16, hy.local_window, None, False)
    # and in fp32 (the CUDA-core kernel on hymba's widths)
    prefill_case(256, 768, hy.n_heads, hy.n_kv_heads, hy.head_dim, 64, 128,
                 16, hy.local_window, None, False, dtype=f32)
    # granite-moe-3b-a800m's continuation chunk (phase 12): T=256 at 768
    prefill_case(256, 768, gr.n_heads, gr.n_kv_heads, gr.head_dim, 64, 128,
                 16, None, None, False)
    # phase 9's gate in fp32 (the CUDA-core kernel): each attention arch's
    # last continuation chunk of its longest prompt, as the gate's engine
    # runs it (page 16, 24 pages, chunks of sd.PREFILL_CHUNK)
    for arch in sd.ARCHS:
        sc = configs.get_smoke(arch)
        if not sc.has_attn:
            continue
        t = sd.PREFILL_CHUNK
        start = max(sd.PROMPT_LENS) + sc.n_meta_tokens - t
        for window in (None, sc.local_window) if sc.local_window \
                else (None,):
            prefill_case(t, start, sc.n_heads, sc.n_kv_heads, sc.head_dim, 16,
                         24, -(-(start + t) // 16), window, sc.attn_softcap,
                         False, dtype=f32)

    def decode_case(lengths, h, kvh, dh, page, n_pages, mp, window, softcap,
                    rep, dtype=bf16):
        kp, vp = (x.to(dtype) for x in pools(kvh, n_pages, page, dh))
        s = len(lengths)
        perm = torch.randperm(n_pages, generator=gen, device="cuda")
        tables = perm[:s * mp].reshape(s, mp).to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = randn(s, 1, h, dh, dtype=dtype)
        kw = dict(window=window, softcap=softcap)
        live = sum(min(n, window or 1 << 30) for n in lengths)
        nbytes = (q.element_size() * (2 * s * h * dh + 2 * live * kvh * dh)
                  + 4 * s * (mp + 1))
        kind = KIND_OF[dtype]
        splits, groups, _, split, _ = ka.paged_decode_plan(s, mp, page, h,
                                                           kvh, dh, window)
        first = [(max(0, n - window) if window else 0) // split
                 for n in lengths]
        busy = sum(-(-n // split) - f if n else 1
                   for n, f in zip(lengths, first)) * (groups // s)
        cases.append(("paged_decode_attention" + F16_SUFFIX.get(dtype, ""),
                      f"{'fp32 ' if dtype == f32 else ''}S={s} "
                      f"lengths={lengths} H={h} KVH={kvh} D={dh} "
                      f"window={window} softcap={softcap}", rep, kind,
                      lambda: ka.paged_decode_attention(q, kp, vp, tables,
                                                        lens, **kw),
                      lambda: ka.paged_decode_attention_plain(
                          q, kp, vp, tables, lens, **kw), None,
                      nbytes, 4.0 * dh * h * live,
                      dict(grid=f"{splits * groups} blocks ({splits} splits "
                           f"of {split} keys x {groups}), {busy} live")))
    serve_lengths = [1010, 530, 310, 80]
    decode_case(serve_lengths, nh, nkv, hd, 64, 128, 32, None, None, True)
    decode_case(serve_lengths, nh, nkv, hd, 64, 128, 32, None, None, True,
                dtype=f16)
    decode_case(serve_lengths, nh, nkv, hd, 64, 128, 32, cfg.local_window,
                None, False)
    decode_case([77, 0, 16, 33], 8, 2, 128, 16, 40, 8, 24, 50.0, False)
    # granite-moe-3b-a800m's decode step (phase 12): GQA 24 / 8, head dim 64
    decode_case(serve_lengths, gr.n_heads, gr.n_kv_heads, gr.head_dim, 64,
                128, 32, None, None, False)
    # phase 9's gate in fp32: the engine's two slots at the last decode step
    # of the first two requests (page 16, 24 pages), each attention arch's
    # windows and softcap
    for arch in sd.ARCHS:
        sc = configs.get_smoke(arch)
        if not sc.has_attn:
            continue
        lengths = [p + sc.n_meta_tokens + g - 1
                   for p, g in zip(sd.PROMPT_LENS[:2], sd.GEN_LENS[:2])]
        for window in (None, sc.local_window) if sc.local_window \
                else (None,):
            decode_case(lengths, sc.n_heads, sc.n_kv_heads, sc.head_dim, 16,
                        24, -(-max(lengths) // 16), window, sc.attn_softcap,
                        False, dtype=f32)
    engine_cases(torch, gen, cases)
    epilogue_cases(torch, gen, cases)
    datapath_cases(torch, gen, cases)
    generic_cases(torch, gen, cases)
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


def ssd_grid(t, h, g, n, chunk):
    """The bf16 SSD kernel's launches and blocks (``launch_tc`` in
    ``ssd.cu``): one launch per chunk, each with an output block per
    (64-row tile, pair of heads of a group) and a state block per (64-row
    slice of N, head), per batch row."""
    q = min(chunk, t)
    out = -(-q // 64) * g * -(-(h // g) // 2)
    state = -(-(-(-n // 16) * 16) // 64) * h
    return (f"{-(-t // q)} launches of {out + state} blocks ({out} output, "
            f"{state} state)")


def ssd32_grid(t, h, g, n, chunk):
    """The fp32 SSD kernel's launches and blocks (``launch_f32`` in
    ``ssd.cu``): one launch per chunk of clusters of two blocks, each with
    a cluster per (32-row tile, pair of heads of a group), its two blocks
    splitting the key tiles, and a state block per (64-row slice of N,
    32 where N <= 32, head; their count made even), per batch row."""
    q = min(chunk, t)
    out = 2 * -(-q // 32) * g * -(-(h // g) // 2)
    state = -(-n // (64 if n > 32 else 32)) * h
    state += state % 2
    return (f"{-(-t // q)} launches of {out + state} blocks in clusters of 2 "
            f"({out} output, {state} state)")


def ssd32_check(torch, name, got, x, dt, a_log, b, c, d_skip, init, chunk):
    """The fp32 SSD's y and final state against the fp64 recurrence
    (``tests/_ssd_exact.py``) within ``fp32_tolerance`` of each one's
    largest magnitude; returns the larger error."""
    from _ssd_exact import fp32_tolerance, ssd_fp64

    exact_y, exact = ssd_fp64(x, dt, a_log, b, c, d_skip=d_skip,
                              initial_state=init)
    tol = fp32_tolerance(dt, a_log, chunk)
    worst = 0.0
    for what, v, e in (("y", got[0], exact_y), ("state", got[1], exact)):
        err = (v.double() - e).abs().max().item()
        if not torch.isfinite(v).all() or err > tol * e.abs().max().item():
            fail(f"{name}: {what} err {err:.3e} > {tol:.2e} x "
                 f"{e.abs().max().item():.3e}")
        worst = max(worst, err)
    return worst


def recurrent_cases(torch, gen, cases):
    """The chunked SSD at mamba2-1.3b's and hymba-1.5b's widths (bf16 x,
    B, C; fp32 dt and states), fresh and resumed, and on a ragged 7-token
    prompt; dense decode attention at gemma3-1b's shape (global and the
    512 window) and hymba-1.5b's (GQA 25 / 5, head dim 64, window 1024).

    The SSD runs at T = 256 resumed (the call serving makes: one chunk
    with a carried state; mamba2-1.3b's is the representative row) and at
    T = 1000 (four chunks, fresh and resumed). Its y is held against the
    plain version in bf16; its final state against the naive recurrence in
    fp64 (``tests/_ssd_exact.py``) within ``fp32_tolerance`` (exp of the
    per-chunk cumulative decay turns that sum's fp32 rounding into a
    relative error). Its bound takes the bf16 tensor-core peak (the bf16
    kernel's products run on tensor cores); the row also logs the bound at
    the fp32 CUDA-core peak (67 TFLOP/s, ``bound_fp32_ms``), the bound of
    the fp32 kernel."""
    from _ssd_exact import fp32_tolerance, ssd_fp64

    from repro_torch import configs
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import mamba2 as km

    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    def ssd_case(arch, t, resume, rep, dtype=bf16):
        cfg = configs.get(arch)
        h, p, g, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
            cfg.d_state
        chunk = cfg.ssm_chunk
        kind = "fp16" if dtype == f16 else "bf16"
        x = randn(1, t, h, p, dtype=dtype)
        b, c = (randn(1, t, g, n, scale=0.3, dtype=dtype) for _ in range(2))
        dt = torch.nn.functional.softplus(randn(1, t, h, dtype=f32))
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
        d_skip = torch.ones((h,), dtype=f32, device="cuda")
        init = randn(1, h, n, p, dtype=f32, scale=0.5) if resume else None
        kw = dict(d_skip=d_skip, chunk=chunk, initial_state=init,
                  return_final_state=True)
        name = f"ssd [{kind} {arch} T={t}]"

        def check(got, want):
            err = check_close(torch, name, got[0], want[0], kind)
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
        flops = ssd_flops(t, h, p, g, n, chunk, resume)
        grid = ssd_grid(t, h, g, n, chunk) + (
            " (fp16: the scores on the .f16 MMA, the rest on exact bf16 "
            "terms)" if dtype == f16 else "")
        cases.append(("ssd" + ("[fp16]" if dtype == f16 else ""),
                      f"{'fp16 ' if dtype == f16 else ''}{arch} B=1 T={t} "
                      f"H={h} P={p} G={g} N={n} "
                      f"chunk={chunk} {'resumed' if resume else 'fresh'}",
                      rep, kind,
                      lambda: km.ssd(x, dt, a_log, b, c, **kw),
                      lambda: km.ssd_plain(x, dt, a_log, b, c, **kw), None,
                      nbytes, flops,
                      dict(check=check, grid=grid,
                           bound_fp32_ms=bound_ms(nbytes, flops,
                                                  "fp32")[0])))
    ssd_case("mamba2-1.3b", 256, True, True)
    ssd_case("hymba-1.5b", 256, True, False)
    ssd_case("mamba2-1.3b", 1000, False, False)
    ssd_case("mamba2-1.3b", 1000, True, False)
    ssd_case("hymba-1.5b", 1000, False, False)
    ssd_case("hymba-1.5b", 1000, True, False)
    ssd_case("mamba2-1.3b", 7, False, False)
    ssd_case("mamba2-1.3b", 256, True, True, dtype=f16)
    ssd_case("hymba-1.5b", 256, True, False, dtype=f16)
    ssd_stress_case(torch, gen, cases)

    def ssd32_case(arch, t, resume=False):
        """The fp32 CUDA-core kernel at the shape of phases 7-8's fp32
        logits (one fresh 256-token prompt), a resumed chunk and a fresh
        1000-token call (four launches): y and the final state held
        against the fp64 recurrence within ``fp32_tolerance``."""
        cfg = configs.get(arch)
        h, p, g, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
            cfg.d_state
        chunk = cfg.ssm_chunk
        x = randn(1, t, h, p, dtype=f32)
        b = randn(1, t, g, n, dtype=f32, scale=0.3)
        c = randn(1, t, g, n, dtype=f32, scale=0.3)
        dt = torch.nn.functional.softplus(randn(1, t, h, dtype=f32))
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
        d_skip = torch.ones((h,), dtype=f32, device="cuda")
        init = randn(1, h, n, p, dtype=f32, scale=0.5) if resume else None
        kw = dict(d_skip=d_skip, chunk=chunk, initial_state=init,
                  return_final_state=True)
        name = f"ssd [fp32 {arch} T={t}{' resumed' if resume else ''}]"

        def check(got, want):
            return ssd32_check(torch, name, got, x, dt, a_log, b, c, d_skip,
                               init, chunk)

        nbytes = (4 * 2 * t * h * p + 4 * 2 * t * g * n + 4 * t * h + 8 * h
                  + 4 * h * n * p * (2 if resume else 1))
        flops = ssd_flops(t, h, p, g, n, chunk, resume)
        cases.append(("ssd", f"fp32 {arch} B=1 T={t} H={h} P={p} G={g} N={n} "
                      f"chunk={chunk} {'resumed' if resume else 'fresh'}",
                      False, "fp32",
                      lambda: km.ssd(x, dt, a_log, b, c, **kw),
                      lambda: km.ssd_plain(x, dt, a_log, b, c, **kw), None,
                      nbytes, flops,
                      dict(check=check, grid=ssd32_grid(t, h, g, n, chunk))))
    ssd32_case("mamba2-1.3b", 256)
    ssd32_case("hymba-1.5b", 256)
    ssd32_case("mamba2-1.3b", 256, resume=True)
    ssd32_case("hymba-1.5b", 256, resume=True)
    ssd32_case("mamba2-1.3b", 1000)
    ssd32_case("hymba-1.5b", 1000)

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
        kind = {f32: "fp32", bf16: "bf16", f16: "fp16"}[dtype]
        nbytes = q.element_size() * (2 * b * h * dh + 2 * b * live * kvh * dh)
        splits, groups, _, split, _ = ka.decode_plan(b, s, h, kvh, dh, pos,
                                                     window)
        opts = dict(grid=f"{splits * groups} blocks ({splits} splits of "
                    f"{split} keys x {groups})")
        if "masked" in libs:
            opts["library_masked"] = libs["masked"]
        cases.append(("decode_attention" + ("[fp16]" if dtype == f16 else ""),
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
                None, None, True, dtype=f16)
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


def resnet50_shapes():
    """dse.resnet(50)'s distinct layers at batch 1, as phase 6 runs them:
    (label, GEMM (M, N, K), conv (H, CI, CO, KH, stride, pad), count)."""
    import math

    from repro_torch.core import dse

    out = {}
    for g in dse.resnet(50).gemms:
        if g.m == 1:
            label, conv = "classifier", (1, g.k, g.n, 1, 1, 0)
        elif g.k == 7 * 7 * 3:
            label, conv = "conv1 7x7/2", (224, 3, g.n, 7, 2, 3)
        else:
            h = math.isqrt(g.m)
            stage = {56: 1, 28: 2, 14: 3, 7: 4}[h]
            if g.k % 9 == 0:
                label, conv = f"stage-{stage} 3x3", (h, g.k // 9, g.n, 3, 1, 1)
            else:
                label, conv = f"stage-{stage} 1x1", (h, g.k, g.n, 1, 1, 0)
        key = (g.m, g.n, g.k)
        if key in out:
            out[key][3] += 1
        else:
            out[key] = [label, key, conv, 1]
    return [tuple(v) for v in out.values()]


def s8_plan_text(kg, m, n, k):
    """The int8 kernel's plan for a shape (both dataflows take it), as
    phase 3 logs it."""
    p = kg.gemm_s8_plan(m, n, k)
    bm, bn, bk = p["tile"]
    return (f"{p['regime']} {bm}x{bn}x{bk}, {p['splits']} K splits, "
            f"{p['grid']} blocks x {p['threads']}, {p['stages']} stages, "
            f"{p['smem']} B shared, workspace {p['workspace_bytes']} B")


def engine_cases(torch, gen, cases):
    """The engine path's int8 kernels at its shapes: the quickstart GEMM
    (bias, shift 7, ReLU), every distinct layer of ResNet-50's stream as a
    GEMM (classifier included) and a ragged GEMM, each on both dataflows
    with its plan (``gemm_s8_plan``) and ``torch._int_mm`` beside it where
    that call takes the shape; the mvout epilogue; the conv kernel at
    every distinct conv of the stream (stem, 1x1 and 3x3 per stage)."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import conv2d_ref, gemm_ref

    i8, i32 = torch.int8, torch.int32

    def rint(lo, hi, *shape, dtype=i8):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=dtype)

    relu = Activation.RELU
    shapes = resnet50_shapes()
    gemms = [("quickstart", 1000, 512, 2048, True)] + \
        [(f"resnet50 {label}", *mnk, False) for label, mnk, _, _ in shapes] + \
        [("ragged", 37, 77, 147, False)]
    for label, m, n, k, rep in gemms:
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
        for kernel, fn in (("gemm[int8]", kg.gemm_os),
                           ("gemm_ws", kg.gemm_ws)):
            cases.append((
                kernel, f"{label} M={m} N={n} K={k} bias shift=7 relu", rep,
                "int", lambda a=a, b=b, bias=bias, fn=fn, kw=kw:
                fn(a, b, bias, **kw),
                lambda a=a, b=b, bias=bias, kw=kw: gemm_ref(a, b, bias, **kw),
                lib, m * k + k * n + 4 * n + m * n, 2.0 * m * n * k,
                {"plan": s8_plan_text(kg, m, n, k)}))

    # PyTorch has no int8 convolution on the card: the conv rows have no
    # library yardstick (logged once).
    try:
        torch.nn.functional.conv2d(rint(-4, 4, 1, 8, 8, 8),
                                   rint(-4, 4, 8, 8, 3, 3), padding=1)
        log("torch.nn.functional.conv2d ran on int8 CUDA tensors")
    except RuntimeError as e:
        log(f"torch.nn.functional.conv2d on int8 CUDA tensors raised "
            f"RuntimeError: {str(e).splitlines()[0]}")
    for label, mnk, (h, ci, co, kh, stride, pad), _ in shapes:
        if label == "classifier":
            continue
        x = rint(-64, 64, 1, h, h, ci)
        w = rint(-32, 32, kh, kh, ci, co)
        bias = rint(-500, 500, co, dtype=i32)
        oh = (h + 2 * pad - kh) // stride + 1
        kw = dict(stride=stride, padding=pad, acc_dtype=i32, out_dtype=i8,
                  shift=8, activation=relu)
        cases.append((
            "conv2d_implicit", f"{label} 1x{h}x{h}x{ci} -> {oh}x{oh}x{co}",
            label == "stage-1 3x3", "int",
            lambda x=x, w=w, bias=bias, kw=kw: kc.conv2d_implicit(x, w, bias,
                                                                  **kw),
            lambda x=x, w=w, bias=bias, kw=kw: conv2d_ref(x, w, bias, **kw),
            None, x.numel() + w.numel() + 4 * co + oh * oh * co,
            2.0 * oh * oh * co * kh * kh * ci,
            {"plan": s8_plan_text(kg, *mnk)}))


# The mvout epilogue's six datapaths: (accumulator, output, check kind,
# rounding shift). The fp16 rows scale their fp32 values by 2^14, so some
# overflow to inf (as JAX's astype stores them).
EPILOGUE_PAIRS = (("int32", "int8", "int", 7), ("int32", "int16", "int", 9),
                  ("int32", "int32", "int", 7), ("fp32", "fp32", "fp32", 2),
                  ("fp32", "bf16", "bf16", 2), ("fp32", "fp16", "fp16", 0))
# A shape whose count is no multiple of four, read from a slice that starts
# one element (4 bytes) past a 16-byte boundary: the kernel's scalar head
# and tail, and runs whose outputs are stored one by one.
EPILOGUE_ODD = (999, 513)


def epilogue_cases(torch, gen, cases):
    """accumulator_epilogue at its six datapaths, each at the mvout
    route's shape (1000, 512) and at ``EPILOGUE_ODD`` misaligned, and
    fp32 -> fp32 / fp16 at (3136, 256) (ResNet-50's stage-1 output; fp16
    overflow to inf); ReLU throughout. The int32 -> int8 row at (1000,
    512) is the kernels line's."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import epilogue as epi
    from repro_torch.kernels import gemm as kg

    dtypes = {"int32": torch.int32, "int8": torch.int8,
              "int16": torch.int16, "fp32": torch.float32,
              "bf16": torch.bfloat16, "fp16": torch.float16}

    def accumulator(acc_name, out_name, count):
        if acc_name == "int32":
            return torch.randint(-2 ** 31, 2 ** 31 - 1, (count,),
                                 generator=gen, device="cuda",
                                 dtype=torch.int32)
        scale = 2.0 ** 14 if out_name == "fp16" else 8.0
        return torch.randn((count,), generator=gen, device="cuda") * scale

    shapes = [((1000, 512), 0), (EPILOGUE_ODD, 1)]
    for acc_name, out_name, kind, shift in EPILOGUE_PAIRS:
        runs = shapes + ([((3136, 256), 0)] if acc_name == "fp32" and
                         out_name != "bf16" else [])
        for shape, offset in runs:
            count = shape[0] * shape[1]
            acc = accumulator(acc_name, out_name, count + offset)[
                offset:].view(shape)
            out = dtypes[out_name]
            kw = dict(out_dtype=out, shift=shift,
                      activation=Activation.RELU)
            label = (f"{acc_name} {shape} -> {out_name} shift={shift} relu"
                     + (f" at +{4 * offset} bytes" if offset else ""))
            cases.append((
                "accumulator_epilogue", label,
                (acc_name, out_name, shape) == ("int32", "int8", (1000, 512)),
                kind,
                lambda acc=acc, kw=kw: kg.accumulator_epilogue(acc, **kw),
                lambda acc=acc, kw=kw: epi.apply(acc, **kw), None,
                (4 + out.itemsize) * count, 0.0))


# The float and 16-bit datapaths (phase 6b): each kernel's report name,
# and each input type's check kind and epilogue shift.
DATAPATH_KERNELS = ("gemm[fp16]", "gemm[int16]", "conv2d_implicit[fp32]",
                    "conv2d_implicit[bf16]", "conv2d_implicit[fp16]",
                    "conv2d_implicit[int16]")
DATAPATH_KIND = {"fp32": "fp32", "bf16": "bf16", "fp16": "fp16",
                 "int16": "int16"}


def datapath_operands(torch, gen, dtype, shape_x, shape_w, n):
    """Operands at ``dtype`` from ``gen``: floats x ~ N(0, 1), w ~ N(0, 1) /
    sqrt(K) (K: the product of w's leading dimensions) and an fp32 N(0, 1)
    bias, shift 1; int16 x in [-2^14, 2^14), w in [-2^8, 2^8) and an int32
    bias in [-2^24, 2^24), shift 10 (enough for some outputs to
    saturate). Returns (x, w, bias, shift)."""
    import math

    k = math.prod(shape_w[:-1])
    if dtype.is_floating_point:
        x = torch.randn(shape_x, generator=gen, device="cuda").to(dtype)
        w = (torch.randn(shape_w, generator=gen, device="cuda") * k ** -0.5
             ).to(dtype)
        return x, w, torch.randn((n,), generator=gen, device="cuda"), 1
    x = torch.randint(-2 ** 14, 2 ** 14, shape_x, generator=gen,
                      device="cuda", dtype=dtype)
    w = torch.randint(-2 ** 8, 2 ** 8, shape_w, generator=gen, device="cuda",
                      dtype=dtype)
    b = torch.randint(-2 ** 24, 2 ** 24, (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    return x, w, b, 10


def conv_plan_text(kc, m, n, k, dtype):
    """The conv kernel's plan for a datapath and an implicit GEMM."""
    p = kc.conv_plan(m, n, k, dtype)
    bm, bn, bk = p["tile"]
    return (f"{p['regime']} {bm}x{bn}x{bk}, {p['splits']} K splits, "
            f"{p['grid']} blocks x {p['threads']}, {p['stages']} stages, "
            f"{p['smem']} B shared, workspace {p['workspace_bytes']} B")


def datapath_cases(torch, gen, cases):
    """The float and 16-bit datapaths' kernels at phase 6b's shapes:
    gemm[fp16] and gemm[int16] at the quickstart GEMM (1000 x 512 x 2048,
    bias, ReLU) on both dataflows, fp16 beside ``torch.matmul``; the int8
    kernel with int16 outputs and the bf16 kernel with fp16 outputs there;
    and each conv kernel (fp32, bf16, fp16, int16) at the stem, stage-1
    3x3 and stage-4 3x3 convs
    beside ``torch.nn.functional.conv2d`` on channels-last views (conv and
    bias; fp32 with TF32 off, as ``main`` sets it). PyTorch has no int16
    matmul or conv on the card: the errors are logged, and those rows have
    no library time. Each row logs its kernel's plan."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import conv2d_ref, gemm_ref

    f32, i32 = torch.float32, torch.int32
    dtypes = {"fp32": f32, "bf16": torch.bfloat16, "fp16": torch.float16,
              "int16": torch.int16}
    relu = Activation.RELU
    probe = torch.ones((4, 4), dtype=torch.int16, device="cuda")
    for what, call in (
            ("torch.matmul", lambda: probe @ probe),
            ("torch.nn.functional.conv2d",
             lambda: torch.nn.functional.conv2d(probe[None, None],
                                                probe[None, None]))):
        try:                          # the yardstick only, never the port
            call()
            log(f"{what} ran on int16 CUDA tensors")
        except RuntimeError as e:
            log(f"{what} on int16 CUDA tensors raised RuntimeError: "
                f"{str(e).splitlines()[0]}")

    m, n, k = 1000, 512, 2048
    for kind, name in (("fp16", "gemm[fp16]"), ("int16", "gemm[int16]")):
        dt = dtypes[kind]
        a, b, bias, shift = datapath_operands(torch, gen, dt, (m, k), (k, n),
                                              n)
        kw = dict(acc_dtype=f32 if dt.is_floating_point else i32,
                  out_dtype=dt, shift=shift, activation=relu)
        lib = (lambda a=a, b=b: torch.matmul(a, b)) if kind == "fp16" \
            else None
        plan = gemm_plan_text(kg, m, n, k, dtype=dt)
        for kernel, fn in ((name, kg.gemm_os), ("gemm_ws", kg.gemm_ws)):
            cases.append((
                kernel, f"{kind} quickstart M={m} N={n} K={k} bias "
                f"shift={shift} relu", kernel == name, kind,
                lambda a=a, b=b, bias=bias, fn=fn, kw=kw: fn(a, b, bias, **kw),
                lambda a=a, b=b, bias=bias, kw=kw: gemm_ref(a, b, bias, **kw),
                lib if kernel == name else None,
                2 * (m * k + k * n + m * n) + 4 * n, 2.0 * m * n * k,
                {"plan": plan}))
    # the older kernels' new outputs: int8 -> int16, bf16 -> fp16
    for kernel, dt, out, kind, label in (
            ("gemm[int8]", torch.int8, torch.int16, "int", "int8 -> int16"),
            ("gemm", torch.bfloat16, torch.float16, "fp16", "bf16 -> fp16")):
        if dt.is_floating_point:
            a, b, bias, shift = datapath_operands(torch, gen, dt, (m, k),
                                                  (k, n), n)
        else:
            a = torch.randint(-128, 128, (m, k), generator=gen,
                              device="cuda", dtype=dt)
            b = torch.randint(-128, 128, (k, n), generator=gen,
                              device="cuda", dtype=dt)
            bias = torch.randint(-2 ** 20, 2 ** 20, (n,), generator=gen,
                                 device="cuda", dtype=i32)
            shift = 4
        kw = dict(acc_dtype=f32 if dt.is_floating_point else i32,
                  out_dtype=out, shift=shift, activation=relu)
        cases.append((
            kernel, f"{label} quickstart M={m} N={n} K={k} bias "
            f"shift={shift} relu", False, kind,
            lambda a=a, b=b, bias=bias, kw=kw: kg.gemm_os(a, b, bias, **kw),
            lambda a=a, b=b, bias=bias, kw=kw: gemm_ref(a, b, bias, **kw),
            None, a.element_size() * (m * k + k * n) + 2 * m * n + 4 * n,
            2.0 * m * n * k))
    shapes = {label: (mnk, conv) for label, mnk, conv, _ in resnet50_shapes()}
    for kind, dt in dtypes.items():
        name = f"conv2d_implicit[{kind}]"
        for label in ("conv1 7x7/2", "stage-1 3x3", "stage-4 3x3"):
            (mm, co, kk), (h, ci, _, kh, stride, pad) = shapes[label]
            x, w, bias, shift = datapath_operands(
                torch, gen, dt, (1, h, h, ci), (kh, kh, ci, co), co)
            acc_t = f32 if dt.is_floating_point else i32
            kw = dict(stride=stride, padding=pad, acc_dtype=acc_t,
                      out_dtype=dt, shift=shift, activation=relu)
            lib = None
            if dt.is_floating_point:
                # the library's own layout, made once: NCHW views of the
                # NHWC image and an OIHW channels-last filter
                xl = x.permute(0, 3, 1, 2)
                wl = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                bl = bias.to(dt)
                lib = (lambda xl=xl, wl=wl, bl=bl, stride=stride, pad=pad:
                       torch.nn.functional.conv2d(xl, wl, bl, stride=stride,
                                                  padding=pad))
            oh = (h + 2 * pad - kh) // stride + 1
            es = x.element_size()
            cases.append((
                name, f"{label} 1x{h}x{h}x{ci} -> {oh}x{oh}x{co}",
                label == "stage-1 3x3", DATAPATH_KIND[kind],
                lambda x=x, w=w, bias=bias, kw=kw: kc.conv2d_implicit(
                    x, w, bias, **kw),
                lambda x=x, w=w, bias=bias, kw=kw: conv2d_ref(x, w, bias,
                                                              **kw),
                lib, es * (x.numel() + w.numel() + oh * oh * co) + 4 * co,
                2.0 * oh * oh * co * kh * kh * ci,
                {"plan": conv_plan_text(kc, mm, co, kk, dt)}))


def run_kernel_phase(torch, timer):
    """Each case: (kernel, label, representative, kind, run_kernel,
    run_plain, run_library, bytes, flops[, opts]); ``opts["check"]``
    replaces ``check_close`` for a kernel with several outputs,
    ``opts["grid"]`` describes the kernel's grid, ``opts["plan"]`` the
    float GEMM's plan, ``opts["bound_fp32_ms"]`` a second bound (at the
    fp32 CUDA-core peak), ``opts["library_masked"]`` a second one-call
    yardstick and ``opts["dense"]`` the dense kernel on keys gathered
    beforehand (timed beside the paged one)."""
    return run_cases(torch, timer, kernel_cases(torch))


def run_cases(torch, timer, cases):
    """Check and time each case (``run_kernel_phase``'s tuples); returns
    the rows and the representative row of each kernel."""
    rows, summary = [], {}
    for (kernel, label, rep, kind, run_k, run_p, run_lib, nbytes, flops,
         *opts) in cases:
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
        b_ms, b_by = bound_ms(nbytes, flops, kind)
        row = {"name": kernel, "shape": label, "max_abs_err": err, "ms": ms,
               "host_ms": host_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
               "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
               "flops": flops}
        extra = ""
        if "library_masked" in opts:
            row["library_masked_ms"] = timer(opts["library_masked"])
            extra += f"  masked library {row['library_masked_ms']:.4f} ms"
        if "dense" in opts:
            row["dense_flash_ms"] = timer(opts["dense"])
            extra += (f"  dense flash on the gathered keys "
                      f"{row['dense_flash_ms']:.4f} ms")
        if "grid" in opts:
            row["grid"] = opts["grid"]
            extra += f"  grid {opts['grid']}"
        if "plan" in opts:
            row["plan"] = opts["plan"]
            extra += f"  plan {opts['plan']}"
        if "bound_fp32_ms" in opts:
            row["bound_fp32_ms"] = opts["bound_fp32_ms"]
            extra += f"  fp32 bound {opts['bound_fp32_ms']:.4f} ms"
        if "launches_per_step" in opts:
            row["launches_per_step"] = opts["launches_per_step"]
            copied = opts["copied_bytes"]
            row["copied_bytes"] = copied() if callable(copied) else copied
            if "bwd_plan" in opts:
                row["bwd_plan"] = opts["bwd_plan"]
                if row["copied_bytes"]:
                    fail(f"{kernel} [{label}]: the call allocated "
                         f"{row['copied_bytes']} bytes beyond its output")
            extra += (f"  {opts['launches_per_step']} a training step, "
                      f"copied {row['copied_bytes']} B")
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
# phase 3, fp16 and the generic datapath: the stress rows and the rows of
# the kernels line's new entries
# ---------------------------------------------------------------------------
def flash_stress_case(torch, randn, cases, h, kvh, dh):
    """fp16 flash on a causal 2048-key prompt whose rows' softmax spans
    more than 20 decades (q and k at 4x the serving scale, head dim ``dh``):
    P in fp16 terms must stay finite and within the fp16 rule of the plain
    version (the kernel's P = P_hi + P_lo flushes only terms under 2^-25)."""
    import math

    from repro_torch.kernels import attention as ka

    t, f16 = 2048, torch.float16
    q, k = (randn(1, t, n, dh, dtype=f16, scale=4.0) for n in (h, kvh))
    v = randn(1, t, kvh, dh, dtype=f16)
    s_last = (q[0, -1, 0].float() @ k[0, :, 0].float().T) / math.sqrt(dh)
    decades = (s_last.max() - s_last.min()).item() / math.log(10.0)
    if decades <= 20:
        fail(f"flash fp16 stress: the last row spans {decades:.1f} decades")
    pairs = t * (t + 1) // 2
    cases.append((
        "flash_attention[fp16]", f"fp16 stress Tq=Tk={t} H={h} KVH={kvh} "
        f"D={dh}: last row's softmax over {decades:.0f} decades", False,
        "fp16", lambda: ka.flash_attention(q, k, v, causal=True),
        lambda: ka.blockwise_attention(q, k, v, causal=True),
        lambda: torch.nn.functional.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            is_causal=True, enable_gqa=True),
        2 * (2 * t * h * dh + 2 * t * kvh * dh), 4.0 * dh * h * pairs,
        {"decades": decades}))


def ssd_stress_case(torch, gen, cases):
    """The fp16 SSD on one fresh 256-token chunk at mamba2-1.3b's widths
    whose state passes fp16's 65504 (x around 1500, B = 1, a slow decay):
    y within the fp16 rule of the plain version, the fp32 final state
    finite, past 65504 and within ``fp32_tolerance`` of the fp64
    recurrence, and no ``convert`` launched (the tensor-core kernel reads
    the fp16 operands as they are)."""
    from _ssd_exact import fp32_tolerance, ssd_fp64

    from repro_torch import configs
    from repro_torch.kernels import mamba2 as km

    cfg = configs.get("mamba2-1.3b")
    h, p, g, n = cfg.n_ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups, \
        cfg.d_state
    t, f16 = 256, torch.float16
    x = (1000 + 1000 * torch.rand((1, t, h, p), generator=gen,
                                  device="cuda")).to(f16)
    b = torch.ones((1, t, g, n), dtype=f16, device="cuda")
    c = (torch.randn((1, t, g, n), generator=gen, device="cuda") * 1e-3
         ).to(f16)
    dt = torch.nn.functional.softplus(
        torch.randn((1, t, h), generator=gen, device="cuda"))
    a_log = torch.log(torch.linspace(1e-3, 1e-2, h, device="cuda"))
    d_skip = torch.ones((h,), dtype=torch.float32, device="cuda")
    kw = dict(d_skip=d_skip, chunk=t, return_final_state=True)
    name = "ssd[fp16] [stress: state past 65504]"

    def check(got, want):
        from repro_torch.kernels import datapath as kd
        err = check_close(torch, name, got[0], want[0], "fp16")
        before = kd.convert.launches
        km.ssd(x, dt, a_log, b, c, **kw)
        if kd.convert.launches != before:
            fail(f"{name}: the fp16 call launched "
                 f"{kd.convert.launches - before} conversions")
        st = got[1]
        big = st.abs().max().item()
        _, exact = ssd_fp64(x, dt, a_log, b, c, d_skip=d_skip)
        tol = fp32_tolerance(dt, a_log, t)
        st_err = (st.double() - exact).abs().max().item()
        scale = exact.abs().max().item()
        if not torch.isfinite(st).all() or big <= 65504 or \
                st_err > tol * scale:
            fail(f"{name}: state max {big:.3e} (must pass 65504), err "
                 f"{st_err:.3e} against {tol * scale:.3e}")
        log(f"{name}: state max {big:.4e}, final state err {st_err:.3e} "
            f"(limit {tol * scale:.3e}, fp64 recurrence)")
        return err

    nbytes = 2 * 2 * t * h * p + 2 * 2 * t * g * n + 4 * t * h + 8 * h \
        + 4 * h * n * p
    cases.append(("ssd[fp16]", f"fp16 stress mamba2-1.3b B=1 T={t} H={h} "
                  f"P={p} G={g} N={n} fresh, state past 65504", False,
                  "fp16", lambda: km.ssd(x, dt, a_log, b, c, **kw),
                  lambda: km.ssd_plain(x, dt, a_log, b, c, **kw), None,
                  nbytes, ssd_flops(t, h, p, g, n, t, False),
                  dict(check=check, grid=ssd_grid(t, h, g, n, t))))


def bits_equal(torch, name):
    """A check that the kernel's output equals the plain version's bit for
    bit (floats compared as their bits, so NaN and -0.0 count too)."""
    ints = {2: torch.int16, 4: torch.int32}

    def check(got, want):
        same = got.dtype == want.dtype and got.shape == want.shape and (
            torch.equal(got, want) if not got.is_floating_point() else
            torch.equal(got.view(ints[got.element_size()]),
                        want.view(ints[want.element_size()])))
        if not same:
            fail(f"{name}: differs from the plain version")
        return 0.0
    return check


def convert_views(torch, buf, dtype):
    """The conversion's four paths on views into ``buf`` (a flat buffer of
    at least 2 * 1000 * 2048 values, 16-byte aligned): packed (a contiguous
    (1000, 2048)), its misaligned head (the same one value past the
    buffer's start), rows (mamba2-1.3b's SSD x as the model slices it from
    its fused projection: (1, 256, 64, 64) in rows of 8512, 4096 in) and
    general (the (1000, 8, 256) transpose of (1000, 256, 8) pairs). Each:
    (path, view)."""
    m, k = 1000, 2048
    return [("packed", buf[:m * k].view(m, k)),
            ("head", buf[1:1 + m * k].view(m, k)),
            ("rows", buf[:256 * 8512].view(1, 256, 8512)[
                :, :, 4096:8192].view(1, 256, 64, 64)),
            ("general", buf[:m * k].view(m, 256, 8).transpose(1, 2))]


def convert_sweep(torch, gen):
    """Every pair of distinct dtypes of the table on each of the four
    paths (``convert_views``), bit for bit against the plain version,
    each launch's path the one ``datapath.convert_plan`` names."""
    from repro_torch.kernels import datapath as kd
    from repro_torch.kernels import epilogue as epi

    dtypes = list(kd.ANY)
    n = 0
    for src in dtypes:
        if src.is_floating_point:
            buf = (torch.randn((2 * 1000 * 2048,), generator=gen,
                               device="cuda") * 20000).to(src)
        else:
            info = torch.iinfo(src)
            buf = torch.randint(info.min, info.max, (2 * 1000 * 2048,),
                                generator=gen, device="cuda", dtype=src)
        for path, view in convert_views(torch, buf, src):
            for dst in dtypes:
                if dst == src:
                    continue
                plan = kd.convert_plan(view, dst)
                want_path = {"packed": 0, "head": 0, "rows": 1,
                             "general": 2}[path]
                if plan["path"] != want_path or \
                        (path == "head") != (plan["shift"] > 0):
                    fail(f"convert {src} -> {dst} [{path}]: plan {plan}")
                got = kd.convert(view, dst)
                bits_equal(torch, f"convert {src} -> {dst} [{path}]")(
                    got, epi.convert(view, dst))
                n += 1
    log(f"convert: {n} (pair, path) cases bit for bit (30 pairs x 4 paths)")


def convert_cases(torch, gen, x16, cases):
    """The conversion's timed rows, one a path, int16 -> bf16 (the
    packed one, a (1000, 2048) operand, is the representative row) and the
    rows path on the fp16 SSD's x view -> fp32, each beside ``Tensor.to``
    on the same view and held bit for bit; then the sweep over every dtype
    pair and path (``convert_sweep``)."""
    from repro_torch.kernels import datapath as kd
    from repro_torch.kernels import epilogue as epi

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    buf = torch.empty((2 * 1000 * 2048,), dtype=torch.int16, device="cuda")
    buf[:x16.numel()].copy_(x16.view(-1))
    buf[x16.numel():].copy_(x16.view(-1))
    hbuf = (torch.randn((256 * 8512,), generator=gen, device="cuda") * 4
            ).to(f16)
    for path, view in convert_views(torch, buf, torch.int16):
        src, dst = (view, bf16) if path != "rows" else \
            (convert_views(torch, hbuf, f16)[2][1], f32)
        n = src.numel()
        name = f"convert [{src.dtype} -> {dst}, {path}]"
        note = " (SSD x view)" if path == "rows" else ""
        cases.append((
            "convert", f"{str(src.dtype)[6:]} {tuple(src.shape)} -> "
            f"{str(dst)[6:]} {path}{note}", path == "packed",
            {bf16: "bf16", f16: "fp16", f32: "fp32"}[dst],
            lambda src=src, dst=dst: kd.convert(src, dst),
            lambda src=src, dst=dst: epi.convert(src, dst),
            lambda src=src, dst=dst: src.to(dst),
            (src.element_size() + torch.empty((), dtype=dst).element_size())
            * n, 0.0,
            {"check": bits_equal(torch, name),
             "plan": str(kd.convert_plan(src, dst))}))
    convert_sweep(torch, gen)


def generic_cases(torch, gen, cases):
    """The generic datapath's kernels (``csrc/datapath.cu``) at the
    quickstart GEMM and ResNet-50's stage-1 3x3 conv: gemm[int32] (int32
    -> int32 -> int8, a bias, shift 10, ReLU), conv2d_implicit[int32]
    (int32 -> int32 -> int32), convert (an int16 (1000, 2048) operand to
    bf16, beside ``Tensor.to``, the one PyTorch call of the same function)
    and epilogue[any] (a (1000, 512) fp32 sum rounded to a bf16
    accumulator, a bf16 bias, shift 1, ReLU, bf16 out): each bit for bit."""
    from repro_torch.core.config import Activation
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels import datapath as kd
    from repro_torch.kernels import epilogue as epi
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import conv2d_ref, epilogue_any_ref, gemm_ref

    i32, bf16 = torch.int32, torch.bfloat16
    relu = Activation.RELU

    def ints(shape, lim, dtype=i32):
        return torch.randint(-lim, lim, shape, generator=gen, device="cuda",
                             dtype=dtype)

    m, n, k = 1000, 512, 2048
    a, b, bias = ints((m, k), 2 ** 20), ints((k, n), 2 ** 10), \
        ints((n,), 2 ** 24)
    kw = dict(acc_dtype=i32, out_dtype=torch.int8, shift=10, activation=relu)
    pl = kg.gemm_s32_plan(m, n, k)
    cases.append(("gemm[int32]", f"int32 -> int32 -> int8 M={m} N={n} K={k} "
                  f"bias shift=10 relu", True, "int32",
                  lambda: kg.gemm_os(a, b, bias, **kw),
                  lambda: gemm_ref(a, b, bias, **kw), None,
                  4 * (m * k + k * n + n) + m * n, 2.0 * m * n * k,
                  {"plan": f"{pl['tile']} tiles, {pl['splits']} K splits, "
                           f"{pl['grid']} blocks"}))
    x, w, cb = ints((1, 56, 56, 64), 2 ** 10), ints((3, 3, 64, 64), 2 ** 10), \
        ints((64,), 2 ** 20)
    ckw = dict(acc_dtype=i32, out_dtype=i32, stride=1, padding=1, shift=8,
               activation=relu)
    mm, kk = 56 * 56, 9 * 64
    cases.append(("conv2d_implicit[int32]", "int32 1x56x56x64 3x3/1 -> 64 "
                  "shift=8 relu", True, "int32",
                  lambda: kc.conv2d_implicit(x, w, cb, **ckw),
                  lambda: conv2d_ref(x, w, cb, **ckw), None,
                  4 * (x.numel() + w.numel() + 64 + mm * 64),
                  2.0 * mm * 64 * kk,
                  {"plan": conv_plan_text(kc, mm, 64, kk, i32)}))
    x16 = ints((m, k), 2 ** 15, torch.int16)
    convert_cases(torch, gen, x16, cases)
    s32 = torch.randn((m, n), generator=gen, device="cuda") * 8
    eb = torch.randn((n,), generator=gen, device="cuda").to(bf16)
    ekw = (bf16, bf16, eb, bf16, 1, relu)
    cases.append(("epilogue[any]", f"fp32 ({m}, {n}) -> bf16 acc + bf16 bias "
                  f"-> bf16 shift=1 relu", True, "bf16",
                  lambda: kd.epilogue_any(s32, *ekw),
                  lambda: epilogue_any_ref(s32, *ekw), None,
                  (4 + 2) * m * n + 2 * n, 0.0,
                  {"check": bits_equal(torch, "epilogue[any]")}))


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

    # Every step's logits, kept on the card for phase 11, which holds the
    # NaN guard's re-runs against this clean run's same steps.
    clean_logits = []
    primary = engine._dispatch

    def keep_logits(which, args):
        logits, state = primary(which, args)
        clean_logits.append(logits)
        return logits, state

    engine._dispatch = keep_logits
    kernels.reset_launch_counts()
    report = engine.run()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    del engine._dispatch

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
    assert_clean("serve", s)
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
    clean = {"tokens": [np.asarray(r["tokens"]).tolist()
                        for r in report["requests"]],
             "logits": clean_logits, "wall_s": s["wall_s"]}
    return counts, s, run_profile_phase(torch, engine), engine, clean


# ---------------------------------------------------------------------------
# phase 4b: where a full-width decode step and prefill chunk spend time
# ---------------------------------------------------------------------------
_KERNEL_NAMES = (("ssd_kernel", "ssd"), ("ssd_tc_kernel", "ssd"),
                 ("PagedDecodeKV", "paged_decode_attention"),
                 ("decode_split_kernel", "decode_attention"),
                 ("PagedKV", "paged_prefill_attention"),
                 ("flash_tc_kernel", "flash_attention"),
                 ("ConvTapsA", "conv2d_implicit"),
                 ("ConvRowsA", "conv2d_implicit"),
                 ("ConvRowsQ", "conv2d_implicit"),
                 ("ConvStripA", "conv2d_implicit"),
                 ("epilogue_kernel", "accumulator_epilogue"),
                 ("epilogue_any_kernel", "accumulator_epilogue"),
                 ("convert_kernel", "convert"),
                 ("hgemm::skinny_kernel", "gemm"),
                 ("hgemm::wide_kernel", "gemm"), ("sgemm_kernel", "gemm"),
                 ("hgemm_bwd::bwd_kernel", "gemm"),
                 ("igemm::kernel<short", "gemm"),
                 ("MatrixA", "gemm[int8]"),
                 ("flash_f32_kernel", "flash_attention"),
                 ("flash_wg_kernel", "flash_attention"))

# Each launch counter of ``repro_torch.kernels.launch_counts`` by the
# kernel class its launches show up as; "gemm_ws" counts a GEMM in WS
# order of either GEMM class (``window_short`` splits it).
_COUNTER_CLASS = {"gemm": "gemm", "gemm[fp32]": "gemm", "gemm[fp16]": "gemm",
                  "gemm[bwd]": "gemm",
                  "gemm[int16]": "gemm",
                  "gemm[int8]": "gemm[int8]",
                  "accumulator_epilogue": "accumulator_epilogue",
                  "conv2d_implicit": "conv2d_implicit",
                  **{f"conv2d_implicit[{d}]": "conv2d_implicit"
                     for d in ("fp32", "bf16", "fp16", "int16", "int32")},
                  "gemm[int32]": "gemm", "convert": "convert",
                  "epilogue[any]": "accumulator_epilogue",
                  **{f"{k}[{v}]": k for k in (
                      "ssd", "flash_attention", "paged_prefill_attention",
                      "paged_decode_attention", "decode_attention")
                     for v in ("fp16", "mixed")},
                  "ssd": "ssd", "flash_attention": "flash_attention",
                  "paged_prefill_attention": "paged_prefill_attention",
                  "paged_decode_attention": "paged_decode_attention",
                  "decode_attention": "decode_attention",
                  # one kernel for both (the launch's table says which)
                  "flash_attention[any]": "flash_attention",
                  "paged_prefill_attention[any]": "flash_attention"}
PROFILE_RETAKES = 4     # windows taken again before a short one is fatal
# Idle time at each edge of a profiler window, in seconds. The profiler
# keeps a device activity only where its converted timestamps fall inside
# the window's host-clock span; a pass that starts right after the window
# opens (or ends right before it closes) lost its edge kernels when the two
# clocks disagreed by more than the gap. ``tools/profile_windows.py``
# counts the short windows with and without it.
PROFILE_PAD_S = 0.02
# Marker kernels (``torch.cuda._sleep``, ATen's ``spin_kernel``) around
# every profiled pass, left out of every count and time: a window whose
# passes launch one kernel each (the fused stream's stem and classifier)
# lost one of its n launches in every retake on some hosts late in the
# script, and never where its kernel had neighbours in the trace.
PROFILE_MARK_CYCLES = 1000


def _kernel_class(name: str) -> str:
    for key, cls in _KERNEL_NAMES:
        if key in name:
            return cls
    return "other"


def window_short(recorded, by_key, counted, n):
    """Why a profiler window over ``n`` passes is short, or None where it
    is whole. ``recorded``: the window's launches per kernel class;
    ``by_key``: its launches per kernel name; ``counted``: the launch
    counters' growth over the same ``n`` passes (``launch_counts`` names).
    Whole means: every counted class recorded exactly its counters' launches
    (a WS GEMM's in either GEMM class), and every kernel name a whole
    number of passes' worth (the passes launch the same kernels)."""
    if not by_key:
        return "no CUDA kernel recorded"
    want = {}
    for name, c in counted.items():
        if name != "gemm_ws" and c:
            cls = _COUNTER_CLASS[name]
            want[cls] = want.get(cls, 0) + c
    gemms = ("gemm", "gemm[int8]")
    extra = [recorded.get(cls, 0) - want.get(cls, 0) for cls in gemms]
    ws = counted.get("gemm_ws", 0)
    if min(extra) < 0 or sum(extra) != ws:
        return (f"GEMM launches recorded {[recorded.get(c, 0) for c in gemms]}"
                f", counted {[want.get(c, 0) for c in gemms]} + {ws} in WS "
                f"order")
    for cls in set(_COUNTER_CLASS.values()) - set(gemms):
        if recorded.get(cls, 0) != want.get(cls, 0):
            return (f"{cls}: {recorded.get(cls, 0)} launches recorded, "
                    f"{want.get(cls, 0)} counted")
    odd = [key for key, c in by_key.items() if c % n]
    if odd:
        return f"{len(odd)} kernels recorded a part of a pass, e.g. {odd[0]}"
    return None


def profile_call(torch, name, fn, n=3, quiet=False, op_keys=()):
    """Wall time of one synchronised ``fn()`` (median of 5) against the
    device time of every kernel ``torch.profiler`` saw in it (mean of n),
    by kernel class; "gemm[int8]" covers the int8 GEMM in either order,
    "gemm" every other GEMM (bf16, fp16, fp32, int16), "conv2d_implicit"
    the conv on every datapath. A window whose launches fall short of the
    launch counters' growth over its passes (``window_short``) is taken
    again, at most ``PROFILE_RETAKES`` times, and then fails: no device
    time is reported from a short window. ``windows`` in the result says
    how many were taken.
    ``quiet``: no log line (the caller logs a summary). ``op_keys``:
    PyTorch operators (e.g. ``aten::bmm``) whose kernels' device time, per
    pass, goes to ``device_ms_by_op`` beside the kernel classes (those
    kernels also count in their class, "other" for a library's)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import kernels

    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    # One warm-up pass inside the profiler, its events dropped: without it
    # the window's first kernel went unrecorded on the H100 (one launch
    # short per window: a one-layer stage read about 2/3 of its time).
    # Windows still lose launches now and then (PR 19, PR 20): each is held
    # to the launch counters.
    for window in range(1, PROFILE_RETAKES + 2):
        # Each retake idles twice as long at the edges as the window before
        # it: on a host whose two clocks disagree by more than the gap, one
        # function's windows all came up short at PROFILE_PAD_S.
        pad = PROFILE_PAD_S * 2 ** (window - 1)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=n,
                                       repeat=1)) as prof:
            for i in range(n + 1):
                if i == 1:
                    before = kernels.launch_counts()
                    time.sleep(pad)
                if i:
                    torch.cuda._sleep(PROFILE_MARK_CYCLES)
                fn()
                if i:
                    torch.cuda._sleep(PROFILE_MARK_CYCLES)
                torch.cuda.synchronize()
                if i == n:
                    time.sleep(pad)
                prof.step()
        after = kernels.launch_counts()
        by_class, launches, by_key, other = {}, {}, {}, {}
        by_op = dict.fromkeys(op_keys, 0.0)
        for a in prof.key_averages():
            if a.key in by_op:
                by_op[a.key] += a.device_time_total / 1e3 / n
            # Device activity only: an operator's entry repeats the time
            # of the kernels it launched, a step's mark spans the step, and
            # the markers are not the function's.
            if not str(a.device_type).endswith("CUDA") or \
                    a.key.startswith("ProfilerStep") or \
                    "spin_kernel" in a.key:
                continue
            cls = _kernel_class(a.key)
            by_class[cls] = (by_class.get(cls, 0.0) +
                             a.self_device_time_total / 1e3 / n)
            if cls == "other":
                other[a.key] = (other.get(a.key, (0.0, 0))[0] +
                                a.self_device_time_total / 1e3 / n,
                                other.get(a.key, (0.0, 0))[1] + a.count)
            launches[cls] = launches.get(cls, 0) + a.count
            by_key[a.key] = by_key.get(a.key, 0) + a.count
        why = window_short(launches, by_key,
                           {k: after[k] - before[k] for k in after}, n)
        if why is None:
            break
        seen = ", ".join(f"{k[:60]} x{c}" for k, c in sorted(
            by_key.items(), key=lambda kv: -kv[1])[:4])
        log(f"profile {name}: window {window} short ({why}; recorded "
            f"{seen}); taken again")
    else:
        fail(f"profile {name}: {PROFILE_RETAKES + 1} windows, every one "
             f"short ({why})")
    launches = {cls: c // n for cls, c in launches.items()}
    wall = statistics.median(walls)
    device = sum(by_class.values())
    out = {"wall_ms": wall, "device_ms": device,
           "device_busy_share": device / wall,
           "device_ms_by_kernel": by_class, "launches_by_kernel": launches,
           "windows": window}
    out["top_other"] = [[k, ms, c // n] for k, (ms, c) in sorted(
        other.items(), key=lambda kv: -kv[1][0])[:8]]
    if op_keys:
        out["device_ms_by_op"] = by_op
    if quiet:
        return out
    parts = ", ".join(f"{k} {v:.3f} ms x{launches[k]}" for k, v in
                      sorted(by_class.items(), key=lambda kv: -kv[1]))
    parts += "".join(f"; of which {k} {v:.3f} ms" for k, v in by_op.items())
    log(f"profile {name}: wall {wall:.3f} ms, device busy "
        f"{device:.3f} ms ({device / wall:.1%}); {parts}"
        + (f" ({window} windows)" if window > 1 else ""))
    return out


def run_profile_phase(torch, engine):
    """``profile_call`` for one decode step of four slots at
    1000/512/300/64 cached tokens and for one 256-token continuation
    chunk at position 768 (the serve phase's shapes)."""
    return {name: profile_call(torch, name, fn)
            for name, fn in profile_steps(torch, engine).items()}


def profile_steps(torch, engine, seed=None):
    """Phase 4b's two steps as calls: one decode step of four slots at
    1000/512/300/64 cached tokens and one 256-token continuation chunk at
    position 768, each returning (logits, state). The tokens are zeros, or
    drawn from ``seed``."""
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
    gen = None if seed is None else \
        torch.Generator(device="cuda").manual_seed(seed)

    def tokens(*shape):
        if gen is None:
            return torch.zeros(shape, dtype=torch.int32, device="cuda")
        return torch.randint(0, cfg.vocab, shape, generator=gen,
                             device="cuda", dtype=torch.int32)
    toks, chunk = tokens(4, 1), tokens(1, 256)
    return {
        "decode_step": lambda: tf.paged_decode_step(
            ctx, params, cfg, toks, decode_state, active, page_size=page),
        "prefill_chunk": lambda: tf.paged_prefill_chunk(
            ctx, params, cfg, chunk, state, 0, state.tables[0], 768,
            page_size=page, kv_pages=16),
    }


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

    # gemma3 with six layers, every third global, so both window kinds run;
    # the MoE archs route every token on the card's fp32 router GEMM;
    # llava-next-34b serves text only (its image stub feeds the training
    # forward alone)
    for arch, kw in (("gemma3-1b", dict(n_layers=6, global_period=3)),
                     ("gemma3-4b", dict(n_layers=6, global_period=3)),
                     ("qwen1.5-4b", {}), ("llava-next-34b", {}),
                     ("granite-moe-3b-a800m", {}),
                     ("llama4-scout-17b-a16e", {})):
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  dtype=torch.float32, **kw)
        fp32_card_equals_cpu(torch, np, arch, cfg)


def fp32_card_equals_cpu(torch, np, arch, cfg):
    """Serve four prompts (37, 16, 70 and 5 tokens, 12 new each) with
    ``cfg`` at weights from seed 1 in fp32 on the card and on the CPU
    (chunks of 16, page 8): the greedy tokens must be equal."""
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.config import GemminiConfig
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

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

    f32 = GemminiConfig(input_dtype="fp32", acc_dtype="fp32",
                        output_dtype="fp32")
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
        assert_clean(f"{arch} fp32 on {device}", rep["summary"])
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


def resnet50_layers(torch, seed=0, dtype=None):
    """``dse.resnet(50)``'s 50 GEMM-shaped layers at batch 1 as convs with
    data from a seed: the 7x7/2 stem on a 224x224x3 image, each 1x1 and
    3x3 (pad 1) at its stage's width and resolution, and the classifier as
    a 1x1 conv over a 1x1x2048 image (host route: the (1, 2048) x (2048,
    1000) GEMM). int8 (``dtype`` None): x in [-64, 64), w in [-32, 32),
    an int32 bias in [-500, 500); another dtype draws each layer by
    ``datapath_operands``. Returns (label, x, w, bias, stride, pad, act)."""
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
        if dtype is not None:
            x, w, b, _ = datapath_operands(torch, gen, dtype, (1, h, h, ci),
                                           (kh, kh, ci, g.n), g.n)
        else:
            x = torch.randint(-64, 64, (1, h, h, ci), generator=gen,
                              device="cuda", dtype=torch.int8)
            w = torch.randint(-32, 32, (kh, kh, ci, g.n), generator=gen,
                              device="cuda", dtype=torch.int8)
            b = torch.randint(-500, 500, (g.n,), generator=gen,
                              device="cuda", dtype=torch.int32)
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

    outs = {}
    for route in ENGINE_ROUTES:
        outs[route] = run_stream(inst, layers, 8, route)
        torch.cuda.synchronize()
        for (label, *_), got, want in zip(layers, outs[route], refs):
            if got.dtype != torch.int8 or not torch.equal(got, want):
                fail(f"resnet50 [{route}] layer {label}: differs from "
                     f"conv2d_ref")
    for got_os, got_ws in zip(*(outs[r] for r in ENGINE_ROUTES[:2])):
        if not torch.equal(got_os, got_ws):
            fail("resnet50: OS and WS outputs differ")
    counts = kernels.launch_counts()
    int8_kernels = [n for n in kernels.ENGINE_KERNELS
                    if n not in DATAPATH_KERNELS]
    for name in int8_kernels:
        if counts[name] <= 0:
            fail(f"kernel {name} was not launched on the engine path")
    log(f"engine launch counts: { {n: counts[n] for n in int8_kernels} }")
    summary = {"layers": len(layers),
               "routes": time_routes(torch, "int8", inst, layers, 8, smi)}
    log("engine: quickstart bit-exact on OS / WS / host conv / fused conv; "
        "header equals plan_gemm; mvout route bit-exact; resnet50 stream "
        "bit-exact on all three routes, OS == WS")
    return counts, summary


# ---------------------------------------------------------------------------
# phases 6 and 6b: a stream's routes and their times
# ---------------------------------------------------------------------------
ENGINE_ROUTES = ("host im2col + OS GEMM", "host im2col + WS GEMM",
                 "fused conv kernel")


def run_stream(inst, layers, shift, route):
    """One pass of ``layers`` through the instance's ``conv2d`` on one of
    ``ENGINE_ROUTES``: im2col in plain torch then the GEMM on OS or on WS,
    or the fused implicit-im2col conv."""
    from repro_torch.core.config import Dataflow

    kw = {"host im2col + OS GEMM": dict(fused=False, dataflow=Dataflow.OS),
          "host im2col + WS GEMM": dict(fused=False, dataflow=Dataflow.WS),
          "fused conv kernel": dict(fused=True)}[route]
    return [inst.conv2d(x, w, b, stride=st, padding=p, shift=shift,
                        activation=act, **kw)
            for _, x, w, b, st, p, act in layers]


def stage_of(layer) -> str:
    return {224: "stem", 56: "stage 1", 28: "stage 2", 14: "stage 3",
            7: "stage 4", 1: "classifier"}[layer[1].shape[1]]


def time_routes(torch, name, inst, layers, shift, smi):
    """Each route's wall (median of ``ENGINE_REPS`` synchronised passes,
    the routes in turn) and device time from ``profile_call``, whole and
    per stage (by input resolution); one log line per route."""
    walls = {route: [] for route in ENGINE_ROUTES}
    for rep in range(ENGINE_REPS):
        for route in ENGINE_ROUTES[::1 if rep % 2 == 0 else -1]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_stream(inst, layers, shift, route)
            torch.cuda.synchronize()
            walls[route].append((time.perf_counter() - t0) * 1e3)
    ops = sum(2.0 * x.shape[-1] * w.shape[0] * w.shape[1] * w.shape[3] *
              ((x.shape[1] + 2 * p - w.shape[0]) // st + 1) ** 2
              for _, x, w, _, st, p, _ in layers)
    stages = {}
    for layer in layers:
        stages.setdefault(stage_of(layer), []).append(layer)
    out = {}
    for route in ENGINE_ROUTES:
        prof = profile_call(torch, f"resnet50 {name} [{route}]",
                            lambda: run_stream(inst, layers, shift, route),
                            quiet=True)
        per = {}
        for stage, part in stages.items():
            sp = profile_call(torch, f"resnet50 {name} [{route}] {stage}",
                              lambda: run_stream(inst, part, shift, route),
                              quiet=True)
            per[stage] = {k: sp[k] for k in ("device_ms",
                                             "device_ms_by_kernel",
                                             "launches_by_kernel")}
            per[stage]["layers"] = len(part)
        wall = statistics.median(walls[route])
        out[route] = {"wall_ms": wall, "walls_ms": walls[route],
                      "ops": ops, "profile": prof, "stages": per}
        kernels = ", ".join(f"{k} {v:.4f} x{prof['launches_by_kernel'][k]}"
                            for k, v in prof["device_ms_by_kernel"].items())
        log(f"resnet50 {name}, {len(layers)} layers, batch 1, [{route}]: "
            f"wall {wall:.3f} ms (median of {ENGINE_REPS}; "
            f"{ops / wall / 1e9:.2f} T ops/s), device {prof['device_ms']:.4f}"
            f" ms ({kernels}); per stage " + ", ".join(
                f"{st} {v['device_ms']:.4f}" for st, v in per.items()) +
            f"; on {smi}")
    return out


# ---------------------------------------------------------------------------
# phase 6b: the float and 16-bit datapaths on ResNet-50's stream
# ---------------------------------------------------------------------------
def library_stream(torch, name, layers):
    """The yardstick of a float stream's fused route: cuDNN's ``conv2d``
    (``torch.nn.functional.conv2d``; TF32 off, as ``main`` sets it) on the
    stream's convs, the classifier left out, each on channels-last views
    of the same NHWC image and filter and the bias in the image's dtype,
    one pass of them profiled as ``profile_call`` profiles the stream.
    Returns (convs, profile)."""
    args = []
    for _, x, w, b, st, p, _ in layers:
        if x.shape[1] == 1:              # the classifier: a GEMM
            continue
        args.append((x.permute(0, 3, 1, 2),
                     w.permute(3, 2, 0, 1).contiguous(
                         memory_format=torch.channels_last),
                     b.to(x.dtype), st, p))

    def run():
        return [torch.nn.functional.conv2d(xl, wl, bl, stride=st, padding=p)
                for xl, wl, bl, st, p in args]

    return len(args), profile_call(torch, f"resnet50 {name} [cuDNN conv2d]",
                                   run, quiet=True)


def datapath_instances():
    """Phase 6b's four instances, each elaborated with both dataflows:
    Table 1's design point 4 (fp32 -> fp32 -> fp32), bf16 -> fp32 -> bf16
    (the serving engine's datapath), fp16 -> fp32 -> fp16 and int16 ->
    int32 -> int16. Returns [(name, config)]."""
    from repro_torch.core.config import (DESIGN_POINTS, Dataflow,
                                         GemminiConfig)

    both = Dataflow.BOTH
    return [("fp32", DESIGN_POINTS[4].replace(dataflow=both))] + [
        (i, GemminiConfig(dataflow=both, input_dtype=i, acc_dtype=a,
                          output_dtype=i))
        for i, a in (("bf16", "fp32"), ("fp16", "fp32"), ("int16", "int32"))]


def run_datapath_phase(torch, smi):
    """ResNet-50's 50-layer stream (``resnet50_layers`` at the instance's
    input type, seed 1) on each of ``datapath_instances`` through all three
    routes: host im2col + OS GEMM, host im2col + WS GEMM, the fused conv.
    Every output is held against ``conv2d_ref`` at the instance's dtypes
    (``check_close``: int16 bit-exact, fp32 / bf16 / fp16 by their rules)
    and OS must equal WS bit for bit. Launch counts are zeroed just before
    the four checked streams and read just after; every kernel of
    ``DATAPATH_KERNELS`` must have run. Then each route's wall (median of
    3 synchronised passes, routes in turn) and device time (profiler),
    whole and per stage. Returns (counts, summary)."""
    from repro_torch import kernels
    from repro_torch.core.generator import elaborate
    from repro_torch.kernels.ref import conv2d_ref

    runs = []
    for name, cfg in datapath_instances():
        shift = 1 if cfg.input_torch.is_floating_point else 10
        layers = resnet50_layers(torch, seed=1, dtype=cfg.input_torch)
        refs = [conv2d_ref(x, w, b, stride=st, padding=p,
                           acc_dtype=cfg.acc_torch,
                           out_dtype=cfg.output_torch, shift=shift,
                           activation=act)
                for _, x, w, b, st, p, act in layers]
        runs.append((name, elaborate(cfg), shift, layers, refs))
    torch.cuda.synchronize()

    kernels.reset_launch_counts()
    summary = {}
    for name, inst, shift, layers, refs in runs:
        kind = DATAPATH_KIND[name]
        outs = {}
        for route in ENGINE_ROUTES:
            outs[route] = run_stream(inst, layers, shift, route)
            torch.cuda.synchronize()
            for (label, *_), got, want in zip(layers, outs[route], refs):
                check_close(torch, f"resnet50 {name} [{route}] layer "
                            f"{label}", got, want, kind)
        for got_os, got_ws in zip(*(outs[r] for r in ENGINE_ROUTES[:2])):
            if not torch.equal(got_os, got_ws):
                fail(f"resnet50 {name}: OS and WS outputs differ")
        fused = outs["fused conv kernel"]
        info = {"layers": len(layers), "outputs": sum(y.numel()
                                                      for y in fused)}
        if name == "int16":
            info["saturated"] = sum(int(((y == 32767) | (y == -32768)).sum())
                                    for y in fused)
        else:
            info["inf"] = sum(int(torch.isinf(y).sum()) for y in fused)
        summary[name] = {"instance": inst.cfg.describe(), **info}
        log(f"resnet50 {name} ({inst.cfg.describe()}): all three routes "
            f"within the {kind} rule of conv2d_ref, OS == WS; {info}")
        del outs, fused
    counts = kernels.launch_counts()
    for kname in DATAPATH_KERNELS:
        if counts[kname] <= 0:
            fail(f"kernel {kname} was not launched on phase 6b's path")
    log(f"phase 6b launch counts: "
        f"{ {n: counts[n] for n in DATAPATH_KERNELS + ('gemm', 'gemm[fp32]',
                                                     'gemm_ws')} }")

    from repro_torch.kernels import conv as kc

    for name, inst, shift, layers, _ in runs:
        summary[name]["routes"] = time_routes(torch, name, inst, layers,
                                              shift, smi)
        plans = {}
        for _, x, w, _, st, p, _ in layers:
            kh, ci, co = w.shape[0], w.shape[2], w.shape[3]
            oh = (x.shape[1] + 2 * p - kh) // st + 1
            plans.setdefault(
                f"{x.shape[1]}x{x.shape[2]}x{ci} {kh}x{kh}/{st} -> {co}",
                conv_plan_text(kc, oh * oh, co, kh * kh * ci, x.dtype))
        summary[name]["conv_plans"] = plans
        log(f"resnet50 {name} conv plans: " + "; ".join(
            f"{k}: {v}" for k, v in plans.items()))
        if not inst.cfg.input_torch.is_floating_point:
            continue
        convs, prof = library_stream(torch, name, layers)
        fused = summary[name]["routes"]["fused conv kernel"]
        convs_ms = (fused["profile"]["device_ms"] -
                    fused["stages"]["classifier"]["device_ms"])
        summary[name]["library"] = {"convs": convs, "device_ms":
                                    prof["device_ms"], "profile": prof,
                                    "fused_convs_ms": convs_ms}
        log(f"resnet50 {name}: cuDNN conv2d over the stream's {convs} "
            f"convs {prof['device_ms']:.4f} ms of device time; the fused "
            f"route's conv2d_implicit {convs_ms:.4f} ms on the same convs "
            f"({fused['profile']['device_ms']:.4f} ms with the classifier)"
            f"; on {smi}")
    return counts, summary


# ---------------------------------------------------------------------------
# phases 7-8: the recurrent and hybrid families served at full width
# ---------------------------------------------------------------------------
ATTN_KERNELS = ("flash_attention", "paged_prefill_attention",
                "paged_decode_attention", "decode_attention")


def serve_family(torch, np, arch, prompt_lens, new_tokens, chunk=256,
                 fp16=False, layers=None):
    """``arch`` at its published widths (bf16, weights from seed 0; with
    ``fp16`` the fp16 model dtype on the fp16 engine config; ``layers``:
    its depth cut to that many) through ``ServingEngine``: the requests
    are submitted at once, launch counts zeroed just before ``run`` and
    read just after. Returns (engine, prompts, counts, ssd launches on
    resumed chunks, summary)."""
    from repro_torch import configs, kernels
    from repro_torch.core.config import GemminiConfig
    from repro_torch.kernels import mamba2
    from repro_torch.serving import ServingEngine

    cfg = configs.get(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    extra = {}
    if fp16:
        cfg = dataclasses.replace(cfg, dtype=torch.float16)
        extra["engine_cfg"] = GemminiConfig(**F16_ENGINE)
    t0 = time.perf_counter()
    engine = ServingEngine(cfg, max_slots=4, max_context=2048, page_size=64,
                           prefill_chunk=chunk, seed=0, device="cuda",
                           **extra)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in _leaves(engine.params))
    log(f"{arch} full width{' fp16' if fp16 else ''}: "
        f"{n_params / 1e9:.3f} B parameters, "
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
    assert_clean(f"{arch} serve", s)
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


def perturb_fp32(torch, params, seed, to="cpu"):
    """Every fp32 leaf times (1 + u 2^-24), u uniform in [-1, 1) drawn
    where the leaf lies from ``seed``, moved to ``to``: w + w u 2^-24 in
    fp32, the small product exact to its own last bit, so each weight
    rounds to the nearest fp32 of w (1 + u 2^-24) and moves by at most
    half an ulp (about a quarter of them by one ulp)."""
    gens = {}

    def one(t):
        if t.dtype != torch.float32:
            return t.to(to)
        gen = gens.get(t.device)
        if gen is None:
            gen = gens[t.device] = torch.Generator(
                device=t.device).manual_seed(seed)
        u = torch.rand(t.shape, generator=gen, device=t.device)
        return (t + t * ((2 * u - 1) * 2.0 ** -24)).to(to)
    return _tree_map(one, params)


def prefill_logits(torch, engine, prompt, fp32=False, cpu_only=False):
    """The prompt's fresh prefill logits on the card (kernels) and on the
    CPU (plain path), same weights; ``fp32`` runs both in the fp32 model
    dtype and engine config, and adds the CPU's logits from the weights
    ``perturb_fp32`` moved ("cpu_perturbed"); ``cpu_only``: the CPU's
    logits alone."""
    from repro_torch.models import transformer as tf

    cfg, ctx, params = as_fp32(torch, engine) if fp32 else \
        (engine.model_cfg, engine.engine, engine.params)
    mp = engine.max_pages_per_seq
    pages = torch.arange(mp, dtype=torch.int32)
    toks = torch.from_numpy(prompt[None])
    outs = {}
    cpu = _tree_map(lambda t: t.cpu(), params)
    runs = [("cpu", "cpu", cpu)] if cpu_only else \
        [("cuda", "cuda", params), ("cpu", "cpu", cpu)]
    if fp32 and not cpu_only:
        # drawn on the card, leaf by leaf, then moved
        runs.append(("cpu_perturbed", "cpu",
                     perturb_fp32(torch, params, FP32_PERTURB_SEED)))
    for name, dev, p in runs:
        state = tf.init_paged_state(cfg, 1, mp, engine.page_size, mp,
                                    dtype=cfg.dtype, device=dev)
        outs[name], _ = tf.paged_prefill(ctx, p, cfg, toks.to(dev), state,
                                         0, pages.to(dev),
                                         page_size=engine.page_size)
    outs = {k: v.float().cpu() for k, v in outs.items()}
    if cpu_only:
        return outs["cpu"]
    if fp32:
        return outs["cuda"], outs["cpu"], outs["cpu_perturbed"]
    return outs["cuda"], outs["cpu"]


def rel_l2(got, want) -> float:
    """Relative L2 gap, in fp64 on the host (0 where both are zero)."""
    g, w = got.double().cpu(), want.double().cpu()
    return ((g - w).norm() / w.norm().clamp_min(1e-300)).item()


def hold_bf16(name, card, cpu, exact, dtype="bf16"):
    """bf16 (or ``dtype``: fp16, the same factor) logits on the card
    (kernels) against those on the CPU
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
    log(f"{name}: {dtype} relative L2 from the fp32 CPU logits: card "
        f"{g_card:.3e}, CPU {g_cpu:.3e} (ratio {g_card / g_cpu:.3f}, limit "
        f"{BF16_FACTOR}); card vs CPU in {dtype} {rel_l2(card, cpu):.3e}")
    if not g_card <= BF16_FACTOR * g_cpu:
        fail(f"{name}: the card's {dtype} logits are {g_card:.3e} from fp32, "
             f"over {BF16_FACTOR} x the CPU's {g_cpu:.3e}")
    return {f"{dtype}_card_vs_fp32": g_card, f"{dtype}_cpu_vs_fp32": g_cpu,
            f"{dtype}_card_vs_cpu": rel_l2(card, cpu)}


def hold_fp32(name, card, cpu, cpu_perturbed):
    """fp32 logits on the card (kernels) against the CPU's (plain path),
    same weights and tokens: the card's relative L2 gap may be at most
    FP32_FACTOR times the CPU's own gap when ``perturb_fp32`` moves every
    weight by up to half an ulp. The card sums in other orders, a rounding
    per operation like the perturbation's one per weight, and the stack
    amplifies both alike (mamba2-1.3b's 48 layers read about 40 times
    hymba-1.5b's gap on either side), so one factor holds every arch where
    a fixed limit could not; a kernel fault adds its own error on top."""
    g_card, g_own = rel_l2(card, cpu), rel_l2(cpu_perturbed, cpu)
    log(f"{name}: fp32 logits, card vs CPU relative L2 {g_card:.3e}; the "
        f"CPU's own under a half-ulp weight perturbation {g_own:.3e} "
        f"(ratio {g_card / max(g_own, 1e-300):.3f}, limit {FP32_FACTOR})")
    if not g_card <= FP32_FACTOR * g_own:
        fail(f"{name}: the card's fp32 logits are {g_card:.3e} from the "
             f"CPU's, over {FP32_FACTOR} x the CPU's own {g_own:.3e}")
    return {"fp32": g_card, "fp32_cpu_perturbed": g_own,
            "fp32_factor": FP32_FACTOR}


def check_prefill_logits(torch, engine, prompt, name):
    """The prompt's fresh prefill logits on the card (kernels) against the
    plain path on the CPU, same weights: in the fp32 model dtype and engine
    config by :func:`hold_fp32`, and in bf16 by :func:`hold_bf16`."""
    cfg = engine.model_cfg
    out = {}
    for fp32 in (True, False):
        res = prefill_logits(torch, engine, prompt, fp32=fp32)
        got = res[0]
        if got.shape != (1, len(prompt) + cfg.n_meta_tokens, cfg.vocab) or \
                not torch.isfinite(got).all():
            fail(f"{name} logits: shape {tuple(got.shape)} or non-finite")
        out["fp32" if fp32 else "bf16"] = res
    rel = hold_fp32(name, *out["fp32"])
    rel.update(hold_bf16(name, *out["bf16"], out["fp32"][1]))
    return rel


def profile_family(torch, engine, op_keys=()):
    """``profile_call`` for one decode step of four slots at
    1000/512/300/64 cached tokens and one 256-token continuation chunk at
    position 768, with the recurrent state carried (phase 4b's steps)."""
    return {name: profile_call(torch, f"{engine.model_cfg.name} {name}", fn,
                               op_keys=op_keys)
            for name, fn in profile_steps(torch, engine).items()}


def guard_cost(torch, engine, reps=8):
    """One decode step of every slot, all active, at the engine's widths
    through its envelope (``_run_guarded``) with the NaN guard off and on,
    alternating call by call; the median and best wall of each,
    synchronised after the step. The guarded step also copies the active
    slots' conv / SSM rows before it (timed alone by CUDA events, its
    ``nonzero`` read of the active mask included) and reads the logits'
    finiteness after it."""
    from repro_torch.models import transformer as tf

    cfg, n = engine.model_cfg, engine.max_slots
    mp, page = engine.max_pages_per_seq, engine.page_size
    state = tf.init_paged_state(cfg, n, n * mp, page, mp, dtype=cfg.dtype,
                                device="cuda")
    args = (engine.params, torch.zeros((n, 1), dtype=torch.int32,
                                       device="cuda"),
            state, torch.ones((n,), dtype=torch.bool, device="cuda"))
    walls = {False: [], True: []}
    try:
        for rep in range(reps + 1):
            for guard in (False, True):
                engine.nan_guard = guard
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                engine._run_guarded("decode", "decode", args)
                torch.cuda.synchronize()
                if rep:                               # the first is warm-up
                    walls[guard].append((time.perf_counter() - t0) * 1e3)
    finally:
        engine.nan_guard = False
    copy_ms = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        engine._recurrent_snapshot("decode", args)
        end.record()
        end.synchronize()
        copy_ms.append(start.elapsed_time(end))
    copied = n * (state.conv[:, 0].nbytes + state.ssm[:, 0].nbytes)
    off, on = statistics.median(walls[False]), statistics.median(walls[True])
    copy = statistics.median(copy_ms)
    log(f"{cfg.name} guarded decode step ({n} active slots, "
        f"{copied / 2**20:.1f} MiB of recurrent rows copied in {copy:.4f} "
        f"ms): median {on:.3f} ms (best {min(walls[True]):.3f}) against "
        f"{off:.3f} ms (best {min(walls[False]):.3f}) unguarded "
        f"({on / off:.3f}x), {reps} calls each, alternating")
    return {"unguarded_ms": off, "guarded_ms": on, "copy_ms": copy,
            "copied_bytes": copied, "walls_ms": {
                "unguarded": walls[False], "guarded": walls[True]}}


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
    rel = check_prefill_logits(torch, engine, prompt, "mamba2-1.3b")
    profile = profile_family(torch, engine)
    guard = guard_cost(torch, engine)
    return counts, resumed, {"summary": s, "logits_rel_l2": rel,
                             "profile": profile, "guard": guard}


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
                               "hymba-1.5b")
    profile = profile_family(torch, engine)
    guard = guard_cost(torch, engine)
    return counts, resumed, {"summary": s, "logits_rel_l2": rel,
                             "profile": profile, "guard": guard}


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
        assert_clean(f"gate {arch} on the card", got["summary"])
        assert_clean(f"gate {arch} on the CPU", cpu["summary"])
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
# phase 11: the robustness envelope and the op profiler at full width
# ---------------------------------------------------------------------------
# Part a's plan: one NaN-poisoned decode step and one Inf-poisoned prefill
# step (each re-run from its pre-call state), two transient decode
# failures and one transient prefill failure (each retried).
FAULT_PLAN = ("seed=3;nan@decode:max=1;inf@prefill:max=1;"
              "transient@decode:max=2;transient@prefill:max=1")
# tests/test_chaos.py's MIXED_PLAN: NaN-poisoned decodes, a failed prefill
# dispatch, straggler-delayed steps and three steps of arena pressure.
MIXED_PLAN = ("seed=3;nan@decode:p=1,max=2;transient@prefill:max=1;"
              "straggler@step:delay=0.001,start=6,max=2;"
              "arena:pages=2,start=3,max=3")
# The counters part b holds between the card and the CPU.
ROBUST_COUNTERS = ("retries", "fallbacks", "injected_faults", "shed",
                   "preemptions", "prefill_chunks")
# Each op phase 4b's steps dispatch, by the launch counter of the kernel
# it launches (bf16 GEMMs count under "gemm").
OP_KERNEL = {"matmul": "gemm", "paged_attention": "paged_decode_attention",
             "paged_prefill_attention": "paged_prefill_attention"}


def robust_full_width(torch, np, engine, clean):
    """Part a: phase 4's traffic on phase 4's weights under ``FAULT_PLAN``
    with the NaN guard on. Every request finishes; retries and fallbacks
    equal the injector's firings; each re-run inside
    ``_dispatch_fallback`` launches the kernels its primary step launched,
    as many times, and gives phase 4's logits of the same step bit for
    bit (from the restored pre-call state); every request's tokens equal
    phase 4's. The same traffic runs unfaulted just before (the guard off,
    then on) and just after (off), so the faulted wall has neighbours
    taken on the same host at the same time."""
    from repro_torch import kernels
    from repro_torch.serving import ServingEngine

    cfg = engine.model_cfg

    def serving(faults=None, nan_guard=None):
        eng = ServingEngine(cfg, max_slots=4, max_context=2048, page_size=64,
                            prefill_chunk=256, seed=0, params=engine.params,
                            faults=faults, nan_guard=nan_guard,
                            device="cuda")
        rng = np.random.default_rng(0)
        for n in SERVE_PROMPTS:
            eng.submit(rng.integers(0, cfg.vocab, (n,)).astype(np.int32),
                       SERVE_NEW)
        return eng

    def unfaulted(name, nan_guard):
        rep = serving(nan_guard=nan_guard).run()
        torch.cuda.synchronize()
        assert_clean(name, rep["summary"])
        toks = [np.asarray(r["tokens"]).tolist() for r in rep["requests"]]
        if toks != clean["tokens"]:
            fail(f"{name}: tokens differ from phase 4's")
        return rep["summary"]

    neighbours = [unfaulted("unfaulted serve, guard off", False),
                  unfaulted("unfaulted serve, guard on", True)]
    eng = serving(faults=FAULT_PLAN)
    primary, fallback = eng._dispatch, eng._dispatch_fallback
    seen = {"steps": 0, "launched": [], "reruns": []}

    def grown(before):
        return {k: v - before[k] for k, v in kernels.launch_counts().items()
                if v > before[k]}

    def watch_primary(which, args):
        before = kernels.launch_counts()
        out = primary(which, args)
        seen["launched"].append(grown(before))
        seen["steps"] += 1
        return out

    def watch_fallback(which, args):
        before = kernels.launch_counts()
        logits, state = fallback(which, args)
        torch.cuda.synchronize()
        step = seen["steps"] - 1
        launched, want = grown(before), seen["launched"][step]
        if launched != want:
            fail(f"the re-run of {which} step {step} launched {launched}, "
                 f"its primary call {want}")
        ref = clean["logits"][step]
        if ref is None or not torch.equal(logits, ref):
            fail(f"the re-run of {which} step {step}: logits differ from "
                 f"phase 4's same step")
        seen["reruns"].append({"which": which, "step": step,
                               "launches": sum(launched.values())})
        return logits, state

    eng._dispatch, eng._dispatch_fallback = watch_primary, watch_fallback
    report = eng.run()
    torch.cuda.synchronize()
    s, fired = report["summary"], report["faults"]
    for r in report["requests"]:
        if r["status"] != "finished" or r["new_tokens"] != SERVE_NEW:
            fail(f"faulted request {r['rid']}: status {r['status']}, "
                 f"{r['new_tokens']} of {SERVE_NEW} tokens")
    want = {"retries": sum(v for k, v in fired.items()
                           if k.startswith("transient@")),
            "fallbacks": sum(v for k, v in fired.items()
                             if k.startswith(("nan@", "inf@")))}
    if fired != {"inf@prefill": 1, "nan@decode": 1, "transient@decode": 2,
                 "transient@prefill": 1} or \
            {k: int(s[k]) for k in want} != want or \
            len(seen["reruns"]) != want["fallbacks"]:
        fail(f"faulted run: fired {fired}, retries {s['retries']}, "
             f"fallbacks {s['fallbacks']}, re-runs {len(seen['reruns'])}")
    if not seen["launched"] or not all(seen["launched"]):
        fail(f"a primary step launched no kernel: {seen['launched']}")
    tokens = [np.asarray(r["tokens"]).tolist() for r in report["requests"]]
    if tokens != clean["tokens"]:
        fail(f"faulted tokens {tokens} differ from phase 4's "
             f"{clean['tokens']}")
    neighbours.append(unfaulted("unfaulted serve, guard off", False))
    walls = {"guard off before": neighbours[0], "guard on": neighbours[1],
             "faulted": s, "guard off after": neighbours[2]}
    log(f"faulted serve: {int(s['requests'])} requests finished, fired "
        f"{fired}; {int(s['retries'])} retries, {int(s['fallbacks'])} "
        f"re-runs {seen['reruns']} (each its primary step's kernels, "
        f"logits equal to phase 4's step bit for bit); all tokens equal "
        f"phase 4's; wall {s['wall_s']:.3f} s against phase 4's "
        f"{clean['wall_s']:.3f} s")
    log("phase 4's traffic in phase 11, in order: " + "; ".join(
        f"{k} {v['wall_s']:.3f} s (ITL p50 {v['p50_itl_s'] * 1e3:.2f} ms, "
        f"TTFT p50 {v['p50_ttft_s'] * 1e3:.1f} ms)" for k, v in walls.items()))
    return {"summary": s, "faults": fired, "reruns": seen["reruns"],
            "wall_s": s["wall_s"], "clean_wall_s": clean["wall_s"],
            "neighbours": dict(zip(("guard off before", "guard on",
                                    "guard off after"), neighbours))}


def robust_mixed_fp32(torch, np):
    """Part b: phase 5's smoke gemma3-1b (fp32 model and engine config) on
    the chaos suite's traffic (two slots, 8-token pages and chunks, three
    prompts of 5, 11 and 19 tokens, 6 new each) under ``MIXED_PLAN``, on
    the card and on the CPU, and unfaulted on the card: equal tokens, and
    the card's counters and firings equal the CPU's."""
    from repro_torch import configs
    from repro_torch.core.config import GemminiConfig
    from repro_torch.models import transformer as tf
    from repro_torch.serving import ServingEngine

    cfg = dataclasses.replace(configs.get_smoke("gemma3-1b"),
                              dtype=torch.float32, n_layers=6,
                              global_period=3)
    f32 = GemminiConfig(input_dtype="fp32", acc_dtype="fp32",
                        output_dtype="fp32")
    params = tf.init_params(torch.Generator().manual_seed(1), cfg)
    runs = {}
    for name, device, plan in (("card", "cuda", MIXED_PLAN),
                               ("card unfaulted", "cuda", None),
                               ("cpu", "cpu", MIXED_PLAN)):
        eng = ServingEngine(cfg, max_slots=2, max_context=32, page_size=8,
                            n_pages=8, prefill_chunk=8, engine_cfg=f32,
                            params=_tree_map(lambda t: t.to(device), params),
                            faults=plan, seed=0, device=device)
        rng = np.random.default_rng(0)
        for n in (5, 11, 19):
            eng.submit(rng.integers(0, cfg.vocab, (n,)).astype(np.int32), 6)
        rep = eng.run()
        runs[name] = {"tokens": [np.asarray(r["tokens"]).tolist()
                                 for r in rep["requests"]],
                      "status": [r["status"] for r in rep["requests"]],
                      "counters": {k: int(rep["summary"][k])
                                   for k in ROBUST_COUNTERS},
                      "faults": rep.get("faults")}
    card, cpu, clean = runs["card"], runs["cpu"], runs["card unfaulted"]
    if card["tokens"] != clean["tokens"] or card["tokens"] != cpu["tokens"]:
        fail(f"MIXED_PLAN fp32 tokens: card {card['tokens']}, unfaulted "
             f"card {clean['tokens']}, CPU {cpu['tokens']}")
    if (card["counters"], card["faults"], card["status"]) != \
            (cpu["counters"], cpu["faults"], cpu["status"]):
        fail(f"MIXED_PLAN counters: card {card['counters']} "
             f"{card['faults']}, CPU {cpu['counters']} {cpu['faults']}")
    if card["counters"]["fallbacks"] < 1 or card["counters"]["retries"] < 1:
        fail(f"MIXED_PLAN fired no fallback or retry: {card['counters']}")
    log(f"MIXED_PLAN smoke gemma3-1b fp32: tokens equal on the card, the "
        f"unfaulted card and the CPU; counters {card['counters']}, fired "
        f"{card['faults']} on both")
    return runs


def profiler_full_width(torch, engine):
    """Part c: the profiler over phase 4b's decode step and continuation
    chunk. Per bucket: op, shape, calls, best ms, achieved TFLOP/s and
    TB/s, share of the roofline (the larger of the compute and memory
    shares, against ``repro_torch.analysis.roofline``'s peak for the op's
    input dtype); each op's calls equal the growth of its kernel's launch
    counter, no share exceeds 1.0, and the profiled step's logits equal
    the unprofiled step's bit for bit."""
    from repro_torch import kernels
    from repro_torch.obs import profile as oprofile

    out = {}
    for name, fn in profile_steps(torch, engine).items():
        want, _ = fn()
        torch.cuda.synchronize()
        walls, pwalls, outs = [], [], []
        for _ in range(3):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        prof = oprofile.install(oprofile.Profiler())
        try:
            before = kernels.launch_counts()
            for _ in range(3):
                t0 = time.perf_counter()
                got, _ = fn()
                torch.cuda.synchronize()
                pwalls.append((time.perf_counter() - t0) * 1e3)
                outs.append(got)
            after = kernels.launch_counts()
        finally:
            oprofile.deactivate()
        grew = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        calls = {}
        for b in prof.buckets.values():
            kernel = OP_KERNEL.get(b.op, b.op)
            calls[kernel] = calls.get(kernel, 0) + b.calls
        if calls != grew:
            fail(f"profile {name}: bucket calls {calls} against the launch "
                 f"counters' growth {grew}")
        if not all(torch.equal(got, want) for got in outs):
            fail(f"profile {name}: profiled logits differ from the "
                 f"unprofiled step's")
        rows = []
        for r in prof.table():
            share = max(r["compute_util"] or 0.0, r["memory_util"] or 0.0)
            row = {"op": r["op"], "contract": r["contract"], "sig": r["sig"],
                   "calls": r["calls"], "best_ms": r["min_s"] * 1e3,
                   "tflops": r["flops"] / r["min_s"] / 1e12,
                   "tbps": r["bytes"] / r["min_s"] / 1e12,
                   "share": share, "bound": r["bound"]}
            rows.append(row)
            log(f"profile {name}: {row['op']:<24} calls {row['calls']:>4}  "
                f"best {row['best_ms']:.4f} ms  {row['tflops']:8.3f} "
                f"TFLOP/s  {row['tbps']:.3f} TB/s  share {share:.3f} "
                f"({row['bound']})  {row['sig']}")
            if share > 1.0:
                fail(f"profile {name}: {row['op']} at {share:.3f} of the "
                     f"roofline ({row['sig']})")
        wall, pwall = statistics.median(walls), statistics.median(pwalls)
        log(f"profile {name}: {len(rows)} buckets, launches {grew}; "
            f"profiled wall {pwall:.3f} ms against {wall:.3f} ms unprofiled "
            f"({pwall / wall:.2f}x); logits equal bit for bit")
        out[name] = {"buckets": rows, "launches": grew, "wall_ms": wall,
                     "profiled_wall_ms": pwall}
    return out


def run_robust_phase(torch, np, engine, clean):
    """Phase 11: parts a, b and c."""
    out = {"faulted": robust_full_width(torch, np, engine, clean)}
    torch.cuda.empty_cache()
    out["mixed_fp32"] = robust_mixed_fp32(torch, np)
    out["profiler"] = profiler_full_width(torch, engine)
    return out


# ---------------------------------------------------------------------------
# phase 12: the MoE family at full width (granite-moe-3b-a800m)
# ---------------------------------------------------------------------------
MOE_ARCH = "granite-moe-3b-a800m"
# The prompt whose prefill logits are held against the CPU: the CPU's
# dense expert products (48 slots x every token row) set its cost.
MOE_LOGITS_PROMPT = 256


def routing_census(torch, engine, seed=3):
    """Every layer's expert loads on one decode step (4 tokens) and one
    256-token continuation chunk (phase 4b's steps, tokens from ``seed``),
    read from ``moe.route`` while the steps run: each layer's loads sum to
    tokens x top_k, and no padded slot gets a token."""
    from repro_torch.models import moe

    cfg = engine.model_cfg
    e_pad = moe.pad_experts(cfg.n_experts, cfg.expert_padding)
    seen, primary = [], moe.route

    def recording(*args, **kw):
        weights, idx = primary(*args, **kw)
        seen.append(idx)
        return weights, idx

    out = {}
    moe.route = recording
    try:
        for name, fn in profile_steps(torch, engine, seed=seed).items():
            seen.clear()
            fn()
            loads = torch.stack([torch.bincount(i.reshape(-1),
                                                minlength=e_pad)
                                 for i in seen]).cpu()
            n_tok = seen[0].shape[0]
            if len(seen) != cfg.n_layers or \
                    (loads.sum(1) != n_tok * cfg.top_k).any() or \
                    loads[:, cfg.n_experts:].any():
                fail(f"{MOE_ARCH} {name}: routing census over {len(seen)} "
                     f"layers: loads {loads.tolist()} (want {n_tok} x "
                     f"{cfg.top_k} a layer, none on slots "
                     f"{cfg.n_experts}-{e_pad - 1})")
            used = (loads[:, :cfg.n_experts] > 0).sum(1)
            out[name] = {"tokens": n_tok, "loads": loads.tolist(),
                         "experts_used_min": int(used.min()),
                         "experts_used_max": int(used.max()),
                         "max_load": int(loads.max())}
            log(f"{MOE_ARCH} {name} routing: {n_tok} tokens x top-"
                f"{cfg.top_k} on each of {len(seen)} layers, loads summing "
                f"to {n_tok * cfg.top_k}, none on the {e_pad - cfg.n_experts}"
                f" padded slots; {int(used.min())}-{int(used.max())} of "
                f"{cfg.n_experts} experts used a layer, busiest expert "
                f"{int(loads.max())} tokens")
    finally:
        moe.route = primary
    return out


def run_moe_phase(torch, np):
    """granite-moe-3b-a800m at its published widths (32 layers, 40 experts
    in 48 slots, top-8; bf16, weights from seed 0) on phase 4's traffic:
    the bf16 GEMM, the fp32 router GEMM, flash, paged prefill and paged
    decode must each launch (and neither the SSD nor dense decode); the
    routing census; a prompt's prefill logits against the CPU plain path
    in fp32 and by ``hold_bf16``; the two steps' device time by kernel
    class, the expert ``bmm`` apart."""
    engine, prompts, counts, _, s = serve_family(torch, np, MOE_ARCH,
                                                 SERVE_PROMPTS, SERVE_NEW)
    L = engine.model_cfg.n_layers
    need = ("gemm", "gemm[fp32]", "flash_attention",
            "paged_prefill_attention", "paged_decode_attention")
    if any(counts[k] <= 0 for k in need) or counts["gemm[fp32]"] % L or \
            counts["ssd"] or counts["decode_attention"]:
        fail(f"{MOE_ARCH} launch counts {counts}: want {need} each > 0, "
             f"the router once a layer, no ssd or decode_attention")
    census = routing_census(torch, engine)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, engine.model_cfg.vocab,
                          (MOE_LOGITS_PROMPT,)).astype(np.int32)
    t0 = time.perf_counter()
    rel = check_prefill_logits(torch, engine, prompt, MOE_ARCH)
    log(f"{MOE_ARCH} logits holds: {time.perf_counter() - t0:.1f} s")
    profile = profile_family(torch, engine, op_keys=("aten::bmm",))
    for name, prof in profile.items():
        log(f"{MOE_ARCH} {name}: expert bmm "
            f"{prof['device_ms_by_op']['aten::bmm']:.3f} ms ({L} layers x 3"
            f" products) of {prof['device_ms']:.3f} ms device time; the "
            f"port's kernels " + ", ".join(
                f"{k} {v:.3f} ms" for k, v in
                sorted(prof["device_ms_by_kernel"].items()) if k != "other"))
        log(f"{MOE_ARCH} {name}: the largest other kernels (ms, launches): "
            + "; ".join(f"{k[:90]} {ms:.3f} x{c}"
                        for k, ms, c in prof["top_other"]))
    return counts, {"summary": s, "census": census, "logits_rel_l2": rel,
                    "profile": profile}


# ---------------------------------------------------------------------------
# phase 13: one training step of every arch at smoke size, card against CPU
# ---------------------------------------------------------------------------
# fp32 model and engine on both sides; the GEMMs and attention's einsums
# sum in other orders (1e-7 an op), which the loss and the backward
# compound: a gradient leaf's relative L2 error reads about 1e-6 and the
# limit is 1e-4. The step's updated parameters: AdamW's first step moves
# each weight by lr * g / (|g| + eps), about the learning rate whatever
# the gradient's size, so each weight's gap from the CPU's is read as a
# share of the update's own bound, 2 lr (1 + wd |w|). Where a gradient
# is rounding noise on both sides the two steps may go either way: qwen's
# key bias, whose gradient the softmax cancels (a constant added to a
# row's scores), is held only to that bound (TRAIN_SMOKE_NOISE_LEAVES);
# every other leaf to TRAIN_SMOKE_PARAM_LIMIT of it: on an H100 the
# largest reading was 1.78e-2 (musicgen-medium's mlp/wg, whose small
# gradients AdamW's eps leaves sensitive), the next 8.6e-3 (PERF.md, PR
# 26), so 5e-2 leaves a factor of 2.8.
TRAIN_SMOKE_GRAD_LIMIT = 1e-4
TRAIN_SMOKE_LR = 1e-3
TRAIN_SMOKE_NOISE_LEAVES = ("blocks/attn/bk",)
TRAIN_SMOKE_PARAM_LIMIT = 5e-2


def run_train_smoke_phase(torch, np):
    """Every registry arch at smoke size in fp32 (model and engine): one
    ``make_train_step`` on the card and on the CPU from the same weights
    and batch (llava with an ``extra_embeds`` prefix, musicgen with its
    codebooks, the MoE archs capacity-bound), the loss and every gradient
    leaf (``steps.loss_and_grads``, the call the step makes), the step's
    metrics and its updated parameters compared. The card must launch the
    fp32 GEMM and its backward products."""
    from repro_torch import configs, kernels
    from repro_torch.core import tree as tu
    from repro_torch.core.config import GemminiConfig
    from repro_torch.core.context import ExecutionContext
    from repro_torch.data import SyntheticLM, SyntheticLMConfig, make_batch
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    ctx = ExecutionContext(cfg=GemminiConfig(
        input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32"))
    out = {}
    for arch in configs.names():
        cfg = dataclasses.replace(configs.get_smoke(arch),
                                  dtype=torch.float32)
        state = steps.init_train_state(cfg, seed=2, device="cpu")
        gen = SyntheticLM(SyntheticLMConfig(
            vocab=cfg.vocab, seq=16, global_batch=2, seed=2,
            n_codebooks=cfg.n_codebooks))
        extra = dict(extra_embed_dim=cfg.d_model, extra_tokens=4) \
            if cfg.modality == "vlm" else {}
        batch = make_batch(gen, 0, "cpu", **extra)
        opt_cfg = adamw.AdamWConfig(lr=TRAIN_SMOKE_LR)
        step_fn = steps.make_train_step(ctx, cfg, opt_cfg)
        res = {}
        for dev in ("cuda", "cpu"):
            st = tu.tree_map(lambda t: t.to(dev), state)
            b = {k: v.to(dev) for k, v in batch.items()}
            kernels.reset_launch_counts()
            loss, grads = steps.loss_and_grads(ctx, cfg, st.params, b)
            new, metrics = step_fn(st, b)
            res[dev] = (loss, grads, new, metrics, kernels.launch_counts())
        (l_c, g_c, n_c, m_c, counts), (l_p, g_p, n_p, m_p, _) = \
            res["cuda"], res["cpu"]
        if counts["gemm[fp32]"] <= 0 or counts["gemm[bwd]"] <= 0:
            fail(f"{arch} smoke train step: counts {counts}, want the fp32 "
                 f"GEMM and gemm[bwd] launched")
        if not torch.isfinite(l_c) or l_c.item() != m_c["loss"].item():
            fail(f"{arch}: the card's loss {l_c.item()} is not finite or "
                 f"differs from its train step's {m_c['loss'].item()}")
        rels = {"loss": rel_l2(l_c, l_p),
                "grad_norm": rel_l2(m_c["grad_norm"], m_p["grad_norm"])}
        grad_rel = {path: rel_l2(g, dict(tu.flatten_with_paths(g_p))[path])
                    for path, g in tu.flatten_with_paths(g_c)}
        old = dict(tu.flatten_with_paths(state.params))
        new_cpu = dict(tu.flatten_with_paths(n_p.params))
        # each weight's gap from the CPU's, over the update's own bound
        param_gap = {
            path: ((x.cpu() - new_cpu[path]).abs() / (
                2 * opt_cfg.lr * (1 + opt_cfg.weight_decay *
                                  old[path].abs()))).max().item()
            for path, x in tu.flatten_with_paths(n_c.params)}
        worst_g = max(grad_rel, key=grad_rel.get)
        held = {k: v for k, v in param_gap.items()
                if k not in TRAIN_SMOKE_NOISE_LEAVES}
        noise = {k: v for k, v in param_gap.items()
                 if k in TRAIN_SMOKE_NOISE_LEAVES}
        worst_p = max(held, key=held.get)
        worst_n = max(noise.values(), default=0.0)
        log(f"{arch} smoke fp32 train step, card vs CPU: loss "
            f"{l_c.item():.6f} (rel {rels['loss']:.2e}), grad norm rel "
            f"{rels['grad_norm']:.2e}; {len(grad_rel)} gradient leaves, "
            f"worst {worst_g} {grad_rel[worst_g]:.2e} (limit "
            f"{TRAIN_SMOKE_GRAD_LIMIT}); updated parameters: largest gap "
            f"from the CPU's {worst_p} {held[worst_p]:.2e} of the "
            f"update's bound (limit {TRAIN_SMOKE_PARAM_LIMIT}; "
            f"{', '.join(sorted(noise)) or 'no leaf'} held to 1.0: "
            f"{worst_n:.2e}); launches gemm[fp32] {counts['gemm[fp32]']}, "
            f"gemm[bwd] {counts['gemm[bwd]']}")
        if rels["loss"] > 1e-5 or rels["grad_norm"] > TRAIN_SMOKE_GRAD_LIMIT \
                or grad_rel[worst_g] > TRAIN_SMOKE_GRAD_LIMIT or \
                held[worst_p] > TRAIN_SMOKE_PARAM_LIMIT or worst_n > 1.0:
            fail(f"{arch} smoke fp32 train step: card and CPU disagree")
        out[arch] = {**rels, "worst_grad": [worst_g, grad_rel[worst_g]],
                     "worst_param_gap": [worst_p, held[worst_p]],
                     "noise_param_gap": worst_n}
    return out


# ---------------------------------------------------------------------------
# phase 14: gemma3-1b trained at full width
# ---------------------------------------------------------------------------
TRAIN_ARCH = "gemma3-1b"
TRAIN_BATCH, TRAIN_SEQ = 4, 1024           # TRAIN_ROWS token rows a step
TRAIN_STEPS, TRAIN_CKPT_AT, TRAIN_LR = 8, 4, 1e-3
# The CPU comparison: the first step's loss and global gradient norm in
# fp32 at batch 1 x 128; the card's fp32 GEMMs and the CPU's sum in other
# orders, so they agree to about 1e-6.
TRAIN_CPU_LIMITS = {"loss": 1e-5, "grad_norm": 1e-4}
# The launcher's --fail-at restart at full width: three steps of batch 1 x
# 128, a checkpoint every two, one failure at step 2.
TRAIN_RESTART_ARGS = ("--steps", "3", "--batch", "1", "--seq", "128",
                      "--ckpt-every", "2", "--fail-at", "2", "--log-every",
                      "1")


def train_gemm_launches(cfg):
    """The engine GEMM's launches in one training step with ``remat``
    (policy ``full``): each layer's 7 projections and the unembedding
    forward, the layers' 7 again when the backward recomputes each block,
    and two backward products (dA, dB) per forward GEMM."""
    fwd = 7 * cfg.n_layers + 1
    return {"gemm": fwd + 7 * cfg.n_layers, "gemm[bwd]": 2 * fwd}


def run_train_phase(torch, np):
    """gemma3-1b at its published widths (26 layers, vocab 262144; bf16,
    the serving engine config bf16 -> fp32 -> bf16), ``remat=True``, AdamW
    under a cosine schedule, batches of 4 x 1024 from ``SyntheticLM`` seed
    0, ``TRAIN_STEPS`` steps: each step's GEMM launches equal
    ``train_gemm_launches`` (and no attention or SSD kernel runs: training
    takes the model functions); every loss finite and the last three's
    mean below the first three's; the state after ``TRAIN_CKPT_AT`` steps
    saved, restored into a fresh state bit for bit, and the next step from
    it gives the uninterrupted run's loss; a profiled step's wall, device
    time and idle share; the first step's loss and gradient norm in fp32
    at batch 1 x 128 against the CPU; the launcher's ``--fail-at``
    restart resuming from its checkpoint."""
    import shutil

    from repro_torch import configs, kernels
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core import tree as tu
    from repro_torch.core.config import GemminiConfig
    from repro_torch.core.context import ExecutionContext
    from repro_torch.data import SyntheticLM, SyntheticLMConfig, make_batch
    from repro_torch.kernels import gemm as kg
    from repro_torch.launch import steps
    from repro_torch.launch import train as train_cli
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw, schedule

    free, total = torch.cuda.mem_get_info()
    log(f"train phase: {free / 2**30:.1f} GiB of {total / 2**30:.1f} GiB "
        f"free on the card before it starts")
    cfg = configs.get(TRAIN_ARCH)
    ctx = ExecutionContext(cfg=GemminiConfig(
        input_dtype="bf16", acc_dtype="fp32", output_dtype="bf16"))
    t0 = time.perf_counter()
    state = steps.init_train_state(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in tu.leaves(state.params))
    log(f"{TRAIN_ARCH} train: {n_params / 1e9:.3f} B parameters, "
        f"{cfg.n_layers} layers, AdamW state fp32; init "
        f"{time.perf_counter() - t0:.1f} s")
    gen = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=0))
    batches = [make_batch(gen, i, "cuda") for i in range(TRAIN_STEPS)]
    train_step = steps.make_train_step(
        ctx, cfg, adamw.AdamWConfig(lr=TRAIN_LR),
        lr_schedule=lambda s: schedule.cosine_schedule(s, TRAIN_STEPS,
                                                       warmup_steps=1))
    want = train_gemm_launches(cfg)
    ckpt_dir = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    mgr = CheckpointManager(ckpt_dir, keep=1)

    losses, norms, walls = [], [], []
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    for i in range(TRAIN_STEPS):
        before = kernels.launch_counts()
        persistent = kg.BWD_COUNT.persistent
        t0 = time.perf_counter()
        state, metrics = train_step(state, batches[i])
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        after = kernels.launch_counts()
        got = {k: after[k] - before[k] for k in after if after[k] - before[k]}
        if got != want:
            fail(f"train step {i}: launches {got}, want {want}")
        # every backward product is 16-bit and tensor-map aligned here: all
        # of them take the backward kernel
        if kg.BWD_COUNT.persistent - persistent != want["gemm[bwd]"]:
            fail(f"train step {i}: {kg.BWD_COUNT.persistent - persistent} "
                 f"of {want['gemm[bwd]']} backward products on the "
                 f"backward kernel")
        if i + 1 == TRAIN_CKPT_AT:
            t0 = time.perf_counter()
            mgr.save(TRAIN_CKPT_AT, state, extra_meta={"arch": cfg.name})
            saved, ckpt_s = state, time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{TRAIN_ARCH} train: {TRAIN_STEPS} steps of {TRAIN_BATCH} x "
        f"{TRAIN_SEQ}, losses " + ", ".join(f"{x:.4f}" for x in losses)
        + "; grad norms " + ", ".join(f"{x:.3f}" for x in norms)
        + f"; step walls (s) " + ", ".join(f"{x:.3f}" for x in walls)
        + f"; peak memory {peak:.2f} GiB; launches per step {want}, "
        f"every gemm[bwd] on the backward kernel")
    if not all(np.isfinite(losses)) or \
            not np.mean(losses[-3:]) < np.mean(losses[:3]):
        fail(f"{TRAIN_ARCH} train: losses {losses} not finite or not "
             f"falling (last three's mean against the first three's)")

    # a profiled step: wall, device time, idle share
    prof = profile_call(torch, f"{TRAIN_ARCH} train step",
                        lambda: train_step(state, batches[0]), n=2)
    log(f"{TRAIN_ARCH} train step: {TRAIN_ROWS / prof['wall_ms'] * 1e3:.0f}"
        f" tokens/s, device idle {1 - prof['device_busy_share']:.1%} of "
        f"the step's wall")
    del state
    torch.cuda.empty_cache()

    # the checkpoint: restored into a fresh state, bit for bit; the next
    # step from it gives the uninterrupted run's loss
    t0 = time.perf_counter()
    step_found, restored = mgr.restore_latest(
        steps.init_train_state(cfg, seed=1, device="cuda"),
        expect_meta={"arch": cfg.name})
    restore_s = time.perf_counter() - t0
    pairs = list(zip(tu.leaves(restored), tu.leaves(saved)))
    differ = [i for i, (x, y) in enumerate(pairs)
              if x.dtype != y.dtype or not torch.equal(x, y)]
    if step_found != TRAIN_CKPT_AT or differ:
        fail(f"checkpoint: step {step_found}, {len(differ)} of "
             f"{len(pairs)} leaves differ from the saved state")
    del saved
    _, m5 = train_step(restored, batches[TRAIN_CKPT_AT])
    resumed_loss = float(m5["loss"])
    del restored, m5
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    if resumed_loss != losses[TRAIN_CKPT_AT]:
        fail(f"checkpoint: step {TRAIN_CKPT_AT + 1}'s loss from the "
             f"restored state {resumed_loss} != the uninterrupted run's "
             f"{losses[TRAIN_CKPT_AT]}")
    log(f"{TRAIN_ARCH} checkpoint at step {TRAIN_CKPT_AT}: saved in "
        f"{ckpt_s:.1f} s, restored into a fresh state in {restore_s:.1f} s, "
        f"{len(pairs)} leaves (params and AdamW state) equal bit for bit; "
        f"step {TRAIN_CKPT_AT + 1}'s loss from it {resumed_loss:.6f} equals "
        f"the uninterrupted run's")

    torch.cuda.empty_cache()

    # the first step's loss and gradient norm in fp32 against the CPU
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    ctx32 = ExecutionContext(cfg=GemminiConfig(
        input_dtype="fp32", acc_dtype="fp32", output_dtype="fp32"))
    params = tf.init_params(torch.Generator().manual_seed(0), cfg32)
    small = make_batch(SyntheticLM(SyntheticLMConfig(
        vocab=cfg.vocab, seq=128, global_batch=1, seed=0)), 0)
    cmp = {}
    t0 = time.perf_counter()
    for dev in ("cuda", "cpu"):
        p = tu.tree_map(lambda t: t.to(dev), params)
        loss, grads = steps.loss_and_grads(
            ctx32, cfg32, p, {k: v.to(dev) for k, v in small.items()})
        cmp[dev] = (loss.cpu(), adamw.global_norm(grads).cpu())
        del p, grads
    rel = {"loss": rel_l2(cmp["cuda"][0], cmp["cpu"][0]),
           "grad_norm": rel_l2(cmp["cuda"][1], cmp["cpu"][1])}
    log(f"{TRAIN_ARCH} fp32 first step at 1 x 128, card vs CPU: loss "
        f"{cmp['cuda'][0].item():.6f} vs {cmp['cpu'][0].item():.6f} (rel "
        f"{rel['loss']:.2e}), grad norm {cmp['cuda'][1].item():.4f} vs "
        f"{cmp['cpu'][1].item():.4f} (rel {rel['grad_norm']:.2e}); limits "
        f"{TRAIN_CPU_LIMITS}; {time.perf_counter() - t0:.1f} s")
    if any(rel[k] > TRAIN_CPU_LIMITS[k] for k in rel):
        fail(f"{TRAIN_ARCH} fp32 first step: card and CPU disagree {rel}")
    del params
    torch.cuda.empty_cache()

    # the launcher's --fail-at restart, resuming from its checkpoint
    restart_dir = os.path.join(ROOT, "build", "chip_smoke_restart")
    shutil.rmtree(restart_dir, ignore_errors=True)
    t0 = time.perf_counter()
    res = train_cli.main(["--arch", TRAIN_ARCH, *TRAIN_RESTART_ARGS,
                          "--ckpt-dir", restart_dir])
    restart_s = time.perf_counter() - t0
    shutil.rmtree(restart_dir, ignore_errors=True)
    if res.start_step != 2 or res.steps_done != 3 or \
            not np.isfinite(res.losses).all():
        fail(f"launcher restart: resumed from step {res.start_step}, "
             f"{res.steps_done} steps, losses {res.losses}")
    log(f"launcher restart ({' '.join(TRAIN_RESTART_ARGS)}): failed at "
        f"step 2, resumed from the step-2 checkpoint, finished 3 steps in "
        f"{restart_s:.1f} s")
    torch.cuda.empty_cache()
    return counts, {"losses": losses, "grad_norms": norms, "step_s": walls,
                    "peak_gib": peak, "free_gib_before": free / 2**30,
                    "launches_per_step": want, "checkpoint_s": ckpt_s,
                    "restore_s": restore_s, "resumed_loss": resumed_loss,
                    "profile": prof, "fp32_vs_cpu": rel,
                    "restart_s": restart_s}


# ---------------------------------------------------------------------------
# phase 15: gemma3-4b served at full width
# ---------------------------------------------------------------------------
G4_ARCH = "gemma3-4b"
G4_LOGITS_PROMPT = 256


def run_gemma3_4b_phase(torch, np):
    """gemma3-4b at its published widths (34 layers, GQA 8 / 4, head dim
    256, window 1024; bf16, weights from seed 0) on phase 4's traffic:
    every serving kernel must launch (and neither the SSD, dense decode nor
    the fp32 GEMM); a 256-token prompt's prefill logits against the CPU
    plain path by ``hold_fp32`` and ``hold_bf16``."""
    from repro_torch import kernels

    engine, prompts, counts, _, s = serve_family(torch, np, G4_ARCH,
                                                 SERVE_PROMPTS, SERVE_NEW)
    if any(counts[k] <= 0 for k in kernels.SERVING_KERNELS) or \
            counts["ssd"] or counts["decode_attention"] or \
            counts["gemm[fp32]"]:
        fail(f"{G4_ARCH} launch counts {counts}: want every serving kernel "
             f"launched, no ssd, decode_attention or fp32 GEMM")
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, engine.model_cfg.vocab,
                          (G4_LOGITS_PROMPT,)).astype(np.int32)
    t0 = time.perf_counter()
    rel = check_prefill_logits(torch, engine, prompt, G4_ARCH)
    log(f"{G4_ARCH} logits holds: {time.perf_counter() - t0:.1f} s")
    del engine
    torch.cuda.empty_cache()
    return counts, {"summary": s, "logits_rel_l2": rel}


# ---------------------------------------------------------------------------
# phase 16: the kernel-schedule tuner on the card
# ---------------------------------------------------------------------------
TUNE_CACHE = os.path.join(ROOT, "build", "chip_smoke_tune.json")


def tune_gemm_shapes(torch):
    """The GEMMs phase 16 tunes: gemma3-1b's distinct engine GEMMs at a
    decode step (M = 4) and a 256-token chunk, as (label, dtypes, ws, M, N,
    K, bias, B transposed). (The training step's backward products run the
    backward kernel, whose plan the tuner does not choose.)"""
    from repro_torch import configs
    from repro_torch.models import transformer as tf

    cfg = configs.get("gemma3-1b")
    eng = (torch.bfloat16, torch.float32, torch.bfloat16)
    out, seen = [], set()
    for rows, seq in ((4, 1), (1, 256)):
        for (m, n, k, bias, fp32_in, b_trans) in tf.model_gemm_calls(
                cfg, rows, seq, include_decode=False):
            if (m, n, k, b_trans) not in seen:
                seen.add((m, n, k, b_trans))
                out.append((f"M={m} N={n} K={k}" + (" B^T" if b_trans
                                                    else ""),
                            eng, False, m, n, k, bias, b_trans))
    return out


def _retime(torch, static_fn, winner_fn, rounds=4):
    """The static plan and the winner timed again, apart from the tuner's
    measurement: ``rounds`` timings of each (``measure.time_callable``'s
    min of 5, L2 flushed), interleaved static, winner, winner, static, ...
    so drift falls on both; the min of each, in us."""
    from repro_torch.tune import measure

    dev = torch.device("cuda", torch.cuda.current_device())
    t = ([], [])
    for r in range(rounds):
        for i in ((0, 1) if r % 2 == 0 else (1, 0)):
            t[i].append(measure.time_callable(
                (static_fn, winner_fn)[i], device=dev)["min_us"])
    return min(t[0]), min(t[1])


def _tune_log(torch, name, rep, static_fn, winner_fn, extra=""):
    """A report's static and winning times; where another plan than the
    static one won, the TIE_BAND check on a fresh measurement
    (``_retime``): the winner fails if it is more than TIE_BAND slower
    than the static plan there."""
    from repro_torch.tune import tuner

    static = rep.candidates[0]
    win = next(c for c in rep.candidates if c.sched == rep.winner)
    row = {"static_us": static.min_us, "winner": win.sched,
           "winner_us": win.min_us, "candidates": len(rep.candidates),
           "cache_key": rep.cache_key}
    again = ""
    if not win.is_static:
        s_us, w_us = _retime(torch, static_fn, winner_fn)
        row.update(recheck_static_us=s_us, recheck_winner_us=w_us)
        again = (f"; again {s_us:.2f} against {w_us:.2f} us "
                 f"({s_us / w_us:.3f}x)")
        if not w_us <= s_us * (1 + tuner.TIE_BAND):
            fail(f"tune {name}: the winner {win.sched} takes {w_us:.2f} us "
                 f"in a fresh measurement, beyond {tuner.TIE_BAND} of the "
                 f"static plan's {s_us:.2f} us")
    log(f"tune {name}: {len(rep.candidates)} candidates; static "
        f"{static.min_us:.2f} us, winner {win.sched} {win.min_us:.2f} us "
        f"({static.min_us / win.min_us:.3f}x){again}{extra}")
    return row


def _library_us(torch, fn):
    from repro_torch.tune import measure
    return measure.time_callable(fn, device=torch.device("cuda"))["min_us"]


def tune_and_hold(torch, np):
    """Phase 16a: under ``full``, tune every shape of the list below and
    hold each winner's output against the plain version by phase 3's
    rules; a winner other than the static plan within TIE_BAND of it in a
    fresh, interleaved measurement (``_tune_log``); every persisted entry,
    read back by a fresh cache object, the plan that won."""
    import torch.nn.functional as F

    from repro_torch.core.config import Activation
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels.ref import conv2d_ref, gemm_ref
    from repro_torch.tune import cache as tcache
    from repro_torch.tune import measure, schedules, tuner

    dev = torch.device("cuda", torch.cuda.current_device())
    rows = {}
    for (label, dtypes, ws, m, n, k, bias, bt) in tune_gemm_shapes(torch):
        rep = tuner._tune_gemm(dtypes, ws, m, n, k, bias, bt, dev)
        run = measure.gemm_case(dtypes, ws, m, n, k, bias, bt, dev)
        a, b, d = run.operands
        lib = _library_us(torch, lambda: torch.matmul(a, b))
        row = _tune_log(torch, f"gemm {label}", rep,
                        lambda: run(schedules.STATIC),
                        lambda: run(rep.winner),
                        f"; torch.matmul {lib:.2f} us")
        got = run(rep.winner)
        kw = dict(acc_dtype=dtypes[1], out_dtype=dtypes[2], shift=0,
                  activation=Activation.NONE)
        want = gemm_ref(a, b, d, **kw)
        if k >= LONG_K:
            hold_long_k(torch, f"tune gemm {label}",
                        lambda: a.double() @ b.double())(got, want)
        else:
            check_close(torch, f"tune gemm {label}", got, want, "bf16")
        del run, a, b, d, got, want
        rows[f"gemm {label}"] = {**row, "library_us": lib}
    torch.cuda.empty_cache()
    for inst, dtypes, kind in (
            ("int8", (torch.int8, torch.int32, torch.int8), "int"),
            ("fp32", (torch.float32,) * 3, "fp32")):
        for label, (m, n, k), (h, ci, co, kh, st, pad), _ in \
                resnet50_shapes():
            label = f"{label} {m}x{n}x{k}"   # the stage's 1x1 layers differ
            rep = tuner._tune_conv(dtypes, 1, h, h, ci, co, kh, kh, st, pad,
                                   True, dev)
            run = measure.conv_case(dtypes, 1, h, h, ci, co, kh, kh, st,
                                    pad, True, dev)
            x, w, bias = run.operands
            extra, lib = "", None
            if kind == "fp32":
                xc = x.permute(0, 3, 1, 2)
                wc = w.permute(3, 2, 0, 1).contiguous(
                    memory_format=torch.channels_last)
                lib = _library_us(torch, lambda: F.conv2d(
                    xc, wc, bias, stride=st, padding=pad))
                extra = f"; cuDNN conv2d {lib:.2f} us"
            row = _tune_log(torch, f"conv {inst} {label}", rep,
                            lambda: run(schedules.STATIC),
                            lambda: run(rep.winner), extra)
            want = conv2d_ref(x, w, bias, stride=st, padding=pad,
                              acc_dtype=dtypes[1], out_dtype=dtypes[2])
            check_close(torch, f"tune conv {inst} {label}", run(rep.winner),
                        want, kind)
            rows[f"conv {inst} {label}"] = {**row, "library_us": lib}
    flash = (1, 256, 256, 4, 1, 256, True, None, torch.bfloat16)
    rep = tuner._tune_attention(*flash, dev)
    run = measure.attn_case(*flash, dev)
    q, k, v = run.operands
    lib = _library_us(torch, lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2).expand(-1, 4, -1, -1),
        v.transpose(1, 2).expand(-1, 4, -1, -1), is_causal=True))
    row = _tune_log(torch, "flash (1, 256, 256, H 4 / 1, D 256)", rep,
                    lambda: run(schedules.FLASH_STATIC),
                    lambda: run(rep.winner), f"; SDPA {lib:.2f} us")
    check_close(torch, "tune flash", run(rep.winner),
                ka.blockwise_attention(q, k, v, causal=True), "bf16")
    rows["flash"] = {**row, "library_us": lib}
    paged = (4, 4, 1, 256, 2048)
    rep = tuner.tune_paged_attention(None, *paged, dtype=torch.bfloat16,
                                     device=dev)
    win = rep.winner
    static = schedules.default_paged_schedule().effective(2048)
    run = measure.paged_case(*paged, win.page_size, None, torch.bfloat16,
                             dev)
    run_static = measure.paged_case(*paged, static.page_size, None,
                                    torch.bfloat16, dev)
    row = _tune_log(torch, "paged (4 slots, 2048 context)", rep,
                    lambda: run_static({"split_keys": static.split_keys}),
                    lambda: run({"split_keys": win.split_keys}))
    del run_static
    q, kp, vp, tables, lengths = run.operands
    check_close(torch, "tune paged decode", run(
        {"split_keys": win.split_keys}),
        ka.paged_decode_attention_plain(q, kp, vp, tables, lengths), "bf16")
    rows["paged"] = {**row, "winner": dataclasses.asdict(win)}
    rows["paged"]["static"] = dataclasses.asdict(static)
    tcache.reset_cache()                 # a fresh object reads the file
    pc = tcache.get_cache()
    for name, row in rows.items():
        want = row["winner"] if isinstance(row["winner"], dict) else \
            dataclasses.asdict(row["winner"])
        got = pc.lookup_schedule(row["cache_key"], ())
        if got != want:
            fail(f"tune {name}: the persisted entry reads back as {got}, "
                 f"not the winner {want}")
    log(f"tune: {len(rows)} persisted entries read back by a fresh cache "
        f"as the plans that won")
    return rows


def decode_walls(torch, engine, reps=8):
    """Phase 4b's decode step on ``engine``, synchronised, alternating
    call by call between ``cached`` (its resolved plans) and ``off`` (the
    kernels' own plans and decode split), after one warm-up of each: the
    walls in ms."""
    from repro_torch.core import flags

    tuned = engine.engine
    steps = {"cached": profile_steps(torch, engine)["decode_step"]}
    engine.engine = dataclasses.replace(tuned, decode_split=0)
    steps["off"] = profile_steps(torch, engine)["decode_step"]
    engine.engine = tuned
    walls = {"cached": [], "off": []}
    prev = flags.get("tune_mode")
    try:
        for rep in range(reps + 1):
            for mode, fn in steps.items():
                flags.set_flag("tune_mode", mode)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                if rep:                               # the first is warm-up
                    walls[mode].append((time.perf_counter() - t0) * 1e3)
    finally:
        flags.set_flag("tune_mode", prev)
    return walls


def run_tune_phase(torch, np, phase4b_decode_ms):
    """Phase 16: (a) tune and hold (``tune_and_hold``); (b) a fresh
    process-local cache in ``cached`` mode, an engine warmed for phase 4's
    prompts serves phase 4's traffic: no cache miss while it serves, every
    request finishes, the first request's first 256 tokens' prefill logits
    held by ``hold_bf16``, and the decode step's wall beside phase 4b's;
    (c) a guard trip under ``FAULT_PLAN`` quarantines the paged key, whose
    next resolution is the static page. The cache lives under ``build/``
    and is deleted afterwards; the flags are restored."""
    from repro_torch import configs, kernels, tune
    from repro_torch.core import flags
    from repro_torch.serving import ServingEngine
    from repro_torch.tune import cache as tcache
    from repro_torch.tune import schedules

    t_phase = time.perf_counter()
    prev = flags.get("tune_mode"), flags.get("tune_cache")
    if os.path.exists(TUNE_CACHE):
        os.remove(TUNE_CACHE)
    flags.set_flag("tune_cache", TUNE_CACHE)
    tcache.reset_cache()
    out = {}
    try:
        flags.set_flag("tune_mode", "full")
        t0 = time.perf_counter()
        out["tuned"] = tune_and_hold(torch, np)
        out["tune_s"] = time.perf_counter() - t0
        log(f"tune: {len(out['tuned'])} shapes tuned, held and persisted "
            f"in {out['tune_s']:.1f} s")

        # (b) warm, then serve from a fresh cache object in cached mode
        flags.set_flag("tune_mode", "cached")
        tcache.reset_cache()
        pc = tcache.get_cache()
        cfg = configs.get("gemma3-1b")
        t0 = time.perf_counter()
        engine = ServingEngine(cfg, max_slots=4, max_context=2048,
                               prefill_chunk=256, seed=0, device="cuda",
                               warm_prompt_lens=SERVE_PROMPTS)
        warm = engine.warm_stats
        log(f"tune: engine made and warmed in "
            f"{time.perf_counter() - t0:.2f} s: {warm}; page "
            f"{engine.page_size}, decode split "
            f"{engine.engine.decode_split or schedules.DEFAULT_SPLIT_KEYS}")
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, cfg.vocab, (n,)).astype(np.int32)
                   for n in SERVE_PROMPTS]
        for p in prompts:
            engine.submit(p, SERVE_NEW)
        h0, m0 = pc.hits, pc.misses
        kernels.reset_launch_counts()
        report = engine.run()
        torch.cuda.synchronize()
        hits, misses = pc.hits - h0, pc.misses - m0
        counts = kernels.launch_counts()
        if any(counts[k] <= 0 for k in kernels.SERVING_KERNELS):
            fail(f"tune serve: a serving kernel did not launch: {counts}")
        s = report["summary"]
        assert_clean("tune serve", s)
        for r in report["requests"]:
            if r["status"] != "finished" or r["new_tokens"] != SERVE_NEW:
                fail(f"tune serve: request {r['rid']} {r['status']}, "
                     f"{r['new_tokens']} of {SERVE_NEW} tokens")
        log(f"tune serve (cached): {s['tokens_per_s']:.2f} tok/s, ITL p50 "
            f"{s['p50_itl_s'] * 1e3:.2f} ms; cache hits {hits}, misses "
            f"{misses} while serving")
        if misses:
            fail(f"tune serve: {misses} cache misses on the request path "
                 f"after the warm-up")
        exact = prefill_logits(torch, engine, prompts[0][:256], fp32=True,
                               cpu_only=True)
        card, cpu = prefill_logits(torch, engine, prompts[0][:256])
        rel = hold_bf16("tune serve prefill (256 tokens)", card, cpu, exact)
        del exact, card, cpu
        walls = decode_walls(torch, engine)
        tuned_ms = statistics.median(walls["cached"])
        static_ms = statistics.median(walls["off"])
        log(f"tune: decode step wall {tuned_ms:.3f} ms resolved (cached) "
            f"against {static_ms:.3f} ms with tuning off, same engine and "
            f"page, {len(walls['off'])} calls each, alternating; phase 4b's "
            f"{phase4b_decode_ms:.3f} ms")
        out["serve"] = {"summary": s, "warm": warm, "hits": hits,
                        "launches": {k: counts[k] for k in
                                     kernels.SERVING_KERNELS},
                        "misses": misses, "page_size": engine.page_size,
                        "decode_split": engine.engine.decode_split,
                        "logits": rel, "decode_wall_ms": tuned_ms,
                        "decode_wall_off_ms": static_ms,
                        "decode_walls_ms": walls,
                        "phase4b_decode_wall_ms": phase4b_decode_ms}

        # (c) a guard trip quarantines the paged key
        flags.set_flag("tune_mode", "cached")
        faulted = ServingEngine(cfg, max_slots=4, max_context=2048,
                                prefill_chunk=256, seed=0, device="cuda",
                                params=engine.params, faults=FAULT_PLAN)
        del engine
        for p in prompts:
            faulted.submit(p, SERVE_NEW)
        rep = faulted.run()
        key = faulted._paged_sched_key
        static = schedules.default_paged_schedule().effective(2048)
        again = tune.resolve_paged_attn_schedule(
            None, 4, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, 2048,
            dtype=cfg.dtype)
        log(f"tune: FAULT_PLAN quarantined {rep['quarantined']} (the paged "
            f"key {key}); fallbacks {int(rep['summary']['fallbacks'])}; "
            f"next resolution {again}")
        if key is None or rep["quarantined"] != [key] or \
                not tcache.get_cache().is_quarantined(key) or \
                again != static:
            fail(f"tune: the guard trip did not quarantine the paged key "
                 f"{key} ({rep['quarantined']}) or its resolution {again} "
                 f"is not the static {static}")
        out["quarantine"] = {"key": key, "quarantined": rep["quarantined"],
                             "next": dataclasses.asdict(again)}
        del faulted
    finally:
        flags.set_flag("tune_mode", prev[0])
        flags.set_flag("tune_cache", prev[1])
        tcache.reset_cache()
        if os.path.exists(TUNE_CACHE):
            os.remove(TUNE_CACHE)
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tune phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 17: the launch contracts held to the card
# ---------------------------------------------------------------------------
CONTRACT_BUDGET_S = 90.0


def run_contract_phase(torch, sources):
    """The lint's verdict and geometry on every probe plan against the C
    plan functions, the registers against the launch bounds, and every
    accepted plan launched into guarded outputs
    (``repro_torch.analysis.lint.card``)."""
    from _ssd_exact import fp32_tolerance, ssd_fp64

    from repro_torch.analysis.lint import card
    from repro_torch.kernels import _build

    kinds = {"int": "int", "bf16": "bf16", "fp16": "fp16", "fp32": "fp32"}
    t0 = time.perf_counter()
    try:
        out = card.run(
            torch, log=log,
            close_fn=lambda name, got, want, kind: check_close(
                torch, name, got, want, kinds[kind]),
            ssd_exact=(ssd_fp64, fp32_tolerance),
            build_logs={name: _build.build_log(name) for name in sources},
            budget_s=CONTRACT_BUDGET_S)
    except card.CardFailure as e:
        fail(f"contracts: {e}")
    c = out["counts"]
    log(f"contracts: {c['plans']} plans checked, {c['admitted']} admitted "
        f"and launched, {c['refused']} refused, {c['needs_card']} need the "
        f"card ({c['card_refused']} refused by it), {c['c_disagree']} C "
        f"disagreements; {out['sms']} SMs")
    out["phase_s"] = time.perf_counter() - t0
    log(f"contract phase: {out['phase_s']:.1f} s")
    if c["c_disagree"]:
        fail(f"contracts: {c['c_disagree']} disagreements with the C plans")
    return out


# ---------------------------------------------------------------------------
# phase 18: multi-device on one card -- the sharded train step and the
# sharded context on a (1, 1) NCCL mesh, and a 16 x 16 dry run
# ---------------------------------------------------------------------------
MESH_STEPS = 2
DRYRUN_CELL = ("gemma3-1b", "train_4k")
DRYRUN_TIMEOUT_S = 300


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def start_dryrun():
    """The 16 x 16 dry-run cell in a subprocess (its ``fake`` process
    group cannot share this process with the NCCL one), on the CPU only:
    no card is visible to it."""
    outdir = os.path.join(ROOT, "build", "chip_smoke_dryrun")
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    arch, shape = DRYRUN_CELL
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--outdir", outdir], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, outdir, time.perf_counter()


def finish_dryrun(proc, outdir, t0):
    """Wait for the dry run; its row, held: per-device FLOPs at most the
    cell's logical count (above DTensor), and 256 devices' at least it."""
    try:
        text = proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"dry run: no result in {DRYRUN_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    arch, shape = DRYRUN_CELL
    for ln in text.splitlines():
        if ln.startswith(f"[{arch} x") or ln.startswith(
                ("  per device", "  collectives", "  logical", "  roofline")):
            log(f"dry run | {ln}")
    if proc.returncode != 0:
        fail(f"dry run exited {proc.returncode}:\n{text[-3000:]}")
    with open(os.path.join(outdir, f"baseline_{arch}_{shape}_16x16.json")) \
            as f:
        row = json.load(f)
    flops, logical = row["flops"], row["logical_flops"]
    if not (0 < flops <= logical <= flops * 256):
        fail(f"dry run: per-device FLOPs {flops:.4e} against the logical "
             f"{logical:.4e} over 256 devices")
    log(f"dry run {arch} x {shape} x 16x16: {wall:.1f} s wall (a process "
        f"on the CPU); per device {flops:.4e} FLOPs, {row['bytes']:.4e} "
        f"bytes, collectives {row['coll_breakdown']}; logical "
        f"{logical:.4e} (replication {row['replication']:.3f}); roofline "
        f"compute {row['t_compute'] * 1e3:.3f} ms, memory "
        f"{row['t_memory'] * 1e3:.3f} ms, collective "
        f"{row['t_collective'] * 1e3:.3f} ms -> {row['bottleneck']}-bound")
    return dict(row, wall_s=wall)


def mesh_train_step(torch, mesh, smi):
    """(a) Two sharded ``make_train_step`` steps of gemma3-1b at full
    width (phase 14's engine, batch and data) on the (1, 1) mesh against
    two unsharded steps from the same state: losses, gradient norms,
    parameters and AdamW's m and v bit for bit; the sharded steps' GEMM
    launches those of phase 14's steps (the counts zeroed just before them
    and read just after)."""
    from repro_torch import configs, kernels
    from repro_torch.core import tree as tu
    from repro_torch.core.config import GemminiConfig
    from repro_torch.core.context import ExecutionContext
    from repro_torch.data import (SyntheticLM, SyntheticLMConfig, make_batch,
                                  make_global_batch)
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cfg = configs.get(TRAIN_ARCH)
    ctx = ExecutionContext(cfg=GemminiConfig(
        input_dtype="bf16", acc_dtype="fp32", output_dtype="bf16"))
    sctx = ctx.with_mesh(mesh, shd.data_axis(mesh))
    opt = adamw.AdamWConfig(lr=TRAIN_LR)
    gen = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                                        global_batch=TRAIN_BATCH, seed=0))
    tspec = shd.tokens_spec(mesh, TRAIN_BATCH)
    ref_step = steps.make_train_step(ctx, cfg, opt)
    sh_step = steps.make_train_step(sctx, cfg, opt, mesh)

    def unsharded():
        state = steps.init_train_state(cfg, seed=0, device="cuda")
        out, walls = [], []
        for i in range(MESH_STEPS):
            t0 = time.perf_counter()
            state, m = ref_step(state, make_batch(gen, i, "cuda"))
            out.append((m["loss"].item(), m["grad_norm"].item()))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        return state, out, walls

    state_u, metrics_u, walls_u = unsharded()
    state_s = steps.init_train_state(cfg, seed=0, device="cuda", mesh=mesh)
    want = train_gemm_launches(cfg)
    metrics_s, walls_s = [], []
    kernels.reset_launch_counts()
    for i in range(MESH_STEPS):
        t0 = time.perf_counter()
        state_s, m = sh_step(state_s,
                             make_global_batch(gen, i, mesh, tspec))
        metrics_s.append((m["loss"].item(), m["grad_norm"].item()))
        torch.cuda.synchronize()
        walls_s.append(time.perf_counter() - t0)
    counts = kernels.launch_counts()
    got = {k: v for k, v in counts.items() if v}
    if got != {k: MESH_STEPS * v for k, v in want.items()}:
        fail(f"sharded train steps launched {got}, want {MESH_STEPS} x "
             f"{want}")
    if metrics_s != metrics_u:
        fail(f"sharded train steps: (loss, grad norm) {metrics_s}, "
             f"unsharded {metrics_u}")
    differ = []
    for name, tree_s, tree_u in (("params", state_s.params, state_u.params),
                                 ("m", state_s.opt["m"], state_u.opt["m"]),
                                 ("v", state_s.opt["v"], state_u.opt["v"])):
        ref = dict(tu.flatten_with_paths(tree_u))
        for path, x in tu.flatten_with_paths(tree_s):
            if not torch.equal(x.full_tensor(), ref[path]):
                differ.append(f"{name}/{path}")
    if differ:
        fail(f"sharded train steps: {len(differ)} leaves differ from the "
             f"unsharded steps', e.g. {differ[:4]}")
    n = len(tu.leaves(state_s.params))
    log(f"{TRAIN_ARCH} sharded train step on the (1, 1) mesh, {TRAIN_BATCH}"
        f" x {TRAIN_SEQ}: {MESH_STEPS} steps, (loss, grad norm) "
        f"{metrics_s} bit for bit the unsharded steps', and all {n} "
        f"parameters, m and v leaves; launches {got}; walls sharded "
        f"{', '.join(f'{w:.3f}' for w in walls_s)} s, unsharded "
        f"{', '.join(f'{w:.3f}' for w in walls_u)} s ({smi})")
    return {"metrics": metrics_s, "walls_s": walls_s, "walls_u": walls_u,
            "launches": got}


def mesh_ctx_ops(torch, mesh):
    """(b) Each wrapped op of the sharded context at phase 3's shapes,
    given DTensors, against the unsharded call on the same tensors: bit
    for bit, and each launches its kernel; then a DTensor handed straight
    to each kernel entry raises ``TypeError``."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch import configs, kernels
    from repro_torch.core.config import Activation, GemminiConfig
    from repro_torch.core.context import ExecutionContext
    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels import mamba2 as km
    from repro_torch.launch import sharding as shd

    g1 = configs.get("gemma3-1b")
    m2 = configs.get("mamba2-1.3b")
    gen = torch.Generator(device="cuda").manual_seed(18)
    bf16, f32, i8, i32 = torch.bfloat16, torch.float32, torch.int8, \
        torch.int32

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)

    def rint(lo, hi, *shape, dtype=i8):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=dtype)

    def dt(x):
        return None if x is None else DTensor.from_local(
            x, mesh, [Replicate()] * mesh.ndim, run_check=False)

    bf = GemminiConfig(input_dtype="bf16", acc_dtype="fp32",
                       output_dtype="bf16")
    d, hd, nh, nkv = g1.d_model, g1.head_dim, g1.n_heads, g1.n_kv_heads
    n_pages, page, mp = 512, 16, 64
    lengths = [700, 33, 256, 1]
    perm = torch.randperm(n_pages, generator=gen, device="cuda")
    tables = perm[:4 * mp].reshape(4, mp).to(i32)
    h, p, gr, n = m2.n_ssm_heads, m2.ssm_head_dim, m2.ssm_groups, m2.d_state
    cases = {
        "gemm (bias)": (bf, "gemm", lambda c, a, b, dd: c.gemm(a, b, dd),
                        (randn(64, d), randn(d, nh * hd, scale=d ** -0.5),
                         randn(1, nh * hd))),
        "conv2d (fused)": (GemminiConfig(), "conv2d_implicit",
                           lambda c, x, w, b: c.conv2d(
                               x, w, b, stride=1, padding=1, shift=8,
                               activation=Activation.RELU, fused=True),
                           (rint(-64, 64, 2, 56, 56, 64),
                            rint(-32, 32, 3, 3, 64, 64),
                            rint(-500, 500, 64, dtype=i32))),
        "flash_attention": (bf, "flash_attention",
                            lambda c, q, k, v: c.flash_attention(
                                q, k, v, window=g1.local_window),
                            (randn(2, 256, nh, hd), randn(2, 256, nkv, hd),
                             randn(2, 256, nkv, hd))),
        "paged_attention": (bf, "paged_decode_attention",
                            lambda c, q, kp, vp, t, ln: c.paged_attention(
                                q, kp, vp, t, ln),
                            (randn(4, 1, nh, hd),
                             randn(nkv, n_pages, page, hd),
                             randn(nkv, n_pages, page, hd), tables,
                             torch.tensor(lengths, dtype=i32,
                                          device="cuda"))),
        "ssd (resumed)": (bf, "ssd",
                          lambda c, x, dtt, a, b, cc, i: c.ssd(
                              x, dtt, a, b, cc, chunk=256, initial_state=i,
                              return_final_state=True),
                          (randn(2, 256, h, p),
                           torch.nn.functional.softplus(
                               randn(2, 256, h, dtype=f32)),
                           randn(h, dtype=f32), randn(2, 256, gr, n),
                           randn(2, 256, gr, n),
                           randn(2, h, n, p, dtype=f32, scale=0.5))),
    }
    out = {}
    for name, (gcfg, kernel, fn, args) in cases.items():
        want = fn(ExecutionContext(cfg=gcfg), *args)
        kernels.reset_launch_counts()
        got = fn(ExecutionContext(cfg=gcfg).with_mesh(
            mesh, shd.data_axis(mesh)), *[dt(a) for a in args])
        launched = kernels.launch_counts()[kernel]
        wants = want if isinstance(want, tuple) else (want,)
        gots = got if isinstance(got, tuple) else (got,)
        same = all(isinstance(x, DTensor) and torch.equal(x.full_tensor(), w)
                   for x, w in zip(gots, wants))
        if not same or launched != 1:
            fail(f"sharded ctx.{name}: bit for bit {same}, {kernel} "
                 f"launches {launched} (want 1)")
        out[name] = {"kernel": kernel, "launches": launched,
                     "shapes": [list(a.shape) for a in args
                                if a is not None]}
    q, k, v = (dt(x) for x in cases["flash_attention"][3])
    x8, w8, b32 = (dt(x) for x in cases["conv2d (fused)"][3])
    a, b, dd = (dt(x) for x in cases["gemm (bias)"][3])
    pq, kp, vp, tb, ln = (dt(x) for x in cases["paged_attention"][3])
    sx, sdt, sa, sb, sc, si = (dt(x) for x in cases["ssd (resumed)"][3])
    entries = {
        "gemm_os": lambda: kg.gemm_os(a, b, dd, acc_dtype=f32,
                                      out_dtype=bf16),
        "gemm_ws": lambda: kg.gemm_ws(a, b, dd, acc_dtype=f32,
                                      out_dtype=bf16),
        "accumulator_epilogue": lambda: kg.accumulator_epilogue(
            dt(randn(64, 64, dtype=f32)), out_dtype=bf16),
        "conv2d_implicit": lambda: kc.conv2d_implicit(
            x8, w8, b32, acc_dtype=i32, out_dtype=i8, padding=1),
        "flash_attention": lambda: ka.flash_attention(q, k, v),
        "decode_attention": lambda: ka.decode_attention(q[:, :1], k, v, 9),
        "paged_decode_attention": lambda: ka.paged_decode_attention(
            pq, kp, vp, tb, ln),
        "paged_prefill_attention": lambda: ka.paged_prefill_attention(
            pq[:1].transpose(0, 1), kp, vp, tb[0], 0),
        "ssd": lambda: km.ssd(sx, sdt, sa, sb, sc, initial_state=si),
    }
    kernels.reset_launch_counts()
    raised = []
    for name, call in entries.items():
        try:
            call()
        except TypeError as e:
            if "DTensor" in str(e):
                raised.append(name)
                continue
            raise
        fail(f"{name} took a DTensor operand without raising")
    if any(kernels.launch_counts().values()):
        fail(f"a DTensor reached a launch: {kernels.launch_counts()}")
    log(f"sharded context on the (1, 1) mesh: {', '.join(out)} bit for bit "
        f"the unsharded calls, one launch each; a DTensor at each of "
        f"{len(raised)} kernel entries raised TypeError ({', '.join(raised)})")
    return {"ops": out, "entries_raise": raised}


def run_mesh_phase(torch, smi):
    """Phase 18 (module docstring): the dry run started first in its own
    process, then (a) and (b) on a (1, 1) ``("data", "model")`` mesh over
    a one-rank NCCL group in this process, destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    proc, outdir, t_dry = start_dryrun()
    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(_free_port())
    dist.init_process_group("nccl", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
        train = mesh_train_step(torch, mesh, smi)
        torch.cuda.empty_cache()
        ops = mesh_ctx_ops(torch, mesh)
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()
    dry = finish_dryrun(proc, outdir, t_dry)
    wall = time.perf_counter() - t_phase
    log(f"phase 18 (multi-device): {wall:.1f} s wall on {smi}")
    return {"train": train, "ctx": ops, "dryrun": dry, "wall_s": wall}


# ---------------------------------------------------------------------------
# phase 19: multi-device, the rest -- the grouped MoE dispatch, micro-
# batches under a mesh and the GPipe stage loop, on one card
# ---------------------------------------------------------------------------
GROUPED_PREFILL = (2, 512)       # granite prefill batch x tokens
GROUPED_LAYER_TOKENS = 1024      # one MoE layer's loss and gradients
ACCUM = 4                        # micro-batches of 1 x TRAIN_SEQ
PIPE_MICRO = 4


def _bf16_ctx():
    from repro_torch.core.config import GemminiConfig
    from repro_torch.core.context import ExecutionContext
    return ExecutionContext(cfg=GemminiConfig(
        input_dtype="bf16", acc_dtype="fp32", output_dtype="bf16"))


def _nonzero(counts):
    return {k: v for k, v in counts.items() if v}


def mesh_grouped_moe(torch, mesh):
    """(a) Full-width granite-moe-3b-a800m (bf16, weights from seed 0,
    laid out by ``param_specs``) on the (1, 1) mesh: ``make_prefill_step``
    over 2 x 512 tokens with ``moe_grouped_dispatch`` off and on, and one
    MoE layer's loss (mean of y^2 in fp32) and gradients (the input and
    every weight) at 1 x 1024 tokens with the capacity bound, off and on:
    bit for bit, the same launches. The grid is (1, 1): the grouped path
    runs with one group."""
    from torch.distributed.tensor import DTensor
    from repro_torch import configs, kernels
    from repro_torch.core import flags
    from repro_torch.core import tree as tu
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.models import moe
    from repro_torch.models import transformer as tf

    cfg = configs.get(MOE_ARCH)
    sctx = _bf16_ctx().with_mesh(mesh, shd.data_axis(mesh))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = tf.init_params(gen, cfg, device="cuda")
    params = shd.distribute_tree(params, shd.param_specs(params, mesh), mesh)
    b, t = GROUPED_PREFILL
    toks = torch.randint(0, cfg.vocab, (b, t), generator=gen,
                         device="cuda", dtype=torch.int32)
    batch = {"tokens": shd.distribute(toks, shd.tokens_spec(mesh, b),
                                      mesh)}
    prefill = steps.make_prefill_step(sctx, cfg, mesh)
    out, counts, walls = {}, {}, {}
    try:
        for grouped in (0, 1):
            flags.set_flag("moe_grouped_dispatch", grouped)
            with mesh_lib.activate_mesh(mesh):
                grid = moe._dispatch_grid(b, t)
            if grid != ((1, (1, 1)) if grouped else (1, None)):
                fail(f"grouped dispatch {grouped}: grid {grid}")
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            out[grouped] = prefill(params, batch).full_tensor()
            torch.cuda.synchronize()
            walls[grouped] = time.perf_counter() - t0
            counts[grouped] = _nonzero(kernels.launch_counts())
        if not torch.equal(out[0], out[1]) or counts[0] != counts[1] or \
                not counts[1].get("gemm[fp32]"):
            fail(f"{MOE_ARCH} grouped prefill: bit for bit "
                 f"{torch.equal(out[0], out[1])}, launches off {counts[0]}"
                 f" on {counts[1]}")

        layer = tu.tree_map(lambda v: v[0], params["blocks"]["moe"])
        x = torch.randn((1, GROUPED_LAYER_TOKENS, cfg.d_model),
                        generator=gen, device="cuda").to(cfg.dtype)
        xd = shd.distribute(x, shd.P("data", "model", None), mesh)
        layer_out, layer_counts = {}, {}
        for grouped in (0, 1):
            flags.set_flag("moe_grouped_dispatch", grouped)
            leaves = [v.detach().requires_grad_(True)
                      for v in [xd] + tu.leaves(layer)]
            lp = tu.unflatten(layer, leaves[1:])
            kernels.reset_launch_counts()
            with steps._mesh_scope(mesh):
                y = moe.moe_apply(sctx, lp, leaves[0],
                                  n_experts=cfg.n_experts, top_k=cfg.top_k,
                                  capacity_factor=cfg.capacity_factor,
                                  activation=cfg.activation)
                loss = (y.to(torch.float32) ** 2).mean()
                grads = torch.autograd.grad(loss, leaves)
            torch.cuda.synchronize()
            layer_counts[grouped] = _nonzero(kernels.launch_counts())
            layer_out[grouped] = [loss.detach().full_tensor()] + [
                g.full_tensor() if isinstance(g, DTensor) else g
                for g in grads]
    finally:
        flags.reset()
    differ = [i for i, (a, c) in enumerate(zip(layer_out[0], layer_out[1]))
              if not torch.equal(a, c)]
    if differ or layer_counts[0] != layer_counts[1]:
        fail(f"{MOE_ARCH} grouped MoE layer: outputs {differ} differ "
             f"(0 the loss, 1 the input's gradient), launches off "
             f"{layer_counts[0]} on {layer_counts[1]}")
    log(f"{MOE_ARCH} on the (1, 1) mesh, moe_grouped_dispatch off / on: "
        f"prefill {b} x {t} last logits bit for bit, launches {counts[1]}"
        f" both, walls {walls[0]:.3f} / {walls[1]:.3f} s; one MoE layer at"
        f" 1 x {GROUPED_LAYER_TOKENS}: loss "
        f"{float(layer_out[1][0]):.6f} and all {len(layer_out[1]) - 1} "
        f"gradients bit for bit, launches {layer_counts[1]} both")
    return {"prefill_launches": counts[1], "prefill_walls_s": walls,
            "layer_launches": layer_counts[1],
            "layer_loss": float(layer_out[1][0])}


def mesh_grad_accum(torch, mesh, smi):
    """(b) Two sharded ``make_train_step`` steps of full-width gemma3-1b
    with ``grad_accum`` = ACCUM (batches of ACCUM x TRAIN_SEQ from
    ``SyntheticLM`` seed 0, micro-batches of 1 x TRAIN_SEQ) on the (1, 1)
    mesh against two unsharded ``grad_accum`` steps: losses, gradient
    norms, parameters, m and v bit for bit; the GEMM launches equal and
    ACCUM x ``train_gemm_launches`` a step."""
    from repro_torch import configs, kernels
    from repro_torch.core import tree as tu
    from repro_torch.data import (SyntheticLM, SyntheticLMConfig, make_batch,
                                  make_global_batch)
    from repro_torch.launch import sharding as shd
    from repro_torch.launch import steps
    from repro_torch.optim import adamw

    cfg = configs.get(TRAIN_ARCH)
    ctx = _bf16_ctx()
    sctx = ctx.with_mesh(mesh, shd.data_axis(mesh))
    opt = adamw.AdamWConfig(lr=TRAIN_LR)
    gen = SyntheticLM(SyntheticLMConfig(vocab=cfg.vocab, seq=TRAIN_SEQ,
                                        global_batch=ACCUM, seed=0))
    tspec = shd.tokens_spec(mesh, ACCUM)
    runs = {}
    for name, step, state, batch in (
            ("unsharded", steps.make_train_step(ctx, cfg, opt,
                                                grad_accum=ACCUM),
             lambda: steps.init_train_state(cfg, seed=0, device="cuda"),
             lambda i: make_batch(gen, i, "cuda")),
            ("sharded", steps.make_train_step(sctx, cfg, opt, mesh,
                                              grad_accum=ACCUM),
             lambda: steps.init_train_state(cfg, seed=0, device="cuda",
                                            mesh=mesh),
             lambda i: make_global_batch(gen, i, mesh, tspec))):
        st = state()
        metrics, walls = [], []
        kernels.reset_launch_counts()
        for i in range(MESH_STEPS):
            t0 = time.perf_counter()
            st, m = step(st, batch(i))
            metrics.append((m["loss"].item(), m["grad_norm"].item()))
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        runs[name] = (st, metrics, walls, _nonzero(kernels.launch_counts()))
        if name == "unsharded":
            continue
        want = {k: MESH_STEPS * ACCUM * v
                for k, v in train_gemm_launches(cfg).items()}
        su, mu, _, cu = runs["unsharded"]
        if runs[name][3] != cu or cu != want:
            fail(f"grad_accum steps launched sharded {runs[name][3]}, "
                 f"unsharded {cu}, want {want}")
        if metrics != mu:
            fail(f"grad_accum steps: (loss, grad norm) sharded {metrics}, "
                 f"unsharded {mu}")
        differ = []
        for part, ts, tu_ in (("params", st.params, su.params),
                              ("m", st.opt["m"], su.opt["m"]),
                              ("v", st.opt["v"], su.opt["v"])):
            ref = dict(tu.flatten_with_paths(tu_))
            differ += [f"{part}/{p}" for p, x in tu.flatten_with_paths(ts)
                       if not torch.equal(x.full_tensor(), ref[p])]
        if differ:
            fail(f"grad_accum steps: {len(differ)} leaves differ, e.g. "
                 f"{differ[:4]}")
        del su
    st, metrics, walls_s, counts = runs["sharded"]
    walls_u = runs["unsharded"][2]
    log(f"{TRAIN_ARCH} grad_accum={ACCUM} on the (1, 1) mesh ({ACCUM} "
        f"micro-batches of 1 x {TRAIN_SEQ}): {MESH_STEPS} steps, (loss, "
        f"grad norm) {metrics} bit for bit the unsharded steps', and every "
        f"parameter, m and v leaf; launches {counts} both; walls sharded "
        f"{', '.join(f'{w:.3f}' for w in walls_s)} s, unsharded "
        f"{', '.join(f'{w:.3f}' for w in walls_u)} s ({smi})")
    return {"metrics": metrics, "launches": counts, "walls_s": walls_s,
            "walls_u": walls_u}


def mesh_pipeline(torch):
    """(c) gemma3-1b's 26 blocks (full width, bf16, weights from seed 0)
    through ``pipeline_loss_fn`` at S = 1 on a ``("stage",)`` mesh, the
    stage parameters DTensors split over it, PIPE_MICRO micro-batches of
    1 x TRAIN_SEQ (phase (b)'s first batch), against the same blocks
    applied micro-batch by micro-batch with no stage loop: the loss and
    every gradient leaf bit for bit, the same GEMM launches."""
    from repro_torch import configs, kernels
    from repro_torch.core import tree as tu
    from repro_torch.data import SyntheticLM, SyntheticLMConfig, make_batch
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import pipeline as pp
    from repro_torch.launch import sharding as shd

    cfg = configs.get(TRAIN_ARCH)
    ctx = _bf16_ctx()
    smesh = mesh_lib.make_mesh((1,), ("stage",))
    gen = torch.Generator(device="cuda").manual_seed(0)
    from repro_torch.models import transformer as tf
    params = tf.init_params(gen, cfg, device="cuda")
    stages = pp.split_stages(params.pop("blocks"), 1)
    toks = make_batch(SyntheticLM(SyntheticLMConfig(
        vocab=cfg.vocab, seq=TRAIN_SEQ, global_batch=PIPE_MICRO, seed=0)),
        0, "cuda")["tokens"]

    def leaves_of(dist_stages):
        rest = tu.tree_map(lambda v: v.detach().requires_grad_(True), params)
        st = tu.tree_map(
            lambda v: (shd.distribute(v, shd.P("stage"), smesh)
                       if dist_stages else v).detach().requires_grad_(True),
            stages)
        return rest, st

    runs = {}
    for name in ("pipeline", "no stage loop"):
        rest, st = leaves_of(name == "pipeline")
        leaves = tu.leaves(rest) + tu.leaves(st)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        if name == "pipeline":
            loss = pp.pipeline_loss_fn(*pp.transformer_stage_fns(
                ctx, cfg, smesh))(dict(rest, stages=st), toks, toks,
                                  mesh=smesh, n_micro=PIPE_MICRO)
        else:
            stage_fn, embed_fn, unembed_loss_fn = \
                pp.transformer_stage_fns(ctx, cfg)
            p = dict(rest, stages=st)
            h = embed_fn(p, toks)
            hm = h.reshape(PIPE_MICRO, -1, *h.shape[1:])
            sp = tu.tree_map(lambda v: v[0], st)
            y = torch.stack([stage_fn(p, sp, hm[i])
                             for i in range(PIPE_MICRO)])
            loss = unembed_loss_fn(p, y.reshape(-1, *y.shape[2:]), toks)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        grads = [g.full_tensor() if hasattr(g, "full_tensor") else g
                 for g in grads]
        runs[name] = (loss.detach(), grads, _nonzero(kernels.launch_counts()),
                      wall)
        del rest, st, leaves, loss
    (lp, gp, cp, wp), (lr_, gr, cr, wr) = runs["pipeline"], \
        runs["no stage loop"]
    differ = [i for i, (a, b) in enumerate(zip(gp, gr))
              if not torch.equal(a, b)]
    if not torch.equal(lp, lr_) or differ or cp != cr or \
            not cp.get("gemm[bwd]"):
        fail(f"pipeline at S = 1: loss {float(lp)} vs {float(lr_)}, "
             f"{len(differ)} gradient leaves differ, launches {cp} vs {cr}")
    log(f"{TRAIN_ARCH} {cfg.n_layers} blocks through pipeline_loss_fn at S ="
        f" 1 on the (stage,) mesh, {PIPE_MICRO} micro-batches of 1 x "
        f"{TRAIN_SEQ}: loss {float(lp):.6f} and all {len(gp)} gradient "
        f"leaves bit for bit the blocks applied micro-batch by micro-batch;"
        f" launches {cp} both; walls {wp:.3f} / {wr:.3f} s")
    return {"loss": float(lp), "launches": cp, "wall_s": wp,
            "wall_reference_s": wr}


def run_mesh_rest_phase(torch, smi):
    """Phase 19 (module docstring): (a)-(c) over a one-rank NCCL group,
    destroyed at the end."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib

    t_phase = time.perf_counter()
    os.environ["MASTER_ADDR"] = "127.0.0.1"
    os.environ["MASTER_PORT"] = str(_free_port())
    dist.init_process_group("nccl", rank=0, world_size=1,
                            device_id=torch.device("cuda", 0))
    out = {}
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"))
        for name, fn in (("grouped_moe", lambda: mesh_grouped_moe(torch,
                                                                   mesh)),
                         ("grad_accum", lambda: mesh_grad_accum(torch, mesh,
                                                                 smi)),
                         ("pipeline", lambda: mesh_pipeline(torch))):
            t0 = time.perf_counter()
            out[name] = dict(fn(), wall_phase_s=time.perf_counter() - t0)
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    wall = time.perf_counter() - t_phase
    parts = ", ".join(f"{k} {v['wall_phase_s']:.1f} s"
                      for k, v in out.items())
    log(f"phase 19 (multi-device, the rest): {wall:.1f} s wall ({parts}) "
        f"on {smi}")
    return dict(out, wall_s=wall)


def ptxas_summary(lines, names) -> str:
    """Per kernel name: its instantiations, their register range and the
    most spill bytes any of them has, from ``-Xptxas=-v`` lines (an entry
    line, its spill line, its register line)."""
    import re

    out = []
    for name in names:
        regs, spills = [], []
        for i, ln in enumerate(lines):
            if "entry function" not in ln or name not in ln:
                continue
            block = " ".join(lines[i + 1:i + 3])
            r = re.search(r"Used (\d+) registers", block)
            if r:
                regs.append(int(r.group(1)))
            spills.append(sum(int(v) for v in re.findall(
                r"(\d+) bytes spill", block)))
        if regs:
            out.append(f"{name} x{len(regs)}: {min(regs)}-{max(regs)} "
                       f"registers, spills up to {max(spills)} bytes")
    return "; ".join(out) or "no entries"


# ---------------------------------------------------------------------------
# phase 20: the remaining datapaths -- fp16 served at full width, and the
# GEMM, conv and epilogue on every dtype combination JAX accepts
# ---------------------------------------------------------------------------
DT_NAMES = ("int8", "int16", "int32", "bfloat16", "float16", "float32")
_BITS = {"int8": 8, "int16": 16, "int32": 32, "bfloat16": 16,
         "float16": 16, "float32": 32}
_ULP = {"bfloat16": 2.0 ** -7, "float16": 2.0 ** -10, "float32": 1e-5}


def jax_raises(a: str, b: str, acc: str) -> bool:
    ints = a.startswith("int") and b.startswith("int")
    return ints and _BITS[acc] < max(_BITS[a], _BITS[b])


def hold_any(torch, name, got, want, floats, mag=None):
    """``got`` against the plain version's ``want`` by the datapath rule of
    tests/test_torch_dtypes.py: bit for bit where ``floats`` is empty (the
    product sums in an integer dtype), else NaNs and infinities in the same
    places and the rest within the coarsest float's rule (fp32 1e-5
    relative + 1e-6 of the largest magnitude; bf16 / fp16 one ulp + 2^-14
    of it), an integer output one count more. ``mag``: each value's
    magnitude before the bias, the activation and the output's saturation,
    |A @ B| + |bias| over 2^shift: a sum rounded to a narrow accumulator
    errs relative to it, and a bias that cancels it, a clip to int8 / int16
    or an fp16 overflow hide it; the sum and the bias add each round in
    the accumulator's dtype, either side of the plain version's, so a
    value may differ by two of its ulps. Returns the max abs error."""
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{name}: {got.dtype} {tuple(got.shape)} != {want.dtype} "
             f"{tuple(want.shape)}")
    g, w = got.double(), want.double()
    if not floats:
        if not torch.equal(g.nan_to_num(), w.nan_to_num()) or \
                not torch.equal(g.isnan(), w.isnan()):
            fail(f"{name}: differs from the plain version, max abs err "
                 f"{(g - w).abs().nan_to_num().max().item():.3e}")
        return 0.0
    odd = w.isnan() | w.isinf()
    if not torch.equal(g.isnan(), w.isnan()) or \
            not torch.equal(g.isinf(), w.isinf()) or \
            not torch.equal(g[w.isinf()], w[w.isinf()]):
        fail(f"{name}: NaN / inf places differ from the plain version's")
    ref = w.abs() if mag is None else torch.maximum(
        w.abs(), mag.double().expand(w.shape))
    g, w, ref = g[~odd], w[~odd], ref[~odd]
    if g.numel() == 0:
        return 0.0
    scale = ref.max().item()
    rtol = max(_ULP[f] for f in floats)
    atol = (1e-6 if rtol == 1e-5 else 2.0 ** -14) * scale + \
        (0.0 if got.is_floating_point() else 1.0)
    if mag is not None:
        rtol *= 2
    err = (g - w).abs()
    bad = err > rtol * ref + atol
    if bad.any():
        fail(f"{name}: {int(bad.sum())} of {bad.numel()} outside the rule; "
             f"max abs err {err.max().item():.3e} (scale {scale:.3e})")
    return err.max().item()


def float_route(torch, a, b, acc, out):
    from repro_torch.kernels.ref import product_dtypes

    dot = str(product_dtypes(getattr(torch, a), getattr(torch, b),
                             getattr(torch, acc))).split(".")[-1]
    if dot.startswith("int"):
        return ()
    return tuple(d for d in (dot, acc, out) if not d.startswith("int"))


def draw_operand(torch, gen, name, shape, k=1):
    """Integers uniform in +-2^(bits - 2) (int32: +-2^16); floats N(0, 1),
    the weights' scaled by k^-1/2."""
    if name.startswith("int"):
        lim = {"int8": 64, "int16": 2 ** 14, "int32": 2 ** 16}[name]
        return torch.randint(-lim, lim, shape, generator=gen, device="cuda",
                             dtype=getattr(torch, name))
    return (torch.randn(shape, generator=gen, device="cuda") * k ** -0.5
            ).to(getattr(torch, name))


def fp16_serving(torch, np, smi):
    """(a): gemma3-1b at fp16 on phase 4's traffic (and phase 4b's decode
    step and prefill chunk profiled), one static-path request
    as phase 10 makes it, and hymba-1.5b at phase 8's 700 + 200 tokens
    (``F16_HYMBA_LAYERS`` of its layers), each at published widths with random
    weights from seed 0 on the fp16 engine config, each run's launch counts
    zeroed just before it and read just after. A full-width prompt's fresh
    prefill logits are held by ``hold_bf16`` at fp16; where the CPU's own fp16
    logits are not finite the arch is not servable in fp16 with these weights,
    which is logged and fails nothing."""
    from repro_torch import kernels

    counts, out, servable = {}, {}, []

    def add(c):
        for k_, v in c.items():
            counts[k_] = counts.get(k_, 0) + v

    def hold(engine, prompt, name):
        card, cpu = prefill_logits(torch, engine, prompt)
        if not torch.isfinite(cpu).all():
            log(f"{name}: the CPU's own fp16 logits at full width are not "
                f"finite: not servable in fp16 with these weights")
            return None
        if not torch.isfinite(card).all():
            fail(f"{name}: the card's fp16 logits are not finite where the "
                 f"CPU's are")
        exact = prefill_logits(torch, engine, prompt, fp32=True,
                               cpu_only=True)
        return hold_bf16(name, card, cpu, exact, dtype="fp16")

    engine, prompts, c, _, s = serve_family(torch, np, "gemma3-1b",
                                            SERVE_PROMPTS, SERVE_NEW,
                                            fp16=True)
    add(c)
    for kname in ("flash_attention[fp16]", "paged_prefill_attention[fp16]",
                  "paged_decode_attention[fp16]", "gemm[fp16]"):
        if c[kname] <= 0:
            fail(f"fp16 gemma3-1b: {kname} did not launch: {c}")
    log(f"fp16 gemma3-1b serve on {smi}: {s['tokens_per_s']:.2f} tok/s, "
        f"TTFT p50 {s['p50_ttft_s'] * 1e3:.1f} ms p99 "
        f"{s['p99_ttft_s'] * 1e3:.1f} ms, ITL p50 {s['p50_itl_s'] * 1e3:.2f} "
        f"ms p95 {s['p95_itl_s'] * 1e3:.2f} ms")
    rel = hold(engine, prompts[-1][:F16_HOLD_TOKENS], "fp16 gemma3-1b")
    if rel is not None:
        servable.append("gemma3-1b")
    # phase 4b's two steps, profiled, at fp16
    out["gemma3-1b"] = {"summary": s, "logits_rel_l2": rel,
                        "profile": run_profile_phase(torch, engine)}

    cfg = engine.model_cfg
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab, (STATIC_PROMPT,)).astype(np.int32)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    toks, logits = static_path(torch, engine.engine, cfg, engine.params,
                               prompt, "cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = kernels.launch_counts()
    add(c)
    want = STATIC_STEPS * cfg.n_layers
    if c["decode_attention[fp16]"] != want:
        fail(f"fp16 static path: decode_attention[fp16] launched "
             f"{c['decode_attention[fp16]']} times, want {want}")
    if "gemma3-1b" in servable and not torch.isfinite(logits).all() or \
            min(toks) < 0 or max(toks) >= cfg.vocab:
        fail(f"fp16 static path: non-finite logits or bad tokens {toks}")
    log(f"fp16 static path gemma3-1b: {STATIC_PROMPT}-token prompt + "
        f"{STATIC_STEPS} steps in {wall:.3f} s; decode_attention[fp16] "
        f"{want} launches")
    out["static"] = {"wall_s": wall, "tokens": toks}
    del engine
    torch.cuda.empty_cache()

    # half depth (16 of 32 layers: the windowed layers and the global one
    # at 16) keeps every kernel of the path and the script inside its limit
    engine, prompts, c, resumed, s = serve_family(
        torch, np, "hymba-1.5b", (700, 200), 16, fp16=True,
        layers=F16_HYMBA_LAYERS)
    add(c)
    for kname in ("ssd[fp16]", "flash_attention[fp16]",
                  "paged_prefill_attention[fp16]",
                  "paged_decode_attention[fp16]"):
        if c[kname] <= 0 or resumed <= 0:
            fail(f"fp16 hymba-1.5b: {kname} did not launch: {c}")
    if c["convert"]:
        fail(f"fp16 hymba-1.5b: {c['convert']} convert launches (the fp16 "
             f"SSD reads its operands as they are)")
    rel = hold(engine, prompts[1][:F16_HOLD_TOKENS], "fp16 hymba-1.5b")
    if rel is not None:
        servable.append("hymba-1.5b")
    out["hymba-1.5b"] = {"summary": s, "logits_rel_l2": rel}
    del engine
    torch.cuda.empty_cache()
    if not servable:
        fail("phase 20: neither gemma3-1b nor hymba-1.5b is servable in fp16")
    out["servable"] = servable
    return counts, out


def generic_matrix(torch, smi):
    """(b): every (input, accumulator, output) combination JAX accepts, on
    the card against the plain version: the quickstart GEMM (1000 x 512 x
    2048, a bias row, shift 1, ReLU) on OS and on WS (equal bit for bit),
    ``accumulator_epilogue`` on every (accumulator, output) pair at (1000,
    512) and at (999, 513), ``conv2d_implicit`` at stage 1's 3x3 (1 x 56 x
    56 x 64 -> 64), and ResNet-50's fused stream on the int32 -> int32 ->
    int32 and bf16 -> bf16 -> bf16 instances on all three routes; launch
    counts zeroed just before and read just after. Then a representative
    combination of each mechanism timed beside its plain version."""
    from repro_torch import kernels
    from repro_torch.core.config import Activation, Dataflow, GemminiConfig
    from repro_torch.core.generator import elaborate
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels import epilogue as epi
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import conv2d_ref, gemm_ref

    gen = torch.Generator(device="cuda").manual_seed(20)
    relu = Activation.RELU
    m, n, k = 1000, 512, 2048
    ops = {d: (draw_operand(torch, gen, d, (m, k)),
               draw_operand(torch, gen, d, (k, n), k)) for d in DT_NAMES}
    bias = torch.randn((1, n), generator=gen, device="cuda") * 100
    xs = {d: (draw_operand(torch, gen, d, (1, 56, 56, 64)),
              draw_operand(torch, gen, d, (3, 3, 64, 64), 9 * 64))
          for d in DT_NAMES}
    cbias = torch.randn((64,), generator=gen, device="cuda") * 100
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    n_gemm = n_conv = n_epi = 0
    worst = {}
    for i in DT_NAMES:
        a, b = ops[i]
        x, w = xs[i]
        for acc in DT_NAMES:
            if jax_raises(i, i, acc):
                continue
            for out in DT_NAMES:
                kw = dict(acc_dtype=getattr(torch, acc),
                          out_dtype=getattr(torch, out), shift=1,
                          activation=relu)
                floats = float_route(torch, i, i, acc, out)
                wide = dict(kw, out_dtype=torch.float32,
                            activation=Activation.NONE)
                mag = gemm_ref(a, b, None, **wide).abs() + bias.abs() / 2 \
                    if floats else None
                want = gemm_ref(a, b, bias, **kw)
                got = {df: kg.gemm(a, b, bias, dataflow=Dataflow[df], **kw)
                       for df in ("OS", "WS")}
                label = f"{i} -> {acc} -> {out}"
                if not torch.equal(got["OS"].view(torch.uint8),
                                   got["WS"].view(torch.uint8)):
                    fail(f"gemm [{label}]: OS and WS differ")
                e = hold_any(torch, f"gemm [{label}]", got["OS"], want,
                             floats, mag)
                worst[label] = e
                n_gemm += 2
                mag = conv2d_ref(x, w, None, stride=1, padding=1, **wide) \
                    .abs() + cbias.abs() / 2 if floats else None
                want = conv2d_ref(x, w, cbias, stride=1, padding=1, **kw)
                got = kc.conv2d_implicit(x, w, cbias, stride=1, padding=1,
                                         **kw)
                hold_any(torch, f"conv2d_implicit [{label}]", got, want,
                         floats, mag)
                n_conv += 1
    for acc in DT_NAMES:
        for out in DT_NAMES:
            for shape in ((1000, 512), EPILOGUE_ODD):
                acc_t = draw_operand(torch, gen, acc, shape) if \
                    acc.startswith("int") else \
                    torch.randn(shape, generator=gen, device="cuda").mul(
                        40).to(getattr(torch, acc))
                kw = dict(out_dtype=getattr(torch, out), shift=1,
                          activation=relu)
                hold_any(torch, f"accumulator_epilogue [{acc} -> {out} "
                         f"{shape}]", kg.accumulator_epilogue(acc_t, **kw),
                         epi.apply(acc_t, **kw), ())
                n_epi += 1
    streams = {}
    for name, (i, a_, o) in (("int32", ("int32", "int32", "int32")),
                             ("bf16", ("bf16", "bf16", "bf16"))):
        inst = elaborate(GemminiConfig(dataflow=Dataflow.BOTH, input_dtype=i,
                                       acc_dtype=a_, output_dtype=o))
        cfg = inst.cfg
        shift = 1 if cfg.input_torch.is_floating_point else 10
        layers = resnet50_layers(torch, seed=1, dtype=cfg.input_torch)
        floats = float_route(torch, *(str(t).split(".")[-1] for t in (
            cfg.input_torch, cfg.input_torch, cfg.acc_torch,
            cfg.output_torch)))
        outs = {}
        for route in ENGINE_ROUTES:
            outs[route] = run_stream(inst, layers, shift, route)
            torch.cuda.synchronize()
            for (label, x, w, b, st, p, act), got in zip(layers,
                                                         outs[route]):
                want = conv2d_ref(x, w, b, stride=st, padding=p,
                                  acc_dtype=cfg.acc_torch,
                                  out_dtype=cfg.output_torch, shift=shift,
                                  activation=act)
                mag = (conv2d_ref(x, w, None, stride=st, padding=p,
                                  acc_dtype=cfg.acc_torch,
                                  out_dtype=torch.float32, shift=shift).abs()
                       + b.float().abs() / 2 ** shift) if floats else None
                hold_any(torch, f"resnet50 {name} [{route}] layer {label}",
                         got, want, floats, mag)
        for got_os, got_ws in zip(*(outs[r] for r in ENGINE_ROUTES[:2])):
            if not torch.equal(got_os, got_ws):
                fail(f"resnet50 {name}: OS and WS outputs differ")
        streams[name] = {"instance": cfg.describe(), "layers": len(layers)}
        log(f"resnet50 {name} ({cfg.describe()}): all three routes within "
            f"the rule of conv2d_ref, OS == WS")
        del outs
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    for kname in kernels.GENERIC_KERNELS:
        if counts[kname] <= 0:
            fail(f"kernel {kname} was not launched on phase 20's matrix")
    log(f"phase 20 matrix: {n_gemm} GEMM calls, {n_conv} convs, {n_epi} "
        f"epilogues and two 50-layer streams held in {wall:.1f} s; launch "
        f"counts {kernels_nonzero(counts)}")

    timer = Timer(torch)
    mech = {}
    reps = {
        "(a) bf16 -> bf16 -> bf16 (hgemm + epilogue[any])":
            ("bfloat16", "bfloat16", "bfloat16", "bfloat16"),
        "(b) int32 -> int32 -> int8 (gemm[int32], fused)":
            ("int32", "int32", "int32", "int8"),
        "(a) int8 -> int16 -> int8 (igemm + epilogue[any])":
            ("int8", "int8", "int16", "int8"),
        "(d) int8 @ fp16 -> fp32 -> fp32 (convert x2 + sgemm + epilogue)":
            ("int8", "float16", "float32", "float32"),
        "(a) fp32 -> fp16 -> fp16 (sgemm + epilogue[any])":
            ("float32", "float32", "float16", "float16")}
    for label, (ia, ib, acc, out) in reps.items():
        a, b = ops[ia][0], ops[ib][1]
        kw = dict(acc_dtype=getattr(torch, acc),
                  out_dtype=getattr(torch, out), shift=1, activation=relu)
        before = kernels.launch_counts()
        kg.gemm_os(a, b, bias, **kw)
        torch.cuda.synchronize()
        launched = {k_: v - before[k_]
                    for k_, v in kernels.launch_counts().items()
                    if v != before[k_]}
        ms = timer(lambda: kg.gemm_os(a, b, bias, **kw))
        plain = timer(lambda: gemm_ref(a, b, bias, **kw))
        bytes_ = (a.element_size() * m * k + b.element_size() * k * n +
                  4 * n + torch.empty((), dtype=getattr(torch, out))
                  .element_size() * m * n)
        dot = float_route(torch, ia, ib, acc, out)
        kind = {"bfloat16": "bf16", "float16": "fp16", "float32": "fp32"}\
            .get(dot[0] if dot else "", "int32" if ia == "int32" else "int")
        b_ms, b_by = bound_ms(bytes_, 2.0 * m * n * k, kind)
        mech[label] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                       "bound_by": b_by, "launches": launched,
                       "library_ms": None}
        log(f"phase 20 {label}: {ms:.4f} ms ({launched}) plain "
            f"{plain:.4f} ms bound {b_ms:.4f} ms ({b_by}); library none; "
            f"on {smi}")
    del timer
    return counts, {"gemm_calls": n_gemm, "convs": n_conv,
                    "epilogues": n_epi, "wall_s": wall, "streams": streams,
                    "mechanisms": mech}


def kernels_nonzero(counts):
    return {k_: v for k_, v in counts.items() if v}


def run_fp16_phase(torch, np, smi):
    """Phase 20: (a) ``fp16_serving`` and (b) ``generic_matrix``.
    Returns the launch counts of the fp16 kernels (from (a)'s runs) and of
    the generic datapath's (from (b)'s), and the summary."""
    from repro_torch import kernels

    t0 = time.perf_counter()
    serve_counts, serve = fp16_serving(torch, np, smi)
    matrix_counts, matrix = generic_matrix(torch, smi)
    counts = {k_: serve_counts.get(k_, 0) for k_ in kernels.FP16_KERNELS}
    counts.update({k_: matrix_counts[k_] for k_ in kernels.GENERIC_KERNELS})
    log(f"phase 20 passed in {time.perf_counter() - t0:.1f} s; launch "
        f"counts {counts}")
    return counts, {"serve": serve, "matrix": matrix}


# ---------------------------------------------------------------------------
# phase 21: the last kernel shapes -- any head dim, unaligned operands,
# mixed float dtypes, the SSD's head dim, state and chunk
# ---------------------------------------------------------------------------
SHAPE_DIMS = (48, 80, 96, 200)
SHAPE_SLICED = (320, 640)       # flash and paged prefill in column slices
SHAPES_WALL_S = 60.0
SHAPE_ATTN = ("flash_attention", "paged_prefill_attention",
              "paged_decode_attention", "decode_attention")
SHAPE_REPLACES = {"flash_attention": "src/repro/kernels/attention.py:162",
                  "paged_prefill_attention":
                      "src/repro/kernels/attention.py:558",
                  "paged_decode_attention":
                      "src/repro/kernels/attention.py:418",
                  "decode_attention": "src/repro/kernels/attention.py:276",
                  "ssd": "src/repro/kernels/mamba2.py:151"}


def offset_view(torch, t, off):
    """``t``'s values in a buffer ``off`` elements past a 16-byte boundary:
    a contiguous view whose rows the kernels read element by element."""
    if not off:
        return t
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def sdpa_or_none(fn):
    """The yardstick where this torch's SDPA takes the call, else None."""
    if fn is None:
        return None
    try:                          # the yardstick only, never the port
        fn()
    except RuntimeError as e:
        log(f"scaled_dot_product_attention refused: {e}")
        return None
    return fn


def shape_cases(torch):
    """Phase 21's checked shapes, as ``kernel_cases``' tuples: the four
    attention launchers at head dims 48, 80, 96 and 200 in bf16, fp16 and
    fp32 (flash and paged prefill on a 256-token causal chunk with 32 / 8
    heads, once more with a window and a softcap; paged and dense decode on
    phase 4's four slots); flash and paged prefill at head dims 320 and
    640 in each dtype (column slices: 16-bit on the generic kernel, fp32 of
    the 128 instance, as at 200) and a paged decode at 320 (the fp32
    instance at 512,
    bf16 widened); one view 2 elements past a 16-byte boundary per
    launcher, and 1 past for flash and paged prefill (the generic kernel's
    element copies); both mixed orders per launcher (q bf16
    with k / v fp32, q fp32 with k / v fp16); the SSD at mamba2-1.3b's
    d_inner as 32 heads of P = 128 at N = 256, one 512-token chunk resumed
    (two column slices, two sub-chunks), and at P = 96, in bf16, fp32 and
    fp16 (``ssd16_any.cu``);
    and the SSD with x fp32 / B, C bf16 and x bf16 / B, C fp32. Each
    row's bound takes its inputs' peak (fp32's where an operand is fp32)
    and the SSD's operations at the sub-chunks it runs
    (``launch_chunk``); its check the output dtype's rule."""
    from _ssd_exact import fp32_tolerance, ssd_fp64

    from repro_torch.kernels import attention as ka
    from repro_torch.kernels import contracts as kc
    from repro_torch.kernels import mamba2 as km

    gen = torch.Generator(device="cuda").manual_seed(21)
    bf16, f32, f16 = torch.bfloat16, torch.float32, torch.float16
    KIND = {bf16: "bf16", f32: "fp32", f16: "fp16"}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    h, kvh, page, n_pages = 32, 8, 64, 128
    lengths = [1010, 530, 310, 80]
    cases = []

    def randn(*shape, dtype=bf16, scale=1.0, off=0):
        t = (torch.randn(shape, generator=gen, device="cuda") * scale
             ).to(dtype)
        return offset_view(torch, t, off)

    def route(qd, kd, d, family="decode", off=0):
        """(kernel name suffix, bound kind, label) of a call: the bound
        takes the inputs' own peak, fp32's where an operand is fp32 (a
        16-bit decode widened at D > 256 could run at its 16-bit rate).
        16-bit flash and paged prefill off the compiled instances run the
        generic kernel, ``[any]``."""
        mixed = qd != kd
        widened = mixed or (qd != f32 and d > 256 and family == "decode")
        generic = family != "decode" and qd != f32 and not mixed and \
            (d not in ka.HEAD_DIMS or off)
        name = "[mixed]" if mixed else "[any]" if generic else \
            "[fp16]" if qd == f16 else ""
        label = f"{KIND[qd]}" + (f"/{KIND[kd]}" if mixed else "") + \
            (" widened" if widened else "")
        return name, "fp32" if f32 in (qd, kd) else KIND[qd], label

    def check(kind, name):
        return lambda got, want: check_close(torch, name, got, want, kind)

    def flash(d, qd, kd, window=None, softcap=None, off=0, rep=False):
        t = 256
        q = randn(1, t, h, d, dtype=qd, off=off)
        k, v = (randn(1, t, kvh, d, dtype=kd, off=off) for _ in range(2))
        kw = dict(causal=True, window=window, softcap=softcap)
        pairs = sum(min(i + 1, window or 1 << 30) for i in range(t))
        nbytes = (2 * q.numel() * q.element_size() +
                  2 * k.numel() * k.element_size())
        suffix, bkind, label = route(qd, kd, d, "flash", off)
        lib = None      # SDPA faults on a view off 16 bytes: none there
        if softcap is None and window is None and qd == kd and not off:
            def lib():
                return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), is_causal=True,
                            enable_gqa=True)
        lib = sdpa_or_none(lib)
        full = f"flash_attention{suffix}"
        label = (f"{label} T={t} H={h} KVH={kvh} D={d} window={window} "
                 f"softcap={softcap}" + (f" offset={off}" if off else ""))
        cases.append((full, label, rep, bkind,
                      lambda: ka.flash_attention(q, k, v, **kw),
                      lambda: ka.blockwise_attention(q, k, v, **kw), lib,
                      nbytes, 4.0 * d * h * pairs,
                      dict(check=check(KIND[qd], f"{full} [{label}]"))))

    def prefill(d, qd, kd, window=None, softcap=None, off=0, rep=False):
        t, start, kv_pages = 256, 768, 16
        kp, vp = (randn(kvh, n_pages + 1, page, d, dtype=kd, off=off)
                  for _ in range(2))
        table = torch.randperm(n_pages, generator=gen, device="cuda")[
            :kv_pages].to(torch.int32)
        q = randn(1, t, h, d, dtype=qd, off=off)
        kw = dict(window=window, softcap=softcap)
        pairs = sum(min(start + i + 1, window or 1 << 30) for i in range(t))
        live = start + t if window is None else min(start + t,
                                                    window - 1 + t)
        nbytes = (2 * q.numel() * q.element_size() +
                  2 * live * kvh * d * kp.element_size() + 4 * kv_pages)
        suffix, bkind, label = route(qd, kd, d, "prefill", off)
        full = f"paged_prefill_attention{suffix}"
        label = (f"{label} T={t} start={start} H={h} KVH={kvh} D={d} "
                 f"window={window} softcap={softcap}" +
                 (f" offset={off}" if off else ""))
        cases.append((full, label, rep, bkind,
                      lambda: ka.paged_prefill_attention(q, kp, vp, table,
                                                         start, **kw),
                      lambda: ka.paged_prefill_attention_plain(
                          q, kp, vp, table, start, **kw), None,
                      nbytes, 4.0 * d * h * pairs,
                      dict(check=check(KIND[qd], f"{full} [{label}]"))))

    def paged_decode(d, qd, kd, off=0, rep=False):
        s, mp = len(lengths), 32
        kp, vp = (randn(kvh, n_pages + 1, page, d, dtype=kd, off=off)
                  for _ in range(2))
        tables = torch.randperm(n_pages, generator=gen, device="cuda")[
            :s * mp].reshape(s, mp).to(torch.int32)
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        q = randn(s, 1, h, d, dtype=qd, off=off)
        live = sum(lengths)
        nbytes = (2 * q.numel() * q.element_size() +
                  2 * live * kvh * d * kp.element_size() + 4 * s * (mp + 1))
        suffix, bkind, label = route(qd, kd, d)
        full = f"paged_decode_attention{suffix}"
        label = (f"{label} S={s} lengths={lengths} H={h} KVH={kvh} D={d}" +
                 (f" offset={off}" if off else ""))
        cases.append((full, label, rep, bkind,
                      lambda: ka.paged_decode_attention(q, kp, vp, tables,
                                                        lens),
                      lambda: ka.paged_decode_attention_plain(
                          q, kp, vp, tables, lens), None,
                      nbytes, 4.0 * d * h * live,
                      dict(check=check(KIND[qd], f"{full} [{label}]"))))

    def dense_decode(d, qd, kd, off=0, rep=False):
        b, smax = len(lengths), max(lengths)
        pos = smax - 1
        q = randn(b, 1, h, d, dtype=qd, off=off)
        k, v = (randn(b, smax, kvh, d, dtype=kd, off=off) for _ in range(2))
        nbytes = (2 * q.numel() * q.element_size() +
                  2 * k.numel() * k.element_size())
        suffix, bkind, label = route(qd, kd, d)
        lib = None
        if qd == kd and not off:
            def lib():
                return sdpa(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), enable_gqa=True)
        lib = sdpa_or_none(lib)
        full = f"decode_attention{suffix}"
        label = (f"{label} B={b} S={smax} pos={pos} H={h} KVH={kvh} D={d}" +
                 (f" offset={off}" if off else ""))
        cases.append((full, label, rep, bkind,
                      lambda: ka.decode_attention(q, k, v, pos),
                      lambda: ka.decode_attention_plain(q, k, v, pos), lib,
                      nbytes, 4.0 * d * h * b * smax,
                      dict(check=check(KIND[qd], f"{full} [{label}]"))))

    for d in SHAPE_DIMS:
        for dt in (bf16, f16, f32):
            rep = d == 200 and dt == bf16       # the generic kernel's rows
            flash(d, dt, dt, rep=rep)
            prefill(d, dt, dt, rep=rep)
            paged_decode(d, dt, dt)
            dense_decode(d, dt, dt)
        flash(d, bf16, bf16, window=128, softcap=30.0)
        prefill(d, bf16, bf16, window=128, softcap=30.0)
    for d in SHAPE_SLICED:
        for dt in (bf16, f16, f32):
            flash(d, dt, dt)
            prefill(d, dt, dt)
    for dt in (bf16, f32):
        paged_decode(320, dt, dt)
    # a view 2 elements in per launcher (head dim 128: the alignment alone
    # decides the route; 16-bit flash and paged prefill: the generic
    # kernel's 4-byte copies), 1 in for flash and paged prefill (its
    # element copies)
    for off in (1, 2):
        flash(128, bf16, bf16, off=off)
        prefill(128, bf16, bf16, off=off)
    paged_decode(128, bf16, bf16, off=2)
    dense_decode(128, bf16, bf16, off=2)
    for qd, kd in ((bf16, f32), (f32, f16)):
        rep = qd == bf16
        flash(128, qd, kd, rep=rep)
        prefill(128, qd, kd, rep=rep)
        paged_decode(128, qd, kd, rep=rep)
        dense_decode(128, qd, kd, rep=rep)

    def ssd(h_, p, n, t, chunk, xd, bd, rep=False):
        x = randn(1, t, h_, p, dtype=xd)
        b, c = (randn(1, t, 1, n, dtype=bd, scale=0.3) for _ in range(2))
        dt = torch.nn.functional.softplus(randn(1, t, h_, dtype=f32))
        a_log = torch.log(torch.linspace(1.0, 16.0, h_, device="cuda"))
        d_skip = torch.ones((h_,), dtype=f32, device="cuda")
        init = randn(1, h_, n, p, dtype=f32, scale=0.5)
        kw = dict(d_skip=d_skip, chunk=chunk, initial_state=init,
                  return_final_state=True)
        mixed = xd != bd
        full = "ssd" + ("[mixed]" if mixed else "[fp16]" if xd == f16 else "")
        label = (f"{KIND[xd]}" + (f"/{KIND[bd]}" if mixed else "") +
                 f" B=1 T={t} H={h_} P={p} G=1 N={n} chunk={chunk} resumed")
        name = f"{full} [{label}]"

        def held(got, want):
            exact_y, exact_s = ssd_fp64(x, dt, a_log, b, c, d_skip=d_skip,
                                        initial_state=init)
            tol = fp32_tolerance(dt, a_log, chunk)
            pairs = [("state", got[1], exact_s)]
            err = 0.0
            if xd == f32:
                pairs.append(("y", got[0], exact_y))
            else:
                err = check_close(torch, name, got[0], want[0], KIND[xd])
            for what, v, ex in pairs:
                e = (v.double() - ex).abs().max().item()
                if not torch.isfinite(v).all() or \
                        e > tol * ex.abs().max().item():
                    fail(f"{name}: {what} err {e:.3e} > {tol:.2e} x "
                         f"{ex.abs().max().item():.3e}")
                err = max(err, e)
            return err

        nbytes = (x.element_size() * 2 * t * h_ * p +
                  b.element_size() * 2 * t * n + 4 * t * h_ + 8 * h_ +
                  4 * 2 * h_ * n * p)
        plan = kc.ssd_contract(1, t, h_, 1, n, p, chunk,
                               dtype=km.kernel_dtype(x, b, c),
                               initial_state=True,
                               final_state=True).plan_dict()
        cases.append((full, label, rep,
                      "fp32" if f32 in (xd, bd) else KIND[xd],
                      lambda: km.ssd(x, dt, a_log, b, c, **kw),
                      lambda: km.ssd_plain(x, dt, a_log, b, c, **kw), None,
                      nbytes, ssd_flops(t, h_, p, 1, n,
                                        km.launch_chunk(chunk, t), True),
                      dict(check=held, grid=(
                          f"{plan['chunks']} launches x {plan['slices']} "
                          f"slices of {plan['first_blocks']} blocks"))))
    for dt in (bf16, f32, f16):
        ssd(32, 128, 256, 512, 512, dt, dt, rep=dt == bf16)
        ssd(32, 96, 128, 256, 256, dt, dt)
    ssd(32, 128, 256, 512, 512, f32, bf16, rep=True)
    ssd(32, 128, 256, 512, 512, bf16, f32)
    return cases


def run_shapes_phase(torch, np):
    """Phase 21: (a) every shape case's kernel call once, the launch counts
    zeroed just before and read just after (the new shapes' main path:
    every wrapper and its fp16 and mixed counts must launch), then each
    checked against its plain version and timed; (b) the port's
    ``ServingEngine`` on the smoke gemma3-1b with head dim 80 and 200, fp32,
    greedy tokens card == CPU (phase 5's check), flash, paged prefill and
    paged decode launched; (c) the port's ``chaos_smoke`` example on the
    card. Held to SHAPES_WALL_S. Returns the launch counts of (a), the rows
    and the representative rows, and the summary."""
    from repro_torch import configs, kernels
    from repro_torch.examples import chaos_smoke

    t0 = time.perf_counter()
    timer = Timer(torch)
    cases = shape_cases(torch)
    kernels.reset_launch_counts()
    for case in cases:
        case[4]()
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    want = [n for n in SHAPE_ATTN] + \
        [f"{n}[fp16]" for n in SHAPE_ATTN[2:]] + list(kernels.ANY_KERNELS) + \
        list(kernels.MIXED_KERNELS) + ["ssd", "ssd[fp16]"]
    for name in want:
        if counts[name] <= 0:
            fail(f"phase 21: {name} launched no time on the shapes' path")
    rows, rep = run_cases(torch, timer, cases)
    del timer, cases
    torch.cuda.empty_cache()

    engine = {}
    for hd in (80, 200):
        cfg = dataclasses.replace(configs.get_smoke("gemma3-1b"),
                                  dtype=torch.float32, head_dim=hd)
        kernels.reset_launch_counts()
        fp32_card_equals_cpu(torch, np, f"gemma3-1b head_dim={hd}", cfg)
        got = {k_: v for k_, v in kernels.launch_counts().items() if v}
        for name in SHAPE_ATTN[:3]:
            if not got.get(name):
                fail(f"phase 21: gemma3-1b at head_dim {hd} launched no "
                     f"{name}")
        engine[hd] = got

    kernels.reset_launch_counts()
    rc = chaos_smoke.main(["--device", "cuda"])
    chaos = {k_: v for k_, v in kernels.launch_counts().items() if v}
    if rc != 0:
        fail(f"phase 21: chaos_smoke returned {rc} on the card")
    wall = time.perf_counter() - t0
    log(f"phase 21 passed in {wall:.1f} s (limit {SHAPES_WALL_S:.0f} s); "
        f"shape launch counts {dict((k_, v) for k_, v in counts.items() if v)}"
        f"; engine {engine}; chaos_smoke 0 with {chaos}")
    if wall > SHAPES_WALL_S:
        fail(f"phase 21 took {wall:.1f} s, over {SHAPES_WALL_S:.0f} s")
    return counts, rows, rep, {"wall_s": wall, "engine_launches": engine,
                               "chaos_launches": chaos, "chaos_rc": rc}


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
    # the redesigned kernels: instantiations, registers and spills per
    # kernel and source (each entry's lines in chip_smoke.json)
    for src, names in (("attention", ("flash_tc_kernel", "flash_f32_kernel",
                                      "decode_split_kernel")),
                       ("attention_any", ("flash_f32_kernel",)),
                       ("attention_wg", ("flash_wg_kernel",)),
                       ("attention_wg16", ("flash_wg_kernel",)),
                       ("attention_decode_any", ("decode_split_kernel",)),
                       ("ssd_any", ("ssd_tc_kernel", "ssd_kernel")),
                       ("ssd16", ("ssd_tc_kernel",)),
                       ("ssd16_any", ("ssd_tc_kernel",)),
                       ("gemm", ("skinny_kernel", "wide_kernel",
                                 "sgemm_kernel", "igemm")),
                       ("gemm16", ("skinny_kernel", "wide_kernel", "igemm")),
                       ("gemm_bwd", ("bwd_kernel",)),
                       ("gemm_bwd16", ("bwd_kernel",)),
                       ("conv", ("igemm", "sgemm_kernel")),
                       ("ssd", ("ssd_tc_kernel", "ssd_kernel")),
                       ("datapath", ("convert_kernel", "epilogue_any_kernel",
                                     "sgemm_kernel"))):
        log(f"ptxas {src}: " + ptxas_summary(ptxas.get(src, []), names))

    if sys.argv[1:] == ["--phase", "17"]:
        contracts = run_contract_phase(torch, secs)
        with open(os.path.join(OUT_DIR, "chip_smoke_contracts.json"),
                  "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi,
                       "contracts": contracts}, f, indent=1, default=str)
        log(f"phases 1, 2 and 17 passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "18"]:
        mesh_summary = run_mesh_phase(torch, smi)
        with open(os.path.join(OUT_DIR, "chip_smoke_mesh.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi,
                       "mesh": mesh_summary}, f, indent=1, default=str)
        log(f"phases 1, 2 and 18 passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "19"]:
        rest_summary = run_mesh_rest_phase(torch, smi)
        with open(os.path.join(OUT_DIR, "chip_smoke_mesh_rest.json"),
                  "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi,
                       "mesh_rest": rest_summary}, f, indent=1, default=str)
        log(f"phases 1, 2 and 19 passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "20"]:
        _, f16_summary = run_fp16_phase(torch, np, smi)
        with open(os.path.join(OUT_DIR, "chip_smoke_fp16.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi,
                       "fp16": f16_summary}, f, indent=1, default=str)
        log(f"phases 1, 2 and 20 passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:] == ["--phase", "21"]:
        _, shape_rows, _, shape_summary = run_shapes_phase(torch, np)
        with open(os.path.join(OUT_DIR, "chip_smoke_shapes.json"), "w") as f:
            json.dump({"device": kind, "nvidia_smi": smi, "build_s": secs,
                       "ptxas": ptxas, "kernels": shape_rows,
                       "shapes": shape_summary}, f, indent=1, default=str)
        log(f"phases 1, 2 and 21 passed in "
            f"{time.perf_counter() - t_start:.1f} s")
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": kind,
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    if sys.argv[1:]:
        fail(f"unknown arguments {sys.argv[1:]}: none, --phase 17, "
             f"--phase 18, --phase 19, --phase 20 or --phase 21")

    # 3. kernels
    timer = Timer(torch)
    rows, rep_rows = run_kernel_phase(torch, timer)
    del timer
    from repro_torch import configs
    serving = [r for r in rows if r["name"] == "gemm" and r["shape"].split()[0]
               in ("wq", "wk", "wv", "wo", "wi", "wg", "mlp.wo", "unembed")]
    gemm_sums = gemm_step_sums(serving, configs.get("gemma3-1b").n_layers)
    for m, sm in sorted(gemm_sums.items()):
        log(f"gemm step sum M={m} (7 projections x {configs.get('gemma3-1b').n_layers}"
            f" layers + unembedding): kernel "
            f"{sm['ms']:.4f} ms  torch.matmul {sm['library_ms']:.4f} ms  "
            f"bound {sm['bound_ms']:.4f} ms")
    torch.cuda.empty_cache()

    # 4. serve at full width (the main path: counts zeroed inside)
    counts, serve_summary, profile, engine, clean = run_serve_phase(torch,
                                                                    np)
    torch.cuda.empty_cache()

    # 5. fp32 end to end, card against CPU
    run_e2e_phase(torch, np)
    torch.cuda.empty_cache()

    # 6. the Gemmini engine path (its own main path: counts zeroed inside)
    engine_counts, engine_summary = run_engine_phase(torch, smi)
    torch.cuda.empty_cache()

    # 6b. the float and 16-bit datapaths on the same stream (their own
    # main path: counts zeroed inside)
    datapath_counts, datapath_summary = run_datapath_phase(torch, smi)
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
    torch.cuda.empty_cache()

    # 11. the robustness envelope and the profiler at full width
    robust = run_robust_phase(torch, np, engine, clean)
    del engine, clean
    torch.cuda.empty_cache()

    # 12. the MoE family at full width (its own main path: counts zeroed
    # inside)
    moe_counts, moe_summary = run_moe_phase(torch, np)
    torch.cuda.empty_cache()

    # 13. one fp32 training step of every arch at smoke size, card vs CPU
    train_smoke = run_train_smoke_phase(torch, np)
    torch.cuda.empty_cache()

    # 14. gemma3-1b trained at full width (the training path's main run:
    # counts zeroed inside)
    train_counts, train_summary = run_train_phase(torch, np)
    torch.cuda.empty_cache()

    # 15. gemma3-4b served at full width
    g4_counts, g4_summary = run_gemma3_4b_phase(torch, np)
    torch.cuda.empty_cache()

    # 16. the kernel-schedule tuner (its own cache, deleted afterwards;
    # every earlier phase ran with tuning off)
    tune_summary = run_tune_phase(torch, np,
                                  profile["decode_step"]["wall_ms"])
    torch.cuda.empty_cache()

    # 17. the launch contracts against the C plans, and every accepted
    # plan launched into guarded outputs
    contracts = run_contract_phase(torch, secs)
    torch.cuda.empty_cache()

    # 18. multi-device: the sharded train step and context on a (1, 1)
    # NCCL mesh (the sharded path's own run: counts zeroed inside), and
    # the 16 x 16 dry run in a subprocess
    mesh_summary = run_mesh_phase(torch, smi)
    torch.cuda.empty_cache()

    # 19. multi-device, the rest: the grouped MoE dispatch, micro-batches
    # under the mesh and the GPipe stage loop (each check zeroes the
    # counts just before it and reads them just after)
    rest_summary = run_mesh_rest_phase(torch, smi)
    torch.cuda.empty_cache()

    # 20. the remaining datapaths: fp16 served at full width, and every dtype
    # combination of the GEMM, conv and epilogue (each run's counts zeroed
    # just before it and read just after)
    f16_counts, f16_summary = run_fp16_phase(torch, np, smi)
    torch.cuda.empty_cache()

    # 21. the last kernel shapes: any head dim, unaligned operands, mixed
    # dtypes, the SSD's head dim, state and chunk (their own path: counts
    # zeroed inside), the engine at new head dims, chaos_smoke on the card
    shape_counts, shape_rows, shape_rep, shape_summary = run_shapes_phase(
        torch, np)
    rep_rows.update({k_: shape_rep[k_] for k_ in kernels.MIXED_KERNELS +
                     kernels.ANY_KERNELS})

    # the kernels line
    meta = {
        "gemm": ("csrc/gemm.cu", "src/repro/kernels/gemm.py:105"),
        "gemm[fp32]": ("csrc/gemm.cu", "src/repro/kernels/gemm.py:105"),
        "flash_attention": ("csrc/attention.cuh",
                            "src/repro/kernels/attention.py:162"),
        "paged_prefill_attention": ("csrc/attention.cuh",
                                    "src/repro/kernels/attention.py:558"),
        "paged_decode_attention": ("csrc/attention.cuh",
                                   "src/repro/kernels/attention.py:418"),
        "gemm[int8]": ("csrc/gemm.cu", "src/repro/kernels/gemm.py:105"),
        "gemm_ws": ("csrc/gemm.cu", "src/repro/kernels/gemm.py:184"),
        "accumulator_epilogue": ("csrc/gemm.cu",
                                 "src/repro/kernels/gemm.py:217"),
        "conv2d_implicit": ("csrc/conv.cu", "src/repro/kernels/conv.py:140"),
        "gemm[fp16]": ("csrc/gemm16.cu", "src/repro/kernels/gemm.py:105"),
        "gemm[int16]": ("csrc/gemm16.cu", "src/repro/kernels/gemm.py:105"),
        **{f"conv2d_implicit[{d}]": ("csrc/conv.cu",
                                     "src/repro/kernels/conv.py:140")
           for d in ("fp32", "bf16", "fp16", "int16")},
        "ssd": ("csrc/ssd.cuh", "src/repro/kernels/mamba2.py:151"),
        "decode_attention": ("csrc/attention.cuh",
                             "src/repro/kernels/attention.py:276"),
        "gemm[bwd]": ("csrc/gemm_bwd.cu", "src/repro/kernels/gemm.py:105"),
        "flash_attention[fp16]": ("csrc/attention.cuh",
                                  "src/repro/kernels/attention.py:162"),
        "paged_prefill_attention[fp16]": (
            "csrc/attention.cuh", "src/repro/kernels/attention.py:558"),
        "paged_decode_attention[fp16]": (
            "csrc/attention.cuh", "src/repro/kernels/attention.py:418"),
        "decode_attention[fp16]": ("csrc/attention.cuh",
                                   "src/repro/kernels/attention.py:276"),
        "ssd[fp16]": ("csrc/ssd16.cu", "src/repro/kernels/mamba2.py:151"),
        "gemm[int32]": ("csrc/datapath.cu", "src/repro/kernels/gemm.py:105"),
        "conv2d_implicit[int32]": ("csrc/conv.cu",
                                   "src/repro/kernels/conv.py:140"),
        "convert": ("csrc/datapath.cu", "src/repro/kernels/gemm.py:105"),
        "epilogue[any]": ("csrc/datapath.cu",
                          "src/repro/kernels/gemm.py:217"),
        **{f"{n}[mixed]": ("csrc/attention.cuh", SHAPE_REPLACES[n])
           for n in SHAPE_ATTN},
        **{f"{n}[any]": ("csrc/attention_wg.cuh", SHAPE_REPLACES[n])
           for n in SHAPE_ATTN[:2]},
        "ssd[mixed]": ("csrc/ssd.cuh", SHAPE_REPLACES["ssd"]),
    }
    line = []
    for name, (src, replaces) in meta.items():
        r = rep_rows[name]
        launches = (shape_counts if name in kernels.MIXED_KERNELS +
                    kernels.ANY_KERNELS else
                    f16_counts if name in f16_counts else
                    datapath_counts if name in DATAPATH_KERNELS else
                    engine_counts if name in kernels.ENGINE_KERNELS else
                    ssm_counts if name in kernels.RECURRENT_KERNELS else
                    static_counts if name in kernels.STATIC_KERNELS else
                    moe_counts if name in kernels.MOE_KERNELS else
                    train_counts if name in kernels.TRAIN_KERNELS else
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
                   "ptxas": ptxas, "kernels": rows,
                   "gemm_step_sums": gemm_sums, "serve": serve_summary,
                   "serve_launches": counts, "profile": profile,
                   "engine": engine_summary,
                   "engine_launches": engine_counts,
                   "datapaths": datapath_summary,
                   "datapath_launches": datapath_counts,
                   "ssm": ssm_summary, "ssm_launches": ssm_counts,
                   "ssm_resumed_ssd_launches": ssm_resumed,
                   "hybrid": hybrid_summary, "hybrid_launches": hybrid_counts,
                   "hybrid_resumed_ssd_launches": hybrid_resumed,
                   "gate_launches": gate_counts,
                   "static": static_summary,
                   "static_launches": static_counts,
                   "robust": robust, "moe": moe_summary,
                   "moe_launches": moe_counts, "train_smoke": train_smoke,
                   "train": train_summary, "train_launches": train_counts,
                   "gemma3_4b": g4_summary, "gemma3_4b_launches": g4_counts,
                   "tune": tune_summary, "contracts": contracts,
                   "mesh": mesh_summary, "mesh_rest": rest_summary,
                   "fp16": f16_summary, "fp16_launches": f16_counts,
                   "shapes": shape_summary, "shape_rows": shape_rows,
                   "shape_launches": shape_counts},
                  f, indent=1, default=str)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": line}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
