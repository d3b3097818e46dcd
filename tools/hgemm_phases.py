"""Where the 16-bit wide GEMM's time goes, phase by phase, on a card.

Builds a copy of ``csrc/hgemm.cuh`` with ``globaltimer`` stamps (thread 0
of every block, at the phase boundaries marked below) into a small library
of its own that stands in for the ``gemm`` and ``gemm16`` libraries'
bf16 / fp16 entry points (bf16 -> bf16 and fp16 -> fp16 outputs only), then
runs the fp16 quickstart GEMM (1000 x 512 x 2048, bias, shift 1, ReLU), the
fp16 host-im2col GEMMs of ResNet-50's stream that take the wide kernel
(``chip_smoke.resnet50_shapes``) and gemma3-1b's bf16 serving GEMMs at M =
64 and 256 (``chip_smoke.gemm_serving_cases``), and prints per shape the
plan, the event time of the copy with its stamps off (``chip_smoke.Timer``:
CUDA events, L2 flushed, median of 25), ``torch.matmul``'s, and the
microseconds from each block's entry at which each phase ended (median
over the blocks that reach it) and the launch's span from its first entry
to its last store:

  python3 tools/hgemm_phases.py
  python3 tools/hgemm_phases.py --sweep   # and the event time of every
                                          # wide plan of the tuner's space

Phases: ``landed`` (the first stage in shared memory), ``loop_end`` (the
last product of the block's k steps), ``staged`` (the block's fp32 tile in
shared memory; with split K, every tile of its cluster), ``done`` (its rows
of the tile finished and stored, every thread). ``--sweep`` times every
tile shape with 1 to 8 K splits, named to the kernel as a caller's plan
(``repro_torch.tune.schedules``). Every output is held against the plain
version (``chip_smoke.check_close``). The stamps cost a few instructions
each, so the phases are the instrumented kernel's. Needs a card and
``nvcc``; builds into ``build/hgemm_phases/``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAMPS = 8
PHASES = ("landed", "loop_end", "staged", "done")

# (anchor in hgemm.cuh, stamp slot, lines of the anchor before the stamp)
MARKS = [
    ("  const int S = p.splits, split = blockIdx.x % S, t = blockIdx.x / S;",
     0, 1),
    ("        mbar_wait(smem_u32(&full[i % ST]), (i / ST) & 1);", 1, 1),
    ("      wgmma_wait<0>();\n    }\n  } else {", 2, 1),
    ("  if (S == 1) {\n    __syncthreads();", 3, 2),
    ("  cluster.sync();\n  finish_rows<Elt, OutT, BM, BN, CLD>(p, cs, "
     "row_bias", 3, 1),
    ("                                        1, 0, BM, m0, n0);\n"
     "    return;", 4, 1),
    ("                                      m0, n0);\n  cluster.sync();", 4,
     1),
]


def named(gemm, sched):
    """``kernels.gemm._gemm`` with its plan forced to ``sched``."""
    def call(*args, **kw):
        kw["plan"] = sched
        return gemm(*args, **kw)
    return call


def stamp(slot: int) -> str:
    guard = "i == 0 && " if slot == 1 else ""
    sync = "  __syncthreads();\n" if slot == 4 else ""
    return (f"{sync}  if ({guard}threadIdx.x == 0 && p.stamps) {{ unsigned "
            "long long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
            f"\"=l\"(t_)); p.stamps[blockIdx.x * {STAMPS} + {slot}] = t_; }}")


def patch(src: str, anchor: str, new: str) -> str:
    if src.count(anchor) != 1:
        raise SystemExit(f"hgemm_phases: anchor not once: {anchor!r}")
    return src.replace(anchor, new)


# The library's entry points: the gemm and gemm16 libraries' bf16 / fp16
# launchers and gemm_plan, each with the caller's plan (tile, splits).
ENTRY = r'''
#include "hgemm.cuh"

namespace {
template <typename Elt, typename OutT>
int run(const void* a, const void* b, const void* d, void* c, int m, int n,
        int k, long long lda, long long ldb, int b_trans, long long ldd,
        int act, float out_scale, int ws, void* workspace, void* stream,
        int tile, int splits) {
  return static_cast<int>(hgemm::launch<Elt, OutT>(
      static_cast<const Elt*>(a), static_cast<const Elt*>(b),
      static_cast<const float*>(d), static_cast<OutT*>(c), m, n, k, lda, ldb,
      b_trans, ldd, act, out_scale, ws, workspace,
      static_cast<cudaStream_t>(stream), tile, splits));
}
}  // namespace

extern "C" int gemm_launch(const void* a, const void* b, const void* d,
                           void* c, int m, int n, int k, long long lda,
                           long long ldb, int b_trans, long long ldd,
                           int in_dtype, int out_dtype, int act,
                           float out_scale, int ws, void* stream,
                           void* workspace, int tile, int splits) {
  if (in_dtype != 1 || out_dtype != 1) return (int)cudaErrorInvalidValue;
  return run<hgemm::bf16, hgemm::bf16>(a, b, d, c, m, n, k, lda, ldb,
                                       b_trans, ldd, act, out_scale, ws,
                                       workspace, stream, tile, splits);
}

extern "C" int gemm_f16_launch(const void* a, const void* b, const void* d,
                               void* c, int m, int n, int k, long long lda,
                               long long ldb, int b_trans, long long ldd,
                               int out_dtype, int act, float out_scale,
                               int ws, void* stream, void* workspace,
                               int tile, int splits) {
  if (out_dtype != 2) return (int)cudaErrorInvalidValue;
  return run<__half, __half>(a, b, d, c, m, n, k, lda, ldb, b_trans, ldd,
                             act, out_scale, ws, workspace, stream, tile,
                             splits);
}

extern "C" int gemm_plan(int m, int n, int k, int b_trans, int in_dtype,
                         int tile, int splits, long long* plan) {
  if (in_dtype != 1 && in_dtype != 2) return (int)cudaErrorInvalidValue;
  hgemm::Plan p;
  if (!hgemm::resolve(m, n, k, b_trans, hgemm::sm_count(), tile, splits, p))
    return (int)cudaErrorInvalidValue;
  const long long out[11] = {p.wide,   p.bm,     p.bn,      p.bk,
                             p.splits, p.blocks, p.threads, p.stages,
                             p.smem,   p.ws_words, hgemm::tile_code(p)};
  for (int i = 0; i < 11; ++i) plan[i] = out[i];
  return 0;
}

extern "C" void hgemm_phases_set(void* stamps) {
  hgemm::g_stamps = static_cast<unsigned long long*>(stamps);
}
'''


def build(out: Path) -> Path:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "hgemm.cuh").read_text()
    src = patch(src, "namespace hgemm {\n", "namespace hgemm {\ninline "
                "unsigned long long* g_stamps = nullptr;\n")
    src = patch(src, "  int* tickets;      // splits > 1: one per tile, 0 "
                "between calls\n", "  int* tickets;      // splits > 1: one "
                "per tile, 0 between calls\n  unsigned long long* stamps;\n")
    src = patch(src, "  a.ws = ws;\n", "  a.ws = ws;\n  a.stamps = g_stamps;"
                "\n")
    for anchor, slot, at in MARKS:
        lines = anchor.split("\n")
        src = patch(src, anchor, "\n".join(lines[:at] + [stamp(slot)] +
                                           lines[at:]))
    out.mkdir(parents=True, exist_ok=True)
    for p in _build.CSRC.glob("*.cuh"):       # the stamped header's siblings
        (out / p.name).write_text(p.read_text())
    (out / "hgemm.cuh").write_text(src)
    (out / "hgemm_phases.cu").write_text(ENTRY)
    lib = out / "libhgemm_phases.so"
    cmd = _build.nvcc_command(out / "hgemm_phases.cu", lib)
    # -fno-gnu-unique: the launchers' statics stay this library's own
    r = subprocess.run(cmd[:1] + ["-Xcompiler", "-fno-gnu-unique"] + cmd[1:],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time every plan the kernel can take")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hgemm_phases: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.config import Activation
    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import gemm_ref
    from repro_torch.tune import schedules

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    lib = ctypes.CDLL(str(build(ROOT / "build" / "hgemm_phases")))
    lib.hgemm_phases_set.argtypes = [ctypes.c_void_p]
    for name in ("gemm", "gemm16"):
        _build._LIBS[name] = lib
    for key in [k for k in _build._FNS if k[0] in ("gemm", "gemm16")]:
        del _build._FNS[key]

    gen = torch.Generator(device="cuda").manual_seed(0)
    f16, bf16 = torch.float16, torch.bfloat16
    cases = []
    relu = dict(shift=1, activation=Activation.RELU)
    for label, (m, n, k) in [("fp16 quickstart", (1000, 512, 2048))] + [
            (f"fp16 resnet50 {lab}", mnk)
            for lab, mnk, _, _ in cs.resnet50_shapes() if mnk[0] > 16]:
        a, b, d, _ = cs.datapath_operands(torch, gen, f16, (m, k), (k, n), n)
        kw = dict(acc_dtype=torch.float32, out_dtype=f16, **relu)
        cases.append((label, m, n, k, "fp16",
                      lambda a=a, b=b, d=d, kw=kw: kg.gemm_os(a, b, d, **kw),
                      lambda a=a, b=b, d=d, kw=kw: gemm_ref(a, b, d, **kw),
                      lambda a=a, b=b: torch.matmul(a, b)))

    def randn(*shape, dtype=bf16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)
    for name, m, n, k, run_k, run_p, run_lib in cs.gemm_serving_cases(
            torch, randn, kg.gemm):
        if m > 16:
            cases.append((f"bf16 {name}", m, n, k, "bf16", run_k, run_p,
                          run_lib))

    timer = cs.Timer(torch)
    print("us from each block's entry, median over the blocks reaching the "
          "phase; span: first entry to last store", flush=True)
    for label, m, n, k, kind, run_k, run_p, run_lib in cases:
        kg._PLANS.clear()
        trans = label.endswith("unembed")
        plan = kg.gemm_plan(m, n, k, trans, dtype=f16 if kind == "fp16"
                            else bf16)
        cs.check_close(torch, f"hgemm_phases {label}", run_k(), run_p(),
                       kind)
        event = timer(run_k)
        lib_ms = timer(run_lib)
        stamps = torch.zeros(plan["grid"] * STAMPS, dtype=torch.int64,
                             device="cuda")
        for _ in range(3):                 # the last of three, L2 flushed
            stamps.zero_()
            timer.flush_buf.zero_()
            torch.cuda.synchronize()
            lib.hgemm_phases_set(stamps.data_ptr())
            run_k()
            torch.cuda.synchronize()
        lib.hgemm_phases_set(None)
        raw = stamps.view(-1, STAMPS).cpu().tolist()
        parts = []
        for j, phase in enumerate(PHASES, 1):
            v = [(r[j] - r[0]) / 1e3 for r in raw if r[j] > 0]
            if v:
                parts.append(f"{phase} {statistics.median(v):.2f}")
        ends = [r[4] for r in raw if r[4] > 0]
        span = (max(ends) - min(r[0] for r in raw)) / 1e3 if ends else 0.0
        text = cs.gemm_plan_text(kg, m, n, k, trans,
                                 dtype=f16 if kind == "fp16" else bf16)
        print(f"{label} M={m} N={n} K={k}: {text}; "
              f"event {event * 1e3:.2f}, torch.matmul {lib_ms * 1e3:.2f}; "
              + ", ".join(parts) + f"; span {span:.2f}", flush=True)
        if not args.sweep:
            continue
        times = []
        dt = f16 if kind == "fp16" else bf16
        real = kg._gemm
        for sched in schedules.enumerate_gemm_schedules(dt, m, n, k)[1:]:
            try:
                p = kg.gemm_plan(m, n, k, trans, dtype=dt, **sched)
            except RuntimeError:
                continue
            # the case's call, with the plan named
            kg._gemm = named(real, sched)
            try:
                cs.check_close(torch, f"hgemm_phases {label} {sched}",
                               run_k(), run_p(), kind)
            except SystemExit:
                times.append(f"{sched} wrong")
                continue
            finally:
                kg._gemm = real
            kg._gemm = named(real, sched)
            try:
                bm, bn, _ = p["tile"]
                times.append(f"{bm}x{bn} s{p['splits']} "
                             f"{timer(run_k) * 1e3:.2f}")
            finally:
                kg._gemm = real
        print("  plans (us): " + ", ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
