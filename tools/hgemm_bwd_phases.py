"""Where the backward products' time goes, phase by phase, on a card.

Builds a copy of ``csrc/hgemm_bwd.cuh`` (the engine GEMM's backward
kernel) with ``globaltimer`` stamps by the first consumer thread of every
block into a library of its own that stands in for the ``gemm_bwd``
library's bf16 entry points, then runs gemma3-1b's 16 backward products at
its training shapes (``chip_smoke.gemm_backward_cases``: dA and dB of the 7
projections and of the tied unembedding at 4 x 1024 token rows) and prints
per product the plan, the event time of the copy with its stamps off
(``chip_smoke.Timer``: CUDA events, L2 flushed, median of 25),
``torch.matmul``'s, and, in microseconds:

  landed     block entry to the first stage in shared memory (median)
  loop       a unit's main loop, its first k step's wait to its last
             product (median over units, and per k step)
  fixup      a split tile's first share: its loop end to the other
             shares' partials added (the flag wait and the merge; max)
  epilogue   a unit's loop end (or fixup) to its tile's TMA store issued
             or, for a later share, its flag raised (median)
  end        block entry to its last unit's epilogue (median, and the
             spread between the first and the last block to finish)
  span       the first block's entry to the last block's end

  python3 tools/hgemm_bwd_phases.py [--bn {128,192}] [--min-seg S ...]

``--bn`` forces the column tile of every product (the plan's own: the one
that wastes fewest columns). ``--min-seg`` sets the fewest k steps of a
stream-K share (the kernel's ``MIN_SEG``), which caps how many shares a
remaining tile splits into; given several, the copy is built and every
product run once for each, one after the other.

The stamps cost a few instructions each, so the phases are the
instrumented kernel's. Every output is held against the plain version
(``chip_smoke.check_close`` or, for the unembedding's dA, ``hold_long_k``).
Needs a card and ``nvcc``; builds into ``build/hgemm_bwd_phases/``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
UNITS = 128                       # units a block stamps at most
SLOTS = 2 + 3 * UNITS             # entry, landed, then per unit 3


def stamp(slot: str) -> str:
    return ("if (tid == 0 && p.stamps != nullptr && (" + slot + ") < "
            f"{SLOTS}) {{ unsigned long long t_; asm volatile(\"mov.u64 "
            "%0, %%globaltimer;\" : \"=l\"(t_)); p.stamps[(long long)"
            f"blockIdx.x * {SLOTS} + (" + slot + ")] = t_; }")


# (anchor, text put after it)
MARKS = [
    ("namespace hgemm_bwd {\n",
     "inline unsigned long long* g_stamps = nullptr;\n"),
    ("  float* part;        // splits > 1: a BM x BN partial a stream-K "
     "block\n", "  unsigned long long* stamps;\n"),
    ("  a.part = workspace ? static_cast<float*>(workspace) + MAX_FLAGS : "
     "nullptr;\n", "  a.stamps = g_stamps;\n"),
    ("  Walk w(p, g, G);\n  Unit u;\n  int it = 0;\n",
     "  int ui_ = -1;\n  " + stamp("0") + "\n"),
    ("    const int n = u.hi - u.lo;\n", "    ++ui_;\n"),
    ("      hgemm::mbar_wait(hgemm::smem_u32(&full[stage]), (it / ST) & 1);"
     "\n", "      if (it == 0) { " + stamp("1") + " }\n"),
    ("    hgemm::wgmma_wait<0>();\n    if (lane == 0) hgemm::mbar_arrive("
     "hgemm::smem_u32(&empty[(it - 1) % ST]));\n",
     "    " + stamp("2 + 3 * ui_") + "\n"),
    ("        atomicExch(p.flags + g, 1);\n      }\n",
     "      " + stamp("4 + 3 * ui_") + "\n"),
    ("          acc[4 * i + 3] += v.w;\n        }\n      }\n",
     "      " + stamp("3 + 3 * ui_") + "\n"),
    ("      asm volatile(\"cp.async.bulk.commit_group;\\n\" ::: \"memory\");"
     "\n    }\n", "    " + stamp("4 + 3 * ui_") + "\n"),
]

ENTRY = r'''
#include "hgemm_bwd.cuh"

extern "C" int gemm_bwd_plan(int m, int n, int k, long long* out) {
  hgemm_bwd::Plan p;
  if (!hgemm_bwd::plan(m, n, k, hgemm::sm_count(), p))
    return (int)cudaErrorInvalidValue;
  const long long v[15] = {hgemm_bwd::BM, p.bn, hgemm_bwd::BK, p.stages,
                           hgemm_bwd::THREADS, p.smem, p.tiles_m, p.tiles_n,
                           p.ksteps, p.dp_tiles, p.sk_tiles, p.splits,
                           p.sk_blocks, p.grid, p.ws_words};
  for (int i = 0; i < 15; ++i) out[i] = v[i];
  return 0;
}

extern "C" int gemm_bwd_launch(const void* a, const void* b, void* c, int m,
                               int n, int k, long long lda, long long ldb,
                               long long ldc, int a_mn, int b_k,
                               void* stream, void* workspace) {
  using T = __nv_bfloat16;
  return (int)hgemm_bwd::launch<T>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(c),
      m, n, k, lda, ldb, ldc, a_mn, b_k, workspace,
      static_cast<cudaStream_t>(stream));
}

extern "C" void hgemm_bwd_phases_set(void* stamps) {
  hgemm_bwd::g_stamps = static_cast<unsigned long long*>(stamps);
}
'''


MIN_SEG = "constexpr int MIN_SEG = "


def build(out: Path, bn: int = 0, min_seg: int = 0) -> Path:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "hgemm_bwd.cuh").read_text()
    marks = MARKS + ([("inline int pick_bn(int n) {\n",
                       f"  if (n > 0) return {bn};\n")] if bn else [])
    for anchor, text in marks:
        if src.count(anchor) != 1:
            raise SystemExit(f"hgemm_bwd_phases: anchor not once: "
                             f"{anchor!r}")
        src = src.replace(anchor, anchor + text)
    if min_seg:
        i = src.index(MIN_SEG) + len(MIN_SEG)
        src = src[:i] + str(min_seg) + src[src.index(";", i):]
    out.mkdir(parents=True, exist_ok=True)
    for p in _build.CSRC.glob("*.cuh"):
        (out / p.name).write_text(p.read_text())
    (out / "hgemm_bwd.cuh").write_text(src)
    (out / "hgemm_bwd_phases.cu").write_text(ENTRY)
    lib = out / "libhgemm_bwd_phases.so"
    cmd = _build.nvcc_command(out / "hgemm_bwd_phases.cu", lib)
    r = subprocess.run(cmd[:1] + ["-Xcompiler", "-fno-gnu-unique"] + cmd[1:],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    return lib


def phases(st, sched):
    """The per-block stamps (ns) as the module docstring's phases (us)."""
    landed, loop, loop_k, fixup, epi = [], [], [], [], []
    ends, entries = [], []
    for g, units in enumerate(sched):
        row = st[g]
        if not units or row[0] == 0:
            continue
        entries.append(row[0])
        landed.append((row[1] - row[0]) / 1e3)
        prev = row[1]
        for ui, (_, lo, hi, kind, _) in enumerate(units[:UNITS]):
            l_end, f_end, e_end = row[2 + 3 * ui], row[3 + 3 * ui], \
                row[4 + 3 * ui]
            loop.append((l_end - prev) / 1e3)
            loop_k.append((l_end - prev) / 1e3 / (hi - lo))
            if kind == "first":
                fixup.append((f_end - l_end) / 1e3)
            epi.append((e_end - (f_end if kind == "first" else l_end)) / 1e3)
            prev = e_end
        ends.append(prev)
    med = statistics.median
    return {"landed_us": med(landed), "loop_us": med(loop),
            "loop_us_per_kstep": med(loop_k),
            "fixup_us_max": max(fixup) if fixup else 0.0,
            "epilogue_us": med(epi),
            "end_us": med(e - s for e, s in zip(ends, entries)) / 1e3,
            "end_spread_us": (max(ends) - min(ends)) / 1e3,
            "span_us": (max(ends) - min(entries)) / 1e3}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bn", type=int, default=0, choices=(0, 128, 192),
                    help="force the column tile (0: the plan's)")
    ap.add_argument("--min-seg", type=int, nargs="+", default=[0],
                    help="fewest k steps a stream-K share (0: the "
                    "kernel's MIN_SEG)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("hgemm_bwd_phases: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels import contracts as kc
    from repro_torch.kernels import gemm as kg

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    out = ROOT / "build" / "hgemm_bwd_phases"
    with ThreadPoolExecutor(len(args.min_seg)) as pool:
        paths = list(pool.map(lambda s: build(out / f"s{s}", args.bn, s),
                              args.min_seg))
    libs = [ctypes.CDLL(str(path)) for path in paths]
    for lib in libs:
        lib.hgemm_bwd_phases_set.argtypes = [ctypes.c_void_p]

    def use(lib):
        """Route ``gemm_bwd``'s entry points (and plans) to ``lib``."""
        _build._LIBS["gemm_bwd"] = lib
        for key in [k for k in _build._FNS if k[0] == "gemm_bwd"]:
            del _build._FNS[key]
        kg._BWD_PLANS.clear()
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                ).to(dtype)
    timer = cs.Timer(torch)
    print("us; landed, loop, epilogue, end: medians over blocks or units; "
          "fixup: the longest", flush=True)
    for op, name, m, n, k, (a, b), _, run_p, run_lib, run_exact in \
            cs.gemm_backward_cases(torch, randn):
        mm, kk = a.shape
        nn = b.shape[1]

        def run(a=a, b=b):
            return kg._gemm_bwd(a, b)
        want = run_p()
        lib_ms = timer(run_lib)
        for min_seg, lib in zip(args.min_seg, libs):
            use(lib)
            got = run()
            if op == "dB" and name == "unembed":
                got = got.t()
            if k >= cs.LONG_K:
                cs.hold_long_k(torch, f"{op} {name}", run_exact)(got, want)
            else:
                cs.check_close(torch, f"{op} {name}", got, want, "bf16")
            del got
            event = timer(run)
            p = kg.gemm_bwd_plan(mm, nn, kk)
            geo = {"bn": p["tile"][1], "tiles_m": p["tiles"][0],
                   "tiles_n": p["tiles"][1], **{key: p[key] for key in (
                       "ksteps", "dp_tiles", "sk_tiles", "splits",
                       "sk_blocks", "grid")}}
            sched = kc.gemm_bwd_schedule(geo)
            stamps = torch.zeros(geo["grid"] * SLOTS, dtype=torch.int64,
                                 device="cuda")
            for _ in range(3):             # the last of three, L2 flushed
                stamps.zero_()
                timer.flush_buf.zero_()
                lib.hgemm_bwd_phases_set(stamps.data_ptr())
                run()
                torch.cuda.synchronize()
                lib.hgemm_bwd_phases_set(None)
            st = stamps.view(geo["grid"], SLOTS).cpu().tolist()
            ph = phases(st, sched)
            print(f"{op} {name:8s} {mm}x{nn}x{kk} min_seg "
                  f"{min_seg or 'kernel'}: bn {geo['bn']} dp "
                  f"{geo['dp_tiles']} sk {geo['sk_tiles']} x "
                  f"{geo['splits']} = {geo['sk_blocks']} grid {geo['grid']};"
                  f" event {event * 1e3:.1f} us, torch.matmul "
                  f"{lib_ms * 1e3:.1f} us; landed {ph['landed_us']:.2f}, "
                  f"loop {ph['loop_us']:.1f} ({ph['loop_us_per_kstep']:.3f} "
                  f"a k step), fixup {ph['fixup_us_max']:.1f}, epilogue "
                  f"{ph['epilogue_us']:.2f}, end {ph['end_us']:.1f} (spread "
                  f"{ph['end_spread_us']:.1f}), span {ph['span_us']:.1f}",
                  flush=True)
        del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
