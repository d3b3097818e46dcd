"""Where the fp32 conv's time goes, phase by phase, and how it moves with
the K split count, on a card.

Builds a copy of ``csrc/conv.cu`` whose ``sgemm.cuh`` carries
``globaltimer`` stamps (thread 0 of every block, at the phase boundaries
below; a split count is handed to it as the caller's plan), then, at
every distinct conv of ``dse.resnet(50)``'s stream
(``chip_smoke.resnet50_shapes``; fp32, operands as phase 6b draws them,
bias, shift 1 and ReLU), prints the shipped kernel's event time
(``chip_smoke.Timer``: CUDA events, L2 flushed, median of 25) and the
copy's phases at the plan's splits: microseconds from each block's entry
at which each phase ended (median over the blocks that reach it):

  python3 tools/conv_phases.py            # phases at the plan's splits
  python3 tools/conv_phases.py --splits   # and the event time of every
                                          # power-of-two split count

Phases: ``staged`` (the stem's strips in shared memory), ``landed`` (the
first slice), ``loop_end`` (the last FMA), ``summed`` (the k groups'
tiles added), ``ticket`` (a split's last block holds the tile's ticket),
``merged`` (partials added), ``done`` (the last output stored). Every
output is held against ``conv2d_ref`` at the fp32 rule. The stamps cost a
few instructions each. Needs a card and ``nvcc``; builds into
``build/conv_phases/``.
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
PHASES = ("staged", "landed", "loop_end", "summed", "ticket", "merged",
          "done")

# (anchor in sgemm.cuh, stamp slot, lines of the anchor before the stamp)
MARKS = [
    ("  const int steps = hi - lo;\n\n  if constexpr (hgemm::Staged", 0, 1),
    ("  // A quad item e = tid + i * T: row e / 4", 1, 0),
    ("    __syncthreads();                      // ... and slice it - 1 is "
     "read\n", 2, 1),
    ("  hgemm::cp_async_wait<0>();\n  if constexpr (KG > 1) {", 3, 1),
    ("  const int S = p.splits;\n  if (S > 1) {\n    Acc* const base", 4, 0),
    ("    if (!hgemm::last_of_tile(p.tickets + tile, S)) return;\n"
     "    constexpr int U", 5, 1),
    ("  // back to this thread's places in the staged tile", 6, 0),
    ("    finish_column<Sh, In, OutT>(p, mine, bias, m0 + row0, c);\n  }\n}",
     7, 2),
]


def stamp(slot: int) -> str:
    guard = "it == 0 && " if slot == 2 else ""
    return (f"  if ({guard}threadIdx.x == 0 && p.stamps) {{ unsigned long "
            "long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
            f"\"=l\"(t_)); p.stamps[blockIdx.x * {STAMPS} + {slot}] = t_; }}")


def patch(src: str, anchor: str, new: str) -> str:
    if src.count(anchor) != 1:
        raise SystemExit(f"conv_phases: anchor not once: {anchor!r}")
    return src.replace(anchor, new)


def build(out: Path) -> Path:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "sgemm.cuh").read_text()
    src = patch(src, "namespace sgemm {\n", "namespace sgemm {\ninline "
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
    conv = (_build.CSRC / "conv.cu").read_text()
    conv += ('\nextern "C" void conv_phases_set(void* stamps) {\n'
             '  sgemm::g_stamps = static_cast<unsigned long long*>(stamps);\n'
             '}\n')
    out.mkdir(parents=True, exist_ok=True)
    (out / "sgemm.cuh").write_text(src)
    (out / "conv.cu").write_text(conv)    # includes the stamped sgemm.cuh
    lib = out / "libconv_phases.so"
    cmd = _build.nvcc_command(out / "conv.cu", lib)
    # -fno-gnu-unique: the launchers' statics stay this library's own
    r = subprocess.run(cmd[:1] + [f"-I{_build.CSRC}", "-Xcompiler",
                                  "-fno-gnu-unique"] + cmd[1:],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--splits", action="store_true",
                    help="also time every power-of-two split count")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("conv_phases: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.config import Activation
    from repro_torch.kernels import conv as kc
    from repro_torch.kernels.ref import conv2d_ref

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer(torch)
    lib = ctypes.CDLL(str(build(ROOT / "build" / "conv_phases")))
    lib.conv_phases_set.argtypes = [ctypes.c_void_p]
    launch = lib.conv2d_launch
    launch.argtypes = kc._ARGS
    launch.restype = ctypes.c_int
    ws = torch.zeros(64 << 20, dtype=torch.int32, device="cuda")
    print("us from each block's entry, median over the blocks reaching the "
          "phase; span: first entry to last store")
    for label, (m, n, k), (h, ci, co, kh, st, pad), _ in \
            cs.resnet50_shapes():
        x, w, b, shift = cs.datapath_operands(
            torch, gen, torch.float32, (1, h, h, ci), (kh, kh, ci, co), co)
        kw = dict(stride=st, padding=pad, acc_dtype=torch.float32,
                  out_dtype=torch.float32, shift=shift,
                  activation=Activation.RELU)
        want = conv2d_ref(x, w, b, **kw)
        event = timer(lambda: kc.conv2d_implicit(x, w, b, **kw))
        plan = kc.conv_plan(m, n, k, torch.float32)
        oh = (h + 2 * pad - kh) // st + 1
        out = torch.empty((1, oh, oh, co), device="cuda")

        def call(splits, stamps=None):
            # splits > 0: the caller's plan (the conv's one tile, code 1)
            lib.conv_phases_set(stamps)
            err = launch(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         out.data_ptr(), 1, h, h, ci, co, kh, kh, st, pad,
                         oh, oh, 2, 0, 1, shift, 0.5,
                         torch.cuda.current_stream().cuda_stream,
                         ws.data_ptr(), 1 if splits else 0, splits)
            if err:
                raise SystemExit(f"conv_phases: {label}: CUDA error {err}")

        grid = plan["grid"]
        stamps = torch.zeros(grid * STAMPS, dtype=torch.int64, device="cuda")
        for _ in range(3):                 # the last of three, L2 flushed
            stamps.zero_()
            timer.flush_buf.zero_()
            torch.cuda.synchronize()
            call(0, stamps.data_ptr())
            torch.cuda.synchronize()
        lib.conv_phases_set(None)
        cs.check_close(torch, f"conv_phases {label}", out, want, "fp32")
        raw = stamps.view(-1, STAMPS).cpu().tolist()
        parts = []
        for j, phase in enumerate(PHASES, 1):
            v = [(r[j] - r[0]) / 1e3 for r in raw if r[j] > 0]
            if v:
                parts.append(f"{phase} {statistics.median(v):.2f}")
        span = (max(r[7] for r in raw) - min(r[0] for r in raw)) / 1e3
        print(f"{label} M={m} N={n} K={k}: {plan['splits']} K splits, "
              f"{grid} blocks; event {event * 1e3:.2f}; " + ", ".join(parts)
              + f"; span {span:.2f}", flush=True)
        if not args.splits:
            continue
        ks, times = -(-k // 16), []
        s = 1
        while s <= 32 and (s == 1 or s <= ks // 2):
            if -(-ks // s) <= 32:        # no chain past 512 k
                call(s)
                torch.cuda.synchronize()
                cs.check_close(torch, f"conv_phases {label} s{s}", out, want,
                               "fp32")
                t = timer(lambda s=s: call(s))
                mark = "*" if s == plan["splits"] else ""
                times.append(f"s{s}{mark} {t * 1e3:.2f}")
            s *= 2
        lib.conv_phases_set(None)
        print(f"  splits (us, * the plan's): " + ", ".join(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
