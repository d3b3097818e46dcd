"""Where the int8 (or int16) GEMM's time goes, phase by phase, on a card.

Builds a copy of ``csrc/gemm.cu`` (``--int16``: ``csrc/gemm16.cu``, the
int16 GEMM on byte planes) whose ``igemm.cuh`` carries ``globaltimer``
stamps (thread 0 of every block, at the phase boundaries marked below),
swaps it in for the ``gemm`` (``gemm16``) library, runs the quickstart
GEMM and every distinct layer of ``dse.resnet(50)``'s stream as a GEMM
(``chip_smoke.resnet50_shapes``; OS, bias, shift and ReLU; int8: int8
out, full-range operands; int16: int16 out, operands as phase 6b draws
them) and prints, per shape, the microseconds from each block's entry at
which each phase ended (median over the blocks that reach it) and the
launch's span from its first entry to its last store:

  python3 tools/igemm_phases.py [--int16]

Phases: ``issued`` (the ring's first slabs in flight), ``landed`` (slab 0
in shared memory), ``loop_end`` (the last MMA), ``ticket`` (a split's
last block holds the tile's ticket), ``merged`` (partials added), ``done``
(tile stored). Beside them: the uninstrumented kernel's event time
(``chip_smoke.Timer``: CUDA events, L2 flushed, median of 25) and the
timer's floor, a one-element ``add_`` timed the same way. The stamps cost
a few instructions each, so the phases are the instrumented kernel's.
Needs a card and ``nvcc``; builds into ``build/igemm_phases/``.
(``landed`` is stamped only where int8 B is transposed in shared memory.)
"""

from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAMPS = 8
PHASES = ("issued", "landed", "loop_end", "ticket", "merged", "done")

# (anchor lines in igemm.cuh, stamp slot, anchor lines before the stamp)
MARKS = [
    ("  const int S = p.splits, split = blockIdx.x % S;", 0, 0),
    ("  if (XPOSE) {\n    hgemm::cp_async_wait<STAGES - 2>();   // slab 0 "
     "has landed", 1, 0),
    ("    __syncthreads();\n    if (it + STAGES - 1 < steps) "
     "load_stage(it + STAGES - 1);", 2, 1),
    ("  hgemm::cp_async_wait<0>();\n\n  if (S > 1) {", 3, 1),
    ("    if (!last_block(p.tickets + tile, S)) return;", 4, 1),
    ("  // The epilogue: the tile through shared memory", 5, 0),
    ("                [&](int v) { return finish(v, p.shift, p.act); });"
     "\n    }\n  }", 6, 3),
]


def stamp(slot: int) -> str:
    guard = "it == 0 && " if slot == 2 else ""
    return (f"  if ({guard}threadIdx.x == 0 && p.stamps) {{ unsigned long "
            "long t_; asm volatile(\"mov.u64 %0, %%globaltimer;\" : "
            f"\"=l\"(t_)); p.stamps[blockIdx.x * {STAMPS} + {slot}] = t_; }}")


def build(out: Path, lib_name: str = "gemm") -> Path:
    from repro_torch.kernels import _build

    src = (_build.CSRC / "igemm.cuh").read_text()
    # the stamps' buffer rides in the kernel's arguments, set per launch
    # from a host pointer
    for anchor, extra in (
            ("namespace igemm {\n",
             "inline unsigned long long* g_stamps = nullptr;\n"),
            ("  Acc* part;        // splits > 1: [tile][split][partial]\n",
             "  unsigned long long* stamps;\n"),
            ("  a.ws = ws;\n", "  a.stamps = g_stamps;\n")):
        if src.count(anchor) != 1:
            raise SystemExit(f"igemm_phases: anchor not once in igemm.cuh: "
                             f"{anchor!r}")
        src = src.replace(anchor, anchor + extra)
    for anchor, slot, at in MARKS:
        if src.count(anchor) != 1:
            raise SystemExit(f"igemm_phases: anchor not once in igemm.cuh: "
                             f"{anchor!r}")
        lines = anchor.split("\n")
        src = src.replace(anchor, "\n".join(lines[:at] + [stamp(slot)]
                                             + lines[at:]))
    out.mkdir(parents=True, exist_ok=True)
    (out / "igemm.cuh").write_text(src)
    gemm = (_build.CSRC / f"{lib_name}.cu").read_text()
    gemm += ('\nextern "C" void igemm_set_stamps(void* p) {\n'
             '  igemm::g_stamps = static_cast<unsigned long long*>(p);\n}\n')
    (out / f"{lib_name}.cu").write_text(gemm)    # the stamped igemm.cuh
    lib = out / f"lib{lib_name}_phases.so"
    # -fno-gnu-unique: the launchers' function-local statics (the kernel's
    # shared-memory attribute, set once) stay this library's own, not
    # bound to the loaded library's copies
    cmd = _build.nvcc_command(out / f"{lib_name}.cu", lib)
    r = subprocess.run(cmd[:1] + [f"-I{_build.CSRC}", "-Xcompiler",
                                  "-fno-gnu-unique"] + cmd[1:],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    return lib


def main() -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--int16", action="store_true",
                    help="the int16 GEMM (byte planes) instead of int8")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("igemm_phases: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.core.config import Activation
    from repro_torch.kernels import _build
    from repro_torch.kernels import gemm as kg
    from repro_torch.kernels.ref import gemm_ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rint(lo, hi, *shape, dtype=torch.int8):
        return torch.randint(lo, hi, shape, generator=gen, device="cuda",
                             dtype=dtype)

    shapes = [("quickstart", (1000, 512, 2048))] + \
        [(label, mnk) for label, mnk, _, _ in cs.resnet50_shapes()]
    if args.int16:
        lib_name, dt = "gemm16", torch.int16
        kw = dict(acc_dtype=torch.int32, out_dtype=dt, shift=10,
                  activation=Activation.RELU)
        ops = [(label, mnk) + cs.datapath_operands(
            torch, gen, dt, mnk[::2], mnk[:0:-1], mnk[1])[:3]
            for label, mnk in shapes]
    else:
        lib_name, dt = "gemm", torch.int8
        kw = dict(acc_dtype=torch.int32, out_dtype=dt, shift=9,
                  activation=Activation.RELU)
        ops = [(label, (m, n, k), rint(-128, 128, m, k),
                rint(-128, 128, k, n), rint(-1000, 1000, n, dtype=torch.int32))
               for label, (m, n, k) in shapes]
    timer = cs.Timer(torch)
    floor_x = torch.zeros(1, device="cuda")
    print(f"timer floor (one-element add_): "
          f"{timer(lambda: floor_x.add_(1)) * 1e3:.2f} us")
    events = {mnk: timer(lambda a=a, b=b, d=d: kg.gemm_os(a, b, d, **kw))
              for _, mnk, a, b, d in ops}

    lib = ctypes.CDLL(str(build(ROOT / "build" / "igemm_phases", lib_name)))
    lib.igemm_set_stamps.argtypes = [ctypes.c_void_p]
    _build._LIBS[lib_name] = lib
    for key in [k for k in _build._FNS if k[0] == lib_name]:
        del _build._FNS[key]
    print("us from each block's entry, median over the blocks reaching the "
          "phase; span: first entry to last store")
    for label, (m, n, k), a, b, d in ops:
        plan = kg.gemm_plan(m, n, k, dtype=dt) if args.int16 \
            else kg.gemm_s8_plan(m, n, k)
        stamps = torch.zeros(plan["grid"] * STAMPS, dtype=torch.int64,
                             device="cuda")
        for _ in range(3):                 # the last of three, L2 flushed
            stamps.zero_()
            timer.flush_buf.zero_()
            torch.cuda.synchronize()
            lib.igemm_set_stamps(stamps.data_ptr())
            got = kg.gemm_os(a, b, d, **kw)
            torch.cuda.synchronize()
        lib.igemm_set_stamps(None)
        if not torch.equal(got, gemm_ref(a, b, d, **kw)):
            raise SystemExit(f"igemm_phases: {label} differs from plain")
        raw = stamps.view(-1, STAMPS).cpu().tolist()
        parts = []
        for j, phase in enumerate(PHASES, 1):
            v = [(r[j] - r[0]) / 1e3 for r in raw if r[j] > 0]
            if v:
                parts.append(f"{phase} {statistics.median(v):.2f}")
        span = (max(r[6] for r in raw) - min(r[0] for r in raw)) / 1e3
        print(f"{label} M={m} N={n} K={k}: {plan['splits']} K splits, "
              f"{plan['grid']} blocks; event {events[(m, n, k)] * 1e3:.2f}; "
              + ", ".join(parts) + f"; span {span:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
