"""Where the SSD kernels' time goes, phase by phase, on a card.

Builds a copy of ``csrc/ssd.cuh`` (``ssd.cu``'s instances; with
``--fp16`` ``ssd16.cu``'s) with ``globaltimer`` stamps (thread 0 of every
block, at the phase boundaries marked below), swaps it in for the
``ssd`` (``ssd16``) library, runs the serving call (one 256-token chunk
with a carried state; bf16, or fp16 with ``--fp16``) at mamba2-1.3b's and
hymba-1.5b's widths, or with ``--fp32`` the fp32 kernel there on phases
7-8's fp32 call (256 tokens fresh) and the resumed chunk, and prints, per
kind of block, the microseconds from
the launch's first stamp at which each phase ended (min, median, max over
the blocks), beside the copy's event time with its stamps off
(``chip_smoke.Timer``: CUDA events, L2 flushed, median of 25):

  python3 tools/ssd_phases.py
  python3 tools/ssd_phases.py --fp16
  python3 tools/ssd_phases.py --fp32

Output blocks by row tile: ``loads`` (C, the carried states, dt, seg and
the decay factors in), ``carried`` (the C @ S term), ``tile k in`` and
``tile k done`` per key tile, ``done``; state blocks: ``computed`` (bf16:
before the row split's reduction; fp32: the last key tile's products
done). The stamps cost a few instructions each, so the times are the
instrumented kernel's. Needs a card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAMPS = 24

# (anchor line in ssd.cuh, stamp slot, stamp before the line?)
MARKS = [
    ("  const int r_lo = warp * 16;", "0", True),
    ("  __syncthreads();                         // C, states, seg and "
     "factors in", "1", False),
    ("  __syncthreads();                         // the states' bytes are "
     "free", "2", False),
    ("    __syncthreads();                       // tile jt is in",
     "3 + jt", False),
    ("    if (jt < it) __syncthreads();          // stage st is free for "
     "jt + 2", "7 + jt", True),
    ("  // y = acc + d_skip x; the last key tile is this row tile, so its "
     "stage", "11", True),
    ("  const int grp = h / (p.H / p.G), n0 = ns * NSL;", "12", True),
    ("  if (wk > 1) {                            // the row split's partials",
     "14", True),
]
# the fp32 kernel's: 32-row tiles, up to 8 key tiles
MARKS_F32 = [
    ("  const int i0 = it * FRT, ni = min(FRT, p.q - i0), jend = i0 + ni;",
     "0", True),
    ("  __syncthreads();                         // C, states, dt, seg, "
     "factors in", "1", False),
    ("  __syncthreads();                         // the states' floats are "
     "free", "2", False),
    ("    __syncthreads();                       // key tile jt is in",
     "3 + jt", False),
    ("    __syncthreads();                       // stage st and the W tiles "
     "free", "11 + jt", True),
    ("  cluster.sync();                          // the other rank's sums are "
     "read", "19", True),
    ("  const int grp = h / (p.H / p.G), n0 = ns * NS;", "20", True),
    ("  if (!active) return;\n  const float dec = expf(seg_last[0]);", "21",
     True),
]


def stamp(slot: str) -> str:
    return ("\n  if (threadIdx.x == 0 && g_stamps) { unsigned long long t_; "
            "asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
            f"g_stamps[(blockIdx.y * gridDim.x + blockIdx.x) * {STAMPS} + "
            f"({slot})] = t_; }}\n")


def build(out: Path, half: bool = False) -> Path:
    from repro_torch.kernels import _build

    src = "#define SSD_GENERIC false\n" + (
        "#define SSD_HALF true\n" if half else "") + (
        ROOT / "src/repro_torch/kernels/csrc/ssd.cuh").read_text().replace(
            "#pragma once\n", "")
    src = src.replace("constexpr int TC_THREADS = 128;",
                      "__device__ unsigned long long* g_stamps;\n"
                      "constexpr int TC_THREADS = 128;")
    for line, slot, before in MARKS + MARKS_F32:
        if src.count(line) != 1:
            raise SystemExit(f"ssd_phases: anchor not once in ssd.cuh: "
                             f"{line!r}")
        src = src.replace(line, stamp(slot) + line if before
                          else line + stamp(slot))
    src += ('\nextern "C" void ssd_set_stamps(void* p) {\n'
            '  cudaMemcpyToSymbol(g_stamps, &p, sizeof(p));\n}\n')
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd_phases.cu").write_text(src)
    lib = out / "libssd_phases.so"
    r = subprocess.run(_build.nvcc_command(out / "ssd_phases.cu", lib),
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(r.stdout + r.stderr)
    return lib


def spread(vals):
    vals = [v for v in vals if v is not None]
    if not vals:
        return "-"
    return (f"{min(vals):.2f} / {statistics.median(vals):.2f} / "
            f"{max(vals):.2f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fp32", action="store_true",
                    help="the fp32 kernel (phases 7-8's fp32 call)")
    ap.add_argument("--fp16", action="store_true",
                    help="the fp16 tensor-core kernel (ssd16.cu)")
    args = ap.parse_args()
    if args.fp32 and args.fp16:
        ap.error("--fp32 and --fp16 name two kernels: pick one")
    import torch
    if not torch.cuda.is_available():
        print("ssd_phases: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.kernels import mamba2 as km

    name = "ssd16" if args.fp16 else "ssd"
    lib = ctypes.CDLL(str(build(ROOT / "build" / f"{name}_phases",
                                half=args.fp16)))
    lib.ssd_set_stamps.argtypes = [ctypes.c_void_p]
    _build._LIBS[name] = lib
    _build._FNS.pop((name, "ssd_launch"), None)
    gen = torch.Generator(device="cuda").manual_seed(0)
    timer = cs.Timer(torch)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    dtype = torch.float32 if args.fp32 else \
        torch.float16 if args.fp16 else torch.bfloat16
    rt = 32 if args.fp32 else 64            # rows per output block
    calls = [(256, False), (256, True)] if args.fp32 else [(256, True)]
    for arch in ("mamba2-1.3b", "hymba-1.5b"):
        cfg = configs.get(arch)
        h, p = cfg.n_ssm_heads, cfg.ssm_head_dim
        g, n = cfg.ssm_groups, cfg.d_state
        for t, resume in calls:
            def randn(*shape, scale=1.0, dt=dtype):
                return (torch.randn(shape, generator=gen, device="cuda")
                        * scale).to(dt)
            x = randn(1, t, h, p)
            b, c = randn(1, t, g, n, scale=0.3), randn(1, t, g, n, scale=0.3)
            dt = torch.nn.functional.softplus(randn(1, t, h,
                                                    dt=torch.float32))
            a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
            kw = dict(d_skip=torch.ones(h, device="cuda"),
                      return_final_state=True,
                      initial_state=randn(1, h, n, p, scale=0.5,
                                          dt=torch.float32)
                      if resume else None)
            event = timer(lambda: km.ssd(x, dt, a_log, b, c, **kw))
            stamps = torch.zeros(4096 * STAMPS, dtype=torch.int64,
                                 device="cuda")
            for _ in range(3):             # the last of three, L2 flushed
                stamps.zero_()
                timer.flush_buf.zero_()
                torch.cuda.synchronize()
                lib.ssd_set_stamps(stamps.data_ptr())
                km.ssd(x, dt, a_log, b, c, **kw)
                torch.cuda.synchronize()
            lib.ssd_set_stamps(None)
            n_rt, n_hs = -(-t // rt), g * -(-(h // g) // 2)
            # fp32: a cluster of two blocks per output tile, the state
            # blocks' count made even
            n_out = (2 if args.fp32 else 1) * n_rt * n_hs
            n_state = (-(-n // (64 if n > 32 else 32)) if args.fp32
                       else -(-(-(-n // 16) * 16) // 64)) * h
            if args.fp32:
                n_state += n_state % 2
            raw = stamps.view(-1, STAMPS)[:n_out + n_state].cpu().tolist()
            t0 = min(v for row in raw for v in row if v > 0)
            us = [[(v - t0) / 1e3 if v > 0 else None for v in row]
                  for row in raw]
            what = "resumed" if resume else "fresh"
            print(f"{arch} {str(dtype)[6:]} T={t} {what}: event "
                  f"{event * 1e3:.2f} us; {n_out} output + {n_state} state "
                  f"blocks; us from the first stamp, min / median / max")
            tiles = t // rt if args.fp32 else 4
            done, state = (19, 21) if args.fp32 else (11, 14)
            # each block's row tile (None: a state block), as the kernel
            # maps block indices: fp32 puts the state blocks after the
            # later half of the row tiles, bf16 after every output block
            per = 2 if args.fp32 else 1              # blocks per tile
            n_long = per * (n_rt - n_rt // 2) * n_hs if args.fp32 else n_out
            tile_of = []
            for bx in range(n_out + n_state):
                if n_long <= bx < n_long + n_state:
                    tile_of.append(None)
                else:
                    b = bx - n_state if bx >= n_long else bx
                    tile_of.append(n_rt - 1 - (b // per) // n_hs)
            for it in range(n_rt - 1, -1, -1):
                rows = [us[i] for i in range(n_out + n_state)
                        if tile_of[i] == it]
                parts = [("loads", 1), ("carried", 2)]
                for k in range(it + 1):
                    parts += [(f"tile {k} in", 3 + k),
                              (f"tile {k} done", 3 + tiles + k)]
                parts.append(("done", done))
                print(f"  output, row tile {it}: " + "; ".join(
                    f"{name} {spread([r[s] for r in rows])}"
                    for name, s in parts))
            print(f"  state: computed " + spread(
                [us[i][state] for i in range(n_out + n_state)
                 if tile_of[i] is None]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
