"""Software model of the Gemmini ISA and its decoupled access/execute timing.

(A copy of ``repro.core.isa``, verbatim up to import paths: it is pure
Python, and the port imports nothing of ``repro``.)

The paper programs the accelerator with mvin / mvout / compute instructions
issued to three parallel queues (LOAD / STORE / EXECUTE), with software-
encoded inter-queue dependencies (section 2.3). We model that machine
analytically: given a TilePlan and system parameters (bus width, memory
latency, requests-in-flight), emit the instruction stream a tiled GEMM
produces and compute its steady-state cycle count under the decoupled
queue model.

This is what reproduces the paper's *system-level* findings without RTL:

  * design point 9 (bus width 128b -> 64b): no slowdown when the machine is
    bound by round-trip latency x max-requests-in-flight rather than by
    bus bandwidth ("This limitation turns a bandwidth constraint into a
    memory latency constraint").
  * design point 7 (4x scratchpad): larger tiles -> fewer HBM re-reads, but
    no gain once the EXECUTE queue is the bottleneck (CPU-limited DNNs).
  * design point 5 (2x array dim): mvin moves DIM rows per instruction, so
    doubling DIM doubles effective bandwidth and quadruples compute
    throughput (paper: "2x-4x depending on reuse").
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Iterator, List, Tuple

from repro_torch.core.config import Dataflow, GemminiConfig, bytes_of
from repro_torch.core.tiling import TilePlan


class Op(enum.Enum):
    MVIN = "mvin"
    MVOUT = "mvout"
    COMPUTE = "compute"
    CONFIG = "config"


@dataclasses.dataclass(frozen=True)
class Instr:
    op: Op
    bytes: int = 0          # data moved (mvin/mvout)
    macs: int = 0           # work (compute)
    queue: str = ""         # LOAD / STORE / EX


@dataclasses.dataclass(frozen=True)
class SystemParams:
    """SoC-level parameters (paper section 2.2, 'System Parameters').

    The mvin unit requests one systolic-dimension row at a time (the paper:
    "requests multiple systolic-dimension matrix rows at a time ...
    increasing the array dimension results in larger blocks of memory
    requested per mvin"), so the latency-bound effective bandwidth is

        inflight * (DIM * input_bytes) / round_trip_latency

    which is what makes design point 9 (bus width) a no-op when the machine
    is latency-bound, and design point 5 (2x DIM) double the effective
    bandwidth -- both of the paper's system-level findings.
    """

    bus_bytes: int = 16            # 128-bit TileLink beat
    mem_latency_cycles: int = 80   # round-trip to LLC/DRAM
    max_inflight: int = 16         # outstanding memory requests
    host_issue_rate: float = 1.0   # instructions/cycle the host can issue
                                   # (Rocket ~1.0; BOOM ~3.0 for this stream)

    def effective_bw(self, request_bytes: int) -> float:
        """bytes/cycle: min(bus limit, latency x in-flight limit)."""
        latency_bw = self.max_inflight * request_bytes / \
            self.mem_latency_cycles
        return min(float(self.bus_bytes), latency_bw)


ROCKET = SystemParams()
BOOM = SystemParams(host_issue_rate=3.0)
NARROW_BUS = SystemParams(bus_bytes=8)   # design point 9


def instruction_stream(plan: TilePlan, cfg: GemminiConfig,
                       has_bias: bool = False) -> Iterator[Instr]:
    """The instruction stream the tiled-GEMM library emits for one GEMM."""
    in_b = bytes_of(cfg.input_dtype)
    acc_b = bytes_of(cfg.acc_dtype)
    out_b = bytes_of(cfg.output_dtype)
    gm, gn, gk = plan.grid
    tm, tn, tk = plan.tile_m, plan.tile_n, plan.tile_k
    yield Instr(Op.CONFIG)
    if plan.dataflow is Dataflow.OS:
        for i in range(gm):
            for j in range(gn):
                if has_bias:
                    yield Instr(Op.MVIN, bytes=tm * tn * acc_b, queue="LOAD")
                for kk in range(gk):
                    yield Instr(Op.MVIN, bytes=tm * tk * in_b, queue="LOAD")
                    yield Instr(Op.MVIN, bytes=tk * tn * in_b, queue="LOAD")
                    yield Instr(Op.COMPUTE, macs=tm * tn * tk, queue="EX")
                yield Instr(Op.MVOUT, bytes=tm * tn * out_b, queue="STORE")
    else:  # WS: B preloaded once per (n, k); A streams; acc read-modify-write
        for j in range(gn):
            for kk in range(gk):
                yield Instr(Op.MVIN, bytes=tk * tn * in_b, queue="LOAD")
                for i in range(gm):
                    yield Instr(Op.MVIN, bytes=tm * tk * in_b, queue="LOAD")
                    yield Instr(Op.COMPUTE, macs=tm * tn * tk, queue="EX")
            for i in range(gm):
                yield Instr(Op.MVOUT, bytes=tm * tn * out_b, queue="STORE")


@dataclasses.dataclass(frozen=True)
class QueueTiming:
    load_cycles: float
    store_cycles: float
    ex_cycles: float
    issue_cycles: float
    n_instrs: int

    @property
    def total_cycles(self) -> float:
        """Decoupled queues overlap; steady state is bound by the slowest."""
        return max(self.load_cycles, self.store_cycles, self.ex_cycles,
                   self.issue_cycles)

    @property
    def bottleneck(self) -> str:
        vals = {"LOAD": self.load_cycles, "STORE": self.store_cycles,
                "EX": self.ex_cycles, "ISSUE": self.issue_cycles}
        return max(vals, key=vals.get)


def simulate(plan: TilePlan, cfg: GemminiConfig, sys: SystemParams,
             has_bias: bool = False) -> QueueTiming:
    """Steady-state cycle model of the decoupled access/execute machine."""
    load_bytes = store_bytes = macs = n = 0
    for ins in instruction_stream(plan, cfg, has_bias):
        n += 1
        if ins.op is Op.MVIN:
            load_bytes += ins.bytes
        elif ins.op is Op.MVOUT:
            store_bytes += ins.bytes
        elif ins.op is Op.COMPUTE:
            macs += ins.macs

    # Memory queues: bounded by min(bus bandwidth, latency-bound bandwidth).
    # mvin granularity: one DIM-row buffer per outstanding request; the row
    # buffer is sized at elaboration for the *baseline* 8-bit lane (DIM
    # bytes), so wider datatypes stream more requests for the same tile --
    # which is exactly why design point 4 (32-bit) loses locality AND
    # bandwidth while design point 5 (2x DIM) gains both.
    req_bytes = cfg.dim
    eff_bw = sys.effective_bw(req_bytes)
    load_cycles = load_bytes / eff_bw
    store_cycles = store_bytes / eff_bw
    # EXECUTE queue: DIM*DIM MACs/cycle (fully pipelined); /2 if depth-1
    # pipeline halves achievable frequency-normalized throughput.
    macs_per_cycle = cfg.dim * cfg.dim * (1.0 if cfg.pipeline_depth > 1 else 0.5)
    ex_cycles = macs / macs_per_cycle
    issue_cycles = n / sys.host_issue_rate
    return QueueTiming(load_cycles, store_cycles, ex_cycles, issue_cycles, n)
